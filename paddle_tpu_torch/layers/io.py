"""Data-entry layers — port of ``paddle_tpu/layers/io.py`` for ``data``
(io.py:14; reference: python/paddle/fluid/layers/io.py:39). The readers
(py_reader, open_files...) are a later slice (ROADMAP Queue 1: I/O and
data)."""

from paddle_tpu_torch.framework import default_main_program
from paddle_tpu_torch.core.types import VarType


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, type=VarType.LOD_TENSOR):
    """Declare a feed variable. With ``append_batch_size`` a -1 batch dim
    is prepended, exactly like the reference."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().current_block()
    if name in block.vars:
        return block.vars[name]
    return block.create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        lod_level=lod_level,
        stop_gradient=stop_gradient,
        type=type,
    )
