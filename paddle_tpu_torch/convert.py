"""Weights carried across from the JAX package.

Both front ends name parameters identically (``word_embedding``,
``fc_0.w_0``, ``layer_norm_0.b_0``...), so the mapping from the JAX
package's scope to the port's is by name: ``load_numpy_state`` takes that
scope's values as numpy arrays and puts them into the port's scope as
tensors on ``device``, checking each against the program's var descs.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.types import convert_dtype_to_np
from paddle_tpu_torch.framework import default_main_program


def load_numpy_state(scope, state, device, program=None):
    """Set ``state`` {name: np.ndarray} into ``scope`` on ``device``.

    Checked against ``program`` (default: the default main program)
    before anything is written: every persistable var of its global block
    must be in ``state``, every name in ``state`` must be such a var, and
    each array must have the var's shape and dtype; a mismatch raises
    ValueError. Returns the sorted names set."""
    block = (program or default_main_program()).desc.global_block()
    want = {n: vd for n, vd in block.vars.items() if vd.persistable}
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise ValueError("load_numpy_state: missing %s, not persistable in "
                         "the program %s" % (missing, extra))
    for name, arr in state.items():
        vd = want[name]
        arr = np.asarray(arr)
        if list(arr.shape) != list(vd.shape):
            raise ValueError("load_numpy_state: %s has shape %s, the program "
                             "declares %s" % (name, list(arr.shape), vd.shape))
        if arr.dtype != convert_dtype_to_np(vd.dtype):
            raise ValueError("load_numpy_state: %s has dtype %s, the program "
                             "declares %s" % (name, arr.dtype, vd.dtype.name))
    device = torch.device(device)
    for name, arr in state.items():
        # a copy: the scope owns its tensors, even on the CPU
        scope.set(name, torch.from_numpy(np.array(arr)).to(device))
    return sorted(state)
