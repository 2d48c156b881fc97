"""Tensor-building layers — port of ``paddle_tpu/layers/tensor.py`` for
``fill_constant`` (tensor.py:46)."""

from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.core.types import convert_np_dtype_to_dtype_

__all__ = ["fill_constant"]


def fill_constant(shape, dtype, value, force_cpu=False, out=None, block=None):
    helper = LayerHelper("fill_constant", block=block)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "dtype": int(convert_np_dtype_to_dtype_(dtype)),
            "value": float(value),
        },
    )
    out.stop_gradient = True
    return out
