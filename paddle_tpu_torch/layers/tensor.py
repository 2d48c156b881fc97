"""Tensor-building layers — port of ``paddle_tpu/layers/tensor.py`` for
``fill_constant`` (tensor.py:46), ``fill_constant_batch_size_like``
(:63), ``cast`` (:83), ``concat`` (:98), ``sums`` (:110) and ``assign``
(:118)."""

import numpy as np

from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.core.types import convert_np_dtype_to_dtype_

__all__ = ["fill_constant", "fill_constant_batch_size_like", "cast",
           "concat", "sums", "assign"]


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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "dtype": int(convert_np_dtype_to_dtype_(dtype)),
            "value": float(value),
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
    )
    out.stop_gradient = True
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="cast",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={
            "in_dtype": int(x.dtype),
            "out_dtype": int(convert_np_dtype_to_dtype_(dtype)),
        },
    )
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(
        type="concat",
        inputs={"X": input},
        outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(dtype=input.dtype)
        helper.append_op(
            type="assign", inputs={"X": [input]}, outputs={"Out": [output]}
        )
    else:
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(dtype=arr.dtype.name)
        key = "fp32_values" if arr.dtype.kind == "f" else "int32_values"
        helper.append_op(
            type="assign_value",
            outputs={"Out": [output]},
            attrs={
                "shape": list(arr.shape),
                "dtype": int(convert_np_dtype_to_dtype_(arr.dtype)),
                key: [float(v) if arr.dtype.kind == "f" else int(v)
                      for v in arr.flatten()],
            },
        )
    return output
