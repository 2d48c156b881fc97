"""Tensor creation/manipulation ops — port of
``paddle_tpu/ops/tensor_ops.py`` for ``fill_constant`` (:18),
``uniform_random`` (:42), ``reshape2`` (:103), ``transpose2`` (:125) and
``slice`` (:183)."""

import torch

from paddle_tpu_torch.core.registry import register_op, register_no_grad_op
from paddle_tpu_torch.core.types import VarType, convert_dtype_to_torch
from paddle_tpu_torch.ops.common import single


def _torch_dtype(attr_dtype):
    return convert_dtype_to_torch(VarType(attr_dtype))


@register_no_grad_op("fill_constant")
def fill_constant(ctx, ins, attrs):
    shape = attrs.get("shape", [])
    dtype = _torch_dtype(attrs.get("dtype", int(VarType.FP32)))
    return {"Out": [torch.full(list(shape), attrs.get("value", 0.0),
                               dtype=dtype, device=ctx.device)]}


@register_no_grad_op("uniform_random", needs_rng=True, capturable=False)
def uniform_random(ctx, ins, attrs):
    """Drawn in float32 on the op's device from its (seed, run, op) stream
    and cast, as the reference draws float32 and casts. The stream is a
    device generator seeded on the host, so a CUDA graph would freeze its
    draw: the op is not capturable (it runs in startup programs, eagerly)."""
    shape = list(attrs.get("shape"))
    dtype = _torch_dtype(attrs.get("dtype", int(VarType.FP32)))
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    gen = ctx.rng()
    if gen is not None:
        out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                     generator=gen)
    return {"Out": [out.to(dtype)]}


def _xshape(x):
    # XShape carries the input shape behind a leading 0 dim (no data)
    return torch.empty((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register_op("reshape2")
def reshape2(ctx, ins, attrs):
    x = single(ins, "X")
    shape = list(attrs.get("shape"))
    # Fluid semantics: 0 means copy dim from input, -1 infers
    for i, d in enumerate(shape):
        if d == 0:
            shape[i] = x.shape[i]
    return {"Out": [x.reshape(shape)], "XShape": [_xshape(x)]}


@register_op("transpose2")
def transpose2(ctx, ins, attrs):
    x = single(ins, "X")
    out = x.permute(list(attrs.get("axis")))
    return {"Out": [out], "XShape": [_xshape(x)]}


@register_op("slice")
def slice_op(ctx, ins, attrs):
    x = single(ins, "Input")
    idx = [slice(None)] * x.ndim
    for ax, st, en in zip(attrs.get("axes"), attrs.get("starts"),
                          attrs.get("ends")):
        idx[ax] = slice(st, en)
    return {"Out": [x[tuple(idx)]]}
