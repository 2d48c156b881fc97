"""Tensor creation/manipulation ops — port of
``paddle_tpu/ops/tensor_ops.py`` for ``fill_constant`` (:18),
``fill_constant_batch_size_like`` (:31), ``uniform_random`` (:42), ``gaussian_random`` (:54),
``truncated_gaussian_random`` (:65), ``cast`` (:76), ``concat`` (:83),
``split`` (:89), ``reshape2`` (:103), ``transpose2`` (:125), ``unsqueeze2``
(:152), ``expand`` (:176), ``slice`` (:183), ``top_k``
(:225), ``top_k_grad`` (:233), ``one_hot`` (:272), ``assign`` (:214), ``label_smooth``
(:299), ``increment`` (:329) and ``assign_value`` (:337).

The random ops draw float32 on the op's device from its (seed, run, op)
stream and cast, as the reference draws float32 and casts; their bits
are torch's, not the reference's threefry. The stream is a device
generator seeded on the host, so a CUDA graph would freeze its draw:
these ops are not capturable (they run in startup programs, eagerly)."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op, register_no_grad_op
from paddle_tpu_torch.core.types import (
    VarType, convert_dtype_to_np, convert_dtype_to_torch,
)
from paddle_tpu_torch.ops.common import single


def _torch_dtype(attr_dtype):
    return convert_dtype_to_torch(VarType(attr_dtype))


@register_no_grad_op("fill_constant")
def fill_constant(ctx, ins, attrs):
    shape = attrs.get("shape", [])
    dtype = _torch_dtype(attrs.get("dtype", int(VarType.FP32)))
    return {"Out": [torch.full(list(shape), attrs.get("value", 0.0),
                               dtype=dtype, device=ctx.device)]}


@register_no_grad_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(ctx, ins, attrs):
    """``value`` in the attrs' shape, dim ``output_dim_idx`` taken from
    the input's dim ``input_dim_idx`` (the batch)."""
    x = single(ins, "Input")
    shape = list(attrs.get("shape"))
    shape[attrs.get("output_dim_idx", 0)] = x.shape[
        attrs.get("input_dim_idx", 0)]
    dtype = _torch_dtype(attrs.get("dtype", int(VarType.FP32)))
    return {"Out": [torch.full(shape, attrs.get("value", 0.0), dtype=dtype,
                               device=ctx.device)]}


@register_no_grad_op("uniform_random", needs_rng=True, capturable=False)
def uniform_random(ctx, ins, attrs):
    def draw(out, gen):
        out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                     generator=gen)
    return _draw(ctx, attrs, draw)


@register_no_grad_op("gaussian_random", needs_rng=True, capturable=False)
def gaussian_random(ctx, ins, attrs):
    def draw(out, gen):
        out.normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                    generator=gen)
    return _draw(ctx, attrs, draw)


# erf(2 / sqrt(2)): the bounds -2 and 2 of the truncated normal, mapped
# to [-1, 1] by the standard normal's CDF as 2 * cdf - 1
_ERF_2 = math.erf(2.0 / math.sqrt(2.0))


@register_no_grad_op("truncated_gaussian_random", needs_rng=True,
                     capturable=False)
def truncated_gaussian_random(ctx, ins, attrs):
    """A normal truncated to [-2, 2] standard deviations, by the inverse
    CDF of a uniform draw between the bounds' CDF values (the reference's
    library draws it so, tensor_ops.py:71), then scaled and shifted."""
    def draw(out, gen):
        out.uniform_(-_ERF_2, _ERF_2, generator=gen)
        out.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        out.mul_(attrs.get("std", 1.0)).add_(attrs.get("mean", 0.0))
    return _draw(ctx, attrs, draw)


def _draw(ctx, attrs, draw):
    """``draw(out, generator)`` fills a float32 tensor of the attrs' shape
    on the op's device (nothing on ``meta``); returns it in the attrs'
    dtype."""
    dtype = _torch_dtype(attrs.get("dtype", int(VarType.FP32)))
    out = torch.empty(list(attrs.get("shape")), dtype=torch.float32,
                      device=ctx.device)
    gen = ctx.rng()
    if gen is not None:
        draw(out, gen)
    return {"Out": [out.to(dtype)]}


@register_op("cast")
def cast(ctx, ins, attrs):
    return {"Out": [single(ins, "X").to(_torch_dtype(attrs.get("out_dtype")))]}


@register_op("concat")
def concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins.get("X", []), dim=attrs.get("axis", 0))]}


def _xshape(x):
    # XShape carries the input shape behind a leading 0 dim (no data)
    return torch.empty((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register_op("split")
def split(ctx, ins, attrs):
    """``num`` equal parts, else parts of the ``sections`` sizes, along
    ``axis``."""
    x = single(ins, "X")
    axis = attrs.get("axis", 0)
    num = attrs.get("num", 0)
    if num:
        if x.shape[axis] % num:
            raise ValueError("split: dim %d of size %d does not divide "
                             "into %d parts" % (axis, x.shape[axis], num))
        outs = torch.chunk(x, num, dim=axis)
    else:
        outs = torch.split(x, list(attrs.get("sections", [])), dim=axis)
    return {"Out": list(outs)}


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


@register_op("unsqueeze2")
def unsqueeze2(ctx, ins, attrs):
    x = single(ins, "X")
    out = x
    for ax in sorted(attrs.get("axes", [])):
        out = out.unsqueeze(ax)
    return {"Out": [out], "XShape": [_xshape(x)]}


@register_op("expand")
def expand(ctx, ins, attrs):
    """``X`` tiled ``expand_times`` along each dim (``jnp.tile``)."""
    return {"Out": [torch.tile(single(ins, "X"),
                               tuple(attrs.get("expand_times")))]}


@register_op("slice")
def slice_op(ctx, ins, attrs):
    x = single(ins, "Input")
    idx = [slice(None)] * x.ndim
    for ax, st, en in zip(attrs.get("axes"), attrs.get("starts"),
                          attrs.get("ends")):
        idx[ax] = slice(st, en)
    return {"Out": [x[tuple(idx)]]}


@register_op("top_k")
def top_k(ctx, ins, attrs):
    """The k largest along the last dim, in descending order, and their
    int64 indices."""
    vals, idx = torch.topk(single(ins, "X"), attrs.get("k", 1), dim=-1)
    return {"Out": [vals], "Indices": [idx]}


@register_no_grad_op("top_k_grad")
def top_k_grad(ctx, ins, attrs):
    """The value grads scattered back to the selected positions of a
    zero X grad (tensor_ops.py:233)."""
    x = single(ins, "X")
    _, idx = torch.topk(x, attrs.get("k", 1), dim=-1)
    g = single(ins, "Out@GRAD").to(x.dtype)
    return {"X@GRAD": [torch.zeros_like(x).scatter_add_(-1, idx, g)]}


@register_no_grad_op("one_hot")
def one_hot(ctx, ins, attrs):
    """float32 one-hot rows of depth ``depth``; a trailing dim of 1 is
    squeezed. An id outside [0, depth) gives a zero row, as in the JAX
    package."""
    ids = single(ins, "X")
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    depth = attrs.get("depth")
    ids = ids.long()
    in_range = (ids >= 0) & (ids < depth)
    out = F.one_hot(torch.where(in_range, ids, torch.zeros_like(ids)),
                    depth).to(torch.float32)
    return {"Out": [out * in_range.unsqueeze(-1)]}


@register_op("label_smooth")
def label_smooth(ctx, ins, attrs):
    x = single(ins, "X")
    eps = attrs.get("epsilon", 0.0)
    return {"Out": [(1.0 - eps) * x + eps / x.shape[-1]]}


@register_op("assign")
def assign(ctx, ins, attrs):
    return {"Out": [single(ins, "X")]}


@register_no_grad_op("increment")
def increment(ctx, ins, attrs):
    """``x + step`` in x's dtype (an integer counter stays integer); the
    learning-rate schedulers' step counter, written in place under
    capture like any other state."""
    x = single(ins, "X")
    step = attrs.get("step", 1.0)
    step = float(step) if x.is_floating_point() else int(step)
    return {"Out": [x + step]}


@register_no_grad_op("assign_value", capturable=False)
def assign_value(ctx, ins, attrs):
    """The attrs' values (``fp32_values``, else ``int32_values``) as a
    tensor of the attrs' shape and dtype: a copy from the host, so no
    graph holds it (it runs in startup programs, eagerly)."""
    dtype = convert_dtype_to_np(VarType(attrs.get("dtype", int(VarType.FP32))))
    vals = attrs.get("fp32_values") or attrs.get("int32_values", [])
    arr = np.asarray(vals, dtype=dtype).reshape(attrs.get("shape"))
    return {"Out": [torch.as_tensor(arr, device=ctx.device)]}
