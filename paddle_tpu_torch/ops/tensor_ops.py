"""Tensor creation/manipulation ops — port of
``paddle_tpu/ops/tensor_ops.py`` for ``fill_constant`` (:18),
``fill_zeros_like`` (:26), ``fill_constant_batch_size_like`` (:31),
``uniform_random`` (:42), ``gaussian_random`` (:54),
``truncated_gaussian_random`` (:65), ``cast`` (:76), ``concat`` (:83),
``split`` (:89), ``reshape2`` (:103), ``reshape`` (:115), ``transpose2``
(:125), ``transpose`` (:133), ``squeeze2`` (:139), ``unsqueeze2`` (:152),
``stack`` (:161), ``unstack`` (:167), ``expand`` (:176), ``slice``
(:183), ``gather`` (:195), ``scatter`` (:202), ``assign`` (:214),
``shape`` (:219), ``top_k`` (:225), ``top_k_grad`` (:233), ``arg_max``
(:250), ``arg_min`` (:257), ``argsort`` (:264), ``one_hot`` (:272),
``range`` (:282), ``label_smooth`` (:299), ``pad`` (:307), ``pad2d``
(:316), ``increment`` (:329), ``assign_value`` (:337), ``isfinite``
(:348), ``cumsum`` (:357) and ``reverse`` (:373).

The index ops' grads end in a scatter-add of the output grad into a zero
input (``gather``, the reflected and replicated borders of ``pad2d``);
``take`` adds there with ``index_put_(accumulate=True)``, whose CUDA path
sorts the indices and adds in a fixed order, so a step is bitwise
repeatable (``index_select``'s own grad adds with float atomics). The
arg ops return int64, as the desc says (int32 at run time in the
reference, whose 64-bit types are off).

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
from paddle_tpu_torch.ops.common import single, take


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


def _fluid_shape(x, shape):
    # Fluid semantics: 0 copies the input's dim, -1 is inferred
    return [x.shape[i] if d == 0 else d for i, d in enumerate(shape)]


@register_op("reshape2")
def reshape2(ctx, ins, attrs):
    x = single(ins, "X")
    return {"Out": [x.reshape(_fluid_shape(x, list(attrs.get("shape"))))],
            "XShape": [_xshape(x)]}


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


@register_op("fill_zeros_like", grad=None)
def fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(single(ins, "X"))]}


@register_op("reshape")
def reshape(ctx, ins, attrs):
    """``reshape2`` without its ``XShape`` output."""
    x = single(ins, "X")
    return {"Out": [x.reshape(_fluid_shape(x, list(attrs.get("shape"))))]}


@register_op("transpose")
def transpose(ctx, ins, attrs):
    return {"Out": [single(ins, "X").permute(list(attrs.get("axis")))]}


@register_op("squeeze2")
def squeeze2(ctx, ins, attrs):
    """The unit dims ``axes`` dropped, the last first; every unit dim when
    ``axes`` is empty."""
    x = single(ins, "X")
    axes = attrs.get("axes", [])
    out = x
    if axes:
        for ax in sorted(axes, reverse=True):
            out = out.squeeze(ax)
    else:
        out = x.squeeze()
    return {"Out": [out], "XShape": [_xshape(x)]}


@register_op("stack")
def stack(ctx, ins, attrs):
    return {"Y": [torch.stack(ins.get("X", []), dim=attrs.get("axis", 0))]}


@register_op("unstack")
def unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(single(ins, "X"),
                                   dim=attrs.get("axis", 0)))}


@register_op("gather")
def gather(ctx, ins, attrs):
    """Rows ``Index`` of ``X`` (``jnp.take`` along axis 0); the grad adds
    the output grad back by ``take``'s sorted scatter."""
    x = single(ins, "X")
    index = single(ins, "Index")
    out = take(x, index, 0)
    return {"Out": [out.reshape(tuple(index.shape) + tuple(x.shape[1:]))]}


@register_op("scatter")
def scatter(ctx, ins, attrs):
    """``X`` with rows ``Ids`` set to ``Updates`` (``overwrite``), else
    with ``Updates`` added there. Duplicate ids under ``overwrite`` have no
    defined winner on the card, as in the reference."""
    x = single(ins, "X")
    ids = single(ins, "Ids").long()
    updates = single(ins, "Updates").to(x.dtype)
    return {"Out": [x.index_put(
        (ids,), updates, accumulate=not attrs.get("overwrite", True))]}


def _int_vector(values, dtype, device):
    """A 1-D tensor of host ints on ``device``, written by fills (no copy
    from the host, so a CUDA graph may hold it)."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i] = v
    return out


@register_no_grad_op("shape")
def shape_op(ctx, ins, attrs):
    """The input's shape, int32."""
    x = single(ins, "Input")
    return {"Out": [_int_vector(list(x.shape), torch.int32, x.device)]}


@register_no_grad_op("arg_max")
def arg_max(ctx, ins, attrs):
    """The first index of the largest value along ``axis``, int64."""
    return {"Out": [torch.argmax(single(ins, "X"), dim=attrs.get("axis", -1))]}


@register_no_grad_op("arg_min")
def arg_min(ctx, ins, attrs):
    return {"Out": [torch.argmin(single(ins, "X"), dim=attrs.get("axis", -1))]}


@register_no_grad_op("argsort")
def argsort(ctx, ins, attrs):
    """Ascending values and their int64 indices along ``axis``; equal
    values keep their order (a stable sort, as ``jnp.argsort``)."""
    vals, idx = torch.sort(single(ins, "X"), dim=attrs.get("axis", -1),
                           stable=True)
    return {"Out": [vals], "Indices": [idx]}


@register_no_grad_op("range", capturable=False)
def range_op(ctx, ins, attrs):
    """``arange(Start, End, Step)`` in Start's dtype. The bounds are read on
    the host (the reference needs them static), so no graph holds it."""
    start, end, step = (single(ins, s) for s in ("Start", "End", "Step"))
    bounds = [t.reshape(-1)[0].item() for t in (start, end, step)]
    return {"Out": [torch.arange(*bounds, dtype=start.dtype,
                                 device=ctx.device)]}


@register_op("pad")
def pad(ctx, ins, attrs):
    """``paddings`` [before_0, after_0, before_1, ...] of ``pad_value``."""
    x = single(ins, "X")
    p = attrs.get("paddings")
    widths = []
    for i in reversed(range(x.ndim)):  # F.pad lists the last dim first
        widths += [p[2 * i], p[2 * i + 1]]
    return {"Out": [F.pad(x, widths, value=attrs.get("pad_value", 0.0))]}


def _border_index(n, before, after, mode, device):
    """Source index of each padded position of a dim of size ``n``:
    mirrored about the edge (``reflect``, the edge not repeated) or
    clamped to it (``edge``)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "reflect":
        i = i.abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i)
    return i.clamp(0, n - 1)


@register_op("pad2d")
def pad2d(ctx, ins, attrs):
    """NCHW, ``paddings`` [top, bottom, left, right]: ``constant`` with
    ``pad_value``, or ``reflect`` / ``edge`` as gathers of the border rows
    and columns, whose grads add back by ``take``'s sorted scatter
    (``F.pad``'s reflect and replicate grads add with float atomics)."""
    x = single(ins, "X")
    p = attrs.get("paddings", [0, 0, 0, 0])
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": [F.pad(x, [p[2], p[3], p[0], p[1]],
                              value=attrs.get("pad_value", 0.0))]}
    if mode not in ("reflect", "edge"):
        raise KeyError(mode)
    rows = _border_index(x.shape[2], p[0], p[1], mode, x.device)
    cols = _border_index(x.shape[3], p[2], p[3], mode, x.device)
    return {"Out": [take(take(x, rows, 2), cols, 3)]}


@register_no_grad_op("isfinite")
def isfinite(ctx, ins, attrs):
    """One bool: every element of every input is finite."""
    ok = torch.ones((), dtype=torch.bool, device=ctx.device)
    for x in ins.get("X", []):
        ok = ok & torch.isfinite(x).all()
    return {"Out": [ok]}


@register_op("cumsum")
def cumsum(ctx, ins, attrs):
    """Inclusive sums along ``axis``; ``exclusive`` subtracts ``x`` from
    them (as the reference does, not a shifted scan); ``reverse`` sums from
    the end."""
    x = single(ins, "X")
    axis = attrs.get("axis", -1)
    reverse = attrs.get("reverse", False)
    if reverse:
        x = torch.flip(x, [axis])
    out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    if reverse:
        out = torch.flip(out, [axis])
    return {"Out": [out]}


@register_op("reverse")
def reverse(ctx, ins, attrs):
    axes = attrs.get("axis")
    if isinstance(axes, int):
        axes = [axes]
    return {"Out": [torch.flip(single(ins, "X"), list(axes))]}
