"""Sequence ops — port of ``paddle_tpu/ops/sequence_ops.py``: every
lowering of the file, ``sequence_pool`` (:21), ``sequence_softmax``
(:51), ``sequence_expand`` (:62), ``sequence_mask`` (:70),
``sequence_reverse`` (:80), ``im2sequence`` (:93), ``sequence_concat``
(:122), ``sequence_slice`` (:155), ``sequence_expand_as`` (:172),
``sequence_pad`` (:184), ``sequence_unpad`` (:213), ``sequence_conv``
(:225) and ``sequence_enumerate`` (:254).

The reference's LoDTensor batches become padded [B, T, ...] tensors with
a [B] ``Length``, as in the JAX package: each op masks the padding. An
op given no ``Length`` reads every row as full, as ``sequence_pool``
does; the JAX package's ``sequence_softmax``, ``sequence_reverse``,
``sequence_pad`` and ``sequence_conv`` fail without one, so its
``nets.sequence_conv_pool``, which passes none, cannot be built. The
ops that move steps along time (reverse, concat, slice) read them with
``ops/common.py`` ``take`` over the [B*T] rows, so their grads add with
a sorted ``index_put_``, in the same order on every run.
"""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import single, take


def _mask(lengths, max_len, dtype):
    steps = torch.arange(max_len, device=lengths.device)
    return (steps[None, :] < lengths.reshape(-1, 1)).to(dtype)


@register_op("sequence_pool", no_grad_inputs=("Length",))
def sequence_pool(ctx, ins, attrs):
    x = single(ins, "X")              # [B, T, D] padded
    lengths = single(ins, "Length")   # [B]; absent: every row full
    if lengths is None:
        lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                             device=x.device)
    pooltype = attrs.get("pooltype", "SUM").upper()
    mask = _mask(lengths, x.shape[1], x.dtype)[..., None]
    if pooltype == "SUM":
        out = (x * mask).sum(1)
    elif pooltype in ("AVERAGE", "SQRT"):
        denom = lengths.reshape(-1, 1).to(x.dtype).clamp_min(1.0)
        if pooltype == "SQRT":
            denom = denom.sqrt()
        out = (x * mask).sum(1) / denom
    elif pooltype == "MAX":
        out = torch.where(mask > 0, x, torch.full_like(x, -1e38)).amax(1)
    elif pooltype == "LAST":
        idx = (lengths - 1).clamp_min(0).to(torch.int64)
        idx = idx.reshape(-1, 1, 1).expand(-1, 1, x.shape[2])
        out = torch.gather(x, 1, idx)[:, 0]
    elif pooltype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError(pooltype)
    return {"Out": [out]}


@register_op("sequence_mask", grad=None)
def sequence_mask(ctx, ins, attrs):
    """[B, maxlen] float32 of 1 where the step is below the row's length
    (the reference's ``_mask`` dtype), from lengths of any shape read as
    [B]; ``maxlen`` must be static, as in the reference."""
    x = single(ins, "X")
    maxlen = attrs.get("maxlen", -1)
    if maxlen < 0:
        raise ValueError("sequence_mask needs a static maxlen")
    return {"Y": [_mask(x, maxlen, torch.float32)]}


def _lengths(ins, x):
    """The [B] ``Length`` of ``x`` [B, T, ...], or T for every row where
    the op has none, as ``sequence_pool`` reads a missing one (the JAX
    package's ``sequence_softmax``, ``sequence_reverse``,
    ``sequence_pad`` and ``sequence_conv`` fail without one)."""
    lengths = single(ins, "Length")
    if lengths is None:
        return torch.full((x.shape[0],), x.shape[1], dtype=torch.int64,
                          device=x.device)
    return lengths.reshape(-1)


def _row_mask(mask, x):
    """A [B, T] mask shaped to broadcast over ``x`` [B, T, ...]."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - 2))


def _take_steps(x, src):
    """``x`` [B, T, ...] read at steps ``src`` [B, T'] of each row: out[b,
    t] = x[b, src[b, t]], by ``take`` over the [B*T] rows."""
    b, t = x.shape[0], x.shape[1]
    rows = torch.arange(b, device=x.device).reshape(-1, 1) * t + src
    out = take(x.reshape((b * t,) + tuple(x.shape[2:])), rows)
    return out.reshape(tuple(src.shape) + tuple(x.shape[2:]))


@register_op("sequence_softmax", no_grad_inputs=("Length",))
def sequence_softmax(ctx, ins, attrs):
    """Softmax over each row's first ``Length`` steps of [B, T] (all of
    them without one); zero past them."""
    x = single(ins, "X")
    mask = _mask(_lengths(ins, x), x.shape[1], x.dtype)
    neg = torch.where(mask > 0, x, torch.full_like(x, -1e38))
    e = torch.exp(neg - neg.amax(1, keepdim=True)) * mask
    return {"Out": [e / e.sum(1, keepdim=True).clamp_min(1e-12)]}


@register_op("sequence_expand", no_grad_inputs=("Y",))
def sequence_expand(ctx, ins, attrs):
    """[B, D] broadcast across ``Y``'s time dim into [B, T, D]."""
    x = single(ins, "X")
    t = single(ins, "Y").shape[1]
    return {"Out": [x[:, None, :].expand(x.shape[0], t, x.shape[-1])]}


@register_op("sequence_reverse", no_grad_inputs=("Length",))
def sequence_reverse(ctx, ins, attrs):
    """Each row's first ``Length`` steps of [B, T, D] reversed, the
    padding left in place."""
    x = single(ins, "X")
    lengths = _lengths(ins, x).reshape(-1, 1)
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    src = torch.where(idx < lengths, lengths - 1 - idx, idx)
    return {"Y": [_take_steps(x, src)]}


@register_op("im2sequence")
def im2sequence(ctx, ins, attrs):
    """The ``kernels`` patches of an NCHW image at ``strides``, after
    ``paddings`` [up, left, down, right]: [N*oh*ow, C*kh*kw], each row
    channel-major then kernel row-major, as the JAX package stacks them
    (``F.unfold``'s order)."""
    x = single(ins, "X")
    kh, kw = attrs.get("kernels")
    strides = attrs.get("strides", [1, 1])
    up, left, down, right = attrs.get("paddings", [0, 0, 0, 0])
    cols = F.unfold(F.pad(x, (left, right, up, down)), (kh, kw),
                    stride=tuple(strides))          # [N, C*kh*kw, oh*ow]
    return {"Out": [cols.transpose(1, 2).reshape(-1, cols.shape[1])]}


@register_op("sequence_concat", no_grad_inputs=("Length",))
def sequence_concat(ctx, ins, attrs):
    """Row i of the output is x1[i, :l1[i]] ++ x2[i, :l2[i]] ++ ...,
    left-compacted into a padded [B, sum(T_k), ...] tensor; zeros past
    it. Without lengths every row is full."""
    xs = ins.get("X", [])
    lens = ins.get("Length", [])
    if not lens:
        lens = [torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                           device=x.device) for x in xs]
    if len(xs) != len(lens):
        raise ValueError(
            "sequence_concat needs one Length per input (got %d inputs, "
            "%d lengths)" % (len(xs), len(lens)))
    b = xs[0].shape[0]
    t_out = sum(x.shape[1] for x in xs)
    out = xs[0].new_zeros((b, t_out) + tuple(xs[0].shape[2:]))
    pos = torch.arange(t_out, device=out.device)[None, :]
    start = torch.zeros((b, 1), dtype=torch.int64, device=out.device)
    for x, l in zip(xs, lens):
        l = l.reshape(-1, 1).long()
        in_seg = (pos >= start) & (pos < start + l)
        src = (pos - start).clamp(0, x.shape[1] - 1)
        out = torch.where(_row_mask(in_seg, x), _take_steps(x, src), out)
        start = start + l
    return {"Out": [out]}


@register_op("sequence_slice", no_grad_inputs=("Offset", "Length"))
def sequence_slice(ctx, ins, attrs):
    """Each row's steps [offset, offset + length) moved to the front of a
    same-T padded tensor; zeros past them."""
    x = single(ins, "X")
    offset = single(ins, "Offset").reshape(-1, 1).long()
    length = single(ins, "Length").reshape(-1, 1).long()
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    src = (pos + offset).clamp(0, t - 1)
    out = _take_steps(x, src)
    return {"Out": [torch.where(_row_mask(pos < length, x), out,
                                torch.zeros_like(out))]}


@register_op("sequence_expand_as", no_grad_inputs=("Y",))
def sequence_expand_as(ctx, ins, attrs):
    """[B, ...] broadcast along ``Y``'s time dim into [B, T, ...]."""
    x = single(ins, "X")
    t = single(ins, "Y").shape[1]
    return {"Out": [x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))]}


@register_op("sequence_pad", no_grad_inputs=("Length", "PadValue"))
def sequence_pad(ctx, ins, attrs):
    """[B, T, ...] padded or cut to ``padded_length`` steps, ``PadValue``
    past each row's length; ``Length`` comes back clamped to
    ``padded_length`` (int64), so that it agrees with the tensor."""
    x = single(ins, "X")
    lengths = _lengths(ins, x)
    pad_value = single(ins, "PadValue")
    padded_length = int(attrs.get("padded_length", -1))
    t = x.shape[1]
    if padded_length < 0:
        padded_length = t
    if padded_length > t:
        x = torch.cat([x, x.new_zeros((x.shape[0], padded_length - t)
                                      + tuple(x.shape[2:]))], 1)
    else:
        x = x[:, :padded_length]
    steps = torch.arange(padded_length, device=x.device)[None, :]
    mask = _row_mask(steps < lengths[:, None], x)
    out = torch.where(mask, x, pad_value.reshape(()).to(x.dtype))
    return {"Out": [out],
            "Length": [lengths.clamp_max(padded_length).long()]}


@register_op("sequence_unpad", no_grad_inputs=("Length",))
def sequence_unpad(ctx, ins, attrs):
    """Zeros past each row's length (the port's ragged form is the padded
    one)."""
    x = single(ins, "X")
    lengths = single(ins, "Length").reshape(-1)
    steps = torch.arange(x.shape[1], device=x.device)[None, :]
    return {"Out": [torch.where(_row_mask(steps < lengths[:, None], x), x,
                                torch.zeros_like(x))]}


@register_op("sequence_conv", no_grad_inputs=("Length",))
def sequence_conv(ctx, ins, attrs):
    """Context-window convolution over time: the ``contextLength`` steps
    from ``contextStart`` around each step, zero outside the row's
    length, concatenated context-step-major into [B, T, ctx*D] and
    multiplied by ``Filter`` [ctx*D, F]; zero past each row's length."""
    x = single(ins, "X")
    lengths = _lengths(ins, x)
    filt = single(ins, "Filter")
    ctx_len = int(attrs.get("contextLength"))
    ctx_start = int(attrs.get("contextStart", -((ctx_len - 1) // 2)))
    t = x.shape[1]
    steps = torch.arange(t, device=x.device)
    step_mask = (steps[None, :] < lengths[:, None])[..., None]
    xz = torch.where(step_mask, x, torch.zeros_like(x))
    cols = []
    for k in range(ctx_len):
        shift = ctx_start + k
        pos = steps + shift
        valid = (pos >= 0)[None, :] & (pos[None, :] < lengths[:, None])
        rolled = torch.roll(xz, -shift, dims=1)
        cols.append(torch.where(valid[..., None], rolled,
                                torch.zeros_like(rolled)))
    out = torch.matmul(torch.cat(cols, -1), filt)
    return {"Out": [torch.where(step_mask, out, torch.zeros_like(out))]}


@register_op("sequence_enumerate", grad=None,
             no_grad_inputs=("X", "Length"))
def sequence_enumerate(ctx, ins, attrs):
    """Sliding windows of ids: [B, T] -> [B, T, win], out[b, t] = ids[b,
    t:t+win], ``pad_value`` past the row's length (or past T without a
    ``Length``). A trailing dim of 1 is squeezed."""
    x = single(ins, "X")
    if x.ndim >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    win = int(attrs.get("win_size"))
    pad_value = attrs.get("pad_value", 0)
    t = x.shape[-1]
    lengths = single(ins, "Length")
    bound = lengths.reshape(-1, 1) if lengths is not None else t
    steps = torch.arange(t, device=x.device)[None, :]
    cols = [torch.where(steps + k < bound, torch.roll(x, -k, dims=-1),
                        torch.full_like(x, pad_value))
            for k in range(win)]
    return {"Out": [torch.stack(cols, -1)]}
