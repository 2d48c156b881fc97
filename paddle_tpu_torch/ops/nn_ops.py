"""NN ops — port of ``paddle_tpu/ops/nn_ops.py`` for ``conv2d`` (:31)
and its direct grad ``conv2d_grad`` (:66), ``depthwise_conv2d`` (:102)
and its grad (:94), ``pool2d`` (:149), ``batch_norm`` (:215) and its
direct grad ``batch_norm_grad`` (:271), the ``sync_batch_norm`` alias
(:331), ``fused_attention`` (:379) and its direct grad
``fused_attention_grad`` (:414), ``layer_norm`` (:480), ``dropout``
(:506), ``lookup_table`` (:527) and its grad ``lookup_table_grad``
(:538), dense or a ``SelectedRows``; and the image ops
``conv2d_transpose`` (:110), ``lrn`` (:560), ``l2_normalize`` (:578),
``norm`` (:587), ``group_norm`` (:596), ``bilinear_interp`` (:632),
``nearest_interp`` (:656), ``prelu`` (:675) and ``maxout`` (:689), each
the reference's formula (not ``F.local_response_norm``, whose ``alpha``
is divided by ``n``, nor ``F.interpolate``, which has no ``align_mode``
1). ``pool2d``, ``layer_norm``, ``dropout`` and the image ops have no
grad lowering of their own: the engine derives theirs as
``torch.func.vjp`` of the forward (``engine/lowering.py``), which
re-draws the forward's dropout mask from the same seed. The
interpolations gather rows and columns with ``take``, whose grad adds
back in a fixed order on the card.

Convolutions run through cuDNN (``torch.nn.functional.conv2d``) in NCHW,
the reference's layout, or, where the layout pass (analysis/layout.py)
rewrote them, on NHWC activations and HWIO filters through cuDNN's
channels_last kernels; so do ``pool2d`` and (channel axis last)
``batch_norm``. Their grads are cuDNN's backward-data and
backward-filter (``aten.convolution_backward``), never a second forward.
The transposed convolution is a float64 GEMM and ``F.fold`` instead
(``conv2d_transpose``).
Batch norm computes its statistics as the reference does, not as
``F.batch_norm`` would: the biased variance ``E[x^2] - mean^2`` in
float32, and Paddle's momentum (``running = m * running + (1 - m) *
batch``, the reverse of torch's).

Dropout seeds come from the run's seed table (``LowerContext.seed``): the
forward op and its grad op share one RNG stream id, so they read the same
entry. The reference draws the attention kernel's seed in [0, int32 max)
and the generic dropout's in [0, 2**32) (nn_ops.py:351;
``hash_keep_mask``, common.py:110)."""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_no_grad_op, register_op
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.ops.common import (
    amp_cast, flatten_lookup_ids, fp32_accum, hash_keep_mask, scatter_rows,
    single, take,
)

ATTENTION_SEED_HIGH = 2 ** 31 - 1
DROPOUT_SEED_HIGH = 2 ** 32


def _attention_seed_range(attrs):
    if attrs.get("is_test", False) or not attrs.get("dropout_rate", 0.0):
        return None
    return ATTENTION_SEED_HIGH


def _dropout_seed_range(attrs):
    return None if attrs.get("is_test", False) else DROPOUT_SEED_HIGH


def _nchw(attrs, op_type):
    """Raise for an NHWC op the reference never runs: its layout pass
    keeps ``conv2d_transpose`` a barrier (analysis/layout.py), so only a
    hand-built desc can ask for it."""
    if attrs.get("data_format", "NCHW") != "NCHW":
        raise NotImplementedError(
            "%s with data_format %r: the reference's layout pass never "
            "rewrites this op to NHWC, and neither package lowers it so"
            % (op_type, attrs.get("data_format")))


def _nhwc(attrs):
    """Whether the layout pass (analysis/layout.py) rewrote this op to
    NHWC: its activations arrive NHWC and its filter HWIO."""
    return attrs.get("data_format", "NCHW") == "NHWC"


# views of an NHWC activation as NCHW and back, and of an HWIO filter as
# OIHW and back (analysis/layout.py's permutations)
_NHWC_AS_NCHW = (0, 3, 1, 2)
_NCHW_AS_NHWC = (0, 2, 3, 1)
_HWIO_AS_OIHW = (3, 2, 0, 1)
_OIHW_AS_HWIO = (2, 3, 1, 0)


def _conv2d_apply(x, w, attrs):
    """NCHW x, OIHW w (I = C / groups), symmetric padding (nn_ops.py:45).
    A float32 conv accumulates in float32 (TF32 is the caller's switch,
    ``torch.backends.cudnn.allow_tf32``); a bfloat16 one returns bfloat16,
    cuDNN accumulating in float32. Under NHWC x is NHWC and w HWIO: the
    NCHW view of a contiguous NHWC tensor is channels_last, so cuDNN
    takes its NHWC kernels without a copy of x, and its channels_last
    output viewed NHWC is contiguous again; the HWIO filter viewed OIHW
    is not channels_last, and cuDNN may copy it."""
    nhwc = _nhwc(attrs)
    if nhwc:
        x, w = x.permute(*_NHWC_AS_NCHW), w.permute(*_HWIO_AS_OIHW)
    out = F.conv2d(x, w, stride=tuple(attrs.get("strides", [1, 1])),
                   padding=tuple(attrs.get("paddings", [0, 0])),
                   dilation=tuple(attrs.get("dilations", [1, 1])),
                   groups=attrs.get("groups", 1))
    if nhwc:
        out = out.permute(*_NCHW_AS_NHWC).contiguous()
    return out


@register_op("conv2d")
def conv2d(ctx, ins, attrs):
    """Under AMP both operands are cast to bfloat16 and the output stays
    bfloat16 (nn_ops.py:33-43): the norms and losses after it upcast
    internally."""
    x, w = amp_cast(single(ins, "Input"), single(ins, "Filter"))
    return {"Output": [_conv2d_apply(x, w, attrs)]}


@register_no_grad_op("conv2d_grad")
def conv2d_grad(ctx, ins, attrs):
    """Direct conv gradients (nn_ops.py:66): cuDNN's backward-data and
    backward-filter convolutions from the output grad, the forward is not
    run again. The output grad takes the forward output's dtype (bfloat16
    under AMP); ``dx`` comes back in x's dtype and ``dw`` in w's, so the
    master weights stay float32."""
    x, w = single(ins, "Input"), single(ins, "Filter")
    xa, wa = amp_cast(x, w)
    g = single(ins, "Output@GRAD").to(xa.dtype)
    nhwc = _nhwc(attrs)
    if nhwc:
        xa, wa = xa.permute(*_NHWC_AS_NCHW), wa.permute(*_HWIO_AS_OIHW)
        g = g.permute(*_NHWC_AS_NCHW)
        if not xa.is_cuda:
            # torch's CPU (oneDNN) convolution backward aborts the process
            # on a strided channels_last input; the CPU takes an NCHW copy
            xa = xa.contiguous()
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g, xa, wa, None, list(attrs.get("strides", [1, 1])),
        list(attrs.get("paddings", [0, 0])),
        list(attrs.get("dilations", [1, 1])), False, [0, 0],
        attrs.get("groups", 1), [True, True, False])
    if nhwc:
        dx = dx.permute(*_NCHW_AS_NHWC).contiguous()
        dw = dw.permute(*_OIHW_AS_HWIO).contiguous()
    return {"Input@GRAD": [dx.to(x.dtype)], "Filter@GRAD": [dw.to(w.dtype)]}


def _depthwise(ins, attrs):
    # the channel count lives last under the layout pass's NHWC rewrite
    attrs = dict(attrs)
    attrs["groups"] = single(ins, "Input").shape[3 if _nhwc(attrs) else 1]
    return attrs


@register_op("depthwise_conv2d")
def depthwise_conv2d(ctx, ins, attrs):
    return conv2d(ctx, ins, _depthwise(ins, attrs))


@register_no_grad_op("depthwise_conv2d_grad")
def depthwise_conv2d_grad(ctx, ins, attrs):
    return conv2d_grad(ctx, ins, _depthwise(ins, attrs))


def _ceil_extra(size, k, s, p):
    """Bottom/right padding that keeps ceil mode's last partial window
    (nn_ops.py:178-183)."""
    out = -(-(size + 2 * p - k) // s) + 1
    return max((out - 1) * s + k - size - p, p)


@register_op("pool2d")
def pool2d(ctx, ins, attrs):
    """Max or average pooling over NCHW windows (nn_ops.py:149). The input
    is padded explicitly, left/top by ``paddings`` and right/bottom by the
    same or, in ceil mode, by what the last partial window needs, with
    -inf for max and 0 for average; the windows then run unpadded. So
    every padding the reference takes gives its result (torch's own
    padding stops at half the window, and its ceil mode drops a last
    window that would start in the padding). Average pooling sums and
    divides by the window's in-input count (``exclusive``) or by its
    size, as the reference does. Global pooling (or adaptive to [1, 1])
    reduces H and W; its mean runs in float32 and returns x's dtype.
    Under NHWC the same pooling runs on the NCHW (channels_last) view of
    x, and its output is viewed NHWC again."""
    x = single(ins, "X")
    if _nhwc(attrs):
        x = x.permute(*_NHWC_AS_NCHW)
        out = _pool2d_nchw(x, attrs)
        return {"Out": [out.permute(*_NCHW_AS_NHWC).contiguous()]}
    return {"Out": [_pool2d_nchw(x, attrs)]}


def _pool2d_nchw(x, attrs):
    ptype = attrs.get("pooling_type", "max")
    ksize = list(attrs.get("ksize", [2, 2]))
    if attrs.get("global_pooling", False) or (
            attrs.get("adaptive", False) and ksize == [1, 1]):
        if ptype == "max":
            return x.amax(dim=(2, 3), keepdim=True)
        return fp32_accum(x).mean(dim=(2, 3), keepdim=True).to(x.dtype)
    strides = list(attrs.get("strides", [1, 1]))
    ph, pw = attrs.get("paddings", [0, 0])
    if attrs.get("ceil_mode", False):
        eh = _ceil_extra(x.shape[2], ksize[0], strides[0], ph)
        ew = _ceil_extra(x.shape[3], ksize[1], strides[1], pw)
    else:
        eh, ew = ph, pw
    pad = (pw, ew, ph, eh)
    if ptype == "max":
        low = (float("-inf") if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        return F.max_pool2d(F.pad(x, pad, value=low), ksize, strides)
    summed = F.avg_pool2d(F.pad(x, pad), ksize, strides, divisor_override=1)
    if attrs.get("exclusive", True):
        ones = F.pad(torch.ones_like(x[:1, :1]), pad)
        return summed / F.avg_pool2d(ones, ksize, strides,
                                     divisor_override=1)
    return summed / (ksize[0] * ksize[1])


def _bn_axes(x, layout):
    """(reduced dims, shape of a per-channel vector) (nn_ops.py:207)."""
    if layout == "NCHW" and x.ndim == 4:
        return (0, 2, 3), (1, -1, 1, 1)
    if x.ndim == 2:
        return (0,), (1, -1)
    return tuple(range(x.ndim - 1)), (1,) * (x.ndim - 1) + (-1,)


def _bn_use_global(ctx, attrs):
    return bool(attrs.get("use_global_stats", False)
                or attrs.get("is_test", False) or ctx.is_test)


def _batch_stats(xc, axes):
    """The batch mean and biased variance, E[x^2] - mean^2, in float32
    (nn_ops.py:247-250)."""
    mean = xc.mean(dim=axes)
    return mean, (xc * xc).mean(dim=axes) - mean * mean


@register_op("batch_norm", no_grad_inputs=("Mean", "Variance"),
             grad_needs_outputs=("SavedMean", "SavedVariance"))
def batch_norm(ctx, ins, attrs):
    """Batch normalization (nn_ops.py:215). In training the batch's
    statistics normalize, ``MeanOut``/``VarianceOut`` are
    ``momentum * running + (1 - momentum) * batch`` (the running variance
    takes the biased batch variance) and ``SavedMean``/``SavedVariance``
    are the batch mean and biased variance. With ``is_test`` or
    ``use_global_stats`` the running statistics normalize and pass
    through unchanged. Statistics and normalization compute in float32;
    ``Y`` takes x's dtype."""
    x = single(ins, "X")
    scale, bias = single(ins, "Scale"), single(ins, "Bias")
    mean_in, var_in = single(ins, "Mean"), single(ins, "Variance")
    momentum = attrs.get("momentum", 0.9)
    axes, pshape = _bn_axes(x, attrs.get("data_layout", "NCHW"))
    xc = fp32_accum(x)
    if _bn_use_global(ctx, attrs):
        mean, var = mean_in, var_in
        mean_out, var_out = mean_in, var_in
    else:
        mean, var = _batch_stats(xc, axes)
        mean_out = momentum * mean_in + (1.0 - momentum) * mean
        var_out = momentum * var_in + (1.0 - momentum) * var
    inv_std = torch.rsqrt(var + attrs.get("epsilon", 1e-5))
    y = (xc - mean.reshape(pshape)) * inv_std.reshape(pshape)
    y = y * scale.reshape(pshape) + bias.reshape(pshape)
    return {"Y": [y.to(x.dtype)], "MeanOut": [mean_out],
            "VarianceOut": [var_out], "SavedMean": [mean],
            "SavedVariance": [var]}


@register_no_grad_op("batch_norm_grad")
def batch_norm_grad(ctx, ins, attrs):
    """Direct batch-norm backward from the saved batch statistics
    (nn_ops.py:271); where the program has no ``SavedMean`` or
    ``SavedVariance``, the statistics are computed again (:294-303). With
    the running statistics in use the normalization is an affine map of
    x."""
    x, scale = single(ins, "X"), single(ins, "Scale")
    saved_mean = single(ins, "SavedMean")
    saved_var = single(ins, "SavedVariance")
    axes, pshape = _bn_axes(x, attrs.get("data_layout", "NCHW"))
    use_global = _bn_use_global(ctx, attrs)
    n = 1
    for a in axes:
        n *= x.shape[a]
    xc = fp32_accum(x)
    g = fp32_accum(single(ins, "Y@GRAD"))
    if saved_mean is None or saved_var is None:
        if use_global:
            saved_mean, saved_var = single(ins, "Mean"), single(
                ins, "Variance")
        else:
            saved_mean, saved_var = _batch_stats(xc, axes)
    inv_std = torch.rsqrt(saved_var + attrs.get("epsilon", 1e-5)).reshape(
        pshape)
    xhat = (xc - saved_mean.reshape(pshape)) * inv_std
    dbias = g.sum(dim=axes)
    dscale = (g * xhat).sum(dim=axes)
    s = scale.reshape(pshape)
    if use_global:
        dx = g * s * inv_std
    else:
        dx = inv_std * (g * s - (dbias.reshape(pshape) * s
                                 + xhat * dscale.reshape(pshape) * s) / n)
    return {"X@GRAD": [dx.to(x.dtype)],
            "Scale@GRAD": [dscale.to(scale.dtype)],
            "Bias@GRAD": [dbias.to(scale.dtype)]}


# sync_batch_norm all-reduces the batch statistics across devices
# (nn_ops.py:324-336); on one device it is batch_norm
register_op("sync_batch_norm", no_grad_inputs=("Mean", "Variance"),
            grad_needs_outputs=("SavedMean", "SavedVariance"))(batch_norm)
register_no_grad_op("sync_batch_norm_grad")(batch_norm_grad)


@register_op("fused_attention", needs_rng=True, no_grad_inputs=("SeqLens",),
             grad_needs_outputs=("Out", "Lse"),
             seed_range=_attention_seed_range)
def fused_attention_op(ctx, ins, attrs):
    """Whole-attention fusion over Q/K/V [B, H, T, D] with optional
    SeqLens [B] (or [B, 1]) key-padding lengths. On CUDA tensors the
    hand-written flash forward kernel runs; on CPU and meta tensors its
    plain torch version (kernels/flash_attention.py dispatches on
    ``q.is_cuda``). Emits ``Lse`` [B, H, Tq, 1] float32, the per-row
    logsumexp the backward kernels read."""
    from paddle_tpu_torch.kernels.flash_attention import (
        dispatch_attention_lse,
    )

    q, k, v, lens, rate, seed = _attention_args(ctx, ins, attrs)
    out, lse = dispatch_attention_lse(
        q, k, v, bool(attrs.get("causal", False)), attrs.get("scale", None),
        lens, rate, seed)
    return {"Out": [out], "Lse": [lse]}


@register_no_grad_op("fused_attention_grad", needs_rng=True,
                     seed_range=_attention_seed_range)
def fused_attention_grad_op(ctx, ins, attrs):
    """Direct attention backward from the forward op's saved ``Out`` and
    ``Lse`` ([B, H, Tq, 1]): on CUDA tensors the hand-written dQ and dK/dV
    kernels, on CPU tensors their plain version; the forward is never run
    again. The dropout seed is the forward op's (the same ``__rng_id__``),
    so the kernels re-derive its mask. Under AMP, Q/K/V are cast to
    bfloat16 as in the forward, and the grads come back in bfloat16."""
    from paddle_tpu_torch.kernels.flash_attention import (
        dispatch_attention_bwd,
    )

    q, k, v, lens, rate, seed = _attention_args(ctx, ins, attrs)
    out, lse = single(ins, "Out"), single(ins, "Lse")
    if out is None or lse is None:
        raise ValueError(
            "fused_attention_grad needs the forward's saved Out and Lse "
            "(append_backward wires them)")
    g = single(ins, "Out@GRAD")
    g = torch.zeros_like(q) if g is None else g
    dq, dk, dv = dispatch_attention_bwd(
        q, k, v, out, lse, g, bool(attrs.get("causal", False)),
        attrs.get("scale", None), lens, rate, seed)
    return {"Q@GRAD": [dq], "K@GRAD": [dk], "V@GRAD": [dv]}


def _attention_args(ctx, ins, attrs):
    """Shared forward/backward argument resolution — the grad op must see
    the same dtypes, mask, rate and dropout seed (the same per-op RNG
    stream) as the forward (nn_ops.py:339-354)."""
    if bool(attrs.get("sequence_parallel", False)):
        raise NotImplementedError(
            "fused_attention with sequence_parallel (ring attention) is not "
            "ported yet (ROADMAP Queue 1: multi-GPU, the sequence axis)")
    q, k, v = amp_cast(single(ins, "Q"), single(ins, "K"), single(ins, "V"))
    lens = single(ins, "SeqLens") if ins.get("SeqLens") else None
    if lens is not None:
        lens = lens.reshape(-1)  # accept [B] or [B, 1] feeds
    rate = float(attrs.get("dropout_rate", 0.0))
    if attrs.get("is_test", False) or ctx.is_test:
        rate = 0.0
    seed = ctx.seed(ATTENTION_SEED_HIGH) if rate > 0.0 else 0
    return q, k, v, lens, rate, seed


@register_op("layer_norm")
def layer_norm(ctx, ins, attrs):
    x = single(ins, "X")
    scale = single(ins, "Scale")
    bias = single(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    orig_dtype = x.dtype
    x = fp32_accum(x)
    norm_shape = tuple(x.shape[begin:])
    y = F.layer_norm(
        x, norm_shape,
        weight=None if scale is None else scale.reshape(norm_shape),
        bias=None if bias is None else bias.reshape(norm_shape), eps=eps)
    var, mean = torch.var_mean(x, dim=tuple(range(begin, x.ndim)),
                               unbiased=False)
    return {"Y": [y.to(orig_dtype)], "Mean": [mean.squeeze()],
            "Variance": [var.squeeze()]}


@register_op("dropout", needs_rng=True, seed_range=_dropout_seed_range)
def dropout(ctx, ins, attrs):
    x = single(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    is_test = attrs.get("is_test", False) or ctx.is_test
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test:
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": [out], "Mask": [torch.ones_like(x)]}
    keep = hash_keep_mask(ctx.seed(DROPOUT_SEED_HIGH), tuple(x.shape), p,
                          x.device)
    mask = keep.to(x.dtype)
    if impl == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    else:
        out = x * mask
    return {"Out": [out], "Mask": [mask]}


@register_op("lookup_table", no_grad_inputs=("Ids",))
def lookup_table(ctx, ins, attrs):
    w = single(ins, "W")
    flat_ids = flatten_lookup_ids(single(ins, "Ids")).long()
    # the rows by ``take``, whose grad (the remat lowering derives it) is
    # lookup_table_grad's sorted scatter
    out = take(w, flat_ids, 0).reshape(tuple(flat_ids.shape)
                                       + tuple(w.shape[1:]))
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        # the padding row contributes no output (lookup_table_op.h)
        out = torch.where((flat_ids == padding_idx).unsqueeze(-1),
                          torch.zeros_like(out), out)
    return {"Out": [out]}


@register_no_grad_op("lookup_table_grad")
def lookup_table_grad(ctx, ins, attrs):
    """The table gradient (reference: lookup_table_op.cc grad kernel and
    its SelectedRows path, framework/selected_rows.h:32), padding rows
    contributing nothing. With ``is_sparse=True`` it is a
    ``SelectedRows`` (rows = the batch's ids, values = the output grads)
    and no table-sized tensor is built; the optimizer lowerings update the
    rows. Dense, the output grads scatter-add into a zero table with
    ``index_put_(accumulate=True)``, whose CUDA path sorts the ids and
    adds each row's grads in a fixed order, so repeated steps agree bit
    for bit (as the reference's ``.at[rows].add`` does); ``index_add_``
    adds with float atomics on CUDA, in an order that changes from run to
    run."""
    w = single(ins, "W")
    rows = flatten_lookup_ids(single(ins, "Ids")).reshape(-1).long()
    vals = single(ins, "Out@GRAD").reshape(
        (rows.shape[0],) + tuple(w.shape[1:])).to(w.dtype)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        vals = torch.where((rows == padding_idx).unsqueeze(-1),
                           torch.zeros_like(vals), vals)
    if attrs.get("is_sparse", False):
        return {"W@GRAD": [SelectedRows(rows, vals, w.shape[0])]}
    return {"W@GRAD": [scatter_rows(w.shape, rows, vals)]}


@register_op("conv2d_transpose")
def conv2d_transpose(ctx, ins, attrs):
    """The transposed convolution of an NCHW input with an IOHW filter
    (I = C_in, O = C_out / groups), (H - 1) * s - 2p + d * (k - 1) + 1
    high: one GEMM lays each input pixel's kh x kw patch of every output
    channel (the filter times the pixel), and ``F.fold`` adds the
    overlapping patches into the output (the reference: the input
    dilated by the stride, convolved with the flipped, IO-swapped
    filter). Both sum in float64 and the output is rounded once, to the
    operands' result dtype: a float32 GEMM or cuDNN's transposed
    convolution sums each output's C_in * kh * kw / s^2 products in one
    float32 register, about 1e-6 of the output's largest element off,
    and a group norm after it magnifies that to 1e-3 of the filter's
    grad (PERF.md, Findings). On the H100 the FP64 tensor cores run float64
    GEMMs at float32's FFMA rate. The grads (a GEMM and ``F.unfold``)
    are float64 too, and deterministic."""
    _nchw(attrs, "conv2d_transpose")
    x, w = single(ins, "Input"), single(ins, "Filter")
    s = tuple(attrs.get("strides", [1, 1]))
    p = tuple(attrs.get("paddings", [0, 0]))
    d = tuple(attrs.get("dilations", [1, 1]))
    g = attrs.get("groups", 1)
    n, c_in, h, wd = x.shape
    _, o_g, kh, kw = w.shape
    out_hw = ((h - 1) * s[0] - 2 * p[0] + d[0] * (kh - 1) + 1,
              (wd - 1) * s[1] - 2 * p[1] + d[1] * (kw - 1) + 1)
    patches = torch.matmul(
        w.double().reshape(g, c_in // g, o_g * kh * kw).transpose(1, 2),
        x.double().reshape(n, g, c_in // g, h * wd))
    out = F.fold(patches.reshape(n, g * o_g * kh * kw, h * wd), out_hw,
                 (kh, kw), dilation=d, padding=p, stride=s)
    return {"Output": [out.to(torch.result_type(x, w))]}


@register_op("lrn")
def lrn(ctx, ins, attrs):
    """``x / (k + alpha * s) ** beta``, ``s`` the sum of squares over a
    window of ``n`` channels centred on each (zero beyond the edges);
    ``MidOut`` is ``k + alpha * s``."""
    x = single(ins, "X")  # NCHW
    n = attrs.get("n", 5)
    k = attrs.get("k", 2.0)
    alpha = attrs.get("alpha", 1e-4)
    half = n // 2
    padded = F.pad(torch.square(x), [0, 0, 0, 0, half, half])
    window = sum(padded[:, i:i + x.shape[1]] for i in range(n))
    mid = k + alpha * window
    return {"Out": [x / torch.pow(mid, attrs.get("beta", 0.75))],
            "MidOut": [mid]}


@register_op("l2_normalize")
def l2_normalize(ctx, ins, attrs):
    """``x / max(||x||, epsilon)`` along ``axis``; ``Norm`` is ``||x||``."""
    x = single(ins, "X")
    norm = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                                keepdim=True))
    return {"Out": [x / torch.clamp_min(norm, attrs.get("epsilon", 1e-10))],
            "Norm": [norm]}


@register_op("norm")
def norm(ctx, ins, attrs):
    """``x / sqrt(sum(x^2) + epsilon)`` along ``axis``."""
    x = single(ins, "X")
    norm_v = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                                  keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": [x / norm_v], "Norm": [norm_v]}


@register_op("group_norm")
def group_norm(ctx, ins, attrs):
    """Each sample's channels normalised in ``groups`` groups (biased
    variance), then scaled and shifted per channel. ``Mean`` and
    ``Variance`` are [N, G] with every unit dim squeezed, as the
    reference's ``jnp.squeeze`` (N or G of 1 drops that axis too)."""
    x = single(ins, "X")  # NCHW
    scale, bias = single(ins, "Scale"), single(ins, "Bias")
    groups = attrs.get("groups", 1)
    n, c = x.shape[0], x.shape[1]
    g = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, g.ndim))
    mean = torch.mean(g, dim=axes, keepdim=True)
    var = torch.mean(torch.square(g - mean), dim=axes, keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + attrs.get("epsilon", 1e-5))).reshape(
        x.shape)
    pshape = (1, c) + (1,) * (x.ndim - 2)
    if scale is not None:
        y = y * scale.reshape(pshape)
    if bias is not None:
        y = y + bias.reshape(pshape)
    return {"Y": [y], "Mean": [mean.squeeze()], "Variance": [var.squeeze()]}


def _interp_src(out_n, in_n, align_corners, align_mode, device):
    """Source coordinate of each output index (nn_ops.py:617):
    ``align_corners`` scales by (in - 1) / (out - 1); otherwise
    ``align_mode`` 1 is src = ratio * dst, 0 the half-pixel
    src = ratio * (dst + 0.5) - 0.5, both clamped to [0, in - 1]."""
    i = torch.arange(out_n, dtype=torch.float32, device=device)
    if align_corners:
        return i * ((in_n - 1) / float(max(out_n - 1, 1)))
    ratio = in_n / float(out_n)
    src = i * ratio if align_mode == 1 else (i + 0.5) * ratio - 0.5
    return torch.clamp(src, 0.0, in_n - 1.0)


@register_op("bilinear_interp")
def bilinear_interp(ctx, ins, attrs):
    """NCHW resized to ``out_h`` x ``out_w``: the four neighbours of each
    source point gathered (``take``) and weighted as the reference does."""
    x = single(ins, "X")
    out_h, out_w = attrs.get("out_h"), attrs.get("out_w")
    ac = bool(attrs.get("align_corners", True))
    am = int(attrs.get("align_mode", 1))
    H, W = x.shape[2], x.shape[3]
    sy = _interp_src(out_h, H, ac, am, x.device)
    sx = _interp_src(out_w, W, ac, am, x.device)
    y0, x0 = torch.floor(sy).long(), torch.floor(sx).long()
    y1, x1 = torch.clamp_max(y0 + 1, H - 1), torch.clamp_max(x0 + 1, W - 1)
    wy = (sy - y0)[None, None, :, None]
    wx = (sx - x0)[None, None, None, :]
    row0, row1 = take(x, y0, 2), take(x, y1, 2)
    v00, v01 = take(row0, x0, 3), take(row0, x1, 3)
    v10, v11 = take(row1, x0, 3), take(row1, x1, 3)
    out = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
           + v10 * wy * (1 - wx) + v11 * wy * wx)
    return {"Out": [out.to(x.dtype)]}


@register_op("nearest_interp")
def nearest_interp(ctx, ins, attrs):
    """NCHW resized to ``out_h`` x ``out_w`` by the nearest source row and
    column: rounded half to even under ``align_corners`` (as
    ``jnp.round``), floored otherwise."""
    x = single(ins, "X")
    out_h, out_w = attrs.get("out_h"), attrs.get("out_w")
    H, W = x.shape[2], x.shape[3]

    def src(out_n, in_n):
        i = torch.arange(out_n, device=x.device)
        if attrs.get("align_corners", True):
            idx = torch.round(i * (in_n - 1) / max(out_n - 1, 1))
        else:
            idx = torch.floor(i * (in_n / out_n))
        return torch.clamp(idx.long(), 0, in_n - 1)

    return {"Out": [take(take(x, src(out_h, H), 2), src(out_w, W), 3)]}


@register_op("prelu")
def prelu(ctx, ins, attrs):
    """``x`` where positive, else ``alpha * x``; ``alpha`` one value
    (``all``), one a channel (``channel``) or one an element of a sample
    (``element``)."""
    x = single(ins, "X")
    alpha = single(ins, "Alpha")
    mode = attrs.get("mode", "all")
    if mode == "all":
        a = alpha.reshape(())
    elif mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    else:
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    return {"Out": [torch.where(x > 0, x, a * x)]}


@register_op("maxout")
def maxout(ctx, ins, attrs):
    """The max of each run of ``groups`` channels (NCHW). ``amax``: its
    grad splits among ties, as JAX's ``max`` does."""
    x = single(ins, "X")
    groups = attrs.get("groups")
    n, c, h, w = x.shape
    return {"Out": [x.reshape(n, c // groups, groups, h, w).amax(dim=2)]}
