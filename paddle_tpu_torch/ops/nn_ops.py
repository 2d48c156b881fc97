"""NN ops — port of ``paddle_tpu/ops/nn_ops.py`` for ``fused_attention``
(:379) and its direct grad ``fused_attention_grad`` (:414),
``layer_norm`` (:480), ``dropout`` (:506), ``lookup_table`` (:527) and
its dense grad ``lookup_table_grad`` (:538). ``layer_norm`` and
``dropout`` have no grad lowering of their own: the engine derives theirs
as ``torch.func.vjp`` of the forward (``engine/lowering.py``), which
re-draws the forward's dropout mask from the same seed.

Dropout seeds come from the run's seed table (``LowerContext.seed``): the
forward op and its grad op share one RNG stream id, so they read the same
entry. The reference draws the attention kernel's seed in [0, int32 max)
and the generic dropout's in [0, 2**32) (nn_ops.py:351;
``hash_keep_mask``, common.py:110)."""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_no_grad_op, register_op
from paddle_tpu_torch.ops.common import (
    amp_cast, flatten_lookup_ids, fp32_accum, hash_keep_mask, single,
)

ATTENTION_SEED_HIGH = 2 ** 31 - 1
DROPOUT_SEED_HIGH = 2 ** 32


def _attention_seed_range(attrs):
    if attrs.get("is_test", False) or not attrs.get("dropout_rate", 0.0):
        return None
    return ATTENTION_SEED_HIGH


def _dropout_seed_range(attrs):
    return None if attrs.get("is_test", False) else DROPOUT_SEED_HIGH


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
    out = F.embedding(flat_ids, w)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        # the padding row contributes no output (lookup_table_op.h)
        out = torch.where((flat_ids == padding_idx).unsqueeze(-1),
                          torch.zeros_like(out), out)
    return {"Out": [out]}


@register_no_grad_op("lookup_table_grad")
def lookup_table_grad(ctx, ins, attrs):
    """Dense table gradient (reference: lookup_table_op.cc grad kernel):
    the output grads scatter-added into a zero table at the batch's ids,
    padding rows contributing nothing. The scatter is ``index_put_`` with
    ``accumulate=True``, whose CUDA path sorts the ids and adds each row's
    grads in a fixed order, so repeated steps agree bit for bit (as the
    reference's ``.at[rows].add`` does); ``index_add_`` adds with float
    atomics on CUDA, in an order that changes from run to run."""
    if attrs.get("is_sparse", False):
        raise NotImplementedError(
            "lookup_table_grad with is_sparse=True makes a SelectedRows "
            "gradient, which is not ported yet (ROADMAP Queue 1, the "
            "training path); build the embedding with "
            "is_sparse=False")
    w = single(ins, "W")
    rows = flatten_lookup_ids(single(ins, "Ids")).reshape(-1).long()
    vals = single(ins, "Out@GRAD").reshape(
        (rows.shape[0],) + tuple(w.shape[1:])).to(w.dtype)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        vals = torch.where((rows == padding_idx).unsqueeze(-1),
                           torch.zeros_like(vals), vals)
    return {"W@GRAD": [torch.zeros_like(w).index_put_(
        (rows,), vals, accumulate=True)]}
