"""Loss ops — port of ``paddle_tpu/ops/loss_ops.py`` for
``cross_entropy`` (:18, on probabilities), ``softmax_with_cross_entropy``
(:33), its direct grad ``softmax_with_cross_entropy_grad`` (:341),
``mean`` (:81), ``square_error_cost`` (:86), ``squared_l2_norm`` (:93),
dense or a ``SelectedRows``, and ``sigmoid_cross_entropy_with_logits``
(:116), and the regression and margin losses ``squared_l2_distance``
(:105), ``log_loss`` (:129), ``huber_loss`` (:138), ``smooth_l1_loss``
(:149), ``kldiv_loss`` (:162) and ``hinge_loss`` (:178), whose grads the
engine derives by vjp, and the CTC ops ``warpctc`` (:185) and
``edit_distance`` (:266). The softmax losses compute in float32 whatever
the logits' dtype, as in the reference.

``warpctc`` is the log-domain alpha recursion as a Python loop over the
time steps, where the reference scans: its grad in Logits is the
engine's vjp of the loop, as the reference's is autodiff of the scan.
Every read of the log-probabilities is one ``take``, so the grad adds
back by a sorted ``index_put_`` and repeats bit for bit on the card
(``F.ctc_loss``'s CUDA backward does not). ``edit_distance`` runs the
Levenshtein DP a hypothesis token a step, each row of the table in one
go as a running minimum (``cummin``), exact in float32."""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_no_grad_op, register_op
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.ops.common import single, take


def _squeeze_label(label):
    if label.ndim >= 2 and label.shape[-1] == 1:
        return label.squeeze(-1)
    return label


@register_op("cross_entropy", no_grad_inputs=("Label",))
def cross_entropy(ctx, ins, attrs):
    """-log of the label's probability (or the soft label's sum), the
    probability floored at 1e-8, in the input's dtype."""
    x = single(ins, "X")  # probabilities
    label = single(ins, "Label")
    eps = 1e-8
    if attrs.get("soft_label", False):
        loss = -(label * torch.log(torch.clamp_min(x, eps))).sum(
            dim=-1, keepdim=True)
    else:
        idx = _squeeze_label(label).to(torch.int64)
        picked = torch.gather(x, -1, idx[..., None])
        loss = -torch.log(torch.clamp_min(picked, eps))
    return {"Y": [loss]}


@register_op("softmax_with_cross_entropy", no_grad_inputs=("Label",))
def softmax_with_cross_entropy(ctx, ins, attrs):
    logits = single(ins, "Logits")
    label = single(ins, "Label")
    logits32 = logits.float()
    if attrs.get("soft_label", False):
        log_sm = torch.log_softmax(logits32, dim=-1)
        loss = -(label * log_sm).sum(dim=-1, keepdim=True)
        softmax_out = log_sm.exp()
    else:
        # hard label: lse(logits) - logits[label], with a label equal to
        # ignore_index contributing no loss. The reference picks the
        # label column by a one-hot sum, so a label outside [0, C) picks 0.
        idx = _squeeze_label(label).long().unsqueeze(-1)
        n_cls = logits.shape[-1]
        in_range = (idx >= 0) & (idx < n_cls)
        lse = torch.logsumexp(logits32, dim=-1, keepdim=True)
        picked = torch.gather(logits32, -1, idx.clamp(0, n_cls - 1))
        loss = lse - torch.where(in_range, picked, torch.zeros_like(picked))
        ignored = idx == attrs.get("ignore_index", -100)
        loss = torch.where(ignored, torch.zeros_like(loss), loss)
        softmax_out = torch.exp(logits32 - lse)
    return {"Softmax": [softmax_out], "Loss": [loss]}


@register_no_grad_op("softmax_with_cross_entropy_grad")
def softmax_with_cross_entropy_grad(ctx, ins, attrs):
    """Direct CE backward (loss_ops.py:341; reference:
    softmax_with_cross_entropy_op.h's grad kernel): dLogits = (softmax -
    onehot) * dLoss, the softmax recomputed from the logits in float32,
    ignored labels getting no gradient, plus the softmax vjp of a cotangent
    on the Softmax output."""
    logits = single(ins, "Logits")
    label = single(ins, "Label")
    g_loss = single(ins, "Loss@GRAD")
    g_sm = single(ins, "Softmax@GRAD")
    sm = torch.softmax(logits.float(), dim=-1)
    grad = torch.zeros_like(sm)
    if g_loss is not None:
        if attrs.get("soft_label", False):
            grad = (sm - label.float()) * g_loss
        else:
            idx = _squeeze_label(label).long()
            onehot = F.one_hot(idx.clamp(0, logits.shape[-1] - 1),
                               logits.shape[-1]).to(sm.dtype)
            # a label outside [0, C) has an all-zero one-hot row, as in
            # the reference (loss_ops.py:369)
            onehot = onehot * ((idx >= 0) & (idx < logits.shape[-1])
                               ).unsqueeze(-1).to(sm.dtype)
            grad = (sm - onehot) * g_loss
            ignored = (idx == attrs.get("ignore_index", -100)).unsqueeze(-1)
            grad = torch.where(ignored, torch.zeros_like(grad), grad)
    if g_sm is not None:
        gs = g_sm.float()
        grad = grad + sm * (gs - (gs * sm).sum(-1, keepdim=True))
    return {"Logits@GRAD": [grad.to(logits.dtype)]}


@register_op("mean")
def mean(ctx, ins, attrs):
    return {"Out": [torch.mean(single(ins, "X"))]}


@register_op("square_error_cost")
def square_error_cost(ctx, ins, attrs):
    return {"Out": [torch.square(single(ins, "X") - single(ins, "Y"))]}


@register_op("squared_l2_norm")
def squared_l2_norm(ctx, ins, attrs):
    """sum(x**2) as a [1] tensor (the global-norm clip's per-grad term);
    a ``SelectedRows`` merges its duplicate rows first (the sentinel
    rows' zeros add nothing)."""
    x = single(ins, "X")
    if isinstance(x, SelectedRows):
        x = x.merged().values
    return {"Out": [torch.sum(torch.square(x)).reshape(1)]}


@register_op("sigmoid_cross_entropy_with_logits", no_grad_inputs=("Label",))
def sigmoid_cross_entropy_with_logits(ctx, ins, attrs):
    """max(x, 0) - x * label + log(1 + exp(-|x|)) elementwise, zero where
    the label is ``ignore_index``; with ``normalize`` divided by the
    count of labels that are not."""
    x = single(ins, "X")
    label = single(ins, "Label")
    ignore_index = attrs.get("ignore_index", -100)
    loss = (torch.clamp(x, min=0.0) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))
    ignored = label == ignore_index
    loss = torch.where(ignored, torch.zeros_like(loss), loss)
    if attrs.get("normalize", False):
        n_valid = torch.clamp((~ignored).sum().to(x.dtype), min=1.0)
        loss = loss / n_valid
    return {"Out": [loss]}


@register_op("squared_l2_distance")
def squared_l2_distance(ctx, ins, attrs):
    """The squared L2 distance of each row of X to Y's, [N, 1];
    ``sub_result`` is X - Y."""
    diff = single(ins, "X") - single(ins, "Y")
    return {"sub_result": [diff],
            "Out": [torch.sum(torch.square(diff), dim=-1, keepdim=True)]}


@register_op("log_loss", no_grad_inputs=("Labels",))
def log_loss(ctx, ins, attrs):
    pred = single(ins, "Predicted")
    label = single(ins, "Labels")
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(pred + eps)
                     - (1.0 - label) * torch.log(1.0 - pred + eps)]}


@register_op("huber_loss", no_grad_inputs=("Y",))
def huber_loss(ctx, ins, attrs):
    """Quadratic within ``delta`` of the label, linear beyond;
    ``Residual`` is Y - X."""
    x = single(ins, "X")  # prediction
    r = single(ins, "Y") - x
    delta = attrs.get("delta", 1.0)
    ar = torch.abs(r)
    return {"Residual": [r],
            "Out": [torch.where(ar <= delta, 0.5 * r * r,
                                delta * (ar - 0.5 * delta))]}


@register_op("smooth_l1_loss", no_grad_inputs=("Y",))
def smooth_l1_loss(ctx, ins, attrs):
    """Each row's sum of 0.5 (sigma d)^2 where |d| < 1 / sigma^2, else
    |d| - 0.5 / sigma^2; ``Diff`` is d = X - Y."""
    diff = single(ins, "X") - single(ins, "Y")
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    ad = torch.abs(diff)
    elem = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    return {"Diff": [diff],
            "Out": [torch.sum(elem.reshape(elem.shape[0], -1), dim=1,
                              keepdim=True)]}


@register_op("kldiv_loss", no_grad_inputs=("Target",))
def kldiv_loss(ctx, ins, attrs):
    """``target * (log(target) - x)`` where the target is positive (x holds
    log-probabilities), reduced by ``reduction``: ``mean``, ``sum``,
    ``batchmean`` (the sum over the batch size) or ``none``."""
    x = single(ins, "X")
    target = single(ins, "Target")
    loss = target * (torch.log(torch.clamp_min(target, 1e-8)) - x)
    loss = torch.where(target > 0, loss, torch.zeros_like(loss))
    reduction = attrs.get("reduction", "mean")
    if reduction == "mean":
        loss = torch.mean(loss)
    elif reduction == "sum":
        loss = torch.sum(loss)
    elif reduction == "batchmean":
        loss = torch.sum(loss) / x.shape[0]
    return {"Loss": [loss]}


@register_op("hinge_loss", no_grad_inputs=("Labels",))
def hinge_loss(ctx, ins, attrs):
    """``max(1 - (2 label - 1) logit, 0)`` for labels in {0, 1}."""
    logits = single(ins, "Logits")
    labels = single(ins, "Labels")
    return {"Loss": [torch.clamp_min(1.0 - (2.0 * labels - 1.0) * logits,
                                     0.0)]}


@register_op("warpctc", no_grad_inputs=("Label", "LogitsLength",
                                        "LabelLength"))
def warpctc(ctx, ins, attrs):
    """CTC loss of [B, T, C] unnormalized logits (softmax inside, as
    warp-ctc) against [B, L] label ids, ``blank`` the blank id; the
    optional LogitsLength/LabelLength [B] cut each row (a row's alpha
    stays frozen past its length); ``norm_by_times`` divides by the
    length. Loss [B, 1]."""
    logits = single(ins, "Logits")
    labels = single(ins, "Label")
    blank = int(attrs.get("blank", 0))
    b, t_n, c = logits.shape
    if labels.ndim == 3 and labels.shape[-1] == 1:
        labels = labels[..., 0]
    lab_n = labels.shape[1]
    dev = logits.device
    in_len = single(ins, "LogitsLength")
    in_len = (in_len.reshape(-1).long() if in_len is not None
              else torch.full((b,), t_n, dtype=torch.int64, device=dev))
    lab_len = single(ins, "LabelLength")
    lab_len = (lab_len.reshape(-1).long() if lab_len is not None
               else torch.full((b,), lab_n, dtype=torch.int64, device=dev))

    log_probs = F.log_softmax(logits.float(), dim=-1)
    s_n = 2 * lab_n + 1
    ext = torch.full((b, s_n), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels.long()
    # the skip s-2 -> s where ext[s] is a label unlike ext[s-2]
    can_skip = torch.cat([
        torch.zeros((b, min(2, s_n)), dtype=torch.bool, device=dev),
        (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])], dim=1)
    neg = -1e30

    # every step's emission log-probabilities [B, T, S], one take
    rows = torch.arange(b, device=dev)[:, None, None] * t_n \
        + torch.arange(t_n, device=dev)[None, :, None]
    emit = take(log_probs.reshape(-1), rows * c + ext[:, None, :]) \
        .reshape(b, t_n, s_n)

    def lse(*xs):
        stacked = torch.stack(xs)
        m_safe = torch.clamp(stacked.amax(dim=0), min=neg)
        return m_safe + torch.log(torch.exp(stacked - m_safe).sum(dim=0))

    head = min(2, s_n)
    alpha = torch.cat([emit[:, 0, :head], torch.full(
        (b, s_n - head), neg, device=dev)], dim=1)
    pad1 = torch.full((b, 1), neg, device=dev)
    pad2 = torch.full((b, 2), neg, device=dev)
    for t in range(1, t_n):
        s1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        s2 = torch.cat([pad2, alpha[:, :-2]], dim=1)[:, :s_n]
        s2 = torch.where(can_skip, s2, neg)
        new = lse(alpha, s1, s2) + emit[:, t]
        alpha = torch.where((t < in_len)[:, None], new, alpha)

    # P(label) = alpha[2 * len] + alpha[2 * len - 1]
    last = 2 * lab_len
    flat = alpha.reshape(-1)
    base = torch.arange(b, device=dev) * s_n
    a_last = take(flat, base + last)
    a_prev = take(flat, base + torch.clamp(last - 1, min=0))
    a_prev = torch.where(lab_len > 0, a_prev, neg)
    loss = -lse(a_last, a_prev)
    if attrs.get("norm_by_times", False):
        loss = loss / torch.clamp(in_len.to(loss.dtype), min=1.0)
    return {"Loss": [loss.reshape(b, 1).to(logits.dtype)]}


@register_no_grad_op("edit_distance")
def edit_distance(ctx, ins, attrs):
    """Levenshtein distance between hypothesis and reference id rows
    ([B, L] or [B, L, 1]) over their HypsLength/RefsLength (full rows
    without them), ``ignored_tokens`` erased first; divided by the
    reference's length when ``normalized``. Out [B, 1], SequenceNum
    [1]."""
    hyp = single(ins, "Hyps")
    ref = single(ins, "Refs")
    if hyp.ndim == 3 and hyp.shape[-1] == 1:
        hyp = hyp[..., 0]
    if ref.ndim == 3 and ref.shape[-1] == 1:
        ref = ref[..., 0]
    b, l1 = hyp.shape
    l2 = ref.shape[1]
    dev = hyp.device
    h_len = single(ins, "HypsLength")
    h_len = (h_len.reshape(-1).long() if h_len is not None
             else torch.full((b,), l1, dtype=torch.int64, device=dev))
    r_len = single(ins, "RefsLength")
    r_len = (r_len.reshape(-1).long() if r_len is not None
             else torch.full((b,), l2, dtype=torch.int64, device=dev))
    ignored = list(attrs.get("ignored_tokens") or [])
    if ignored:
        def compact(seq, lens):
            n = seq.shape[1]
            pos = torch.arange(n, device=dev)[None, :]
            ign = pos >= lens[:, None]
            for tok in ignored:
                ign = ign | (seq == tok)
            order = torch.argsort(ign.long() * (2 * n) + pos, dim=1,
                                  stable=True)
            return torch.gather(seq, 1, order), (~ign).sum(dim=1)

        hyp, h_len = compact(hyp, h_len)
        ref, r_len = compact(ref, r_len)

    cols = torch.arange(l2 + 1, dtype=torch.float32, device=dev)
    row = cols[None, :].expand(b, l2 + 1)             # D[0, j] = j
    for i in range(l1):
        match = ref == hyp[:, i:i + 1]
        diag = row[:, :-1] + torch.where(match, 0.0, 1.0)
        up = row[:, 1:] + 1.0
        # new[j] = min over k <= j of (c[k] + j - k), c[0] = i + 1 and
        # c[j + 1] = min(up[j], diag[j]): the DP's left-to-right minimum
        c_row = torch.cat([torch.full((b, 1), float(i + 1), device=dev),
                           torch.minimum(up, diag)], dim=1)
        new = torch.cummin(c_row - cols, dim=1).values + cols
        row = torch.where((i < h_len)[:, None], new, row)
    dist = row.gather(1, r_len[:, None])[:, 0]
    dist = torch.where(r_len == 0, h_len.to(dist.dtype), dist)
    if attrs.get("normalized", True):
        dist = dist / torch.clamp(r_len.to(dist.dtype), min=1.0)
    return {"Out": [dist.reshape(b, 1)],
            "SequenceNum": [torch.full((1,), b, dtype=torch.int64,
                                       device=dev)]}
