"""Loss ops — port of ``paddle_tpu/ops/loss_ops.py`` for
``cross_entropy`` (:18, on probabilities), ``softmax_with_cross_entropy``
(:33), its direct grad ``softmax_with_cross_entropy_grad`` (:341),
``mean`` (:81), ``square_error_cost`` (:86), ``squared_l2_norm`` (:93),
dense or a ``SelectedRows``, and ``sigmoid_cross_entropy_with_logits``
(:116). The softmax losses compute
in float32 whatever the logits' dtype, as in the reference."""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_no_grad_op, register_op
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.ops.common import single


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
