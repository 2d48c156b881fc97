"""Loss ops — port of ``paddle_tpu/ops/loss_ops.py`` for
``softmax_with_cross_entropy`` (:33) and ``mean`` (:81). Losses compute
in float32 whatever the logits' dtype, as in the reference."""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import single


def _squeeze_label(label):
    if label.ndim >= 2 and label.shape[-1] == 1:
        return label.squeeze(-1)
    return label


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


@register_op("mean")
def mean(ctx, ins, attrs):
    return {"Out": [torch.mean(single(ins, "X"))]}
