"""Metric ops — port of ``paddle_tpu/ops/metric_ops.py`` for ``accuracy``
(:10)."""

import torch

from paddle_tpu_torch.core.registry import register_no_grad_op
from paddle_tpu_torch.ops.common import single


@register_no_grad_op("accuracy")
def accuracy(ctx, ins, attrs):
    """A row is correct when any of its top-k ``Indices`` [N, k] is its
    ``Label`` [N, 1]: ``Accuracy`` float32 [1], ``Correct`` and ``Total``
    int32 [1]."""
    indices = single(ins, "Indices")
    label = single(ins, "Label").reshape(-1, 1).to(indices.dtype)
    n = indices.shape[0]
    correct = (indices == label).any(dim=1).sum(dtype=torch.int32)
    return {"Accuracy": [(correct.float() / n).reshape(1)],
            "Correct": [correct.reshape(1)],
            "Total": [torch.full((1,), n, dtype=torch.int32,
                                 device=indices.device)]}
