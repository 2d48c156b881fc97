"""Reduce ops — port of ``paddle_tpu/ops/reduce_ops.py`` for
``reduce_sum`` (:25)."""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import single


@register_op("reduce_sum")
def reduce_sum(ctx, ins, attrs):
    x = single(ins, "X")
    keep_dim = attrs.get("keep_dim", False)
    if attrs.get("reduce_all", False):
        out = torch.sum(x)
        if keep_dim:
            out = out.reshape([1] * x.ndim)
    else:
        dims = [d if d >= 0 else d + x.ndim for d in attrs.get("dim", [0])]
        out = torch.sum(x, dim=dims, keepdim=keep_dim)
    return {"Out": [out]}
