"""Activations — port of ``paddle_tpu/ops/activation_ops.py`` for ``gelu``
(:65; the exact erf form unless ``approximate``) and ``tanh`` (:44)."""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import single


@register_op("gelu")
def gelu(ctx, ins, attrs):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [F.gelu(single(ins, "X"), approximate=approximate)]}


@register_op("tanh", grad_needs_outputs=("Out",))
def tanh(ctx, ins, attrs):
    return {"Out": [torch.tanh(single(ins, "X"))]}
