"""Activations — port of ``paddle_tpu/ops/activation_ops.py`` for ``gelu``
(:65; the exact erf form unless ``approximate``) and its direct grad
``gelu_grad`` (:71), and, through ``_out_based`` (:20-44), ``tanh``/
``tanh_grad`` and ``relu``/``relu_grad``, whose grads read the forward's
output, and ``softmax`` (:181), whose grad the engine derives by vjp."""

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_no_grad_op, register_op
from paddle_tpu_torch.ops.common import fp32_accum, single


def _out_based(type, fwd, dfn):
    """Activation whose backward is an analytic function of its OUTPUT
    (reference: activation_op.h functors with ``FwdDeps() == kDepOut``):
    the grad op reads ``Out`` instead of re-running the forward."""

    def lower(ctx, ins, attrs):
        return {"Out": [fwd(single(ins, "X"))]}

    def lower_grad(ctx, ins, attrs):
        out = single(ins, "Out")
        if out is None:  # hand-built grad program without the Out wiring
            out = fwd(single(ins, "X"))
        g = single(ins, "Out@GRAD").to(out.dtype)
        return {"X@GRAD": [dfn(out, g).to(out.dtype)]}

    register_op(type, grad_needs_outputs=("Out",))(lower)
    register_no_grad_op(type + "_grad")(lower_grad)


_out_based("relu", torch.relu, lambda out, g: g * (out > 0).to(g.dtype))
_out_based("tanh", torch.tanh, lambda out, g: g * (1.0 - out * out))


@register_op("gelu")
def gelu(ctx, ins, attrs):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [F.gelu(single(ins, "X"), approximate=approximate)]}


@register_no_grad_op("gelu_grad")
def gelu_grad(ctx, ins, attrs):
    """Direct analytic gelu backward (reference: GeluGradKernel of
    operators/gelu_op.h), in float32, from the pre-activation only."""
    x = single(ins, "X")
    g = single(ins, "Out@GRAD")
    x32 = x.float()
    if attrs.get("approximate", False):
        c = math.sqrt(2.0 / math.pi)
        t = torch.tanh(c * (x32 + 0.044715 * x32 ** 3))
        d = (0.5 * (1.0 + t)
             + 0.5 * x32 * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * x32 * x32))
    else:
        cdf = 0.5 * (1.0 + torch.erf(x32 * (2.0 ** -0.5)))
        pdf = torch.exp(-0.5 * x32 * x32) * (1.0 / math.sqrt(2.0 * math.pi))
        d = cdf + x32 * pdf
    return {"X@GRAD": [(g.float() * d).to(x.dtype)]}


@register_op("softmax")
def softmax(ctx, ins, attrs):
    """float32 exp and sum for low-precision input, the result cast back
    (activation_ops.py:181)."""
    x = single(ins, "X")
    return {"Out": [torch.softmax(fp32_accum(x), dim=attrs.get("axis", -1))
                    .to(x.dtype)]}
