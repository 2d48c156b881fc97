"""Activations — port of ``paddle_tpu/ops/activation_ops.py`` in full
(reference: paddle/fluid/operators/activation_op.cc): elementwise
lowerings over torch tensors.

- ``_out_based`` (:20-44): relu, sigmoid, tanh, exp, sqrt, rsqrt and
  reciprocal, each with a direct ``*_grad`` that reads the forward's
  output instead of re-running the forward.
- ``_unary`` (:13): logsigmoid, log, square, abs, softsign, softplus,
  tanh_shrink, sin, cos, floor, ceil, round and sign; their grads are the
  engine's ``torch.func.vjp`` of the forward, as the reference derives
  them with its own vjp.
- The parameterised ones, with the reference's attr defaults: gelu (the
  exact erf form unless ``approximate``) with its direct grad, leaky_relu,
  relu6, elu, hard_sigmoid, swish, brelu, soft_relu, pow_activation,
  stanh, hard_shrink, softshrink, thresholded_relu, and softmax and
  log_softmax in float32 for low-precision input.
"""

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_no_grad_op, register_op
from paddle_tpu_torch.ops.common import fp32_accum, single


def _unary(fn):
    def lower(ctx, ins, attrs):
        return {"Out": [fn(single(ins, "X"))]}

    return lower


def _out_based(type, fwd, dfn):
    """Activation whose backward is an analytic function of its OUTPUT
    (reference: activation_op.h functors with ``FwdDeps() == kDepOut``):
    the grad op reads ``Out`` instead of re-running the forward."""
    register_op(type, grad_needs_outputs=("Out",))(_unary(fwd))

    def lower_grad(ctx, ins, attrs):
        out = single(ins, "Out")
        if out is None:  # hand-built grad program without the Out wiring
            out = fwd(single(ins, "X"))
        g = single(ins, "Out@GRAD").to(out.dtype)
        return {"X@GRAD": [dfn(out, g).to(out.dtype)]}

    register_no_grad_op(type + "_grad")(lower_grad)


_out_based("relu", torch.relu, lambda out, g: g * (out > 0).to(g.dtype))
_out_based("sigmoid", torch.sigmoid, lambda out, g: g * out * (1.0 - out))
_out_based("tanh", torch.tanh, lambda out, g: g * (1.0 - out * out))
_out_based("exp", torch.exp, lambda out, g: g * out)
_out_based("sqrt", torch.sqrt, lambda out, g: g * 0.5 / out)
_out_based("rsqrt", lambda x: 1.0 / torch.sqrt(x),
           lambda out, g: g * (-0.5) * out * out * out)
_out_based("reciprocal", lambda x: 1.0 / x, lambda out, g: -g * out * out)
register_op("logsigmoid")(_unary(F.logsigmoid))
register_op("log")(_unary(torch.log))
register_op("square")(_unary(torch.square))
register_op("abs")(_unary(torch.abs))
register_op("softsign")(_unary(lambda x: x / (1.0 + torch.abs(x))))
register_op("softplus")(_unary(F.softplus))
register_op("tanh_shrink")(_unary(lambda x: x - torch.tanh(x)))
register_op("sin")(_unary(torch.sin))
register_op("cos")(_unary(torch.cos))
register_op("floor", grad=None)(_unary(torch.floor))
register_op("ceil", grad=None)(_unary(torch.ceil))
register_op("round", grad=None)(_unary(torch.round))
register_op("sign", grad=None)(_unary(torch.sign))


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


def _zeros(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register_op("leaky_relu")
def leaky_relu(ctx, ins, attrs):
    alpha = attrs.get("alpha", 0.02)
    x = single(ins, "X")
    return {"Out": [torch.where(x >= 0, x, alpha * x)]}


@register_op("relu6")
def relu6(ctx, ins, attrs):
    threshold = attrs.get("threshold", 6.0)
    return {"Out": [torch.clamp(single(ins, "X"), 0.0, threshold)]}


@register_op("elu")
def elu(ctx, ins, attrs):
    alpha = attrs.get("alpha", 1.0)
    x = single(ins, "X")
    return {"Out": [torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))]}


@register_op("hard_sigmoid")
def hard_sigmoid(ctx, ins, attrs):
    slope = attrs.get("slope", 0.2)
    offset = attrs.get("offset", 0.5)
    x = single(ins, "X")
    return {"Out": [torch.clamp(slope * x + offset, 0.0, 1.0)]}


@register_op("swish")
def swish(ctx, ins, attrs):
    beta = attrs.get("beta", 1.0)
    x = single(ins, "X")
    return {"Out": [x * torch.sigmoid(beta * x)]}


@register_op("brelu")
def brelu(ctx, ins, attrs):
    t_min = attrs.get("t_min", 0.0)
    t_max = attrs.get("t_max", 24.0)
    return {"Out": [torch.clamp(single(ins, "X"), t_min, t_max)]}


@register_op("soft_relu")
def soft_relu(ctx, ins, attrs):
    threshold = attrs.get("threshold", 40.0)
    x = torch.clamp(single(ins, "X"), -threshold, threshold)
    return {"Out": [torch.log(1.0 + torch.exp(x))]}


@register_op("pow_activation")
def pow_activation(ctx, ins, attrs):
    return {"Out": [torch.pow(single(ins, "X"), attrs.get("factor", 1.0))]}


@register_op("stanh")
def stanh(ctx, ins, attrs):
    a = attrs.get("scale_a", 2.0 / 3.0)
    b = attrs.get("scale_b", 1.7159)
    return {"Out": [b * torch.tanh(a * single(ins, "X"))]}


@register_op("hard_shrink")
def hard_shrink(ctx, ins, attrs):
    threshold = attrs.get("threshold", 0.5)
    x = single(ins, "X")
    return {"Out": [torch.where(torch.abs(x) > threshold, x, _zeros(x))]}


@register_op("softshrink")
def softshrink(ctx, ins, attrs):
    lam = attrs.get("lambda", 0.5)
    x = single(ins, "X")
    return {"Out": [torch.where(x > lam, x - lam,
                                torch.where(x < -lam, x + lam, _zeros(x)))]}


@register_op("thresholded_relu")
def thresholded_relu(ctx, ins, attrs):
    threshold = attrs.get("threshold", 1.0)
    x = single(ins, "X")
    return {"Out": [torch.where(x > threshold, x, _zeros(x))]}


@register_op("softmax")
def softmax(ctx, ins, attrs):
    """float32 exp and sum for low-precision input, the result cast back
    (activation_ops.py:181)."""
    x = single(ins, "X")
    return {"Out": [torch.softmax(fp32_accum(x), dim=attrs.get("axis", -1))
                    .to(x.dtype)]}


@register_op("log_softmax")
def log_softmax(ctx, ins, attrs):
    x = single(ins, "X")
    return {"Out": [torch.log_softmax(fp32_accum(x),
                                      dim=attrs.get("axis", -1))
                    .to(x.dtype)]}
