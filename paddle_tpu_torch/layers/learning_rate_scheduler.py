"""LR schedulers — port of ``paddle_tpu/layers/learning_rate_scheduler.py``
(reference: python/paddle/fluid/layers/learning_rate_scheduler.py, "the
decay is computed by ops in the program itself"). The persistable step
counter ``@LR_DECAY_COUNTER@`` is incremented by an ``increment`` op each
run; the decayed rate is a var the optimizer ops read, recomputed by ops
of the program every step. The ops and their attrs are the JAX
package's, so both front ends build the same descs: like the JAX
package's, they carry the role of the ops around them (Forward when a
scheduler is built before ``minimize``), so under ``accumulate_steps=k``
the counter advances once a micro-batch and the update reads the mean of
the micro-batches' rates, as the JAX package's scan does."""

import math

from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.initializer import ConstantInitializer
from paddle_tpu_torch.layers import tensor

__all__ = [
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "noam_decay",
    "cosine_decay",
    "linear_lr_warmup",
]


def _global_step_counter():
    helper = LayerHelper("global_step_counter")
    counter = helper.main_program.global_block().vars.get(
        "@LR_DECAY_COUNTER@"
    )
    if counter is None:
        counter = helper.create_global_variable(
            name="@LR_DECAY_COUNTER@", shape=[1], dtype="float32",
            persistable=True,
        )
        helper.set_variable_initializer(counter, ConstantInitializer(0.0))
        helper.append_op(
            type="increment",
            inputs={"X": [counter]},
            outputs={"Out": [counter]},
            attrs={"step": 1.0},
        )
    return counter


def _unary_expr(fn_op_type, x, **attrs):
    helper = LayerHelper(fn_op_type)
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type=fn_op_type, inputs={"X": [x]}, outputs={"Out": [out]},
        attrs=attrs,
    )
    return out


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step_counter()
    div = _unary_expr("scale", step, scale=1.0 / decay_steps)
    if staircase:
        div = _unary_expr("floor", div)
    # lr * decay_rate^div == lr * exp(div * ln(decay_rate))
    expo = _unary_expr("scale", div, scale=math.log(decay_rate))
    factor = _unary_expr("exp", expo)
    return _unary_expr("scale", factor, scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step_counter()
    div = _unary_expr("scale", step, scale=1.0 / decay_steps)
    if staircase:
        div = _unary_expr("floor", div)
    expo = _unary_expr("scale", div, scale=-decay_rate)
    factor = _unary_expr("exp", expo)
    return _unary_expr("scale", factor, scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    from paddle_tpu_torch.layers.nn import elementwise_div

    step = _global_step_counter()
    div = _unary_expr("scale", step, scale=1.0 / decay_steps)
    if staircase:
        div = _unary_expr("floor", div)
    denom = _unary_expr("scale", div, scale=decay_rate, bias=1.0)
    lr = tensor.fill_constant([1], "float32", float(learning_rate))
    return elementwise_div(lr, denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    from paddle_tpu_torch.layers.nn import (
        elementwise_div, elementwise_pow, elementwise_mul, elementwise_add,
        elementwise_min,
    )

    step = _global_step_counter()
    decay_steps_var = tensor.fill_constant([1], "float32", float(decay_steps))
    if cycle:
        ratio = elementwise_div(step, decay_steps_var)
        ceil_r = _unary_expr("ceil", ratio)
        # div_res = max(ceil(step/decay_steps), 1)
        one = tensor.fill_constant([1], "float32", 1.0)
        from paddle_tpu_torch.layers.nn import elementwise_max

        div_res = elementwise_max(ceil_r, one)
        decay_steps_var = elementwise_mul(decay_steps_var, div_res)
        cur = step
    else:
        cur = _unary_expr(
            "clip", step, min=0.0, max=float(decay_steps)
        )
    frac = elementwise_div(cur, decay_steps_var)
    one_minus = _unary_expr("scale", frac, scale=-1.0, bias=1.0)
    powv = tensor.fill_constant([1], "float32", float(power))
    poly = elementwise_pow(one_minus, powv)
    range_lr = _unary_expr(
        "scale", poly, scale=float(learning_rate) - float(end_learning_rate),
        bias=float(end_learning_rate),
    )
    return range_lr


def piecewise_decay(boundaries, values):
    """Piecewise-constant LR: sum of indicator-masked values."""
    from paddle_tpu_torch.layers.nn import sum as sum_layer

    assert len(values) == len(boundaries) + 1
    step = _global_step_counter()
    pieces = []
    prev_b = None
    for i, v in enumerate(values):
        lo = -1.0 if i == 0 else float(boundaries[i - 1])
        hi = float(boundaries[i]) if i < len(boundaries) else 1e30
        # indicator(lo < step <= hi) * v, computed with clips
        # in01 = clip(step - lo, 0, 1) * (1 - clip(step - hi, 0, 1))
        above_lo = _unary_expr("clip", _unary_expr("scale", step, scale=1.0, bias=-lo - 0.5), min=0.0, max=1.0)
        below_hi = _unary_expr("clip", _unary_expr("scale", step, scale=-1.0, bias=hi + 0.5), min=0.0, max=1.0)
        from paddle_tpu_torch.layers.nn import elementwise_mul

        ind = elementwise_mul(above_lo, below_hi)
        pieces.append(_unary_expr("scale", ind, scale=float(v)))
    return sum_layer(pieces)


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (reference: learning_rate_scheduler.py noam_decay)."""
    from paddle_tpu_torch.layers.nn import elementwise_min

    step = _global_step_counter()
    safe_step = _unary_expr("clip", step, min=1.0, max=1e30)
    a = _unary_expr("rsqrt", safe_step)
    b = _unary_expr("scale", step, scale=float(warmup_steps) ** -1.5)
    m = elementwise_min(a, b)
    return _unary_expr("scale", m, scale=float(d_model) ** -0.5)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _global_step_counter()
    epoch = _unary_expr("floor", _unary_expr("scale", step, scale=1.0 / step_each_epoch))
    inner = _unary_expr("scale", epoch, scale=math.pi / epochs)
    cosv = _unary_expr("cos", inner)
    return _unary_expr(
        "scale", cosv, scale=0.5 * float(learning_rate),
        bias=0.5 * float(learning_rate), bias_after_scale=True,
    )


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    from paddle_tpu_torch.layers.nn import elementwise_add, elementwise_mul

    step = _global_step_counter()
    frac = _unary_expr(
        "clip",
        _unary_expr("scale", step, scale=1.0 / float(warmup_steps)),
        min=0.0, max=1.0,
    )
    warm = _unary_expr(
        "scale", frac, scale=float(end_lr) - float(start_lr),
        bias=float(start_lr),
    )
    if isinstance(learning_rate, float):
        after = tensor.fill_constant([1], "float32", learning_rate)
    else:
        after = learning_rate
    # blend: frac<1 -> warm, else after. Use indicator on step>=warmup.
    done = _unary_expr(
        "clip",
        _unary_expr("scale", step, scale=1.0,
                    bias=-float(warmup_steps) + 0.5),
        min=0.0, max=1.0,
    )
    not_done = _unary_expr("scale", done, scale=-1.0, bias=1.0)
    return elementwise_add(
        elementwise_mul(warm, not_done), elementwise_mul(after, done)
    )


def append_LARS(params_grads, learning_rate, weight_decay):
    """Layer-wise adaptive rate scaling applied as per-param learning
    rates (reference: layers/learning_rate_scheduler.py:310 — sets each
    param's optimize_attr['learning_rate'] to
    lr * ||w|| / (||g|| + weight_decay * ||w||))."""
    from paddle_tpu_torch.layers import nn as nn_layers
    from paddle_tpu_torch.layers import ops as ops_layers

    def _balanced_weight(param_norm, grad_norm):
        if weight_decay == 1.0:
            return grad_norm + param_norm
        return grad_norm + weight_decay * param_norm

    for param, grad in params_grads:
        param_lr = param.optimize_attr.get("learning_rate", 1.0)
        param_norm = ops_layers.sqrt(
            nn_layers.reduce_sum(input=ops_layers.square(param)))
        grad_norm = ops_layers.sqrt(
            nn_layers.reduce_sum(input=ops_layers.square(grad)))
        if isinstance(param_lr, float) and param_lr == 1.0:
            decayed_lr = learning_rate * param_norm / _balanced_weight(
                param_norm, grad_norm)
        else:
            decayed_lr = (learning_rate * param_lr * param_norm
                          / _balanced_weight(param_norm, grad_norm))
        param.optimize_attr["learning_rate"] = decayed_lr
