"""Optimizer update ops — port of ``paddle_tpu/ops/optimizer_ops.py``:
``sgd`` (:14), ``momentum`` (:28), ``lars_momentum`` (:57), ``adam``
(:80), ``adamax`` (:120), ``adagrad`` (:145), ``decayed_adagrad`` (:168),
``adadelta`` (:183), ``rmsprop`` (:208), ``ftrl`` (:245) and
``model_average_accum`` (:276) (reference: paddle/fluid/operators/optimizers/). Each returns
new tensors for its ``*Out`` slots, which the engine binds to the same
persistable names and writes back to the scope after the run (in place
under capture); each keeps the reference's ``inplace_map``.

A ``SelectedRows`` (sparse) gradient takes a row-wise branch in ``sgd``,
``momentum``, ``adam`` (lazy: only the batch's rows move) and
``adagrad``, as in the JAX package (:19, :38, :100, :152); the other
updates densify it. Each sum into rows is ``index_put_`` with
``accumulate=True`` (a fixed order on CUDA), and each set writes merged,
unique rows (``core/selected_rows.py``).
"""

import torch

from paddle_tpu_torch.core.registry import register_no_grad_op
from paddle_tpu_torch.core.selected_rows import SelectedRows, densify
from paddle_tpu_torch.ops.common import single


@register_no_grad_op("sgd", inplace_map={"ParamOut": "Param"})
def sgd(ctx, ins, attrs):
    p = single(ins, "Param")
    g = single(ins, "Grad")
    lr = single(ins, "LearningRate").reshape(())
    if isinstance(g, SelectedRows):
        # sparse SGD (reference: sgd_op.cc's SelectedRows kernel): a
        # scatter-add, duplicates summing, which is the dense update since
        # it is linear in the gradient
        return {"ParamOut": [g.add_rows(p, -lr * g.values.to(p.dtype))]}
    return {"ParamOut": [p - lr * g]}


@register_no_grad_op(
    "momentum", inplace_map={"ParamOut": "Param", "VelocityOut": "Velocity"}
)
def momentum(ctx, ins, attrs):
    p = single(ins, "Param")
    g = single(ins, "Grad")
    v = single(ins, "Velocity")
    lr = single(ins, "LearningRate").reshape(())
    mu = attrs.get("mu")
    use_nesterov = attrs.get("use_nesterov", False)
    if isinstance(g, SelectedRows):
        # the dense update without a dense grad: the velocity decays on
        # every row, and the gradient enters linearly (no merge needed)
        gv = g.values.to(p.dtype)
        v_out = g.add_rows(mu * v, gv)
        if use_nesterov:
            p_out = g.add_rows(p - lr * mu * v_out, -lr * gv)
        else:
            p_out = p - lr * v_out
        return {"ParamOut": [p_out], "VelocityOut": [v_out]}
    v_out = mu * v + g
    if use_nesterov:
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register_no_grad_op(
    "adam",
    inplace_map={
        "ParamOut": "Param",
        "Moment1Out": "Moment1",
        "Moment2Out": "Moment2",
    },
)
def adam(ctx, ins, attrs):
    p = single(ins, "Param")
    g = single(ins, "Grad")
    m1 = single(ins, "Moment1")
    m2 = single(ins, "Moment2")
    lr = single(ins, "LearningRate").reshape(())
    b1p = single(ins, "Beta1Pow").reshape(())
    b2p = single(ins, "Beta2Pow").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    if isinstance(g, SelectedRows):
        # lazy Adam (reference: adam_op.h SparseAdamFunctor): only the
        # rows in the gradient update their moments and param; the others
        # keep stale moments rather than decaying every step
        m = g.merged()
        vals = m.values.to(p.dtype)
        m1r = b1 * m.gather_rows(m1) + (1.0 - b1) * vals
        m2r = b2 * m.gather_rows(m2) + (1.0 - b2) * torch.square(vals)
        p_out = m.add_rows(p, -lr_t * m1r / (torch.sqrt(m2r) + eps))
        return {"ParamOut": [p_out], "Moment1Out": [m.set_rows(m1, m1r)],
                "Moment2Out": [m.set_rows(m2, m2r)]}
    m1o = b1 * m1 + (1.0 - b1) * g
    m2o = b2 * m2 + (1.0 - b2) * torch.square(g)
    p_out = p - lr_t * m1o / (torch.sqrt(m2o) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1o], "Moment2Out": [m2o]}


@register_no_grad_op(
    "lars_momentum", inplace_map={"ParamOut": "Param", "VelocityOut": "Velocity"}
)
def lars_momentum(ctx, ins, attrs):
    p = single(ins, "Param")
    g = densify(single(ins, "Grad"))
    v = single(ins, "Velocity")
    lr = single(ins, "LearningRate").reshape(())
    mu = attrs.get("mu")
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * coeff * p_norm / (g_norm + decay * p_norm + 1e-12),
        lr,
    )
    v_out = mu * v + local_lr * (g + decay * p)
    p_out = p - v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register_no_grad_op(
    "adamax",
    inplace_map={
        "ParamOut": "Param",
        "MomentOut": "Moment",
        "InfNormOut": "InfNorm",
    },
)
def adamax(ctx, ins, attrs):
    p = single(ins, "Param")
    g = densify(single(ins, "Grad"))
    m = single(ins, "Moment")
    inf = single(ins, "InfNorm")
    lr = single(ins, "LearningRate").reshape(())
    b1p = single(ins, "Beta1Pow").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1.0 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g) + eps)
    lr_t = lr / (1.0 - b1p)
    p_out = p - lr_t * m_out / inf_out
    return {"ParamOut": [p_out], "MomentOut": [m_out], "InfNormOut": [inf_out]}


@register_no_grad_op(
    "adagrad", inplace_map={"ParamOut": "Param", "MomentOut": "Moment"}
)
def adagrad(ctx, ins, attrs):
    p = single(ins, "Param")
    g = single(ins, "Grad")
    m = single(ins, "Moment")
    lr = single(ins, "LearningRate").reshape(())
    eps = attrs.get("epsilon", 1e-6)
    if isinstance(g, SelectedRows):
        # exactly dense Adagrad: a zero-grad row changes neither moment
        # nor param (reference: adagrad_op.cc's sparse kernel)
        sr = g.merged()
        vals = sr.values.to(p.dtype)
        mr = sr.gather_rows(m) + torch.square(vals)
        p_out = sr.add_rows(p, -lr * vals / (torch.sqrt(mr) + eps))
        return {"ParamOut": [p_out], "MomentOut": [sr.set_rows(m, mr)]}
    m_out = m + torch.square(g)
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": [p_out], "MomentOut": [m_out]}


@register_no_grad_op(
    "decayed_adagrad", inplace_map={"ParamOut": "Param", "MomentOut": "Moment"}
)
def decayed_adagrad(ctx, ins, attrs):
    p = single(ins, "Param")
    g = densify(single(ins, "Grad"))
    m = single(ins, "Moment")
    lr = single(ins, "LearningRate").reshape(())
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_out = decay * m + (1.0 - decay) * torch.square(g)
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": [p_out], "MomentOut": [m_out]}


@register_no_grad_op(
    "adadelta",
    inplace_map={
        "ParamOut": "Param",
        "AvgSquaredGradOut": "AvgSquaredGrad",
        "AvgSquaredUpdateOut": "AvgSquaredUpdate",
    },
)
def adadelta(ctx, ins, attrs):
    p = single(ins, "Param")
    g = densify(single(ins, "Grad"))
    asg = single(ins, "AvgSquaredGrad")
    asu = single(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    asg_out = rho * asg + (1.0 - rho) * torch.square(g)
    update = -torch.sqrt((asu + eps) / (asg_out + eps)) * g
    asu_out = rho * asu + (1.0 - rho) * torch.square(update)
    return {
        "ParamOut": [p + update],
        "AvgSquaredGradOut": [asg_out],
        "AvgSquaredUpdateOut": [asu_out],
    }


@register_no_grad_op(
    "rmsprop",
    inplace_map={
        "ParamOut": "Param",
        "MomentOut": "Moment",
        "MeanSquareOut": "MeanSquare",
        "MeanGradOut": "MeanGrad",
    },
)
def rmsprop(ctx, ins, attrs):
    p = single(ins, "Param")
    g = densify(single(ins, "Grad"))
    mom = single(ins, "Moment")
    ms = single(ins, "MeanSquare")
    mg = single(ins, "MeanGrad")
    lr = single(ins, "LearningRate").reshape(())
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum_ = attrs.get("momentum", 0.0)
    ms_out = rho * ms + (1.0 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg_out = rho * mg + (1.0 - rho) * g
        mom_out = momentum_ * mom + lr * g / torch.sqrt(
            ms_out - torch.square(mg_out) + eps)
    else:
        mg_out = mg
        mom_out = momentum_ * mom + lr * g / torch.sqrt(ms_out + eps)
    return {
        "ParamOut": [p - mom_out],
        "MomentOut": [mom_out],
        "MeanSquareOut": [ms_out],
        "MeanGradOut": [mg_out],
    }


@register_no_grad_op(
    "ftrl",
    inplace_map={
        "ParamOut": "Param",
        "SquaredAccumOut": "SquaredAccumulator",
        "LinearAccumOut": "LinearAccumulator",
    },
)
def ftrl(ctx, ins, attrs):
    p = single(ins, "Param")
    g = densify(single(ins, "Grad"))
    sq = single(ins, "SquaredAccumulator")
    lin = single(ins, "LinearAccumulator")
    lr = single(ins, "LearningRate").reshape(())
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    new_sq = sq + torch.square(g)
    sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq, -lr_power)) / lr
    lin_out = lin + g - sigma * p
    pre_shrink = (torch.sign(lin_out) * l1 - lin_out) / (
        torch.pow(new_sq, -lr_power) / lr + 2.0 * l2)
    p_out = torch.where(torch.abs(lin_out) > l1, pre_shrink,
                        torch.zeros_like(p))
    return {
        "ParamOut": [p_out],
        "SquaredAccumOut": [new_sq],
        "LinearAccumOut": [lin_out],
    }


@register_no_grad_op("model_average_accum",
                     inplace_map={"SumOut": "Sum", "CntOut": "Cnt",
                                  "OldSumOut": "OldSum",
                                  "OldCntOut": "OldCnt",
                                  "TotalOut": "Total"})
def model_average_accum(ctx, ins, attrs):
    """Windowed parameter sums for ModelAverage (reference:
    optimizer.py:1484 + operators/average_accumulates_op): the current
    window folds into the old one when its count reaches
    min(max_average_window, updates * average_window_rate), so an average
    is always available; ``apply`` reads (Sum + OldSum) / (Cnt + OldCnt).
    The reference's three-tier fold is two tiers, as in the JAX
    package."""
    param = single(ins, "Param")
    s = single(ins, "Sum")
    c = single(ins, "Cnt")
    old_s = single(ins, "OldSum")
    old_c = single(ins, "OldCnt")
    total = single(ins, "Total")
    rate = float(attrs.get("average_window_rate", 0.15))
    minw = float(attrs.get("min_average_window", 10000))
    maxw = float(attrs.get("max_average_window", 10000))
    total2 = total + 1.0
    c2 = c + 1.0
    s2 = s + param
    restart = (c2 >= minw) & (c2 >= torch.clamp(total2 * rate, max=maxw))
    old_s2 = torch.where(restart, s2, old_s)
    old_c2 = torch.where(restart, c2, old_c)
    s3 = torch.where(restart, torch.zeros_like(s2), s2)
    c3 = torch.where(restart, torch.zeros_like(c2), c2)
    return {"SumOut": [s3], "CntOut": [c3], "OldSumOut": [old_s2],
            "OldCntOut": [old_c2], "TotalOut": [total2]}
