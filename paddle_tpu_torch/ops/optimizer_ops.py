"""Optimizer update ops — port of ``paddle_tpu/ops/optimizer_ops.py`` for
``sgd`` (:14), ``momentum`` (:28) and ``adam`` (:80), dense gradients only
(reference: paddle/fluid/operators/optimizers/). Each returns new tensors
for its ``*Out`` slots, which the engine binds to the same persistable
names and writes back to the scope after the run.

The JAX package also takes a ``SelectedRows`` (sparse) gradient here; the
port has no SelectedRows type yet (ROADMAP Queue 1, the training path),
and ``lookup_table_grad``, the only op that would make one, raises
``NotImplementedError`` for ``is_sparse=True``.
"""

import torch

from paddle_tpu_torch.core.registry import register_no_grad_op
from paddle_tpu_torch.ops.common import single


@register_no_grad_op("sgd", inplace_map={"ParamOut": "Param"})
def sgd(ctx, ins, attrs):
    p = single(ins, "Param")
    g = single(ins, "Grad")
    lr = single(ins, "LearningRate").reshape(())
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
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
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
    m1o = b1 * m1 + (1.0 - b1) * g
    m2o = b2 * m2 + (1.0 - b2) * torch.square(g)
    p_out = p - lr_t * m1o / (torch.sqrt(m2o) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1o], "Moment2Out": [m2o]}
