"""Reduce ops — port of ``paddle_tpu/ops/reduce_ops.py``: ``reduce_sum``,
``reduce_mean``, ``reduce_max``, ``reduce_min`` and ``reduce_prod``
(:25-29) and the boolean ``reduce_all`` and ``reduce_any`` (:30-31,
registered with ``grad=None`` as there). The reference's dtype rules
hold: the mean of an integer tensor is float32, as ``jnp.mean`` gives
it; the grads are ``torch.func.vjp`` of these lowerings, which split a
max's or min's gradient evenly among ties as JAX's do."""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import single


def _float(x):
    return x if x.is_floating_point() else x.float()


def _prod(x, dim=None, keepdim=False):
    # torch.prod takes one dim at a time
    if dim is None:
        return torch.prod(x)
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(fn):
    """The lowering of ``fn(x, dim=, keepdim=)``; with ``reduce_all``,
    ``fn(x)`` over every dim, of shape [1] * ndim under ``keep_dim``."""
    def lower(ctx, ins, attrs):
        x = single(ins, "X")
        keep_dim = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            out = fn(x)
            if keep_dim:
                out = out.reshape([1] * x.ndim)
        else:
            dims = tuple(d if d >= 0 else d + x.ndim
                         for d in attrs.get("dim", [0]))
            out = fn(x, dim=dims, keepdim=keep_dim)
        return {"Out": [out]}

    return lower


register_op("reduce_sum")(_reduce(torch.sum))
register_op("reduce_mean")(_reduce(
    lambda x, **kw: torch.mean(_float(x), **kw)))
register_op("reduce_max")(_reduce(torch.amax))
register_op("reduce_min")(_reduce(torch.amin))
register_op("reduce_prod")(_reduce(_prod))
register_op("reduce_all", grad=None)(_reduce(
    lambda x, **kw: torch.all(x.bool(), **kw)))
register_op("reduce_any", grad=None)(_reduce(
    lambda x, **kw: torch.any(x.bool(), **kw)))
