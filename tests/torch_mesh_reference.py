"""The JAX package's side of the port's mesh tests: its models' startup
state, and its runs on its 8 virtual CPU devices (tests/conftest.py),
with or without a mesh. The port's side runs in spawned ranks
(tests/torch_mesh_worker.py) from the same state and batches."""

import numpy as np

import paddle_tpu.fluid as jfluid
from paddle_tpu import flags as j_flags
from paddle_tpu import models as j_models
from paddle_tpu import parallel as j_parallel
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.models import transformer as j_transformer

import torch_mesh_worker as worker

MLP = ("mlp", dict(lr=0.01))
RESNET = ("resnet", dict(dataset="cifar10", depth=8, lr=0.1))
BERT = ("bert", dict(batch_size=4, seq_len=16, vocab_size=50, d_model=32,
                     n_layers=2, n_heads=2, d_inner=64, max_position=32,
                     dropout=0.0, lr=1e-3))
SYNC_BN = ("sync_bn", dict())
SP_ATTENTION = ("sp_attention", dict())


def model(kind, kw=None):
    kw = kw or {}
    with j_unique_name.guard():
        if kind == "mlp":
            return j_models.mnist.get_model(**kw)
        if kind == "resnet":
            return j_models.resnet.get_model(**kw)
        if kind == "bert":
            return j_models.bert.get_model(**kw)
        if kind == "sync_bn":
            return worker.build_sync_bn(jfluid, **kw)
        if kind == "sp_attention":
            # the JAX package infers the ring op's shapes under an sp mesh
            j_parallel.set_default_mesh(j_parallel.make_mesh({"sp": 2}))
            try:
                return worker.build_sp_attention(jfluid, j_transformer,
                                                 **kw)
            finally:
                j_parallel.set_default_mesh(None)
    raise ValueError(kind)


def startup_state(kind, kw):
    """Every persistable of the model after the JAX package's startup."""
    main, startup, _ = model(kind, kw)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    return {v.name: np.array(scope.get(v.name)) for v in main.list_vars()
            if v.persistable}


def mlp_batches(n, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(784, 10).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.randn(batch, 784).astype(np.float32)
        y = np.argmax(x @ w, 1).astype(np.int64).reshape(-1, 1)
        out.append({"img": x, "label": y})
    return out


def train(kind, kw, state, batches, fetch_extra=(), axes=None, rules=None,
          zero=False, first_fetch_only=False):
    """The JAX package's run from ``state``: fetches a step and the final
    state. ``axes`` runs it over a mesh of its virtual devices, with
    ``rules`` [(pattern, spec entries)] and ``zero`` (ZeRO-1)."""
    from jax.sharding import PartitionSpec as P

    main, _, h = model(kind, kw)
    scope = jfluid.Scope()
    for n, v in state.items():
        scope.set(n, v)
    exe = jfluid.Executor(jfluid.CPUPlace())
    kwargs = {}
    if axes is not None:
        kwargs["mesh"] = j_parallel.make_mesh(axes)
        if rules is not None:
            kwargs["shard_rules"] = j_parallel.ShardingRules(
                [(p, P(*s)) for p, s in rules])
    fetch = [h["loss"].name] + list(fetch_extra)
    if zero:
        j_flags.set_flags({"zero": True})
    try:
        out = []
        for i, b in enumerate(batches):
            f = fetch if (i == 0 or not first_fetch_only) else fetch[:1]
            out.append([np.asarray(v) for v in exe.run(
                main, feed=b, fetch_list=f, scope=scope, **kwargs)])
    finally:
        if zero:
            j_flags.reset_flag("zero")
    final = {n: np.asarray(scope.get(n)) for n in state}
    return {"fetches": out, "state": final}


def losses(run):
    return np.array([float(np.asarray(f[0]).reshape(-1)[0])
                     for f in run["fetches"]])


def assert_state_close(got, want, rel, abs_=0.0, names=None):
    """Every var (or ``names``) within rel * max|want| + abs_."""
    for n in (names or sorted(want)):
        w = np.asarray(want[n], np.float64)
        g = np.asarray(got[n], np.float64)
        assert g.shape == w.shape, n
        tol = rel * (np.abs(w).max() if w.size else 0.0) + abs_
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=n)
