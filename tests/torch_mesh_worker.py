"""Ranks of a ``torch.distributed`` world on the CPU for the port's mesh
tests. Imports the port only (never JAX or the JAX package).

``run_world(world, cases, tmp_path)`` spawns ``world`` processes that
meet through a ``FileStore`` under ``tmp_path`` (no port, so parallel
test workers never race for one) over gloo. Every rank runs every case
of ``cases`` ({name: (case function name, args)}) in order and pickles
its results; the call returns them, one dict a rank. The args, the
reference's initial state and batches, go through a pickle too.
"""

import os
import pickle
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(world, cases, tmp_path):
    import torch.multiprocessing as mp

    tmp_path = str(tmp_path)
    with open(os.path.join(tmp_path, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    mp.start_processes(_rank_main, args=(world, tmp_path), nprocs=world,
                       start_method="spawn")
    out = []
    for rank in range(world):
        with open(os.path.join(tmp_path, "out%d.pkl" % rank), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank, world, tmp_path):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch import parallel

    torch.set_num_threads(1)
    parallel.init_distributed(
        num_processes=world, process_id=rank, device_type="cpu",
        init_method="file://" + os.path.join(tmp_path, "store"))
    with open(os.path.join(tmp_path, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    results = {}
    for name, (fn, args) in cases.items():
        results[name] = globals()[fn](rank, world, **args)
    with open(os.path.join(tmp_path, "out%d.pkl" % rank), "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


# -- helpers ------------------------------------------------------------------
def _numpy(v):
    from torch.distributed.tensor import DTensor

    if isinstance(v, DTensor):
        v = v.full_tensor()
    return v.detach().cpu().numpy().copy()


def _placement(v):
    return str(tuple(getattr(v, "placements", ())))


def _local_shape(v):
    to_local = getattr(v, "to_local", None)
    return tuple((to_local() if to_local else v).shape)


def _model(kind, **kw):
    from paddle_tpu_torch import models, unique_name

    with unique_name.guard():
        if kind == "mlp":
            return models.mnist.get_model(**kw)
        if kind == "resnet":
            return models.resnet.get_model(**kw)
        if kind == "bert":
            return models.bert.get_model(**kw)
        if kind == "sync_bn":
            return sync_bn_program(**kw)
        if kind == "sp_attention":
            return sp_attention_program(**kw)
    raise ValueError(kind)


def sync_bn_program(lr=0.1):
    """A conv, ``sync_batch_norm`` and a squared-mean loss, SGD; the same
    builder both packages' tests use (``fluid`` is either package's)."""
    import paddle_tpu_torch.fluid as fluid

    return build_sync_bn(fluid, lr)


def build_sync_bn(fluid, lr=0.1):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 6, 6], dtype="float32")
        h = fluid.layers.conv2d(img, num_filters=4, filter_size=3, padding=1)
        h = fluid.layers.sync_batch_norm(h, act="relu")
        loss = fluid.layers.mean(fluid.layers.square(h))
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, {"img": img, "loss": loss}


def sp_attention_program(T=16, DM=16, NH=2, causal=True):
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer

    return build_sp_attention(fluid, transformer, T, DM, NH, causal)


def build_sp_attention(fluid, transformer, T=16, DM=16, NH=2, causal=True):
    """The Transformer's attention block with ``sequence_parallel`` and a
    squared-mean loss; its grads are appended (no optimizer)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[T, DM], dtype="float32")
        out = transformer.multi_head_attention(
            x, x, x, DM, NH, dropout_rate=0.0, causal=causal,
            is_train=True, sequence_parallel=True)
        loss = fluid.layers.mean(fluid.layers.square(out))
        fluid.append_backward(loss)
    return main, startup, {"x": x, "out": out, "loss": loss}


def _train(kind, model_kw, state, batches, fetch_extra=(), mode="executor",
           axes=None, rules=None, flag_values=None, first_fetch_only=False):
    """Load ``state`` into a scope, run ``batches`` through ``mode``
    ('plain': no mesh; 'executor': ``Executor.run(mesh=)``; 'compiled':
    ``CompiledProgram.with_spmd``/``with_data_parallel``; 'parallel':
    ``ParallelExecutor``) and return (fetches a step, final state,
    placements and local shapes of the state, the scope's state)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert, flags, parallel
    from paddle_tpu_torch.parallel import ShardingRules

    flag_values = dict(flag_values or {})
    for k, v in flag_values.items():
        flags.set_flags({k: v})
    try:
        main, startup, h = _model(kind, **model_kw)
        rules = (ShardingRules([(p, parallel.PartitionSpec(*s))
                                for p, s in rules])
                 if rules is not None else None)
        scope = fluid.Scope()
        convert.load_numpy_state(scope, state, "cpu", program=main)
        fetch = [h["loss"].name] + list(fetch_extra)
        exe = fluid.Executor(fluid.CPUPlace())
        prog, kw = main, {}
        if mode == "executor":
            kw = dict(mesh=parallel.make_mesh(axes, device_type="cpu"),
                      shard_rules=rules)
        elif mode == "compiled":
            prog = (fluid.CompiledProgram(main).with_spmd(
                mesh_axes=axes, shard_rules=rules, device_type="cpu",
                loss_name=h["loss"].name) if axes is not None else
                fluid.CompiledProgram(main).with_data_parallel(
                    loss_name=h["loss"].name))
        out = []
        if mode == "parallel":
            pe = fluid.ParallelExecutor(use_cuda=False,
                                        loss_name=h["loss"].name,
                                        main_program=main, scope=scope)
            for b in batches:
                out.append([np.asarray(v) for v in pe.run(fetch, feed=b)])
        else:
            with fluid.scope_guard(scope):
                for i, b in enumerate(batches):
                    f = fetch if (i == 0 or not first_fetch_only) \
                        else fetch[:1]
                    out.append([np.asarray(v) for v in
                                exe.run(prog, feed=b, fetch_list=f, **kw)])
        names = sorted(state)
        final = {n: _numpy(scope.get(n)) for n in names}
        places = {n: _placement(scope.get(n)) for n in names}
        local = {n: _local_shape(scope.get(n)) for n in names}
        feeds = []
        for entry in exe.engine._cache.values():
            feeds.append([tuple(b.shape) for b in entry.feed_bufs])
        return {"fetches": out, "state": final, "placements": places,
                "local_shapes": local, "feed_shapes": feeds}
    finally:
        for k in flag_values:
            flags.reset_flag(k)


# -- cases ----------------------------------------------------------------
def train_case(rank, world, **kw):
    return _train(**kw)


def counters_case(rank, world, **kw):
    """``_train`` with metrics on; adds the engine's counters."""
    from paddle_tpu_torch import flags, observability as obs

    flags.set_flags({"metrics": True})
    obs.reset()
    try:
        res = _train(**kw)
        res["counters"] = {
            n: obs.counter_value(n) for n in (
                "engine.grad_buckets", "engine.mesh_redistribute",
                "engine.state_resharded", "engine.cache_miss")}
        return res
    finally:
        flags.reset_flag("metrics")
        obs.reset()


def ring_case(rank, world, q, k, v, g, axis="sp", causal=(False, True)):
    """``ring_attention`` on whole tensors over a 1-D ``axis`` mesh of the
    world: the output and the grads of q, k and v for cotangent ``g``."""
    import torch

    from paddle_tpu_torch import parallel

    mesh = parallel.make_mesh({axis: world}, device_type="cpu")
    out = {}
    for c in causal:
        leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        o = parallel.ring_attention(*leaves, mesh=mesh, axis_name=axis,
                                    causal=c)
        grads = torch.autograd.grad(o, leaves, torch.tensor(g))
        out[c] = [o.detach().numpy()] + [t.numpy() for t in grads]
    return out


def sp_program_case(rank, world, state, feed, fetch, mode, causal=True):
    """The sequence-parallel attention program at sp=world: 'default'
    runs it without a mesh under a default sp mesh (whole tensors into
    the op), 'mesh' through ``Executor.run(mesh={'dp': 1, 'sp': world})``
    (DTensors into the op)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert, parallel

    main, startup, h = _model("sp_attention", causal=causal)
    scope = fluid.Scope()
    convert.load_numpy_state(scope, state, "cpu", program=main)
    exe = fluid.Executor(fluid.CPUPlace())
    kw = {}
    if mode == "default":
        parallel.set_default_mesh(parallel.make_mesh({"sp": world},
                                                     device_type="cpu"))
    else:
        kw["mesh"] = parallel.make_mesh({"dp": 1, "sp": world},
                                        device_type="cpu")
    try:
        with fluid.scope_guard(scope):
            vals = exe.run(main, feed=feed, fetch_list=fetch, **kw)
    finally:
        parallel.set_default_mesh(None)
    return [np.asarray(v) for v in vals]


def spmd_case(rank, world, **kw):
    """``_train`` under ``spmd_predict`` and ``verify`` with metrics on;
    adds the ``spmd.prediction_delta`` events, the entry's predicted
    collectives and the collectives its first run recorded."""
    from paddle_tpu_torch import flags, observability as obs
    from paddle_tpu_torch.engine import executor as engine

    flags.set_flags({"metrics": True, "spmd_predict": True,
                     "verify": True})
    obs.reset()
    entries = []
    build = engine.Engine.get_compiled

    def spy(self, *a, **k):
        entry = build(self, *a, **k)
        if entry not in entries:
            entries.append(entry)
        return entry

    engine.Engine.get_compiled = spy
    try:
        res = _train(**kw)
    finally:
        engine.Engine.get_compiled = build
        for k in ("metrics", "spmd_predict", "verify"):
            flags.reset_flag(k)
    res["events"] = {name: [dict(r.args or {}) for r in obs.spans()
                            if r.name == name]
                     for name in ("spmd.prediction_delta", "spmd_plan")}
    res["gauges"] = {k: v for k, v in obs.snapshot()["gauges"].items()
                     if k.startswith("spmd.")}
    plan = entries[0].spmd_plan
    res["predicted"] = [(c.kind, c.var, c.nbytes, c.phase)
                        for c in plan.collectives]
    res["record"] = list(entries[0].mesh_plan.record)
    obs.reset()
    return res
