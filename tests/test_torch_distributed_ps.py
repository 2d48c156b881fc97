"""The port's parameter-server path (``paddle_tpu_torch/transpiler``,
``paddle_tpu_torch/distributed/ps.py``, ``ops/distributed_ops.py``)
against the JAX package's, on the CPU. Servers and trainers run as
threads of this process over localhost sockets, as the reference's own
cluster tests do.

- The wire: ``_encode_msg`` gives the JAX package's bytes for a str and
  every dtype of ``_ALLOWED_DTYPES`` (bfloat16 too, without ml_dtypes on
  the port's side), and each package's ``_decode_msg`` reads the other's.
- The transpiler: the trainer, trainer-startup, pserver and per-endpoint
  startup descs are byte-identical to the reference's, for SGD, Adam and
  Momentum, ``slice_var_up`` on and off, with and without distributed
  tables.
- The reference's cluster tests (``tests/test_dist_pserver.py``,
  ``test_dist_async.py``, ``test_dist_lookup_table.py``,
  ``test_dist_slice_var.py``) against the port: each cluster against the
  same model trained in one process, at the reference's tolerances
  (losses rtol 1e-4 / atol 1e-5, tables rtol 1e-4 / atol 1e-6); the
  deadline raising ``RpcDeadlineError`` under a low ``rpc_deadline_ms``.
- A tiny DeepFM (1000 ids, 5 fields, distributed tables, Adam) on 2
  pservers and 2 trainers: the port's cluster, and the port's trainers
  against the JAX package's servers, within the same tolerances of the
  JAX package's cluster, every server starting from the JAX servers'
  state (``convert.load_numpy_state``).
"""

import functools
import socket
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import models as j_models
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import (LowerContext as JLowerContext,
                                      OpRegistry as JOpRegistry)
from paddle_tpu.distributed import ps as j_ps

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert, flags
from paddle_tpu_torch import models as t_models
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry)
from paddle_tpu_torch.distributed import ps as t_ps

CPU = tfluid.CPUPlace()
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
FIXED_EPS = "127.0.0.1:6170,127.0.0.1:6171"
VOCAB, DIM, FIELDS = 64, 4, 5
CTR = dict(num_features=1000, num_fields=5, embed_dim=4, lr=0.01)
CTR_BATCH, CTR_STEPS = 32, 3
# the lowerings of this slice (tests/test_torch_ops.py holds every
# ported lowering to a case)
SLICE_OPS = frozenset({"distributed_lookup", "distributed_lookup_grad",
                       "make_selected_rows"})


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _endpoints(n=2):
    return ["127.0.0.1:%d" % _free_port() for _ in range(n)]


def _side(pkg):
    if pkg == "jax":
        return jfluid, j_unique_name, j_models, j_ps
    return tfluid, t_unique_name, t_models, t_ps


# -- the reference tests' models, in either package ---------------------------
def _mlp(pkg, lr=0.1, optimizer="sgd", names=False):
    """``test_dist_pserver.py``'s model (``names``: ``test_dist_async.py``'s
    named weights)."""
    fluid, uname, _, _ = _side(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with uname.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=16, act="relu", param_attr=(
            fluid.ParamAttr(name="aw1") if names else None))
        pred = fluid.layers.fc(input=h, size=4, param_attr=(
            fluid.ParamAttr(name="aw2") if names else None))
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits=pred, label=y))
        opt = (fluid.optimizer.Adam if optimizer == "adam"
               else fluid.optimizer.SGD)
        opt(learning_rate=lr).minimize(loss)
    return main, startup, loss


def _table(pkg, lr=0.2, is_distributed=False, optimizer="sgd"):
    """``test_dist_lookup_table.py``'s model."""
    fluid, uname, _, _ = _side(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with uname.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[FIELDS], dtype="int64")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(
            ids, size=[VOCAB, DIM], is_sparse=True,
            is_distributed=is_distributed,
            param_attr=fluid.ParamAttr(name="emb_w"))
        pooled = fluid.layers.reduce_sum(emb, dim=1)
        pred = fluid.layers.fc(input=pooled, size=4,
                               param_attr=fluid.ParamAttr(name="fc_w"))
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits=pred, label=y))
        opt = (fluid.optimizer.Adam if optimizer == "adam"
               else fluid.optimizer.SGD)
        opt(learning_rate=lr).minimize(loss)
    return main, startup, loss


def _slice(pkg):
    """``test_dist_slice_var.py``'s model: a 32x600 weight above two
    blocks of ``min_block_size``, Momentum."""
    fluid, uname, _, _ = _side(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with uname.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[32], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=600, act="relu",
                            param_attr=fluid.ParamAttr(
                                name="big_w",
                                initializer=fluid.initializer.Constant(
                                    0.01)))
        p = fluid.layers.fc(input=h, size=1, param_attr=fluid.ParamAttr(
            name="small_w", initializer=fluid.initializer.Constant(0.02)))
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=p, label=y))
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss


def _deepfm(pkg, is_distributed=True):
    fluid, uname, models, _ = _side(pkg)
    with uname.guard():
        main, startup, h = models.deepfm.get_model(
            batch_size=CTR_BATCH, is_distributed=is_distributed, **CTR)
    return main, startup, h["loss"]


def _mlp_batches(n, batch, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(16, 4).astype(np.float32)
    out = []
    for _ in range(n):
        xv = rng.randn(batch, 16).astype(np.float32)
        yv = np.argmax(xv @ w, 1).astype(np.int64).reshape(-1, 1)
        out.append({"x": xv, "y": yv})
    return out


def _table_batches(n, batch, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(VOCAB).astype(np.float32)
    out = []
    for _ in range(n):
        ids = rng.randint(0, VOCAB, (batch, FIELDS)).astype(np.int64)
        yv = (np.stack([w[ids].sum(1), -w[ids].sum(1), w[ids].max(1),
                        w[ids].min(1)], 1)
              .argmax(1).astype(np.int64).reshape(-1, 1))
        out.append({"ids": ids, "y": yv})
    return out


def _ctr_batches():
    rng = np.random.RandomState(21)
    return [j_models.deepfm.make_fake_batch(
        CTR_BATCH, CTR["num_features"], CTR["num_fields"], rng=rng)
        for _ in range(CTR_STEPS)]


# -- the lowerings ---------------------------------------------------------------
def _lower(side, op_type, ins, attrs):
    """``side``'s lowering of ``op_type`` on host arrays: {slot: [value]}
    (a SelectedRows as its (rows, values, height))."""
    names = {s: ["x"] * len(v) for s, v in ins.items()}
    if side == "jax":
        import jax.numpy as jnp

        ctx = JLowerContext(JOpDesc(op_type, names, {}, attrs), None,
                            op_index=0)
        outs = JOpRegistry.get(op_type).lower(
            ctx, {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
            attrs)
    else:
        ctx = TLowerContext(TOpDesc(op_type, names, {}, attrs), None, "cpu",
                            op_index=0)
        outs = TOpRegistry.get(op_type).lower(
            ctx, {s: [torch.from_numpy(np.array(a)) for a in v]
                  for s, v in ins.items()}, attrs)

    def host(x):
        if hasattr(x, "height"):
            return (np.asarray(x.rows), np.asarray(x.values), x.height)
        return np.asarray(x)

    return {s: [host(x) for x in v] for s, v in outs.items()}


def _distributed_op_case(op_type, padding_idx):
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 20, (4, 5, 1)).astype(np.int64)
    ids[0, 0, 0] = 3
    attrs = {"padding_idx": padding_idx, "table_name": "emb_w"}
    if op_type == "distributed_lookup":
        ins = {"Prefetched": [rng.randn(20, 6).astype(np.float32)],
               "Ids": [ids]}
    elif op_type == "distributed_lookup_grad":
        ins = {"Ids": [ids],
               "Out@GRAD": [rng.randn(4, 5, 6).astype(np.float32)]}
    else:
        ins = {"Rows": [rng.randint(0, 9, (12,)).astype(np.int64)],
               "Values": [rng.randn(12, 6).astype(np.float32)]}
        attrs = {"height": 9}
    return ins, attrs


@pytest.mark.parametrize("padding_idx", [-1, 3])
@pytest.mark.parametrize("op_type", sorted(SLICE_OPS))
def test_distributed_ops_match_reference(op_type, padding_idx):
    """Each lowering against the JAX package's on the same inputs:
    equal outputs (the lookup's rows reshaped with its ids' trailing 1
    squeezed and the padding row zeroed; the grad flattened; the
    SelectedRows' int32 rows, values and height)."""
    ins, attrs = _distributed_op_case(op_type, padding_idx)
    want = _lower("jax", op_type, ins, attrs)
    got = _lower("torch", op_type, ins, attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            if isinstance(w, tuple):
                assert g[0].dtype == np.int32 == w[0].dtype
                np.testing.assert_array_equal(g[0], w[0])
                np.testing.assert_array_equal(g[1], w[1])
                assert g[2] == w[2]
            else:
                assert g.shape == w.shape
                np.testing.assert_array_equal(g, w)


# -- the wire -------------------------------------------------------------------
def _ml_bf16(words):
    import ml_dtypes

    return words.view(ml_dtypes.bfloat16)


@pytest.mark.parametrize("dtype", sorted(t_ps._ALLOWED_DTYPES) + ["str"])
def test_wire_bytes_identical(dtype):
    assert t_ps._ALLOWED_DTYPES == j_ps._ALLOWED_DTYPES
    rng = np.random.RandomState(3)
    if dtype == "str":
        fields = ("send", "fc_0.w_0@GRAD", "ünïcode")
        j_fields = t_fields = fields
    elif dtype == "bfloat16":
        words = rng.randint(-2 ** 15, 2 ** 15, (3, 5)).astype(np.int16)
        j_fields = ("var", _ml_bf16(words))
        t_fields = ("var", torch.from_numpy(words).view(torch.bfloat16))
    else:
        arr = (rng.rand(2, 3, 4) * 100).astype(dtype)
        j_fields = t_fields = ("send", "w@GRAD", arr)
    j_bytes = j_ps._encode_msg(j_fields)
    t_bytes = t_ps._encode_msg(t_fields)
    assert t_bytes == j_bytes
    # each package reads the other's bytes
    t_read = t_ps._decode_msg(j_bytes)
    j_read = j_ps._decode_msg(t_bytes)
    for a, b in zip(t_read, j_read):
        if isinstance(a, str):
            assert a == b
        elif dtype == "bfloat16":
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          words)
            np.testing.assert_array_equal(np.asarray(b).view(np.int16),
                                          words)
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # a scalar and an empty array too
    if dtype not in ("str", "bfloat16"):
        for arr in (np.asarray(7, dtype), np.zeros((0, 4), dtype)):
            assert t_ps._encode_msg(("var", arr)) == \
                j_ps._encode_msg(("var", arr))


def test_wire_refuses_what_the_reference_refuses():
    with pytest.raises(TypeError, match="pserver wire"):
        t_ps._encode_msg(("var", np.zeros(2, np.complex64)))
    bad = j_ps._encode_msg(("var", np.zeros(2, np.float32))).replace(
        b"float32", b"complex")
    with pytest.raises(ValueError, match="disallowed dtype"):
        t_ps._decode_msg(bad)


# -- the transpiler ------------------------------------------------------------
def _descs(pkg, build, slice_var_up, eps=FIXED_EPS, trainers=2):
    fluid = _side(pkg)[0]
    main, startup, _ = build(pkg)
    cfg = fluid.DistributeTranspilerConfig()
    cfg.slice_var_up = slice_var_up
    t = fluid.DistributeTranspiler(config=cfg)
    t.transpile(trainer_id=0, program=main, pservers=eps,
                trainers=trainers, startup_program=startup)
    out = {"trainer": t.get_trainer_program(),
           "trainer_startup": t.get_trainer_startup_program()}
    for ep in eps.split(","):
        prog, start = t.get_pserver_programs(ep)
        out["pserver " + ep] = prog
        out["startup " + ep] = start
    return {k: v.desc.serialize_to_string() for k, v in out.items()}, t


BUILDS = {
    "mlp_sgd": lambda pkg: _mlp(pkg),
    "mlp_adam": lambda pkg: _mlp(pkg, lr=0.01, optimizer="adam"),
    "slice_momentum": _slice,
    "table_sgd": lambda pkg: _table(pkg, is_distributed=True),
    "table_adam": lambda pkg: _table(pkg, lr=0.05, is_distributed=True,
                                     optimizer="adam"),
    "deepfm": _deepfm,
}


@pytest.mark.parametrize("slice_var_up", [True, False],
                         ids=["slice_var_up", "whole_vars"])
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_transpiled_descs_byte_identical(build, slice_var_up):
    want, jt = _descs("jax", BUILDS[build], slice_var_up)
    got, tt = _descs("torch", BUILDS[build], slice_var_up)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    assert tt._param_to_ep == jt._param_to_ep
    assert tt._param_blocks == jt._param_blocks
    assert tt._dist_tables == jt._dist_tables
    if build == "slice_momentum":
        assert bool(tt._param_blocks) is slice_var_up


def test_hash_name_dispatch_and_collective_modes():
    """``HashName`` picks the reference's endpoints (its zlib hash);
    nccl2 and mesh modes return the program unchanged, and mesh mode
    refuses a distributed table, as in the reference."""
    eps = FIXED_EPS.split(",")
    names = [("w%d" % i, None) for i in range(8)] + ["plain_var"]
    assert tfluid.transpiler.HashName(eps).dispatch(names) == \
        jfluid.transpiler.HashName(eps).dispatch(names)
    for mode in ("nccl2", "mesh"):
        main, _, _ = _mlp("torch")
        cfg = tfluid.DistributeTranspilerConfig()
        cfg.mode = mode
        t = tfluid.DistributeTranspiler(config=cfg)
        t.transpile(trainer_id=0, program=main, trainers=FIXED_EPS)
        assert t.get_trainer_program() is main
    main, _, _ = _table("torch", is_distributed=True)
    cfg = tfluid.DistributeTranspilerConfig()
    cfg.mode = "mesh"
    with pytest.raises(NotImplementedError, match="pserver transport"):
        tfluid.DistributeTranspiler(config=cfg).transpile(
            trainer_id=0, program=main)


# -- clusters --------------------------------------------------------------
def _local(build, batches, set_state=None, steps_fetch=None):
    """The model trained in one port process on ``batches``: (initial
    params, losses, final scope)."""
    main, startup, loss = build("torch")
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    for n, v in (set_state or {}).items():
        scope.set(n, v.copy())
    init = {p.name: np.array(scope.get(p.name))
            for p in main.all_parameters()}
    losses = [float(np.asarray(exe.run(main, feed=b, fetch_list=[loss],
                                       scope=scope)[0]))
              for b in batches]
    return init, losses, scope


def _cluster(t, startup, n_trainers, batches, loss_name, feed_of=None,
             server_startup=None, set_state=None, trainer_pkg="torch",
             server_pkg="torch", states=None):
    """Servers for ``t``'s endpoints and ``n_trainers`` trainer threads
    running ``batches`` (trainer i's slice by ``feed_of``); returns
    (each trainer's losses, the servers, the trainers)."""
    servers = []
    for i, ep in enumerate(t.pserver_endpoints):
        prog = t.get_pserver_program(ep)
        start = (server_startup(t, ep, prog) if server_startup
                 else startup)
        if server_pkg == "torch":
            srv = t_ps.ParameterServer(prog, None if states else start, ep,
                                       fanin=n_trainers, place=CPU)
            if states:
                convert.load_numpy_state(srv.scope, states[i], "cpu",
                                         program=prog)
        else:
            srv = j_ps.ParameterServer(prog, None if states else start, ep,
                                       fanin=n_trainers)
            for n, v in (states[i] if states else {}).items():
                srv.scope.set(n, v)
        for n, v in (set_state(ep) if set_state else {}).items():
            srv.scope.set(n, v)
        srv.start()
        servers.append(srv)
    results, trainers = [None] * n_trainers, [None] * n_trainers
    prog, tstart = t.get_trainer_program(), t.get_trainer_startup_program()
    errors = []

    def run(tid):
        try:
            if trainer_pkg == "torch":
                tr = t_ps.DistTrainer(prog, t, place=CPU)
            else:
                tr = j_ps.DistTrainer(prog, t)
            tr.run_startup(tstart)
            tr.pull_params()
            losses = []
            for b in batches:
                feed = feed_of(b, tid) if feed_of else b
                (val,) = tr.run(feed, [loss_name])
                losses.append(float(np.asarray(val)))
            trainers[tid] = tr
            tr.close()
            results[tid] = losses
        except Exception as e:  # surfaced below with the trainer's id
            errors.append((tid, e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(n_trainers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    assert all(r is not None for r in results), "a trainer died"
    return results, servers, trainers


def _halves(batch, tid, n=2):
    size = len(next(iter(batch.values()))) // n
    return {k: v[tid * size:(tid + 1) * size] for k, v in batch.items()}


def _transpile(build, eps, trainers, sync_mode=True, config=None,
               pkg="torch"):
    fluid = _side(pkg)[0]
    main, startup, loss = build(pkg)
    t = fluid.DistributeTranspiler(config=config)
    t.transpile(trainer_id=0, program=main, pservers=",".join(eps),
                trainers=trainers, sync_mode=sync_mode,
                startup_program=startup)
    return t, startup, loss


def test_pserver_adam_matches_local():
    """``test_dist_pserver.py``: 2 pservers, 2 trainers on half batches,
    Adam (beta-pow scale ops routed to the owning server): the mean of
    the trainers' losses is the local full-batch trajectory."""
    batches = _mlp_batches(8, 32, seed=0)
    build = functools.partial(_mlp, lr=0.01, optimizer="adam")
    init, local, _ = _local(build, batches)
    t, startup, loss = _transpile(build, _endpoints(), 2)
    results, _, trainers = _cluster(
        t, startup, 2, batches, loss.name, feed_of=_halves,
        set_state=lambda ep: init)
    dist = [(a + b) / 2 for a, b in zip(*results)]
    np.testing.assert_allclose(dist, local, **LOSS_TOL)
    assert dist[-1] < dist[0]
    step = trainers[0].step_ms
    assert set(step) == {"engine", "rpc", "copy"}
    assert all(v >= 0 for v in step.values())
    assert trainers[0].client.bytes_sent > 0
    assert trainers[0].client.bytes_received > 0


def test_pserver_update_failure_unblocks_trainers():
    """A failing optimizer update replies with an error instead of
    leaving the batch barrier stuck at fanin."""
    ep = _endpoints(1)[0]
    t, startup, _ = _transpile(_mlp, [ep], 1)
    srv = t_ps.ParameterServer(t.get_pserver_program(ep), startup, ep,
                               fanin=1, place=CPU)
    srv.start()
    try:
        client = t_ps.PSClient([ep])
        gname = next(op.inputs["X"][0] for op in
                     t.get_trainer_program().desc.global_block().ops
                     if op.type == "send")
        client.send_var(ep, gname, np.zeros((3, 3), np.float32))
        sock = client._socks[ep]
        t_ps._send_msg(sock, ("batch_barrier",))
        reply = t_ps._recv_msg(sock)
        assert reply is not None and reply[0] == "error"
    finally:
        srv.stop()


def test_async_training_converges_without_barriers():
    """``test_dist_async.py``: async mode, each trainer's gradient applied
    on arrival; the losses fall."""
    build = functools.partial(_mlp, lr=0.05, names=True)
    t, startup, loss = _transpile(build, _endpoints(), 2, sync_mode=False)
    feeds = {tid: _mlp_batches(30, 16, seed=tid + 1) for tid in range(2)}
    results, _, _ = _cluster(
        t, startup, 2, list(range(30)), loss.name,
        feed_of=lambda i, tid: feeds[tid][i])
    for losses in results:
        assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_async_applies_each_gradient_immediately():
    build = functools.partial(_mlp, lr=0.05, names=True)
    eps = _endpoints()
    t, startup, _ = _transpile(build, eps, 1, sync_mode=False)
    servers = [t_ps.ParameterServer(t.get_pserver_program(ep), startup,
                                    ep, fanin=1, place=CPU) for ep in eps]
    for srv in servers:
        srv.start()
    srv = next(s for s in servers if "aw2@GRAD" in s._grad_to_block)
    before = np.array(srv.scope.get("aw2"))
    client = t_ps.PSClient([srv.endpoint])
    client.send_var(srv.endpoint, "aw2@GRAD", np.ones((16, 4), np.float32))
    after = np.array(srv.scope.get("aw2"))
    np.testing.assert_allclose(after, before - 0.05, rtol=1e-5, atol=1e-6)
    client.send_complete()
    for s in servers:
        s.stop()


def test_distributed_checkpoint_roundtrip(tmp_path):
    """Train, ``checkpoint_notify``, and a fresh cluster restored from the
    shard files holds the same parameters."""
    ckpt = str(tmp_path / "dist_ckpt")
    build = functools.partial(_mlp, lr=0.05, names=True)
    eps = _endpoints()
    t, startup, loss = _transpile(build, eps, 1)
    servers = [t_ps.ParameterServer(t.get_pserver_program(ep), startup,
                                    ep, fanin=1, place=CPU) for ep in eps]
    for srv in servers:
        srv.start()
    trainer = t_ps.DistTrainer(t.get_trainer_program(), t, place=CPU)
    trainer.run_startup(startup)
    trainer.pull_params()
    for b in _mlp_batches(4, 16, seed=1):
        trainer.run(b, [loss.name])
    trainer.save_checkpoint(ckpt)
    params = {n: np.array(srv.scope.get(n)) for srv in servers
              for n in srv._owned_persistables()
              if srv.scope.get(n) is not None}
    trainer.close()
    t2, startup2, _ = _transpile(build, eps, 1)
    for ep in eps:
        for _ in range(50):
            try:
                srv = t_ps.ParameterServer(t2.get_pserver_program(ep),
                                           startup2, ep, fanin=1,
                                           checkpoint_dir=ckpt, place=CPU)
                break
            except OSError:
                time.sleep(0.2)
        else:
            raise RuntimeError("port for %s never freed" % ep)
        for n in srv._owned_persistables():
            if n in params:
                np.testing.assert_allclose(np.asarray(srv.scope.get(n)),
                                           params[n], rtol=1e-6,
                                           err_msg=n)
        srv._sock.close()


@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.2), ("adam", 0.05)])
def test_distributed_lookup_table_matches_local(optimizer, lr):
    """``test_dist_lookup_table.py``: the table row-sharded over 2
    pservers with prefetch and sparse pushback; neither trainers nor
    servers hold the whole table; losses and the sharded table equal the
    local run's."""
    batches = _table_batches(8, 32)
    emb0 = np.linspace(-0.5, 0.5, VOCAB * DIM).astype(
        np.float32).reshape(VOCAB, DIM)
    init, local, scope = _local(functools.partial(
        _table, lr=lr, optimizer=optimizer), batches, {"emb_w": emb0})
    local_table = np.array(scope.get("emb_w"))
    build = functools.partial(_table, lr=lr, is_distributed=True,
                              optimizer=optimizer)
    t, startup, loss = _transpile(build, _endpoints(), 2)
    shards = t._dist_tables["emb_w"]["shards"]

    def state(ep):
        start, end = next((s, e) for e2, s, e in shards if e2 == ep)
        out = {n: v for n, v in init.items() if n != "emb_w"}
        out["emb_w"] = emb0[start:end].copy()
        return out

    results, servers, trainers = _cluster(
        t, startup, 2, batches, loss.name, feed_of=_halves,
        server_startup=lambda t_, ep, prog: t_.get_startup_program(ep,
                                                                   prog),
        set_state=state)
    for srv in servers:
        for name in srv.scope.local_var_names():
            val = srv.scope.get(name)
            if val is not None and hasattr(val, "shape"):
                assert tuple(val.shape) != (VOCAB, DIM), name
    for tr in trainers:
        for name in tr.scope.local_var_names():
            val = tr.scope.get(name)
            if val is not None and hasattr(val, "shape"):
                assert tuple(val.shape) != (VOCAB, DIM), name
    dist = [(a + b) / 2 for a, b in zip(*results)]
    np.testing.assert_allclose(dist, local, **LOSS_TOL)
    assert dist[-1] < dist[0]
    table = np.concatenate([np.array(s.scope.get("emb_w")) for s in servers])
    np.testing.assert_allclose(table, local_table, **TABLE_TOL)


def test_disjoint_shard_usage_scales_by_fanin():
    """A shard only ONE trainer's batch touches still divides by fanin
    (mean over trainers), not by the number of senders."""
    rng = np.random.RandomState(3)
    ids = np.concatenate([rng.randint(0, VOCAB // 2, (4, FIELDS)),
                          rng.randint(VOCAB // 2, VOCAB, (4, FIELDS))]
                         ).astype(np.int64)
    batch = {"ids": ids, "y": (ids.sum(1, keepdims=True) % 4).astype(
        np.int64)}
    emb0 = np.linspace(-0.5, 0.5, VOCAB * DIM).astype(
        np.float32).reshape(VOCAB, DIM)
    init, _, scope = _local(_table, [batch], {"emb_w": emb0})
    local_table = np.array(scope.get("emb_w"))
    t, startup, loss = _transpile(functools.partial(
        _table, is_distributed=True), _endpoints(), 2)
    shards = t._dist_tables["emb_w"]["shards"]

    def state(ep):
        start, end = next((s, e) for e2, s, e in shards if e2 == ep)
        return dict({n: v for n, v in init.items() if n != "emb_w"},
                    emb_w=emb0[start:end].copy())

    _, servers, _ = _cluster(t, startup, 2, [batch], loss.name,
                             feed_of=_halves, set_state=state)
    table = np.concatenate([np.array(s.scope.get("emb_w")) for s in servers])
    np.testing.assert_allclose(table, local_table, **TABLE_TOL)


def test_slice_var_up_parity():
    """``test_dist_slice_var.py``: the 32x600 weight sliced into two row
    blocks on two servers (Momentum's velocity sliced and renamed with
    it); no server holds the whole weight; 5 steps equal the local
    run."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 32).astype(np.float32)
    feed = {"x": x, "y": (x[:, :1] * 2 + 1).astype(np.float32)}
    _, local, _ = _local(_slice, [feed] * 5)
    cfg = tfluid.DistributeTranspilerConfig()
    cfg.slice_var_up = True
    cfg.min_block_size = 8192
    t, startup, loss = _transpile(_slice, _endpoints(), 1, config=cfg)
    blocks = t._param_blocks["big_w"]
    assert len(blocks) == 2 and len({ep for *_, ep in blocks}) == 2
    assert "small_w" in t._param_to_ep
    results, servers, _ = _cluster(
        t, startup, 1, [feed] * 5, loss.name,
        server_startup=lambda t_, ep, prog: t_.get_startup_program(ep,
                                                                   prog))
    for srv in servers:
        assert srv.scope.get("big_w") is None
        owned = [n for n in ("big_w.block0", "big_w.block1")
                 if srv.scope.get(n) is not None]
        assert len(owned) == 1
        assert tuple(srv.scope.get(owned[0]).shape) == (16, 600)
    np.testing.assert_allclose(results[0][-1], local[-1], rtol=1e-5)


def test_rpc_deadline_raises_under_a_low_flag():
    """A peer that accepts and never answers fails the RPC with
    ``RpcDeadlineError`` once ``rpc_deadline_ms`` passes, never waiting
    for the 180 s default."""
    mute = socket.socket()
    mute.bind(("127.0.0.1", 0))
    mute.listen(1)
    ep = "127.0.0.1:%d" % mute.getsockname()[1]
    flags.set_flags({"rpc_deadline_ms": 200.0})
    try:
        client = t_ps.PSClient([ep])
        t0 = time.perf_counter()
        with pytest.raises(t_ps.RpcDeadlineError, match="200 ms"):
            client.get_var(ep, "w")
        assert time.perf_counter() - t0 < 5.0
        assert isinstance(t_ps.RpcDeadlineError("x"), t_ps.RpcError)
        client.close()
    finally:
        flags.reset_flag("rpc_deadline_ms")
        mute.close()
    assert t_ps.rpc_deadline_seconds() == 180.0


# -- DeepFM on the JAX package's servers and on the port's ------------------
@pytest.fixture(scope="module")
def ctr_reference():
    """The JAX package's cluster of the tiny DeepFM: each server's state
    after its startup, the trainers' losses and the final table shards
    (one run for the module)."""
    eps = _endpoints()
    t, startup, loss = _transpile(_deepfm, eps, 2, pkg="jax")
    states = []
    for ep in eps:
        prog = t.get_pserver_program(ep)
        scope = jfluid.Scope()
        jfluid.Executor(jfluid.CPUPlace()).run(
            t.get_startup_program(ep, prog), scope=scope)
        states.append({n: np.array(scope.get(n)) for n, vd in
                       prog.desc.global_block().vars.items()
                       if vd.persistable})
    batches = _ctr_batches()
    results, servers, _ = _cluster(t, startup, 2, batches, loss.name,
                                   feed_of=_halves, trainer_pkg="jax",
                                   server_pkg="jax", states=states)
    tables = {n: np.concatenate([np.array(s.scope.get(n))
                                 for s in servers])
              for n in ("fm_w1", "fm_v")}
    return states, batches, results, tables


@pytest.mark.parametrize("servers", ["torch", "jax"],
                         ids=["port_cluster", "mixed_cluster"])
def test_deepfm_cluster_matches_reference_cluster(ctr_reference, servers):
    """2 pservers, 2 trainers, distributed tables, Adam: the port's
    trainers on the port's servers, and on the JAX package's servers
    (the mixed cluster), from the JAX servers' state, give each
    trainer's losses and the final table shards of the JAX package's
    cluster."""
    states, batches, want, tables = ctr_reference
    t, startup, loss = _transpile(_deepfm, _endpoints(), 2)
    got, srvs, trainers = _cluster(
        t, startup, 2, batches, loss.name, feed_of=_halves,
        server_pkg=servers, states=states)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **LOSS_TOL)
    for name, want_table in tables.items():
        table = np.concatenate([np.array(s.scope.get(name)) for s in srvs])
        assert table.shape == (CTR["num_features"],) + \
            want_table.shape[1:]
        np.testing.assert_allclose(table, want_table, **TABLE_TOL)
    # the tables never reach a trainer
    for tr in trainers:
        assert tr.scope.get("fm_v") is None and tr.scope.get("fm_w1") is None


def test_capture_gc_pause_overlaps_across_threads():
    """Engines of several threads (a cluster's trainers and servers) may
    capture at once: the garbage collector stays off until the LAST
    overlapping capture ends (a collection during a capture can make
    CUDA refuse it), and comes back on after."""
    import gc

    from paddle_tpu_torch.engine import executor as engine

    assert gc.isenabled()
    inside, release = threading.Event(), threading.Event()

    def other():
        with engine._gc_paused():
            inside.set()
            release.wait(10)

    th = threading.Thread(target=other)
    th.start()
    inside.wait(10)
    with engine._gc_paused():
        assert not gc.isenabled()
    assert not gc.isenabled(), "the other thread still captures"
    release.set()
    th.join(10)
    assert gc.isenabled()


def test_graph_release_takes_the_lifecycle_lock():
    """An entry's CUDA graph is released under the process-wide lock that
    captures take (torch's generator keeps captured graphs in a set it
    does not lock), whichever thread drops the entry."""
    import gc

    from paddle_tpu_torch.engine import executor as engine

    seen = []

    class Graph:
        def __del__(self):
            seen.append(engine._graph_lifecycle._is_owned())

    entry = object.__new__(engine.CompiledBlock)
    entry.graph = Graph()
    th = threading.Thread(target=lambda: entry.__del__())
    th.start()
    th.join(10)
    assert seen == [True] and entry.graph is None
    del entry
    gc.collect()
    assert seen == [True]
