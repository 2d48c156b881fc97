"""The port's async checkpoints (``paddle_tpu_torch/checkpoint.py`` and
``io.save_checkpoint_async``/``io.load_checkpoint``) on the CPU: the
counterparts of ``tests/test_checkpoint_async.py``, the quorum and
fallback cases of ``tests/test_resilience.py``/``tests/test_elastic.py``,
and checkpoints carried across packages both ways.

Tolerances: a restored value is bitwise equal to the value saved (the
files hold the bytes). After a cross-package restore the next Adam step
of the MLP runs in the other package: loss and every state var within
1e-5 relative (float32 on both sides, the same formulas in other
summation orders).

The non-blocking check holds the writer on a ``threading.Event`` rather
than bounding ``save``'s wall time, so a loaded machine cannot fail it.
"""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.checkpoint import CheckpointManager as JManager

import paddle_tpu_torch.checkpoint as cp
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.checkpoint import CheckpointManager

STEP_RTOL = 1e-5


@pytest.fixture
def metrics():
    obs.set_enabled(True)
    obs.reset()
    yield obs
    obs.reset()
    obs.set_enabled(None)


def _mlp(fluid_, unique_name_, counter=False):
    """The MLP of the JAX package's checkpoint tests, with Adam; with
    ``counter`` the program also keeps a persistable int64 step count
    (``global_step``, incremented by each step; the JAX package holds it
    as int32)."""
    main, startup = fluid_.Program(), fluid_.Program()
    with unique_name_.guard(), fluid_.program_guard(main, startup):
        x = fluid_.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid_.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid_.layers.fc(input=x, size=16, act="relu")
        pred = fluid_.layers.fc(input=h, size=4)
        loss = fluid_.layers.mean(fluid_.layers.softmax_with_cross_entropy(
            logits=pred, label=y))
        if counter:
            step = fluid_.layers.create_global_var(
                shape=[1], value=0, dtype="int64", persistable=True,
                name="global_step")
            fluid_.layers.increment(step, value=1, in_place=True)
        fluid_.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _batch(seed, n=16):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 8).astype(np.float32),
            "y": rng.randint(0, 4, (n, 1)).astype(np.int64)}


def _persistables(main, scope):
    return {v.name: scope.get(v.name) for v in main.list_vars()
            if v.persistable and scope.get(v.name) is not None}


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


@pytest.fixture
def held_writer(monkeypatch):
    """Hold the writer thread before its first file write until the
    returned event is set."""
    gate = threading.Event()
    real = cp._save_synced

    def gated(path, arr, dtype):
        gate.wait(timeout=60)
        real(path, arr, dtype)

    monkeypatch.setattr(cp, "_save_synced", gated)
    yield gate
    gate.set()


# -- the counterparts of tests/test_checkpoint_async.py ----------------------
def test_checkpoint_roundtrip_and_resume(tmp_path):
    """Train -> async save -> train more -> restore into a fresh scope:
    every persistable equals the saved point bitwise and training
    resumes from it."""
    main, startup, loss = _mlp(fluid, unique_name)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    with fluid.scope_guard(scope):
        exe.run(startup)
        for i in range(3):
            exe.run(main, feed=_batch(i), fetch_list=[loss])
        fluid.io.save_checkpoint_async(mgr, step=3, main_program=main,
                                       scope=scope)
        saved = {n: _host(v).copy()
                 for n, v in _persistables(main, scope).items()}
        for i in range(3):   # keep training WHILE the save is in flight
            exe.run(main, feed=_batch(3 + i), fetch_list=[loss])
        mgr.wait()
        mgr.check_error()

    scope2 = fluid.Scope()
    with fluid.scope_guard(scope2):
        exe.run(startup)
        step = fluid.io.load_checkpoint(mgr, main_program=main, scope=scope2)
        assert step == 3
        for name, want in saved.items():
            np.testing.assert_array_equal(_host(scope2.get(name)), want,
                                          err_msg=name)
        exe.run(main, feed=_batch(9), fetch_list=[loss])   # resumes


def test_save_does_not_block_the_step_loop(tmp_path, held_writer):
    """``save`` returns while the writer is held before its first write,
    and the snapshot is immune to later in-place updates."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    w = torch.arange(16.0).reshape(4, 4)
    mgr.save(1, {"w": w, "b": torch.zeros(4)})
    assert mgr.in_flight and not held_writer.is_set()
    w.add_(100.0)        # "training continues", in place as a replay does
    held_writer.set()
    mgr.wait()
    mgr.check_error()
    np.testing.assert_array_equal(mgr.restore(1)["w"],
                                  np.arange(16.0).reshape(4, 4))


def test_snapshot_is_not_aliased_by_in_place_steps(tmp_path, held_writer):
    """After ``save_checkpoint_async`` the next steps write the scope's
    tensors in place (the engine's donated state); the checkpoint holds
    the values from before them."""
    main, startup, loss = _mlp(fluid, unique_name)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    with fluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=_batch(0), fetch_list=[loss])
        state = _persistables(main, scope)
        saved = {n: _host(v).copy() for n, v in state.items()}
        fluid.io.save_checkpoint_async(mgr, 1, main_program=main,
                                       scope=scope)
        exe.run(main, feed=_batch(1), fetch_list=[loss])
        # the step wrote the SAME tensor objects
        assert all(scope.get(n) is t for n, t in state.items())
        assert not np.array_equal(_host(scope.get("fc_0.w_0_0")),
                                  saved["fc_0.w_0_0"])
        held_writer.set()
        mgr.wait()
        mgr.check_error()
    got = mgr.restore(1)
    assert sorted(got) == sorted(saved)
    for name, want in saved.items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_each_published_write_observes_its_wall(tmp_path, metrics):
    """``ckpt.write_ms`` gets one observation a published save (transfer
    to publish); a save whose every attempt fails gets none."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for s in (1, 2):
        mgr.save(s, {"v": torch.full((3,), float(s))}, blocking=True)
    hist = metrics.snapshot()["histograms"]["ckpt.write_ms"]
    assert hist["count"] == 2 and hist["min"] > 0.0

    class Boom:
        shape = (2,)

        def __array__(self, dtype=None, copy=None):
            raise OSError("disk on fire")

    mgr.save(3, {"v": Boom()})
    mgr.wait()
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        mgr.check_error()
    assert metrics.snapshot()["histograms"]["ckpt.write_ms"]["count"] == 2


def test_atomic_publish_and_gc(tmp_path):
    """A checkpoint dir appears only complete (manifest present), and
    max_to_keep prunes the oldest."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"v": torch.full((2,), float(s))}, blocking=True)
    assert mgr.all_steps() == [2, 3]
    assert not any(d.startswith(".") for d in
                   os.listdir(str(tmp_path / "ckpt")))
    assert mgr.restore()["v"][0] == 3.0
    assert mgr.restore(2)["v"][0] == 2.0


def test_failed_save_surfaces_on_next_interaction(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))

    class Boom:
        shape = (2,)

        def __array__(self, dtype=None, copy=None):
            raise OSError("disk on fire")

    mgr.save(1, {"v": Boom()})
    mgr.wait()
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        mgr.check_error()
    # the error is consumed; the manager is usable again
    mgr.save(2, {"v": np.ones(2)}, blocking=True)
    assert mgr.all_steps() == [2]


def test_orphan_gc_and_layout_preference(tmp_path):
    """Incomplete proc-layout orphans older than the kept window are
    pruned, and a step present in BOTH layouts restores from the newest
    complete set."""
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, max_to_keep=2, process_index=0,
                            process_count=1)
    for s in (1, 2, 3):
        mgr.save(s, {"v": np.full((2,), float(s))}, blocking=True)
    orphan = os.path.join(root, "step_0.proc1")
    os.makedirs(orphan)
    with open(os.path.join(orphan, "manifest.json"), "w") as f:
        json.dump({"step": 0, "process": 1, "process_count": 2,
                   "vars": {}}, f)
    assert mgr.all_steps() == [2, 3]   # orphan invisible
    mgr.save(4, {"v": np.full((2,), 4.0)}, blocking=True)
    assert not os.path.exists(orphan), "orphan survived gc"

    def fabricate(dirname, value):
        d = os.path.join(root, dirname)
        os.makedirs(d)
        np.save(os.path.join(d, "v.npy"), np.full((2,), value))
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump({"step": 9, "process": 0, "process_count": 1,
                       "vars": {"v": {"global_shape": [2],
                                      "dtype": "float64",
                                      "pieces": [{"file": "v.npy",
                                                  "index": None}]}}}, f)

    fabricate("step_9", -1.0)
    time.sleep(0.05)     # the manifests' mtimes order the two layouts
    fabricate("step_9.proc0", 9.0)
    assert mgr.restore(9)["v"][0] == 9.0, "stale layout shadowed fresh"


# -- the fallback and quorum cases ------------------------------------------
def _state(scale=1.0):
    return {"qw": torch.arange(24, dtype=torch.float32).reshape(4, 6) * scale,
            "qb": torch.full((6,), 0.5 * scale)}


def test_corrupt_manifest_falls_back_a_step(tmp_path, metrics):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    for s in (1, 2, 3):
        mgr.save(s, {"v": np.full((2,), float(s))}, blocking=True)
    m = os.path.join(str(tmp_path / "ck"), "step_3", "manifest.json")
    with open(m, "w") as f:
        f.write('{"step": 3, "vars": {')
    with pytest.warns(RuntimeWarning, match="manifest"):
        assert mgr.latest_step() == 2
    with pytest.warns(RuntimeWarning):
        assert mgr.restore()["v"][0] == 2.0
    assert metrics.counter_value("recovery.ckpt_corrupt") >= 1


def test_missing_shard_restores_from_a_replica(tmp_path, metrics):
    """The local step lost a file; the replica serves the step, byte for
    byte, instead of a fall back to an older step."""
    local = str(tmp_path / "local")
    mgr = CheckpointManager(local, replica_roots=[str(tmp_path / "peer")],
                            replicas=1)
    mgr.save(5, _state(1.0), blocking=True)
    mgr.save(10, _state(2.0), blocking=True)
    rep = os.path.join(str(tmp_path / "peer"), ".replicas", "local",
                       "step_10")
    assert sorted(os.listdir(rep)) == sorted(
        os.listdir(os.path.join(local, "step_10")))
    os.remove(os.path.join(local, "step_10", "qw.npy"))
    with pytest.warns(RuntimeWarning, match="missing a shard"):
        got = mgr.restore()
    for k, want in _state(2.0).items():
        assert got[k].tobytes() == want.numpy().tobytes()
    assert metrics.counter_value("recovery.ckpt_missing_shard") >= 1
    assert metrics.counter_value("recovery.ckpt_quorum_restore") >= 1
    # with no replica left either, restore falls back a step
    shutil.rmtree(rep)
    with pytest.warns(RuntimeWarning):
        got = CheckpointManager(local).restore()
    np.testing.assert_array_equal(got["qw"], _state(1.0)["qw"].numpy())


def test_torn_local_save_loses_the_quorum(tmp_path, metrics):
    """A save published locally but never mirrored (a crash between the
    two) is one vote of three: latest_step() answers the replicated
    step."""
    local = str(tmp_path / "local")
    peers = [str(tmp_path / "p1"), str(tmp_path / "p2")]
    CheckpointManager(local, replica_roots=peers,
                      replicas=2).save(10, _state(), blocking=True)
    CheckpointManager(local).save(20, _state(9.0), blocking=True)
    mgr = CheckpointManager(local, replica_roots=peers, replicas=2)
    assert mgr.latest_step() == 10
    assert 20 not in mgr.all_steps()
    assert metrics.counter_value("recovery.ckpt_quorum_reject") >= 1
    assert CheckpointManager(local).latest_step() == 20


# -- load_checkpoint: in place, partial, placement ---------------------------
def test_load_checkpoint_in_place_partial_and_placement(tmp_path):
    main, startup, loss = _mlp(fluid, unique_name, counter=True)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    with fluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=_batch(0), fetch_list=[loss])
        fluid.io.save_checkpoint_async(mgr, 1, main_program=main,
                                       scope=scope, blocking=True)
        exe.run(main, feed=_batch(1), fetch_list=[loss])
        held = _persistables(main, scope)
        fluid.io.load_checkpoint(mgr, main_program=main, scope=scope)
        # copied into the tensors the scope holds: a graph stays bound
        assert all(scope.get(n) is t for n, t in held.items())
    # a var the checkpoint lacks raises unless the caller allows it
    data = {n: v for n, v in mgr.restore(1).items() if n != "fc_1.b_0_0"}
    mgr.save(2, data, blocking=True)
    with pytest.raises(KeyError, match="fc_1.b_0_0"):
        fluid.io.load_checkpoint(mgr, main_program=main, scope=scope)
    assert fluid.io.load_checkpoint(mgr, main_program=main, scope=scope,
                                    allow_partial=True) == 2
    # a scope with no tensors: the card unless the caller names a place
    empty = fluid.Scope()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fluid.io.load_checkpoint(mgr, main_program=main, scope=empty,
                                     step=1)
    fluid.io.load_checkpoint(mgr, main_program=main, scope=empty, step=1,
                             place=fluid.CPUPlace())
    counter = empty.get("global_step")
    assert counter.device.type == "cpu" and counter.dtype == torch.int64


def test_load_checkpoint_with_steps_in_the_dispatch_window(tmp_path):
    """A restore while windowed steps are in flight runs after them (the
    same stream), leaves their records (and verdicts) in the window,
    unread, and the restored state holds."""
    main, startup, loss = _mlp(fluid, unique_name)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_checkpoint_async(mgr, 0, main_program=main,
                                       scope=scope, blocking=True)
        want = {n: _host(v).copy()
                for n, v in _persistables(main, scope).items()}
        outs = [exe.run(main, feed=_batch(i), fetch_list=[loss],
                        dispatch_steps=4) for i in range(2)]
        assert len(exe.engine.window) == 2
        fluid.io.load_checkpoint(mgr, main_program=main, scope=scope)
        assert len(exe.engine.window) == 2
        for name, arr in want.items():
            np.testing.assert_array_equal(_host(scope.get(name)), arr)
        exe.sync()
        assert all(np.isfinite(np.asarray(o[0])).all() for o in outs)


# -- across the packages ------------------------------------------------------
def _j_state(main, scope):
    return {v.name: np.asarray(scope.get(v.name)) for v in main.list_vars()
            if v.persistable and scope.get(v.name) is not None}


def _assert_step_agrees(j_loss, j_state, t_loss, t_state):
    np.testing.assert_allclose(np.asarray(t_loss), np.asarray(j_loss),
                               rtol=STEP_RTOL)
    assert sorted(j_state) == sorted(t_state)
    for name, want in j_state.items():
        got = t_state[name]
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=STEP_RTOL,
                                       atol=1e-7, err_msg=name)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """The JAX package's CheckpointManager writes step 2 of the MLP (its
    int64 counter held as int32); the port restores it into its own scope
    (as int64) and its next step gives the JAX package's next step."""
    root = str(tmp_path / "ckpt")
    jmain, jstartup, jloss = _mlp(jfluid, j_unique_name, counter=True)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        for i in range(2):
            jexe.run(jmain, feed=_batch(i), fetch_list=[jloss])
        jfluid.io.save_checkpoint_async(JManager(root), 2,
                                        main_program=jmain, scope=jscope,
                                        blocking=True)
        (j_loss,) = jexe.run(jmain, feed=_batch(2), fetch_list=[jloss])
        j_state = _j_state(jmain, jscope)
    with open(os.path.join(root, "step_2", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["vars"]["global_step"]["dtype"] == "int32"

    main, startup, loss = _mlp(fluid, unique_name, counter=True)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        assert fluid.io.load_checkpoint(CheckpointManager(root),
                                        main_program=main,
                                        scope=scope) == 2
        assert scope.get("global_step").dtype == torch.int64
        (t_loss,) = exe.run(main, feed=_batch(2), fetch_list=[loss])
        t_state = {n: _host(v) for n, v in _persistables(main,
                                                         scope).items()}
    _assert_step_agrees(j_loss, j_state, t_loss, t_state)


def test_port_checkpoint_restores_in_jax(tmp_path):
    root = str(tmp_path / "ckpt")
    main, startup, loss = _mlp(fluid, unique_name, counter=True)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        for i in range(2):
            exe.run(main, feed=_batch(i), fetch_list=[loss])
        fluid.io.save_checkpoint_async(CheckpointManager(root), 2,
                                       main_program=main, scope=scope,
                                       blocking=True)
        (t_loss,) = exe.run(main, feed=_batch(2), fetch_list=[loss])
        t_state = {n: _host(v) for n, v in _persistables(main,
                                                         scope).items()}

    jmain, jstartup, jloss = _mlp(jfluid, j_unique_name, counter=True)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        assert jfluid.io.load_checkpoint(JManager(root), main_program=jmain,
                                         scope=jscope) == 2
        (j_loss,) = jexe.run(jmain, feed=_batch(2), fetch_list=[jloss])
        j_state = _j_state(jmain, jscope)
    _assert_step_agrees(j_loss, j_state, t_loss, t_state)


def test_bfloat16_files_match_the_jax_package(tmp_path):
    """A bfloat16 value is written as the JAX package writes one (a
    '<V2' .npy, "bfloat16" in the manifest), byte for byte, and restores
    in each package to the same bit patterns."""
    rng = np.random.RandomState(3)
    f32 = rng.randn(5, 7).astype(np.float32)
    bf = f32.astype(ml_dtypes.bfloat16)
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    JManager(jroot).save(1, {"h": jnp.asarray(bf), "w": f32},
                         blocking=True)
    CheckpointManager(troot).save(
        1, {"h": torch.from_numpy(f32).to(torch.bfloat16),
            "w": torch.from_numpy(f32)}, blocking=True)
    for name in ("h.npy", "w.npy", "manifest.json"):
        with open(os.path.join(jroot, "step_1", name), "rb") as a, \
                open(os.path.join(troot, "step_1", name), "rb") as b:
            assert a.read() == b.read(), name
    got = CheckpointManager(jroot).restore(1)["h"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  bf.view(np.int16))
    back = JManager(troot).restore(1)["h"]
    np.testing.assert_array_equal(back.view(np.int16), bf.view(np.int16))


def test_jax_two_process_sharded_layout_restores(tmp_path):
    """Two processes' ``step_N.procI`` dirs as the JAX package's writer
    builds them (pieces of a dp-sharded array with their slices, a host
    value written by process 0 only, bfloat16 pieces) reassemble in the
    port; a two-process layout of the port's restores in the JAX
    package."""
    if len(jax.devices()) < 2:
        pytest.skip("needs two JAX CPU devices")
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    x = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    h = (np.arange(24.0, dtype=np.float32) / 7).reshape(6, 4).astype(
        ml_dtypes.bfloat16)
    arrays = {"x": jax.device_put(x, NamedSharding(mesh, P("dp", None))),
              "h": jax.device_put(h, NamedSharding(mesh, P("dp", None))),
              "step_count": np.array([7], np.int64)}
    root = str(tmp_path / "j")
    for pi in (0, 1):
        JManager(root, process_index=pi, process_count=2).save(
            3, arrays, blocking=True)
    assert sorted(os.listdir(root)) == ["step_3.proc0", "step_3.proc1"]
    files = os.listdir(os.path.join(root, "step_3.proc0"))
    assert sum(f.startswith("x.shard") for f in files) == 2
    got = CheckpointManager(root).restore(3)
    np.testing.assert_array_equal(got["x"], x)
    np.testing.assert_array_equal(got["h"].view(torch.int16).numpy(),
                                  h.view(np.int16))
    np.testing.assert_array_equal(got["step_count"], [7])

    troot = str(tmp_path / "t")
    for pi in (0, 1):
        CheckpointManager(troot, process_index=pi, process_count=2).save(
            3, {"x": torch.from_numpy(x)}, blocking=True)
    np.testing.assert_array_equal(JManager(troot).restore(3)["x"], x)
