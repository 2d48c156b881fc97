"""The port's ``resilience/retrying.py`` and ``resilience/faultinject.py``
against the JAX package's, and the engine's fault seams on the CPU.

- ``parse_fault_spec``, ``random_spec`` and ``FaultSchedule``'s firing
  sequence equal the JAX package's on a table of specs, with rank,
  restart, repeat and hit-count conditions; ``Backoff``'s delays are
  equal for the same seed (exactly: one ``random.Random`` stream each)
  and ``retry_call`` retries, gives up and clips to its deadline alike.
- The engine seams: ``step_nan`` trips the nan guard with the JAX
  package's message, naming the same var and step, in a plain run and
  in a dispatch window (deferred verdict); the poisoned state is the
  scope's own tensors; ``step_fail`` raises ``InjectedFault``;
  ``compile`` fires once, at the cache miss and before the transforms;
  ``bitflip`` raises ``NotImplementedError`` naming item 11.

Every test starts and ends with no spec and a fresh schedule in both
packages, so files sharing a worker cannot leak a spec into each other.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import flags as j_flags
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.resilience import faultinject as j_fi
from paddle_tpu.resilience import retrying as j_retrying

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import flags, unique_name
from paddle_tpu_torch.resilience import faultinject as fi
from paddle_tpu_torch.resilience import retrying


@pytest.fixture(autouse=True)
def _no_spec():
    for f, mod in ((flags, fi), (j_flags, j_fi)):
        f.reset_flag("fault_spec")
        f.reset_flag("check_nan_inf")
        mod.reset()
    yield
    for f, mod in ((flags, fi), (j_flags, j_fi)):
        f.reset_flag("fault_spec")
        f.reset_flag("check_nan_inf")
        mod.reset()


def _arm(spec):
    for f, mod in ((flags, fi), (j_flags, j_fi)):
        f.set_flags({"fault_spec": spec})
        mod.reset()


# -- the schedule -------------------------------------------------------------
SPECS = [
    "step_nan@7; worker_kill@rank1:step12 ;ckpt_write@3:x2;compile",
    "step_fail@4",
    "compile@2",
    "ckpt_write@x3",
    "step_nan@restart1:step5",
    "worker_kill@rank1:step5",
    "bitflip@rank0:step3:x9:dev2;preempt@rank1:step8;disk_fail@6",
    "worker_hang@rank2:restart1:step4;worker_loss@rank0:step9",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_fault_spec_equals_the_jax_package(spec):
    def fields(e):
        return (e.point, e.step, e.rank, e.restart, e.repeat, e.dev,
                repr(e))

    assert [fields(e) for e in fi.parse_fault_spec(spec)] == \
        [fields(e) for e in j_fi.parse_fault_spec(spec)]


@pytest.mark.parametrize("bad", ["meteor_strike@3", "step_nan@sometimes"])
def test_bad_specs_raise_the_same_error(bad):
    with pytest.raises(ValueError) as t_err:
        fi.parse_fault_spec(bad)
    with pytest.raises(ValueError) as j_err:
        j_fi.parse_fault_spec(bad)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rank,restart", [(0, 0), (1, 0), (1, 1), (2, 1)])
def test_schedule_fires_as_the_jax_package(spec, rank, restart):
    """The same hits (with and without a step from the seam) fire the
    same entries in both packages."""
    hits = [(p, s) for s in range(1, 14) for p in sorted(fi.KNOWN_POINTS)]
    hits += [(p, None) for p in sorted(fi.KNOWN_POINTS)] * 3
    t = fi.FaultSchedule(spec, rank=rank, restart=restart)
    j = j_fi.FaultSchedule(spec, rank=rank, restart=restart)
    fired_t = [repr(t.check(p, step=s)) for p, s in hits]
    fired_j = [repr(j.check(p, step=s)) for p, s in hits]
    assert fired_t == fired_j
    assert t._hits == j._hits


def test_schedule_reads_rank_and_restart_from_the_environment(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_GPU_RESTART_COUNT", "2")
    s = fi.FaultSchedule("step_fail@rank1:restart2:step3")
    assert (s.rank, s.restart) == (1, 2)
    assert s.check("step_fail", step=3) is not None


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_spec_equals_the_jax_package(seed):
    kinds = ("worker_kill", "step_nan", "bitflip", "preempt", "ckpt_write")
    for n_steps, nproc in ((40, 1), (40, 2), (500, 8)):
        assert fi.random_spec(seed, n_steps, nproc=nproc, kinds=kinds) == \
            j_fi.random_spec(seed, n_steps, nproc=nproc, kinds=kinds)
    assert fi.random_spec(seed, 40) == j_fi.random_spec(seed, 40)


def test_exit_codes_equal_the_jax_package():
    for name in ("KILLED_EXIT_CODE", "LOST_EXIT_CODE", "PREEMPT_EXIT_CODE",
                 "POISON_POINTS", "KNOWN_POINTS"):
        assert getattr(fi, name) == getattr(j_fi, name), name


# -- retrying ------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(base=1.0, factor=1.0, cap=1.0, jitter=0.5, seed=7),
    dict(base=0.05, cap=1.0, jitter=0.5, seed=3),
    dict(base=0.1, factor=2.0, cap=1.0, jitter=0.0),
    dict(base=0.2, factor=3.0, cap=4.0, jitter=1.0, seed=11),
])
def test_backoff_delays_equal_the_jax_package(kw):
    t, j = retrying.Backoff(**kw), j_retrying.Backoff(**kw)
    assert [t.envelope(k) for k in range(8)] == \
        [j.envelope(k) for k in range(8)]
    assert [t.delay(k) for k in range(50)] == [j.delay(k) for k in range(50)]


def test_retry_call_gives_up_and_clips_as_the_jax_package():
    def run(mod):
        calls, sleeps, now = [], [], [0.0]

        def boom():
            calls.append(1)
            now[0] += 0.4
            raise OSError("down")

        def sleep(s):
            sleeps.append(s)
            now[0] += s

        with pytest.raises(mod.RetriesExhausted) as ei:
            mod.retry_call(boom, attempts=3,
                           backoff=mod.Backoff(base=0.1, seed=1),
                           sleep=sleep, clock=lambda: now[0])
        assert isinstance(ei.value.__cause__, OSError)
        with pytest.raises(mod.DeadlineExceeded):
            mod.retry_call(boom, deadline=1.0,
                           backoff=mod.Backoff(base=10.0, jitter=0.0),
                           sleep=sleep, clock=lambda: now[0])
        with pytest.raises(ValueError):
            mod.retry_call(lambda: 1)
        return len(calls), sleeps

    assert run(retrying) == run(j_retrying)


# -- the engine's seams ----------------------------------------------------------
def _mlp(fluid_, unique_name_):
    main, startup = fluid_.Program(), fluid_.Program()
    with unique_name_.guard(), fluid_.program_guard(main, startup):
        x = fluid_.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid_.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid_.layers.fc(input=x, size=16, act="relu")
        pred = fluid_.layers.fc(input=h, size=4)
        loss = fluid_.layers.mean(fluid_.layers.softmax_with_cross_entropy(
            logits=pred, label=y))
        fluid_.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(16, 8).astype(np.float32),
            "y": rng.randint(0, 4, (16, 1)).astype(np.int64)}


def _started(fluid_, unique_name_, f):
    """A started MLP with check_nan_inf on: (exe, scope, main, loss)."""
    f.set_flags({"check_nan_inf": True})
    main, startup, loss = _mlp(fluid_, unique_name_)
    exe, scope = fluid_.Executor(fluid_.CPUPlace()), fluid_.Scope()
    with fluid_.scope_guard(scope):
        exe.run(startup)
    return exe, scope, main, loss


def _nan_trip(fluid_, unique_name_, f, dispatch_steps):
    """Arm step_nan for the second training step; returns (the guard's
    message, the engine's run counter at the trip, the scope)."""
    exe, scope, main, loss = _started(fluid_, unique_name_, f)
    target = exe.engine._run_counter + 2
    _arm("step_nan@%d" % target)
    kw = {"dispatch_steps": dispatch_steps} if dispatch_steps > 1 else {}
    with fluid_.scope_guard(scope):
        with pytest.raises(RuntimeError, match="check_nan_inf") as err:
            for i in range(4):
                exe.run(main, feed=_batch(i), fetch_list=[loss], **kw)
            exe.sync()
    return str(err.value), target, scope, exe


@pytest.mark.parametrize("dispatch_steps", [1, 2])
def test_step_nan_trips_the_guard_with_the_reference_message(
        dispatch_steps):
    t_msg, t_step, scope, exe = _nan_trip(fluid, unique_name, flags,
                                          dispatch_steps)
    j_msg, j_step, _, _ = _nan_trip(jfluid, j_unique_name, j_flags,
                                    dispatch_steps)
    assert t_step == j_step
    assert "after step %d" % t_step in t_msg
    assert t_msg == j_msg
    # the donated state was poisoned in place: the scope's own tensors
    assert torch.isnan(scope.get("fc_0.w_0_0")).all()
    exe.engine.discard_window()


def test_step_fail_raises_injected_fault():
    exe, scope, main, loss = _started(fluid, unique_name, flags)
    _arm("step_fail@%d" % (exe.engine._run_counter + 1))
    with fluid.scope_guard(scope):
        with pytest.raises(fi.InjectedFault, match="step_fail"):
            exe.run(main, feed=_batch(0), fetch_list=[loss])
        (l,) = exe.run(main, feed=_batch(1), fetch_list=[loss])  # spent
    assert np.isfinite(l).all()


def test_compile_fires_once_at_the_cache_miss():
    """The first miss raises before the transforms (nothing analyzed or
    cached); the retry builds the entry; hits never reach the seam."""
    exe, scope, main, loss = _started(fluid, unique_name, flags)
    exe = fluid.Executor(fluid.CPUPlace())     # an empty cache
    _arm("compile@1")
    with fluid.scope_guard(scope):
        with pytest.raises(fi.InjectedFault, match="compile"):
            exe.run(main, feed=_batch(0), fetch_list=[loss])
        assert not exe.engine._blocks and not exe.engine._cache
        for i in range(3):
            exe.run(main, feed=_batch(i), fetch_list=[loss])
    assert len(exe.engine._cache) == 1
    assert fi._schedule._hits["compile"] == 2


def test_bitflip_raises_not_implemented():
    exe, scope, main, loss = _started(fluid, unique_name, flags)
    _arm("bitflip@%d" % (exe.engine._run_counter + 1))
    with fluid.scope_guard(scope):
        with pytest.raises(NotImplementedError, match="item 11"):
            exe.run(main, feed=_batch(0), fetch_list=[loss])


def test_ckpt_write_fault_is_retried_or_fails_the_save(tmp_path):
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.checkpoint import CheckpointManager

    obs.set_enabled(True)
    obs.reset()
    try:
        _arm("ckpt_write@5")
        mgr = CheckpointManager(str(tmp_path / "ok"))
        mgr.save(5, {"v": torch.ones(2)}, blocking=True)
        assert mgr.latest_step() == 5
        assert obs.counter_value("recovery.ckpt_retry") == 1
        _arm("ckpt_write@5:x3")        # one per attempt: all 3 fail
        mgr = CheckpointManager(str(tmp_path / "bad"))
        with pytest.raises(RuntimeError, match="async checkpoint save"):
            mgr.save(5, {"v": torch.ones(2)}, blocking=True)
        assert mgr.latest_step() is None
    finally:
        obs.reset()
        obs.set_enabled(None)
