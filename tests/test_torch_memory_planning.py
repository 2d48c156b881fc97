"""The port's memory planner (``paddle_tpu_torch/analysis/memory.py``) and
the engine's level-3 seam against the JAX package's, on the CPU, at a
tiny size (the MLP, a 2-layer BERT at hidden size 32, seq 32, batch 2,
and ResNet-20 on 32x32 at batch 4); it mirrors
tests/test_memory_planning.py.

- Liveness, donation and remat plans equal to the JAX package's on the
  same descs (every interval, the peak and its order, the donated and
  held sets with their reasons, the segment count, the estimate, the
  candidates and the reason), at no budget, a generous and a tight one;
  ``replan_segments`` equal on the same measurements.
- The liveness units of the reference (a toy chain, persistables pinned
  for the whole program) and the donation-safety property.
- The engine at level 3: the memory budget is part of the cache key (a
  new ``device_memory_bytes`` is a new entry); a 2 MiB budget makes
  auto-remat lower the plan's segment count, and the losses match level
  2's (rtol 1e-4, atol 1e-5, the reference's tolerance); with no budget
  pressure no segment is lowered; a planner that raises is counted
  (``memory.plan_crashes``) and the step runs unplanned.
- The measured-feedback loop (``Engine._note_peak``, which the card's
  first run calls with ``torch.cuda.max_memory_allocated``), seeded with
  a measurement: a miss beyond ``replan_tolerance`` rebuilds the entry
  once, with the re-planned segment count; never twice; not at all with
  the tolerance at its default 0.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import models as j_models
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.analysis import memory as j_memory
from paddle_tpu.analysis import build_graph as j_build_graph

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import flags, models
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.analysis import build_graph
from paddle_tpu_torch.analysis import memory
from paddle_tpu_torch.analysis.memory import (
    RematPlan, analyze_liveness, plan_memory, replan_segments,
)
from torch_threads import one_torch_thread  # noqa: F401

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    for name in ("opt_level", "device_memory_bytes", "hbm_budget_frac",
                 "replan_tolerance", "metrics"):
        flags.reset_flag(name)


def _mlp(fluid, guard):
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[12], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=16, act="relu",
                            param_attr=fluid.ParamAttr(name="w1"))
        pred = fluid.layers.fc(input=h, size=4,
                               param_attr=fluid.ParamAttr(name="w2"))
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits=pred, label=y))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, {"loss": loss}


def _bert(mods, guard):
    with guard():
        return mods.bert.get_model(
            batch_size=2, seq_len=32, vocab_size=128, d_model=32,
            n_layers=2, n_heads=2, d_inner=64, dropout=0.0,
            max_position=64, use_fused_attention=True)


def _resnet(mods, guard):
    with guard():
        return mods.resnet.get_model(batch_size=4, dataset="cifar10",
                                     depth=20)


def _build(kind, pkg):
    fluid, mods, guard = ((jfluid, j_models, j_unique_name.guard)
                          if pkg == "jax" else
                          (tfluid, models, t_unique_name.guard))
    if kind == "mlp":
        return _mlp(fluid, guard)
    return (_bert if kind == "bert" else _resnet)(mods, guard)


_FEED_SHAPES = {
    "mlp": {"x": (16, 12), "y": (16, 1)},
    "bert": None,
    "resnet": {"img": (4, 3, 32, 32), "label": (4, 1)},
}


def _feed(kind, rng):
    if kind == "mlp":
        return {"x": rng.randn(16, 12).astype(np.float32),
                "y": rng.randint(0, 4, (16, 1)).astype(np.int64)}
    if kind == "bert":
        return models.bert.make_fake_batch(2, 32, 128, rng=rng)
    return {"img": rng.randn(4, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}


def _plan_facts(plan):
    lv, dn, rm = plan.liveness, plan.donation, plan.remat
    return (
        {n: (iv.start, iv.end, iv.nbytes, iv.persistable)
         for n, iv in lv.intervals.items()},
        lv.peak_bytes, lv.peak_order, lv.n_orders,
        sorted(dn.donate), dict(dn.held),
        rm.n_segments, rm.activation_bytes, rm.est_peak_bytes,
        [tuple(c) for c in rm.candidates], rm.reason,
        plan.predicted_peak_bytes, plan.render(),
    )


@pytest.mark.parametrize("budget", ["none", "generous", "tight"])
@pytest.mark.parametrize("kind", ["mlp", "bert", "resnet"])
def test_plans_match_reference(kind, budget):
    j_main, _, j_h = _build(kind, "jax")
    t_main, _, t_h = _build(kind, "torch")
    shapes = _FEED_SHAPES[kind]
    if shapes is None:
        shapes = {n: tuple(v.shape) for n, v in _feed(
            kind, np.random.RandomState(0)).items()}
    fetch = [t_h["loss"].name]
    peak = plan_memory(t_main.desc, feed_shapes=shapes,
                       fetch_names=fetch).liveness.peak_bytes
    budget_bytes = {"none": None, "generous": 1 << 40,
                    "tight": peak // 2}[budget]
    got = plan_memory(t_main.desc, feed_shapes=shapes, fetch_names=fetch,
                      budget_bytes=budget_bytes)
    want = j_memory.plan_memory(j_main.desc, feed_shapes=shapes,
                                fetch_names=fetch, budget_bytes=budget_bytes)
    assert _plan_facts(got) == _plan_facts(want)
    if budget == "tight":
        assert got.remat.n_segments in (2, 4, 8, 16, 32)
        for measured in (64 << 10, got.predicted_peak_bytes, 64 << 20):
            a = replan_segments(got, measured, budget_bytes)
            b = j_memory.replan_segments(want, measured, budget_bytes)
            assert (a.n_segments, a.est_peak_bytes, a.reason) == \
                (b.n_segments, b.est_peak_bytes, b.reason)


def test_liveness_units_match_reference():
    """The reference's toy chain and MNIST units, in the port."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        a = tfluid.layers.scale(x, scale=2.0)
        b = tfluid.layers.scale(a, scale=3.0)
    rep = analyze_liveness(main.desc, feed_shapes={"x": (8, 4)})
    ivs = rep.intervals
    assert (ivs["x"].start, ivs["x"].end) == (0, 0)
    assert (ivs[a.name].start, ivs[a.name].end) == (0, 1)
    assert (ivs[b.name].start, ivs[b.name].end) == (1, 1)
    assert rep.peak_bytes == 2 * 8 * 4 * 4
    main, _, _ = models.mnist.get_model(lr=0.1)
    rep = analyze_liveness(main.desc,
                           feed_shapes={"img": (16, 784), "label": (16, 1)})
    for p in main.all_parameters():
        iv = rep.intervals[p.name]
        assert iv.persistable and (iv.start, iv.end) == (0, rep.n_orders - 1)
    graph = build_graph(main.desc)
    j_main, _, _ = j_models.mnist.get_model(lr=0.1)
    assert len(graph.all_vars()) == len(j_build_graph(j_main.desc)
                                        .all_vars())


def test_donation_never_aliases_a_live_fetch():
    main, _, h = _build("mlp", "torch")
    plan = plan_memory(main.desc, feed_shapes=_FEED_SHAPES["mlp"],
                       fetch_names=[h["loss"].name, "w1"])
    assert not (plan.donation.donate & {h["loss"].name, "w1"})
    assert "fetched" in plan.donation.held["w1"]
    graph = build_graph(main.desc)
    assert all(graph.var(0, n).persistable for n in plan.donation.donate)


def _train(kind, opt_level, steps=3, device_bytes=None, fetch_extra=()):
    flags.set_flags({"opt_level": opt_level})
    if device_bytes is not None:
        flags.set_flags({"device_memory_bytes": device_bytes})
    main, startup, h = _build(kind, "torch")
    exe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(0)
    out = []
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        for _ in range(steps):
            vals = exe.run(main, feed=_feed(kind, rng),
                           fetch_list=[h["loss"]] + list(fetch_extra))
            out.append([np.asarray(v) for v in vals])
    return out, exe


def _losses(out):
    return [float(v[0].reshape(-1)[0]) for v in out]


def _planned(exe):
    return [c for c in exe.engine._cache.values()
            if c.memory_plan is not None and c.auto_remat_eligible]


@pytest.mark.parametrize("kind", ["bert", "resnet"])
def test_opt3_auto_remat_parity(kind):
    """A 2 MiB budget makes auto-remat lower the plan's segments; the
    level-3 losses match level 2's."""
    l2, _ = _train(kind, 2)
    l3, exe = _train(kind, 3, device_bytes=2 << 20)
    segmented = [c for c in _planned(exe)
                 if c.memory_plan.remat.n_segments > 0]
    assert segmented and all(c.remat_segments ==
                             c.memory_plan.remat.n_segments
                             for c in segmented)
    np.testing.assert_allclose(_losses(l3), _losses(l2), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)


def test_opt3_donation_only_parity_and_budget_in_key():
    """No budget pressure: no segment lowered, the fetched state still
    correct step over step; a new budget is a new cache entry."""
    l2, _ = _train("mlp", 2, steps=4, fetch_extra=["w1"])
    l3, exe = _train("mlp", 3, steps=4, fetch_extra=["w1"])
    for a, b in zip(l3, l2):
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a[1], b[1], rtol=1e-5, atol=1e-6)
    planned = _planned(exe)
    assert planned and all(c.remat_segments == 0 for c in planned)
    steps = [c for c in planned if "x" in c.block_program.feed_names]
    assert steps and all("w1" in c.memory_plan.donation.held for c in steps)
    keys = {c._cache_key[-2] for c in planned}
    assert keys == {None}  # the CPU has no device limit: no budget
    flags.set_flags({"device_memory_bytes": 1 << 30})
    main, startup, h = _build("mlp", "torch")
    exe2 = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe2.run(startup)
        feed = _feed("mlp", np.random.RandomState(0))
        exe2.run(main, feed=feed, fetch_list=[h["loss"]])
        flags.set_flags({"device_memory_bytes": 1 << 31})
        exe2.run(main, feed=feed, fetch_list=[h["loss"]])
    budgets = sorted(c._cache_key[-2] for c in _planned(exe2)
                     if "x" in c.block_program.feed_names)
    assert budgets == [int((1 << 30) * 0.9), int((1 << 31) * 0.9)]


def test_plan_crash_is_counted_and_runs_unplanned(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("planner bug")

    monkeypatch.setattr(memory, "plan_memory", boom)
    flags.set_flags({"metrics": True})
    c0 = obs.counter_value("memory.plan_crashes")
    out, exe = _train("mlp", 3, steps=2)
    # one crash an entry: the startup program's and the step's
    assert obs.counter_value("memory.plan_crashes") == c0 + 2
    assert all(c.memory_plan is None for c in exe.engine._cache.values())
    assert all(np.isfinite(_losses(out)))


def _replan_run(steps, tolerance, measured):
    """ResNet-20 at level 3 under a 2 MiB budget; after the first step
    the planned entry is handed ``measured`` as its peak, as the card's
    first run hands it torch.cuda.max_memory_allocated."""
    flags.set_flags({"opt_level": 3, "device_memory_bytes": 2 << 20,
                     "replan_tolerance": tolerance, "metrics": True})
    main, startup, h = _build("resnet", "torch")
    exe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(0)
    losses = []
    c0 = obs.counter_value("memory.replan")
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        for i in range(steps):
            (l,) = exe.run(main, feed=_feed("resnet", rng),
                           fetch_list=[h["loss"]])
            losses.append(float(np.asarray(l).reshape(-1)[0]))
            for c in _planned(exe) + [c for c in exe.engine._cache.values()
                                      if c.replanned]:
                if c.peak_bytes is None:
                    exe.engine._note_peak(c, measured)
    return losses, exe, obs.counter_value("memory.replan") - c0


def test_replan_rebuilds_once_on_a_seeded_miss():
    """A measured 64 KiB against a segmented plan: the entry is rebuilt
    once, unsegmented, and the losses stay on level 2's trajectory; the
    rebuilt entry never re-plans again."""
    losses, exe, n = _replan_run(4, 0.25, 64 << 10)
    assert n == 1
    live = [c for c in exe.engine._cache.values()
            if c.memory_plan is not None]
    assert live and all(c.replanned and c.remat_segments == 0 for c in live)
    l2, _ = _train("resnet", 2, steps=4)
    np.testing.assert_allclose(losses, _losses(l2), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)


def test_replan_is_off_at_the_default_tolerance():
    _, exe, n = _replan_run(2, 0.0, 64 << 10)
    assert n == 0
    assert any(c.remat_segments > 0 for c in _planned(exe))


def test_replan_segments_rescales_cost_model():
    """The reference's unit, in the port."""
    A = 1 << 20
    plan = RematPlan(4, A, (1 << 20) + (2 * A + 3) // 4, [], "unit")
    assert replan_segments(plan, 64 << 10, 2 << 20).n_segments == 0
    same = replan_segments(plan, plan.est_peak_bytes, plan.est_peak_bytes)
    assert same.n_segments == plan.n_segments
    high = replan_segments(plan, 64 << 20, 1 << 20, max_segments=8)
    assert plan.n_segments < high.n_segments <= 8
    assert replan_segments(plan, 0, 1 << 20).n_segments == 4
    assert replan_segments(plan, 1 << 20, 0).n_segments == 4
