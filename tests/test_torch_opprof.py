"""The port's op-level profiler (``paddle_tpu_torch/observability/
opprof.py``) against the JAX package's (``paddle_tpu/observability/
opprof.py``), on the CPU, at a tiny size (the reference's MLP: 784 -> 64
-> 10, batch 64):

- every registered op's tag round-trips through ``provenance_tag``,
  ``parse_tag`` and ``tag_op_type`` in both packages; a miss is None;
- ``classify`` gives the reference's verdicts on a grid of FLOPs, bytes
  and peaks, and reads the peak flags; ``gate_issues`` and ``top_rows``
  agree on the same tables;
- ``attribute`` gives the reference's table (only ``source`` differs, and
  the port's ``join`` record is its own) when the reference's
  ``device_op_events`` is patched to return synthetic events under a
  sidecar and the port reads the equivalent synthetic ``torch.profiler``
  trace; the join of a captured entry's replays to its eager run by
  kernel order, a replay the profiler dropped launches from, and one that
  does not match (``source`` "cuda-eager"), on synthetic CUDA traces;
- the opt-2 ``__src_ops__`` lists equal the reference's;
- losses are bit-exact with ``opprof`` on and off at opt levels 0 and 2,
  and with a profiler session active; toggling the flag keeps the
  engine's cache entry;
- the MLP trained under ``start_profiler``/``stop_profiler`` attributes
  at least 95 % of its aten time with every live op in its table, and the
  FLOPs and bytes it registers per tag equal the reference's, the
  accumulated lowering's once-op tags (from 100_000) too.

The CPU's "device events" are host times of aten ops; the file runs
torch on one thread (``tests/torch_threads.py``): with a thread a core
under the suite's load, a small op's parallel region can wait tens of
milliseconds for its threads, at random, whoever launched it.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import flags as j_flags
from paddle_tpu import observability as j_obs
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.analysis.transforms import optimize_program as j_optimize
from paddle_tpu.core.registry import OpRegistry as JOpRegistry
from paddle_tpu.observability import opprof as j_opprof

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import flags as t_flags
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.analysis.transforms import optimize_program
from paddle_tpu_torch.core.registry import OpRegistry
from paddle_tpu_torch.observability import opprof
from torch_threads import one_torch_thread  # noqa: F401

ATTRIBUTED_MIN = 0.95


@pytest.fixture
def clean_registry():
    opprof.reset()
    j_opprof.reset()
    try:
        yield
    finally:
        opprof.reset()
        j_opprof.reset()
        t_obs.reset()
        j_obs.reset()


def _mlp(fluid, optimizer="sgd"):
    img = fluid.layers.data(name="img", shape=[784], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=img, size=64, act="relu")
    pred = fluid.layers.fc(input=h, size=10, act="softmax")
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=pred, label=label))
    if optimizer == "sgd":
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    elif optimizer == "adam":
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss


def _build(pkg, optimizer="sgd"):
    fluid, guard = ((jfluid, j_unique_name.guard) if pkg == "jax"
                    else (tfluid, t_unique_name.guard))
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        loss = _mlp(fluid, optimizer)
    return main, startup, loss


def _feed(batch=64, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(batch, 784).astype(np.float32),
            "label": rng.randint(0, 10, size=(batch, 1)).astype(np.int64)}


# -- tags ------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_every_registered_op_tag_round_trips(pkg):
    mod, reg = ((j_opprof, JOpRegistry) if pkg == "jax"
                else (opprof, OpRegistry))
    types = reg.all_types()
    assert len(types) > 200
    for t in types:
        tag = mod.provenance_tag(t, 0, 7)
        assert mod.parse_tag("run/%s/aten::mm" % tag) == tag, t
        assert mod.tag_op_type(tag) == t
        assert opprof.provenance_tag(t, 3, 11) == \
            j_opprof.provenance_tag(t, 3, 11)
    assert set(OpRegistry.all_types()) >= set(JOpRegistry.all_types())


@pytest.mark.parametrize("name", [
    "jit(run)/dot_general", "", None, "jit(f)/pt.mul.x_y/dot",
    "aten::mm", "opprof.replay#3"])
def test_parse_tag_misses_return_none(name):
    assert opprof.parse_tag(name) is None
    assert j_opprof.parse_tag(name) is None


# -- roofline classifier ---------------------------------------------------

def test_classify_matches_reference_on_a_grid():
    values = (0, 1, 10, 100, 1000, 1e6)
    peaks = ((0, 10e9), (100e9, 0), (100e9, 10e9), (989e12, 3.35e12),
             (67e12, 3.35e12))
    for flops in values:
        for nbytes in values:
            for pf, pm in peaks:
                assert opprof.classify(flops, nbytes, pf, pm) == \
                    j_opprof.classify(flops, nbytes, pf, pm), \
                    (flops, nbytes, pf, pm)
    assert opprof.classify(100, 10, 100e9, 10e9) == "compute-bound"
    assert opprof.classify(1000, 0, 100e9, 10e9) == "unknown"


def test_classify_reads_peak_flags():
    for fl in (t_flags, j_flags):
        fl.set_flags({"peak_flops": 100e9, "peak_membw_bytes": 10e9})
    try:
        for flops, nbytes in ((1000, 10), (10, 1000), (100, 10)):
            assert opprof.classify(flops, nbytes) == \
                j_opprof.classify(flops, nbytes)
        assert opprof.classify(10, 1000) == "memory-bound"
    finally:
        for fl in (t_flags, j_flags):
            fl.reset_flag("peak_flops")
            fl.reset_flag("peak_membw_bytes")
    assert opprof.classify(1000, 10) == "unknown"
    assert t_flags.get_flag("opprof") is j_flags.get_flag("opprof") is True


_TABLES = [
    {"ops": {}, "collective_instances": 0,
     "expected_collective_instances": 0},
    {"ops": {"pt.mul.0_0": {"ms": 1.0}}, "collective_instances": 2,
     "expected_collective_instances": 2},
    {"ops": {"pt.mul.0_0": {"ms": 1.0}}, "collective_instances": 3,
     "expected_collective_instances": 2},
    {"ops": {"pt.mul.0_0": {"ms": 0.0}, "pt.relu.0_1": {"ms": 0.0}},
     "collective_instances": 1, "expected_collective_instances": 0},
    {"ops": {"pt.b.0_1": {"ms": 2.0}, "pt.a.0_0": {"ms": 2.0},
             "pt.c.0_2": {"ms": 0.0}, "pt.d.0_3": {"ms": 5.0}}},
]


@pytest.mark.parametrize("i", range(len(_TABLES)))
def test_gate_issues_and_top_rows_agree(i):
    table = _TABLES[i]
    got, want = opprof.gate_issues(table), j_opprof.gate_issues(table)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.split()[:4] == w.split()[:4]  # the same finding
        assert [int(s) for s in g.split() if s.isdigit()] == \
            [int(s) for s in w.split() if s.isdigit()]
    for k in (1, 2, 15):
        assert opprof.top_rows(table, k) == j_opprof.top_rows(table, k)


# -- attribution on synthetic traces ----------------------------------------

def _ev(cat, name, ts, dur, tid=1, corr=None, pid=1):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
         "ts": float(ts), "dur": float(dur), "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "baseTimeNanoseconds": 10 ** 18,
                   "traceEvents": events}, f)
    return str(path)


_SIDECAR = {
    "policy": "dominant",
    "instr_tags": {"multiply.1": "pt.mul.0_0"},
    "instr_kinds": {"multiply.1": "multiply"},
    "costs": {"pt.mul.0_0": {"op_type": "mul", "flops": 100,
                             "bytes": 10, "src_ops": None},
              "pt.relu.0_1": {"op_type": "relu", "flops": 1,
                              "bytes": 1, "src_ops": None}},
    "collectives": {"hlo_psums": 0, "hlo_bytes": 0, "instances": 0},
}


def test_attribute_matches_reference_on_synthetic_events(tmp_path,
                                                         monkeypatch):
    """The reference's ``device_op_events`` patched to give a tagged 3 ms
    instruction and an untagged 1 ms one; the port reads a trace where a
    3 ms kernel launches inside the ``pt.mul.0_0`` range and a 1 ms
    memcpy outside any: equal tables but for ``source``."""
    monkeypatch.setattr(j_opprof, "device_op_events", lambda d, known=None: (
        [("multiply.1", 3.0), ("copy.7", 1.0)], "tpu"))
    want = j_opprof.attribute(str(tmp_path), sidecar=_SIDECAR,
                              peak_flops=100e9, peak_membw=10e9)
    trace = _write_trace(tmp_path / "w.pt.trace.json", [
        _ev("user_annotation", "pt.mul.0_0", 100, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
        _ev("kernel", "sgemm_128x64", 200, 3000, tid=7, corr=1, pid=0),
        _ev("cuda_runtime", "cudaMemcpyAsync", 300, 5, corr=2),
        _ev("gpu_memcpy", "Memcpy HtoD", 3500, 1000, tid=7, corr=2,
            pid=0),
    ])
    got = opprof.attribute(trace, sidecar=_SIDECAR, peak_flops=100e9,
                           peak_membw=10e9)
    assert want["source"] == "tpu" and got["source"] == "cuda-eager"
    for key in want:
        if key != "source":
            assert got[key] == want[key], key
    assert got["ops"]["pt.mul.0_0"]["verdict"] == "compute-bound"
    assert got["unattributed_ms"] == pytest.approx(1.0)
    assert opprof.gate_issues(got) == j_opprof.gate_issues(want) == []


def _captured_trace(path, replays, eager=("k1", "k2", "k3")):
    """A captured entry's tagged eager run (kernels k1 in pt.a.0_0, k2 in
    pt.b.0_1, k3 in neither: an unaliasing clone) and its replays, each a
    list of kernel names launched by one graph launch."""
    tags = {"k1": "pt.a.0_0", "k2": "pt.b.0_1"}
    evs = [_ev("user_annotation", "opprof.eager#5", 0, 100)]
    t, corr = 1, 1
    for name in eager:
        if name in tags:
            evs.append(_ev("user_annotation", tags[name], t, 10))
        evs.append(_ev("cuda_runtime", "cudaLaunchKernel", t + 1, 1,
                       corr=corr))
        evs.append(_ev("kernel", name, 1000 + t, 100, tid=7, corr=corr,
                       pid=0))
        t += 20
        corr += 1
    start = 5000
    for kernels in replays:
        evs.append(_ev("user_annotation", "opprof.replay#5", start, 10))
        evs.append(_ev("cuda_runtime", "cudaGraphLaunch", start + 1, 5,
                       corr=corr))
        for j, name in enumerate(kernels):
            evs.append(_ev("kernel", name, start + 100 + 200 * j, 100,
                           tid=7, corr=corr, pid=0))
        start += 5000
        corr += 1
    return _write_trace(path, evs)


def test_replays_join_the_eager_run_by_kernel_order(tmp_path):
    whole = opprof.attribute(_captured_trace(
        tmp_path / "a.pt.trace.json", [("k1", "k2", "k3")] * 2),
        sidecar={"costs": {}})
    assert whole["source"] == "cuda"
    assert whole["join"]["joined"] == 2 and not whole["join"]["mismatches"]
    assert whole["ops"]["pt.a.0_0"]["events"] == 3
    assert whole["ops"]["pt.b.0_1"]["ms"] == pytest.approx(0.3)
    assert whole["unattributed_ms"] == pytest.approx(0.3)  # k3, 3 runs
    assert opprof.window_issues(whole) == []

    # the profiler dropped k1 from a replay: joined in order, flagged
    part = opprof.attribute(_captured_trace(
        tmp_path / "b.pt.trace.json", [("k1", "k2", "k3"), ("k2", "k3")]),
        sidecar={"costs": {}})
    assert part["source"] == "cuda"
    assert part["join"]["partial_replays"] == 1
    assert part["ops"]["pt.a.0_0"]["events"] == 2
    assert part["ops"]["pt.b.0_1"]["events"] == 3
    assert "dropped" in opprof.window_issues(part)[0]

    # another kernel at capture: the replay is left out, the eager run
    # stands alone
    odd = opprof.attribute(_captured_trace(
        tmp_path / "c.pt.trace.json", [("k1", "k9", "k3")]),
        sidecar={"costs": {}})
    assert odd["source"] == "cuda-eager"
    (miss,) = odd["join"]["mismatches"]
    assert miss["first_difference"] == 1 and miss["replay"] == "k9"
    assert odd["join"]["excluded_ms"] == pytest.approx(0.3)
    assert odd["total_ms"] == pytest.approx(0.3)
    assert opprof.window_issues(odd)

    empty = opprof.attribute(_write_trace(tmp_path / "d.pt.trace.json", [
        _ev("user_annotation", "pt.a.0_0", 0, 10)]), sidecar={"costs": {}})
    assert opprof.window_issues(empty) == [
        "the window recorded no device activity"]


def test_kernel_launched_on_another_thread_counts_for_its_range(tmp_path):
    """A vjp's backward launches from autograd's thread while the op's
    thread waits inside the op's range."""
    table = opprof.attribute(_write_trace(tmp_path / "v.pt.trace.json", [
        _ev("user_annotation", "pt.mul_grad.0_4", 0, 100, tid=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, tid=2, corr=1),
        _ev("kernel", "gemm", 60, 30, tid=7, corr=1, pid=0),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 1, tid=2, corr=2),
        _ev("kernel", "gemm", 160, 30, tid=7, corr=2, pid=0),
    ]), sidecar={"costs": {}})
    assert table["ops"]["pt.mul_grad.0_4"]["events"] == 1
    assert table["attributed_frac"] == pytest.approx(0.5)


def test_comm_lane_counts_a_runs_collectives(tmp_path):
    """NCCL kernels form the comm lane; a run issuing another count of
    collectives than the registration recorded fails the gate."""
    evs = [_ev("user_annotation", "opprof.eager#2", 0, 1000)]
    for i in range(3):
        evs += [_ev("cuda_runtime", "cudaLaunchKernel", 10 + i, 1,
                    corr=i + 1),
                _ev("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
                    100 + 50 * i, 20, tid=7, corr=i + 1, pid=0)]
    path = _write_trace(tmp_path / "n.pt.trace.json", evs)
    table = opprof.attribute(path, sidecar={
        "costs": {}, "collectives": {"instances": 3}})
    assert table["comm_ms"] == pytest.approx(0.06)
    assert table["attributed_frac"] == pytest.approx(1.0)
    assert table["collective_instances"] == 3
    bad = opprof.attribute(path, sidecar={
        "costs": {}, "collectives": {"instances": 2}})
    assert any("collective" in s for s in opprof.gate_issues(bad))


# -- fused-op source lists ---------------------------------------------------

def test_fused_op_source_lists_at_opt2_match_reference():
    srcs = {}
    for pkg, optimize in (("jax", j_optimize), ("torch", optimize_program)):
        fluid, guard = ((jfluid, j_unique_name.guard) if pkg == "jax"
                        else (tfluid, t_unique_name.guard))
        main, startup = fluid.Program(), fluid.Program()
        with guard(), fluid.program_guard(main, startup):
            loss = _mlp(fluid, optimizer=None)
        desc, _ = optimize(main, level=2, feed_names=["img", "label"],
                           fetch_names=[loss.name])
        srcs[pkg] = [(op.type, list(op.attrs["__src_ops__"]))
                     for op in desc.block(0).ops
                     if "__src_ops__" in op.attrs]
    assert srcs["torch"] == srcs["jax"]
    assert ("fused_elemwise_activation", ["elementwise_add", "relu"]) \
        in srcs["torch"]


# -- bit-exactness ------------------------------------------------------------

@pytest.mark.parametrize("opt_level", [0, 2])
def test_instrumentation_is_bit_exact(opt_level, tmp_path, clean_registry):
    """The ranges are host-side only: losses with ``opprof`` off, on, and
    on with a profiler session active are bit-identical, and toggling
    the flag keeps the engine's cache entry."""
    main, startup, loss = _build("torch")
    t_flags.set_flags({"opt_level": opt_level,
                       "trace_dir": str(tmp_path / "trace")})
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        tfluid.Executor(tfluid.CPUPlace()).run(startup)
    state = {n: np.array(scope.get(n)) for n in scope.local_var_names()}
    try:
        runs = []
        for mode in ("off", "on", "profiled"):
            t_flags.set_flags({"opprof": mode != "off"})
            exe = tfluid.Executor(tfluid.CPUPlace())
            scope = tfluid.Scope()
            for n, v in state.items():
                scope.set(n, torch.from_numpy(v.copy()))
            with tfluid.scope_guard(scope):
                if mode == "profiled":
                    tfluid.profiler.start_profiler()
                losses = [exe.run(main, feed=_feed(seed=s),
                                  fetch_list=[loss.name])[0]
                          for s in range(3)]
                if mode == "profiled":
                    table = tfluid.profiler.stop_profiler(
                        profile_path=str(tmp_path / "p"))
                    assert table["ops"]
                entries = len(exe.engine._cache)
                t_flags.set_flags({"opprof": mode == "off"})
                exe.run(main, feed=_feed(seed=9), fetch_list=[loss.name])
                assert len(exe.engine._cache) == entries
            runs.append(np.asarray(losses))
        assert np.array_equal(runs[0], runs[1])
        assert np.array_equal(runs[0], runs[2])
    finally:
        for name in ("opt_level", "opprof", "trace_dir"):
            t_flags.reset_flag(name)


# -- end-to-end attribution on a profiled run ---------------------------------

def _reference_costs(optimizer, run_kw):
    """The JAX package's registered costs for the MLP's step."""
    main, startup, loss = _build("jax", optimizer)
    j_flags.set_flags({"metrics": True, "opprof": True})
    try:
        exe = jfluid.Executor(jfluid.CPUPlace())
        with jfluid.scope_guard(jfluid.Scope()):
            exe.run(startup)
            j_opprof.reset()
            exe.run(main, feed=_feed(), fetch_list=[loss.name], **run_kw)
        return j_opprof.registry_snapshot()["costs"]
    finally:
        j_flags.reset_flag("metrics")
        j_flags.reset_flag("opprof")


def _profiled_steps(tmp_path, optimizer, run_kw):
    """The MLP's warm-up step, then three under a profiler session:
    (op table, registry snapshot, trace directory)."""
    trace_dir = str(tmp_path / "trace")
    t_flags.set_flags({"opprof": True, "trace_dir": trace_dir})
    try:
        main, startup, loss = _build("torch", optimizer)
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(tfluid.Scope()):
            exe.run(startup)
            exe.run(main, feed=_feed(), fetch_list=[loss.name], **run_kw)
            tfluid.profiler.start_profiler()
            for step in range(3):
                exe.run(main, feed=_feed(seed=step),
                        fetch_list=[loss.name], **run_kw)
            table = tfluid.profiler.stop_profiler(
                profile_path=str(tmp_path / "profile"))
    finally:
        t_flags.reset_flag("opprof")
        t_flags.reset_flag("trace_dir")
    return table, opprof.registry_snapshot(), trace_dir


def _every_live_op_ran(table, snap):
    (label,) = snap["instr_tags"]
    for tag in snap["instr_tags"][label]:
        assert tag in table["ops"], tag
        assert table["ops"][tag]["events"] > 0, tag


def test_profiled_mlp_attribution(tmp_path, clean_registry):
    """Train the MLP under ``start_profiler``/``stop_profiler``: at least
    95 % of the window's aten time attributed, every live op in the
    table, the ``opprof.*`` gauges, the sidecar and the written table;
    the tags and their FLOPs and bytes are the reference's."""
    table, snap, trace_dir = _profiled_steps(tmp_path, "sgd", {})
    assert opprof.load_sidecar(trace_dir)["costs"] == snap["costs"]
    assert table["source"] == "cpu"
    assert table["attributed_frac"] >= ATTRIBUTED_MIN, (
        table["attributed_frac"], table["unattributed_ms"])
    _every_live_op_ran(table, snap)
    assert table["comm_ms"] == 0.0
    assert opprof.gate_issues(table) == []
    gauges = t_obs.snapshot()["gauges"]
    assert gauges["opprof.attributed_frac"] == pytest.approx(
        table["attributed_frac"])
    assert any(k.startswith("opprof.pt.") for k in gauges)
    assert "Device time by framework op" in (
        tmp_path / "profile").read_text()
    assert snap["costs"] == _reference_costs("sgd", {})


def test_accumulated_lowering_tags_match_reference(tmp_path, clean_registry):
    """Under ``accumulate_steps`` the once ops (Adam's updates) take the
    reference's tags from 100_000, with its FLOPs and bytes; every op of
    the loop and of the update ran under its tag."""
    table, snap, _ = _profiled_steps(tmp_path, "adam",
                                     {"accumulate_steps": 2})
    _every_live_op_ran(table, snap)
    want = _reference_costs("adam", {"accumulate_steps": 2})
    assert snap["costs"] == want
    assert any(int(t.rsplit("_", 1)[1]) >= 100_000 for t in want)


def test_registered_costs_are_computed_once_an_entry(clean_registry):
    """Registration runs at an entry's first observed run only."""
    main, startup, loss = _build("torch")
    t_flags.set_flags({"metrics": True})
    try:
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(tfluid.Scope()):
            exe.run(startup)
            for s in range(2):
                exe.run(main, feed=_feed(seed=s), fetch_list=[loss.name])
        assert t_obs.counter_value("opprof.executables") == 2
        assert t_obs.counter_value("opprof.register_crashes") == 0
        kinds = opprof.registry_snapshot()["instr_kinds"]
        assert sorted(kinds.values()) == ["eager", "eager"]
    finally:
        t_flags.reset_flag("metrics")
