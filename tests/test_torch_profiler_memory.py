"""The port's profiler façade (``paddle_tpu_torch/profiler.py``,
``fluid.profiler``), device-memory accounting
(``paddle_tpu_torch/observability/memory.py``), the heartbeat's memory
field and the device-lane merge of ``chrome_trace``, on the CPU, held to
the JAX package's own tests of them (``tests/test_observability.py``:
the profiler cases at :300, :324, :331, :342 and :779, the memory cases
at :526 and :548):

- ``stop_profiler`` honours ``sorted_key`` and writes the summary table,
  the host spans' chrome trace and the Prometheus text (with the goodput
  block while the ledger is live); a bad key raises the reference's
  ``ValueError``; ``reset_profiler`` clears; the session forces the host
  collectors on and restores the flag's gate; both packages' summary
  tables print the same text for the same spans;
- an engine step with metrics on records the first-run memory (the
  argument bytes exact: the feeds and the state the block reads; on the
  CPU the peak is the static liveness estimate of the block) and the
  live bytes split resident/transient; the memory-pressure event fires
  once an excursion;
- a heartbeat carries ``hbm_peak_bytes`` once the watermark is nonzero;
- ``chrome_trace(xplane_dir=)`` merges a synthetic ``torch.profiler``
  trace's device events as processes after the host's, on the host
  spans' epoch clock.
"""

import json

import numpy as np
import pytest
import torch

from paddle_tpu import observability as j_obs
from paddle_tpu import profiler as j_profiler
from paddle_tpu.observability.tracing import SpanRecord as JSpanRecord

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import flags, profiler
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.analysis.memory import analyze_liveness
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.observability import health, memory
from paddle_tpu_torch.observability.tracing import SpanRecord
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean():
    obs.reset()
    obs.set_enabled(None)
    yield
    obs.reset()
    obs.set_enabled(None)


@pytest.fixture
def metrics_on():
    flags.set_flags({"metrics": True})
    try:
        yield
    finally:
        flags.reset_flag("metrics")


@pytest.fixture
def traced(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_GPU_TRACE_DIR", str(tmp_path / "trace"))
    return str(tmp_path / "profile.txt")


# -- profiler façade --------------------------------------------------------

def test_stop_profiler_writes_sorted_summary(traced):
    with fluid.profiler.profiler(sorted_key="total", profile_path=traced):
        assert obs.enabled()  # the session forces the host collectors on
        with profiler.record_event("outer-span"):
            with profiler.record_event("inner-span"):
                np.ones(4).sum()
    text = open(traced).read()
    assert "Event" in text and "Total(ms)" in text
    assert "outer-span" in text and "inner-span" in text
    assert text.index("outer-span") < text.index("inner-span")
    trace = json.load(open(traced + ".trace.json"))
    assert {e["name"] for e in trace["traceEvents"]
            if e.get("ph") == "X"} >= {"outer-span", "inner-span"}
    assert not obs.enabled()  # gate restored to the flag
    # the session's own trace holds the record_event ranges
    dev = json.load(open(profiler.last_session()["trace"]))
    assert {"outer-span", "inner-span"} <= {
        e["name"] for e in dev["traceEvents"]
        if e.get("cat") == "user_annotation"}


def test_stop_profiler_rejects_bad_sort_key():
    with pytest.raises(ValueError, match="sorted_key"):
        profiler.summary_table("bogus")
    with pytest.raises(ValueError, match="sorted_key"):
        j_profiler.summary_table("bogus")


def test_reset_profiler_clears_state(metrics_on):
    obs.inc("c")
    with obs.span("s"):
        pass
    profiler.reset_profiler()
    snap = obs.snapshot()
    assert snap["counters"] == {} and snap["spans"] == {}


def test_stop_profiler_writes_prom_metrics(traced):
    with profiler.profiler(profile_path=traced):
        obs.inc("engine.cache_hit", 2)
        with profiler.record_event("work"):
            np.ones(4).sum()
    text = open(traced + ".metrics.prom").read()
    assert "# TYPE paddle_gpu_engine_cache_hit counter" in text
    assert "paddle_gpu_engine_cache_hit 2" in text


def test_stop_profiler_appends_goodput_block(traced):
    from paddle_tpu_torch.observability import goodput

    flags.set_flags({"goodput": True})
    try:
        goodput.tracker.mark("compute", now=1.0)
        goodput.tracker.mark("compute", now=1.2)
        goodput.tracker.mark("restart_downtime", now=1.3)
        with profiler.profiler(profile_path=traced):
            np.ones(4).sum()
        text = open(traced + ".metrics.prom").read()
    finally:
        flags.reset_flag("goodput")
        goodput.reset()
    assert "# goodput ledger:" in text
    assert "restart_downtime" in text
    assert "paddle_gpu_goodput_frac" in text


@pytest.mark.parametrize("key", [None, "calls", "total", "max", "min",
                                 "ave"])
def test_summary_table_matches_reference(key):
    spans = [("step", 0.0, 5000.0), ("run", 10.0, 3000.0),
             ("run", 4000.0, 500.0), ("trace", 20.0, 250.0)]
    for name, ts, dur in spans:
        obs.tracer._add(SpanRecord(name, ts, dur, 1, 0, None))
        j_obs.tracer._add(JSpanRecord(name, ts, dur, 1, 0, None))
    try:
        assert profiler.summary_table(key) == j_profiler.summary_table(key)
    finally:
        j_obs.reset()


# -- device-memory accounting -------------------------------------------------

def _bert_step():
    main, startup, h = bert.get_model(
        batch_size=2, seq_len=16, vocab_size=100, d_model=32, n_layers=1,
        n_heads=2, d_inner=64, dropout=0.0, lr=1e-3, max_position=64)
    return main, startup, h, bert.make_fake_batch(2, 16, 100, 2)


def test_memory_accounting_on_engine_step(metrics_on):
    """A cache-miss engine step records the first-run memory and the
    live bytes split scope-resident vs transient; the argument bytes are
    exactly the feeds' and the read state's, and the CPU's peak is the
    static liveness estimate of the block."""
    main, startup, h, batch = _bert_step()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        obs.reset()
        exe.run(main, feed=batch, fetch_list=[h["loss"]])
        snap = obs.snapshot()
    g = snap["gauges"]
    (compiled,) = [c for c in exe.engine._cache.values()
                   if c.block_program.feed_names]
    bp = compiled.block_program
    feeds = sum(np.asarray(batch[n]).astype(
        np.int64 if np.asarray(batch[n]).dtype.kind == "i"
        else np.asarray(batch[n]).dtype).nbytes for n in bp.feed_names)
    state = sum(scope.get(n).numel() * scope.get(n).element_size()
                for n in bp.state_in_names)
    assert g["hbm.compile_arg_bytes"] == feeds + state
    assert g["hbm.compile_out_bytes"] > 0
    want = analyze_liveness(compiled.run_desc, feed_shapes={
        n: tuple(np.shape(batch[n])) for n in bp.feed_names}).peak_bytes
    assert g["hbm.compile_peak_bytes"] == want
    assert g["hbm.live_bytes"] > 0
    assert g["hbm.resident_bytes"] > 0  # parameters pinned by the scope
    assert g["hbm.live_bytes"] >= g["hbm.resident_bytes"]
    assert g["hbm.live_bytes_peak"] >= g["hbm.live_bytes"]
    assert snap["histograms"]["hbm.compile_peak_bytes_per_exe"]["count"] \
        == 1
    assert memory.peak_hbm_bytes() > 0
    # a second run is no first run
    with fluid.scope_guard(scope):
        exe.run(main, feed=batch, fetch_list=[h["loss"]])
    assert obs.snapshot()["histograms"][
        "hbm.compile_peak_bytes_per_exe"]["count"] == 1


def test_memory_pressure_event_edge_triggered(metrics_on):
    """Crossing PADDLE_GPU_MEMORY_PRESSURE_FRAC of the (overridden)
    device capacity raises one memory_pressure event per excursion, not
    one per step."""
    scope = fluid.Scope()
    scope.set("keep_alive", torch.ones(64))
    flags.set_flags({"device_memory_bytes": 1,
                     "memory_pressure_frac": 0.5})
    try:
        memory.reset_peaks()
        out = memory.record_step_memory(scope, step=1)
        assert out is not None and out["live_bytes"] == 256
        assert out["resident_bytes"] == 256
        assert obs.counter_value("memory.pressure_events") == 1
        memory.record_step_memory(scope, step=2)   # still over: no re-fire
        assert obs.counter_value("memory.pressure_events") == 1
        trips = [s for s in obs.spans() if s.name == "memory_pressure"]
        assert len(trips) == 1
        assert trips[0].args["limit_bytes"] == 1
        assert trips[0].args["step"] == 1
        flags.set_flags({"memory_pressure_frac": 1000.0})
        memory.record_step_memory(scope, step=3)   # back under
        flags.set_flags({"memory_pressure_frac": 0.5})
        memory.record_step_memory(scope, step=4)   # a second excursion
        assert obs.counter_value("memory.pressure_events") == 2
    finally:
        flags.reset_flag("device_memory_bytes")
        flags.reset_flag("memory_pressure_frac")


def test_step_tensors_count_once_beside_the_scope():
    """On the CPU the live bytes are the scope's and the step's own
    tensors, each storage once (a view of a state tensor adds nothing)."""
    scope = fluid.Scope()
    w = torch.ones(10)
    scope.set("w", w)
    out = memory.record_step_memory(
        scope, step_tensors=[w[:5], torch.ones(4, dtype=torch.int64)])
    assert out["resident_bytes"] == 40
    assert out["live_bytes"] == 72 and out["transient_bytes"] == 32
    assert memory.device_memory_limit("cpu") is None


def test_record_compile_memory_peaks():
    """The first-run record: measured growth above the arguments on the
    card, the static estimate on the CPU; in-place outputs count once."""
    flags.set_flags({"metrics": True})
    try:
        assert memory.record_compile_memory(
            100, 60, alias_bytes=40, grown_bytes=50) == 150
        g = obs.snapshot()["gauges"]
        assert g["hbm.compile_temp_bytes"] == 30  # 150 - 100 - (60 - 40)
        assert memory.record_compile_memory(
            100, 60, static_peak_bytes=400) == 400
        assert obs.snapshot()["gauges"]["hbm.compile_peak_bytes"] == 400
        assert memory.record_compile_memory(1, 1) is None
    finally:
        flags.reset_flag("metrics")


def test_heartbeat_carries_hbm_peak_bytes():
    memory.reset_peaks()
    beat = health.HeartbeatEmitter(interval_ms=1000.0).emit_now()
    assert "hbm_peak_bytes" not in beat   # no watermark yet
    scope = fluid.Scope()
    scope.set("w", torch.ones(256))
    memory.record_step_memory(scope)
    beat = health.HeartbeatEmitter(interval_ms=1000.0).emit_now()
    assert beat["hbm_peak_bytes"] == memory.peak_hbm_bytes() == 1024


# -- the device-lane merge ---------------------------------------------------

def test_chrome_trace_merges_device_events(tmp_path):
    tracer = obs.SpanTracer()
    with tracer.span("step"):
        pass
    base_ns = 1_700_000_000 * 10 ** 9
    events = [
        {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7,
         "ts": 10.0, "dur": 5.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 8, "ts": 20.0, "dur": 2.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "relu", "pid": 1, "tid": 7,
         "ts": 30.0, "dur": 1.0, "args": {}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 99,
         "tid": 1, "ts": 9.0, "dur": 7.0, "args": {}},
    ]
    trace_dir = tmp_path / "trace"
    trace_dir.mkdir()
    raw = json.dumps({"baseTimeNanoseconds": base_ns,
                      "traceEvents": events})
    (trace_dir / "a.pt.trace.json").write_text(raw)
    (trace_dir / "b.pt.trace.json").write_text(raw)  # a copy: read once
    merged = tracer.chrome_trace(xplane_dir=str(trace_dir))["traceEvents"]
    host = [e for e in merged if e.get("pid") == 1 and e["ph"] == "X"]
    assert [e["name"] for e in host] == ["step"]
    device = [e for e in merged if e.get("pid", 1) > 1 and e["ph"] == "X"]
    assert [(e["name"], e["pid"]) for e in device] == [
        ("gemm", 2), ("Memcpy HtoD", 2), ("relu", 3)]
    assert device[0]["ts"] == pytest.approx(base_ns / 1e3 + 10.0)
    names = {e["args"]["name"] for e in merged if e["ph"] == "M"
             and e["name"] == "thread_name" and e["pid"] == 2}
    assert names == {"stream 7", "stream 8"}
    path = obs.dump_chrome_trace(str(tmp_path / "m.json"),
                                 xplane_dir=str(trace_dir))
    assert len(json.load(open(path))["traceEvents"]) > len(device)
    with pytest.raises(FileNotFoundError):
        tracer.chrome_trace(xplane_dir=str(tmp_path / "none"))


def test_profile_steps_reruns_a_wanting_window(traced, monkeypatch):
    """``profile_steps`` profiles a window again while
    ``opprof.window_issues`` finds it wanting (the card's profiler can
    drop launches), and reports each rejected window's issues."""
    from paddle_tpu_torch.observability import opprof

    seen = []
    real = opprof.window_issues
    monkeypatch.setattr(opprof, "window_issues", lambda t: (
        seen.append(t) or (["dropped"] if len(seen) == 1 else real(t))))
    x = torch.ones(64)
    table, rejected = profiler.profile_steps(lambda: (x * 2).sum(), 2,
                                             attempts=3,
                                             profile_path=traced)
    assert rejected == [["dropped"]] and len(seen) == 2
    assert table["source"] == "cpu" and table["total_ms"] > 0
