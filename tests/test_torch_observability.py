"""The port's observability copies (paddle_tpu_torch/flags.py and
paddle_tpu_torch/observability/) against the JAX package's modules: the
same input sequences through both give equal results for

- ``Histogram`` (count, total, extrema and nearest-rank percentiles over
  the bounded tail),
- ``SloMonitor`` (burn rates, the alert condition and ``snapshot`` at
  fixed ``now``),
- ``reqtrace.head_sampled`` and the tail-sampling verdicts of
  ``ReqTracer.finish`` (fixed threshold, errors, head samples and the
  adaptive 2x-EWMA-p99 rule),
- ``snapshot_text`` (Prometheus text, exemplar comments included),
- ``GoodputTracker`` (charges, clipping, idle fill, fencing, and the MFU
  attribution: FLOPs noted, steps counted),
- flag parsing from the environment (``PADDLE_TPU_*`` for the JAX
  package, ``PADDLE_GPU_*`` for the port) and the shared defaults.

Then the port's own pieces on their own: the metrics gate and its flag
hook, the JSONL sink's rotation read back through ``SinkTail``, the
flight recorder, the chrome-trace export (with the device-lane merge:
a directory without a ``torch.profiler`` trace raises the reference's
``FileNotFoundError``), and the heartbeat payload.
"""

import json
import os

import numpy as np
import pytest

from paddle_tpu import flags as j_flags
from paddle_tpu.observability import goodput as j_goodput
from paddle_tpu.observability import health as j_health
from paddle_tpu.observability import metrics as j_metrics
from paddle_tpu.observability import reqtrace as j_reqtrace

from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import export, goodput, health
from paddle_tpu_torch.observability import metrics, reqtrace


@pytest.fixture(autouse=True)
def _reset_port_observability():
    obs.reset()
    obs.set_enabled(None)
    yield
    obs.reset()
    obs.set_enabled(None)


# -- the same sequences through both packages ------------------------------
def _sequences():
    rng = np.random.RandomState(5)
    return {
        "normal_100": rng.randn(100) * 3.0 + 10.0,
        "exponential_700": rng.exponential(20.0, 700),  # past the 512 tail
        "ties": np.repeat([1.0, 2.0, 2.0, 5.0], 9),
        "single": np.array([42.0]),
    }


@pytest.mark.parametrize("name", sorted(_sequences()))
def test_histogram_matches_jax(name):
    seq = _sequences()[name]
    a, b = j_metrics.Histogram(), metrics.Histogram()
    for i, v in enumerate(seq):
        ex = "t%d" % i if i % 7 == 0 else None
        a.record(float(v), ex)
        b.record(float(v), ex)
    assert b.describe() == a.describe()
    assert b.exemplar == a.exemplar
    for q in (-5, 0, 1, 25, 50, 90, 99, 99.9, 100, 150):
        assert b.percentile(q) == a.percentile(q), q
    assert metrics.Histogram().percentile(50) is None
    assert metrics.Histogram().describe() == j_metrics.Histogram().describe()


def _slo_trace():
    """(latency_ms, now) samples over 900 s: mostly fast, a burst of slow
    requests in the middle, then a recovery."""
    rng = np.random.RandomState(9)
    out = []
    for i in range(600):
        t = 1000.0 + 1.5 * i
        slow = 300 <= i < 380 or rng.rand() < 0.01
        out.append((float(rng.uniform(150, 400) if slow
                          else rng.uniform(5, 40)), t))
    return out


def test_slo_monitor_matches_jax():
    kw = dict(target=0.99, fast_window_s=60.0, slow_window_s=300.0,
              fast_burn=10.0, slow_burn=3.0, name="parity")
    a, b = j_health.SloMonitor(100.0, **kw), health.SloMonitor(100.0, **kw)

    def compare(t):
        for w in (a.fast_window_s, a.slow_window_s, 10.0):
            assert b.burn_rate(w, now=t) == a.burn_rate(w, now=t), (t, w)
        assert b.burning(now=t) == a.burning(now=t)
        assert b.snapshot(now=t) == a.snapshot(now=t)
        return a.burning(now=t)

    burning = []
    for i, (ms, t) in enumerate(_slo_trace()):
        tid = "tr%d" % i if i % 3 == 0 else None
        a.record(ms, now=t, trace_id=tid)
        b.record(ms, now=t, trace_id=tid)
        if i % 10 == 0:
            burning.append(compare(t))
    for later in (30.0, 200.0, 400.0):   # no new requests: burn ages out
        burning.append(compare(t + later))
    assert any(burning) and not all(burning)  # the trace crosses both ways


def test_head_sampling_matches_jax():
    ids = [os.urandom(8).hex() for _ in range(2000)] + [
        "", "zz", None, "ffffffffffffffff", "0000000000000000"]
    for rate in (0.0, 0.01, 0.25, 0.5, 0.999, 1.0, 2.0, -1.0):
        got = [reqtrace.head_sampled(i, rate) for i in ids]
        want = [j_reqtrace.head_sampled(i, rate) for i in ids]
        assert got == want, rate
    assert 0 < sum(reqtrace.head_sampled(i, 0.25) for i in ids[:2000]) < 1000


def test_tail_verdicts_match_jax(monkeypatch):
    """The same completions (latency, error, head-sample flag) through
    both tracers under the same slow threshold: the same keep verdicts
    and reasons, and the same stats, past the point where the adaptive
    p99 rule arms (100 completions, refreshed every 64)."""
    monkeypatch.setenv(j_flags.env_name("trace_slow_ms"), "500")
    monkeypatch.setenv(flags.env_name("trace_slow_ms"), "500")
    rng = np.random.RandomState(13)
    a, b = j_reqtrace.ReqTracer(), reqtrace.ReqTracer()
    reasons = []
    for i in range(400):
        tid = "%016x" % (i * 2654435761 % 2 ** 64)
        fl = j_reqtrace.FLAG_SAMPLED if i % 17 == 0 else 0
        ms = float(rng.lognormal(2.5, 0.6))
        if i in (300, 333, 366):
            ms = 300.0     # past 2x the p99 EWMA, under the threshold
        elif i == 390:
            ms = 1000.0    # past the fixed threshold
        err = i % 53 == 0
        ca, cb = a.begin(tid, flags_=fl), b.begin(tid, flags_=fl)
        a.add_span(ca, "queue", 0.0, 1.0)
        b.add_span(cb, "queue", 0.0, 1.0)
        ra, rb = a.finish(ca, ms, error=err), b.finish(cb, ms, error=err)
        assert rb == ra, (i, ms, err, fl)
        reasons.append(ra[1])
    assert b.stats() == a.stats()
    assert b.p99_ewma() == a.p99_ewma() is not None
    # every rule fired somewhere in the sequence
    assert {"error", "slow", "slow_p99", "sampled", None} <= set(reasons)


def _fill(reg):
    reg.inc("serving.requests", 5)
    reg.inc("serving.batches")
    reg.set_gauge("serving.queue_depth", 3)
    reg.set_gauge("goodput.serving_request_frac", 0.625, exemplar="abc")
    reg.set_gauge("flag", True)
    reg.set_gauge("text", "not-a-number")
    for v, ex in ((1.5, None), (9.25, "t9"), (4.0, "t4"), (0.5, None)):
        reg.observe("serving.request_ms", v, exemplar=ex)
    reg.observe("serving.batch-fill", 0.75)


@pytest.mark.parametrize("prefix", ["paddle_tpu", "paddle_gpu", ""])
def test_snapshot_text_matches_jax(prefix):
    a, b = j_metrics.MetricsRegistry(), metrics.MetricsRegistry()
    _fill(a)
    _fill(b)
    assert b.snapshot() == a.snapshot()
    want = j_metrics.snapshot_text(a.snapshot(), prefix=prefix)
    assert metrics.snapshot_text(b.snapshot(), prefix=prefix) == want
    assert b.snapshot_text(prefix=prefix) == a.snapshot_text(prefix=prefix)
    assert '# EXEMPLAR' in want and 'quantile="0.99"' in want
    assert metrics.snapshot_text({}) == j_metrics.snapshot_text({}) == ""


def test_goodput_tracker_matches_jax():
    a, b = j_goodput.GoodputTracker(attempt=0), goodput.GoodputTracker(0)
    charges = [("compute", 10.0, 10.5), ("compile", 10.5, 11.0),
               ("compute", 10.8, 11.4),       # clipped against the cursor
               ("input_wait", 12.0, 12.25),   # gap filled as idle
               ("compute", 11.0, 11.2),       # fully behind: rejected
               ("host_sync", 12.25, 12.5, 3),  # another incarnation: fenced
               ("idle", 12.5, 12.5)]          # empty: rejected
    for c in charges:
        assert b.charge(*c) == a.charge(*c), c
    for t in (13.0, 13.75, 14.0):
        assert b.mark("compute", now=t) == a.mark("compute", now=t)
    for flops in (2.5e9, 0.0, 1.5e9):
        a.note_flops(flops)
        b.note_flops(flops)
        a.note_step()
        b.note_step()
    # the MFU attribution too (no peak set: the ratios are None)
    assert b.snapshot() == a.snapshot()
    assert b.snapshot()["mfu"]["model_flops_per_step"] == pytest.approx(
        4e9 / 3)
    assert b.top_badput() == a.top_badput()
    snap = b.snapshot()
    assert sum(snap["categories"].values()) == pytest.approx(snap["wall_ms"])


def _env_raw(typ):
    return {bool: ["1", "0", "false", "yes", ""], int: ["7", "-3"],
            float: ["2.5", "0"], str: ["4,8,16", ""]}[typ]


def test_flags_parse_env_like_jax(monkeypatch):
    shared = sorted(set(flags.DEFS) & set(j_flags.DEFS))
    assert shared == sorted(flags.DEFS)  # every port flag is a JAX flag
    for name in shared:
        typ, default, _ = flags.DEFS[name]
        assert (typ, default) == j_flags.DEFS[name][:2], name
        assert flags.get_flag(name) == j_flags.get_flag(name), name
        for raw in _env_raw(typ):
            monkeypatch.setenv(j_flags.env_name(name), raw)
            monkeypatch.setenv(flags.env_name(name), raw)
            assert flags.get_flag(name) == j_flags.get_flag(name), (name, raw)
            assert flags.describe()[name][:2] == j_flags.describe()[name][:2]
    assert flags.env_name("queue_limit") == "PADDLE_GPU_QUEUE_LIMIT"


def test_set_flags_precedence_and_reset(monkeypatch):
    monkeypatch.setenv("PADDLE_GPU_QUEUE_LIMIT", "4")
    assert flags.get_flag("queue_limit") == 4
    seen = []
    flags.on_change("queue_limit", seen.append)
    try:
        flags.set_flags({"queue_limit": "9"})
        assert flags.get_flag("queue_limit") == 9
        assert flags.describe()["queue_limit"][1] == "set_flags"
        flags.reset_flag("queue_limit")
        assert flags.get_flag("queue_limit") == 4  # the env value is back
        assert os.environ["PADDLE_GPU_QUEUE_LIMIT"] == "4"
    finally:
        flags._change_hooks["queue_limit"].remove(seen.append)
    assert seen == [9, 4]
    with pytest.raises(KeyError):
        flags.set_flags({"no_such_flag": 1})


# -- the port's own pieces --------------------------------------------------
def test_metrics_gate_follows_flag():
    obs.inc("x")
    assert obs.counter_value("x") == 0  # off by default: a no-op
    try:
        flags.set_flags({"metrics": True})
        assert obs.enabled()
        obs.inc("x", 2)
        obs.observe("h", 3.0)
        with obs.time_block("blk"):
            pass
        with obs.span("outer", k=1):
            obs.event("marker", v=2)
        snap = obs.snapshot()
        assert snap["counters"]["x"] == 2
        assert snap["histograms"]["blk"]["count"] == 1
        assert snap["spans"]["outer"]["calls"] == 1
        assert [s.name for s in obs.spans()] == ["marker", "outer"]
    finally:
        flags.reset_flag("metrics")
    assert not obs.enabled()


def test_jsonl_sink_rotation_read_back(tmp_path):
    path = str(tmp_path / "m.jsonl")
    tail = export.SinkTail(path)
    sink = export.JsonlSink(path, rotate_bytes=600, keep=0, host=3,
                            snapshot_fn=obs.registry.snapshot)
    tracer = obs.SpanTracer(flight_depth=5)
    tracer.attach_sink(sink)
    seen = []
    for i in range(40):
        with tracer.span("step", i=i):
            pass
        sink.flush()
        seen += tail.poll()
    sink.close()
    seen += tail.poll()
    spans = [e for e in seen if e.get("t") == "span"]
    assert [e["args"]["i"] for e in spans] == list(range(40))
    assert all(e["host"] == 3 for e in seen)
    assert len(sink.files()) > 2  # rotated at least twice
    assert tracer.dropped() == 0
    assert [s.args["i"] for s in tracer.spans()] == list(range(35, 40))


def test_chrome_trace_and_unported_xplane(tmp_path):
    tracer = obs.SpanTracer()
    with tracer.span("dispatch", bucket=8):
        tracer.event("inner")
    path = tracer.dump_chrome_trace(str(tmp_path / "t.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert [e["ph"] for e in events if e["name"] in ("dispatch", "inner")] \
        == ["i", "X"]
    # the merge is ported (tests/test_torch_profiler_memory.py merges a
    # trace); a directory holding none raises, as the reference's does
    with pytest.raises(FileNotFoundError, match="pt.trace.json"):
        obs.dump_chrome_trace(str(tmp_path / "u.json"),
                              xplane_dir=str(tmp_path))


def test_heartbeat_payload():
    health.reset_steps()
    health.note_step()
    health.note_step()
    obs.registry.set_gauge("serving.queue_depth", 4)
    obs.memory.reset_peaks()
    beat = health.HeartbeatEmitter(interval_ms=1000.0).emit_now()
    assert beat["step"] == 2 and beat["queue_depth"] == 4
    assert beat["phase"] == "idle" and beat["rss_bytes"] > 0
    # no device-memory watermark recorded: the field stays out, as the
    # reference leaves it out at 0 (test_torch_profiler_memory.py has it)
    assert "hbm_peak_bytes" not in beat
    # liveness bypasses the metrics gate
    assert [s.name for s in obs.tracer.spans()] == [health.HEARTBEAT_EVENT]
    assert health.ensure_heartbeat(0) is None
    health.reset_steps()
