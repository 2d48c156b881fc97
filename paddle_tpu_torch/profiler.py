"""Profiler façade (reference: python/paddle/fluid/profiler.py — profiler
ctx mgr:221, start/stop_profiler:125,165, cuda_profiler:39). Port of
``paddle_tpu/profiler.py`` on ``torch.profiler``.

Drives BOTH halves of the telemetry stack together:

* the **device** half: a ``torch.profiler.profile`` session (CPU
  activity, and CUDA's where a card is present), whose chrome-trace JSON
  lands under ``trace_dir`` (the ``trace_dir`` flag, else
  ``$PADDLE_GPU_TRACE_DIR``, else ``paddle_gpu_trace`` under the
  temporary directory); with the ``opprof`` flag up the engine tags each
  op's lowering for the session (``observability/opprof.py``);
* the **host** half: paddle_tpu_torch.observability spans (step ->
  trace -> run) and the metrics registry. ``start_profiler`` forces the
  host collectors on for the session even when ``PADDLE_GPU_METRICS`` is
  down; ``stop_profiler`` restores the flag-controlled gate.

``stop_profiler(sorted_key, profile_path)`` writes the host-span summary
table to ``profile_path`` sorted by ``sorted_key`` (calls / total / max /
min / ave — the reference's EventSortingKey set) followed by the
op-attributed device-time table, dumps the host spans as chrome-trace
JSON next to it (``<profile_path>.trace.json``; merge the device lanes
with ``observability.dump_chrome_trace(path, xplane_dir=trace_dir)``)
and the metrics registry as Prometheus text
(``<profile_path>.metrics.prom``).
"""

import contextlib
import os
import socket
import tempfile

from paddle_tpu_torch import flags, observability

_session = {"dir": None, "prof": None, "n": 0}
_last = {"table": None, "profile": None, "trace": None, "events": None}

_SORT_KEYS = {
    None: None,
    "default": None,
    "calls": "calls",
    "total": "total_ms",
    "max": "max_ms",
    "min": "min_ms",
    "ave": "ave_ms",
}


def trace_dir():
    """Where a session's traces go: the ``trace_dir`` flag, else
    ``$PADDLE_GPU_TRACE_DIR``, else ``paddle_gpu_trace`` under the
    temporary directory."""
    return (flags.get_flag("trace_dir")
            or os.environ.get("PADDLE_GPU_TRACE_DIR")
            or os.path.join(tempfile.gettempdir(), "paddle_gpu_trace"))


def start_profiler(state="All", tracer_option=None):
    """Start the device trace AND the host span/metric collectors
    (``state``/``tracer_option`` kept for reference API parity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    observability.set_enabled(True)
    _session["dir"] = trace_dir()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _session["prof"] = prof
    _session["n"] += 1
    observability.opprof.begin_session()


def summary_table(sorted_key=None):
    """The host-span summary as text (reference:
    platform/profiler.cc PrintProfiler's table): one row per span name
    with calls / total / min / max / ave milliseconds."""
    if sorted_key not in _SORT_KEYS:
        raise ValueError(
            "sorted_key must be one of %s, got %r"
            % (sorted(k for k in _SORT_KEYS if k), sorted_key))
    agg = observability.tracer.summary()
    rows = list(agg.items())
    field = _SORT_KEYS[sorted_key]
    if field is not None:
        rows.sort(key=lambda kv: kv[1][field], reverse=field != "min_ms")
    lines = ["%-32s %8s %12s %12s %12s %12s"
             % ("Event", "Calls", "Total(ms)", "Min(ms)", "Max(ms)",
                "Ave(ms)")]
    for name, r in rows:
        lines.append("%-32s %8d %12.3f %12.3f %12.3f %12.3f"
                     % (name[:32], r["calls"], r["total_ms"], r["min_ms"],
                        r["max_ms"], r["ave_ms"]))
    if not rows:
        lines.append("(no host spans recorded)")
    return "\n".join(lines)


def op_summary_text(table, top_k=15):
    """The op-attributed device-time table as text: one row per
    provenance tag (framework op), hottest first, with its launches, the
    roofline verdict and the source-op list fused ops expand back to."""
    from paddle_tpu_torch.observability import opprof

    lines = [
        "Device time by framework op (source: %s, fusion policy: %s)"
        % (table["source"], table["fusion_policy"]),
        "%-36s %10s %6s %8s %10s %-13s %s"
        % ("op", "ms", "%", "launches", "FLOP/B", "verdict", "src_ops")]
    for tag, row in opprof.top_rows(table, top_k):
        if row["ms"] <= 0:
            continue
        lines.append(
            "%-36s %10.3f %5.1f%% %8d %10.2f %-13s %s"
            % (tag[:36], row["ms"], 100.0 * row["frac"], row["events"],
               row["intensity"], row["verdict"],
               ",".join(row["src_ops"])[:40]))
    lines.append(
        "attributed %.1f%% of %.3f ms device time "
        "(unattributed %.3f ms, comm lane %.3f ms)"
        % (100.0 * table["attributed_frac"], table["total_ms"],
           table["unattributed_ms"], table["comm_ms"]))
    join = table.get("join") or {}
    if join.get("mismatches"):
        lines.append("replays left out (their kernels do not match the "
                     "eager run's): %s" % join["mismatches"][:4])
    return "\n".join(lines)


def _stop_trace():
    """Stop the session's profile and write its chrome trace; returns
    the trace's path, or None."""
    import torch

    prof = _session["prof"]
    _session["prof"] = None
    if prof is None:
        return None
    if torch.cuda.is_available():
        # this thread's stream: the session's work is done when it is
        # (never a device-wide synchronize, which would break another
        # thread's capture)
        torch.cuda.current_stream().synchronize()
    prof.stop()
    path = os.path.join(_session["dir"], "%s_%d.%d%s" % (
        socket.gethostname(), os.getpid(), _session["n"],
        observability.opprof.TRACE_SUFFIX))
    try:
        os.makedirs(_session["dir"], exist_ok=True)
        prof.export_chrome_trace(path)
    except OSError:
        path = None
    _last["profile"] = prof
    return path


def stop_profiler(sorted_key=None, profile_path=None):
    """Stop both halves; write the host summary table PLUS the
    op-attributed device-time table (the session's device events joined
    back to ProgramDesc ops through the opprof provenance ranges, with
    roofline verdicts) to ``profile_path`` (default: ``profile`` under
    the temporary directory) honoring ``sorted_key``, the host spans as
    chrome-trace JSON to ``<profile_path>.trace.json``, and the metrics
    registry as Prometheus text exposition to
    ``<profile_path>.metrics.prom``. The provenance sidecar
    (``opprof_provenance.json``) lands next to the traces. An attached
    streaming sink is flushed so its JSONL tail is complete at the moment
    the session ends. Returns the op table (None with ``opprof`` off)."""
    from paddle_tpu_torch.observability import opprof

    tagged = opprof.tagging()
    opprof.end_session()
    trace = _stop_trace()
    _last["trace"] = trace
    op_table = events = None
    if trace and tagged:
        try:
            opprof.save_sidecar(_session["dir"])
            op_table, events = opprof.attribute_events(trace)
        except Exception:
            op_table = events = None
        if op_table is not None:
            observability.set_gauge("opprof.attributed_frac",
                                    op_table["attributed_frac"])
            observability.set_gauge("opprof.unattributed_ms",
                                    op_table["unattributed_ms"])
            observability.set_gauge("opprof.comm_ms",
                                    op_table["comm_ms"])
            for tag, row in opprof.top_rows(op_table, top_k=20):
                if row["ms"] > 0:
                    observability.set_gauge("opprof.%s_ms" % tag,
                                            row["ms"])
    _last["table"], _last["events"] = op_table, events
    table = summary_table(sorted_key)
    if op_table is not None:
        table += "\n\n" + op_summary_text(op_table)
    if profile_path is None:
        profile_path = os.path.join(tempfile.gettempdir(), "profile")
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(table + "\n")
        observability.dump_chrome_trace(profile_path + ".trace.json")
        # refresh the goodput.*/mfu.* gauges first so the exposition
        # dump carries the ledger, then append the human-readable
        # summary block (comment lines — any Prometheus parser skips
        # them) answering "where did the wall clock go" inline
        observability.goodput.publish()
        with open(profile_path + ".metrics.prom", "w") as f:
            f.write(observability.registry.snapshot_text())
            if observability.goodput.enabled():
                snap = observability.goodput.snapshot()
                f.write("# goodput ledger: %.2f%% of %.1f ms wall "
                        "(attempt %d)\n"
                        % (100.0 * snap["goodput_frac"], snap["wall_ms"],
                           snap["attempt"]))
                for cat, ms in sorted(snap["categories"].items(),
                                      key=lambda cm: -cm[1]):
                    if ms > 0:
                        f.write("#   %-16s %12.3f ms\n" % (cat, ms))
    # snap=True: the opprof.* gauges just set (and the final goodput
    # ledger) land in the sink's last snapshot
    observability.flush_sink(snap=True)
    observability.set_enabled(None)  # back to the PADDLE_GPU_METRICS gate
    if trace:
        print("profiler: device trace %s (chrome://tracing, perfetto), "
              "host summary in %s" % (trace, profile_path))
    return op_table


def last_session():
    """The last session's op table, the device events it was made of
    ([(name, ms, tag or None)]), its ``torch.profiler`` profile and its
    trace's path."""
    return dict(_last)


def reset_profiler():
    """Drop all recorded host spans and metrics (reference
    profiler.py:148 reset_profiler)."""
    observability.reset()


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None,
             tracer_option=None):
    start_profiler(state, tracer_option)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """Accelerator profiler passthrough (name kept for API compat)."""
    with profiler():
        yield


@contextlib.contextmanager
def record_event(name):
    """RAII span (reference: platform/profiler.h:82 RecordEvent) — lands
    in BOTH timelines: a host observability span and a
    ``record_function`` range the device trace attributes kernels to."""
    import torch

    with observability.span(name), torch.profiler.record_function(name):
        yield


def profile_steps(step, steps=1, attempts=3, sorted_key=None,
                  profile_path=None):
    """Run ``step()`` ``steps`` times in one profiler session and return
    its op table; a window ``opprof.window_issues`` finds wanting (no
    device activity, a replay lacking launches the profiler dropped, a
    replay that did not join) is profiled again, up to ``attempts``
    sessions. ``step`` must be repeatable. Returns (table, [the issues of
    each rejected window])."""
    from paddle_tpu_torch.observability import opprof

    rejected = []
    table = None
    for _ in range(max(1, int(attempts))):
        start_profiler()
        try:
            for _ in range(steps):
                step()
        finally:
            table = stop_profiler(sorted_key, profile_path)
        issues = (opprof.window_issues(table) if table is not None
                  else ["no op table (the opprof flag is down)"])
        if not issues:
            break
        rejected.append(issues)
    return table, rejected
