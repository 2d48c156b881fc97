"""Host-side span tracer: RAII wall-clock spans, nestable, exported as
chrome-trace JSON.

Port of ``paddle_tpu/observability/tracing.py`` (kept as the port's own
copy). Where the reference merges the device planes of its profiler's
xplane files into the host trace (``xplane_to_chrome_trace``,
``tracing.py:233``), the port merges the device events (kernels,
memcpys, memsets) of the chrome-trace files ``torch.profiler`` wrote
under the directory (``device_trace_to_chrome_trace``): the argument
keeps the reference's name, ``xplane_dir``.

The host half of the reference's RecordEvent timeline (reference:
platform/profiler.h:82 RecordEvent): ``span("dispatch")`` records start
+ duration on exit, spans nest per thread, and ``chrome_trace()`` emits
complete ("ph": "X") slices with microsecond timestamps, loadable in
chrome://tracing / perfetto, on an epoch-anchored clock.

Span timestamps come from ``perf_counter_ns`` re-anchored to the epoch
once at import: monotonic durations, epoch-aligned starts.
"""

import json
import threading
import time

from paddle_tpu_torch.observability.export import (DEFAULT_FLIGHT_DEPTH,
                                             FlightRecorder)

# perf_counter is monotonic but has an arbitrary zero; anchor it to the
# epoch once so span starts align with device-trace timestamps.
_EPOCH_ANCHOR_NS = time.time_ns() - time.perf_counter_ns()

# Finished spans are capped so a long serving loop with tracing left on
# degrades to "recent window + dropped count", never unbounded RAM.
# With a streaming sink attached (observability/export.py) the cap never
# bites: spans stream to disk and only the flight recorder stays in RAM.
MAX_SPANS = 100000


class SpanRecord:
    __slots__ = ("name", "ts_us", "dur_us", "tid", "depth", "args")

    def __init__(self, name, ts_us, dur_us, tid, depth, args):
        self.name = name
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.tid = tid
        self.depth = depth
        self.args = args

    def __repr__(self):
        return "SpanRecord(%r, ts=%.1fus, dur=%.1fus, depth=%d)" % (
            self.name, self.ts_us, self.dur_us, self.depth)


class SpanTracer:
    def __init__(self, max_spans=MAX_SPANS, flight_depth=None):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans = []
        self._dropped = 0
        self._max_spans = max_spans
        self._sink = None
        self._flight = FlightRecorder(flight_depth or DEFAULT_FLIGHT_DEPTH)
        # name of the most recently entered open span, process-wide —
        # the "what is this worker doing" field the health heartbeat
        # reports. Plain attribute write on span enter/exit (no lock:
        # an approximate label, read racily by the heartbeat thread).
        self._phase_name = None

    # -- record -----------------------------------------------------------
    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _add(self, rec):
        with self._lock:
            self._flight.add(rec)
            sink = self._sink
            if sink is not None:
                # Streaming mode: the span goes to the sink, RAM keeps
                # only the flight-recorder window — an unbounded loop
                # never drops and never grows.
                try:
                    sink.emit_span(rec)
                except Exception:
                    self._dropped += 1
                return
            if len(self._spans) >= self._max_spans:
                self._dropped += 1
                return
            self._spans.append(rec)

    def add_record(self, rec):
        """Record an externally built SpanRecord through the normal
        sink/flight/in-memory routing — the request tracer
        (observability/reqtrace) emits a kept trace's buffered spans
        through this, so ``trace.*`` spans reach the JSONL sink, the
        flight recorder, and the chrome-trace export exactly like
        natively recorded spans."""
        self._add(rec)

    # -- sink / flight recorder -------------------------------------------
    def attach_sink(self, sink):
        """Route finished spans to ``sink`` (export.JsonlSink protocol:
        ``emit_span(rec)``). Returns the previously attached sink (not
        closed — the caller owns lifecycle)."""
        with self._lock:
            prev, self._sink = self._sink, sink
            return prev

    def detach_sink(self):
        with self._lock:
            prev, self._sink = self._sink, None
            return prev

    @property
    def sink(self):
        return self._sink

    def set_flight_depth(self, depth):
        with self._lock:
            self._flight.resize(depth)

    def span(self, name, **args):
        return _Span(self, name, args)

    def current_phase(self):
        """The innermost open span's name (any thread), or None."""
        return self._phase_name

    def event(self, name, **args):
        """Zero-duration instant marker (chrome-trace "i" events) — e.g.
        a nan/inf-guard trip, a cache eviction."""
        now_us = (_EPOCH_ANCHOR_NS + time.perf_counter_ns()) / 1e3
        self._add(SpanRecord(name, now_us, 0.0, threading.get_ident(),
                             len(self._stack()), args or None))

    # -- read -------------------------------------------------------------
    def spans(self):
        """Recorded spans: the in-memory list, or — in streaming mode,
        where spans live on disk — the flight recorder's window."""
        with self._lock:
            if self._sink is not None:
                return self._flight.records()
            return list(self._spans)

    def dropped(self):
        with self._lock:
            return self._dropped

    def reset(self):
        with self._lock:
            self._spans = []
            self._dropped = 0
            self._flight.clear()
            self._phase_name = None

    def chrome_trace_events(self, pid=1, process_name="paddle_gpu host"):
        """Chrome-trace event dicts for every recorded span: per-process
        and per-thread name metadata, "X" slices for spans, "i" instants
        for zero-duration events."""
        spans = self.spans()
        events = [{"name": "process_name", "ph": "M", "pid": pid,
                   "args": {"name": process_name}}]
        tids = {}
        for s in spans:
            if s.tid not in tids:
                tids[s.tid] = len(tids)
                events.append({"name": "thread_name", "ph": "M", "pid": pid,
                               "tid": tids[s.tid],
                               "args": {"name": "host thread %d"
                                        % tids[s.tid]}})
        for s in spans:
            ev = {"name": s.name, "pid": pid, "tid": tids[s.tid],
                  "ts": s.ts_us}
            if s.dur_us > 0.0:
                ev["ph"] = "X"
                ev["dur"] = s.dur_us
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            if s.args:
                ev["args"] = dict(s.args)
            events.append(ev)
        return events

    def chrome_trace(self, xplane_dir=None):
        """Full chrome-trace dict. With ``xplane_dir`` (a directory of
        ``torch.profiler`` traces, or one trace) the device lanes
        (``device_trace_to_chrome_trace`` below) are merged in as further
        processes — one file, host spans above the device lanes, shared
        wall clock."""
        events = self.chrome_trace_events()
        if xplane_dir is not None:
            device = device_trace_to_chrome_trace(xplane_dir)["traceEvents"]
            for ev in device:
                ev = dict(ev)
                ev["pid"] = ev.get("pid", 1) + 1  # host trace owns pid 1
                events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path, xplane_dir=None):
        trace = self.chrome_trace(xplane_dir=xplane_dir)
        with open(path, "w") as f:
            json.dump(trace, f)
        return path

    def summary(self):
        """Aggregate by span name: {name: {calls, total_ms, min_ms,
        max_ms, ave_ms}} — the reference profiler's summary-table rows
        (reference: platform/profiler.cc PrintProfiler)."""
        agg = {}
        for s in self.spans():
            row = agg.setdefault(s.name, {"calls": 0, "total_ms": 0.0,
                                          "min_ms": None, "max_ms": None})
            ms = s.dur_us / 1e3
            row["calls"] += 1
            row["total_ms"] += ms
            row["min_ms"] = ms if row["min_ms"] is None else min(
                row["min_ms"], ms)
            row["max_ms"] = ms if row["max_ms"] is None else max(
                row["max_ms"], ms)
        for row in agg.values():
            row["ave_ms"] = row["total_ms"] / row["calls"]
        return agg


def device_trace_to_chrome_trace(trace_dir, line_filter=None):
    """-> chrome-trace dict {"traceEvents": [...], "displayTimeUnit":
    "ms"} of the device events of every distinct ``torch.profiler``
    trace under ``trace_dir`` (byte-identical files are read once, by
    the shared trace iterator). Every device of a trace becomes a chrome
    "process", every stream a "thread"; events are complete ("X")
    slices whose microsecond timestamps carry the trace's
    ``baseTimeNanoseconds``, the epoch clock the host spans use.
    ``line_filter`` (a substring of the event's category, e.g.
    "kernel") keeps matching events only."""
    from paddle_tpu_torch.observability.opprof import iter_planes

    device_cats = ("kernel", "gpu_memcpy", "gpu_memset")
    events = []
    pids = {}
    for n, trace in enumerate(iter_planes(trace_dir)):
        base_us = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
        tids = {}
        for e in trace["traceEvents"]:
            cat = e.get("cat")
            if e.get("ph") != "X" or cat not in device_cats:
                continue
            if line_filter and line_filter not in cat:
                continue
            key = (n, e.get("pid"))
            if key not in pids:
                pids[key] = len(pids) + 1
                events.append({"name": "process_name", "ph": "M",
                               "pid": pids[key],
                               "args": {"name": "device %s" % (key[1],)}})
            pid = pids[key]
            lane = (pid, e.get("tid"))
            if lane not in tids:
                tids[lane] = len(tids)
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": tids[lane],
                               "args": {"name": "stream %s" % (lane[1],)}})
            events.append({
                "name": e.get("name", "?"),
                "ph": "X",
                "pid": pid,
                "tid": tids[lane],
                "ts": base_us + float(e["ts"]),
                "dur": float(e["dur"]),
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


class _Span:
    """RAII span: start on __enter__, record on __exit__ (also usable as
    a decorator-free plain object for manual begin/end)."""

    __slots__ = ("tracer", "name", "args", "_t0_ns", "_depth")

    def __init__(self, tracer, name, args):
        self.tracer = tracer
        self.name = name
        self.args = args or None

    def __enter__(self):
        stack = self.tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self.tracer._phase_name = self.name
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur_ns = time.perf_counter_ns() - self._t0_ns
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.tracer._phase_name = stack[-1].name if stack else None
        self.tracer._add(SpanRecord(
            self.name, (_EPOCH_ANCHOR_NS + self._t0_ns) / 1e3,
            dur_ns / 1e3, threading.get_ident(), self._depth, self.args))
        return False
