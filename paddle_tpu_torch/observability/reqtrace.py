"""Request-scoped distributed tracing: trace-ID propagation, tail-based
sampling, and exemplar linkage across the serving fleet.

Port of ``paddle_tpu/observability/reqtrace.py`` (pure Python, kept as
the port's own copy; the environment prefix is ``PADDLE_GPU_``).

The rest of the observability stack answers *aggregate* questions — the
goodput ledger says how much wall clock a job wasted, the SLO monitor
says the p99 budget is burning, the op profiler says which device op is
hot. None of them can answer the question an on-call actually asks when
the p99 alarm fires: **which request was slow, and where did its time
go** — queue, bucket-coalesce wait, dispatch, device. This module is
that layer:

* **TraceContext** — ``(trace_id, parent_span_id, flags)``, the identity
  a request carries from ``InferenceServer.submit()`` (client-supplied
  ID or generated) through ``FleetRouter`` routing, the worker queue,
  bucket coalescing (the batch span records every member trace ID —
  fan-in is explicit, never inferred), the engine dispatch seam, and —
  for training — across the async dispatch window and across *process
  boundaries*: the supervisor exports ``PADDLE_GPU_TRACE_ID`` so a
  restarted incarnation's spans join the same trace, incarnation-fenced
  exactly like heartbeats.

* **Tail-based sampling** — spans buffer per-trace in a bounded ring
  (``PADDLE_GPU_TRACE_BUFFER`` in-flight traces, 512 spans each) and
  the verdict happens once, at request completion: the full trace is
  kept iff the request was slow (over ``PADDLE_GPU_TRACE_SLOW_MS``, or
  over 2x the EWMA-smoothed p99 of recent completions), errored, or
  head-sampled at the ``PADDLE_GPU_TRACE_SAMPLE`` rate. Everything else
  is dropped wholesale, so steady-state overhead is a context tag and a
  buffered tuple append — not a span flood. Kept spans are emitted as
  ordinary ``trace.*`` SpanRecords through the process span tracer, so
  they flow to the JSONL sink, the flight recorder, and the
  chrome-trace export for free.

* **Eager mode** (``FLAG_EAGER``) — a trace begun with this flag streams
  every span to the tracer/sink the moment it happens instead of
  buffering for a tail verdict. The reference tags such spans with the
  process's incarnation (the supervised launcher's restart count); that
  tag and the supervisor's cross-process seams (``export_env`` /
  ``adopt_env``) come with the port's launcher (ROADMAP Queue 1 item 11).

* **Training seams** — a thread activates a context (``activate`` /
  ``use``; ``current`` reads it), and the engine's dispatch window emits
  ``step_event("step_enqueue")`` when it takes a step and
  ``step_event("step_retire")`` when it retires it, both named with the
  step's ORIGINAL number, so the two halves of an async step correlate
  across the window. A thread with no active context (a serving
  dispatcher) emits nothing.

The head-sample decision is **deterministic in the trace ID** (a hash
fraction, not an RNG draw), so every process that sees the same ID —
router, worker, restarted incarnation — independently reaches the same
verdict without coordination.

Overhead contract: with tracing disabled (both flags 0) every seam is
one cached-bool check; with tracing enabled but a request not yet
finished, ``add_span`` is a lock + tuple append, < 2 us
(the reference's tests/test_reqtrace.py asserts it).
"""

import itertools
import os
import threading
import time
from collections import OrderedDict, deque

from paddle_tpu_torch import flags

# -- trace identity ---------------------------------------------------------

# Head-sample keep: decided at begin() from the trace-ID hash; the
# request is kept regardless of the tail verdict.
FLAG_SAMPLED = 1
# Eager streaming: spans bypass the tail buffer and emit immediately
# (training / cross-process traces — a killed incarnation's spans must
# already be on disk).
FLAG_EAGER = 2

# Serving stamps request times with time.monotonic(); sink spans use
# epoch microseconds. One anchor, taken once at import, converts
# between them (same pattern as tracing._EPOCH_ANCHOR_NS).
_MONO_ANCHOR_NS = time.time_ns() - time.monotonic_ns()

# Per-trace span-list cap: a runaway instrumented loop inside one
# request degrades to "first 512 spans + overflow count", never
# unbounded RAM.
MAX_SPANS_PER_TRACE = 512

# Process-wide span-ID source (itertools.count is atomic in CPython).
_ids = itertools.count(1)


def new_trace_id():
    """16 lowercase hex chars of OS entropy — unique per request."""
    return os.urandom(8).hex()


def new_span_id():
    return next(_ids)


def head_sampled(trace_id, rate):
    """Deterministic head-sample verdict: the first 8 hex chars of the
    ID as a fraction of 2^32, kept when under ``rate``. Every process
    hashing the same ID agrees — no coordination, no RNG state."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    try:
        frac = int(trace_id[:8], 16) / float(0xFFFFFFFF)
    except (ValueError, TypeError):
        return False
    return frac < rate


class TraceContext:
    """The identity a traced request carries: ``trace_id`` names the
    whole request, ``parent_span_id`` is the ID of its *root* span (the
    span child spans attach under), ``flags`` is the FLAG_* bitmask."""

    __slots__ = ("trace_id", "parent_span_id", "flags")

    def __init__(self, trace_id, parent_span_id, flags_=0):
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.flags = flags_

    @property
    def sampled(self):
        return bool(self.flags & FLAG_SAMPLED)

    @property
    def eager(self):
        return bool(self.flags & FLAG_EAGER)

    def __repr__(self):
        return "TraceContext(%s, root=%s, flags=%d)" % (
            self.trace_id, self.parent_span_id, self.flags)


# -- clock bridges ----------------------------------------------------------

def now_us():
    """Epoch microseconds (the sink span timebase)."""
    return time.time_ns() / 1e3


def mono_to_epoch_us(mono_s):
    """A ``time.monotonic()`` stamp (seconds) re-anchored to epoch
    microseconds, so serving's queue timestamps and the sink spans
    share one clock."""
    return (_MONO_ANCHOR_NS + mono_s * 1e9) / 1e3


# -- the tracer -------------------------------------------------------------

class ReqTracer:
    """Bounded per-trace span buffers + the tail-sampling verdict.

    Buffered entries are plain tuples ``(phase, ts_us, dur_us, span_id,
    parent_id, args)`` — no objects allocated on the hot path; they
    become real SpanRecords only if the trace survives its verdict.
    """

    def __init__(self, max_traces=None, max_spans=MAX_SPANS_PER_TRACE):
        self._lock = threading.Lock()
        self._traces = OrderedDict()   # trace_id -> [entry, ...]
        self._max_traces = max_traces  # None -> read the flag lazily
        self._max_spans = max_spans
        # completion stats + the adaptive slow threshold
        self._lat = deque(maxlen=512)  # recent total_ms of completions
        self._p99_ewma = None
        self._since_p99 = 0
        self.started = 0
        self.completed = 0
        self.kept = 0
        self.evicted = 0
        self.overflow = 0
        self.kept_by = {}              # reason -> count

    # -- config -----------------------------------------------------------
    def _bound(self):
        if self._max_traces is not None:
            return self._max_traces
        try:
            return max(1, int(flags.get_flag("trace_buffer") or 256))
        except (ValueError, TypeError):
            return 256

    def set_max_traces(self, n):
        self._max_traces = None if n is None else max(1, int(n))

    # -- lifecycle --------------------------------------------------------
    def begin(self, trace_id=None, flags_=None, sample_rate=None):
        """Start a trace: allocate the root span ID, decide the
        head-sample flag (deterministic in the ID), and open the span
        buffer (eager traces stream instead of buffering)."""
        trace_id = trace_id or new_trace_id()
        if flags_ is None:
            rate = (float(flags.get_flag("trace_sample") or 0.0)
                    if sample_rate is None else sample_rate)
            flags_ = FLAG_SAMPLED if head_sampled(trace_id, rate) else 0
        ctx = TraceContext(trace_id, new_span_id(), flags_)
        if not (flags_ & FLAG_EAGER):
            with self._lock:
                self.started += 1
                buf = self._traces.get(trace_id)
                if buf is None:
                    while len(self._traces) >= self._bound():
                        self._traces.popitem(last=False)
                        self.evicted += 1
                    self._traces[trace_id] = []
        else:
            with self._lock:
                self.started += 1
        return ctx

    def add_span(self, ctx, phase, ts_us, dur_us, parent=None, args=None,
                 root=False):
        """Record one span of ``ctx``'s trace. Buffered traces append a
        tuple under the lock (< 2 us, no allocation beyond the tuple);
        eager traces emit a SpanRecord immediately. ``root=True``
        records the trace's root span: it takes the context's own span
        ID and no parent. Returns the span ID (or None when the trace
        was evicted)."""
        if ctx is None:
            return None
        if root:
            sid, pid = ctx.parent_span_id, None
        else:
            sid = new_span_id()
            pid = ctx.parent_span_id if parent is None else parent
        if ctx.flags & FLAG_EAGER:
            self._emit_one(ctx.trace_id, phase, ts_us, dur_us, sid, pid,
                           args, eager=True)
            return sid
        with self._lock:
            buf = self._traces.get(ctx.trace_id)
            if buf is None:
                return None
            if len(buf) >= self._max_spans:
                self.overflow += 1
                return None
            buf.append((phase, ts_us, dur_us, sid, pid, args))
        return sid

    def finish(self, ctx, total_ms, error=False):
        """The tail verdict, at request completion: pop the buffer,
        decide keep/drop, emit the kept spans through the process span
        tracer. Returns ``(kept, reason)`` where reason is one of
        "error", "slow", "slow_p99", "sampled", "eager", or None."""
        if ctx is None:
            return (False, None)
        if ctx.flags & FLAG_EAGER:
            # eager spans are already out the door; nothing buffered
            with self._lock:
                self.completed += 1
                self.kept += 1
                self.kept_by["eager"] = self.kept_by.get("eager", 0) + 1
            return (True, "eager")
        with self._lock:
            buf = self._traces.pop(ctx.trace_id, None)
            self.completed += 1
            reason = self._verdict_locked(total_ms, error, ctx.flags)
            if reason is not None:
                self.kept += 1
                self.kept_by[reason] = self.kept_by.get(reason, 0) + 1
        if reason is not None and buf:
            self._emit_buffered(ctx.trace_id, buf, reason)
        return (reason is not None, reason)

    def _verdict_locked(self, total_ms, error, ctx_flags):
        """Keep-reason or None. Also feeds the completion-latency tail
        and refreshes the EWMA-p99 every 64 completions (>= 100 samples
        before the adaptive rule arms, so a cold start never keeps
        everything)."""
        self._lat.append(total_ms)
        self._since_p99 += 1
        if self._since_p99 >= 64 and len(self._lat) >= 100:
            self._since_p99 = 0
            s = sorted(self._lat)
            p99 = s[min(len(s) - 1, int(round(0.99 * (len(s) - 1))))]
            self._p99_ewma = (p99 if self._p99_ewma is None
                              else 0.8 * self._p99_ewma + 0.2 * p99)
        if error:
            return "error"
        slow_ms = float(flags.get_flag("trace_slow_ms") or 0.0)
        if slow_ms > 0.0 and total_ms > slow_ms:
            return "slow"
        if self._p99_ewma is not None and total_ms > 2.0 * self._p99_ewma:
            return "slow_p99"
        if ctx_flags & FLAG_SAMPLED:
            return "sampled"
        return None

    def p99_ewma(self):
        return self._p99_ewma

    # -- emission ---------------------------------------------------------
    def _emit_buffered(self, trace_id, entries, reason):
        from paddle_tpu_torch import observability as obs
        for phase, ts_us, dur_us, sid, pid, args in entries:
            a = {"trace": trace_id, "span": sid}
            if pid is not None:
                a["parent"] = pid
            if pid is None or phase == "request":
                a["keep"] = reason
            if args:
                a.update(args)
            obs.tracer.add_record(obs.SpanRecord(
                "trace." + phase, ts_us, dur_us,
                threading.get_ident(), 0, a))
        obs.inc("reqtrace.kept_spans", len(entries))

    def _emit_one(self, trace_id, phase, ts_us, dur_us, sid, pid, args,
                  eager=False):
        """Ungated direct emission (eager / supervisor spans): routes
        through the span tracer even with the metrics flag down — a
        traced job's spans must reach the sink regardless, the same
        contract the launcher's recovery events follow — and flushes so
        a kill right after still finds the span on disk."""
        from paddle_tpu_torch import observability as obs
        a = {"trace": trace_id, "span": sid}
        if pid is not None:
            a["parent"] = pid
        if args:
            a.update(args)
        obs.tracer.add_record(obs.SpanRecord(
            "trace." + phase, ts_us, dur_us, threading.get_ident(), 0, a))
        if eager:
            obs.flush_sink()

    # -- read / reset -----------------------------------------------------
    def in_flight(self):
        with self._lock:
            return len(self._traces)

    def stats(self):
        with self._lock:
            return {
                "started": self.started,
                "completed": self.completed,
                "kept": self.kept,
                "kept_frac": (self.kept / self.completed
                              if self.completed else 0.0),
                "kept_by": dict(self.kept_by),
                "evicted": self.evicted,
                "overflow": self.overflow,
                "in_flight": len(self._traces),
                "p99_ewma_ms": self._p99_ewma,
            }

    def reset(self):
        with self._lock:
            self._traces.clear()
            self._lat.clear()
            self._p99_ewma = None
            self._since_p99 = 0
            self.started = self.completed = self.kept = 0
            self.evicted = self.overflow = 0
            self.kept_by = {}


tracer = ReqTracer()

# -- enablement gate --------------------------------------------------------
# Cached tri-state: None = recompute from the flags on next check. Kept
# fresh by flag change-hooks so set_flags({"trace_sample": ...}) takes
# effect immediately; the disabled path is one cached-bool check.
_ENABLED = None


def enabled():
    global _ENABLED
    if _ENABLED is None:
        try:
            _ENABLED = (float(flags.get_flag("trace_sample") or 0.0) > 0.0
                        or float(flags.get_flag("trace_slow_ms") or 0.0)
                        > 0.0)
        except (ValueError, TypeError):
            _ENABLED = False
    return _ENABLED


def _invalidate(_v=None):
    global _ENABLED
    _ENABLED = None


flags.on_change("trace_sample", _invalidate)
flags.on_change("trace_slow_ms", _invalidate)
flags.on_change("trace_buffer", lambda _v: None)


# -- thread-local current context (training propagation) --------------------
_local = threading.local()


def current():
    """The thread's active TraceContext, or None. The training seams (the
    engine's enqueue, the window's retire) emit through it; a serving
    dispatcher thread, which never activates one, emits nothing."""
    return getattr(_local, "ctx", None)


def activate(ctx):
    _local.ctx = ctx
    return ctx


def deactivate():
    _local.ctx = None


class use:
    """``with reqtrace.use(ctx): ...`` — scoped activation."""

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        self._prev = current()
        _local.ctx = self.ctx
        return self.ctx

    def __exit__(self, exc_type, exc, tb):
        _local.ctx = self._prev
        return False


# -- module-level convenience ----------------------------------------------

def begin(trace_id=None, flags_=None, sample_rate=None):
    return tracer.begin(trace_id, flags_=flags_, sample_rate=sample_rate)


def maybe_begin(trace_id=None):
    """begin() iff tracing is enabled — the serving submit seam: one
    cached-bool check on the disabled path."""
    if not enabled():
        return None
    return tracer.begin(trace_id)


def add_span(ctx, phase, ts_us, dur_us, parent=None, **args):
    return tracer.add_span(ctx, phase, ts_us, dur_us, parent=parent,
                           args=args or None)


def add_root_span(ctx, phase, ts_us, dur_us, **args):
    """The trace's root span (usually phase "request", covering enqueue
    to completion) — recorded under the context's own span ID."""
    return tracer.add_span(ctx, phase, ts_us, dur_us, args=args or None,
                           root=True)


def finish(ctx, total_ms, error=False):
    return tracer.finish(ctx, total_ms, error=error)


def step_event(name, step, **args):
    """Instant eager event on the thread's active trace: the dispatch
    window's enqueue and retire markers, named with the ORIGINAL step so
    the two halves of an async step correlate across the window. A no-op
    with no active context."""
    ctx = current()
    if ctx is None:
        return
    args["step"] = step
    tracer._emit_one(ctx.trace_id, name, now_us(), 0.0, new_span_id(),
                     ctx.parent_span_id, args, eager=True)


def stats():
    return tracer.stats()


def reset():
    """Test isolation: drop every buffer and stat, forget the cached
    gate (conftest resets flags around tests too)."""
    tracer.reset()
    tracer.set_max_traces(None)
    _invalidate()
