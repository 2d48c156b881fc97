"""Thread-safe metrics registry: counters, gauges, timing histograms.

Port of ``paddle_tpu/observability/metrics.py`` (pure Python, kept as
the port's own copy). The host-side half of the reference's profiler
bookkeeping (reference: paddle/fluid/platform/profiler.cc Event/EventList):
instrumented seams increment named counters and record wall-time
observations here, and ``snapshot()`` returns one plain-dict view a
bench, test, or report can serialize.

Gated by ``PADDLE_GPU_METRICS`` (flags.py). The off path is a handful of
module-bool checks per step — no locks taken, no objects allocated — so
instrumented seams cost nothing when the flag is down.

Usage::

    from paddle_tpu_torch import observability as obs
    obs.inc("serving.requests")
    obs.observe("serving.batch_ms", wall_ms)
    with obs.time_block("serving.coalesce"):  # histogram of the block wall
        ...
    obs.snapshot()   # {"counters": {...}, "gauges": {...},
                     #  "histograms": {name: {count, total, mean, ...}}}
"""

import threading
import time

# Bounded per-histogram sample tail kept for percentiles; totals/extrema
# are exact over every observation regardless.
_HIST_TAIL = 512


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n


class Gauge:
    __slots__ = ("value", "exemplar")

    def __init__(self):
        self.value = None
        # (value, trace_id) of the most recent observation that carried
        # an exemplar — the request-trace linkage slot.
        self.exemplar = None

    def set(self, v, exemplar=None):
        self.value = v
        if exemplar is not None:
            self.exemplar = (v, exemplar)


class Histogram:
    """Exact count/total/min/max over all observations plus a bounded
    tail of recent samples for percentiles."""

    __slots__ = ("count", "total", "min", "max", "samples", "exemplar")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.samples = []
        # (value, trace_id) of the worst exemplar-carrying observation:
        # the trace behind the bucket max, the one an SLO page wants.
        self.exemplar = None

    def record(self, v, exemplar=None):
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self.samples.append(v)
        if len(self.samples) > _HIST_TAIL:
            del self.samples[: len(self.samples) - _HIST_TAIL]
        if exemplar is not None and (self.exemplar is None
                                     or v >= self.exemplar[0]):
            self.exemplar = (v, exemplar)

    def percentile(self, q):
        """Nearest-rank percentile over the bounded sample tail; a
        zero-count histogram (or out-of-range ``q``) returns ``None``
        instead of raising — a scrape must never crash on a metric that
        has not fired yet."""
        if self.count == 0 or not self.samples:
            return None
        q = min(100.0, max(0.0, float(q)))
        s = sorted(self.samples)
        idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[idx]

    def describe(self):
        if self.count == 0:
            return {"count": 0, "total": 0.0, "mean": None, "min": None,
                    "max": None, "p50": None, "p99": None}
        return {
            "count": self.count,
            "total": self.total,
            "mean": self.total / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """One lock for the whole registry: the seams record a handful of
    values per *step* (not per op), so contention is nil and a single
    lock keeps snapshot/reset trivially consistent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._histograms = {}

    # -- record -----------------------------------------------------------
    def inc(self, name, n=1):
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            c.inc(n)

    def set_gauge(self, name, value, exemplar=None):
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            g.set(value, exemplar)

    def observe(self, name, value, exemplar=None):
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            h.record(value, exemplar)

    # -- read -------------------------------------------------------------
    def counter_value(self, name, default=0):
        with self._lock:
            c = self._counters.get(name)
            return c.value if c is not None else default

    def gauge_value(self, name, default=None):
        with self._lock:
            g = self._gauges.get(name)
            return g.value if g is not None else default

    def histogram(self, name):
        with self._lock:
            return self._histograms.get(name)

    def snapshot(self):
        """Plain-dict view of everything recorded so far (safe to
        json.dumps). Values are copied out under the lock; the live
        registry keeps recording. Gauges stay plain scalars — exemplar
        slots land under a separate top-level ``"exemplars"`` key
        (present only when at least one metric carries one) so every
        existing consumer keeps reading scalar gauges."""
        with self._lock:
            snap = {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.describe()
                               for k, h in self._histograms.items()},
            }
            exemplars = {}
            for coll in (self._gauges, self._histograms):
                for k, m in coll.items():
                    if m.exemplar is not None:
                        exemplars[k] = {"value": m.exemplar[0],
                                        "trace_id": m.exemplar[1]}
            if exemplars:
                snap["exemplars"] = exemplars
            return snap

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def snapshot_text(self, prefix="paddle_gpu"):
        """Prometheus-style text exposition of the registry."""
        return snapshot_text(self.snapshot(), prefix=prefix)


def _prom_name(prefix, name):
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    name = "".join(out)
    return prefix + "_" + name if prefix else name


def _prom_value(v):
    if v is None:
        return "NaN"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, int):
        return str(v)
    return "NaN"  # non-numeric gauge values are unrepresentable


def snapshot_text(snap, prefix="paddle_gpu"):
    """Render one ``MetricsRegistry.snapshot()``-shaped dict as
    Prometheus text exposition format: counters as ``counter``, gauges
    as ``gauge``, histograms as ``summary`` (quantile series + _sum +
    _count). Standalone so offline consumers (a JSONL "snap" event)
    render the identical text."""
    lines = []
    for name, v in sorted(snap.get("counters", {}).items()):
        m = _prom_name(prefix, name)
        lines.append("# TYPE %s counter" % m)
        lines.append("%s %s" % (m, _prom_value(v)))
    for name, v in sorted(snap.get("gauges", {}).items()):
        m = _prom_name(prefix, name)
        lines.append("# TYPE %s gauge" % m)
        lines.append("%s %s" % (m, _prom_value(v)))
    for name, h in sorted(snap.get("histograms", {}).items()):
        m = _prom_name(prefix, name)
        lines.append("# TYPE %s summary" % m)
        for q_key, q in (("p50", "0.5"), ("p99", "0.99")):
            if h.get(q_key) is not None:
                lines.append('%s{quantile="%s"} %s'
                             % (m, q, _prom_value(h[q_key])))
        lines.append("%s_sum %s" % (m, _prom_value(h.get("total", 0.0))))
        lines.append("%s_count %s" % (m, _prom_value(h.get("count", 0))))
    # Exemplar linkage as comment lines: classic text exposition has no
    # exemplar syntax (that is OpenMetrics), so the trace IDs ride in
    # ``# EXEMPLAR <series> <value> trace_id="<id>"`` comments — ignored
    # by any Prometheus parser, greppable by an on-call.
    for name, ex in sorted(snap.get("exemplars", {}).items()):
        lines.append('# EXEMPLAR %s %s trace_id="%s"'
                     % (_prom_name(prefix, name),
                        _prom_value(ex.get("value")),
                        ex.get("trace_id")))
    return "\n".join(lines) + ("\n" if lines else "")


class _TimeBlock:
    """Reusable-shape timing ctx mgr: records the block's wall clock in
    MILLISECONDS into a histogram on exit."""

    __slots__ = ("registry", "name", "_t0")

    def __init__(self, registry, name):
        self.registry = registry
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.registry.observe(
            self.name, (time.perf_counter() - self._t0) * 1e3)
        return False


class _NullBlock:
    """Shared no-op ctx mgr for the flag-off path."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_BLOCK = _NullBlock()
