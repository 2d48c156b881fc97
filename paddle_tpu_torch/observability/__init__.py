"""paddle_tpu_torch.observability — runtime telemetry across the port's
seams. Port of the facade of ``paddle_tpu/observability/__init__.py``
(:72-258), with the port's own copies of its pure-Python modules:

* a **metrics registry** (metrics.py): thread-safe counters / gauges /
  timing histograms with exemplars;
* a **span tracer** (tracing.py): RAII host spans exportable as
  chrome-trace JSON, streaming to a JSONL sink (export.py) with an
  always-on flight recorder;
* request tracing (reqtrace.py), health and the serving SLO monitor
  (health.py), and the goodput ledger (goodput.py);
* device-memory accounting (memory.py) on the CUDA caching allocator,
  and op-level device profiling (opprof.py) on ``torch.profiler``.

``paddle_tpu_torch.profiler`` is the user-facing façade that starts and
stops these host spans together with the device trace.

Everything is gated by ``PADDLE_GPU_METRICS`` (flags.py): with the flag
down every helper here is one module-bool check — no locks, no
allocation. The gate is cached in ``_ENABLED`` and kept fresh by a flags
change-hook, so ``flags.set_flags({"metrics": True})`` takes effect
immediately; ``PADDLE_GPU_METRICS=1`` in the environment is read once at
import. Importing this package opens no file and starts no thread: the
JSONL sink (``PADDLE_GPU_METRICS_SINK``) and the heartbeat
(``PADDLE_GPU_HEARTBEAT_MS``) start from ``set_flags`` or from
``attach_sink()`` / ``health.ensure_heartbeat()``, which
``InferenceServer.start()`` calls.
"""

from paddle_tpu_torch import flags
from paddle_tpu_torch.observability import (  # noqa: F401
    export,
    goodput,
    health,
    memory,
    opprof,
    reqtrace,
)
from paddle_tpu_torch.observability.export import (  # noqa: F401
    FlightRecorder,
    JsonlSink,
)
from paddle_tpu_torch.observability.metrics import (  # noqa: F401
    NULL_BLOCK,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    _TimeBlock,
    snapshot_text,
)
from paddle_tpu_torch.observability.tracing import (  # noqa: F401
    SpanRecord,
    SpanTracer,
)

__all__ = [
    "FlightRecorder", "JsonlSink", "MetricsRegistry", "SpanTracer",
    "attach_sink", "counter_value", "detach_sink", "dump_chrome_trace",
    "enabled", "event", "flush_sink", "goodput", "health", "inc",
    "memory", "observe", "opprof", "registry", "reqtrace", "reset",
    "set_enabled", "set_gauge", "sink", "snapshot", "snapshot_text",
    "span", "spans", "time_block", "tracer",
]

registry = MetricsRegistry()
tracer = SpanTracer(flight_depth=int(flags.get_flag("flight_recorder_depth")))

_ENABLED = bool(flags.get_flag("metrics"))


def set_enabled(value=None):
    """Override the gate (``True``/``False``) or re-read the flag
    (``None``). The profiler façade forces the gate up for the duration
    of an explicit profiling session regardless of the flag."""
    global _ENABLED
    _ENABLED = (bool(flags.get_flag("metrics")) if value is None
                else bool(value))


flags.on_change("metrics", lambda _v: set_enabled(None))


def enabled():
    return _ENABLED


# -- streaming sink --------------------------------------------------------
def sink():
    """The active streaming sink, or None."""
    return tracer.sink


def attach_sink(path=None, host=None, **kwargs):
    """Attach a rotating JSONL sink (export.JsonlSink) to the tracer:
    finished spans/events stream to disk, tracer memory stays bounded at
    the flight-recorder depth, ``dropped()`` stays 0 on unbounded loops.

    ``path`` defaults to the ``PADDLE_GPU_METRICS_SINK`` flag; returns
    None (and detaches nothing) when neither is set. Multi-process runs
    (``host`` passed, or a launcher rank in the environment) write to
    the host-tagged ``<base>.h<rank><ext>``. Any previous sink is closed.
    """
    import os

    path = path or flags.get_flag("metrics_sink")
    if not path:
        return None
    explicit = host is not None
    host = export.host_tag() if host is None else int(host)
    try:
        world = int(os.environ.get(
            "PADDLE_TRAINERS_NUM", os.environ.get("WORLD_SIZE") or 1))
    except ValueError:
        world = 1
    if explicit or host or world > 1:
        path = export.host_tagged_path(path, host)
    kwargs.setdefault(
        "rotate_bytes",
        int(float(flags.get_flag("metrics_sink_rotate_mb")) * 2 ** 20))
    kwargs.setdefault("keep", int(flags.get_flag("metrics_sink_keep")))
    kwargs.setdefault("snapshot_fn", registry.snapshot)
    new = JsonlSink(path, host=host, **kwargs)
    prev = tracer.attach_sink(new)
    if prev is not None:
        try:
            prev.close()
        except Exception:
            pass
    return new


def detach_sink():
    """Detach and close the active sink (final metric snapshot + flush
    included). Returns the closed sink, or None."""
    prev = tracer.detach_sink()
    if prev is not None:
        try:
            prev.close()
        except Exception:
            pass
    return prev


def flush_sink(snap=False):
    """Flush the active sink; ``snap=True`` also forces a metrics
    snapshot first, so the final gauge values land on disk even when the
    process never detaches the sink."""
    s = tracer.sink
    if s is not None:
        if snap:
            try:
                s.emit_snapshot(force=True)
            except Exception:
                pass
        s.flush()


def _sink_flag_changed(value):
    if value:
        attach_sink(value)
    else:
        detach_sink()


flags.on_change("metrics_sink", _sink_flag_changed)
flags.on_change("flight_recorder_depth",
                lambda v: tracer.set_flight_depth(int(v)))
flags.on_change("heartbeat_ms", lambda _v: health.ensure_heartbeat())


# -- metrics ---------------------------------------------------------------
def inc(name, n=1):
    if _ENABLED:
        registry.inc(name, n)


def set_gauge(name, value, exemplar=None):
    if _ENABLED:
        registry.set_gauge(name, value, exemplar)


def observe(name, value, exemplar=None):
    if _ENABLED:
        registry.observe(name, value, exemplar)


def time_block(name):
    """Ctx mgr recording the block's wall time (ms) into histogram
    ``name`` — a metric only, no span."""
    if not _ENABLED:
        return NULL_BLOCK
    return _TimeBlock(registry, name)


def counter_value(name, default=0):
    return registry.counter_value(name, default)


# -- spans -----------------------------------------------------------------
def span(name, **args):
    """RAII host span: wall start + duration, nests per thread."""
    if not _ENABLED:
        return NULL_BLOCK
    return tracer.span(name, **args)


def event(name, **args):
    """Zero-duration instant marker in the trace."""
    if _ENABLED:
        tracer.event(name, **args)


def spans():
    return tracer.spans()


# -- export ----------------------------------------------------------------
def snapshot():
    """One plain dict of everything recorded: counters, gauges,
    histogram summaries, and the per-span-name aggregate."""
    out = registry.snapshot()
    out["spans"] = tracer.summary()
    dropped = tracer.dropped()
    if dropped:
        out["dropped_spans"] = dropped
    return out


def dump_chrome_trace(path, xplane_dir=None):
    """Write the host spans as chrome-trace JSON (load in
    chrome://tracing or perfetto). With ``xplane_dir`` (a directory of
    ``torch.profiler`` traces) the device lanes are merged into the same
    file as additional processes."""
    return tracer.dump_chrome_trace(path, xplane_dir=xplane_dir)


def reset():
    """Drop all recorded metrics, spans, goodput charges and request
    traces (test isolation). Memory watermarks reset too; an attached
    sink stays attached (stream files are append-only history, not
    registry state)."""
    registry.reset()
    tracer.reset()
    memory.reset_peaks()
    goodput.reset()
    reqtrace.reset()
