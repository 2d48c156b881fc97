"""Unified runtime flags (reference: the gflags-backed FLAGS_* system —
paddle/fluid/platform/init.cc InitGflags + python/paddle/fluid/__init__.py
__bootstrap__ reading env into gflags). Port of ``paddle_tpu/flags.py``:
the same mechanism, under the environment prefix ``PADDLE_GPU_``. Values
come from (highest precedence first) programmatic ``set_flags``, the
environment, the default.

Only the flags that the port's modules read are declared; a later slice
adds the entries of the modules it ports.

Usage::

    from paddle_tpu_torch import flags
    flags.set_flags({"metrics": True})
    flags.get_flag("serving_max_wait_ms")
    flags.describe()          # name -> (value, source, help)
"""

import os

__all__ = ["DEFS", "ENV_PREFIX", "get_flag", "set_flags", "reset_flag",
           "describe", "env_name", "on_change"]

ENV_PREFIX = "PADDLE_GPU_"

# name -> (type, default, help)
DEFS = {
    "check_nan_inf": (
        bool, False,
        "Verify every fetch/state tensor is finite after each step "
        "(reference: FLAGS_check_nan_inf)."),
    "executable_cache_size": (
        int, 128,
        "LRU capacity of the engine's compiled-block cache: one entry, "
        "and on CUDA one captured graph, per (program, feed signature, "
        "fetches, is_test, donation, AMP, cache tag) (reference: the "
        "Executor program cache)."),
    "metrics": (
        bool, False,
        "Runtime telemetry (paddle_tpu_torch.observability): counters, "
        "timing histograms and host-side spans exportable as chrome-trace "
        "JSON. Off = no-op stubs at every instrumented seam (near-zero "
        "overhead)."),
    "metrics_sink": (
        str, "",
        "Streaming telemetry export (observability/export.py): path of a "
        "JSONL sink file finished spans, instant events, and periodic "
        "metric snapshots stream to as one-line JSON events. Multi-process "
        "runs tag the file per host (<base>.h<rank>.jsonl). Empty = no "
        "sink."),
    "metrics_sink_rotate_mb": (
        float, 64.0,
        "Size-based rotation threshold for the JSONL sink, in MiB. <=0 "
        "disables rotation."),
    "metrics_sink_keep": (
        int, 8,
        "Rotated JSONL files kept per sink (oldest pruned); the live "
        "file is always kept. <=0 keeps every rotation."),
    "flight_recorder_depth": (
        int, 2048,
        "Depth of the always-on in-memory flight recorder ring buffer: "
        "the last N finished spans/events survive in RAM."),
    "heartbeat_ms": (
        float, 0.0,
        "Per-process liveness heartbeat interval in ms "
        "(observability/health.py): a daemon thread writes "
        "health.heartbeat events (step counter, current span phase, host "
        "RSS, serving queue depth) through the telemetry sink and flushes "
        "it. Bypasses the metrics gate. 0 = off."),
    "serving_slo_ms": (
        float, 0.0,
        "Per-request latency SLO of the continuous-batching "
        "InferenceServer, in ms: requests slower than this spend error "
        "budget in the fast/slow burn-rate windows "
        "(observability/health.SloMonitor); sustained burn in both "
        "windows flips InferenceServer.health() to unhealthy. 0 = no SLO "
        "monitor."),
    "serving_buckets": (
        str, "1,2,4,8,16,32",
        "Padded batch-size bucket edges of the continuous-batching "
        "server (inference/serving.py), comma-separated. Coalesced "
        "requests are padded up to the smallest edge that fits."),
    "serving_max_wait_ms": (
        float, 5.0,
        "Max time the serving batcher holds the oldest queued request "
        "while waiting to fill a bigger bucket, in ms: the p99 bound at "
        "low QPS. 0 = dispatch immediately."),
    "trace_sample": (
        float, 0.0,
        "Head-sampling rate of the request tracer "
        "(observability/reqtrace.py), decided deterministically from the "
        "trace ID. Tracing is active when this or PADDLE_GPU_TRACE_SLOW_MS "
        "is > 0."),
    "trace_slow_ms": (
        float, 0.0,
        "Tail-sampling latency threshold of the request tracer, in ms: a "
        "completed request slower than this keeps its full span buffer "
        "(errored requests and those slower than 2x the EWMA p99 are kept "
        "too). 0 = no fixed threshold."),
    "trace_buffer": (
        int, 256,
        "Max in-flight traces the request tracer buffers spans for; the "
        "oldest is evicted when a new one would exceed the bound."),
    "queue_limit": (
        int, 0,
        "Bound on the serving request queue (inference/admission.py): a "
        "submit past it first evicts expired requests, then sheds a "
        "lower-priority entry if PADDLE_GPU_SERVING_SHED is on, then "
        "raises Rejected('queue_full'). 0 = unbounded."),
    "serving_shed": (
        bool, False,
        "Priority load shedding: while the SLO fast window burns, "
        "priority<=0 submissions are shed (Rejected('shed')), and a full "
        "bounded queue may evict its lowest-priority entry for a "
        "higher-priority newcomer."),
    "serving_degraded": (
        bool, False,
        "Degraded-mode fallback of the InferenceServer: with a "
        "degraded_program passed at construction, a fast-window SLO burn "
        "switches dispatch to it and a confirmed slow-window recovery "
        "switches back."),
}

_overrides = {}
_env_backup = {}
# name -> [callables] invoked with the new value after set_flags /
# reset_flag touches that flag (observability caches its gate off this).
_change_hooks = {}


def on_change(name, fn):
    if name not in DEFS:
        raise KeyError("unknown flag %r" % name)
    _change_hooks.setdefault(name, []).append(fn)


def _notify(name):
    for fn in _change_hooks.get(name, ()):
        fn(get_flag(name))


def env_name(name):
    return ENV_PREFIX + name.upper()


def _parse(typ, raw):
    if typ is bool:
        return raw not in ("0", "", "false", "False", False, 0, None)
    return typ(raw)


def get_flag(name):
    typ, default, _ = DEFS[name]
    if name in _overrides:
        return _overrides[name]
    raw = os.environ.get(env_name(name))
    if raw is None:
        return default
    return _parse(typ, raw)


def set_flags(flags_dict):
    """Programmatic override. Also mirrors into the environment so
    subprocesses inherit the setting."""
    for name, value in flags_dict.items():
        if name not in DEFS:
            raise KeyError(
                "unknown flag %r; known: %s" % (name, sorted(DEFS)))
        typ = DEFS[name][0]
        value = _parse(typ, value) if not isinstance(value, typ) else value
        if name not in _env_backup:
            _env_backup[name] = os.environ.get(env_name(name))
        _overrides[name] = value
        os.environ[env_name(name)] = (
            ("1" if value else "0") if typ is bool else str(value))
        _notify(name)


def reset_flag(name):
    """Undo a set_flags override, restoring any pre-existing env value
    (the set_flags > env > default precedence survives)."""
    _overrides.pop(name, None)
    prev = _env_backup.pop(name, None)
    if prev is None:
        os.environ.pop(env_name(name), None)
    else:
        os.environ[env_name(name)] = prev
    _notify(name)


def describe():
    out = {}
    for name, (typ, default, help_text) in DEFS.items():
        if name in _overrides:
            src = "set_flags"
        elif env_name(name) in os.environ:
            src = "env"
        else:
            src = "default"
        out[name] = (get_flag(name), src, help_text)
    return out
