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
    "verify": (
        bool, False,
        "Run the static program verifier (paddle_tpu_torch.analysis) "
        "before each block is lowered: once per cache entry, on the desc "
        "the transforms return, raising on ERROR-severity findings "
        "(use-before-def, dtype clashes, orphan gradients...)."),
    "opt_level": (
        int, 1,
        "Desc-level optimization applied once per cache entry at the "
        "engine's cache-miss seam (analysis/transforms.py "
        "optimize_program): 0 = off, 1 = the attention-pattern rewrite "
        "to the fused flash-attention op (the reference's default), "
        "2 = + elementwise-activation fusion, constant folding and CSE, "
        "3 = + memory planning (donation, auto-remat against the "
        "hbm_budget_frac budget), 4 = + the NHWC layout pass (see "
        "'layout'). Rewrites operate on a clone; the program desc is "
        "never mutated."),
    "layout": (
        str, "auto",
        "Whole-program layout assignment (analysis/layout.py): rewrite "
        "every conv/pool/batch_norm (and their grads) to NHWC, bake "
        "OIHW filters to HWIO in the scope, and insert transpose2 seams "
        "only at feed/fetch/flatten boundaries. 'auto' = on at opt_level "
        ">= 4, 'nhwc' = on whenever transforms run, 'off' = never. The "
        "engine keys its cache on the resolved value."),
    "replan_tolerance": (
        float, 0.0,
        "Measured-feedback memory re-planning: when the realized peak "
        "(torch.cuda.max_memory_allocated around the eager first run of "
        "a planned CUDA entry, the memory_plan_delta event) misses the "
        "prediction by more than this relative tolerance, re-plan the "
        "remat segment count from the measured peak and rebuild the "
        "entry once (bounded; counted in memory.replan). <=0 disables."),
    "spmd_predict": (
        bool, False,
        "Validate the static SPMD collective schedule "
        "(analysis/spmd.py) against the collectives the mesh path "
        "issues on the first run of every mesh cache entry: compare "
        "predicted psum/all-gather counts and payload bytes with the "
        "ones parallel/plan.py recorded, and emit "
        "spmd.prediction_delta telemetry — the collective-schedule "
        "analog of memory_plan_delta. Requires PADDLE_GPU_METRICS=1; "
        "no-op without a mesh."),
    "hbm_budget_frac": (
        float, 0.9,
        "Fraction of device memory (observability.memory."
        "device_memory_limit: the card's total memory, overridable via "
        "PADDLE_GPU_DEVICE_MEMORY_BYTES) the opt-level-3 memory planner "
        "budgets a step against: when the liveness peak estimate "
        "exceeds budget, automatic rematerialization picks the "
        "smallest checkpoint segment count that fits. <=0 or an "
        "unknowable device limit disables auto-remat (donation "
        "planning still runs)."),
    "auto_layout": (
        bool, False,
        "Let the compiler choose entry/exit buffer layouts for training "
        "state. The reference applies it on a TPU backend only; on the "
        "card (and the CPU) it changes nothing, in either package. Kept "
        "so that a configuration setting it runs unchanged."),
    "memory_pressure_frac": (
        float, 0.9,
        "Fraction of device memory at which a step's live bytes raise a "
        "memory_pressure telemetry event (observability/memory.py). "
        "Device capacity is the card's total memory, else "
        "device_memory_bytes."),
    "device_memory_bytes": (
        int, 0,
        "Device memory capacity override in bytes (observability."
        "memory.device_memory_limit), for the memory planner's budget "
        "and for backends that report none (the CPU). 0 = the card's "
        "total memory, none on the CPU."),
    "serving_calibration_batches": (
        int, 8,
        "Representative batches the post-training-quantization "
        "calibrator (paddle_tpu_torch.inference.quantize) runs through "
        "the frozen fp32 program to collect per-tensor abs-max ranges "
        "before rewriting conv/fc/matmul ops to int8."),
    "int8_native": (
        str, "auto",
        "Lowering mode of quantized_conv2d/quantized_matmul: '1' = "
        "native int8 GEMMs with int32 accumulation (torch._int_mm, the "
        "card's int8 tensor cores; raises on the CPU, which has no int8 "
        "GEMM in the port), '0' = numerically exact fp32 emulation "
        "(int8 values cast to f32; products <= 127^2 and per-dot "
        "partial sums stay inside the f32 mantissa). 'auto' = native "
        "on CUDA tensors, the emulation on the CPU."),
    "executable_cache_size": (
        int, 128,
        "LRU capacity of the engine's compiled-block cache: one entry, "
        "and on CUDA one captured graph, per (program, feed signature, "
        "fetches, is_test, donation, AMP, cache tag) (reference: the "
        "Executor program cache)."),
    "rpc_deadline_ms": (
        float, 180000.0,
        "Deadline for pserver RPC replies; <=0 disables (reference: "
        "FLAGS_rpc_deadline)."),
    "dispatch_steps": (
        int, 1,
        "Depth of the engine's async dispatch window "
        "(engine/pipeline.py): Executor.run enqueues up to this many "
        "steps without waiting for the card; fetches of steps still in "
        "flight come back as DeferredFetch placeholders, resolved by "
        "Executor.sync(), the window's retire of its oldest step, or the "
        "first host read (np.asarray/float). 1 = the synchronous "
        "feed->step->fetch loop. check_nan_inf under a deeper window "
        "defers its verdict to retire time and names the original step; "
        "the heartbeat reports retired steps, so a deep window never "
        "reads as a hang."),
    "prefetch_depth": (
        int, 2,
        "Batches the PrefetchingFeeder (engine/pipeline.py) stages ahead "
        "of the consumer: a background thread copies batch k+1..k+depth "
        "into pinned host buffers and on to the device on a side stream "
        "while step k runs. 2 = double buffering."),
    "data": (
        str, "",
        "Root directory of real dataset files (dataset/ readers, read "
        "each time a reader starts); empty serves the seeded synthetic "
        "data."),
    "goodput": (
        bool, False,
        "Goodput ledger (observability/goodput.py): charge every "
        "wall-clock second of a training loop to one category (compute, "
        "compile, input_wait, host_sync, idle, ...) through marks at the "
        "engine and pipeline seams, count each cache entry's model FLOPs "
        "once, and publish the goodput.* and mfu.* gauges. Off = one bool "
        "check per seam."),
    "peak_flops": (
        float, 0.0,
        "Peak FLOP/s of the device, for MFU (mfu.mfu = achieved / peak; "
        "mfu.goodput_mfu divides by the whole wall). The caller sets it "
        "for its card and dtype; <=0 skips the two ratio gauges "
        "(mfu.model_flops_per_step and mfu.achieved_flops_per_s still "
        "publish)."),
    "trace_dir": (
        str, "",
        "Profiler trace output directory (profiler.py): torch.profiler's "
        "chrome-trace JSON and the opprof provenance sidecar land here. "
        "Empty = $PADDLE_GPU_TRACE_DIR, else a paddle_gpu_trace folder "
        "under the system's temporary directory."),
    "peak_membw_bytes": (
        float, 0.0,
        "Peak device memory bandwidth in bytes/s for the op-level "
        "roofline (observability/opprof.py): an op is compute-bound "
        "when its arithmetic intensity (FLOPs/byte) sits at or above "
        "the ridge point PEAK_FLOPS / PEAK_MEMBW_BYTES, memory-bound "
        "below it. <=0 (or PEAK_FLOPS unset) downgrades every verdict "
        "to 'unknown' — device time and intensity still report."),
    "opprof": (
        bool, True,
        "Op-level profiling provenance (observability/opprof.py): while "
        "a profiler session is active, every op's lowering runs inside "
        "torch.profiler.record_function('pt.<type>.<blk>_<idx>') so its "
        "kernels are attributed to the framework op, a captured entry's "
        "first run in the session runs eagerly under those ranges (its "
        "replays are joined to them by kernel order), and each cache "
        "entry registers its per-op FLOPs/bytes on its first observed "
        "run. The ranges are host-side only (the computation is "
        "bit-identical, tests/test_torch_opprof.py asserts it) and "
        "entered only during a session; off skips the ranges and the "
        "registration. The captured graph is the same either way, so "
        "the engine does not key its cache on the value."),
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
    "ckpt_replicas": (
        int, 0,
        "Cross-root checkpoint replication factor (checkpoint.py): "
        "after each local atomic publish the writer mirrors the step "
        "dir to up to this many peer roots (CheckpointManager "
        "replica_roots), latest_step() becomes a majority vote across "
        "the local root + replicas (a torn local-only save loses), and "
        "restore() falls back to a peer's byte-identical replica when "
        "the local root is gone or poisoned (disk_fail). 0 = off "
        "(single-root behavior, exactly as before)."),
    "fault_spec": (
        str, "",
        "Deterministic fault-injection schedule "
        "(paddle_tpu_torch.resilience.faultinject): ';'-separated "
        "point@cond:cond entries, e.g. "
        "'step_nan@7;worker_kill@rank1:step12'. Points: step_nan, "
        "step_fail, compile, ckpt_write, worker_kill, worker_hang, "
        "worker_loss (permanent — the supervisor shrinks instead of "
        "restarting), disk_fail (poisons the local checkpoint root). "
        "Empty = no faults (the production default; the check is one "
        "env read)."),
    "zero": (
        bool, False,
        "ZeRO-1 weight-update sharding over the mesh's data axes "
        "(engine cache-miss seam, mesh runs only): optimizer-state "
        "slots (Adam moments, Momentum velocity) are partitioned "
        "across dp ranks, each parameter gradient is reduce-scattered "
        "to its owning shard (parallel/sharding.py zero1_plan), the "
        "update runs on the local shard, and the updated parameter is "
        "all-gathered back replicated. Parameters whose dims the "
        "data-axis product does not divide (scalars, beta-pow "
        "accumulators) keep the replicated all-reduce path. Keyed into "
        "the engine's cache. No-op without a mesh, under gradient "
        "accumulation, and under remat."),
    "grad_bucket_mb": (
        float, 0.0,
        "Bucketed gradient reduction under the ZeRO-1 sharded update "
        "(PADDLE_GPU_ZERO): gradients are packed, in backward "
        "production order, into flat buckets of roughly this many MB, "
        "one reduce_scatter_tensor a bucket, launched as soon as the "
        "bucket fills instead of one collective a gradient. Each rank "
        "receives the same shards as without buckets. <=0 = one "
        "reduce-scatter a gradient."),
    "mesh": (
        str, "",
        "Device mesh for the SPMD executor path, as 'axis=size' pairs "
        "('dp=8', 'dp=4,tp=2'; one axis may be -1 = every rank of the "
        "world left over). When set, plain Executor.run runs the step "
        "over this mesh of torch.distributed ranks — batch sharded over "
        "the data axes, state per the sharding rules (replicated without "
        "rules) — with the gradient collectives derived from the "
        "placements. Empty = one process, no mesh (the default; "
        "bit-identical to a 1-rank mesh)."),
    "dist_strategy": (
        str, "",
        "Distributed-training transport ParallelExecutor selects: '' or "
        "'dp' = SPMD data parallelism over every rank of the world (the "
        "default), 'mesh' = SPMD over the PADDLE_GPU_MESH mesh with the "
        "sharding rules' placements; 'pserver'/'nccl2' go through the "
        "DistributeTranspiler (paddle_tpu_torch.transpiler, "
        "distributed/ps.py), and ParallelExecutor refuses them."),
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
