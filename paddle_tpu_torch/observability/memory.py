"""Device-memory accounting: port of ``paddle_tpu/observability/memory.py``
on the CUDA caching allocator.

Three signal sources, recorded into the shared metrics registry at the
engine seams (engine/executor.py) so a snapshot, or a streaming JSONL
"snap" event, carries memory next to latency:

* **Live bytes** (``record_step_memory``, every step with metrics on):
  on the card the allocator's live bytes
  (``torch.cuda.memory_stats()['allocated_bytes.all.current']``, what
  ``torch.cuda.memory_allocated`` reads), split into *scope-resident*
  bytes (parameters, optimizer moments, BN stats: the tensors a Scope
  pins between runs, by storage) and *transient* bytes (feeds, fetches,
  activations, the graph pool), plus a high-watermark gauge. On the
  CPU, where no allocator counts, the census is the scope's tensors and
  the tensors the caller names as the step's own (``step_tensors``:
  the entry's feed buffers and fetches). Only host-side counters are
  read: no tensor, and no synchronize.

* **Allocator stats**: the allocator's current and peak bytes
  (``hbm.device_bytes_in_use``, ``hbm.device_peak_bytes_in_use``), which
  also see what other code in the process allocated; the peak feeds the
  watermark, so ``peak_hbm_bytes()`` is at least
  ``torch.cuda.max_memory_allocated`` since the last reset of both.

* **First-run peaks** (``record_compile_memory``), once per cache entry:
  the reference reads XLA's ``memory_analysis()`` of the compiled
  executable; the port has no compile, so on the card the peak is the
  MEASURED one of the entry's eager first run (its argument bytes plus
  what the allocator's peak grew during the run), and on the CPU the
  STATIC liveness estimate of the block the entry runs
  (``analysis/memory.py`` ``analyze_liveness``). ``hbm.compile_arg_bytes``
  (feeds and state in) and ``hbm.compile_out_bytes`` (fetches and state
  out) are exact on both.

When a step's live bytes cross ``PADDLE_GPU_MEMORY_PRESSURE_FRAC`` of
device memory, a ``memory_pressure`` instant event lands in the
trace/sink (edge triggered: once per excursion, not per step). Device
capacity is the card's total memory, overridable by
``PADDLE_GPU_DEVICE_MEMORY_BYTES`` (the only capacity the CPU has).

Gauges (all bytes): ``hbm.live_bytes``, ``hbm.resident_bytes``,
``hbm.transient_bytes``, ``hbm.live_bytes_peak``,
``hbm.device_bytes_in_use``, ``hbm.device_peak_bytes_in_use``,
``hbm.device_bytes_limit``, ``hbm.compile_arg_bytes``,
``hbm.compile_out_bytes``, ``hbm.compile_temp_bytes``,
``hbm.compile_peak_bytes`` (max over entries) and the per-entry
``hbm.compile_peak_bytes_per_exe`` histogram.
"""

import threading

import torch

from paddle_tpu_torch import flags

__all__ = ["device_memory_limit", "peak_hbm_bytes", "record_compile_memory",
           "record_compile_stats", "record_step_memory", "reset_peaks",
           "scope_resident_bytes", "tensor_bytes", "CompiledMemoryStats"]

_lock = threading.Lock()
_state = {"live_peak": 0, "compile_peak": 0, "over_pressure": False}


def _obs():
    # Late import: observability/__init__ imports this module.
    from paddle_tpu_torch import observability

    return observability


def reset_peaks():
    """Zero the watermark state (so ``peak_hbm_bytes()`` attributes per
    model)."""
    with _lock:
        _state["live_peak"] = 0
        _state["compile_peak"] = 0
        _state["over_pressure"] = False


def peak_hbm_bytes():
    """The high-watermark since the last ``reset_peaks()``: max of the
    live peak and the first-run peak, the "how much device memory did
    this model need" number."""
    with _lock:
        return max(_state["live_peak"], _state["compile_peak"])


def _cuda_device(device):
    """``device`` as a CUDA ``torch.device``, or None (the CPU; a None
    device is the current card when CUDA is available)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_memory_limit(device=None):
    """Device memory capacity in bytes, or None when unknowable: the
    ``PADDLE_GPU_DEVICE_MEMORY_BYTES`` override wins, else the card's
    total memory (``torch.cuda.get_device_properties``) for a CUDA
    ``device`` (default: the current card when CUDA is available), and
    None on the CPU."""
    override = int(flags.get_flag("device_memory_bytes"))
    if override > 0:
        return override
    device = _cuda_device(device)
    if device is None:
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def _storage_key(t):
    """(storage address, bytes) of a tensor, its local shard for a
    DTensor; None for anything else."""
    local = getattr(t, "_local_tensor", None)
    if local is not None:
        t = local
    if not isinstance(t, torch.Tensor):
        return None
    try:
        storage = t.untyped_storage()
        return storage.data_ptr(), int(storage.nbytes())
    except Exception:
        return None


def tensor_bytes(tensors, seen=None, device_type=None):
    """Bytes of the distinct storages under ``tensors`` (a SelectedRows
    counts its rows and values), of those on ``device_type`` only when
    given; ``seen`` (a set of storage addresses) skips those already
    counted and collects the new ones."""
    seen = set() if seen is None else seen
    total = 0
    for t in tensors:
        parts = ([t.rows, t.values] if hasattr(t, "rows")
                 and hasattr(t, "values") else [t])
        for p in parts:
            if (device_type is not None and isinstance(p, torch.Tensor)
                    and p.device.type != device_type):
                continue
            key = _storage_key(p)
            if key is None or key[0] in seen:
                continue
            seen.add(key[0])
            total += key[1]
    return total


# -- first-run peaks ---------------------------------------------------------
class CompiledMemoryStats:
    """The fields of the reference's ``CompiledMemoryStats`` that
    ``record_compile_stats`` reads, for an entry of the port."""

    __slots__ = ("argument_size_in_bytes", "output_size_in_bytes",
                 "temp_size_in_bytes", "alias_size_in_bytes")

    def __init__(self, argument_size_in_bytes=0, output_size_in_bytes=0,
                 temp_size_in_bytes=0, alias_size_in_bytes=0):
        self.argument_size_in_bytes = int(argument_size_in_bytes)
        self.output_size_in_bytes = int(output_size_in_bytes)
        self.temp_size_in_bytes = int(temp_size_in_bytes)
        self.alias_size_in_bytes = int(alias_size_in_bytes)


def record_compile_stats(mem_stats, label=None):
    """Record one entry's memory stats (a ``CompiledMemoryStats``, or any
    object with its fields). Safe on None/odd shapes: what reports
    nothing records nothing."""
    if mem_stats is None:
        return None
    obs = _obs()
    try:
        arg = int(getattr(mem_stats, "argument_size_in_bytes", 0) or 0)
        out = int(getattr(mem_stats, "output_size_in_bytes", 0) or 0)
        tmp = int(getattr(mem_stats, "temp_size_in_bytes", 0) or 0)
        alias = int(getattr(mem_stats, "alias_size_in_bytes", 0) or 0)
    except Exception:
        return None
    # Aliased (in-place written state) bytes are counted once: they live
    # in the arguments and the outputs reuse them.
    peak = arg + max(0, out - alias) + tmp
    obs.set_gauge("hbm.compile_arg_bytes", arg)
    obs.set_gauge("hbm.compile_out_bytes", out)
    obs.set_gauge("hbm.compile_temp_bytes", tmp)
    obs.observe("hbm.compile_peak_bytes_per_exe", peak)
    with _lock:
        _state["compile_peak"] = max(_state["compile_peak"], peak)
        obs.set_gauge("hbm.compile_peak_bytes", _state["compile_peak"])
    if label:
        obs.event("compile_memory", label=str(label), arg_bytes=arg,
                  out_bytes=out, temp_bytes=tmp, peak_bytes=peak)
    return peak


def record_compile_memory(arg_bytes, out_bytes, alias_bytes=0,
                          grown_bytes=None, static_peak_bytes=None,
                          label=None):
    """Record an entry's first-run memory. ``arg_bytes``: its feeds and
    state inputs; ``out_bytes``: its fetches and state outputs, of which
    ``alias_bytes`` were written in place into state inputs. The peak is
    ``arg_bytes + grown_bytes`` when the card measured how far the
    allocator's peak grew above what was allocated before the run
    (``grown_bytes``), else ``static_peak_bytes`` (the CPU's liveness
    estimate of the block); the temporaries are what the peak holds
    beyond the arguments and the new outputs. Any failure records
    nothing: telemetry never takes down a step that ran."""
    try:
        arg, out, alias = int(arg_bytes), int(out_bytes), int(alias_bytes)
        if grown_bytes is not None:
            peak = arg + max(0, int(grown_bytes))
        elif static_peak_bytes is not None:
            peak = int(static_peak_bytes)
        else:
            return None
        tmp = max(0, peak - arg - max(0, out - alias))
    except Exception:
        return None
    return record_compile_stats(
        CompiledMemoryStats(arg, out, tmp, alias), label=label)


# -- live bytes ---------------------------------------------------------------
def scope_resident_bytes(scope, device_type=None):
    """(storage addresses, bytes) of the tensors ``scope`` pins (walking
    the parent chain), on ``device_type`` only when given: the
    parameter/optimizer/BN state the engine keeps resident between
    runs."""
    seen, total = set(), 0
    s = scope
    while s is not None:
        total += tensor_bytes(list(s._vars.values()), seen, device_type)
        s = s.parent
    return seen, total


def record_step_memory(scope=None, step=None, device=None,
                       step_tensors=()):
    """The per-step seam: live bytes (the allocator's on the card, the
    census of the scope's and ``step_tensors`` on the CPU), split
    resident vs transient, the watermark, the allocator's stats, and the
    edge-triggered ``memory_pressure`` event. Returns the gauge dict
    (also recorded into the registry)."""
    obs = _obs()
    cuda = _cuda_device(device)
    resident_ids, resident = set(), 0
    if scope is not None:
        try:
            resident_ids, resident = scope_resident_bytes(
                scope, "cuda" if cuda is not None else None)
        except Exception:
            pass
    stats = None
    if cuda is not None:
        try:
            stats = torch.cuda.memory_stats(cuda)
        except Exception:
            return None
        total = int(stats.get("allocated_bytes.all.current", 0))
    else:
        total = resident + tensor_bytes(step_tensors, set(resident_ids))
    transient = max(0, total - resident)
    obs.set_gauge("hbm.live_bytes", total)
    obs.set_gauge("hbm.resident_bytes", resident)
    obs.set_gauge("hbm.transient_bytes", transient)
    peak_in_use = None
    if stats:
        obs.set_gauge("hbm.device_bytes_in_use", total)
        peak_in_use = stats.get("allocated_bytes.all.peak")
        if peak_in_use is not None:
            obs.set_gauge("hbm.device_peak_bytes_in_use", int(peak_in_use))
    with _lock:
        _state["live_peak"] = max(_state["live_peak"], total,
                                  int(peak_in_use or 0))
        live_peak = _state["live_peak"]
    obs.set_gauge("hbm.live_bytes_peak", live_peak)

    limit = device_memory_limit(device=cuda)
    if limit:
        obs.set_gauge("hbm.device_bytes_limit", int(limit))
        frac = float(flags.get_flag("memory_pressure_frac"))
        over = frac > 0 and total > frac * limit
        with _lock:
            crossed = over and not _state["over_pressure"]
            _state["over_pressure"] = over
        if crossed:
            obs.inc("memory.pressure_events")
            obs.event("memory_pressure", live_bytes=total,
                      limit_bytes=int(limit), frac=frac, step=step)
    return {"live_bytes": total, "resident_bytes": resident,
            "transient_bytes": transient, "live_bytes_peak": live_peak}
