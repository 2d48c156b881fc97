"""Goodput ledger: charge every wall-clock second, and attribute MFU.

Port of ``paddle_tpu/observability/goodput.py`` (pure Python, kept as the
port's own copy), without the incarnation read from the supervised
launcher's restart count: the port has no launcher yet, so a tracker's
``attempt`` is what its caller passes (0 by default).

- ``GoodputTracker`` is an interval ledger over ``time.monotonic()``.
  Seams *mark* category boundaries in temporal order; a charge never
  overlaps a previous one (the cursor clips it; fully-overlapped charges
  are rejected and counted), gaps between charges are filled as
  ``idle``, and charges tagged with a stale incarnation are fenced out.
  Conservation is exact by construction: the category sums equal
  ``cursor - t0`` to float precision.
- The engine's seams, behind the ``PADDLE_GPU_GOODPUT`` gate
  (``enabled()``): ``mark("compile")`` after a run that captured a
  graph, ``mark("input_wait")`` in the prefetching feeder,
  ``mark("host_sync")`` at a dispatch window's retire, and
  ``step_boundary()`` at the end of every ``Executor.run``, which charges
  the rest of the step as ``compute``, counts it and publishes the
  ``goodput.*`` and ``mfu.*`` gauges.
- MFU (:191-297): ``note_flops`` adds one run's model FLOPs. Where the
  reference reads them from XLA's ``cost_analysis()``, the port's engine
  counts them once a cache entry, on its first (eager) run, with
  ``torch.utils.flop_counter.FlopCounterMode``; the flash kernels, ctypes
  launches the counter cannot see, add their own count from their shapes
  and valid keys (``kernels/flash_attention.py`` ``count_flops``).
  ``mfu.mfu`` is achieved FLOP/s over compute time against the
  ``peak_flops`` flag; ``mfu.goodput_mfu`` divides by the whole wall.
- ``note_serving_request`` is the serving side: the batch-mean executing
  fraction of each request's wall, published as the
  ``goodput.serving_request_frac`` gauge.
"""

import contextlib
import threading
import time

from paddle_tpu_torch import flags

#: Exhaustive, mutually-exclusive wall-clock categories. Every charged
#: second lands in exactly one; ``idle`` absorbs the gaps between marks.
CATEGORIES = (
    "compute",           # steps making forward progress
    "compile",           # cache-miss build of an executable or kernel
    "input_wait",        # blocked on the input pipeline (prefetch queue)
    "host_sync",         # deferred-fetch retire / device_get barriers
    "ckpt_critical",     # blocking part of a checkpoint save
    "rollback_replay",   # re-running steps already paid for once
    "restart_downtime",  # process death -> relaunch -> resume restore
    "shrink_rejit",      # elastic shrink re-plan + re-jit on the new mesh
    "preempt_drain",     # graceful-eviction drain + final checkpoint
    "idle",              # wall clock no seam claimed
)

#: The categories that count as forward progress. ``input_wait`` and
#: ``host_sync`` are pipeline overlap, not waste — the clean-run
#: acceptance bar (>= 0.99) is over this sum.
GOODPUT_CATEGORIES = ("compute", "input_wait", "host_sync")

_ENABLED = None


def enabled():
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = bool(flags.get_flag("goodput"))
    return _ENABLED


def set_enabled(value=None):
    """Force the gate, or re-read the flag when ``value`` is None."""
    global _ENABLED
    _ENABLED = bool(flags.get_flag("goodput")) if value is None else bool(value)


class GoodputTracker:
    """Monotonic, non-overlapping, exhaustive interval ledger.

    ``charge(category, start, end)`` is the primitive: clipped against
    the cursor, gap-filled with ``idle``, fenced by incarnation.
    ``mark(category)`` is the sequential helper the seams use: it
    charges ``[last_mark, now)`` and advances — callers never compute
    intervals themselves, so overlap is impossible on the hot path.
    """

    def __init__(self, attempt=0):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.attempt = int(attempt)
        self._reset_locked()

    def _reset_locked(self):
        self._ms = {c: 0.0 for c in CATEGORIES}
        self._t0 = None
        self._cursor = None
        self._last_mark = None
        self._overlap_rejected = 0
        self._fenced = 0
        self._steps = 0
        self._flops_total = 0.0
        self._flops_per_step = 0.0

    def reset(self, attempt=None):
        """Drop all charges (e.g. after a warmup window) and re-anchor
        lazily at the next charge."""
        with self._lock:
            if attempt is not None:
                self.attempt = int(attempt)
            self._reset_locked()

    # -- primitive ---------------------------------------------------------
    def charge(self, category, start, end, attempt=None):
        """Charge ``[start, end)`` (``time.monotonic()`` seconds) to
        ``category``. Returns the ms actually charged (0.0 when fenced,
        rejected, or fully clipped)."""
        redirect = getattr(self._local, "redirect", None)
        if redirect:
            category = redirect.get(category, category)
        if category not in self._ms:
            raise ValueError("unknown goodput category %r" % (category,))
        with self._lock:
            if attempt is not None and int(attempt) != self.attempt:
                self._fenced += 1
                return 0.0
            if end <= start:
                self._overlap_rejected += 1
                return 0.0
            if self._t0 is None:
                self._t0 = self._cursor = start
            if end <= self._cursor:
                # fully behind the cursor: someone already owns this wall
                self._overlap_rejected += 1
                return 0.0
            if start < self._cursor:
                start = self._cursor  # clip the overlapped prefix
            elif start > self._cursor:
                self._ms["idle"] += (start - self._cursor) * 1000.0
            charged = (end - start) * 1000.0
            self._ms[category] += charged
            self._cursor = end
            return charged

    # -- sequential marks (hot path) ---------------------------------------
    def mark(self, category, now=None):
        """Charge ``[last_mark, now)`` to ``category`` and advance the
        mark. The first mark only anchors (nothing to charge yet) —
        that lazily excludes pre-training setup from the ledger."""
        now = time.monotonic() if now is None else now
        last, self._last_mark = self._last_mark, now
        if last is None:
            with self._lock:
                if self._t0 is None:
                    self._t0 = self._cursor = now
            return 0.0
        return self.charge(category, last, now)

    @contextlib.contextmanager
    def redirected(self, mapping):
        """Thread-locally remap categories for the duration — the
        training loop wraps replayed steps in
        ``{"compute": "rollback_replay"}`` so re-earned progress is not
        double-counted as goodput."""
        prev = getattr(self._local, "redirect", None)
        merged = dict(prev or {})
        merged.update(mapping)
        self._local.redirect = merged
        try:
            yield
        finally:
            self._local.redirect = prev

    # -- MFU ---------------------------------------------------------------
    def note_flops(self, flops):
        """Accumulate one run's model FLOPs (counted once a cache entry)."""
        if flops and flops > 0:
            with self._lock:
                self._flops_total += float(flops)

    def note_step(self):
        with self._lock:
            self._steps += 1
            if self._steps:
                self._flops_per_step = self._flops_total / self._steps

    # -- reporting ---------------------------------------------------------
    def snapshot(self):
        with self._lock:
            cats = dict(self._ms)
            wall = 0.0 if self._t0 is None else (self._cursor - self._t0) * 1e3
            steps = self._steps
            flops_total = self._flops_total
            flops_per_step = self._flops_per_step
            overlap = self._overlap_rejected
            fenced = self._fenced
            attempt = self.attempt
        good = sum(cats[c] for c in GOODPUT_CATEGORIES)
        frac = (good / wall) if wall > 0 else 1.0
        compute_s = cats["compute"] / 1e3
        wall_s = wall / 1e3
        achieved = (flops_total / compute_s) if compute_s > 0 else 0.0
        peak = float(flags.get_flag("peak_flops") or 0.0)
        return {
            "wall_ms": wall,
            "goodput_ms": good,
            "badput_ms": wall - good,
            "goodput_frac": frac,
            "categories": cats,
            "steps": steps,
            "attempt": attempt,
            "overlap_rejected": overlap,
            "fenced": fenced,
            "mfu": {
                "model_flops_per_step": flops_per_step,
                "total_flops": flops_total,
                "achieved_flops_per_s": achieved,
                "peak_flops": peak,
                # None, not 0.0, when no peak is configured: an MFU of
                # zero is a measurement, absence is not
                "mfu": (achieved / peak) if peak > 0 else None,
                "goodput_mfu": (flops_total / wall_s / peak)
                if (peak > 0 and wall_s > 0) else None,
            },
        }

    def top_badput(self):
        """``(category, ms)`` of the largest non-goodput category —
        the one-line attribution answer."""
        snap = self.snapshot()
        bad = [(c, m) for c, m in snap["categories"].items()
               if c not in GOODPUT_CATEGORIES]
        bad.sort(key=lambda cm: -cm[1])
        return bad[0] if bad else ("idle", 0.0)

    def publish(self, registry=None):
        """Mirror the ledger into the metrics registry as ``goodput.*``
        and ``mfu.*`` gauges, so snap events and ``snapshot_text()`` see
        it with zero extra plumbing."""
        if registry is None:
            from paddle_tpu_torch import observability as obs
            registry = obs.registry
        snap = self.snapshot()
        registry.set_gauge("goodput.frac", snap["goodput_frac"])
        registry.set_gauge("goodput.wall_ms", snap["wall_ms"])
        registry.set_gauge("goodput.badput_ms", snap["badput_ms"])
        registry.set_gauge("goodput.attempt", float(snap["attempt"]))
        for c, v in snap["categories"].items():
            registry.set_gauge("goodput.%s_ms" % c, v)
        mfu = snap["mfu"]
        registry.set_gauge("mfu.model_flops_per_step",
                           mfu["model_flops_per_step"])
        registry.set_gauge("mfu.achieved_flops_per_s",
                           mfu["achieved_flops_per_s"])
        if mfu["peak_flops"] > 0:
            registry.set_gauge("mfu.peak_flops", mfu["peak_flops"])
            registry.set_gauge("mfu.mfu", mfu["mfu"])
            registry.set_gauge("mfu.goodput_mfu", mfu["goodput_mfu"])
        return snap


#: Process-wide tracker the seams feed. Reset via ``reset()`` below
#: (wired into ``observability.reset()`` for test isolation).
tracker = GoodputTracker()


def mark(category, now=None):
    """Module-level hot-path mark: one bool check when the flag is down."""
    if not enabled():
        return 0.0
    return tracker.mark(category, now)


def note_flops(flops):
    if enabled():
        tracker.note_flops(flops)


def step_boundary():
    """End-of-step seam: charge the rest of the step as ``compute``,
    count the step, and refresh the published gauges."""
    if not enabled():
        return
    tracker.mark("compute")
    tracker.note_step()
    try:
        tracker.publish()
    except Exception:
        pass  # telemetry must never take down a step that succeeded


def note_serving_request(mean_frac, trace_id=None):
    """Serving-side request goodput: publish the batch-mean executing
    fraction as the ``goodput.serving_request_frac`` gauge, with the
    WORST request's trace ID riding as the exemplar — the request-level
    ledger entry links straight to the trace that wasted its wall.
    Gated by the metrics flag (via obs.set_gauge), not the goodput
    flag: serving has no interval ledger to keep consistent."""
    from paddle_tpu_torch import observability as obs

    obs.set_gauge("goodput.serving_request_frac", mean_frac,
                  exemplar=trace_id)


def publish():
    """Refresh the ``goodput.*`` / ``mfu.*`` gauges (no-op when the flag
    is down; failures never propagate)."""
    if not enabled():
        return None
    try:
        return tracker.publish()
    except Exception:
        return None


def snapshot():
    return tracker.snapshot()


def reset():
    global _ENABLED
    tracker.reset()
    _ENABLED = None


flags.on_change("goodput", lambda _v: set_enabled(None))
