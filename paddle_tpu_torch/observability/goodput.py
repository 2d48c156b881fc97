"""Goodput ledger: charge every wall-clock second.

Port of ``paddle_tpu/observability/goodput.py`` (pure Python, kept as the
port's own copy), without the MFU attribution (``note_flops``, the
``mfu.*`` gauges, ``record_compile_flops`` at ``goodput.py:281-297``),
which needs model FLOPs that no port seam notes yet, and without the
incarnation read from the supervised launcher's restart count: the port
has no launcher yet, so a tracker's ``attempt`` is what its caller
passes (0 by default).

- ``GoodputTracker`` is an interval ledger over ``time.monotonic()``.
  Seams *mark* category boundaries in temporal order; a charge never
  overlaps a previous one (the cursor clips it; fully-overlapped charges
  are rejected and counted), gaps between charges are filled as
  ``idle``, and charges tagged with a stale incarnation are fenced out.
  Conservation is exact by construction: the category sums equal
  ``cursor - t0`` to float precision.
- ``note_serving_request`` is the serving side: the batch-mean executing
  fraction of each request's wall, published as the
  ``goodput.serving_request_frac`` gauge.

The engine seams that mark the process ``tracker``, the
``PADDLE_GPU_GOODPUT`` gate they check and the MFU attribution come with
the port's engine features (ROADMAP Queue 1 item 4); serving publishes
its request goodput through the metrics gate.
"""

import contextlib
import threading
import time

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

    # -- reporting ---------------------------------------------------------
    def snapshot(self):
        with self._lock:
            cats = dict(self._ms)
            wall = 0.0 if self._t0 is None else (self._cursor - self._t0) * 1e3
            overlap = self._overlap_rejected
            fenced = self._fenced
            attempt = self.attempt
        good = sum(cats[c] for c in GOODPUT_CATEGORIES)
        frac = (good / wall) if wall > 0 else 1.0
        return {
            "wall_ms": wall,
            "goodput_ms": good,
            "badput_ms": wall - good,
            "goodput_frac": frac,
            "categories": cats,
            "attempt": attempt,
            "overlap_rejected": overlap,
            "fenced": fenced,
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
        gauges, so snap events and ``snapshot_text()`` see
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
        return snap


#: Process-wide tracker. Reset via ``reset()`` below (wired into
#: ``observability.reset()`` for test isolation).
tracker = GoodputTracker()


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


def reset():
    tracker.reset()
