"""Admission control & graceful degradation policy for the serving
stack.

Port of ``paddle_tpu/inference/admission.py`` (pure Python, kept as the
port's own copy). The fleet router that trips ``CircuitBreaker``s
(``paddle_tpu/resilience/elastic.py:131``) comes in a later slice, and
with it the ``fleet_breaker_*`` flags that give a breaker its defaults;
until then a ``CircuitBreaker`` takes ``failures`` and ``reset_s`` from
its caller.

The continuous-batching server (``serving.py``) and the fleet router
can *observe* overload — SLO burn windows,
goodput attribution, per-request traces — but observation alone does
not keep a queue bounded.  This module holds the small, dependency-free
policy pieces they share:

* typed admission errors (:class:`Rejected`, :class:`DeadlineExceeded`)
  so callers can distinguish "the server turned me away" from "the
  model failed" without string matching;
* :class:`AdmissionGate` — a bounded-queue check plus a predictive
  wait estimate (queue depth x EWMA batch latency) that lets the
  server reject a deadlined request at *enqueue* time when it is
  already doomed, instead of burning a slot and failing it later;
* :class:`CircuitBreaker` — the classic closed / open / half-open
  state machine, one per fleet worker, tripping on consecutive
  failures and re-admitting the worker through a single half-open
  probe once a cool-down has passed.

Everything here is pure policy: no threads, no queues, no engine
imports.  The mechanisms that *act* on these decisions stay in the
server and the router, next to the locks they need.  All knobs default
to "off" (0 / unbounded), and every class degrades to a no-op at those
defaults so the protected path stays bit-identical to the unprotected
one until a flag arms it.
"""

import threading
import time

from paddle_tpu_torch import flags


class AdmissionError(RuntimeError):
    """Base class for typed admission failures.

    Subclasses RuntimeError so pre-admission callers that already catch
    the server's coarse errors keep working unchanged.
    """


class Rejected(AdmissionError):
    """The server refused the request at (or after) enqueue.

    ``reason`` is one of:

    * ``"queue_full"``      — bounded queue at capacity, nothing to evict;
    * ``"predicted_late"``  — estimated queue wait already exceeds the
      request's own deadline, so admitting it would only waste a slot;
    * ``"shed"``            — dropped by priority-based load shedding
      while the SLO fast window is burning (or evicted from the queue
      to make room for a higher-priority request).
    """

    def __init__(self, reason, message=None, trace_id=None):
        super(Rejected, self).__init__(
            message or ("request rejected (%s)" % reason))
        self.reason = reason
        self.trace_id = trace_id


class DeadlineExceeded(AdmissionError):
    """The request's ``deadline_ms`` elapsed before it was served.

    Raised from the future (never from ``submit`` itself): the request
    was admitted but expired in the queue, either noticed by the
    batcher as it popped the entry or evicted early (CoDel-style) to
    relieve pressure on a full queue.
    """

    def __init__(self, message=None, trace_id=None, deadline_ms=None,
                 waited_ms=None):
        super(DeadlineExceeded, self).__init__(
            message or "deadline exceeded before dispatch")
        self.trace_id = trace_id
        self.deadline_ms = deadline_ms
        self.waited_ms = waited_ms


class AdmissionGate:
    """Bounded-queue + predictive-wait admission policy.

    The gate owns two facts the server feeds it:

    * ``queue_limit`` — a hard bound on queued requests (0 keeps the
      pre-admission unbounded behavior);
    * an EWMA of recent *batch* latencies (``note_batch``), from which
      :meth:`predicted_wait_ms` estimates how long a newcomer would sit
      in the queue: batches ahead of it (queued rows / max bucket,
      rounded up) plus its own batch, each costing one EWMA.

    The estimate is deliberately coarse — it exists to refuse requests
    that are *obviously* doomed (estimated wait already past their
    deadline), not to schedule precisely.  Before the first batch
    completes the EWMA is unknown and the gate predicts 0.0, i.e. it
    admits: optimism at cold start beats rejecting the warmup traffic
    that would have calibrated it.
    """

    def __init__(self, queue_limit=None, alpha=0.2):
        if queue_limit is None:
            queue_limit = int(flags.get_flag("queue_limit"))
        self.queue_limit = max(0, int(queue_limit))
        self.alpha = float(alpha)
        self._ewma_ms = None

    @property
    def batch_ewma_ms(self):
        """EWMA of batch wall time in ms (None until the first batch)."""
        return self._ewma_ms

    def note_batch(self, batch_ms):
        """Fold one completed batch's wall time into the EWMA."""
        batch_ms = float(batch_ms)
        if self._ewma_ms is None:
            self._ewma_ms = batch_ms
        else:
            a = self.alpha
            self._ewma_ms = (1.0 - a) * self._ewma_ms + a * batch_ms

    def predicted_wait_ms(self, queued_rows, max_bucket):
        """Estimated ms until a request enqueued NOW would complete."""
        if self._ewma_ms is None:
            return 0.0
        max_bucket = max(1, int(max_bucket))
        batches_ahead = -(-int(queued_rows) // max_bucket)  # ceil
        return (batches_ahead + 1) * self._ewma_ms

    def over_limit(self, queue_depth):
        """True when the bounded queue is at (or past) capacity."""
        return self.queue_limit > 0 and queue_depth >= self.queue_limit


#: CircuitBreaker states.
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-worker consecutive-failure breaker with a half-open probe.

    * CLOSED    — healthy; every request is allowed.  ``failures``
      consecutive recorded failures trip it OPEN.
    * OPEN      — the worker is out of rotation; :meth:`allow` refuses
      until ``reset_s`` has elapsed since the trip, then transitions to
      HALF_OPEN and hands out exactly one probe.
    * HALF_OPEN — one request (the probe) is in flight.  Its success
      closes the breaker; its failure re-opens it and restarts the
      cool-down.  Further :meth:`allow` calls while the probe is
      outstanding return False, so a sick worker sees at most one
      request per ``reset_s``.

    The probe token is consumed by the ``allow`` call that returns True
    — callers must only invoke ``allow`` for a worker they will
    actually use if it answers yes.  ``failures <= 0`` disables the
    breaker entirely (``allow`` is always True, nothing ever trips),
    which keeps the default fleet behavior identical to pre-breaker
    builds.
    """

    def __init__(self, failures, reset_s, name="worker",
                 clock=time.monotonic):
        self.failures = int(failures)
        self.reset_s = float(reset_s)
        self.name = name
        self.clock = clock
        self.trips = 0
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False
        self._lock = threading.Lock()

    @property
    def state(self):
        return self._state

    def allow(self, now=None):
        """May a request be routed to this worker right now?"""
        if self.failures <= 0:
            return True
        if now is None:
            now = self.clock()
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if now - self._opened_at < self.reset_s:
                    return False
                self._state = HALF_OPEN
                self._probing = True
                return True  # the single half-open probe
            # HALF_OPEN: probe already outstanding
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self):
        """A request on this worker completed: reset (and close)."""
        if self.failures <= 0:
            return
        closed = False
        with self._lock:
            self._consecutive = 0
            self._probing = False
            if self._state != CLOSED:
                self._state = CLOSED
                closed = True
        if closed:
            self._event("health.breaker_closed")

    def record_failure(self, now=None):
        """A request on this worker failed: count it, maybe trip."""
        if self.failures <= 0:
            return
        if now is None:
            now = self.clock()
        tripped = False
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN:
                # the probe failed: back to OPEN, restart the cool-down
                self._state = OPEN
                self._opened_at = now
                self._probing = False
            elif (self._state == CLOSED
                  and self._consecutive >= self.failures):
                self._state = OPEN
                self._opened_at = now
                self.trips += 1
                tripped = True
        if tripped:
            self._event("health.breaker_open")

    def _event(self, name):
        from paddle_tpu_torch import observability as obs

        obs.inc("fleet.breaker_trips" if name.endswith("open")
                else "fleet.breaker_closes")
        obs.event(name, worker=self.name, trips=self.trips,
                  threshold=self.failures, reset_s=self.reset_s)
