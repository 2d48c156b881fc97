"""Health & liveness layer: the step counter, heartbeats, and the serving
SLO monitor.

Port of ``paddle_tpu/observability/health.py`` (pure Python, kept as the
port's own copy), in two of its three pieces:

* **HeartbeatEmitter** — a per-process daemon thread that periodically
  writes ``health.heartbeat`` events (monotonic step counter, current
  span phase, host RSS, serving queue depth) through the sink /
  flight-recorder path and flushes the sink so a live tail sees them.
  Gated by ``PADDLE_GPU_HEARTBEAT_MS``. Heartbeats bypass the
  ``PADDLE_GPU_METRICS`` gate on purpose: liveness is not optional
  telemetry (the ``health.heartbeats`` *counter* still rides the gate).
  A beat also carries ``hbm_peak_bytes``, the device-memory watermark
  of ``observability/memory.py`` (``peak_hbm_bytes``), once it is
  nonzero.

* **SloMonitor** — serving-side multi-window burn-rate alerting (the
  SRE fast/slow-window recipe) over per-request latencies against a
  configured SLO (``PADDLE_GPU_SERVING_SLO_MS``): burn rate = the
  window's violation fraction over the error budget (1 − target);
  sustained burn in BOTH windows fires an edge-triggered
  ``health.slo_burn`` event and flips ``InferenceServer.health()``
  unhealthy — the load-balancer readiness probe.

The supervisor side of the reference (``RankHealth`` /
``HealthMonitor``, the hung-worker classifier over heartbeat files)
comes with the port's launcher (ROADMAP Queue 1 item 11).

The engine's per-step calls are ``note_step()`` (a synchronous step), or
``note_step_enqueued()`` and, at the window's retire,
``note_step_retired()``: one int increment and one clock read each;
emitting runs on the daemon thread. A beat carries both counters, and
its ``step`` is the retired one.
"""

import collections
import os
import threading
import time

HEARTBEAT_EVENT = "health.heartbeat"

# -- the step counters the heartbeat reports --------------------------------
# Plain dict mutation under the GIL: these notes are the only calls on the
# engine's step path and must stay in the ns regime. Multi-step dispatch
# (engine/pipeline.py) splits "a step happened" into two edges: ENQUEUED
# when the host hands the step to the card's stream, RETIRED when its
# results are read. The heartbeat's "step" is the RETIRED count: an
# N-deep window advances its enqueue counter ahead of retirement without
# reading as a stall, while a wedged card stalls the retire edge however
# deep the window (health.py:105-133).
_step_state = {"steps": 0, "enqueued": 0, "ts": None, "enq_ts": None}


def note_step():
    """Record one synchronously completed engine step (enqueue and retire
    are the same edge at dispatch depth 1)."""
    note_step_enqueued()
    note_step_retired()


def note_step_enqueued():
    """The host enqueued a step on the card (its results may still be in
    flight)."""
    _step_state["enqueued"] += 1
    _step_state["enq_ts"] = time.monotonic()


def note_step_retired():
    """An enqueued step's results were read (window retire or sync)."""
    _step_state["steps"] += 1
    _step_state["ts"] = time.monotonic()


def step_count():
    """Retired steps: the liveness counter a watchdog judges."""
    return _step_state["steps"]


def enqueued_count():
    return _step_state["enqueued"]


def reset_steps():
    """Test isolation for the process-local step counters."""
    _step_state["steps"] = 0
    _step_state["enqueued"] = 0
    _step_state["ts"] = None
    _step_state["enq_ts"] = None


def host_rss_bytes():
    """This process's resident set size, or None where unreadable."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        # ru_maxrss is KiB on Linux (a peak, not current — close enough
        # for the trend the heartbeat carries)
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return None


# -- heartbeat emitter -------------------------------------------------------
class HeartbeatEmitter:
    """Daemon thread writing one ``health.heartbeat`` event per interval
    through the tracer (sink + flight recorder), flushing the sink so a
    supervisor tailing the file sees the beat immediately."""

    def __init__(self, interval_ms=None, host=None):
        from paddle_tpu_torch import flags
        from paddle_tpu_torch.observability import export

        if interval_ms is None:
            interval_ms = float(flags.get_flag("heartbeat_ms"))
        self.interval_ms = float(interval_ms)
        self.host = export.host_tag() if host is None else int(host)
        self._seq = 0
        self._stop = threading.Event()
        self._thread = None

    @property
    def running(self):
        t = self._thread
        return t is not None and t.is_alive()

    def start(self):
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="paddle-gpu-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        self._thread = None

    def emit_now(self):
        """Build and emit one heartbeat; returns the payload dict."""
        from paddle_tpu_torch import observability as obs

        self._seq += 1
        payload = {"seq": self._seq, "step": _step_state["steps"],
                   "enqueued": _step_state["enqueued"],
                   "interval_ms": self.interval_ms}
        payload["phase"] = obs.tracer.current_phase() or "idle"
        rss = host_rss_bytes()
        if rss:
            payload["rss_bytes"] = int(rss)
        peak = obs.memory.peak_hbm_bytes()
        if peak:
            payload["hbm_peak_bytes"] = int(peak)
        depth = obs.registry.gauge_value("serving.queue_depth")
        if depth is not None:
            payload["queue_depth"] = depth
        # direct tracer call, NOT obs.event: liveness must flow even with
        # PADDLE_GPU_METRICS down. The counter below does ride the gate.
        obs.tracer.event(HEARTBEAT_EVENT, **payload)
        obs.inc("health.heartbeats")
        try:
            obs.flush_sink()
        except Exception:
            pass
        return payload

    def _loop(self):
        interval = max(0.01, self.interval_ms / 1000.0)
        while not self._stop.wait(interval):
            try:
                self.emit_now()
            except Exception:
                # a sick emitter must never take the worker down with it
                pass


_emitter = None


def ensure_heartbeat(interval_ms=None):
    """Start/retune/stop the singleton from ``interval_ms`` (default:
    the ``heartbeat_ms`` flag; <= 0 stops). The flags change-hook and
    the observability import both route here, so the env var the
    supervised launcher sets takes effect at worker import."""
    global _emitter
    from paddle_tpu_torch import flags

    if interval_ms is None:
        interval_ms = float(flags.get_flag("heartbeat_ms"))
    interval_ms = float(interval_ms)
    if interval_ms <= 0:
        stop_heartbeat()
        return None
    if _emitter is not None and _emitter.running \
            and _emitter.interval_ms == interval_ms:
        return _emitter
    stop_heartbeat()
    _emitter = HeartbeatEmitter(interval_ms=interval_ms).start()
    return _emitter


def stop_heartbeat():
    global _emitter
    if _emitter is not None:
        _emitter.stop()
        _emitter = None


# -- serving SLO monitor -----------------------------------------------------
#: retained latency samples are pruned to the slow window AND this cap.
MAX_SLO_SAMPLES = 65536


class SloMonitor:
    """Multi-window burn-rate monitor over request latencies.

    burn = (window violation fraction) / (1 − target): 1.0 means the
    error budget is being spent exactly at the sustainable rate. The
    alert condition requires BOTH windows over threshold — the fast
    window for detection speed, the slow window so a brief spike that
    already ended does not page (the SRE multiwindow recipe; defaults
    14.4×/6× are the classic fast/slow page thresholds). State flips
    are edge-triggered ``health.slo_burn`` / ``health.slo_recovered``
    events through the (gated) telemetry layer.

    ``now`` parameters default to ``time.monotonic()`` and exist so
    tests drive a synthetic clock.
    """

    def __init__(self, slo_ms, target=0.999, fast_window_s=60.0,
                 slow_window_s=600.0, fast_burn=14.4, slow_burn=6.0,
                 name="serving"):
        self.slo_ms = float(slo_ms)
        self.target = float(target)
        self.budget = max(1e-9, 1.0 - self.target)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.name = name
        self._samples = collections.deque()  # (ts_s, latency_ms)
        self._lock = threading.Lock()
        self._burning = False
        # worst SLO-violating (latency_ms, trace_id) seen so far — the
        # exemplar a burn event names, linking the page to the request
        # trace that spent the budget
        self._exemplar = None

    # -- record ----------------------------------------------------------
    def record(self, latency_ms, now=None, trace_id=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            self._samples.append((now, float(latency_ms)))
            if trace_id is not None and latency_ms > self.slo_ms \
                    and (self._exemplar is None
                         or latency_ms >= self._exemplar[0]):
                self._exemplar = (float(latency_ms), trace_id)
            exemplar = self._exemplar
            self._prune(now)
            fast = self._burn(now, self.fast_window_s)
            slow = self._burn(now, self.slow_window_s)
            burning = fast >= self.fast_burn and slow >= self.slow_burn
            flipped = burning != self._burning
            self._burning = burning
        if flipped:
            from paddle_tpu_torch import observability as obs

            if burning:
                obs.inc("health.slo_burn")
                kw = {}
                if exemplar is not None:
                    kw["exemplar_ms"] = round(exemplar[0], 2)
                    kw["exemplar_trace"] = exemplar[1]
                obs.event("health.slo_burn", monitor=self.name,
                          slo_ms=self.slo_ms, burn_fast=round(fast, 2),
                          burn_slow=round(slow, 2), **kw)
            else:
                obs.event("health.slo_recovered", monitor=self.name,
                          slo_ms=self.slo_ms)

    def _prune(self, now):
        horizon = now - self.slow_window_s
        q = self._samples
        while q and (q[0][0] < horizon or len(q) > MAX_SLO_SAMPLES):
            q.popleft()

    def _burn(self, now, window_s):
        horizon = now - window_s
        total = bad = 0
        for ts, ms in self._samples:
            if ts >= horizon:
                total += 1
                if ms > self.slo_ms:
                    bad += 1
        if not total:
            return 0.0
        return (bad / total) / self.budget

    # -- read ------------------------------------------------------------
    def burn_rate(self, window_s, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._burn(now, window_s)

    def burning(self, now=None):
        """Live alert condition (recomputed, so burn that aged out of
        the fast window reads recovered even with no new requests)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return (self._burn(now, self.fast_window_s) >= self.fast_burn
                    and self._burn(now, self.slow_window_s)
                    >= self.slow_burn)

    def snapshot(self, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            fast = self._burn(now, self.fast_window_s)
            slow = self._burn(now, self.slow_window_s)
            lats = sorted(ms for _, ms in self._samples)
            n = len(lats)
            p99 = lats[min(n - 1, int(0.99 * n))] if n else None
            bad = sum(1 for _, ms in self._samples if ms > self.slo_ms)
            out = {"slo_ms": self.slo_ms, "target": self.target,
                   "requests": n, "violations": bad,
                   "burn_fast": fast, "burn_slow": slow,
                   "burning": fast >= self.fast_burn
                   and slow >= self.slow_burn,
                   "p99_ms": p99}
            if self._exemplar is not None:
                out["exemplar"] = {"ms": round(self._exemplar[0], 2),
                                   "trace_id": self._exemplar[1]}
            return out
