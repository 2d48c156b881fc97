"""Continuous-batching inference server over a served program.

Port of ``paddle_tpu/inference/serving.py`` (``InferenceServer`` :116)
onto the port's eager engine. A request queue in front of the engine:
submitter threads enqueue single requests (each a feed dict with a
leading batch dim), one worker thread coalesces them along axis 0 into
zero-padded shape buckets and runs each bucket through
``Engine.run_block``. Where the JAX engine compiles one executable per
bucket, the server passes the engine a ``("serving", name, bucket)`` tag
(``cache_key_extra``) as the reference does, and the port's engine keys
one cache entry, and on CUDA one captured CUDA graph, per tag; all
buckets share the block's one analysis. ``warmup`` runs each bucket
twice on CUDA, the eager warm-up and the capture, so live requests only
replay. Dispatch happens when the top
bucket fills OR when the oldest queued request has waited
``serving_max_wait_ms`` — the max-wait timer is the p99 bound at low
QPS (a lone request never waits longer than the timer plus one batch's
compute). Coalescing is what turns the card's idle share into served
rows: the eager engine's host cost of a dispatch barely depends on its
rows.

The worker runs the engine with ``donate_state=False`` and
``state_writeback=False`` (the served program re-emits state it read
unchanged; skipping the write keeps the scope immutable under
concurrent submitters, and the params are read-only inputs of each
bucket's graph). It runs every op of a dispatch on its own
thread's current stream of the executor's device (no second stream),
and the fetches' copy to the host completes before a future resolves.
A padded row carries ``seq_lens`` 0, which attention clamps to 1 as
the reference does; a real row's answer does not depend on its
batch-mates or on the padding beyond the GEMMs' summation order.

SLO telemetry (gated by PADDLE_GPU_METRICS, histograms in the process
metrics registry): ``serving.request_ms`` (submit -> result),
``serving.queue_ms`` (submit -> batch start), ``serving.batch_ms``,
``serving.batch_fill`` (rows/bucket), ``serving.queue_depth``
(histogram, sampled at each dispatch; also a live gauge), counters
``serving.requests`` / ``serving.batches`` / ``serving.padded_rows``,
and ``serving.request_goodput`` — the executing fraction of each
request's wall (the rest is queue wait + batching delay); batch-mean
mirrored as the ``goodput.serving_request_frac`` gauge.

Readiness (ungated): with an SLO configured (``slo_ms`` ctor arg /
``PADDLE_GPU_SERVING_SLO_MS``) every request's latency also feeds an
``observability.health.SloMonitor`` — fast/slow burn-rate windows whose
sustained burn flips ``health()`` to unhealthy and emits an
edge-triggered ``health.slo_burn`` event. ``health()`` is the probe a
load balancer polls: worker liveness, queue depth, p99, burn rates,
last-dispatch age.

Overload protection (inference/admission.py — every knob defaults to
OFF, leaving this path identical to the unprotected one): requests may
carry ``deadline_ms`` and ``priority``. A bounded queue
(``PADDLE_GPU_QUEUE_LIMIT``) evicts already-expired entries CoDel-style
before refusing; a predictive gate rejects a deadlined request at
enqueue when its estimated wait (queued batches x EWMA batch latency)
already exceeds the deadline; under SLO fast-window burn, priority<=0
traffic is shed (``PADDLE_GPU_SERVING_SHED``) — after dispatch has
fallen back to a cheaper ``degraded_program``
(``PADDLE_GPU_SERVING_DEGRADED``), when one is configured. ``Rejected``
raises synchronously from ``submit``; ``DeadlineExceeded`` resolves
onto the future of an admitted request that expired in the queue; the
batcher skips expired entries as it pops them; ``run(timeout=)``
cancels its queue entry instead of orphaning it. Counters:
``serving.{rejected,shed,expired,cancelled}``; degraded-mode flips
emit edge-triggered ``health.degraded_mode`` events and count
``serving.degraded_entered``.
"""

import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.executor import Executor, global_scope
from paddle_tpu_torch.inference.admission import (
    AdmissionGate,
    DeadlineExceeded,
    Rejected,
)
from paddle_tpu_torch.observability.health import SloMonitor


def parse_buckets(spec=None):
    """'1,2,4,8' (or an iterable of ints) -> sorted tuple of edges.
    Defaults to the ``serving_buckets`` flag."""
    if spec is None:
        spec = flags.get_flag("serving_buckets")
    if isinstance(spec, str):
        edges = [int(p) for p in spec.replace(" ", "").split(",") if p]
    else:
        edges = [int(p) for p in spec]
    edges = sorted(set(e for e in edges if e > 0))
    if not edges:
        raise ValueError("serving buckets must name at least one edge")
    return tuple(edges)


class _Request:
    __slots__ = ("feed", "rows", "future", "t_enq", "ctx",
                 "deadline_ms", "t_deadline", "priority")

    def __init__(self, feed, rows, ctx=None, deadline_ms=None, priority=0):
        self.feed = feed
        self.rows = rows
        self.future = Future()
        self.t_enq = time.monotonic()
        # request TraceContext (observability/reqtrace), or None when
        # tracing is disabled / the request was not selected
        self.ctx = ctx
        self.deadline_ms = deadline_ms
        # absolute expiry on the same monotonic clock as t_enq; None =
        # the request waits forever (pre-deadline behavior)
        self.t_deadline = (None if deadline_ms is None
                           else self.t_enq + float(deadline_ms) / 1000.0)
        self.priority = int(priority)

    def expired(self, now):
        return self.t_deadline is not None and now >= self.t_deadline


class InferenceServer:
    """Continuous-batching server over one served program.

    >>> server = InferenceServer(program, feed_names, fetch_names,
    ...                          scope=scope, executor=exe)
    >>> with server:
    ...     out = server.run({"img": batch})          # blocking
    ...     fut = server.submit({"img": batch})       # async Future
    """

    def __init__(self, program, feed_names, fetch_names, scope=None,
                 executor=None, buckets=None, max_wait_ms=None,
                 name="serving", slo_ms=None, slo_monitor=None,
                 degraded_program=None, opt_level=None):
        self.program = program
        # the engine's opt level for every dispatch (None: the flag's);
        # the predictor passes its switch_ir_optim choice through
        self.opt_level = opt_level
        self.feed_names = tuple(feed_names)
        self.fetch_names = tuple(
            f.name if hasattr(f, "name") else str(f) for f in fetch_names)
        self.scope = scope if scope is not None else global_scope()
        # Executor() is CUDAPlace(0) and raises without CUDA: the server
        # never falls back to the CPU unless the caller's executor asks
        self._exe = executor or Executor()
        self._engine = self._exe.engine
        self.device = self._exe.device
        self.buckets = parse_buckets(buckets)
        if max_wait_ms is None:
            max_wait_ms = float(flags.get_flag("serving_max_wait_ms"))
        self.max_wait_ms = float(max_wait_ms)
        self.name = name
        if slo_ms is None:
            slo_ms = float(flags.get_flag("serving_slo_ms"))
        # latency SLO burn-rate monitor (observability/health.py): fed
        # unconditionally in _dispatch — readiness is not gated by the
        # metrics flag. ``slo_monitor`` injects a pre-built monitor
        # (custom windows/thresholds, e.g. windows of seconds)
        if slo_monitor is not None:
            self.slo = slo_monitor
        else:
            self.slo = SloMonitor(slo_ms, name=name) \
                if slo_ms and slo_ms > 0 else None
        self._queue = []
        self._cond = threading.Condition()
        self._stopping = False
        self._started = False
        self._worker = None
        self._last_dispatch = None
        # overload protection (inference/admission.py). Flags are read
        # once at construction, like max_wait/buckets; at the defaults
        # (queue_limit 0, shed off, no degraded program) every check
        # below short-circuits and the request path is the unprotected
        # one.
        self._adm = AdmissionGate()  # reads PADDLE_GPU_QUEUE_LIMIT
        self._shed = bool(flags.get_flag("serving_shed"))
        self.degraded_program = degraded_program
        self._deg_enabled = bool(degraded_program is not None
                                 and flags.get_flag("serving_degraded"))
        self._degraded = False

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._started:
            return self
        self._stopping = False
        self._started = True
        # the heartbeat and the JSONL sink, where their flags are set
        obs.health.ensure_heartbeat()
        if obs.sink() is None:
            obs.attach_sink()
        self._worker = threading.Thread(
            target=self._loop, name="paddle-gpu-%s" % self.name, daemon=True)
        self._worker.start()
        return self

    def stop(self):
        """Drain the queue (every pending future resolves), then stop the
        worker."""
        if not self._started:
            return
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._worker.join()
        self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def warmup(self, example_feed):
        """Run every bucket from one example request (tiled to each
        edge): once on the CPU, twice on CUDA, where the first run of a
        bucket is the engine's eager warm-up (the kernel libraries' first
        load, an nvcc build on a cold build directory, cuBLAS handle
        set-up and the caching allocator's growth) and the second
        captures its CUDA graph. Live requests then only replay."""
        example = {k: np.asarray(v) for k, v in example_feed.items()}
        passes = 2 if self.device.type == "cuda" else 1
        modes = (False, True) if self._deg_enabled else (False,)
        was = self._degraded
        try:
            for degraded in modes:
                # with a degraded fallback armed, warm BOTH programs'
                # buckets — entering degraded mode under burn must not
                # pay a first run at the worst moment
                self._degraded = degraded
                for edge in self.buckets:
                    feed = {k: self._tile(v, edge)
                            for k, v in example.items()}
                    for _ in range(passes):
                        self._run_padded(feed, edge)
        finally:
            self._degraded = was
        return self

    # -- client API --------------------------------------------------------
    def submit(self, feed, trace_id=None, deadline_ms=None, priority=0):
        """Enqueue one request; returns a concurrent.futures.Future
        resolving to the fetch list (numpy, rows matching the request).

        With request tracing enabled (``PADDLE_GPU_TRACE_SAMPLE`` /
        ``PADDLE_GPU_TRACE_SLOW_MS``) the request opens a trace —
        ``trace_id`` joins a caller-supplied trace (a router passes the
        ID it generated at routing time), otherwise one is generated. The future carries ``trace_id`` plus the enqueue /
        completion stamps ``t_enq`` / ``t_done`` (``time.monotonic()``,
        the same clock ``health()`` ages dispatches with), so a client
        can line its own latency measurement up against the trace.

        ``deadline_ms`` bounds submit -> result: an admitted request
        that expires in the queue resolves its future with
        :class:`DeadlineExceeded`, and the predictive admission gate
        refuses outright (``Rejected('predicted_late')``) when the
        estimated queue wait already exceeds the deadline. ``priority``
        orders load shedding (higher survives longer); it is inert
        unless ``PADDLE_GPU_SERVING_SHED`` is on. A :class:`Rejected`
        request raises here synchronously — no future, no trace."""
        if not self._started:
            raise RuntimeError("InferenceServer not started (use start() "
                               "or the context manager)")
        fd, rows = self._coerce(feed)
        now = time.monotonic()
        evicted = []  # (_Request, exc): resolved after the lock drops
        reject = None
        with self._cond:
            if self._stopping:
                raise RuntimeError("InferenceServer is stopping")
            # 1) priority shedding under fast-window burn. With a
            # degraded program configured, shedding only starts once
            # the cheaper executable is already engaged — degrade
            # first, drop second.
            if (self._shed and priority <= 0
                    and (self._degraded or not self._deg_enabled)
                    and self.fast_burning(now=now)):
                reject = Rejected("shed", trace_id=trace_id)
            # 2) predictive gate: refuse a deadlined request whose
            # estimated wait is already past its deadline.
            elif deadline_ms is not None:
                est = self._adm.predicted_wait_ms(
                    sum(r.rows for r in self._queue), self.buckets[-1])
                if est > float(deadline_ms):
                    reject = Rejected(
                        "predicted_late",
                        "predicted wait %.1fms exceeds deadline %.1fms"
                        % (est, float(deadline_ms)), trace_id=trace_id)
            # 3) bounded queue: evict expired entries first
            # (CoDel-style, oldest first by queue order), then shed a
            # strictly-lower-priority entry, then refuse.
            if reject is None and self._adm.over_limit(len(self._queue)):
                keep = []
                for r in self._queue:
                    if r.expired(now):
                        evicted.append((r, DeadlineExceeded(
                            trace_id=r.future.trace_id,
                            deadline_ms=r.deadline_ms,
                            waited_ms=(now - r.t_enq) * 1000.0)))
                    else:
                        keep.append(r)
                if len(keep) != len(self._queue):
                    self._queue[:] = keep
                if self._adm.over_limit(len(self._queue)):
                    victim = None
                    if self._shed and self._queue:
                        v = min(self._queue,
                                key=lambda r: (r.priority, r.t_enq))
                        if v.priority < int(priority):
                            victim = v
                    if victim is not None:
                        self._queue.remove(victim)
                        evicted.append((victim, Rejected(
                            "shed",
                            "evicted for a priority-%d request"
                            % int(priority),
                            trace_id=victim.future.trace_id)))
                    else:
                        reject = Rejected("queue_full", trace_id=trace_id)
            if reject is None:
                req = _Request(fd, rows,
                               ctx=obs.reqtrace.maybe_begin(trace_id),
                               deadline_ms=deadline_ms, priority=priority)
                req.future.trace_id = (req.ctx.trace_id
                                       if req.ctx is not None else None)
                req.future.t_enq = req.t_enq
                req.future.t_done = None
                self._queue.append(req)
                obs.set_gauge("serving.queue_depth", len(self._queue))
                self._cond.notify_all()
        # resolve evicted futures outside the lock: their done-callbacks
        # must never run under the server's condition variable
        for r, exc in evicted:
            self._finish_unserved(r, exc)
        if reject is not None:
            if obs.enabled():
                obs.inc("serving.shed" if reject.reason == "shed"
                        else "serving.rejected")
            raise reject
        return req.future

    def run(self, feed, timeout=None):
        """Blocking submit. A ``timeout`` that fires CANCELS the queue
        entry (it will never be dispatched with the result discarded);
        a request already handed to the batcher completes normally —
        only the caller stopped waiting for it."""
        fut = self.submit(feed)
        try:
            return fut.result(timeout)
        except FutureTimeout:
            self.cancel(fut)
            raise

    def cancel(self, future):
        """Withdraw a still-queued request: removes the entry and
        cancels its future. Returns False when the request already left
        the queue (dispatched, resolved, or never ours) — dispatch is
        the point of no return, matching the semantics clients expect
        from ``concurrent.futures``."""
        req = None
        with self._cond:
            for i, r in enumerate(self._queue):
                if r.future is future:
                    req = self._queue.pop(i)
                    obs.set_gauge("serving.queue_depth", len(self._queue))
                    break
        if req is None:
            return False
        t = time.monotonic()
        req.future.t_done = t
        req.future.cancel()
        if obs.enabled():
            obs.inc("serving.cancelled")
        if req.ctx is not None:
            obs.reqtrace.finish(req.ctx, (t - req.t_enq) * 1000.0,
                                error=True)
        return True

    def _finish_unserved(self, req, exc):
        """Resolve a queue entry that will never dispatch (expired or
        evicted) with its typed admission error, closing its trace and
        bumping the matching counter. Runs WITHOUT the server lock."""
        t = time.monotonic()
        req.future.t_done = t
        if not req.future.cancelled():
            req.future.set_exception(exc)
        if obs.enabled():
            obs.inc("serving.expired" if isinstance(exc, DeadlineExceeded)
                    else "serving.shed")
        if req.ctx is not None:
            rt = obs.reqtrace
            total_ms = (t - req.t_enq) * 1000.0
            rt.add_root_span(req.ctx, "request",
                             rt.mono_to_epoch_us(req.t_enq),
                             (t - req.t_enq) * 1e6, rows=req.rows,
                             error=repr(exc)[:160],
                             total_ms=round(total_ms, 3))
            rt.finish(req.ctx, total_ms, error=True)

    def alive(self):
        """True while the dispatch worker thread is running — the cheap
        liveness check the FleetRouter routes on."""
        return bool(self._started and self._worker is not None
                    and self._worker.is_alive())

    def burning(self, now=None):
        """Live SLO alert condition (BOTH burn windows over threshold);
        False without an SLO monitor."""
        return bool(self.slo is not None and self.slo.burning(now=now))

    def fast_burning(self, now=None):
        """FAST-window-only burn — the early detection signal the
        FleetRouter scales OUT on, before the slow window would confirm
        a page. False without an SLO monitor."""
        if self.slo is None:
            return False
        return (self.slo.burn_rate(self.slo.fast_window_s, now=now)
                >= self.slo.fast_burn)

    def slow_recovered(self, now=None):
        """True once the SLOW burn window is back under threshold — the
        confirmation signal the FleetRouter requires fleet-wide before
        scaling IN (a brief lull never sheds capacity). True without an
        SLO monitor."""
        if self.slo is None:
            return True
        return (self.slo.burn_rate(self.slo.slow_window_s, now=now)
                < self.slo.slow_burn)

    def burn_snapshot(self, now=None):
        """{'burn_fast', 'burn_slow', thresholds} for scale-decision
        forensics, or None without an SLO monitor."""
        if self.slo is None:
            return None
        return {"burn_fast": self.slo.burn_rate(self.slo.fast_window_s,
                                                now=now),
                "burn_slow": self.slo.burn_rate(self.slo.slow_window_s,
                                                now=now),
                "fast_threshold": self.slo.fast_burn,
                "slow_threshold": self.slo.slow_burn}

    def health(self):
        """Readiness snapshot for a load-balancer probe: healthy =
        worker thread alive AND (with an SLO configured) not burning
        error budget in both burn-rate windows. Always includes queue
        depth, p99, and the age of the last dispatch."""
        now = time.monotonic()
        with self._cond:
            depth = len(self._queue)
        alive = self.alive()
        out = {"name": self.name, "started": self._started,
               "worker_alive": alive, "queue_depth": depth,
               "last_dispatch_age_s":
                   (now - self._last_dispatch)
                   if self._last_dispatch is not None else None}
        if self._adm.queue_limit:
            out["queue_limit"] = self._adm.queue_limit
        if self._deg_enabled:
            out["degraded"] = self._degraded
        healthy = alive
        if self.slo is not None:
            snap = self.slo.snapshot(now=now)
            out["slo"] = snap
            out["p99_ms"] = snap["p99_ms"]
            healthy = healthy and not snap["burning"]
        else:
            h = obs.registry.histogram("serving.request_ms")
            out["p99_ms"] = h.percentile(99) if h is not None else None
        out["healthy"] = healthy
        return out

    # -- worker ------------------------------------------------------------
    def _loop(self):
        if self.device.type == "cuda":
            # this thread's current stream is then the device's default
            # stream, the one every op of a dispatch is launched on
            torch.cuda.set_device(self.device)
        while True:
            batch = self._collect()
            if batch is None:
                return
            if not batch:
                # every popped entry had already expired — nothing to run
                continue
            self._dispatch(batch)

    def _collect(self):
        """Block until a dispatchable batch exists: the top bucket is
        full, the oldest request's max-wait expired, or the server is
        draining. Returns the popped requests (None = drained + stopped;
        possibly empty when every popped entry had expired in queue —
        those resolve with DeadlineExceeded instead of dispatching).
        """
        max_bucket = self.buckets[-1]
        expired = []
        with self._cond:
            while not self._queue:
                if self._stopping:
                    return None
                self._cond.wait(0.25)
            deadline = self._queue[0].t_enq + self.max_wait_ms / 1000.0
            while (sum(r.rows for r in self._queue) < max_bucket
                   and not self._stopping):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch, rows = [], 0
            now = time.monotonic()
            while self._queue:
                nxt = self._queue[0]
                if nxt.expired(now):
                    # admitted but dead on arrival at the batcher: skip
                    # it rather than burn bucket rows on an answer the
                    # client already gave up on
                    expired.append(self._queue.pop(0))
                    continue
                if batch and rows + nxt.rows > max_bucket:
                    break
                r = self._queue.pop(0)
                # claim the future: a client that cancelled it directly
                # (a hedge loser, a raced run(timeout=)) is dropped here
                # instead of blowing up set_result() mid-batch and
                # poisoning its batch-mates
                if not r.future.set_running_or_notify_cancel():
                    continue
                batch.append(r)
                rows += nxt.rows
        for r in expired:
            self._finish_unserved(r, DeadlineExceeded(
                trace_id=r.future.trace_id, deadline_ms=r.deadline_ms,
                waited_ms=(time.monotonic() - r.t_enq) * 1000.0))
        return batch

    def _dispatch(self, batch):
        rt = obs.reqtrace
        t_start = time.monotonic()
        if self._deg_enabled:
            self._update_degraded(t_start)
        rows = sum(r.rows for r in batch)
        bucket = self._bucket_for(rows)
        traced = [r for r in batch if r.ctx is not None]
        # fan-in is explicit: every member trace's batch spans name ALL
        # the trace IDs coalesced into this bucket
        members = [r.ctx.trace_id for r in traced] if traced else None
        if obs.enabled():
            with self._cond:
                depth = len(self._queue)
            obs.observe("serving.queue_depth", depth)
            obs.set_gauge("serving.queue_depth", depth)
            for r in batch:
                obs.observe("serving.queue_ms",
                            (t_start - r.t_enq) * 1000.0,
                            exemplar=(r.ctx.trace_id if r.ctx is not None
                                      else None))
        for r in traced:
            rt.add_span(r.ctx, "queue", rt.mono_to_epoch_us(r.t_enq),
                        (t_start - r.t_enq) * 1e6, rows=r.rows)
        t_coal = t_start
        try:
            feed = self._coalesce(batch, rows, bucket)
            t_coal = time.monotonic()
            outs = self._run_padded(feed, bucket)
            self._resolve(batch, outs, bucket)
        except BaseException as e:  # noqa: BLE001 - propagate per-request
            t_err = time.monotonic()
            # close every member trace BEFORE resolving the futures: a
            # done-callback may relaunch the SAME trace id on another
            # worker (FleetRouter retry), and the relaunch must re-open
            # a fresh span buffer — spans added to this one after the
            # callback would be lost when finish() pops it
            for r in traced:
                # errored requests always keep their trace
                r.future.t_done = t_err
                total_ms = (t_err - r.t_enq) * 1000.0
                rt.add_root_span(r.ctx, "request",
                                 rt.mono_to_epoch_us(r.t_enq),
                                 (t_err - r.t_enq) * 1e6, rows=r.rows,
                                 bucket=bucket, error=repr(e)[:160],
                                 total_ms=round(total_ms, 3))
                rt.finish(r.ctx, total_ms, error=True)
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        t_done = time.monotonic()
        self._last_dispatch = t_done
        # feed the admission gate's EWMA with the batch wall time —
        # the predictive gate's wait estimate is depth x this
        self._adm.note_batch((t_done - t_start) * 1000.0)
        for r in batch:
            # the enqueue stamp was retained on the future at submit;
            # completing on the same monotonic clock closes the pair
            # (health()'s last_dispatch age, the trace spans, and a
            # client-side latency measurement now all agree)
            r.future.t_done = t_done
        if traced:
            engine_step = getattr(self._engine, "_run_counter", None)
            coalesce_us = (t_coal - t_start) * 1e6
            dispatch_us = (t_done - t_coal) * 1e6
            for r in traced:
                rt.add_span(r.ctx, "coalesce",
                            rt.mono_to_epoch_us(t_start), coalesce_us,
                            members=members, bucket=bucket, rows=rows)
                rt.add_span(r.ctx, "dispatch",
                            rt.mono_to_epoch_us(t_coal), dispatch_us,
                            members=members, bucket=bucket,
                            engine_step=engine_step)
                total_ms = (t_done - r.t_enq) * 1000.0
                rt.add_root_span(r.ctx, "request",
                                 rt.mono_to_epoch_us(r.t_enq),
                                 (t_done - r.t_enq) * 1e6, rows=r.rows,
                                 bucket=bucket, engine_step=engine_step,
                                 queue_ms=round(
                                     (t_start - r.t_enq) * 1e3, 3),
                                 coalesce_ms=round(
                                     (t_coal - t_start) * 1e3, 3),
                                 exec_ms=round((t_done - t_coal) * 1e3, 3),
                                 total_ms=round(total_ms, 3))
                rt.finish(r.ctx, total_ms)
        if self.slo is not None:
            # a sick SLO monitor must never take the dispatch loop down
            # (every queued future would hang unresolved)
            try:
                for r in batch:
                    self.slo.record(
                        (t_done - r.t_enq) * 1000.0, now=t_done,
                        trace_id=(r.ctx.trace_id if r.ctx is not None
                                  else None))
            except Exception:
                pass
        if obs.enabled():
            exec_ms = (t_done - t_start) * 1000.0
            obs.observe("serving.batch_ms", exec_ms)
            obs.observe("serving.batch_fill", rows / float(bucket))
            # per-request goodput: the fraction of the request's wall
            # that was the batch actually executing — the remainder is
            # queue wait + batching delay (the serving-side badput the
            # SLO burn monitor reacts to). Same decomposition as the
            # training ledger, at request granularity.
            frac_sum = 0.0
            worst = None          # (frac, trace_id) exemplar candidate
            for r in batch:
                total_ms = (t_done - r.t_enq) * 1000.0
                frac = min(1.0, exec_ms / total_ms) if total_ms > 0 \
                    else 1.0
                frac_sum += frac
                if r.ctx is not None and (worst is None
                                          or frac < worst[0]):
                    worst = (frac, r.ctx.trace_id)
                obs.observe("serving.request_ms", total_ms,
                            exemplar=(r.ctx.trace_id
                                      if r.ctx is not None else None))
                obs.observe("serving.request_goodput", frac)
            obs.goodput.note_serving_request(
                frac_sum / len(batch),
                trace_id=worst[1] if worst is not None else None)
            obs.inc("serving.requests", len(batch))
            obs.inc("serving.batches")
            obs.inc("serving.padded_rows", bucket - rows)

    def _update_degraded(self, now=None):
        """Edge-triggered degraded-mode controller, evaluated once per
        dispatch: ENTER on the fast burn window (early detection — the
        same signal the fleet scales out on), EXIT only once the slow
        window confirms recovery. The asymmetry is deliberate: flipping
        programs is cheap (both are warm in the engine's cache) but
        flapping would make every latency sample bimodal."""
        if not self._degraded:
            if self.fast_burning(now=now):
                self._degraded = True
                obs.inc("serving.degraded_entered")
                obs.event("health.degraded_mode", server=self.name,
                          engaged=True, burn=self.burn_snapshot(now=now))
        elif (not self.fast_burning(now=now)
              and self.slow_recovered(now=now)):
            self._degraded = False
            obs.event("health.degraded_mode", server=self.name,
                      engaged=False, burn=self.burn_snapshot(now=now))

    # -- internals ---------------------------------------------------------
    def _coerce(self, feed):
        fd, rows = {}, None
        for name in self.feed_names:
            if name not in feed:
                raise KeyError("request is missing feed %r" % name)
            v = np.asarray(feed[name])
            if v.ndim == 0:
                raise ValueError("feed %r must carry a leading batch dim"
                                 % name)
            if rows is None:
                rows = int(v.shape[0])
            elif int(v.shape[0]) != rows:
                raise ValueError(
                    "inconsistent batch dims in request: %r has %d rows, "
                    "expected %d" % (name, v.shape[0], rows))
            fd[name] = v
        return fd, rows

    def _bucket_for(self, rows):
        for edge in self.buckets:
            if rows <= edge:
                return edge
        return rows  # oversized request: an exact-shape dispatch

    def _coalesce(self, batch, rows, bucket):
        feed = {}
        for name in self.feed_names:
            parts = [r.feed[name] for r in batch]
            joined = parts[0] if len(parts) == 1 else np.concatenate(
                parts, axis=0)
            if bucket > rows:
                pad = np.zeros((bucket - rows,) + joined.shape[1:],
                               joined.dtype)
                joined = np.concatenate([joined, pad], axis=0)
            feed[name] = joined
        return feed

    def _run_padded(self, feed, bucket):
        # degraded mode swaps in the cheaper program under its own
        # cache tag; with the mode off, the key is the 3-tuple
        program = self.program
        key = ("serving", self.name, bucket)
        if self._degraded:
            program = self.degraded_program
            key = ("serving", self.name, bucket, "degraded")
        return self._engine.run_block(
            program.desc, 0, self.scope,
            feed=feed, fetch_list=list(self.fetch_names),
            is_test=True, donate_state=False, state_writeback=False,
            cache_key_extra=key, opt_level=self.opt_level,
            return_numpy=True)

    def _resolve(self, batch, outs, bucket):
        # split each fetch along axis 0 when it kept the padded batch
        # dim; anything else (scalar metrics, reduced outputs) is handed
        # to every request whole
        row0 = 0
        splittable = [
            hasattr(o, "shape") and getattr(o, "ndim", 0) >= 1
            and int(o.shape[0]) == bucket for o in outs]
        for r in batch:
            vals = []
            for o, split in zip(outs, splittable):
                vals.append(o[row0:row0 + r.rows] if split else o)
            r.future.set_result(vals)
            row0 += r.rows

    @staticmethod
    def _tile(v, rows):
        reps = (int(np.ceil(rows / max(1, v.shape[0]))),) + (1,) * (
            v.ndim - 1)
        return np.tile(v, reps)[:rows]
