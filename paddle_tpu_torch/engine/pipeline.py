"""Async dispatch and host/device pipelining — port of
``paddle_tpu/engine/pipeline.py`` on CUDA streams and events.

A CUDA launch returns before the card runs it: only a read on the host
(``.cpu()``, ``.item()``, a synchronize) waits. The synchronous engine
gives that away by copying every step's fetches to the host before the
next step is enqueued. Multi-step dispatch keeps the state in flight on
the card, hands the caller ``DeferredFetch`` placeholders, and bounds how
far the host runs ahead with a retire-at-depth window.

* **DispatchWindow** (:199) — the engine's bounded deque of in-flight step
  records. ``push`` retires the oldest record once the window holds more
  than the requested depth; ``sync`` retires everything (the
  ``Executor.sync()`` barrier); ``discard`` drops records without
  raising. A retire waits on the step's CUDA event, turns its fetches
  into host values, checks its deferred nan/inf probes, notes the retired
  step for the heartbeat and books the ``pipeline.*`` telemetry
  (``dispatch_depth`` gauge, ``enqueue_to_retire_ms`` and ``retire_ms``
  histograms).

* **DeferredFetch** (:134) — the placeholder a windowed run returns for
  each fetch. ``shape``/``dtype`` read without waiting; any host use
  (``np.asarray``, ``float``, ``.value()``) retires the window up to its
  step. A record owns its fetches before the next step is enqueued: with
  ``return_numpy`` each one is copied on the card's stream into pinned
  host memory (non-blocking) and an event is recorded after the copies;
  otherwise the engine hands over device clones. A replayed graph writes
  the same output buffers every step, so nothing of a record aliases
  them.

* **FiniteProbe** (:73) — ``check_nan_inf`` under a window: the verdict
  scalars (``isfinite(x).all()`` and the nan/inf counts of each tensor)
  are enqueued with the step and read at retire, where a trip raises the
  synchronous guard's ``check_nan_inf:`` message naming the ORIGINAL
  step.

* **PrefetchingFeeder** (:359) — input prefetch: a background thread
  pulls batch k+1 from the reader, copies each array into a pinned host
  buffer and on to the device with ``non_blocking=True`` on a side
  stream, and records an event, while step k runs; at most ``depth``
  batches (``PADDLE_GPU_PREFETCH_DEPTH``, default 2) wait in a bounded
  queue. A pinned buffer is refilled only after its copy's event has
  completed, and a batch is handed to the consumer only after its
  stream has been made to wait on the copy's event (and the device
  tensors recorded on that stream, so the allocator keeps them until the
  consumer's work is done). Exhaustion and reader exceptions reach the
  consumer in order.
"""

import collections
import queue
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs

__all__ = ["DeferredFetch", "DispatchWindow", "FiniteProbe",
           "PrefetchingFeeder", "prefetch_to_device"]


class FiniteProbe:
    """One tensor's deferred nan/inf verdict: device scalars enqueued with
    the step, read at retire."""

    __slots__ = ("name", "kind", "shape", "dtype", "ok", "nan", "inf")

    def __init__(self, name, kind, shape, dtype, ok, nan, inf):
        self.name = name
        self.kind = kind
        self.shape = shape
        self.dtype = dtype
        self.ok = ok        # 0-d bool tensor: isfinite(x).all()
        self.nan = nan      # 0-d int tensor: isnan(x).sum()
        self.inf = inf      # 0-d int tensor: isinf(x).sum()


def finite_probes(named_values, kind):
    """Enqueue the finiteness reductions of the float tensors in
    ``named_values`` (the enqueue half of the deferred ``check_nan_inf``);
    nothing here waits for the card."""
    probes = []
    for name, val in named_values:
        if not isinstance(val, torch.Tensor) or not val.is_floating_point():
            continue
        probes.append(FiniteProbe(
            name=name, kind=kind, shape=tuple(val.shape),
            dtype=str(val.dtype).replace("torch.", ""),
            ok=torch.isfinite(val).all(), nan=torch.isnan(val).sum(),
            inf=torch.isinf(val).sum()))
    return probes


def stage_fetches(fetches, return_numpy):
    """Make a step's fetches the record's own without waiting: on CUDA,
    with ``return_numpy`` each is copied into pinned host memory on the
    current stream (bfloat16 as float32, since numpy has no bfloat16), and
    one event is recorded after the copies. Returns (values, event); the
    event is None for CPU tensors, which are ready."""
    if not any(t.is_cuda for t in fetches):
        return list(fetches), None
    staged = []
    for t in fetches:
        if return_numpy and t.is_cuda:
            if t.dtype == torch.bfloat16:
                t = t.float()
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            t = host
        staged.append(t)
    event = torch.cuda.Event()
    event.record()
    return staged, event


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _StepRecord:
    """One in-flight step: its staged fetches, its CUDA event, deferred
    nan probes and the placeholders handed to the caller."""

    __slots__ = ("step", "fetch_names", "fetches", "event", "probes",
                 "return_numpy", "enqueued_at", "placeholders", "resolved",
                 "values", "discarded")

    def __init__(self, step, fetch_names, fetches, event, probes,
                 return_numpy):
        self.step = step
        self.fetch_names = fetch_names
        self.fetches = fetches          # staged, not yet read
        self.event = event              # recorded after the step's copies
        self.probes = probes
        self.return_numpy = return_numpy
        self.enqueued_at = time.monotonic()
        self.placeholders = ()
        self.resolved = False
        self.values = None
        self.discarded = False


class DeferredFetch:
    """Placeholder for one fetch of a windowed step. ``shape``, ``dtype``
    and ``step`` read without waiting; any host use retires the dispatch
    window up to this step and keeps the value."""

    def __init__(self, window, record, index, name=None):
        self._window = window
        self._record = record
        self._index = index
        self.name = name

    @property
    def step(self):
        return self._record.step

    @property
    def resolved(self):
        return self._record.resolved

    @property
    def discarded(self):
        return self._record.discarded

    @property
    def shape(self):
        rec = self._record
        v = rec.values[self._index] if rec.resolved else \
            rec.fetches[self._index]
        return tuple(v.shape)

    @property
    def dtype(self):
        rec = self._record
        if rec.resolved:
            return rec.values[self._index].dtype
        t = rec.fetches[self._index]
        if rec.return_numpy:
            return np.dtype(str(t.dtype).replace("torch.", "").replace(
                "bfloat16", "float32"))
        return t.dtype

    def value(self):
        """The fetch (numpy under ``return_numpy``, else the device
        tensor); retires the window up to this step first."""
        rec = self._record
        if rec.discarded:
            raise RuntimeError(
                "DeferredFetch of step %d was discarded (the dispatch "
                "window was dropped by a rollback); the replayed step's "
                "result supersedes this placeholder" % rec.step)
        if not rec.resolved:
            self._window.retire_until(rec)
        return rec.values[self._index]

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self.value())
        return out.astype(dtype) if dtype is not None else out

    def __float__(self):
        return float(np.asarray(self.value()).reshape(-1)[0])

    def __int__(self):
        return int(np.asarray(self.value()).reshape(-1)[0])

    def __repr__(self):
        state = ("discarded" if self._record.discarded else
                 "resolved" if self._record.resolved else "in-flight")
        return "DeferredFetch(step=%d, name=%r, %s)" % (
            self._record.step, self.name, state)


class DispatchWindow:
    """Bounded deque of in-flight step records (engine-owned)."""

    def __init__(self):
        self._records = collections.deque()

    def __len__(self):
        return len(self._records)

    def push(self, record, depth):
        """Append a freshly enqueued step; retire the oldest records until
        at most ``depth`` remain in flight. The retire is the only host
        wait of the windowed loop, and only once the window is full."""
        self._records.append(record)
        obs.inc("pipeline.steps_enqueued")
        obs.set_gauge("pipeline.dispatch_depth", len(self._records))
        while len(self._records) > max(1, int(depth)):
            self._retire_oldest()

    def sync(self):
        """Retire every in-flight record; deferred nan verdicts raise
        here, oldest step first."""
        while self._records:
            self._retire_oldest()

    def retire_until(self, record):
        """Retire records oldest first until ``record`` is resolved (a
        host read of a DeferredFetch)."""
        while self._records and not record.resolved:
            self._retire_oldest()
        if not record.resolved and not record.discarded:
            # the record left the deque already (retired by an earlier
            # overflow whose verdict raised): resolve it directly
            self._resolve(record)

    def discard(self):
        """Drop every in-flight record without reading or raising. The
        dropped steps count as retired for the watchdog."""
        n = 0
        while self._records:
            rec = self._records.popleft()
            rec.discarded = True
            rec.fetches = rec.probes = rec.event = None
            obs.health.note_step_retired()
            n += 1
        if n:
            obs.inc("pipeline.steps_discarded", n)
            obs.set_gauge("pipeline.dispatch_depth", 0)
        return n

    # -- internals ---------------------------------------------------------
    def _retire_oldest(self):
        rec = self._records.popleft()
        t0 = time.monotonic()
        try:
            self._resolve(rec)
        finally:
            # the retire is the windowed loop's host wait: the ledger
            # charges it as host_sync (pipeline overlap, not waste)
            obs.goodput.mark("host_sync")
            # the step left the window whether or not its guard tripped
            obs.health.note_step_retired()
            # the retire half of the step's trace pair, named with the
            # record's ORIGINAL step
            obs.reqtrace.step_event("step_retire", rec.step)
            if obs.enabled():
                now = time.monotonic()
                obs.inc("pipeline.steps_retired")
                obs.observe("pipeline.retire_ms", (now - t0) * 1000.0)
                obs.observe("pipeline.enqueue_to_retire_ms",
                            (now - rec.enqueued_at) * 1000.0)
                obs.set_gauge("pipeline.dispatch_depth",
                              len(self._records))

    def _resolve(self, rec):
        """Read one record: fetches first (they resolve the caller's
        placeholders even when the guard then trips), then the deferred
        nan/inf probes, raising the synchronous guard's message with the
        ORIGINAL step."""
        if rec.resolved or rec.discarded:
            return
        if rec.event is not None:
            rec.event.synchronize()
        if rec.return_numpy:
            rec.values = [_to_numpy(t) for t in rec.fetches]
        else:
            rec.values = list(rec.fetches)
        rec.resolved = True
        rec.fetches = rec.event = None
        probes, rec.probes = rec.probes, None
        for p in probes or ():
            if bool(p.ok):
                continue
            n_nan, n_inf = int(p.nan), int(p.inf)
            obs.inc("engine.nan_inf_trips")
            obs.event("nan_inf_trip", var=p.name, kind=p.kind,
                      shape=str(p.shape), dtype=p.dtype, step=rec.step,
                      nan=n_nan, inf=n_inf, deferred=True)
            raise RuntimeError(
                "check_nan_inf: %s %r (shape %s, dtype %s) contains "
                "%d NaN / %d Inf value(s) after step %s (deferred "
                "verdict, resolved at window retire; reference: "
                "FLAGS_check_nan_inf, framework/operator.cc:972)"
                % (p.kind, p.name, p.shape, p.dtype, n_nan, n_inf,
                   rec.step))


# -- input prefetch ----------------------------------------------------------
class _End:
    pass


class _Raise:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class _Staged:
    """A batch on its way to the device: the item with device tensors in
    place of its arrays, and the copy stream's event after their copies
    (None on the CPU)."""

    __slots__ = ("item", "event", "tensors")

    def __init__(self, item, event, tensors):
        self.item = item
        self.event = event
        self.tensors = tensors


class _PinnedRing:
    """``slots`` sets of pinned host buffers, one per array of a batch,
    used in turn; a slot is refilled only once the event recorded after
    its last copies has completed."""

    def __init__(self, slots):
        self._slots = [({}, None) for _ in range(slots)]
        self._next = 0

    def take(self):
        i = self._next
        self._next = (i + 1) % len(self._slots)
        bufs, event = self._slots[i]
        if event is not None:
            event.synchronize()
        return i, bufs

    def done(self, i, event):
        self._slots[i] = (self._slots[i][0], event)


def _is_array(v):
    return isinstance(v, (np.ndarray, torch.Tensor))


def _map_item(item, fn):
    if isinstance(item, dict):
        return {k: fn(v) if _is_array(v) else v for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(fn(v) if _is_array(v) else v for v in item)
    return fn(item) if _is_array(item) else item


class PrefetchingFeeder:
    """Prefetch of a reader's batches onto the device.

    ``source`` is a reader-style callable returning an iterable (or a
    plain iterable) of batches: feed dicts of numpy arrays, or tuples or
    lists of them. A background thread stages up to ``depth`` batches
    ahead of the consumer: each numpy array (or CPU tensor) is copied into
    a pinned host buffer, then to ``device`` with ``non_blocking=True`` on
    a side stream; values that are not arrays (python lists) pass through
    for the engine's declared-dtype conversion. ``device`` defaults to the
    card (``CUDAPlace(0)``, raising without CUDA); on ``"cpu"`` the arrays
    become CPU tensors. With ``device_put=False`` batches pass through
    unconverted.

    Exhaustion and exceptions keep iterator semantics: ``StopIteration``
    where the source ended, and a source exception re-raised on the
    consuming thread after every batch produced before it. A CUDA error
    in a copy reaches the consumer the same way. ``close()`` (or leaving
    the ``with`` block, or the end of the iteration) stops the producer.
    """

    def __init__(self, source, depth=None, device_put=True, device=None):
        if depth is None:
            depth = int(flags.get_flag("prefetch_depth"))
        self.depth = max(1, int(depth))
        if device is None:
            from paddle_tpu_torch.platform import default_place

            device = default_place().torch_device()
        self.device = torch.device(device)
        self._source = source
        self._put = device_put
        self._q = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = None
        self._stream = None
        # a batch in the queue, one being consumed and one being filled
        self._ring = _PinnedRing(self.depth + 2)

    # -- producer ----------------------------------------------------------
    def _stage(self, item):
        if self.device.type != "cuda":
            return _Staged(_map_item(item, torch.as_tensor), None, ())
        slot, bufs = self._ring.take()
        tensors = []
        counter = iter(range(1 << 30))

        def put(v):
            host = torch.as_tensor(v)
            key = next(counter)
            buf = bufs.get(key)
            if (buf is None or buf.shape != host.shape
                    or buf.dtype != host.dtype):
                buf = bufs[key] = torch.empty(host.shape, dtype=host.dtype,
                                              pin_memory=True)
            buf.copy_(host)
            dev = buf.to(self.device, non_blocking=True)
            tensors.append(dev)
            return dev

        with torch.cuda.stream(self._stream):
            staged = _map_item(item, put)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._ring.done(slot, event)
        return _Staged(staged, event, tensors)

    def _producer(self):
        try:
            it = self._source() if callable(self._source) else \
                iter(self._source)
            for item in it:
                staged = self._stage(item) if self._put else \
                    _Staged(item, None, ())
                if not self._offer(staged):
                    return
            self._offer(_End())
        except BaseException as e:  # noqa: BLE001 - re-raised by consumer
            self._offer(_Raise(e))

    def _offer(self, payload):
        """Bounded put that gives up when the consumer closed early (a
        plain Queue.put would block the thread forever)."""
        while not self._stop.is_set():
            try:
                self._q.put(payload, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer ----------------------------------------------------------
    def __iter__(self):
        if self._thread is None:
            if self.device.type == "cuda" and self._put:
                self._stream = torch.cuda.Stream(self.device)
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._producer, name="paddle-gpu-prefetch",
                daemon=True)
            self._thread.start()
        return self

    def __next__(self):
        if self._thread is None:
            iter(self)
        hit = not self._q.empty()
        obs.inc("pipeline.prefetch_hit" if hit else
                "pipeline.prefetch_miss")
        t0 = time.monotonic()
        payload = self._q.get()
        if obs.enabled():
            obs.observe("pipeline.prefetch_wait_ms",
                        (time.monotonic() - t0) * 1000.0)
        # blocked-on-input wall since the last ledger mark
        obs.goodput.mark("input_wait")
        if isinstance(payload, _End):
            self.close()
            raise StopIteration
        if isinstance(payload, _Raise):
            self.close()
            raise payload.exc
        if payload.event is not None:
            # the consumer's stream waits for the copies; the allocator
            # keeps the tensors until that stream's work on them is done
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(payload.event)
            for t in payload.tensors:
                t.record_stream(stream)
        return payload.item

    def close(self):
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            # unblock a producer parked on the bounded queue
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)
        self._thread = None

    def __enter__(self):
        iter(self)
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def prefetch_to_device(reader, depth=None, device_put=True, device=None):
    """Reader decorator form of PrefetchingFeeder: wraps a batch or
    feed-dict reader so each epoch's batches are staged onto ``device``
    ``depth`` ahead (a new producer thread an epoch)."""

    def data_reader():
        feeder = PrefetchingFeeder(reader, depth=depth,
                                   device_put=device_put, device=device)
        try:
            for item in feeder:
                yield item
        finally:
            feeder.close()

    return data_reader
