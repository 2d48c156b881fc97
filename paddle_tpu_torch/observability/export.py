"""Streaming telemetry export: JSONL sinks + the flight recorder.

Port of ``paddle_tpu/observability/export.py`` (pure Python, kept as the
port's own copy). The tracer's in-memory span list bounds a long serving
loop by *dropping*; with a sink attached ``SpanTracer._add`` hands every
finished span to the sink instead of appending, so tracer memory stays
bounded (the flight recorder's ring) and ``dropped()`` stays 0 on an
unbounded loop.

Two pieces:

* **JsonlSink** — an append-only file of one-line JSON events (spans,
  instant events, periodic metric snapshots) with size-based rotation:
  when the live file crosses ``rotate_bytes`` it is atomically renamed
  to ``<path>.<seq>`` (``os.replace``) and a fresh file is opened, so a
  tail-follower (``SinkTail``) always sees complete lines. Multi-process
  runs write one sink per process, tagged ``<base>.h<rank><ext>`` (see
  ``host_tagged_path``), and every event carries a ``"host"`` field.

* **FlightRecorder** — an always-cheap ring buffer (deque append, no
  lock) keeping the last N spans/events in RAM even after the tracer
  would have dropped them or the sink streamed them to disk: the
  post-mortem window a crashed run is diagnosed from.

Event schema (one JSON object per line)::

    {"t": "meta", "host": 0, "pid": 1234, "version": 1, ...}
    {"t": "span", "name": "step", "ts": <us>, "dur": <us>, "tid": ...,
     "depth": 0, "args": {...}, "host": 0}
    {"t": "snap", "ts": <us>, "metrics": <registry.snapshot()>, "host": 0}

Wired through ``observability.attach_sink()`` / the
``PADDLE_GPU_METRICS_SINK`` flag; rotation size and flight-recorder
depth come from ``PADDLE_GPU_METRICS_SINK_ROTATE_MB`` /
``PADDLE_GPU_FLIGHT_RECORDER_DEPTH``.
"""

import collections
import json
import os
import threading
import time

# Default flight-recorder depth when the flag system is not consulted
# (standalone SpanTracer instances in tests).
DEFAULT_FLIGHT_DEPTH = 2048

# Periodic metric-snapshot cadence inside a sink: whichever of the two
# trips first emits a "snap" event carrying registry.snapshot().
SNAPSHOT_EVERY_S = 5.0
SNAPSHOT_EVERY_EVENTS = 5000


def host_tag():
    """This process's host/worker id for telemetry attribution: the
    launcher's trainer id, the generic RANK, else 0."""
    for var in ("PADDLE_TRAINER_ID", "RANK"):
        raw = os.environ.get(var)
        if raw:
            try:
                return int(raw)
            except ValueError:
                pass
    return 0


def host_tagged_path(path, host):
    """``metrics.jsonl`` -> ``metrics.h3.jsonl`` for worker 3.

    Idempotent: a path already carrying this host's tag passes through,
    so the launcher rewriting the env var and a worker re-attaching its
    sink after ``init_distributed`` do not double-tag."""
    base, ext = os.path.splitext(path)
    tag = ".h%d" % host
    if base.endswith(tag):
        return path
    return base + tag + ext


class FlightRecorder:
    """Bounded ring of the most recent SpanRecords/events. Appends are
    a single deque.append (atomic under the GIL) — cheap enough to stay
    on even when nothing else is, which is the point: after a crash the
    last ``depth`` spans are still here."""

    def __init__(self, depth=DEFAULT_FLIGHT_DEPTH):
        self._buf = collections.deque(maxlen=max(1, int(depth)))

    def add(self, rec):
        self._buf.append(rec)

    def records(self):
        return list(self._buf)

    def resize(self, depth):
        depth = max(1, int(depth))
        if depth != self._buf.maxlen:
            self._buf = collections.deque(self._buf, maxlen=depth)

    def clear(self):
        self._buf.clear()

    @property
    def depth(self):
        return self._buf.maxlen

    def __len__(self):
        return len(self._buf)


class JsonlSink:
    """Rotating JSONL event sink.

    ``emit_span`` is called under the tracer lock, so everything here is
    O(write-to-buffered-file); rotation renames are the only filesystem
    metadata operations and amortize over ``rotate_bytes`` of events.
    ``snapshot_fn`` (when given) must not touch the tracer — it runs
    inside the tracer lock; ``registry.snapshot`` is the intended
    callable."""

    def __init__(self, path, rotate_bytes=64 * 2 ** 20, keep=8, host=None,
                 snapshot_fn=None, snapshot_every_s=SNAPSHOT_EVERY_S,
                 snapshot_every_events=SNAPSHOT_EVERY_EVENTS):
        self.path = path
        self.rotate_bytes = int(rotate_bytes)
        self.keep = int(keep)
        self.host = host_tag() if host is None else int(host)
        self._snapshot_fn = snapshot_fn
        self._snapshot_every_s = float(snapshot_every_s)
        self._snapshot_every_events = int(snapshot_every_events)
        self._lock = threading.RLock()
        self._seq = self._next_seq()
        self._events = 0
        self._events_at_snap = 0
        self._last_snap = time.monotonic()
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        self._open()
        self.emit({"t": "meta", "pid": os.getpid(), "version": 1,
                   "rotate_bytes": self.rotate_bytes})

    # -- internals --------------------------------------------------------
    def _next_seq(self):
        """First unused rotation index, so reattaching to an existing
        sink path never clobbers a prior rotation."""
        seq = 0
        for name in self._rotated_paths():
            try:
                seq = max(seq, int(name.rsplit(".", 1)[1]))
            except (IndexError, ValueError):
                continue
        return seq

    def _rotated_paths(self):
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        base = os.path.basename(self.path) + "."
        out = []
        try:
            names = os.listdir(d)
        except OSError:
            return out
        for name in names:
            if name.startswith(base) and name[len(base):].isdigit():
                out.append(os.path.join(d, name))
        out.sort(key=lambda p: int(p.rsplit(".", 1)[1]))
        return out

    def _open(self):
        self._f = open(self.path, "a", encoding="utf-8")
        try:
            self._size = os.fstat(self._f.fileno()).st_size
        except OSError:
            self._size = 0

    def _rotate(self):
        self._f.close()
        self._seq += 1
        os.replace(self.path, "%s.%d" % (self.path, self._seq))
        if self.keep > 0:
            rotated = self._rotated_paths()
            for stale in rotated[: max(0, len(rotated) - self.keep)]:
                try:
                    os.remove(stale)
                except OSError:
                    pass
        self._open()

    # -- emit -------------------------------------------------------------
    def emit(self, event):
        """One event dict -> one JSON line (host field injected)."""
        with self._lock:
            event.setdefault("host", self.host)
            line = json.dumps(event, separators=(",", ":"),
                              default=str) + "\n"
            self._f.write(line)
            self._size += len(line)
            self._events += 1
            if self.rotate_bytes > 0 and self._size >= self.rotate_bytes:
                self._rotate()
            self._maybe_snapshot()

    def emit_span(self, rec):
        """SpanRecord -> "span" event (the SpanTracer._add handoff)."""
        ev = {"t": "span", "name": rec.name, "ts": rec.ts_us,
              "dur": rec.dur_us, "tid": rec.tid, "depth": rec.depth}
        if rec.args:
            ev["args"] = dict(rec.args)
        self.emit(ev)

    def emit_snapshot(self, force=False):
        """Emit a "snap" event carrying the metrics snapshot now."""
        if self._snapshot_fn is None:
            return
        with self._lock:
            self._last_snap = time.monotonic()
            self._events_at_snap = self._events
            try:
                metrics = self._snapshot_fn()
            except Exception:
                return
            self.emit({"t": "snap", "ts": time.time_ns() / 1e3,
                       "metrics": metrics})

    def _maybe_snapshot(self):
        if self._snapshot_fn is None:
            return
        if (time.monotonic() - self._last_snap >= self._snapshot_every_s
                or self._events - self._events_at_snap
                >= self._snapshot_every_events):
            self.emit_snapshot()

    # -- lifecycle --------------------------------------------------------
    def flush(self):
        with self._lock:
            self._f.flush()

    def close(self):
        with self._lock:
            self.emit_snapshot()
            self._f.flush()
            self._f.close()

    def files(self):
        """The sink's current file set, rotation order then live."""
        return self._rotated_paths() + [self.path]


class SinkTail:
    """Incremental reader of a live JSONL sink file (one rotation-safe
    tail for every follower). Yields complete events only (a
    torn final line is retried on the next poll) and survives size-based
    rotation: a shrink means the content moved to ``<path>.<seq>`` — the
    unread tail of the newest rotation is drained first, then the new
    live file from offset 0."""

    def __init__(self, path):
        self.path = path
        self.offset = 0
        self._carry = ""

    def _read_from(self, path, offset):
        try:
            with open(path, encoding="utf-8") as f:
                f.seek(offset)
                data = f.read()
        except OSError:
            return "", offset
        return data, offset + len(data)

    def _newest_rotation(self):
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        base = os.path.basename(self.path) + "."
        best, best_seq = None, -1
        try:
            names = os.listdir(d)
        except OSError:
            return None
        for name in names:
            if name.startswith(base) and name[len(base):].isdigit():
                seq = int(name[len(base):])
                if seq > best_seq:
                    best, best_seq = os.path.join(d, name), seq
        return best

    def poll(self):
        """-> list of new event dicts since the last poll."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            size = 0
        chunks = []
        if size < self.offset:
            # rotated away: drain what we had not read from the segment
            # that now lives under the newest rotation suffix
            rotated = self._newest_rotation()
            if rotated:
                data, _ = self._read_from(rotated, self.offset)
                chunks.append(data)
            self.offset = 0
        data, self.offset = self._read_from(self.path, self.offset)
        chunks.append(data)
        text = self._carry + "".join(chunks)
        lines = text.split("\n")
        self._carry = lines.pop()  # "" on a complete final line
        events = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                continue
        return events

