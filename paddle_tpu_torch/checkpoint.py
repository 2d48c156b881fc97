"""Async sharded checkpointing — port of ``paddle_tpu/checkpoint.py``
(SURVEY §5: the equivalent of the reference's save-op machinery —
python/paddle/fluid/io.py:441 save_persistables +
operators/save_combine_op.cc — re-designed as a background writer
instead of save ops on the step thread).

The on-disk layout is the JAX package's, byte for byte, so a checkpoint
either package writes restores in the other:

    <root>/step_<N>/
        manifest.json     {"step": N, "process": p, "process_count": P,
                           "vars": {name: {"global_shape", "dtype",
                           "pieces": [{"file", "index"}]}}}
        <var>.npy         one file per var (per piece when the JAX
                          package saved an array sharded over a mesh)

``index`` records each piece's slice into the global shape; restore
reassembles the pieces of every ``step_N.procI`` directory of a
multi-process layout. A bfloat16 value, which numpy lacks, is written as
the JAX package writes one (``np.save`` of an ``ml_dtypes.bfloat16``
array): a ``'<V2'`` ``.npy`` of its 2-byte patterns, ``"dtype":
"bfloat16"`` in the manifest; restore views the bytes as
``torch.bfloat16``.

The snapshot, where the port differs from the JAX design. The JAX engine
donates its state buffers and makes new ones each step; the port's
captured step writes the persistable state IN PLACE, into the same scope
tensors, at every replay. So ``save`` snapshots the CUDA tensors with a
device copy on the current stream — the stream the engine replays on —
ordered after the step that wrote them and before the next replay that
overwrites them: one ``torch.cat`` of the tensors of each dtype into a
flat buffer, then an event recorded on that stream. That is all the
step thread pays. The writer thread, when it takes the snapshot, copies
each flat buffer into pinned host memory on the manager's copy stream,
which waits on that event, and waits on the copy's own event before it
touches the bytes; the transfer overlaps training. The device copies
live until their transfer has run, so ``max_pending`` bounds them. The
pinned memory is one buffer a (device, dtype), sized to the largest
snapshot and kept by the manager for its lifetime: the single writer
reuses it for every save, so no save after the first allocates pinned
memory, however short the interval between saves. A CPU tensor is
cloned; a numpy value is captured by reference (nothing mutates it —
``scope.set`` rebinds).

Cross-root replication + quorum: with ``replica_roots`` configured and
``PADDLE_GPU_CKPT_REPLICAS`` (or the ``replicas`` ctor arg) > 0, the
writer mirrors each published step dir to up to k peer roots,
byte-for-byte, under ``<peer_root>/.replicas/<basename(my_root)>/`` —
the same atomic tmp+rename publication, so a peer never sees a half
replica. Reads then become a majority vote over (local root + replica
locations): a torn local-only save — published locally, crashed before
mirroring — cannot win ``latest_step()``, and a rank whose local root
died restores its files from a peer's replica, byte-identical.
Replication off (the default) leaves single-root behavior as it is.
"""

import json
import os
import re
import shutil
import threading
import time
import warnings

import numpy as np
import torch

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)(?:\.proc(\d+))?$")


class _ShardMissingError(FileNotFoundError):
    """A step that looks complete (manifest present) lost a shard file
    at every location holding it — restore falls back a step."""


def _read_manifest(step_dir):
    """The dir's parsed manifest.json, or None when it is missing,
    truncated, or unparsable — the signature of a crash mid-write. A
    None manifest makes the dir invisible to restore/latest_step, so
    recovery falls back to the previous COMPLETE step instead of raising
    into the face of a supervisor that is trying to restart the job."""
    path = os.path.join(step_dir, "manifest.json")
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        warnings.warn(
            "skipping checkpoint dir %s: corrupt manifest (%s)"
            % (step_dir, e), RuntimeWarning)
        from paddle_tpu_torch import observability as obs

        obs.inc("recovery.ckpt_corrupt")
        obs.event("ckpt.corrupt_manifest", dir=step_dir,
                  error=str(e)[:200])
        return None


def _save_synced(path, arr, dtype):
    """np.save + fsync: the atomic-rename publication is only crash-safe
    if the DATA pages are durable before the rename, not just the
    manifest. A bfloat16 array (``arr`` its uint16 patterns) gets the
    header ``np.save`` writes for an ``ml_dtypes.bfloat16`` array."""
    with open(path, "wb") as f:
        if dtype == "bfloat16":
            np.lib.format.write_array_header_1_0(f, {
                "descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
            f.write(np.ascontiguousarray(arr).tobytes())
        else:
            np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _DeviceCopy:
    """The CUDA tensors of one (device, dtype) in a snapshot: their flat
    device copy, the event recorded after it on the step's stream, and,
    once the writer has moved it, its view of the pinned buffer."""

    __slots__ = ("flat", "ready", "host")

    def __init__(self, flat, ready):
        self.flat = flat
        self.ready = ready
        self.host = None


class _Piece:
    """One CUDA tensor of a snapshot: its place in a ``_DeviceCopy``."""

    __slots__ = ("copy", "offset", "shape")

    def __init__(self, copy, offset, shape):
        self.copy = copy
        self.offset = offset
        self.shape = shape

    def tensor(self):
        n = int(np.prod(self.shape, dtype=np.int64))
        return self.copy.host[self.offset:self.offset + n].view(self.shape)


def _host_array(value):
    """(numpy array, manifest dtype) of one snapshot value; a bfloat16
    tensor comes back as its uint16 bit patterns."""
    if isinstance(value, _Piece):
        value = value.tensor()
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy().view(np.uint16), \
                "bfloat16"
        value = value.numpy()
    host = np.asarray(value)
    return host, str(host.dtype)


def _as_patterns(arr, dtype):
    """A loaded piece as stored in the assembly buffer: a bfloat16 piece
    (a 2-byte void array) as uint16 patterns."""
    return arr.view(np.uint16) if dtype == "bfloat16" else arr


def _restored(arr, dtype):
    """A reassembled var as ``restore`` returns it: numpy, or a CPU
    ``torch.bfloat16`` tensor for a bfloat16 var."""
    if dtype != "bfloat16":
        return arr
    patterns = np.ascontiguousarray(_as_patterns(arr, dtype))
    return torch.from_numpy(patterns.view(np.int16)).view(torch.bfloat16)


class CheckpointManager:
    """Background-thread checkpoint writer with atomic publication.

    save() captures a snapshot (see the module docstring) and returns
    immediately; the device->host transfer and the file writes happen on
    ONE persistent daemon writer thread consuming a bounded pending
    queue, so the step thread never joins a previous save either.

    A checkpoint directory appears under its final name only when
    complete (write to ``.step_N.tmp``, fsync, ``os.rename``) — a crash
    mid-save can never publish a half checkpoint. The single writer
    publishes saves in submission order. ``max_pending`` bounds snapshot
    memory (the device copies, until the writer has moved them to the
    host): a checkpoint interval shorter than the write time degrades
    toward synchronous saving (save() blocks until the queue drains below
    the bound) rather than piling up snapshots.
    """

    def __init__(self, root, max_to_keep=3, process_index=None,
                 process_count=None, max_pending=2, replica_roots=None,
                 replicas=None):
        from paddle_tpu_torch import flags

        self.root = root
        self.max_to_keep = max_to_keep
        self.max_pending = max(1, int(max_pending))
        # cross-root replication: this rank's files mirror to up to
        # ``replicas`` of the given peer roots after each local publish
        # (0 / no peers = off; reads stay single-root)
        if replicas is None:
            replicas = int(flags.get_flag("ckpt_replicas"))
        self.replicas = max(0, int(replicas))
        self.replica_roots = [
            r for r in (replica_roots or [])
            if os.path.abspath(r) != os.path.abspath(root)]
        # process identity resolves LAZILY at first use, so a manager made
        # before torch.distributed.init_process_group sees the group
        self._proc = (process_index, process_count)
        os.makedirs(root, exist_ok=True)
        self._error = None
        self._cv = threading.Condition()
        self._pending = []      # [(step, snapshot)] consumed in order
        self._writing = False
        self._writer = None     # the persistent daemon thread
        self._streams = {}      # device -> the device-to-host copy stream
        self._pinned = {}       # (device, dtype) -> the writer's buffer

    def _resolve_proc(self):
        pi, pc = self._proc
        if pi is None or pc is None:
            import torch.distributed as dist

            up = dist.is_available() and dist.is_initialized()
            if pi is None:
                pi = dist.get_rank() if up else 0
            if pc is None:
                pc = dist.get_world_size() if up else 1
            self._proc = (pi, pc)
        return pi, pc

    @property
    def process_index(self):
        return self._resolve_proc()[0]

    @property
    def process_count(self):
        return self._resolve_proc()[1]

    def _dirname(self, step):
        """Single-process keeps the plain 'step_N' layout; multi-process
        runs publish one 'step_N.procI' directory a process so saves on a
        shared filesystem never collide."""
        pi, pc = self._resolve_proc()
        if pc <= 1:
            return os.path.join(self.root, "step_%d" % step)
        return os.path.join(self.root, "step_%d.proc%d" % (step, pi))

    # -- save --------------------------------------------------------------
    def save(self, step, arrays, blocking=False):
        """``arrays``: {name: tensor or array-like}. Captures a snapshot
        now (the step thread's only cost), enqueues it for the persistent
        writer thread, and returns without joining any in-flight write.
        Raises any previous save's error (a failed async save surfaces on
        the next interaction). A full pending queue (``max_pending``)
        blocks until the writer drains — bounded memory over unbounded
        pile-up."""
        from paddle_tpu_torch import observability as obs

        self.check_error()
        t0 = time.perf_counter()
        snapshot = self._snapshot(arrays)
        obs.observe("ckpt.snapshot_ms",
                    (time.perf_counter() - t0) * 1000.0)
        with self._cv:
            self._ensure_writer()
            self._pending.append((int(step), snapshot))
            obs.set_gauge("ckpt.pending", len(self._pending))
            self._cv.notify_all()
            while len(self._pending) > self.max_pending:
                obs.inc("ckpt.backpressure_waits")
                self._cv.wait()
        if blocking:
            self.wait()
            self.check_error()

    def _snapshot(self, arrays):
        """{name: snapshot value}: CUDA tensors copied on the current
        stream into one flat buffer a (device, dtype), an event recorded
        after them; CPU tensors cloned; the rest by reference."""
        snapshot, on_card = {}, {}
        for name, arr in arrays.items():
            if isinstance(arr, torch.Tensor):
                if arr.is_cuda:
                    on_card.setdefault(arr.device, {}).setdefault(
                        arr.dtype, []).append((name, arr))
                    snapshot[name] = None      # keeps the caller's order
                else:
                    snapshot[name] = arr.detach().clone()
            else:
                snapshot[name] = arr
        for device, groups in on_card.items():
            # ordered after the step that wrote each tensor, before the
            # next replay that overwrites it in place
            flats = [torch.cat([t.detach().reshape(-1) for _, t in named])
                     for named in groups.values()]
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
            for named, flat in zip(groups.values(), flats):
                copy, offset = _DeviceCopy(flat, ready), 0
                for name, t in named:
                    snapshot[name] = _Piece(copy, offset, tuple(t.shape))
                    offset += t.numel()
        return snapshot

    def _to_host(self, snapshot):
        """Writer thread: move every device copy of ``snapshot`` into the
        manager's pinned buffers on the copy stream, after the event the
        step thread recorded, and wait for the transfer. The device
        copies are freed then (their transfer has run)."""
        copies = {id(v.copy): v.copy for v in snapshot.values()
                  if isinstance(v, _Piece)}
        done = []
        for copy in copies.values():
            flat = copy.flat
            key = (flat.device, flat.dtype)
            buf = self._pinned.get(key)
            if buf is None or buf.numel() < flat.numel():
                buf = self._pinned[key] = torch.empty(
                    flat.numel(), dtype=flat.dtype, pin_memory=True)
            copier = self._streams.get(flat.device)
            if copier is None:
                copier = self._streams[flat.device] = torch.cuda.Stream(
                    flat.device)
            copier.wait_event(copy.ready)
            with torch.cuda.stream(copier):
                copy.host = buf[:flat.numel()]
                copy.host.copy_(flat, non_blocking=True)
                event = torch.cuda.Event()
                event.record(copier)
            done.append(event)
        for event in done:
            event.synchronize()
        for copy in copies.values():
            copy.flat = copy.ready = None

    def _ensure_writer(self):
        """Start (or restart, should it ever die) the persistent writer
        under self._cv."""
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, name="paddle-gpu-ckpt-writer",
                daemon=True)
            self._writer.start()

    def _writer_loop(self):
        while True:
            with self._cv:
                while not self._pending:
                    self._cv.wait()
                step, snapshot = self._pending.pop(0)
                self._writing = True
                self._cv.notify_all()
            try:
                self._write(step, snapshot)
            finally:
                # the snapshot's device copies go now, not when the next
                # save arrives
                snapshot = None
                with self._cv:
                    self._writing = False
                    self._cv.notify_all()

    def _write(self, step, snapshot):
        """Writer-thread entry: the device-to-host transfer, then the
        write attempt under the shared retry policy (resilience.retrying)
        so transient filesystem errors — or an injected ckpt_write fault
        — cost a backoff-spaced re-attempt, not the checkpoint. Each
        attempt restarts from a clean tmp dir; only exhaustion surfaces
        via check_error(). ``ckpt.write_ms`` observes the wall from the
        transfer to the publish of a save that succeeded."""
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.resilience.faultinject import InjectedFault
        from paddle_tpu_torch.resilience.retrying import Backoff, retry_call

        t0 = time.perf_counter()
        try:
            self._to_host(snapshot)
        except Exception as e:                        # noqa: BLE001
            self._error = e
            return

        def _on_retry(e, attempt, delay):
            obs.inc("recovery.ckpt_retry")
            obs.event("ckpt.write_retry", step=step, attempt=attempt,
                      error=str(e)[:200])

        try:
            retry_call(self._write_attempt, step, snapshot,
                       retry_on=(OSError, InjectedFault), attempts=3,
                       backoff=Backoff(base=0.05, cap=1.0, jitter=0.5,
                                       seed=step),
                       on_retry=_on_retry)
        except Exception as e:                        # noqa: BLE001
            self._error = e
            return
        obs.observe("ckpt.write_ms", (time.perf_counter() - t0) * 1000.0)
        # replicate AFTER the local publish succeeded, still on the
        # writer thread (a blocking save's wait() covers the mirror
        # too). Best-effort: a dead peer costs this step its quorum
        # vote there, never the local checkpoint.
        self._mirror(step)

    def _write_attempt(self, step, snapshot):
        final = self._dirname(step)
        tmp = os.path.join(self.root,
                           "." + os.path.basename(final) + ".tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        pi, pc = self._resolve_proc()
        manifest = {"step": step, "process": pi,
                    "process_count": pc, "vars": {}}
        for name, value in snapshot.items():
            # the port holds every value whole (one replica a process
            # under torch.distributed), so process 0 alone writes it, as
            # the JAX package writes a replicated array once
            if pi != 0:
                continue
            host, dtype = _host_array(value)
            fname = name.replace("/", "__")
            _save_synced(os.path.join(tmp, fname + ".npy"), host, dtype)
            manifest["vars"][name] = {
                "global_shape": list(host.shape),
                "dtype": dtype,
                "pieces": [{"file": fname + ".npy", "index": None}],
            }
        # fault point at the mid-write seam: var files exist, manifest
        # does not yet — the state a crash here leaves behind is exactly
        # what _read_manifest's fallback is for
        from paddle_tpu_torch.resilience.faultinject import fault_point

        fault_point("ckpt_write", step=step)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)                # file entries durable pre-rename
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)                     # atomic publish
        # a re-save of the same step under a DIFFERENT world size
        # must not leave the other layout's dirs to shadow this one
        # at restore time (process 0 cleans; peers' same-layout proc
        # dirs are of course kept)
        mine = os.path.basename(final)
        if pi == 0:
            for d in os.listdir(self.root):
                m = _STEP_RE.match(d)
                if not m or int(m.group(1)) != step or d == mine:
                    continue
                other_layout = (m.group(2) is not None) != (pc > 1)
                if other_layout:
                    shutil.rmtree(os.path.join(self.root, d),
                                  ignore_errors=True)
        _fsync_dir(self.root)                     # durable dir entry
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        if not self.max_to_keep or not steps:
            return
        kept = steps[-self.max_to_keep:]
        # prune everything OLDER than the kept window — including
        # incomplete orphans from crashed saves, which never appear in
        # all_steps and would otherwise accumulate forever. Dirs newer
        # than the newest complete step are in-progress peers: kept.
        for d in os.listdir(self.root):
            m = _STEP_RE.match(d)
            if m and int(m.group(1)) < kept[0]:
                shutil.rmtree(os.path.join(self.root, d),
                              ignore_errors=True)

    # -- replication -------------------------------------------------------
    def _replica_dirs(self):
        """The peer locations this rank's steps mirror to (empty =
        replication off). Namespaced by the local root's basename so
        several ranks can share one peer root without colliding."""
        if not self.replicas or not self.replica_roots:
            return []
        base = os.path.basename(os.path.abspath(self.root))
        return [os.path.join(r, ".replicas", base)
                for r in self.replica_roots[:self.replicas]]

    def _mirror(self, step):
        """Copy the just-published step dir(s) to each replica location
        with the same tmp+rename atomic publication, then apply the
        max_to_keep window there. Writer-thread only."""
        from paddle_tpu_torch import observability as obs

        final = self._dirname(step)
        base = os.path.basename(final)
        if not os.path.isdir(final):
            return
        for rd in self._replica_dirs():
            try:
                os.makedirs(rd, exist_ok=True)
                tmp = os.path.join(rd, "." + base + ".tmp")
                shutil.rmtree(tmp, ignore_errors=True)
                shutil.copytree(final, tmp)
                _fsync_dir(tmp)
                dst = os.path.join(rd, base)
                shutil.rmtree(dst, ignore_errors=True)
                os.rename(tmp, dst)
                _fsync_dir(rd)
                if self.max_to_keep:
                    have = sorted(
                        int(m.group(1)) for m in
                        (_STEP_RE.match(d) for d in os.listdir(rd)) if m)
                    cut = (have[-self.max_to_keep:] or [0])[0]
                    for d in os.listdir(rd):
                        m = _STEP_RE.match(d)
                        if m and int(m.group(1)) < cut:
                            shutil.rmtree(os.path.join(rd, d),
                                          ignore_errors=True)
            except OSError as e:
                warnings.warn(
                    "checkpoint replica to %s failed (%s) — step %d has "
                    "no quorum vote there" % (rd, e, step),
                    RuntimeWarning)
                obs.inc("recovery.ckpt_replica_failed")
                obs.event("ckpt.replica_failed", step=step, dest=rd,
                          error=str(e)[:200])
                continue
            obs.inc("recovery.ckpt_replicated")
            obs.event("ckpt.replicated", step=step, dest=rd)

    # -- lifecycle ---------------------------------------------------------
    def wait(self):
        """Block until every enqueued save has been written (the
        rollback seam: join the snapshot before restoring)."""
        with self._cv:
            while self._pending or self._writing:
                self._cv.wait()

    def check_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    @property
    def in_flight(self):
        with self._cv:
            return bool(self._pending or self._writing)

    # -- restore -----------------------------------------------------------
    def _step_dirs(self, step=None, root=None):
        """{step: [(dir, manifest), ...]} of COMPLETE checkpoints (every
        process dir named by the recorded process_count must be present,
        every manifest readable — a missing/truncated/unparsable
        manifest marks a mid-write crash and hides the dir, see
        _read_manifest). When a root holds BOTH layouts for one step
        (re-saved under a different world size and the cleanup raced),
        the set with the newest manifest wins — never a silent mix.
        ``root`` defaults to the local root; quorum reads pass a
        replica location instead."""
        root = self.root if root is None else root
        found = {}
        try:
            entries_on_disk = os.listdir(root)
        except OSError:
            return {}        # location gone entirely (dead disk/peer)
        for d in entries_on_disk:
            m = _STEP_RE.match(d)
            if not m:
                continue
            s = int(m.group(1))
            if step is not None and s != step:
                continue
            path = os.path.join(root, d)
            manifest = _read_manifest(path)
            if manifest is None:
                continue
            is_proc = m.group(2) is not None
            found.setdefault(s, {}).setdefault(is_proc, []).append(
                (path, manifest))
        complete = {}
        for s, by_layout in found.items():
            candidates = []
            for entries in by_layout.values():
                entries = sorted(entries)
                want = entries[0][1].get("process_count", 1)
                if len(entries) < want:
                    continue
                try:
                    newest = max(os.path.getmtime(
                        os.path.join(d, "manifest.json"))
                        for d, _ in entries)
                except OSError:
                    continue        # dir raced away under a peer's gc
                candidates.append((newest, entries))
            if candidates:
                complete[s] = max(candidates)[1]
        return complete

    def all_steps(self):
        """Sorted complete steps. Single-root: exactly the local dirs.
        With replication configured: a majority vote over the locations
        that hold ANY complete step (an empty/poisoned location is not
        a voter — else a wiped disk would veto the surviving replicas)
        — a step published on a minority of locations (the torn-save
        signature: local publish, crash before mirror) does not
        appear."""
        replica_dirs = self._replica_dirs()
        if not replica_dirs:
            return sorted(self._step_dirs())
        votes = {}
        voters = 0
        for loc in [self.root] + replica_dirs:
            steps = set(self._step_dirs(root=loc))
            if not steps:
                continue
            voters += 1
            for s in steps:
                votes[s] = votes.get(s, 0) + 1
        if not voters:
            return []
        need = voters // 2 + 1
        return sorted(s for s, v in votes.items() if v >= need)

    def latest_step(self):
        steps = self.all_steps()
        best = steps[-1] if steps else None
        if self._replica_dirs():
            # a local step NEWER than the quorum winner lost the vote —
            # the torn-save forensic record (ckpt.quorum_reject)
            torn = [s for s in sorted(self._step_dirs())
                    if best is None or s > best]
            if torn:
                from paddle_tpu_torch import observability as obs

                obs.inc("recovery.ckpt_quorum_reject")
                obs.event("ckpt.quorum_reject", steps=torn, chosen=best)
        return best

    def restore(self, step=None):
        """-> {name: np.ndarray} reassembled to global shape, merging
        every process's manifest (multi-process layouts); a bfloat16 var
        comes back as a CPU ``torch.bfloat16`` tensor.

        Degraded-read ladder: the local root is tried first; a step
        whose local dir lost a shard file (bit rot, partial disk loss)
        or is gone entirely is retried from each replica location
        (``ckpt.quorum_restore`` — byte-identical, the mirror is a
        file copy); only when NO location can serve the step does
        restore fall back to the previous complete step
        (``ckpt.missing_shard`` + ``ckpt.restore_fallback``, mirroring
        the corrupt-manifest fallback). An EXPLICITLY requested step
        that is absent everywhere still raises — only a step that
        looks complete but cannot be read falls back."""
        explicit = step is not None
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint under %s" % self.root)
        steps = self.all_steps()
        tries = [step] + [s for s in reversed(steps) if s < step]
        last_err = None
        for i, s in enumerate(tries):
            try:
                out = self._restore_step(s)
            except _ShardMissingError as e:
                from paddle_tpu_torch import observability as obs

                obs.inc("recovery.ckpt_restore_fallback")
                obs.event("ckpt.restore_fallback", step=s,
                          error=str(e)[:200])
                last_err = e
                continue
            except FileNotFoundError as e:
                if i == 0 and explicit:
                    raise        # the requested step never existed
                last_err = e
                continue
            if i > 0:
                warnings.warn(
                    "checkpoint step %s unreadable; restored step %s "
                    "instead" % (step, s), RuntimeWarning)
            return out
        raise FileNotFoundError(
            "no readable checkpoint under %s (tried steps %s)"
            % (self.root, tries)) from last_err

    def _restore_step(self, step):
        """Load one step, trying the local root then each replica
        location. Raises FileNotFoundError when no location holds the
        step, _ShardMissingError when every location that holds it is
        missing a shard file."""
        shard_err = None
        for li, loc in enumerate([self.root] + self._replica_dirs()):
            entries = self._step_dirs(step, root=loc).get(step)
            if not entries:
                continue
            try:
                out = self._load_entries(entries)
            except (FileNotFoundError, OSError, ValueError) as e:
                from paddle_tpu_torch import observability as obs

                warnings.warn(
                    "checkpoint step %d at %s is missing a shard file "
                    "(%s)" % (step, loc, e), RuntimeWarning)
                obs.inc("recovery.ckpt_missing_shard")
                obs.event("ckpt.missing_shard", step=step, location=loc,
                          error=str(e)[:200])
                shard_err = e
                continue
            if li > 0:
                from paddle_tpu_torch import observability as obs

                obs.inc("recovery.ckpt_quorum_restore")
                obs.event("ckpt.quorum_restore", step=step, source=loc)
            return out
        if shard_err is not None:
            raise _ShardMissingError(
                "checkpoint step %s unreadable at every location"
                % step) from shard_err
        raise FileNotFoundError(
            "checkpoint step %s incomplete or absent under %s"
            % (step, self.root))

    @staticmethod
    def _load_entries(entries):
        out = {}
        filled = {}
        dtypes = {}
        for d, manifest in entries:
            for name, spec in manifest["vars"].items():
                pieces = spec["pieces"]
                dtype = dtypes.setdefault(name, spec["dtype"])
                if name not in out:
                    if (len(pieces) == 1 and pieces[0]["index"] is None
                            and len(entries) == 1):
                        out[name] = np.load(
                            os.path.join(d, pieces[0]["file"]))
                        continue
                    # numpy has no bfloat16: its pieces assemble as
                    # their 2-byte patterns
                    out[name] = np.zeros(
                        spec["global_shape"],
                        np.uint16 if dtype == "bfloat16"
                        else np.dtype(dtype))
                    filled[name] = set()
                full = out[name]
                for p in pieces:
                    key = (None if p["index"] is None
                           else tuple(map(tuple, p["index"])))
                    if key in filled.get(name, set()):
                        continue   # replicated piece seen from a peer
                    arr = np.load(os.path.join(d, p["file"]))
                    sl = (tuple(slice(a, b) for a, b in p["index"])
                          if p["index"] is not None else Ellipsis)
                    full[sl] = _as_patterns(arr, dtype)
                    filled.setdefault(name, set()).add(key)
        return {name: _restored(arr, dtypes[name])
                for name, arr in out.items()}
