"""Parameter-server runtime — port of ``paddle_tpu/distributed/ps.py``:
the live transport behind the DistributeTranspiler's pserver mode.

Reference: the C++ RPC stack — RPCClient/RPCServer with VariableMessage
serde (paddle/fluid/operators/distributed/grpc/grpc_serde.cc,
send_recv.proto.in), request handlers with send/get/fetch barriers
(request_handler_impl.cc), and the listen_and_serv sync loop that waits for
all trainers' gradients, runs one optimizer sub-block per parameter, then
serves Get until the fetch barrier (listen_and_serv_op.cc:107-176
RunSyncLoop). Graceful shutdown mirrors Executor::Close → SendComplete.

The protocol state machine and the length-prefixed TCP framing are the
JAX package's, byte for byte, so a port trainer talks to a JAX-package
server and back. Gradients from N trainers are averaged on the host, then
each parameter's optimizer sub-block runs on the port's engine: on the
card by default (``CUDAPlace(0)``), on the CPU when the caller passes
``place=CPUPlace()``. Every step moves the gradients device-to-host and
the parameters host-to-device (the wire carries host arrays); state the
engine reads is written in place, so a captured step stays bound.
``DistTrainer.step_ms`` splits the last step's wall into the engine's
run, the RPCs and the host copies; ``PSClient`` counts the bytes it sends
and receives.
"""

import socket
import struct
import threading
import time

import numpy as np
import torch


# -- framing ---------------------------------------------------------------
#
# Typed wire format — the analog of the reference's VariableMessage proto
# (send_recv.proto.in): a message is a tuple of str / array fields, each
# self-describing. No pickle: nothing received from the socket is ever
# interpreted as code, mirroring the reference's typed zero-copy serde
# (grpc_serde.cc).
#
#   frame   := <Q total_len> payload
#   payload := <B nfields> field*
#   field   := 0x01 <I len> utf8-bytes                    (str)
#            | 0x02 <B dlen> dtype-utf8 <B ndim> <Q>*ndim raw-bytes (ndarray)
#
# numpy has no bfloat16: a bfloat16 field goes on the wire as its raw
# 16-bit words under the tag "bfloat16" (the bytes the JAX package's
# ml_dtypes arrays send) and is read back as a CPU torch.bfloat16 tensor.

_TAG_STR = 1
_TAG_ARR = 2

_ALLOWED_DTYPES = frozenset([
    "float16", "bfloat16", "float32", "float64",
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "bool",
])


def _wire_array(f):
    """(dtype name, shape, raw bytes) of an array field: a numpy array
    (any dtype named on the wire list, an ml_dtypes bfloat16 one too) or
    a torch tensor (moved to the host)."""
    if isinstance(f, torch.Tensor):
        t = f.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), \
                t.view(torch.int16).numpy().tobytes()
        f = t.numpy()
    arr = np.ascontiguousarray(f)
    return arr.dtype.name, arr.shape, arr.tobytes()


def _encode_msg(fields):
    parts = [struct.pack("<B", len(fields))]
    for f in fields:
        if isinstance(f, str):
            b = f.encode("utf-8")
            parts.append(struct.pack("<BI", _TAG_STR, len(b)))
            parts.append(b)
        else:
            name, shape, raw = _wire_array(f)
            # Enforce the wire contract on the sending side too, so a bad
            # call fails fast with a local traceback instead of a remote
            # decode error.
            if name not in _ALLOWED_DTYPES:
                raise TypeError(
                    "cannot send field of type %s/dtype %s over the "
                    "pserver wire" % (type(f).__name__, name))
            dt = name.encode("utf-8")
            parts.append(struct.pack("<BB", _TAG_ARR, len(dt)))
            parts.append(dt)
            parts.append(struct.pack("<B", len(shape)))
            parts.append(struct.pack("<%dQ" % len(shape), *shape))
            parts.append(raw)
    return b"".join(parts)


def _decode_msg(body):
    (nfields,) = struct.unpack_from("<B", body, 0)
    off = 1
    fields = []
    for _ in range(nfields):
        (tag,) = struct.unpack_from("<B", body, off)
        off += 1
        if tag == _TAG_STR:
            (n,) = struct.unpack_from("<I", body, off)
            off += 4
            fields.append(body[off:off + n].decode("utf-8"))
            off += n
        elif tag == _TAG_ARR:
            (dlen,) = struct.unpack_from("<B", body, off)
            off += 1
            dtype = body[off:off + dlen].decode("ascii")
            off += dlen
            if dtype not in _ALLOWED_DTYPES:
                raise ValueError("disallowed dtype on wire: %r" % dtype)
            (ndim,) = struct.unpack_from("<B", body, off)
            off += 1
            shape = struct.unpack_from("<%dQ" % ndim, body, off)
            off += 8 * ndim
            count = int(np.prod(shape, dtype=np.int64))
            if dtype == "bfloat16":
                n = count * 2
                words = np.frombuffer(body[off:off + n], dtype=np.int16)
                arr = torch.from_numpy(words.copy()).view(
                    torch.bfloat16).reshape(shape)
            else:
                dt = np.dtype(dtype)
                n = count * dt.itemsize
                arr = np.frombuffer(body[off:off + n],
                                    dtype=dt).reshape(shape)
            off += n
            fields.append(arr)
        else:
            raise ValueError("bad wire tag %d" % tag)
    return tuple(fields)


def _send_msg(sock, obj):
    payload = _encode_msg(obj)
    sock.sendall(struct.pack("<Q", len(payload)) + payload)
    return 8 + len(payload)


def _recv_msg(sock, idle_ok=False, sizes=None):
    """Receive one frame. With ``idle_ok`` (server waiting for a client's
    NEXT request) the wait for the frame header is unbounded — idle
    connections are normal; the deadline still bounds the frame BODY so a
    half-sent frame cannot hang a handler forever. ``sizes`` (a list)
    gets the frame's bytes appended."""
    head = _recv_exact(sock, 8, deadline=None if idle_ok
                       else rpc_deadline_seconds())
    if head is None:
        return None
    (n,) = struct.unpack("<Q", head)
    body = _recv_exact(sock, n, deadline=rpc_deadline_seconds())
    if body is None:
        return None
    if sizes is not None:
        sizes.append(8 + n)
    return _decode_msg(body)


class RpcError(OSError):
    """Typed RPC failure. Peer death is an error the CALLER sees, never a
    bare TypeError in a worker thread (reference: the completion-queue
    status handling of operators/distributed/grpc/grpc_client.cc — a dead
    peer becomes a failed RPC with a message naming the peer)."""


class RpcPeerClosedError(RpcError):
    """The peer closed the connection mid-RPC (EOF before a full reply
    frame arrived)."""


class RpcDeadlineError(RpcError):
    """A peer failed to answer within PADDLE_GPU_RPC_DEADLINE_MS
    (reference: FLAGS_rpc_deadline + the completion-queue timeouts of
    operators/distributed/grpc/grpc_client.cc:64 — a hung peer must fail
    the RPC, not block the trainer forever)."""


def rpc_deadline_seconds():
    from paddle_tpu_torch import flags

    ms = float(flags.get_flag("rpc_deadline_ms"))
    return None if ms <= 0 else ms / 1000.0


def _recv_exact(sock, n, deadline=None):
    prev = sock.gettimeout()
    sock.settimeout(deadline)
    buf = b""
    try:
        while len(buf) < n:
            try:
                chunk = sock.recv(n - len(buf))
            except socket.timeout:
                raise RpcDeadlineError(
                    "RPC deadline exceeded (%.0f ms) waiting for peer %s"
                    % ((deadline or 0) * 1000.0,
                       sock.getpeername() if sock.fileno() >= 0 else "?"))
            if not chunk:
                return None
            buf += chunk
        return buf
    finally:
        try:
            sock.settimeout(prev)
        except OSError:
            pass


# -- host/device values ------------------------------------------------------

def _host(val):
    """A scope value as a host array for the wire: a torch tensor moved to
    the host (a bfloat16 one stays a CPU tensor), a host array as it
    is."""
    if isinstance(val, torch.Tensor):
        t = val.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(val)


def _np_dtype(t):
    return torch.empty(0, dtype=t.dtype).numpy().dtype \
        if isinstance(t, torch.Tensor) else np.dtype(t.dtype)


def _assign(scope, name, value, device):
    """Write ``value`` (a host array or tensor) into ``name``: in place
    when the scope holds a tensor of its shape and dtype (the engine's
    captured steps stay bound to it), else as a new tensor on
    ``device``."""
    src = value if isinstance(value, torch.Tensor) else torch.from_numpy(
        np.require(value, requirements=("C", "W")))
    cur = scope.get(name)
    if (isinstance(cur, torch.Tensor) and cur.shape == src.shape
            and cur.dtype == src.dtype and cur.device == device
            and getattr(cur, "placements", None) is None):
        cur.copy_(src)
    else:
        scope.set(name, src.to(device))


def _sync(device):
    """Wait for this thread's stream: never the whole device, which CUDA
    refuses while another thread's engine captures a graph."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


# -- server ----------------------------------------------------------------

class ParameterServer:
    """Executes one trainer-synchronous update loop per batch.

    Protocol (per connection, any number of requests):
      ("send", var_name, ndarray)  — gradient in
      ("batch_barrier",)           — trainer finished sending this batch
      ("get", var_name)            — parameter out (blocks until updated)
      ("complete",)                — trainer shutting down

    The optimizer sub-blocks run on ``place`` (default the card). Each
    update's wall is kept in ``update_ms`` (the last) and
    ``update_ms_total``/``updates``.
    """

    def __init__(self, pserver_program, startup_program, endpoint, fanin,
                 scope=None, checkpoint_dir=None, place=None):
        import paddle_tpu_torch.fluid as fluid

        self.program = pserver_program
        self.endpoint = endpoint
        self.fanin = fanin
        self.scope = scope if scope is not None else fluid.Scope()
        self.exe = fluid.Executor(place)
        self.device = self.exe.device
        if startup_program is not None:
            self.exe.run(startup_program, scope=self.scope)

        lns = self.program.desc.global_block().ops[-1]
        assert lns.type == "listen_and_serv"
        self.optimize_blocks = list(lns.attrs["optimize_blocks"])
        # Async mode (reference: listen_and_serv_op.cc RunAsyncLoop):
        # each arriving gradient immediately runs its param's optimize
        # block — no barriers, no cross-trainer averaging.
        self.sync_mode = bool(lns.attrs.get("sync_mode", True))
        self._grad_to_block = dict(zip(
            lns.attrs.get("block_grads", []), self.optimize_blocks))

        # Distributed lookup-table shards (reference:
        # distributed/parameter_prefetch.cc + the table optimize block):
        # this server owns rows [start, end) of each table; table-shaped
        # state initialized full-size by the shared startup program is
        # sliced down so no server holds the whole table.
        self.dist_tables = {d["name"]: d
                            for d in lns.attrs.get("dist_tables", [])}
        self._dist_block = {d["block"]: d for d in self.dist_tables.values()}
        for d in self.dist_tables.values():
            for n in d["sliced"]:
                full = self.scope.get(n)
                # slice only FULL-height state (a legacy un-transpiled
                # startup); the per-endpoint startup from
                # get_startup_program already initializes at shard shape
                if full is not None and tuple(full.shape)[0] == d["vocab"]:
                    part = full[d["start"]:d["end"]]
                    self.scope.set(n, part.clone() if isinstance(
                        part, torch.Tensor) else np.array(part))

        self._lock = threading.Condition()
        self._grads = {}          # name -> list of arrays this batch
        self._sparse_grads = {}   # table -> list of (rows, values)
        if checkpoint_dir is not None:
            self.load_checkpoint(checkpoint_dir)
        self._barriers = 0
        self._updated_batch = 0   # generation counter
        self._completed = 0
        self._stop = False
        self.update_ms = None
        self.update_ms_total = 0.0
        self.updates = 0
        host, port = endpoint.rsplit(":", 1)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self._threads = []

    # -- lifecycle ---------------------------------------------------------
    def serve_forever(self):
        accept_thread = threading.Thread(target=self._accept_loop,
                                         daemon=True)
        accept_thread.start()
        with self._lock:
            while not self._stop:
                self._lock.wait(timeout=0.1)
        # Unblock the accept() syscall before closing: closing an fd
        # another thread is blocked in accept() on does NOT cancel the
        # syscall on Linux — the kernel keeps the socket (and the port)
        # alive until accept returns, so a quick restart on the same
        # endpoint would fail with EADDRINUSE.
        try:
            host, port = self.endpoint.rsplit(":", 1)
            socket.create_connection((host, int(port)), timeout=1).close()
        except OSError:
            pass
        accept_thread.join(timeout=2)
        self._sock.close()

    def start(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def stop(self):
        """Stop serving (the accept loop and the sync loop end; open
        connections close as their trainers leave)."""
        with self._lock:
            self._stop = True
            self._lock.notify_all()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    # -- request handling --------------------------------------------------
    def _handle(self, conn):
        try:
            self._handle_loop(conn)
        except (ValueError, TypeError, struct.error) as e:
            # Malformed frame (bad tag / disallowed dtype / truncation):
            # reply with an error if the socket still works, then close so
            # the peer sees EOF instead of blocking until its timeout.
            try:
                _send_msg(conn, ("error", "protocol error: %s" % e))
            except OSError:
                pass
        except OSError:
            pass  # peer vanished mid-frame; nothing to reply to
        finally:
            conn.close()

    def _handle_loop(self, conn):
        while True:
            msg = _recv_msg(conn, idle_ok=True)
            if msg is None:
                return
            try:
                if self._dispatch(conn, msg):
                    return
            except OSError:
                raise
            except Exception as e:
                # A handler failure (optimizer block crash, missing var)
                # is THIS request's failure, not the connection's: reply
                # with a typed error the client raises as RpcError, and
                # keep serving. The reference returns a failed
                # grpc::Status per call (request_handler_impl.cc), never
                # tears down the channel.
                _send_msg(conn, ("error", "%s: %s" % (type(e).__name__, e)))

    def _dispatch(self, conn, msg):
        """Handle one request; returns True when the connection is done."""
        kind = msg[0]
        if kind == "send":
            _, name, arr = msg
            if self.sync_mode:
                with self._lock:
                    self._grads.setdefault(name, []).append(arr)
            else:
                # RunAsyncLoop: apply this trainer's gradient now
                # (serialized by the lock — the consistency level of
                # the reference's per-block executor, without
                # cross-trainer barriers)
                with self._lock:
                    self._apply_async_dense(name, arr)
            _send_msg(conn, ("ok",))
        elif kind == "send_sparse":
            _, name, rows, values = msg
            if self.sync_mode:
                with self._lock:
                    self._sparse_grads.setdefault(name, []).append(
                        (rows, values))
            else:
                with self._lock:
                    self._apply_sparse(name, [(rows, values)], scale=1.0)
            _send_msg(conn, ("ok",))
        elif kind == "checkpoint":
            # reference: checkpoint_notify_op.cc:28 — each pserver
            # saves its own shard of the persistables
            _, dirname = msg
            try:
                with self._lock:
                    self.save_checkpoint(dirname)
                _send_msg(conn, ("ok",))
            except OSError as e:
                _send_msg(conn, ("error", "checkpoint failed: %s" % e))
        elif kind == "prefetch":
            # shard-local row gather (reference:
            # request_handler_impl.cc RequestPrefetchHandler): the gather
            # is enqueued under the lock, so no later optimize block's
            # in-place update of the table can overtake it; the rows
            # alone cross to the host, outside the lock
            _, name, ids = msg
            with self._lock:
                table = self.scope.get(name)
                if isinstance(table, torch.Tensor):
                    rows = table.index_select(0, torch.from_numpy(
                        ids.astype(np.int64)).to(table.device))
                else:
                    rows = np.asarray(table)[ids.astype(np.int64)]
            _send_msg(conn, ("var", _host(rows)))
        elif kind == "batch_barrier":
            if not self.sync_mode:
                # async mode has no barriers (RunAsyncLoop)
                _send_msg(conn, ("ok",))
                return False
            failed = False
            with self._lock:
                self._barriers += 1
                gen = self._updated_batch
                if self._barriers == self.fanin:
                    try:
                        self._run_update()
                        self._updated_batch += 1
                    except Exception:
                        # An update failure while peers are parked in
                        # the wait loop below must not leave the
                        # barrier stuck at fanin — stop the server so
                        # every trainer unblocks; the un-bumped
                        # generation tells them it failed.
                        self._stop = True
                        failed = True
                    self._barriers = 0
                    self._lock.notify_all()
                else:
                    while (self._updated_batch == gen
                           and not self._stop):
                        self._lock.wait(timeout=5)
                    failed = self._stop and self._updated_batch == gen
            if failed:
                _send_msg(conn, ("error", "parameter update failed"))
            else:
                _send_msg(conn, ("ok",))
        elif kind == "get":
            # A device copy taken UNDER the lock (a later optimize block
            # updates the state in place, after this copy on the same
            # stream); the device-to-host transfer then runs OUTSIDE the
            # lock so N trainers' param pulls stay concurrent.
            _, name = msg
            with self._lock:
                val = self.scope.get(name)
                if isinstance(val, torch.Tensor):
                    val = val.clone()
            if val is None:
                raise KeyError("var %r not hosted on %s"
                               % (name, self.endpoint))
            _send_msg(conn, ("var", _host(val)))
        elif kind == "complete":
            with self._lock:
                self._completed += 1
                if self._completed >= self.fanin:
                    self._stop = True
                    self._lock.notify_all()
            _send_msg(conn, ("ok",))
            conn.close()
            return True
        else:
            _send_msg(conn, ("error", "unknown request %r" % kind))
        return False

    def _run_update(self):
        """Average buffered grads, run each optimizer sub-block
        (RunSyncLoop body, listen_and_serv_op.cc:150-160)."""
        t0 = time.perf_counter()
        avg = {
            name: np.mean(np.stack(vals), axis=0)
            for name, vals in self._grads.items()
        }
        self._grads.clear()
        for name, val in avg.items():
            _assign(self.scope, name, val, self.device)
        sparse = {
            name: pairs for name, pairs in self._sparse_grads.items()
        }
        self._sparse_grads.clear()
        for bidx in self.optimize_blocks:
            dist = self._dist_block.get(bidx)
            if dist is None:
                self.exe.engine.run_block(
                    self.program.desc, bidx, self.scope, feed={},
                    fetch_list=[])
                continue
            # NOTE: the block runs even when no trainer touched this shard
            # this batch — its non-gradient ops (Adam beta-pow advance,
            # momentum velocity decay) are per-step state the local run
            # would also apply; a sentinel-only SelectedRows makes the
            # gradient part a no-op. Sync semantics = mean over trainers:
            # scale by 1/fanin, NOT 1/n_senders (a trainer whose batch hit
            # no row of this shard sends nothing — a zero contribution to
            # the mean, not a smaller denominator).
            self._apply_sparse(dist["name"], sparse.get(dist["name"], []),
                               scale=1.0 / self.fanin, block_idx=bidx)
        _sync(self.device)
        self.update_ms = (time.perf_counter() - t0) * 1e3
        self.update_ms_total += self.update_ms
        self.updates += 1

    def _apply_async_dense(self, grad_name, arr):
        bidx = self._grad_to_block.get(grad_name)
        if bidx is None:
            raise ValueError("no optimize block for gradient %r" % grad_name)
        _assign(self.scope, grad_name, arr, self.device)
        self.exe.engine.run_block(
            self.program.desc, bidx, self.scope, feed={}, fetch_list=[])

    def _apply_sparse(self, table_name, pairs, scale, block_idx=None):
        """Run a distributed table's optimize block on (rows, values)
        pairs; rows bucketed to powers of two with the sentinel row so one
        cache entry serves all batch sizes."""
        from paddle_tpu_torch.data_feeder import bucketed_length

        dist = self.dist_tables[table_name]
        if block_idx is None:
            block_idx = dist["block"]
        height = dist["end"] - dist["start"]
        if pairs:
            rows = np.concatenate([r for r, _ in pairs]).astype(np.int64)
            vals = np.concatenate(
                [np.asarray(v) for _, v in pairs]) * scale
        else:
            # shape/dtype metadata only — no table transfer
            table = self.scope.get(table_name)
            rows = np.zeros((0,), np.int64)
            vals = np.zeros((0, table.shape[1]), _np_dtype(table))
        bucket = bucketed_length(len(rows), min_bucket=1)
        if bucket > len(rows):
            pad = bucket - len(rows)
            rows = np.concatenate([rows, np.full(pad, height, np.int64)])
            vals = np.concatenate(
                [vals, np.zeros((pad,) + vals.shape[1:], vals.dtype)])
        self.exe.engine.run_block(
            self.program.desc, block_idx, self.scope,
            feed={table_name + "@GRAD@ROWS": rows,
                  table_name + "@GRAD@VALUES": vals},
            fetch_list=[])

    # -- distributed checkpointing -----------------------------------------
    def _owned_persistables(self):
        """Persistable vars this server's optimize blocks touch — its shard
        of the model (reference: io.py:261 _save_distributed_persistables
        gathers exactly the pserver-side vars)."""
        names = set()
        gb = self.program.desc.global_block()
        for bidx in self.optimize_blocks:
            bd = self.program.desc.block(bidx)
            for op in bd.ops:
                for n in op.input_arg_names() + op.output_arg_names():
                    vd = gb.find_var_recursive(n)
                    if vd is not None and vd.persistable:
                        names.add(n)
        return sorted(names)

    def _checkpoint_path(self, dirname):
        import os

        tag = self.endpoint.replace(":", "_").replace("/", "_")
        return os.path.join(dirname, "pserver_%s.npz" % tag)

    def save_checkpoint(self, dirname):
        """Save this server's shard (reference: checkpoint_notify_op.cc:28
        -> RequestCheckpointHandler saving the owned vars); the file is
        the JAX package's."""
        import os

        os.makedirs(dirname, exist_ok=True)
        arrays = {}
        for n in self._owned_persistables():
            v = self.scope.get(n)
            if v is not None:
                arrays[n] = _host(v)
        # record each table shard's row offset so loaders reassemble in
        # ROW order, not in checkpoint-filename order
        for d in self.dist_tables.values():
            for n in d.get("sliced", []):
                if n in arrays:
                    arrays[n + "@SHARD_START"] = np.asarray(
                        d["start"], np.int64)
        np.savez(self._checkpoint_path(dirname), **arrays)

    def load_checkpoint(self, dirname):
        import os

        path = self._checkpoint_path(dirname)
        if not os.path.exists(path):
            raise FileNotFoundError(
                "no checkpoint for %s at %s" % (self.endpoint, path))
        with np.load(path) as data:
            for n in data.files:
                self.scope.set(n, data[n])


# -- client ----------------------------------------------------------------

def _connect_with_retry(ep, deadline=None):
    """Connect to a pserver endpoint under the shared retry policy
    (resilience.retrying): a trainer routinely starts BEFORE its
    pservers bind — or reconnects while a supervised gang restart is
    still re-binding the port — so connection-refused is a schedule
    fact, not an error, until the overall deadline says otherwise
    (reference: the gRPC channel's reconnect backoff the C++ client
    leans on, grpc_client.cc). The deadline defaults to
    FLAGS rpc_deadline (60s when the deadline flag is disabled)."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.resilience.retrying import Backoff, retry_call

    if deadline is None:
        deadline = rpc_deadline_seconds() or 60.0
    host, port = ep.rsplit(":", 1)

    def _on_retry(e, attempt, delay):
        obs.inc("recovery.rpc_connect_retry")
        obs.event("rpc.connect_retry", endpoint=ep, attempt=attempt,
                  error=str(e)[:200])

    try:
        return retry_call(
            socket.create_connection, (host, int(port)), timeout=5,
            retry_on=(ConnectionRefusedError, ConnectionResetError,
                      ConnectionAbortedError, socket.timeout),
            deadline=deadline,
            backoff=Backoff(base=0.05, factor=2.0, cap=2.0, jitter=0.5),
            on_retry=_on_retry)
    except OSError as e:
        raise RpcError(
            "cannot connect to pserver %s within %.0fs: %s"
            % (ep, deadline, e)) from e


class PSClient:
    """Trainer-side RPC client (reference: distributed/rpc_client.h:32 —
    AsyncSendVar/AsyncGetVar + barriers, SendComplete). Connects
    through the shared backoff/deadline policy so trainer-before-server
    startup ordering and gang restarts resolve instead of crashing.
    ``bytes_sent`` and ``bytes_received`` count the frames it moved."""

    def __init__(self, endpoints, connect_deadline=None):
        self._socks = {}
        self.bytes_sent = 0
        self.bytes_received = 0
        for ep in endpoints:
            self._socks[ep] = _connect_with_retry(ep, connect_deadline)

    def _send(self, sock, msg):
        self.bytes_sent += _send_msg(sock, msg)

    def _reply(self, ep, expect, idle_ok=False):
        """One reply frame, or a typed RpcError. EOF (server died or shut
        the connection mid-RPC) and wrong-kind replies both name the peer
        so the failure is diagnosable from the trainer side."""
        sizes = []
        msg = _recv_msg(self._socks[ep], idle_ok=idle_ok, sizes=sizes)
        self.bytes_received += sum(sizes)
        if msg is None:
            raise RpcPeerClosedError(
                "pserver %s closed the connection before replying" % ep)
        if msg[0] == "error":
            raise RpcError("pserver %s: %s" % (ep, msg[1]))
        if msg[0] != expect:
            raise RpcError("pserver %s replied %r, expected %r"
                           % (ep, msg[0], expect))
        return msg

    def _fanout_replies(self, expect, idle_ok=False):
        """Drain one reply from EVERY endpoint before raising, so one
        server's failure cannot leave another's unread reply on the wire
        and desync that connection for every later RPC."""
        errors = []
        for ep in self._socks:
            try:
                self._reply(ep, expect, idle_ok=idle_ok)
            except OSError as e:
                errors.append(e)
        if errors:
            if len(errors) == 1:
                raise errors[0]
            raise RpcError("; ".join(str(e) for e in errors))

    def send_var(self, ep, name, arr):
        self._send(self._socks[ep], ("send", name, _host(arr)))
        self._reply(ep, "ok")

    def batch_barrier(self):
        for s in self._socks.values():
            self._send(s, ("batch_barrier",))
        # barrier completion waits on the SLOWEST peer trainer (a
        # straggler's first step can exceed any RPC deadline) — unbounded
        # like the reference's sync barrier
        self._fanout_replies("ok", idle_ok=True)

    def get_var(self, ep, name):
        self._send(self._socks[ep], ("get", name))
        return self._reply(ep, "var")[1]

    def prefetch(self, ep, name, local_ids):
        """Rows of a table shard by shard-local id (reference:
        parameter_prefetch.cc prefetch_recv)."""
        self._send(self._socks[ep],
                   ("prefetch", name, np.asarray(local_ids, np.int64)))
        return self._reply(ep, "var")[1]

    def send_sparse(self, ep, name, local_rows, values):
        self._send(self._socks[ep],
                   ("send_sparse", name,
                    np.asarray(local_rows, np.int64), _host(values)))
        self._reply(ep, "ok")

    def checkpoint_notify(self, dirname):
        """Ask every pserver to save its shard (reference:
        checkpoint_notify_op.cc:28)."""
        for s in self._socks.values():
            self._send(s, ("checkpoint", dirname))
        self._fanout_replies("ok")

    def send_complete(self):
        for s in self._socks.values():
            try:
                _send_msg(s, ("complete",))
                _recv_msg(s)
            except OSError:
                pass
            s.close()

    def close(self):
        """Close the sockets WITHOUT signalling trainer completion — for
        read-only clients (an evaluator pulling params must not consume a
        completion slot and stop a live cluster)."""
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass


class DistTrainer:
    """Runs a transpiled trainer program: forward and backward on the
    engine (on ``place``, default the card), then send-grads → barrier →
    recv-params over the client (the role of the send/recv/fetch_barrier
    ops in the reference trainer program).

    ``step_ms`` holds the last step's wall split into ``engine`` (the
    engine's run to its device tensors, the feed copies included),
    ``rpc`` (prefetch, send, barrier and get calls) and ``copy`` (the
    fetched grads to the host, the pulled params to the device)."""

    def __init__(self, trainer_program, transpiler, scope=None, place=None):
        import paddle_tpu_torch.fluid as fluid

        self.scope = scope if scope is not None else fluid.Scope()
        self.exe = fluid.Executor(place)
        self.device = self.exe.device
        self.step_ms = None
        # send/recv markers carry the routing; the engine runs the
        # program without them (the transport is this class)
        self._sends = []   # (grad_name, endpoint, wire_name, rows|None)
        self._recvs = []   # (param_name, endpoint, wire_name, rows|None)
        self.program = trainer_program.clone()
        block = self.program.desc.global_block()
        kept = []
        # distributed lookup tables: host-side prefetch/sparse-send per
        # table (the marker ops stay in the program — they are real
        # lowered ops; the transpiler records the routing)
        self._dist = []    # (table, ids_var, pref_var, vocab, shards)
        self._transpiler = transpiler
        dist_tables = getattr(transpiler, "_dist_tables", {})
        for op in block.ops:
            if op.type == "send":
                self._sends.append(
                    (op.inputs["X"][0], op.attrs["endpoints"][0],
                     op.attrs.get("wire", op.inputs["X"][0]),
                     op.attrs.get("rows")))
            elif op.type == "recv":
                self._recvs.append(
                    (op.outputs["Out"][0], op.attrs["endpoints"][0],
                     op.attrs.get("wire", op.outputs["Out"][0]),
                     op.attrs.get("rows")))
            else:
                if op.type == "distributed_lookup":
                    wname = op.attrs["table_name"]
                    self._dist.append(
                        (wname, op.inputs["Ids"][0],
                         op.inputs["Prefetched"][0],
                         dist_tables[wname]["vocab"],
                         dist_tables[wname]["shards"]))
                kept.append(op)
        block.ops = kept
        self.program._bump_version()
        eps = sorted({ep for _, ep, _, _ in self._sends + self._recvs}
                     | {ep for *_, shards in self._dist
                        for ep, _, _ in shards})
        self.client = PSClient(eps)

    def run_startup(self, startup_program):
        self.exe.run(startup_program, scope=self.scope)
        # a caller may pass the un-transpiled startup; drop the full table
        # AND its table-shaped optimizer state (Adam moments etc.) it
        # initialized (get_trainer_startup_program avoids creating them)
        if self._dist:
            for name in self._transpiler.table_state_var_names():
                self.scope.erase(name)

    def pull_params(self):
        """Initial sync so all trainers start from the pserver's params."""
        self._recv_all()

    def _recv_all(self, times=None):
        """Fetch every param — whole vars directly, sliced vars assembled
        from their row blocks (reference: recv + concat of VarBlocks) —
        and write it into the scope's tensor in place."""
        for name, ep, wire, rows in self._recvs:
            t0 = time.perf_counter()
            part = self.client.get_var(ep, wire)
            t1 = time.perf_counter()
            if rows is None:
                _assign(self.scope, name, part, self.device)
            else:
                cur = self.scope.get(name)
                if cur is None or tuple(cur.shape)[0] < rows[1]:
                    raise RuntimeError(
                        "sliced param %r not materialized trainer-side"
                        % name)
                if not isinstance(cur, torch.Tensor):
                    cur = torch.from_numpy(np.array(cur)).to(self.device)
                    self.scope.set(name, cur)
                src = part if isinstance(part, torch.Tensor) else \
                    torch.from_numpy(np.require(part,
                                                requirements=("C", "W")))
                cur[rows[0]:rows[1]].copy_(src)
            if times is not None:
                _sync(self.device)
                times["rpc"] += t1 - t0
                times["copy"] += time.perf_counter() - t1

    def run(self, feed, fetch_list):
        times = {"engine": 0.0, "rpc": 0.0, "copy": 0.0}
        # -- prefetch distributed-table rows for this batch's ids ---------
        # (reference: parameter_prefetch.cc — split ids by shard, RPC each
        # owner, merge rows back in id order; deduplicated like
        # merge_ids_op so each unique id crosses the wire once)
        feed = dict(feed)
        dist_ctx = []
        t0 = time.perf_counter()
        for wname, ids_var, pref_var, vocab, shards in self._dist:
            if ids_var not in feed:
                raise ValueError(
                    "distributed lookup table %r needs its ids %r in the "
                    "feed" % (wname, ids_var))
            flat = np.asarray(feed[ids_var]).reshape(-1)
            if flat.size and (flat.min() < 0 or flat.max() >= vocab):
                # the local lookup_table clamps via gather; silently
                # dropping unowned ids here would train zero embeddings
                raise ValueError(
                    "ids for distributed table %r out of range [0, %d): "
                    "min=%d max=%d" % (wname, vocab, flat.min(),
                                       flat.max()))
            uniq, inv = np.unique(flat, return_inverse=True)
            rows = None
            for ep, start, end in shards:
                m = (uniq >= start) & (uniq < end)
                if not m.any():
                    continue
                part = self.client.prefetch(ep, wname, uniq[m] - start)
                if rows is None:
                    rows = np.zeros((len(uniq), part.shape[-1]),
                                    part.dtype)
                rows[m] = part
            assert rows is not None, "no shard owned any id"
            feed[pref_var] = rows[inv]
            dist_ctx.append((wname, pref_var + "@GRAD", uniq, inv, shards))
        times["rpc"] += time.perf_counter() - t0

        grad_names = sorted({g for g, *_ in self._sends})
        sparse_fetch = [g for _, g, *_ in dist_ctx]
        t0 = time.perf_counter()
        outs = self.exe.run(
            self.program, feed=feed,
            fetch_list=list(fetch_list) + grad_names + sparse_fetch,
            scope=self.scope, return_numpy=False)
        _sync(self.device)
        t1 = time.perf_counter()
        outs = [_host(o) for o in outs]
        times["engine"] += t1 - t0
        times["copy"] += time.perf_counter() - t1
        n_fetch = len(fetch_list)
        grads = dict(zip(grad_names + sparse_fetch, outs[n_fetch:]))
        t0 = time.perf_counter()
        for gname, ep, wire, rows in self._sends:
            arr = grads[gname]
            if rows is not None:
                arr = arr[rows[0]:rows[1]]
            self.client.send_var(ep, wire, arr)
        # -- sparse grads back to the shard owners, merged per unique id --
        for wname, gname, uniq, inv, shards in dist_ctx:
            vals = np.asarray(grads[gname])
            merged = np.zeros((len(uniq), vals.shape[-1]), vals.dtype)
            np.add.at(merged, inv, vals)
            for ep, start, end in shards:
                m = (uniq >= start) & (uniq < end)
                if not m.any():
                    continue
                self.client.send_sparse(ep, wname, uniq[m] - start,
                                        merged[m])
        self.client.batch_barrier()
        times["rpc"] += time.perf_counter() - t0
        self._recv_all(times)
        self.step_ms = {k: v * 1e3 for k, v in times.items()}
        return outs[:n_fetch]

    def save_checkpoint(self, dirname):
        """Distributed checkpoint: every pserver saves its own shard
        (reference: io.py:261 _save_distributed_persistables +
        checkpoint_notify)."""
        self.client.checkpoint_notify(dirname)

    def close(self):
        self.client.send_complete()
