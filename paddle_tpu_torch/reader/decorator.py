"""Reader decorators: composable generators over samples (reference:
python/paddle/reader/decorator.py — map_readers:42, shuffle:63, chain,
compose, buffered:179, xmap_readers:236, multiprocess_reader:338,
PipeReader:438, Fake:509). Port of ``paddle_tpu/reader/decorator.py``.

``buffered`` and ``xmap_readers`` move pickled samples between threads
through the native ``BlockingQueue``; ``prefetch_to_device`` is the
engine's ``PrefetchingFeeder`` (``engine/pipeline.py``) as a decorator.
"""

import itertools
import multiprocessing
import multiprocessing.connection
import pickle
import random
import threading

from paddle_tpu_torch.native import BlockingQueue


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    """Shuffle within windows of ``buf_size`` samples, with Python's
    ``random`` module (seed it for a repeatable order)."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    def reader():
        for r in readers:
            for e in r():
                yield e

    return reader


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            for outputs in zip(*rs):
                yield sum((make_tuple(o) for o in outputs), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                yield sum(
                    (make_tuple(o) for o in outputs if o is not None), ())

    return reader


def buffered(reader, size):
    """Read ahead up to ``size`` samples on a background thread, through
    the native blocking queue. Stopping the iteration early closes the
    queue, which ends the thread."""

    def data_reader():
        q = BlockingQueue(capacity=size)

        def producer():
            try:
                for e in reader():
                    if not q.push(pickle.dumps(e, protocol=4)):
                        return
            finally:
                q.close()

        threading.Thread(target=producer, name="paddle-gpu-buffered",
                         daemon=True).start()
        try:
            while True:
                item = q.pop()
                if item is None:
                    break
                yield pickle.loads(item)
        finally:
            q.close()

    return data_reader


def prefetch_to_device(reader, depth=None, device_put=True, device=None):
    """Stage a batch or feed-dict reader's items onto ``device`` (default:
    the card, ``CUDAPlace(0)``) ``depth`` ahead (default: the
    ``prefetch_depth`` flag, 2) on a background thread, through pinned
    buffers and a copy stream, while the consumer's step runs
    (``engine/pipeline.py`` ``PrefetchingFeeder``). Compose it last, over
    ``DataFeeder.decorate_reader``'s output (or pass ``prefetch=True``
    there). Exhaustion and reader exceptions reach the consumer in
    order."""
    from paddle_tpu_torch.engine.pipeline import prefetch_to_device as _impl

    return _impl(reader, depth=depth, device_put=device_put, device=device)


def batch(reader, batch_size, drop_last=False):
    def batch_reader():
        b = []
        for e in reader():
            b.append(e)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


def firstn(reader, n):
    def firstn_reader():
        for i, e in enumerate(reader()):
            if i >= n:
                break
            yield e

    return firstn_reader


def cache(reader):
    """Read ``reader`` once, on the first epoch, and replay it after."""
    all_data = []

    def cache_reader():
        if not all_data:
            all_data.extend(reader())
        for e in all_data:
            yield e

    return cache_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Map ``mapper`` over the samples with ``process_num`` worker threads
    between two bounded native queues. With ``order=True`` the samples
    come out in the reader's order; otherwise in the order the workers
    finish them."""

    def data_reader():
        in_q = BlockingQueue(capacity=buffer_size)
        out_q = BlockingQueue(capacity=buffer_size)
        n_done = [0]
        done_lock = threading.Lock()

        def feed():
            try:
                for i, e in enumerate(reader()):
                    if not in_q.push(pickle.dumps((i, e), protocol=4)):
                        return
            finally:
                in_q.close()

        def work():
            while True:
                item = in_q.pop()
                if item is None:
                    break
                i, e = pickle.loads(item)
                if not out_q.push(pickle.dumps((i, mapper(e)), protocol=4)):
                    break
            with done_lock:
                n_done[0] += 1
                if n_done[0] == process_num:
                    out_q.close()

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()
        pending, want = {}, 0
        try:
            while True:
                item = out_q.pop()
                if item is None:
                    break
                i, out = pickle.loads(item)
                if not order:
                    yield out
                    continue
                pending[i] = out
                while want in pending:
                    yield pending.pop(want)
                    want += 1
        finally:
            in_q.close()
            out_q.close()

    return data_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Merge readers, each run in a child process forked from this one
    (pipe mode by default, a ``multiprocessing.Queue`` otherwise); the
    samples of different readers interleave in no fixed order.

    The children are forked, so they inherit the parent's state but no
    CUDA context can be used in them: the readers must yield numpy or
    Python values and must not touch the card (nor torch's CUDA state)."""
    ctx = multiprocessing.get_context("fork")

    def read_into(reader, sink):
        for sample in reader():
            if sample is None:
                raise ValueError("sample has None")
            sink(pickle.dumps(sample))
        sink(pickle.dumps(None))

    def queue_reader():
        q = ctx.Queue(queue_size)
        procs = [ctx.Process(target=read_into, args=(r, q.put))
                 for r in readers]
        for p in procs:
            p.start()
        finish_num = 0
        while finish_num < len(readers):
            sample = pickle.loads(q.get())
            if sample is None:
                finish_num += 1
            else:
                yield sample
        for p in procs:
            p.join()

    def pipe_reader():
        conns = []
        procs = []
        for r in readers:
            parent_conn, child_conn = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=read_into,
                               args=(r, child_conn.send_bytes))
            proc.start()
            child_conn.close()
            conns.append(parent_conn)
            procs.append(proc)
        live = list(conns)
        while live:
            for conn in multiprocessing.connection.wait(live):
                try:
                    data = conn.recv_bytes()
                except EOFError:
                    live.remove(conn)
                    continue
                sample = pickle.loads(data)
                if sample is None:
                    live.remove(conn)
                    conn.close()
                else:
                    yield sample
        for p in procs:
            p.join()

    return pipe_reader if use_pipe else queue_reader


class PipeReader:
    """Stream the stdout of a shell command, as lines or as chunks, plain
    or gzip."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        if not isinstance(command, str):
            raise TypeError("command must be a string")
        self.command = command
        self.bufsize = bufsize
        self.file_type = file_type

    def get_line(self, cut_lines=True, line_break="\n"):
        import subprocess
        import zlib

        process = subprocess.Popen(
            self.command.split(" "), bufsize=self.bufsize,
            stdout=subprocess.PIPE)
        decomp = (zlib.decompressobj(32 + zlib.MAX_WBITS)
                  if self.file_type == "gzip" else None)
        remained = ""
        try:
            while True:
                buff = process.stdout.read(self.bufsize)
                if not buff:
                    break
                if decomp is not None:
                    buff = decomp.decompress(buff)
                text = buff.decode("utf-8", "ignore")
                if cut_lines:
                    lines = (remained + text).split(line_break)
                    remained = lines.pop(-1)
                    for line in lines:
                        yield line
                else:
                    yield text
            if cut_lines and remained:
                yield remained
        finally:
            process.stdout.close()
            process.wait()


class Fake:
    """Cache the first sample and replay it ``data_num`` times an epoch
    (for speed tests without I/O)."""

    def __init__(self):
        self.data = None
        self.yield_data = None

    def __call__(self, reader, data_num):
        def fake_reader():
            if self.data is None:
                self.data = next(reader())
            while self.yield_data != data_num:
                self.yield_data += 1
                yield self.data
            self.yield_data = 0

        self.yield_data = 0
        return fake_reader
