"""Native runtime components of the input pipeline: the RecordIO writer and
reader (``recordio.cc``), the bounded byte-buffer queue between a decode
thread and the feeder (``blocking_queue.cc``) and the MultiSlotDataFeed
file parser (``multislot.cc``), bound through ``ctypes``.

Port of ``paddle_tpu/native/__init__.py``. The three sources are the JAX
package's, copied unchanged. They are built with the system ``g++`` at
first use (``lib()``), never at import, into ``native/_build/`` (listed in
``.gitignore``) under a file name keyed by a hash of the sources and
flags: an edited source is rebuilt, an unchanged one reused. The build
writes a temporary file named by process and thread and publishes it with
``os.replace``, so two processes that build at once (test workers) each
load a whole library. A failed build raises with the compiler's output;
nothing falls back to Python by itself. The pure-Python forms of the queue
and of the RecordIO reader and writer are the plain versions that tests
hold the native code against, reached only by ``native=False``.
"""

import ctypes
import hashlib
import os
import queue
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("recordio.cc", "blocking_queue.cc", "multislot.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path():
    """Where the library of the current sources is (or will be) built."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        "libpaddle_gpu_native-%s.so" % h.hexdigest()[:16])


def _build(path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.%d.tmp" % (path, os.getpid(), threading.get_ident())
    cmd = ["g++", *CXX_FLAGS, "-o", tmp,
           *[os.path.join(_HERE, s) for s in SOURCES], "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError("native build: cannot run g++ (%s); the input "
                           "pipeline's C++ is built at first use" % e)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("native build failed (g++ exit %d): %s\n%s%s"
                           % (proc.returncode, " ".join(cmd), proc.stdout,
                              proc.stderr))
    os.replace(tmp, path)


def _bind(lib):
    c = ctypes
    lib.rio_writer_open.restype = c.c_void_p
    lib.rio_writer_open.argtypes = [c.c_char_p, c.c_uint32, c.c_uint64]
    lib.rio_writer_write.restype = c.c_int
    lib.rio_writer_write.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
    lib.rio_writer_close.restype = c.c_int
    lib.rio_writer_close.argtypes = [c.c_void_p]
    lib.rio_reader_open.restype = c.c_void_p
    lib.rio_reader_open.argtypes = [c.c_char_p]
    lib.rio_reader_next.restype = c.c_int64
    lib.rio_reader_next.argtypes = [c.c_void_p, c.POINTER(c.c_char_p)]
    lib.rio_reader_close.restype = None
    lib.rio_reader_close.argtypes = [c.c_void_p]
    lib.msf_parse_file.restype = c.c_void_p
    lib.msf_parse_file.argtypes = [c.c_char_p, c.c_int,
                                   c.POINTER(c.c_uint8)]
    lib.msf_num_rows.restype = c.c_int64
    lib.msf_num_rows.argtypes = [c.c_void_p]
    lib.msf_free.restype = None
    lib.msf_free.argtypes = [c.c_void_p]
    lib.msf_range_total.restype = c.c_int64
    lib.msf_range_total.argtypes = [c.c_void_p, c.c_int, c.c_int64,
                                    c.c_int64]
    lib.msf_counts_range.restype = None
    lib.msf_counts_range.argtypes = [c.c_void_p, c.c_int, c.c_int64,
                                     c.c_int64, c.POINTER(c.c_int64)]
    lib.msf_values_f_range.restype = None
    lib.msf_values_f_range.argtypes = [c.c_void_p, c.c_int, c.c_int64,
                                       c.c_int64, c.POINTER(c.c_float)]
    lib.msf_values_i_range.restype = None
    lib.msf_values_i_range.argtypes = [c.c_void_p, c.c_int, c.c_int64,
                                       c.c_int64, c.POINTER(c.c_int64)]

    lib.btq_create.restype = c.c_void_p
    lib.btq_create.argtypes = [c.c_uint64]
    lib.btq_push.restype = c.c_int
    lib.btq_push.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
    lib.btq_pop.restype = c.c_int64
    lib.btq_pop.argtypes = [c.c_void_p, c.POINTER(c.POINTER(c.c_char))]
    lib.btq_free_buf.restype = None
    lib.btq_free_buf.argtypes = [c.POINTER(c.c_char)]
    lib.btq_size.restype = c.c_uint64
    lib.btq_size.argtypes = [c.c_void_p]
    for name in ("btq_close", "btq_reset", "btq_destroy"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [c.c_void_p]
    return lib


def lib():
    """The loaded library, built first if this source hash has no build
    yet. Raises (with g++'s output) when the build fails."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                path = library_path()
                if not os.path.exists(path):
                    _build(path)
                _lib = _bind(ctypes.CDLL(path))
    return _lib


def loaded_path():
    """The path of the library this process loaded, or None."""
    return None if _lib is None else _lib._name


class BlockingQueue:
    """Bounded byte-buffer queue: the capacity bound gives backpressure;
    ``close`` fails pushers at once and lets poppers drain, then signals
    end of stream (``pop`` returns None); ``reset`` drops what is queued
    and reopens. Native by default; ``native=False`` is the plain Python
    version."""

    def __init__(self, capacity=64, native=True):
        self.capacity = capacity
        self._native = lib() if native else None
        if self._native is not None:
            self._q = self._native.btq_create(capacity)
        else:
            self._q = queue.Queue(maxsize=capacity)
            self._closed = False

    def push(self, data: bytes) -> bool:
        """False when the queue is closed (the item is dropped)."""
        if self._native is not None:
            return self._native.btq_push(self._q, data, len(data)) == 0
        # bounded put attempts, so close() releases a producer parked on
        # a full queue (the native push wakes on close the same way)
        while not self._closed:
            try:
                self._q.put(data, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def pop(self):
        """bytes, or None at end of stream."""
        if self._native is not None:
            out = ctypes.POINTER(ctypes.c_char)()
            n = self._native.btq_pop(self._q, ctypes.byref(out))
            if n < 0:
                return None
            data = ctypes.string_at(out, n)
            self._native.btq_free_buf(out)
            return data
        while True:
            try:
                return self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed:
                    return None

    def size(self):
        if self._native is not None:
            return int(self._native.btq_size(self._q))
        return self._q.qsize()

    def close(self):
        if self._native is not None:
            self._native.btq_close(self._q)
        else:
            self._closed = True

    def reset(self):
        if self._native is not None:
            self._native.btq_reset(self._q)
        else:
            self._q = queue.Queue(maxsize=self.capacity)
            self._closed = False

    def __del__(self):
        native = getattr(self, "_native", None)
        if native is not None:
            native.btq_destroy(self._q)


class MultiSlotFile:
    """Handle over a natively parsed slot file. Batches are copied out one
    row range at a time (the parsed data lives once, in the C++ vectors).
    Use as a context manager or call ``close()``."""

    def __init__(self, handle, slot_is_float):
        self._h = handle
        self._is_float = list(slot_is_float)
        self.rows = lib().msf_num_rows(handle)

    def slot_batch(self, j, r0, r1):
        """(counts int64[r1-r0], values of those rows) of slot j: float32
        for a float slot, int64 otherwise."""
        if not 0 <= r0 <= r1 <= self.rows:
            raise IndexError("rows [%d, %d) outside [0, %d)"
                             % (r0, r1, self.rows))
        l = lib()
        counts = np.empty(r1 - r0, np.int64)
        if r1 > r0:
            l.msf_counts_range(
                self._h, j, r0, r1,
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        total = l.msf_range_total(self._h, j, r0, r1)
        if self._is_float[j]:
            vals = np.empty(total, np.float32)
            if total:
                l.msf_values_f_range(
                    self._h, j, r0, r1,
                    vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        else:
            vals = np.empty(total, np.int64)
            if total:
                l.msf_values_i_range(
                    self._h, j, r0, r1,
                    vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return counts, vals

    def close(self):
        if self._h is not None:
            lib().msf_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self.close()


def open_multislot_file(path, slot_is_float):
    """Parse a MultiSlotDataFeed file (per line, for each slot in order: a
    count N, then N values). Raises ValueError on an unreadable file or a
    malformed line."""
    n = len(slot_is_float)
    mask = (ctypes.c_uint8 * n)(*[1 if f else 0 for f in slot_is_float])
    h = lib().msf_parse_file(os.fsencode(path), n, mask)
    if not h:
        raise ValueError("cannot read or parse multislot file %s" % path)
    return MultiSlotFile(h, slot_is_float)


def parse_multislot_file(path, slot_is_float):
    """Whole-file form of ``open_multislot_file``: (rows, [(counts,
    values) of each slot])."""
    with open_multislot_file(path, slot_is_float) as mf:
        return mf.rows, [mf.slot_batch(j, 0, mf.rows)
                         for j in range(len(slot_is_float))]
