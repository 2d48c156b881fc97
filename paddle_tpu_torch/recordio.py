"""RecordIO writer and reader (reference: paddle/fluid/recordio/ and
python recordio_writer.py). Port of ``paddle_tpu/recordio.py``; the file
format is the JAX package's, byte for byte:

    chunk   := u32 magic 'PTRC' | u32 n_records | u64 payload_len
               | u32 crc32(payload) | payload
    payload := repeat { u32 len | bytes }

all little-endian. ``Writer`` and ``Reader`` run on the native library
(``native/recordio.cc``), built at first use; ``native=False`` selects the
plain Python version, which tests hold the native one against. A chunk
whose magic, length or CRC does not check raises ``IOError``.
"""

import ctypes
import os
import struct
import zlib

from paddle_tpu_torch import native as _native

_MAGIC = 0x43525450
_HEAD = struct.Struct("<IIQI")


def _crc32(data):
    return zlib.crc32(data) & 0xFFFFFFFF


class Writer:
    def __init__(self, path, max_records=1024, max_bytes=1 << 20,
                 native=True):
        self._path = path
        self._native = _native.lib() if native else None
        if self._native is not None:
            self._h = self._native.rio_writer_open(
                os.fsencode(path), max_records, max_bytes)
            if not self._h:
                raise IOError("cannot open %s" % path)
        else:
            self._f = open(path, "wb")
            self._buf = bytearray()
            self._n = 0
            self._max_records = max_records
            self._max_bytes = max_bytes

    def write(self, record: bytes):
        if self._native is not None:
            if self._native.rio_writer_write(self._h, record,
                                             len(record)) != 0:
                raise IOError("write failed on %s" % self._path)
            return
        self._buf += struct.pack("<I", len(record)) + record
        self._n += 1
        if self._n >= self._max_records or len(self._buf) >= self._max_bytes:
            self._flush()

    def _flush(self):
        if self._n == 0:
            return
        payload = bytes(self._buf)
        self._f.write(_HEAD.pack(_MAGIC, self._n, len(payload),
                                 _crc32(payload)))
        self._f.write(payload)
        self._buf = bytearray()
        self._n = 0

    def close(self):
        if self._native is not None:
            if self._h:
                rc = self._native.rio_writer_close(self._h)
                self._h = None
                if rc != 0:
                    raise IOError("close failed on %s" % self._path)
            return
        if not self._f.closed:
            self._flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Reader:
    """Iterates the records of one file, as bytes."""

    def __init__(self, path, native=True):
        self._path = path
        self._native = _native.lib() if native else None
        if self._native is not None:
            self._h = self._native.rio_reader_open(os.fsencode(path))
            if not self._h:
                raise IOError("cannot open %s" % path)
        else:
            self._f = open(path, "rb")
            self._records = []
            self._idx = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._native is not None:
            out = ctypes.c_char_p()
            n = self._native.rio_reader_next(self._h, ctypes.byref(out))
            if n == -1:
                raise StopIteration
            if n < 0:
                raise IOError("corrupt recordio file %s" % self._path)
            return ctypes.string_at(out, n)
        while self._idx >= len(self._records):
            head = self._f.read(_HEAD.size)
            if not head:
                raise StopIteration
            if len(head) < _HEAD.size:
                raise IOError("corrupt recordio file %s" % self._path)
            magic, n, plen, crc = _HEAD.unpack(head)
            if magic != _MAGIC:
                raise IOError("corrupt recordio file %s" % self._path)
            payload = self._f.read(plen)
            if len(payload) != plen or _crc32(payload) != crc:
                raise IOError("corrupt recordio file %s" % self._path)
            self._records = []
            off = 0
            for _ in range(n):
                if off + 4 > plen:
                    raise IOError("corrupt recordio file %s" % self._path)
                (ln,) = struct.unpack_from("<I", payload, off)
                off += 4
                if off + ln > plen:
                    raise IOError("corrupt recordio file %s" % self._path)
                self._records.append(payload[off:off + ln])
                off += ln
            self._idx = 0
        rec = self._records[self._idx]
        self._idx += 1
        return rec

    def close(self):
        if self._native is not None:
            if self._h:
                self._native.rio_reader_close(self._h)
                self._h = None
            return
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
