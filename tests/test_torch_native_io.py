"""The port's native input layer (``paddle_tpu_torch/native/``) and RecordIO
(``recordio.py``, ``recordio_writer.py``) against the JAX package's, on
the CPU.

- The library builds with g++ from the port's own copies of the sources,
  into ``native/_build/`` under a source-hash name, published with
  ``os.replace``; a failed build raises with the compiler's output.
- RecordIO: a file written by either package (native or plain writer)
  reads the same, record for record, in either package; the writers'
  files are equal byte for byte; a flipped payload byte raises.
- ``BlockingQueue`` (native and plain): backpressure, drain after close,
  a pusher released by close, reset.
- The MultiSlotDataFeed parse equals the JAX package's, exactly.
"""

import os
import threading
import time

import numpy as np
import pytest

from paddle_tpu import native as j_native
from paddle_tpu import recordio as j_recordio
from paddle_tpu import recordio_writer as j_recordio_writer

from paddle_tpu_torch import native, recordio, recordio_writer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(n=23, seed=0):
    rng = np.random.RandomState(seed)
    # empty records, one byte, and sizes past a chunk's byte budget
    sizes = [0, 1] + list(rng.randint(0, 300, n - 3)) + [5000]
    return [rng.bytes(int(s)) for s in sizes]


def test_library_builds_from_the_ports_sources_and_loads():
    lib = native.lib()
    path = native.loaded_path()
    assert lib is native.lib()  # loaded once a process
    assert path == native.library_path()
    assert os.path.dirname(path) == os.path.join(
        ROOT, "paddle_tpu_torch", "native", "_build")
    assert os.path.basename(path).startswith("libpaddle_gpu_native-")
    for name in native.SOURCES:
        with open(os.path.join(ROOT, "paddle_tpu_torch", "native",
                               name), "rb") as f:
            port = f.read()
        with open(os.path.join(ROOT, "paddle_tpu", "native", name),
                  "rb") as f:
            assert f.read() == port, "%s differs from the JAX package's" % name


def test_failed_build_raises_with_the_compilers_output(tmp_path,
                                                        monkeypatch):
    for name in native.SOURCES:
        (tmp_path / name).write_text("int broken( {\n")
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    out = str(tmp_path / "_build" / "lib.so")
    with pytest.raises(RuntimeError, match="native build failed") as e:
        native._build(out)
    assert "error" in str(e.value)  # g++'s own diagnostics
    assert not os.path.exists(out)
    assert os.listdir(tmp_path / "_build") == []  # no temporary left


def test_concurrent_builds_publish_whole_libraries(tmp_path, monkeypatch):
    """Two builders of one library (two test workers, say) each write a
    temporary file of their own and publish it with os.replace: the
    library at the final path is always one whole build."""
    outs = []

    class _Done:
        returncode = 0
        stdout = stderr = ""

    def fake_gxx(cmd, **kw):
        tmp = cmd[cmd.index("-o") + 1]
        outs.append(tmp)
        with open(tmp, "wb") as f:
            f.write(b"part-")
            time.sleep(0.05)  # the other builder writes meanwhile
            f.write(b"whole")
        return _Done()

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", fake_gxx)
    path = str(tmp_path / "lib.so")
    threads = [threading.Thread(target=native._build, args=(path,))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(set(outs)) == 2 and path not in outs
    assert open(path, "rb").read() == b"part-whole"
    assert os.listdir(tmp_path) == ["lib.so"]


_WRITERS = {
    "jax": lambda p, recs, m: _write(j_recordio.Writer(p, max_records=m),
                                     recs),
    "native": lambda p, recs, m: _write(recordio.Writer(p, max_records=m),
                                        recs),
    "plain": lambda p, recs, m: _write(
        recordio.Writer(p, max_records=m, native=False), recs),
}
_READERS = {
    "jax": lambda p: list(j_recordio.Reader(p)),
    "native": lambda p: _read(recordio.Reader(p)),
    "plain": lambda p: _read(recordio.Reader(p, native=False)),
}


def _write(w, recs):
    with w:
        for r in recs:
            w.write(r)


def _read(r):
    with r:
        return list(r)


@pytest.mark.parametrize("writer", sorted(_WRITERS))
@pytest.mark.parametrize("reader", sorted(_READERS))
def test_recordio_reads_the_same_across_packages(tmp_path, writer, reader):
    recs = _records()
    path = str(tmp_path / "f.rio")
    _WRITERS[writer](path, recs, 4)
    assert _READERS[reader](path) == recs


def test_recordio_writers_write_the_same_bytes(tmp_path):
    recs = _records(seed=3)
    files = {}
    for name, write in _WRITERS.items():
        path = str(tmp_path / ("%s.rio" % name))
        write(path, recs, 5)
        files[name] = open(path, "rb").read()
    assert files["native"] == files["jax"]
    assert files["plain"] == files["jax"]


@pytest.mark.parametrize("reader", ["native", "plain"])
def test_recordio_flipped_byte_raises(tmp_path, reader):
    path = str(tmp_path / "f.rio")
    _WRITERS["jax"](path, _records(), 100)
    raw = bytearray(open(path, "rb").read())
    raw[40] ^= 0x01  # inside the first chunk's payload: the CRC fails
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="corrupt"):
        _READERS[reader](path)
    with pytest.raises(IOError, match="corrupt"):
        _READERS["jax"](path)


def test_recordio_writer_shards_match_reference(tmp_path):
    rng = np.random.RandomState(5)
    samples = [(rng.rand(3, 2).astype(np.float32), np.int64(i))
               for i in range(11)]
    got = recordio_writer.convert_reader_to_recordio_files(
        str(tmp_path / "port.rio"), 4, lambda: iter(samples),
        max_num_records=3)
    want = j_recordio_writer.convert_reader_to_recordio_files(
        str(tmp_path / "jax.rio"), 4, lambda: iter(samples),
        max_num_records=3)
    assert got == want == [4, 4, 3]
    for i in range(3):
        port = open(tmp_path / ("port-%05d.rio" % i), "rb").read()
        jax = open(tmp_path / ("jax-%05d.rio" % i), "rb").read()
        assert port == jax
    assert recordio_writer._sample_bytes(samples[0]) == \
        j_recordio_writer._sample_bytes(samples[0])


@pytest.mark.parametrize("is_native", [True, False])
def test_blocking_queue_backpressure_drain_and_reset(is_native):
    q = native.BlockingQueue(capacity=2, native=is_native)
    assert q.push(b"a") and q.push(b"b") and q.size() == 2
    pushed = []

    def pusher():
        pushed.append(q.push(b"c"))  # blocks: the queue is full

    t = threading.Thread(target=pusher)
    t.start()
    time.sleep(0.2)
    assert pushed == [] and q.size() == 2
    assert q.pop() == b"a"
    t.join(timeout=5)
    assert not t.is_alive() and pushed == [True]
    # close: pushers fail at once, poppers drain, then end of stream
    q.close()
    assert q.push(b"d") is False
    assert [q.pop(), q.pop(), q.pop()] == [b"b", b"c", None]
    # a pusher parked on a full queue is released by close
    q.reset()
    assert q.push(b"e") and q.push(b"f")
    t = threading.Thread(target=pusher)
    t.start()
    time.sleep(0.1)
    q.close()
    t.join(timeout=5)
    assert not t.is_alive() and pushed == [True, False]
    # reset drops what was queued and reopens
    q.reset()
    assert q.size() == 0 and q.push(b"g") and q.pop() == b"g"


def _multislot_file(tmp_path, rows):
    path = str(tmp_path / "slots.txt")
    with open(path, "w") as f:
        for r in rows:
            f.write(r + "\n")
    return path


def test_multislot_parse_matches_reference(tmp_path):
    rng = np.random.RandomState(7)
    rows = []
    for _ in range(37):
        ids = rng.randint(0, 1 << 40, rng.randint(0, 5))
        vals = rng.randn(rng.randint(1, 4)).astype(np.float32)
        label = [int(rng.randint(0, 2))]
        rows.append(" ".join(
            [str(len(ids))] + [str(v) for v in ids]
            + [str(len(vals))] + ["%.7g" % v for v in vals]
            + ["1", str(label[0])]))
    rows.insert(5, "")  # a blank line is skipped
    path = _multislot_file(tmp_path, rows)
    is_float = [False, True, False]
    got_rows, got = native.parse_multislot_file(path, is_float)
    want_rows, want = j_native.parse_multislot_file(path, is_float)
    assert got_rows == want_rows == 37
    for (gc, gv), (wc, wv) in zip(got, want):
        assert gc.dtype == wc.dtype and gv.dtype == wv.dtype
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gv, wv)
    with native.open_multislot_file(path, is_float) as mf:
        counts, vals = mf.slot_batch(1, 10, 20)
        np.testing.assert_array_equal(counts, want[1][0][10:20])
        lo = int(want[1][0][:10].sum())
        np.testing.assert_array_equal(vals,
                                      want[1][1][lo:lo + counts.sum()])


def test_multislot_malformed_line_raises(tmp_path):
    path = _multislot_file(tmp_path, ["2 1 2 1 0", "2.5 1 1 0"])
    assert j_native.parse_multislot_file(path, [False, False]) is None
    with pytest.raises(ValueError, match="multislot"):
        native.parse_multislot_file(path, [False, False])
