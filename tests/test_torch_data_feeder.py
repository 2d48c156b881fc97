"""The port's ``DataFeeder``, ``LoDTensor`` helpers, ``DataFeedDesc`` and
``contrib.reader.ctr_reader`` against the JAX package's, on the CPU.

- ``DataFeeder.feed`` gives equal feed dicts (names, dtypes, shapes,
  values) for dense, ragged and ``@LEN`` columns, with ``bucket_seq`` on
  and off, and so do ``feed_parallel`` and ``decorate_reader``.
  ``decorate_reader(prefetch=True)`` stages the same values onto the
  feeder's place (the CPU here).
- A ragged program fed through the DataFeeder (an ``@LEN`` var threaded
  into ``sequence_pool``) trains 3 SGD steps to the JAX package's losses,
  rtol 1e-5 (float32 on both sides), from the same initial state; the
  port's engine holds one cache entry a length bucket.
- ``fluid.create_lod_tensor``, ``create_random_int_lodtensor`` and
  ``LoDTensorArray`` agree with the JAX package; so does
  ``DataFeedDesc``'s parse and its text form; ``ctr_reader`` yields the
  same batches from svm and csv files.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.contrib.reader import ctr_reader as j_ctr
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as j_program_guard

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.contrib.reader import ctr_reader as t_ctr
from paddle_tpu_torch.data_feeder import bucketed_length

LOSS_RTOL = 1e-5
D = 3


def _feed_program(fluid, unique_name, program_cls, guard):
    main, startup = program_cls(), program_cls()
    with unique_name.guard(), guard(main, startup):
        img = fluid.layers.data(name="img", shape=[2, 3], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        words = fluid.layers.data(name="words", shape=[-1], dtype="int64",
                                  lod_level=1)
        fluid.layers.data(name="words@LEN", shape=[1], dtype="int64")
        tags = fluid.layers.data(name="tags", shape=[-1, 2],
                                 dtype="float32")
        uniform = fluid.layers.data(name="uniform", shape=[-1],
                                    dtype="int64")
        fluid.layers.data(name="uniform@LEN", shape=[1], dtype="int64")
    return main, [img, label, words, tags, uniform]


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        rows.append((rng.rand(2, 3).tolist(),          # nested lists
                     int(rng.randint(10)),
                     list(rng.randint(0, 50, rng.randint(1, 12))),
                     rng.rand(rng.randint(1, 6), 2),
                     [1, 2, 3]))                       # uniform, with @LEN
    return rows


def _same_feed(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _feeders(bucket_seq=True):
    t_main, t_vars = _feed_program(tfluid, t_unique_name, tfluid.Program,
                                   tfluid.program_guard)
    j_main, j_vars = _feed_program(jfluid, j_unique_name, JProgram,
                                   j_program_guard)
    return (tfluid.DataFeeder(t_vars, tfluid.CPUPlace(), program=t_main,
                              bucket_seq=bucket_seq),
            jfluid.DataFeeder(j_vars, jfluid.CPUPlace(), program=j_main,
                              bucket_seq=bucket_seq))


@pytest.mark.parametrize("bucket_seq", [True, False])
def test_feed_matches_reference(bucket_seq):
    t_feeder, j_feeder = _feeders(bucket_seq)
    for n, seed in ((5, 0), (1, 1), (7, 2)):
        rows = _rows(n, seed)
        got, want = t_feeder.feed(rows), j_feeder.feed(rows)
        _same_feed(got, want)
        assert got["label"].shape == (n, 1)
        assert got["words@LEN"].dtype == np.int64
        assert "tags@LEN" not in got  # no var declares it
        assert got["uniform"].shape[1] == (8 if bucket_seq else 3)


def test_bucketed_length_matches_reference():
    from paddle_tpu.data_feeder import bucketed_length as j_bucketed

    for n in list(range(0, 70)) + [1000]:
        for m in (1, 4, 8):
            assert bucketed_length(n, m) == j_bucketed(n, m)


@pytest.mark.parametrize("num_places", [1, 2, 3])
def test_feed_parallel_and_decorate_reader_match_reference(num_places):
    t_feeder, j_feeder = _feeders()
    batches = [_rows(6, 3), [], _rows(5, 4)]
    got = list(t_feeder.feed_parallel(batches, num_places))
    want = list(j_feeder.feed_parallel(batches, num_places))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_feed(g, w)
    for drop_last in (True, False):
        kw = dict(multi_devices=True, num_places=num_places,
                  drop_last=drop_last)
        got = list(t_feeder.decorate_reader(lambda: iter(batches), **kw)())
        want = list(j_feeder.decorate_reader(lambda: iter(batches), **kw)())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_feed(g, w)
    got = list(t_feeder.decorate_reader(lambda: iter(batches[::2]))())
    want = list(j_feeder.decorate_reader(lambda: iter(batches[::2]))())
    for g, w in zip(got, want):
        _same_feed(g, w)


def test_decorate_reader_prefetch_stages_onto_the_place():
    t_feeder, j_feeder = _feeders()
    batches = [_rows(4, s) for s in range(3)]
    staged = list(t_feeder.decorate_reader(
        lambda: iter(batches), prefetch=True, prefetch_depth=2)())
    want = [j_feeder.feed(b) for b in batches]
    assert len(staged) == 3
    for s, w in zip(staged, want):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in s.values())
        _same_feed({k: v.numpy() for k, v in s.items()}, w)


def _ragged_model(fluid, unique_name, program_cls, guard):
    main, startup = program_cls(), program_cls()
    with unique_name.guard(), guard(main, startup):
        x = fluid.layers.data(name="x", shape=[-1, D], dtype="float32")
        lens = fluid.layers.data(name="x@LEN", shape=[1], dtype="int64")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=4, num_flatten_dims=2, act="tanh")
        pooled = fluid.layers.sequence_pool(h, "average", length=lens)
        pred = fluid.layers.fc(input=pooled, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, [x, y], loss


def test_ragged_program_trains_through_the_feeder_like_reference():
    rng = np.random.RandomState(0)
    batches = []
    for maxlen in (5, 7, 11):  # buckets 8, 8, 16
        rows = []
        for _ in range(4):
            seq = rng.randn(rng.randint(1, maxlen + 1), D).astype(np.float32)
            rows.append((seq, np.float32(seq[:, 0].mean())))
        batches.append(rows)

    j_main, j_startup, j_feed, j_loss = _ragged_model(
        jfluid, j_unique_name, JProgram, j_program_guard)
    j_exe, j_scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    j_feeder = jfluid.DataFeeder(j_feed, jfluid.CPUPlace(), program=j_main)
    with jfluid.scope_guard(j_scope):
        j_exe.run(j_startup)
        state = {v.name: np.array(j_scope.get(v.name))
                 for v in j_main.list_vars() if v.persistable}
        want = [float(np.asarray(j_exe.run(
            j_main, feed=j_feeder.feed(b), fetch_list=[j_loss])[0]))
            for b in batches]

    t_main, _, t_feed, t_loss = _ragged_model(
        tfluid, t_unique_name, tfluid.Program, tfluid.program_guard)
    assert t_main.desc.serialize_to_string() == \
        j_main.desc.serialize_to_string()
    t_exe, t_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    t_feeder = tfluid.DataFeeder(t_feed, tfluid.CPUPlace(), program=t_main)
    with tfluid.scope_guard(t_scope):
        convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
        feeds = [t_feeder.feed(b) for b in batches]
        assert [f["x"].shape[1] for f in feeds] == [8, 8, 16]
        got = [float(np.asarray(t_exe.run(
            t_main, feed=f, fetch_list=[t_loss])[0])) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert len(t_exe.engine._cache) == 2  # one entry a bucket


def test_lod_tensors_match_reference():
    data = [[1, 2, 3], [4], [5, 6]]
    for fluid in (tfluid, jfluid):
        with pytest.raises(ValueError, match="row lengths"):
            fluid.create_lod_tensor(data, [[3, 1, 1]])
    t = tfluid.create_lod_tensor(data, [[3, 1, 2]])
    j = jfluid.create_lod_tensor(data, [[3, 1, 2]])
    for fn in ("lod", "recursive_sequence_lengths", "shape",
               "has_valid_recursive_sequence_lengths"):
        assert getattr(t, fn)() == getattr(j, fn)()
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    arr = np.arange(12, dtype=np.float32).reshape(6, 2)
    t = tfluid.create_lod_tensor(arr, [[2, 1], [1, 2, 3]])
    j = jfluid.create_lod_tensor(arr, [[2, 1], [1, 2, 3]])
    assert t.lod() == j.lod() == [[0, 2, 3], [0, 1, 3, 6]]
    assert t.has_valid_recursive_sequence_lengths()
    bad = tfluid.create_lod_tensor(arr, [[2, 2]])
    assert bad.has_valid_recursive_sequence_lengths() == \
        jfluid.create_lod_tensor(arr, [[2, 2]]) \
        .has_valid_recursive_sequence_lengths() is False
    out = []
    for fluid in (tfluid, jfluid):
        np.random.seed(7)
        out.append(fluid.create_random_int_lodtensor(
            [[2, 3]], [4], fluid.CPUPlace(), low=0, high=9))
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(out[1]))
    assert np.asarray(out[0]).shape == (5, 4)
    assert out[0].lod() == out[1].lod() == [[0, 2, 5]]
    arrays = (tfluid.LoDTensorArray(), jfluid.LoDTensorArray())
    for a in arrays:
        a.append(arr)
        a.append(tfluid.create_lod_tensor(arr[:2], [[2]])
                 if a is arrays[0] else
                 jfluid.create_lod_tensor(arr[:2], [[2]]))
    assert [x.lod() for x in arrays[0]] == [x.lod() for x in arrays[1]]


_DESC = '''
name: "MultiSlotDataFeed"
batch_size: 2
multi_slot_desc {
    slots {
        name: "words"
        type: "uint64"
        is_dense: false
        is_used: true
    }
    slots {
        name: "label"
        type: "uint64"
        is_dense: false
        is_used: false
    }
    slots {
        name: "dense"
        type: "float"
        is_dense: true
        is_used: true
    }
}
'''


def test_data_feed_desc_matches_reference(tmp_path):
    path = tmp_path / "desc.prototxt"
    path.write_text(_DESC)
    for src in (_DESC, str(path)):
        t = tfluid.DataFeedDesc(src)
        j = jfluid.DataFeedDesc(src)
        for d in (t, j):
            d.set_batch_size(128)
            d.set_dense_slots(["label"])
            d.set_use_slots(["label"])
        assert t.desc() == j.desc()
        assert (t.name, t.batch_size) == (j.name, j.batch_size) == \
            ("MultiSlotDataFeed", 128)
        assert [vars(s) for s in t.slots] == [vars(s) for s in j.slots]
        assert [s.name for s in t.used_slots()] == \
            [s.name for s in j.used_slots()] == ["words", "label", "dense"]


def _ctr_vars(fluid, unique_name, program_cls, guard, names):
    main, startup = program_cls(), program_cls()
    with unique_name.guard(), guard(main, startup):
        return {n: fluid.layers.data(name=n, shape=[-1], dtype=dtype)
                for n, dtype in names}


@pytest.mark.parametrize("file_type", ["svm", "csv"])
def test_ctr_reader_matches_reference(tmp_path, file_type):
    rng = np.random.RandomState(11)
    lines = []
    for i in range(9):
        if file_type == "svm":
            toks = ["%d:%d" % (rng.randint(1, 4), rng.randint(0, 1000))
                    for _ in range(rng.randint(1, 6))]
            lines.append(" ".join([str(i % 2)] + toks))
        else:
            lines.append(",".join([str(i % 2)]
                                  + ["%.3f" % v for v in rng.rand(3)]
                                  + [str(v) for v in rng.randint(0, 99, 2)]))
        if i == 4:
            lines.append("")  # a blank line is skipped
    files = []
    for k in range(2):
        p = tmp_path / ("part-%d.txt" % k)
        p.write_text("\n".join(lines[k::2]) + "\n")
        files.append(str(p))
    if file_type == "svm":
        names = [("label", "int64"), ("s1", "int64"), ("s2", "int64"),
                 ("s3", "int64")]
    else:
        names = [("label", "int64"), ("dense", "float32"),
                 ("sparse", "int64")]
    batches = []
    for fluid, un, prog, guard, ctr in (
            (tfluid, t_unique_name, tfluid.Program, tfluid.program_guard,
             t_ctr),
            (jfluid, j_unique_name, JProgram, j_program_guard, j_ctr)):
        feed_dict = _ctr_vars(fluid, un, prog, guard, names)
        reader = ctr.ctr_reader(
            feed_dict, file_type, "plain", [0, 1, 2], [3, 4], capacity=2,
            thread_num=1, batch_size=4, file_list=files,
            slots=["1", "2", "3"])
        reader.start()
        out = []
        while True:
            fd = reader.next_feed()
            if fd is None:
                break
            out.append(fd)
        batches.append(out)
    assert len(batches[0]) == len(batches[1]) == 3
    for g, w in zip(*batches):
        _same_feed(g, w)
