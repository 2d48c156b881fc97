"""The port's readers (``paddle_tpu_torch/reader/``) and datasets
(``paddle_tpu_torch/dataset/``) against the JAX package's, on the CPU.

- Every creator and decorator, in both packages, yields the same items
  from the same seeded source, exactly. ``shuffle`` seeds Python's
  ``random`` the same way for both before each epoch; ``buffered`` and
  ``cache`` run two epochs; ``xmap_readers`` with ``order=True`` keeps the
  reader's order (the JAX package accepts ``order`` and ignores it, so
  its order is only that of one worker; with three workers both are
  compared as multisets); ``multiprocess_reader`` is compared as a
  multiset, over readers that import no torch.
- Each of the 13 datasets' train and test readers yields the same first
  64 samples (all of them where there are fewer) in both packages. MNIST
  (IDX gz) and Flowers (npz) also read a tiny real file under a temporary
  root: the port through its ``data`` flag (set with ``fluid.set_flags``
  after the reader was made: the flag is read when a reader starts), the
  JAX package through its ``_DATA_DIR``, patched here only.
"""

import gzip
import itertools
import os
import random
import struct

import numpy as np
import pytest

import paddle_tpu.dataset as j_dataset
import paddle_tpu.reader as j_reader
from paddle_tpu import recordio_writer as j_recordio_writer
from paddle_tpu.reader import creator as j_creator

import paddle_tpu_torch.dataset as t_dataset
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.reader as t_reader
from paddle_tpu_torch import flags
from paddle_tpu_torch.reader import creator as t_creator


def same(a, b):
    """Exact structural equality: the same container types, arrays of the
    same dtype, shape and values, equal scalars."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (type(a) is type(b) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (type(a) is type(b) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    return type(a) is type(b) and a == b


def _samples(n=13, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(3).astype(np.float32), int(rng.randint(10)))
            for _ in range(n)]


def _source(pkg, seed=0, n=13):
    return (j_creator if pkg == "jax" else t_creator).np_array(
        np.asarray([s[0] for s in _samples(n, seed)]))


def _decorated(pkg, name):
    """(reader, epochs) of one decorator case, built from ``pkg``'s own
    creators and decorators."""
    r = j_reader if pkg == "jax" else t_reader
    src = _source(pkg)
    other = _source(pkg, seed=1, n=9)
    cases = {
        "map_readers": lambda: r.map_readers(lambda a, b: a * 2 + b, src,
                                             other),
        "shuffle": lambda: r.shuffle(src, 4),
        "chain": lambda: r.chain(src, other),
        "compose": lambda: r.compose(src, other, check_alignment=False),
        "compose_aligned": lambda: r.compose(src, src),
        "buffered": lambda: r.buffered(src, 3),
        "batch": lambda: r.batch(src, 4),
        "batch_drop_last": lambda: r.batch(src, 4, drop_last=True),
        "firstn": lambda: r.firstn(src, 5),
        "cache": lambda: r.cache(src),
        "fake": lambda: r.Fake()(src, 4),
    }
    return cases[name]()


DECORATORS = ["map_readers", "shuffle", "chain", "compose",
              "compose_aligned", "buffered", "batch", "batch_drop_last",
              "firstn", "cache", "fake"]


def _epochs(reader, n=2):
    out = []
    for epoch in range(n):
        random.seed(100 + epoch)  # shuffle draws from Python's random
        out.append(list(reader()))
    return out


@pytest.mark.parametrize("name", DECORATORS)
def test_decorator_yields_reference_items(name):
    want = _epochs(_decorated("jax", name))
    got = _epochs(_decorated("port", name))
    assert want[0], name
    assert same(got, want)


def test_xmap_readers_order_and_multiset():
    def mapper(x):
        return x * 3.0

    src_t, src_j = _source("port"), _source("jax")
    ordered = list(t_reader.xmap_readers(mapper, src_t, 3, 2,
                                         order=True)())
    one_worker = list(j_reader.xmap_readers(mapper, src_j, 1, 2,
                                            order=True)())
    assert same(ordered, one_worker)
    assert same(ordered, [mapper(x) for x in src_t()])

    def key(x):
        return x.tobytes()

    many_t = list(t_reader.xmap_readers(mapper, src_t, 3, 2)())
    many_j = list(j_reader.xmap_readers(mapper, src_j, 3, 2)())
    assert sorted(map(key, many_t)) == sorted(map(key, many_j))
    assert len(many_t) == 13


def _plain_reader(seed):
    # numpy and Python values only: the forked child touches no torch
    def reader():
        rng = np.random.RandomState(seed)
        for i in range(7):
            yield (rng.randint(0, 100, 3).astype(np.int64), seed * 10 + i)
    return reader


@pytest.mark.parametrize("use_pipe", [True, False])
def test_multiprocess_reader_multiset(use_pipe):
    readers = [_plain_reader(s) for s in (1, 2, 3)]

    def key(s):
        return (s[0].tobytes(), s[1])

    got = list(t_reader.multiprocess_reader(readers, use_pipe=use_pipe)())
    want = list(j_reader.multiprocess_reader(readers, use_pipe=use_pipe)())
    assert len(got) == 21
    assert sorted(map(key, got)) == sorted(map(key, want))


@pytest.mark.parametrize("file_type", ["plain", "gzip"])
def test_pipe_reader_matches_reference(tmp_path, file_type):
    text = "".join("line %d %s\n" % (i, "x" * i) for i in range(40))
    text += "no newline at the end"
    path = str(tmp_path / "t.txt")
    if file_type == "gzip":
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
    for cut in (True, False):
        got = list(t_reader.PipeReader("cat " + path, bufsize=64,
                                       file_type=file_type).get_line(cut))
        want = list(j_reader.PipeReader("cat " + path, bufsize=64,
                                        file_type=file_type).get_line(cut))
        assert got == want
        assert got == text.split("\n") if cut else "".join(got) == text


def test_creators_match_reference(tmp_path):
    arr = np.arange(24, dtype=np.float32).reshape(6, 4)
    assert same(list(t_creator.np_array(arr)()),
                list(j_creator.np_array(arr)()))
    path = str(tmp_path / "lines.txt")
    with open(path, "w") as f:
        f.write("a b\n\nc\nlast")
    assert list(t_creator.text_file(path)()) == \
        list(j_creator.text_file(path)())
    paths = []
    for i in range(2):
        p = str(tmp_path / ("s%d.rio" % i))
        j_recordio_writer.convert_reader_to_recordio_file(
            p, _source("jax", seed=i), max_num_records=4)
        paths.append(p)
    for arg in (paths, ",".join(paths)):
        got = list(t_creator.recordio(arg, buf_size=3)())
        want = list(j_creator.recordio(arg, buf_size=3)())
        assert got == want and len(got) == 26


def _first(reader, n=64):
    return list(itertools.islice(reader(), n))


# name -> a function of the dataset package giving its readers
DATASETS = {
    "mnist": lambda d: (d.mnist.train(), d.mnist.test()),
    "cifar10": lambda d: (d.cifar.train10(), d.cifar.test10()),
    "cifar100": lambda d: (d.cifar.train100(), d.cifar.test100()),
    "imdb": lambda d: (d.imdb.train(), d.imdb.test()),
    "uci_housing": lambda d: (d.uci_housing.train(), d.uci_housing.test()),
    "flowers": lambda d: (d.flowers.train(), d.flowers.test(),
                          d.flowers.valid()),
    "wmt14": lambda d: (d.wmt14.train(30), d.wmt14.test(30),
                        d.wmt14.gen(30)),
    "wmt16": lambda d: (d.wmt16.train(30, 40), d.wmt16.test(30, 40),
                        d.wmt16.validation(30, 40, src_lang="de")),
    "movielens": lambda d: (d.movielens.train(), d.movielens.test()),
    "imikolov": lambda d: (
        d.imikolov.train(d.imikolov.build_dict(), 5),
        d.imikolov.test(d.imikolov.build_dict(), 5),
        d.imikolov.train(d.imikolov.build_dict(), 0,
                         d.imikolov.DataType.SEQ)),
    "conll05": lambda d: (d.conll05.train(), d.conll05.test()),
    "sentiment": lambda d: (d.sentiment.train(), d.sentiment.test()),
    "mq2007": lambda d: tuple(
        getattr(d.mq2007, split)(format=f)
        for split in ("train", "test")
        for f in ("pointwise", "pairwise", "listwise")),
    "voc2012": lambda d: (d.voc2012.train(), d.voc2012.test(),
                          d.voc2012.val()),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_first_samples_match_reference(name):
    got = [_first(r) for r in DATASETS[name](t_dataset)]
    want = [_first(r) for r in DATASETS[name](j_dataset)]
    assert all(want)
    assert same(got, want)


def test_dataset_tables_match_reference():
    t, j = t_dataset, j_dataset
    assert t.imdb.word_dict() == j.imdb.word_dict()
    assert t.sentiment.get_word_dict() == j.sentiment.get_word_dict()
    assert t.conll05.get_dict() == j.conll05.get_dict()
    assert same(t.conll05.get_embedding(), j.conll05.get_embedding())
    assert t.wmt14.get_dict(20) == j.wmt14.get_dict(20)
    assert t.wmt16.get_dict("en", 20, reverse=True) == \
        j.wmt16.get_dict("en", 20, reverse=True)
    assert t.imikolov.build_dict() == j.imikolov.build_dict()
    for fn in ("get_movie_title_dict", "max_movie_id", "max_user_id",
               "max_job_id", "movie_categories"):
        assert getattr(t.movielens, fn)() == getattr(j.movielens, fn)()
    assert sorted(t.movielens.movie_info()) == \
        sorted(j.movielens.movie_info())


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    """A temporary data root: the port reaches it through its ``data``
    flag, set with ``fluid.set_flags``; the JAX package through its
    modules' ``_DATA_DIR``, patched here only."""
    root = str(tmp_path)
    for mod in (j_dataset.mnist, j_dataset.flowers):
        monkeypatch.setattr(mod, "_DATA_DIR", root)
    yield root
    flags.reset_flag("data")


def _write_idx(root, split_files, n, seed):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    os.makedirs(os.path.join(root, "mnist"), exist_ok=True)
    img_name, lbl_name = split_files
    with gzip.open(os.path.join(root, "mnist", img_name), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with gzip.open(os.path.join(root, "mnist", lbl_name), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return images, labels


def test_mnist_reads_real_idx_files_through_the_data_flag(data_root):
    images, labels = _write_idx(
        data_root, ("train-images-idx3-ubyte.gz",
                    "train-labels-idx1-ubyte.gz"), 5, 0)
    _write_idx(data_root, ("t10k-images-idx3-ubyte.gz",
                           "t10k-labels-idx1-ubyte.gz"), 3, 1)
    train, test = t_dataset.mnist.train(), t_dataset.mnist.test()
    synthetic = _first(train, 5)
    # the flag is read when a reader starts, not when it is made
    tfluid.set_flags({"data": data_root})
    assert flags.get_flag("data") == data_root
    got = [list(train()), list(test())]
    want = [list(j_dataset.mnist.train()()), list(j_dataset.mnist.test()())]
    assert same(got, want) and len(got[0]) == 5 and len(got[1]) == 3
    np.testing.assert_array_equal(
        got[0][2][0], images[2].reshape(-1).astype(np.float32) / 127.5 - 1)
    assert got[0][4][1] == int(labels[4])
    assert not same(got[0], synthetic)
    flags.reset_flag("data")
    assert same(_first(train, 5), synthetic)


def test_flowers_reads_a_real_npz_through_the_data_flag(data_root):
    rng = np.random.RandomState(3)
    os.makedirs(os.path.join(data_root, "flowers"))
    for split, n in (("train", 4), ("test", 2), ("valid", 3)):
        np.savez(os.path.join(data_root, "flowers", split + ".npz"),
                 images=rng.randint(0, 256, (n, 3, 8, 8)).astype(np.uint8),
                 labels=rng.randint(0, 102, n))
    tfluid.set_flags({"data": data_root})
    got = [list(r()) for r in DATASETS["flowers"](t_dataset)]
    want = [list(r()) for r in DATASETS["flowers"](j_dataset)]
    assert [len(g) for g in got] == [4, 2, 3]
    assert same(got, want)
