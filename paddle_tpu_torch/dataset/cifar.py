"""CIFAR-10/100 reader (reference: python/paddle/dataset/cifar.py — yields
(3072-float image in [0,1] CHW, int label)). Local pickle batches when
present, class-structured synthetic otherwise.
Port of ``paddle_tpu/dataset/cifar.py``: the same seeded samples.
"""

import os
import pickle

import numpy as np

from paddle_tpu_torch.dataset.common import data_path


def _load_local(name, split):
    base = data_path(name)
    files = []
    if os.path.isdir(base):
        if split == "train":
            files = [os.path.join(base, f) for f in sorted(os.listdir(base))
                     if "data_batch" in f or f == "train"]
        else:
            files = [os.path.join(base, f) for f in os.listdir(base)
                     if "test" in f]
    for path in files:
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        labels = d.get(b"labels", d.get(b"fine_labels"))
        for img, lbl in zip(d[b"data"], labels):
            yield img, int(lbl)


def _synthetic(n, n_classes, seed):
    rng = np.random.RandomState(seed)
    templates = rng.randn(n_classes, 3072).astype(np.float32)
    labels = rng.randint(0, n_classes, n)
    images = templates[labels] + 0.5 * rng.randn(n, 3072).astype(np.float32)
    images = np.clip((images + 3) / 6 * 255, 0, 255).astype(np.uint8)
    for img, lbl in zip(images, labels):
        yield img, int(lbl)


def _reader(name, split, n_classes, n_synth, seed):
    def reader():
        got_any = False
        for img, lbl in _load_local(name, split):
            got_any = True
            yield img.astype(np.float32) / 255.0, lbl
        if not got_any:
            for img, lbl in _synthetic(n_synth, n_classes, seed):
                yield img.astype(np.float32) / 255.0, lbl

    return reader


def train10():
    return _reader("cifar-10-batches-py", "train", 10, 2048, 0)


def test10():
    return _reader("cifar-10-batches-py", "test", 10, 512, 1)


def train100():
    return _reader("cifar-100-python", "train", 100, 2048, 2)


def test100():
    return _reader("cifar-100-python", "test", 100, 512, 3)
