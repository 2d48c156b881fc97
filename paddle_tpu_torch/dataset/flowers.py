"""Flowers-102 reader (reference: python/paddle/dataset/flowers.py —
yields (CHW float32 image, int label in [0, 102))). Reads
``$PADDLE_GPU_DATA/flowers/{split}.npz`` (arrays ``images`` [N, 3, H, W]
uint8/float, ``labels`` [N]) when present, else synthesizes
class-structured images (per-class color template + noise).
Port of ``paddle_tpu/dataset/flowers.py``: the same seeded samples.
"""

import os

import numpy as np

from paddle_tpu_torch.dataset.common import data_path

_CLASSES = 102
_SIZE = 32  # synthetic resolution; real npz keeps its own


def _load_npz(split):
    path = data_path("flowers", split + ".npz")
    if os.path.exists(path):
        d = np.load(path)
        return d["images"], d["labels"]
    return None


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    templates = rng.rand(_CLASSES, 3, 1, 1).astype(np.float32)
    labels = rng.randint(0, _CLASSES, n)
    images = (np.broadcast_to(templates[labels],
                              (n, 3, _SIZE, _SIZE))
              + 0.1 * rng.randn(n, 3, _SIZE, _SIZE)).astype(np.float32)
    return np.clip(images, 0.0, 1.0), labels


def _reader(split, n_synth, seed):
    def reader():
        real = _load_npz(split)
        if real is not None:
            images, labels = real
            images = images.astype(np.float32)
            if images.max() > 1.5:
                images = images / 255.0
        else:
            images, labels = _synthetic(n_synth, seed)
        for img, lbl in zip(images, labels):
            yield img, int(lbl)

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader("train", 1024, 0)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader("test", 256, 1)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader("valid", 256, 2)
