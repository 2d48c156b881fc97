"""MNIST reader (reference: python/paddle/dataset/mnist.py — yields
(784-float image in [-1,1], int label)). Reads IDX files from
$PADDLE_GPU_DATA/mnist when present, else synthesizes a deterministic
pseudo-MNIST with class-dependent structure.
Port of ``paddle_tpu/dataset/mnist.py``: the same seeded samples.
"""

import gzip
import os
import struct

import numpy as np

from paddle_tpu_torch.dataset.common import data_path


def _idx_paths(split):
    if split == "train":
        return (data_path("mnist", "train-images-idx3-ubyte.gz"),
                data_path("mnist", "train-labels-idx1-ubyte.gz"))
    return (data_path("mnist", "t10k-images-idx3-ubyte.gz"),
            data_path("mnist", "t10k-labels-idx1-ubyte.gz"))


def _read_idx(images_path, labels_path):
    with gzip.open(labels_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(n), dtype=np.uint8)
    with gzip.open(images_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        images = images.reshape(n, rows * cols)
    return images, labels


def _synthetic(n, seed):
    """Class-structured fake digits: label-specific template + noise.
    The templates come from a FIXED seed shared by both splits — train
    and test must describe the same task, or a model generalizes at
    chance and accuracy-based tests (e.g. the INT8 delta discipline)
    are vacuous; ``seed`` only drives the split's labels and noise."""
    rng = np.random.RandomState(seed)
    templates = np.random.RandomState(1234).randn(10, 784).astype(
        np.float32)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    images = templates[labels] + 0.5 * rng.randn(n, 784).astype(np.float32)
    images = np.clip((images + 3) / 6 * 255, 0, 255).astype(np.uint8)
    return images, labels


def _reader(split, n_synth, seed):
    def reader():
        imgs_path, lbls_path = _idx_paths(split)
        if os.path.exists(imgs_path) and os.path.exists(lbls_path):
            images, labels = _read_idx(imgs_path, lbls_path)
        else:
            images, labels = _synthetic(n_synth, seed)
        for img, lbl in zip(images, labels):
            yield (img.astype(np.float32) / 127.5 - 1.0), int(lbl)

    return reader


def train():
    return _reader("train", 2048, 0)


def test():
    return _reader("test", 512, 1)
