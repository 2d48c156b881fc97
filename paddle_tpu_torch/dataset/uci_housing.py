"""UCI housing regression reader (reference:
python/paddle/dataset/uci_housing.py — yields (13 features, price)).
Synthetic linear-plus-noise data with the real feature count.
Port of ``paddle_tpu/dataset/uci_housing.py``: the same seeded samples.
"""

import numpy as np

_N_FEATURES = 13


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(_N_FEATURES).astype(np.float32)
    X = rng.randn(n, _N_FEATURES).astype(np.float32)
    y = X @ w + 0.1 * rng.randn(n).astype(np.float32) + 22.5
    for xi, yi in zip(X, y):
        yield xi, np.array([yi], np.float32)


def train():
    def reader():
        for s in _synthetic(404, 0):
            yield s

    return reader


def test():
    def reader():
        for s in _synthetic(102, 1):
            yield s

    return reader
