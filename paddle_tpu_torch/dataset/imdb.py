"""IMDB sentiment reader (reference: python/paddle/dataset/imdb.py —
yields (token-id list, 0/1 label)). Synthetic corpus with a
sentiment-bearing vocabulary split when no local data exists.
Port of ``paddle_tpu/dataset/imdb.py``: the same seeded samples.
"""

import numpy as np

_VOCAB_SIZE = 5148  # reference vocabulary size after frequency cutoff


def word_dict():
    return {"<w%d>" % i: i for i in range(_VOCAB_SIZE)}


def _synthetic(n, seed):
    """Positive docs oversample the low id range, negative the high —
    a learnable, deterministic sentiment signal."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(20, 120))
        if label == 1:
            ids = rng.randint(0, _VOCAB_SIZE // 2, length)
        else:
            ids = rng.randint(_VOCAB_SIZE // 2, _VOCAB_SIZE, length)
        yield ids.tolist(), label


def train(word_idx=None):
    def reader():
        for sample in _synthetic(2000, 0):
            yield sample

    return reader


def test(word_idx=None):
    def reader():
        for sample in _synthetic(400, 1):
            yield sample

    return reader
