"""NLTK movie-review sentiment reader (reference:
python/paddle/dataset/sentiment.py — yields (word id list, 0/1 label)).
Same deterministic synthetic signal as dataset/imdb.py (split
vocabulary) at the reference's vocabulary scale.
Port of ``paddle_tpu/dataset/sentiment.py``: the same seeded samples.
"""

import numpy as np

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000
_VOCAB = 4000


def get_word_dict():
    """Sorted word -> id (reference: sentiment.py:56)."""
    return {"<w%d>" % i: i for i in range(_VOCAB)}


def _synthetic(start, n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(start, start + n):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(10, 60))
        if label == 1:
            ids = rng.randint(0, _VOCAB // 2, length)
        else:
            ids = rng.randint(_VOCAB // 2, _VOCAB, length)
        yield ids.tolist(), label


def train():
    return lambda: _synthetic(0, NUM_TRAINING_INSTANCES, 0)


def test():
    return lambda: _synthetic(NUM_TRAINING_INSTANCES,
                              NUM_TOTAL_INSTANCES
                              - NUM_TRAINING_INSTANCES, 1)
