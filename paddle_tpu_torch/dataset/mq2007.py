"""MQ2007 learning-to-rank reader (reference:
python/paddle/dataset/mq2007.py — pointwise (feature, score), pairwise
(d_high, d_low), listwise (label_list, feature_list) per query).
Synthetic queries: 46-dim feature vectors whose relevance is a noisy
linear function of the features, so ranking models have real signal.
Port of ``paddle_tpu/dataset/mq2007.py``: the same seeded samples.
"""

import numpy as np

_FEATURE_DIM = 46


def _queries(n_queries, seed):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(99).randn(_FEATURE_DIM)
    for _ in range(n_queries):
        n_docs = int(rng.randint(5, 15))
        feats = rng.rand(n_docs, _FEATURE_DIM).astype(np.float32)
        raw = feats @ w + 0.2 * rng.randn(n_docs)
        # relevance 0..2 by tertile
        cuts = np.percentile(raw, [33, 66])
        labels = np.digitize(raw, cuts)
        yield labels.astype(np.float32), feats


def __reader__(filepath=None, format="pairwise", shuffle=False,
               fill_missing=-1, n_queries=200, seed=0):
    """(reference: mq2007.py:294) ``filepath`` accepted for parity; local
    LETOR-format parsing is not implemented — synthetic queries serve."""
    for labels, feats in _queries(n_queries, seed):
        if format == "pointwise":
            for l, f in zip(labels, feats):
                yield f, float(l)
        elif format == "pairwise":
            for i in range(len(labels)):
                for j in range(len(labels)):
                    if labels[i] > labels[j]:
                        yield 1.0, feats[i], feats[j]
        elif format == "listwise":
            yield labels.tolist(), [f for f in feats]
        else:
            raise ValueError("unknown format %r" % format)


def train(format="pairwise"):
    return lambda: __reader__(format=format, n_queries=200, seed=0)


def test(format="pairwise"):
    return lambda: __reader__(format=format, n_queries=40, seed=1)
