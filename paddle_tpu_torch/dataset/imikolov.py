"""PTB / imikolov language-model reader (reference:
python/paddle/dataset/imikolov.py — NGRAM mode yields n-gram id tuples,
SEQ mode yields (src_seq, trg_seq)). Reads
``$PADDLE_GPU_DATA/imikolov/{split}.txt`` when present, else generates a
Markov-chain corpus over the synthetic vocabulary (bigram structure, so
a word2vec / n-gram LM has signal to learn).
Port of ``paddle_tpu/dataset/imikolov.py``: the same seeded samples.
"""

import os

import numpy as np

from paddle_tpu_torch.dataset.common import data_path

_VOCAB = 2074  # reference vocab size at min_word_freq=50


class DataType:
    NGRAM = 1
    SEQ = 2


def build_dict(min_word_freq=50):
    """Word -> id with <s>, <e>, <unk> (reference: imikolov.py:53)."""
    d = {"<s>": 0, "<e>": 1, "<unk>": 2}
    path = data_path("imikolov", "train.txt")
    if os.path.exists(path):
        from collections import Counter

        counts = Counter()
        with open(path) as f:
            for line in f:
                counts.update(line.strip().split())
        for w, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
            if c >= min_word_freq:
                d[w] = len(d)
        return d
    for i in range(3, _VOCAB):
        d["<w%d>" % i] = i
    return d


def _sentences(split, n_synth, seed):
    path = data_path("imikolov", split + ".txt")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                yield line.strip().split()
        return
    # Markov chain: next-word distribution depends on current word bucket
    rng = np.random.RandomState(seed)
    for _ in range(n_synth):
        length = int(rng.randint(5, 20))
        w = int(rng.randint(3, _VOCAB))
        words = []
        for _ in range(length):
            words.append("<w%d>" % w)
            w = 3 + (w * 31 + int(rng.randint(0, 7))) % (_VOCAB - 3)
        yield words


def _reader_creator(split, n_synth, seed, word_idx, n, data_type):
    def reader():
        unk = word_idx["<unk>"]
        for words in _sentences(split, n_synth, seed):
            if data_type == DataType.NGRAM:
                assert n > -1, "Invalid gram length"
                l = ["<s>"] + words + ["<e>"]
                if len(l) >= n:
                    ids = [word_idx.get(w, unk) for w in l]
                    for i in range(n, len(ids) + 1):
                        yield tuple(ids[i - n:i])
            elif data_type == DataType.SEQ:
                ids = [word_idx.get(w, unk) for w in words]
                src = [word_idx["<s>"]] + ids
                trg = ids + [word_idx["<e>"]]
                if n > 0 and len(src) > n:
                    continue
                yield src, trg
            else:
                raise AssertionError("Unknown data type")

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader_creator("train", 1000, 0, word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader_creator("test", 200, 1, word_idx, n, data_type)
