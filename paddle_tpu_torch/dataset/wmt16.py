"""WMT16 en-de reader (reference: python/paddle/dataset/wmt16.py — yields
(src_ids, trg_ids, trg_ids_next); <s>=0, <e>=1, <unk>=2). Reads
``$PADDLE_GPU_DATA/wmt16/{split}.tsv`` (en \\t de per line) when present,
else synthesizes a deterministic copy-with-offset translation corpus —
target tokens are a fixed function of source tokens, so a seq2seq model
can actually learn it.
Port of ``paddle_tpu/dataset/wmt16.py``: the same seeded samples.
"""

import os

import numpy as np

from paddle_tpu_torch.dataset.common import data_path


START_MARK = "<s>"
END_MARK = "<e>"
UNK_MARK = "<unk>"
_START, _END, _UNK = 0, 1, 2
_RESERVED = 3


def get_dict(lang, dict_size, reverse=False):
    """Token dictionary (reference: wmt16.py:294). Synthetic vocabulary is
    ``<w{i}>`` for ids past the reserved marks."""
    words = {START_MARK: _START, END_MARK: _END, UNK_MARK: _UNK}
    for i in range(_RESERVED, dict_size):
        words["<%s%d>" % (lang, i)] = i
    if reverse:
        return {v: k for k, v in words.items()}
    return words


def _tsv_path(split):
    return data_path("wmt16", split + ".tsv")


def _real_reader(path, src_dict_size, trg_dict_size, src_lang):
    src_dict = get_dict(src_lang, src_dict_size)
    trg_lang = "de" if src_lang == "en" else "en"
    trg_dict = get_dict(trg_lang, trg_dict_size)
    src_col = 0 if src_lang == "en" else 1
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) != 2:
                continue
            src_words = parts[src_col].split()
            trg_words = parts[1 - src_col].split()
            src_ids = ([_START]
                       + [src_dict.get(w, _UNK) for w in src_words]
                       + [_END])
            trg_ids = [trg_dict.get(w, _UNK) for w in trg_words]
            yield src_ids, [_START] + trg_ids, trg_ids + [_END]


def _synthetic(n, seed, src_dict_size, trg_dict_size):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        length = int(rng.randint(3, 12))
        src = rng.randint(_RESERVED, src_dict_size, length)
        # deterministic "translation": shift each token id
        trg = [(_RESERVED + (int(t) - _RESERVED + 7) %
                (trg_dict_size - _RESERVED)) for t in src]
        src_ids = [_START] + [int(t) for t in src] + [_END]
        yield src_ids, [_START] + trg, trg + [_END]


def _reader_creator(split, n_synth, seed, src_dict_size, trg_dict_size,
                    src_lang):
    def reader():
        path = _tsv_path(split)
        if os.path.exists(path):
            for sample in _real_reader(path, src_dict_size, trg_dict_size,
                                       src_lang):
                yield sample
        else:
            for sample in _synthetic(n_synth, seed, src_dict_size,
                                     trg_dict_size):
                yield sample

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader_creator("train", 2000, 0, src_dict_size, trg_dict_size,
                           src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader_creator("test", 200, 1, src_dict_size, trg_dict_size,
                           src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader_creator("val", 200, 2, src_dict_size, trg_dict_size,
                           src_lang)
