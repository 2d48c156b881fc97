"""WMT14 fr-en reader (reference: python/paddle/dataset/wmt14.py — yields
(src_ids, trg_ids with leading <s>, trg_ids_next with trailing <e>);
<s>=0, <e>=1, <unk>=2). Same local-tsv-else-synthetic discipline as
wmt16; the synthetic corpus is the shifted-copy translation.
Port of ``paddle_tpu/dataset/wmt14.py``: the same seeded samples.
"""

import os
import zlib

import numpy as np

from paddle_tpu_torch.dataset.common import data_path

_START, _END, _UNK = 0, 1, 2
_RESERVED = 3


def get_dict(dict_size, reverse=True):
    """(reference: wmt14.py:156) — returns (src_dict, trg_dict)."""
    words = {"<s>": _START, "<e>": _END, "<unk>": _UNK}
    for i in range(_RESERVED, dict_size):
        words["<w%d>" % i] = i
    if reverse:
        rev = {v: k for k, v in words.items()}
        return rev, dict(rev)
    return dict(words), dict(words)


def _reader_creator(split, n_synth, seed, dict_size):
    def reader():
        path = data_path("wmt14", split + ".tsv")
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    ids = lambda ws: [
                        _RESERVED + (zlib.crc32(w.encode("utf-8"))
                                     % (dict_size - _RESERVED))
                        for w in ws.split()]
                    src, trg = ids(parts[0]), ids(parts[1])
                    yield src, [_START] + trg, trg + [_END]
        else:
            rng = np.random.RandomState(seed)
            for _ in range(n_synth):
                length = int(rng.randint(3, 12))
                src = [int(t) for t in
                       rng.randint(_RESERVED, dict_size, length)]
                trg = [(_RESERVED + (t - _RESERVED + 7)
                        % (dict_size - _RESERVED)) for t in src]
                yield src, [_START] + trg, trg + [_END]

    return reader


def train(dict_size):
    return _reader_creator("train", 2000, 0, dict_size)


def test(dict_size):
    return _reader_creator("test", 200, 1, dict_size)


def gen(dict_size):
    return _reader_creator("gen", 200, 2, dict_size)
