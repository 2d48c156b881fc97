"""``fluid.core`` names of the feed path: ``LoDTensor``, ``LoDTensorArray``
and ``create_lod_tensor`` (reference: paddle/fluid/framework/lod_tensor.h,
pybind LoDTensorArray). Port of those names of ``paddle_tpu/core_shim.py``
(:19-80); the rest of that module (ROADMAP Queue 1 item 12) is not ported
yet. A LoDTensor is a host array with its LoD offsets beside it; the
engine takes padded arrays and explicit lengths (``DataFeeder``'s
``@LEN`` columns), not LoD."""

import numpy as np


class LoDTensor:
    """Host-side array + LoD offsets (reference: lod_tensor.h:110)."""

    def __init__(self):
        self._array = None
        self._lod = []

    def set(self, array, place=None):
        self._array = np.asarray(array)

    def set_lod(self, lod):
        self._lod = lod

    def lod(self):
        return self._lod

    def recursive_sequence_lengths(self):
        return [[e - s for s, e in zip(level[:-1], level[1:])]
                for level in self._lod]

    def set_recursive_sequence_lengths(self, lengths):
        self._lod = []
        for level in lengths:
            offsets = [0]
            for n in level:
                offsets.append(offsets[-1] + n)
            self._lod.append(offsets)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._array, dtype=dtype)

    def shape(self):
        return list(self._array.shape)

    def has_valid_recursive_sequence_lengths(self):
        """(reference: lod_tensor.cc CheckAbsLoD) — offsets ascending and
        the last level ending at dim 0 of the data."""
        if not self._lod:
            return True
        for level in self._lod:
            if any(b < a for a, b in zip(level, level[1:])):
                return False
        if self._array is not None:
            return self._lod[-1][-1] == self._array.shape[0]
        return True


class LoDTensorArray(list):
    """(reference: pybind LoDTensorArray — a vector<LoDTensor>)."""

    def append(self, t):
        if not isinstance(t, LoDTensor):
            arr = t
            t = LoDTensor()
            t.set(arr)
        list.append(self, t)


def create_lod_tensor(data, recursive_seq_lens=None, place=None):
    t = LoDTensor()
    t.set(data, place)
    if recursive_seq_lens:
        t.set_recursive_sequence_lengths(recursive_seq_lens)
    return t
