"""Weight pruners (reference:
python/paddle/fluid/contrib/slim/prune/pruner.py — MagnitudePruner:24,
RatioPruner:49). The reference builds mask programs of ops; here pruning
is a host-side mask over the scope value (same result, no graph
rewrite)."""

import numpy as np

__all__ = ["MagnitudePruner", "RatioPruner"]


class MagnitudePruner:
    """Zero weights with |w| below a threshold."""

    def __init__(self, threshold):
        self.threshold = threshold

    def prune(self, param, threshold=None):
        t = self.threshold if threshold is None else threshold
        arr = np.asarray(param)
        return np.where(np.abs(arr) < t, 0.0, arr).astype(arr.dtype)


class RatioPruner:
    """Zero the smallest-|w| fraction of each param. ``ratios`` maps
    param name -> ratio ('*' for default)."""

    def __init__(self, ratios=None):
        self.ratios = ratios or {}

    def prune(self, param, ratio=None):
        arr = np.asarray(param)
        if ratio is None:
            ratio = float(self.ratios.get("*", 0.0))
        if ratio <= 0:
            return arr
        k = int(arr.size * min(ratio, 1.0))
        if k == 0:
            return arr
        flat = np.abs(arr).reshape(-1)
        thresh = np.partition(flat, k - 1)[k - 1]
        return np.where(np.abs(arr) <= thresh, 0.0, arr).astype(arr.dtype)
