"""Shared helpers for op lowerings — port of ``paddle_tpu/ops/common.py``.

The counter-based dropout hash (``hash_mix_bits``/``keep_threshold``,
common.py:92-107) is the contract that lets the generic dropout op and
the flash-attention kernel and its plain version all draw their masks
from (seed, coordinate) alone. The reference computes it in uint32; torch
has no uint32 arithmetic, so it runs here in int64 holding values in
[0, 2**32), masked with ``& 0xFFFFFFFF`` after every multiply. A 32x32
multiply does not fit a signed 64-bit product, so each multiply is split
into 16-bit halves of the constant (``_mul32``), which keeps every
intermediate below 2**49 and the low 32 bits exact.
"""

import torch

M32 = 0xFFFFFFFF


def bcast_y_to_x(x, y, axis):
    """Fluid elementwise broadcast: align Y's dims to X starting at ``axis``
    (reference: paddle/fluid/operators/elementwise/elementwise_op_function.h,
    the trim-trailing-ones + mid-broadcast rule)."""
    if x.shape == y.shape:
        return y
    if y.ndim > x.ndim:
        # e.g. scalar X vs [1] Y — plain broadcasting is well-defined
        return y
    if axis == -1:
        axis = x.ndim - y.ndim
    # Trim trailing 1s of y (reference does this before computing n/post)
    y_shape = list(y.shape)
    while y_shape and y_shape[-1] == 1 and len(y_shape) > 1:
        if axis + len(y_shape) > x.ndim or x.shape[axis + len(y_shape) - 1] != 1:
            y_shape = y_shape[:-1]
        else:
            break
    y = y.reshape(y_shape) if tuple(y_shape) != tuple(y.shape) else y
    new_shape = [1] * x.ndim
    for i, d in enumerate(y.shape):
        new_shape[axis + i] = d
    return y.reshape(new_shape)


def flatten_to_2d(x, num_col_dims):
    """Reference ``mul`` op semantics: flatten leading ``num_col_dims`` dims
    into rows, rest into cols (paddle/fluid/operators/mul_op.cc)."""
    rows = 1
    for d in x.shape[:num_col_dims]:
        rows *= d
    cols = 1
    for d in x.shape[num_col_dims:]:
        cols *= d
    return x.reshape(rows, cols)


def single(ins, slot, default=None):
    vals = ins.get(slot, [])
    return vals[0] if vals else default


def flatten_lookup_ids(ids):
    """lookup_table id normalization: a trailing dim of 1 is squeezed
    (reference: lookup_table_op.cc treats ids as a column of indices)."""
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        return ids.squeeze(-1)
    return ids


def _mul32(h, c):
    """(h * c) mod 2**32 for int64 ``h`` in [0, 2**32) and a 32-bit
    constant ``c``, without overflowing int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def hash_mix_bits(h):
    """2-round xorshift-multiply finalizer (common.py:92) on int64 tensors
    holding uint32 values."""
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def keep_threshold(rate):
    """24-bit integer threshold for ``mixed_bits >> 8 >= threshold`` keep
    tests (common.py:104)."""
    return int(float(rate) * (1 << 24))


def hash_keep_mask(seed, shape, rate, device):
    """Counter-based dropout keep-mask (common.py:110): the hash of the
    row-major element coordinate, xor-ed with ``seed * 0x9E3779B9``.
    ``seed`` is a uint32 Python int (the reference draws it with one
    threefry call, the port from the op's torch RNG stream)."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device) & M32
    seed_term = (int(seed) * 0x9E3779B9) & M32
    h = hash_mix_bits(idx ^ seed_term)
    return ((h >> 8) >= keep_threshold(rate)).reshape(shape)
