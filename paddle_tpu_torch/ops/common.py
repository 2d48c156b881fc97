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

A dropout seed is a Python int or a 0-d int64 tensor (an entry of the
engine's seed table, read on the device); both give the same bits.
"""

import torch

from paddle_tpu_torch.core.registry import amp_enabled

M32 = 0xFFFFFFFF


def fp32_accum(x):
    """The AMP numerics policy for accumulation-sensitive internals (norm
    statistics, softmax, losses): low-precision floats compute in float32;
    callers cast the result back to the activation dtype (common.py:8)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x


def amp_cast(*xs):
    """Under AMP, float32 operands cast to bfloat16, the compute dtype
    (common.py:19), a ``SelectedRows`` its values; anything else passes
    through. One argument in, one out."""
    if not amp_enabled():
        return xs if len(xs) > 1 else xs[0]
    out = tuple(
        x.to(torch.bfloat16) if getattr(x, "dtype", None) == torch.float32
        else x
        for x in xs)
    return out if len(out) > 1 else out[0]


def seed32(seed):
    """A dropout seed's low 32 bits: a Python int, or an int64 tensor for
    a tensor seed."""
    if isinstance(seed, torch.Tensor):
        return seed & M32
    return int(seed) & M32


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


def scatter_rows(shape, rows, vals):
    """A zero tensor of ``shape`` with ``vals`` added at ``rows`` of its
    first dim, by ``index_put_(accumulate=True)``: on CUDA it sorts the
    ids and adds each row's values in a fixed order, so repeated steps
    agree bit for bit; ``index_add_`` adds with float atomics, in an
    order that changes from run to run."""
    out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    return out.index_put_((rows,), vals, accumulate=True)


class _Take(torch.autograd.Function):
    """``x.index_select(dim, idx)`` whose grad adds the output grad back
    with ``scatter_rows`` (``index_select``'s own grad is ``index_add_``)."""

    @staticmethod
    def forward(x, idx, dim):
        return x.index_select(dim, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, idx, dim = inputs
        ctx.save_for_backward(idx)
        ctx.dim = dim
        ctx.x_meta = (x.shape[dim], x.dtype)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n, dtype = ctx.x_meta
        rows = g.movedim(ctx.dim, 0).to(dtype)
        dx = scatter_rows((n,) + tuple(rows.shape[1:]), idx, rows)
        return dx.movedim(0, ctx.dim), None, None


def take(x, idx, dim=0):
    """The entries of ``x`` at the indices ``idx`` (flattened) along
    ``dim``, with a grad that is bitwise repeatable on the card
    (``_Take``)."""
    return _Take.apply(x, idx.reshape(-1).long(), dim)


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
    ``seed`` is a uint32, as a Python int or a 0-d int64 tensor on
    ``device`` (the reference draws it with one threefry call, the port
    from the op's torch RNG stream)."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device) & M32
    seed_term = _mul32(seed32(seed), 0x9E3779B9)
    h = hash_mix_bits(idx ^ seed_term)
    return ((h >> 8) >= keep_threshold(rate)).reshape(shape)
