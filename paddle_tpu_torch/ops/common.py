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


_SAME_WIDTH_INT = {torch.float64: torch.int64, torch.float32: torch.int32,
                   torch.bfloat16: torch.int16, torch.float16: torch.int16}


def topk_lowest_index_first(x, k):
    """(values, int64 indices) of the ``k`` largest entries along the last
    dim, in descending order, as ``lax.top_k`` returns them: floats in
    IEEE total order (-0.0 below +0.0) and ties taken lowest index first
    (``torch.topk`` orders ties otherwise). Each float's bits are read as
    an integer whose order is the total order (the magnitude bits
    flipped where the sign bit is set); a key of at most 32 bits goes
    into the high half of an int64 whose low half ranks the index
    downwards, so one ``torch.topk`` of distinct values picks and orders
    them; a 64-bit key takes a stable descending sort cut to ``k``."""
    key = x
    if x.is_floating_point():
        bits = x.view(_SAME_WIDTH_INT[x.dtype])
        key = torch.where(bits < 0, bits ^ torch.iinfo(bits.dtype).max, bits)
    if key.dtype == torch.int64:
        idx = torch.sort(key, dim=-1, descending=True, stable=True).indices
        idx = idx[..., :k]
    else:
        rank = (1 << 32) - 1 - torch.arange(x.shape[-1], device=x.device)
        idx = torch.topk(key.long() * (1 << 32) + rank, k, dim=-1).indices
    return x.gather(-1, idx), idx


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


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def hash_bits(seed, n, device, start=0):
    """The counter-based hash of the coordinates ``start`` ..
    ``start + n - 1`` under ``seed``: ``hash_mix_bits(i ^ seed *
    0x9E3779B9)``, int64 in [0, 2**32)."""
    idx = torch.arange(start, start + n, dtype=torch.int64,
                       device=device) & M32
    return hash_mix_bits(idx ^ _mul32(seed32(seed), 0x9E3779B9))


def hash_keep_mask(seed, shape, rate, device):
    """Counter-based dropout keep-mask (common.py:110): the hash of the
    row-major element coordinate, xor-ed with ``seed * 0x9E3779B9``.
    ``seed`` is a uint32, as a Python int or a 0-d int64 tensor on
    ``device`` (the reference draws it with one threefry call, the port
    from the op's torch RNG stream)."""
    h = hash_bits(seed, _numel(shape), device)
    return ((h >> 8) >= keep_threshold(rate)).reshape(shape)


def uniform_ints(seed, shape, high, device):
    """Counter-based uniform integers in [0, ``high``) of ``shape``
    (int64): the hash of each row-major coordinate under ``seed`` (a
    dropout seed, ``hash_bits``) mapped to the range by multiply-shift,
    ``(h * high) >> 32``. The same seed gives the same ids on every
    device, and an op that takes its seed from the run's seed table
    draws fresh ids at each replay of a captured graph."""
    if not 0 < int(high) <= 2 ** 31:
        raise ValueError("uniform_ints: high %d outside (0, 2**31]" % high)
    h = hash_bits(seed, _numel(shape), device)
    return ((h * int(high)) >> 32).reshape(tuple(shape))


def uniform_floats(seed, shape, device, stream=0):
    """Counter-based float32 uniforms in [0, 1) of ``shape``, 24 bits
    each, from coordinates ``stream * n + i`` of ``hash_bits`` (``n`` the
    number of elements), so an op can draw several independent
    tensors from one seed."""
    n = _numel(shape)
    h = hash_bits(seed, n, device, start=stream * n)
    return ((h >> 8).float() * (1.0 / (1 << 24))).reshape(tuple(shape))


def hash_op_bits(x, k):
    """The ``hash`` op's mix (misc_ops.py:236-251): a splitmix-style mix
    of the uint32 ids ``x`` (int64 tensors, read as ``x & 0xFFFFFFFF``)
    for hash number ``k``, in int64 held to 32 bits. The JAX package
    builds ``k * 0x85EBCA6B`` as a uint32 constant, which overflows from
    ``k = 2`` on: so does this."""
    salt = k * 0x85EBCA6B
    if salt > M32:
        raise OverflowError(
            "Python integer %d out of bounds for uint32 (hash number %d)"
            % (salt, k))
    h = (_mul32(x & M32, 0x9E3779B1) + salt) & M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 13)
