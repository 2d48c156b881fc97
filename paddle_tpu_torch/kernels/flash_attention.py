"""Flash attention: hand-written CUDA kernels and their plain torch
versions — port of ``paddle_tpu/kernels/flash_attention.py``, forward and
backward.

Three kernels, each replacing one Pallas TPU kernel:

- ``flash_forward_cuda`` launches ``csrc/flash_fwd.cu`` (``_attn_kernel``,
  flash_attention.py:110-181, launched by ``_flash_forward`` :218-266);
- ``flash_backward_cuda`` launches ``csrc/flash_bwd_dq.cu``
  (``_bwd_dq_kernel`` :269-325) and ``csrc/flash_bwd_dkv.cu``
  (``_bwd_dkv_kernel`` :328-407), both launched by ``_flash_backward``
  :410-525, after computing delta = rowsum(dO * O) - g_lse in torch
  (:441-446).

``attention_lse_plain`` and ``attention_bwd_plain`` are the same functions
in plain torch: the forward mirrors ``_xla_scores``/``_xla_attention_lse``
(:528-563) but takes the kernels' offsets and fully-masked-row rule, and
the backward computes the two backward kernels' formulas explicitly, with
their casts to the input dtype. Both draw the dropout mask with the
kernels' hash, so kernel and plain version agree up to float rounding.

``flash_attention_lse`` is a ``torch.autograd.Function`` (the reference's
custom_vjp, :662-777): its backward folds the lse cotangent into delta and
runs the backward kernels from the saved (out, lse), never the forward
again. Each entry point dispatches on ``q.is_cuda``: a CUDA tensor goes to
the kernels (which launch or raise), a CPU or ``meta`` tensor to the plain
version — so build-time shape inference on ``meta`` tensors never
launches anything, and nothing falls back.

The dropout seed is a Python int or a 0-d int64 tensor (the engine's
seed-table entry); the kernels read it from device memory through a
pointer, so a captured CUDA graph takes each run's seed from the table.

``launches``, ``launches_dq`` and ``launches_dkv`` count kernel launches
that run on the device (one per launch of each kernel), so a run can show
the main path went through the kernels. A launch made while a CUDA graph
is being captured runs only when the graph replays: inside
``record_launches()`` it is recorded instead of counted, and the engine
adds the recorded counts at each replay (``add_launches``). Given the
capture stream, ``record_launches`` also records the launches other
threads make on that stream (autograd runs a captured backward on its
own thread).

Inside ``count_flops()`` every launch adds the model FLOPs of its call,
from its shapes and the keys below each row's length (and, if causal,
at or before the row): 4 per (query, key, head dim) for the forward, 8
for the backward pair. The engine's FLOP count (``torch.utils.
flop_counter.FlopCounterMode``) cannot see a ctypes launch.
"""

import contextlib
import ctypes
import threading

import torch

from paddle_tpu_torch.ops.common import M32, _mul32, hash_mix_bits, \
    keep_threshold, seed32

_NEG = -1e30
D_MAX = 128

launches = 0
launches_dq = 0
launches_dkv = 0
COUNTERS = ("launches", "launches_dq", "launches_dkv")

# the launch counts of a capture in progress on this thread, or None
_recording = threading.local()
# capture stream handle -> the launch counts of the capture on it, for
# launches from other threads (a captured backward runs on autograd's)
_stream_records = {}
# the FLOPs of the launches inside count_flops(), or None
_flops = None


def _count(counter):
    """One launch of the counter's kernel: counted, or recorded while this
    thread, or the stream it launches on, captures a graph."""
    rec = getattr(_recording, "counts", None)
    if rec is None and _stream_records:
        rec = _stream_records.get(torch.cuda.current_stream().cuda_stream)
    if rec is not None:
        rec[counter] += 1
    else:
        globals()[counter] += 1


@contextlib.contextmanager
def record_launches(stream=None):
    """Record instead of count the launches this thread makes inside the
    block (a graph capture), and those any thread makes on ``stream``
    (the capture stream); yields the {counter: launches} record."""
    rec = dict.fromkeys(COUNTERS, 0)
    _recording.counts = rec
    key = None if stream is None else stream.cuda_stream
    if key is not None:
        _stream_records[key] = rec
    try:
        yield rec
    finally:
        _recording.counts = None
        if key is not None:
            _stream_records.pop(key, None)


@contextlib.contextmanager
def count_flops():
    """Sum the model FLOPs of the kernel launches inside the block;
    yields a one-element list holding the sum."""
    global _flops
    rec, prev = [0.0], _flops
    _flops = rec
    try:
        yield rec
    finally:
        _flops = prev


def _add_flops(per_pair, q, k, lens, causal):
    """Add ``per_pair`` FLOPs per (query row, valid key, head, head-dim
    element) of one call to the running count, if one runs (reads the
    lengths back to the host: counting runs once a cache entry)."""
    rec = _flops
    if rec is None:
        return
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    rows = ([Tk] * B if lens is None
            else [min(max(int(n), 1), Tk) for n in lens.tolist()])
    pairs = 0
    for n in rows:
        if causal:
            pairs += sum(min(i + 1, n) for i in range(Tq))
        else:
            pairs += Tq * n
    rec[0] += float(per_pair) * pairs * H * D


def add_launches(counts):
    """Count the launches of one replay of a captured graph."""
    for counter, n in counts.items():
        globals()[counter] += n


def _offsets_pair(offsets):
    """[q_off, k_off] as two ints: the Q/K global base positions (the ring
    step's shard offsets); (0, 0) for ordinary full attention."""
    if offsets is None:
        return 0, 0
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.reshape(-1).tolist()
    q_off, k_off = offsets
    return int(q_off), int(k_off)


def keep_mask(seed, bh, q_pos, k_pos, t_k, rate):
    """The kernel's dropout keep-mask (``_keep_mask``, :65-82): murmur-style
    bits of the counter ``q_pos * t_k + k_pos`` (positions local to the
    call) xor the seed term ``seed + 0x9E3779B9 * (bh + 1)``, kept when
    ``(bits >> 8) >= keep_threshold(rate)``. Integer tensors broadcast;
    ``seed`` is an int or a 0-d int64 tensor on their device."""
    idx = (q_pos * t_k + k_pos) & M32
    seed_term = (seed32(seed) + _mul32((bh + 1) & M32, 0x9E3779B9)) & M32
    h = hash_mix_bits(idx ^ seed_term)
    return (h >> 8) >= keep_threshold(rate)


def _scores(q, k, seq_lens, offsets, causal, scale):
    """The masked, scaled float32 scores [B, H, Tq, Tk] (masked entries
    hold _NEG) and the q/k position columns, as the kernels mask them:
    causal at the global offsets, keys at or past each sequence's length
    (clamped to >= 1) masked."""
    B, Tq, Tk = q.shape[0], q.shape[2], k.shape[2]
    dev = q.device
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Tq, device=dev).reshape(Tq, 1)
    k_pos = torch.arange(Tk, device=dev).reshape(1, Tk)
    valid = torch.ones((1, 1, Tq, Tk), dtype=torch.bool, device=dev)
    if causal:
        q_off, k_off = _offsets_pair(offsets)
        valid = valid & (q_pos + q_off >= k_pos + k_off)
    if seq_lens is not None:
        lens = seq_lens.reshape(B, 1, 1, 1).to(dev).clamp(min=1)
        valid = valid & (k_pos < lens)
    return torch.where(valid, s, torch.full_like(s, _NEG)), q_pos, k_pos


def _dropout_keep(seed, q, q_pos, k_pos, rate):
    """The kernels' keep mask [B, H, Tq, Tk] for q [B, H, Tq, D]."""
    B, H = q.shape[0], q.shape[1]
    bh = torch.arange(B * H, device=q.device).reshape(B, H, 1, 1)
    return keep_mask(seed, bh, q_pos, k_pos, k_pos.shape[1], rate)


def attention_lse_plain(q, k, v, seq_lens=None, offsets=None, seed=0,
                        causal=False, scale=None, rate=0.0):
    """Plain torch attention over q [B, H, Tq, D], k/v [B, H, Tk, D]:
    ``(out, lse)``, out in q's dtype, lse float32 [B, H, Tq] of the
    pre-dropout softmax. Same semantics as ``flash_forward_cuda``.

    p, after the dropout keep and the 1/(1-rate) scale, is rounded to v's
    dtype before the P.V product, as ``_attn_kernel`` casts it
    (flash_attention.py:163); the identity for float32. Here p is
    exp(s - row max); the kernels' is exp(s - running max), so with one key
    tile both round the same values, and with several they round at other
    scales wherever a later tile raises the max."""
    D = q.shape[3]
    scale = D ** -0.5 if scale is None else scale
    s, q_pos, k_pos = _scores(q, k, seq_lens, offsets, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    live = m > 0.5 * _NEG
    l = torch.where(live, p.sum(dim=-1, keepdim=True), torch.zeros_like(m))
    l_safe = l.clamp(min=1e-30)
    lse = m + torch.log(l_safe)
    if rate > 0.0:
        keep = _dropout_keep(seed, q, q_pos, k_pos, rate)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), torch.zeros_like(p))
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = torch.where(live, acc / l_safe, torch.zeros_like(acc))
    return out.to(q.dtype), lse.squeeze(-1)


def attention_bwd_plain(q, k, v, out, lse, g, g_lse=None, seq_lens=None,
                        offsets=None, seed=0, causal=False, scale=None,
                        rate=0.0):
    """Plain torch backward of ``attention_lse_plain`` from its saved
    ``(out, lse)``: ``(dq, dk, dv)`` in q's, k's and v's dtypes, for the
    cotangent ``g`` of out and ``g_lse`` [B, H, Tq] of lse (None for
    none). The two backward kernels' formulas written out, not autograd:
    delta = rowsum(g * out) - g_lse; p = exp(s - lse), 0 on masked keys
    and on fully masked rows (lse ~= -1e30); dp = g . v^T kept and scaled
    by the forward's dropout mask; ds = p * (dp - delta) * scale;
    dq = ds . k, dk = ds^T . q, dv = p_drop^T . g, with p_drop cast to
    g's dtype and ds to k's before the products, as the kernels cast
    them (flash_attention.py:320, :383, :392)."""
    D = q.shape[3]
    scale = D ** -0.5 if scale is None else scale
    s, q_pos, k_pos = _scores(q, k, seq_lens, offsets, causal, scale)
    delta = _delta(out, g, g_lse).unsqueeze(-1)
    lse = lse.float().unsqueeze(-1)
    p = torch.where(lse > 0.5 * _NEG, torch.exp(s - lse),
                    torch.zeros_like(s))
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    p_drop = p
    if rate > 0.0:
        keep = _dropout_keep(seed, q, q_pos, k_pos, rate)
        inv = 1.0 / (1.0 - rate)
        p_drop = torch.where(keep, p, torch.zeros_like(p)) * inv
        dp = torch.where(keep, dp, torch.zeros_like(dp)) * inv
    ds = p * (dp - delta) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p_drop.to(g.dtype).float(),
                      g.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(out, g, g_lse):
    """delta = rowsum(g * out) - g_lse, float32 [B, H, Tq]: the lse
    cotangent folds in exactly, since ds from g_lse is p * g_lse
    (flash_attention.py:438-446)."""
    delta = (g.float() * out.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# library -> the argument types of its entry point after the tensors'
# pointers: (BH, H, Tq, Tk, D, causal, scale, dropout, keep_thr, inv_keep,
# seed (int64 in device memory), q_off, k_off, dtype, stream)
_TAIL_ARGS = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                   ctypes.c_uint, ctypes.c_float,
                                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
# library -> the number of tensor pointers its entry point takes first
_N_POINTERS = {"flash_fwd": 6, "flash_bwd_dq": 8, "flash_bwd_dkv": 9}

_libs = {}
# first loads from two threads: one declares the signatures, and neither
# calls an entry point before they are declared
_libs_lock = threading.Lock()


def _lib(name):
    """The built kernel library ``name``, its C signatures declared once."""
    lib = _libs.get(name)
    if lib is None:
        from paddle_tpu_torch.kernels import build

        with _libs_lock:
            lib = _libs.get(name)
            if lib is None:
                lib = build.load(name)
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] * _N_POINTERS[name]
                               + _TAIL_ARGS)
                fn.restype = ctypes.c_int
                err = getattr(lib, name + "_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def _seed_on_device(seed, device):
    """The seed as an int64 tensor on ``device`` for the kernels' pointer:
    a seed-table entry as it is; an int copied to the card, which a graph
    capture cannot hold (it would freeze the value), so it raises there."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.device != device \
                or seed.numel() != 1:
            raise ValueError("the dropout seed must be one int64 on %s, got "
                             "%s %s on %s" % (device, seed.dtype,
                                              tuple(seed.shape), seed.device))
        return seed
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a dropout seed given as a Python int cannot be "
                           "captured in a CUDA graph; pass the seed table's "
                           "tensor")
    return torch.tensor(int(seed) & M32, dtype=torch.int64, device=device)


def _launch(name, pointers, q, k, lens, causal, scale, rate, seed,
            offsets):
    """Call kernel library ``name`` on the current stream of q's device
    and raise on a refused launch. Without dropout the kernel gets no
    seed."""
    lib = _lib(name)
    B, H, Tq, D = q.shape
    q_off, k_off = _offsets_pair(offsets)
    seed_t = _seed_on_device(seed, q.device) if rate > 0.0 else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, name)(
            *pointers, None if lens is None else lens.data_ptr(),
            B * H, H, Tq, k.shape[2], D, int(bool(causal)), scale,
            int(rate > 0.0), keep_threshold(rate),
            (1.0 / (1.0 - rate)) if rate > 0.0 else 1.0,
            None if seed_t is None else seed_t.data_ptr(), q_off, k_off,
            _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        err = getattr(lib, name + "_error_string")(rc).decode()
        raise RuntimeError("%s launch failed: CUDA error %d (%s)"
                           % (name, rc, err))


def _check_cuda_inputs(who, q, k, v, seq_lens, *more_q_shaped):
    """Validate what the kernels take: CUDA tensors on one device, one
    dtype in float32/bfloat16, q [B, H, Tq, D] and k/v [B, H, Tk, D] with
    D <= 128, contiguous. ``more_q_shaped`` (out, dO) must match q.
    Returns ``(scale default, lens)``: the int64 lengths on q's device, as
    fed (the kernels clamp them to >= 1 themselves), or None."""
    tensors = (q, k, v) + more_q_shaped
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("%s: inputs must be CUDA tensors on one device"
                         % who)
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in tensors):
        raise ValueError("%s: inputs must share a dtype in float32/bfloat16, "
                         "got %s" % (who, [t.dtype for t in tensors]))
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("%s: q [B,H,Tq,D], k/v [B,H,Tk,D]" % who)
    B, H, Tq, D = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError("%s: q %s and k %s disagree"
                         % (who, tuple(q.shape), tuple(k.shape)))
    if any(t.shape != q.shape for t in more_q_shaped):
        raise ValueError("%s: out and its cotangent must have q's shape %s"
                         % (who, tuple(q.shape)))
    if D > D_MAX:
        raise ValueError("%s: head dim %d > %d" % (who, D, D_MAX))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("%s: inputs must be contiguous" % who)
    if seq_lens is None:
        return None
    if seq_lens.numel() != B:
        raise ValueError("%s: seq_lens needs %d entries" % (who, B))
    return seq_lens.reshape(B).to(device=q.device,
                                  dtype=torch.int64).contiguous()


def flash_forward_cuda(q, k, v, seq_lens=None, offsets=None, seed=0,
                       causal=False, scale=None, rate=0.0):
    """Launch the CUDA flash forward on contiguous q [B, H, Tq, D] and
    k/v [B, H, Tk, D] (float32 or bfloat16, D <= 128) on one card.
    Returns ``(out, lse)`` as ``attention_lse_plain`` does; raises on any
    input the kernel does not take and on a refused launch."""
    lens = _check_cuda_inputs("flash_forward_cuda", q, k, v, seq_lens)
    B, H, Tq, D = q.shape
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _launch("flash_fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), lse.data_ptr()),
            q, k, lens, causal, scale, rate, seed, offsets)
    _count("launches")
    _add_flops(4, q, k, lens, causal)
    return out, lse


def flash_backward_cuda(q, k, v, out, lse, g, g_lse=None, seq_lens=None,
                        offsets=None, seed=0, causal=False, scale=None,
                        rate=0.0):
    """Launch the CUDA dQ and dK/dV kernels: ``(dq, dk, dv)`` as
    ``attention_bwd_plain`` returns them, from the forward's saved ``out``
    and ``lse`` [B, H, Tq] (float32) and the cotangents ``g`` (q's shape)
    and ``g_lse`` ([B, H, Tq], or None). Delta is computed first, in
    torch. Raises on any input the kernels do not take and on a refused
    launch."""
    lens = _check_cuda_inputs("flash_backward_cuda", q, k, v, seq_lens, out,
                              g)
    B, H, Tq, D = q.shape
    if lse.shape != (B, H, Tq) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError("flash_backward_cuda: lse must be float32 %s on "
                         "q's device" % ((B, H, Tq),))
    scale = D ** -0.5 if scale is None else float(scale)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = lse.contiguous()
    delta = _delta(out, g, g_lse).contiguous()
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    args = (q, k, lens, causal, scale, rate, seed, offsets)
    _launch("flash_bwd_dq", common + (dq.data_ptr(),), *args)
    _count("launches_dq")
    _launch("flash_bwd_dkv", common + (dk.data_ptr(), dv.data_ptr()), *args)
    _count("launches_dkv")
    _add_flops(8, q, k, lens, causal)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, g, g_lse=None, seq_lens=None,
                        offsets=None, seed=0, causal=False, scale=None,
                        rate=0.0):
    """``(dq, dk, dv)``: the CUDA kernels for CUDA tensors, the plain
    version for CPU and ``meta`` tensors."""
    fn = flash_backward_cuda if q.is_cuda else attention_bwd_plain
    return fn(q, k, v, out, lse, g, g_lse, seq_lens, offsets, seed, causal,
              scale, rate)


class _FlashAttentionLse(torch.autograd.Function):
    """``(out, lse)`` with a backward that runs the backward kernels from
    the saved (out, lse); seq_lens, offsets, seed, causal, scale and rate
    get no gradient. Written in the ``setup_context`` form so it also
    composes with ``torch.func``."""

    @staticmethod
    def forward(q, k, v, seq_lens, offsets, seed, causal, scale, rate):
        fn = flash_forward_cuda if q.is_cuda else attention_lse_plain
        return fn(q, k, v, seq_lens, offsets, seed, causal, scale, rate)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, seq_lens, offsets, seed, causal, scale, rate = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse, seq_lens)
        ctx.args = (offsets, seed, causal, scale, rate)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, seq_lens = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, g_out.contiguous(), g_lse, seq_lens,
            *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_lse(q, k, v, seq_lens=None, offsets=None, seed=0,
                        causal=False, scale=None, rate=0.0):
    """``(out, lse [B, H, Tq])``, differentiable in q, k and v (and
    through lse): the CUDA kernels for CUDA tensors, the plain versions
    for CPU and ``meta`` tensors."""
    return _FlashAttentionLse.apply(q, k, v, seq_lens, offsets, seed,
                                    causal, scale, rate)


def _shard_layout(q, seq_lens):
    """Over a mesh (q a DTensor): (mesh, the placements every input is
    brought to, those of the lengths, the per-shard seed's shard index).
    The batch stays split where q's is and the heads where q's are; the
    sequence and head dims are gathered. The shard index is linear over
    the axes that split the batch, then the one that splits the heads,
    in mesh order (reference: ``_shard_seed``, :912)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    sizes = list(mesh.mesh.shape)
    places, lens_places = [], []
    batch, head = [], []
    for mdim, pl in enumerate(q.placements):
        if isinstance(pl, Shard) and pl.dim in (0, 1):
            places.append(pl)
            lens_places.append(pl if pl.dim == 0 else Replicate())
            if sizes[mdim] > 1:
                (batch if pl.dim == 0 else head).append(mdim)
        else:
            places.append(Replicate())
            lens_places.append(Replicate())
    idx = 0
    for mdim in batch + head:
        idx = idx * sizes[mdim] + mesh.get_local_rank(mdim)
    return mesh, tuple(places), tuple(lens_places), idx


def _local_inputs(mesh, places, *tensors):
    """Each DTensor at ``places``, as this rank's local tensor (a plain
    tensor, the same on every rank, is sliced to the same shard)."""
    from torch.distributed.tensor import DTensor

    from paddle_tpu_torch.parallel.plan import local_chunk

    out = []
    for t in tensors:
        if t is None:
            out.append(None)
        elif isinstance(t, DTensor):
            out.append(t.redistribute(mesh, places).to_local())
        else:
            out.append(local_chunk(t, mesh, places))
    return out


def _shard_seed(seed, idx):
    """Per-shard dropout seed (reference: ``_shard_seed``, :912): seed +
    shard index * 1000003, so shards draw decorrelated masks (the hash
    indexes by LOCAL (b, q, k) coordinates, which repeat across shards);
    the forward and both backward kernels of a shard take the same."""
    if idx == 0:
        return seed
    if isinstance(seed, torch.Tensor):
        return seed + idx * 1000003
    return int(seed) + idx * 1000003


def dispatch_attention_lse(q, k, v, causal=False, scale=None, seq_lens=None,
                           dropout_rate=0.0, seed=0):
    """The ``fused_attention`` op's entry (``dispatch_attention_lse``,
    :952): ``(out, lse)`` with lse in the op's saved ``[B, H, Tq, 1]``
    layout. Inputs arrive as views from ``transpose2``; they are made
    contiguous here, where the op hands them to the kernel.

    Over a mesh (DTensor inputs, the engine's mesh path) each rank runs
    the kernel on its own batch and head shard, with the lengths sliced
    alike and the per-shard dropout seed, and the results are DTensors
    at the same placements: attention is independent across batch and
    heads, so the split is exact (the reference's shard_map wrap)."""
    from torch.distributed.tensor import DTensor

    from paddle_tpu_torch.parallel.plan import from_shard

    if isinstance(q, DTensor):
        mesh, places, lens_places, idx = _shard_layout(q, seq_lens)
        ql, kl, vl = _local_inputs(mesh, places, q, k, v)
        (lens,) = _local_inputs(mesh, lens_places, seq_lens)
        out, lse = dispatch_attention_lse(
            ql, kl, vl, causal, scale, lens, dropout_rate,
            _shard_seed(seed, idx) if dropout_rate > 0.0 else seed)
        return (from_shard(out, mesh, places),
                from_shard(lse, mesh, places))
    out, lse = flash_attention_lse(
        q.contiguous(), k.contiguous(), v.contiguous(), seq_lens, None,
        seed, causal, scale, dropout_rate)
    return out, lse.unsqueeze(-1)


def dispatch_attention_bwd(q, k, v, out, lse, g, causal=False, scale=None,
                           seq_lens=None, dropout_rate=0.0, seed=0):
    """The ``fused_attention_grad`` op's entry: ``(dq, dk, dv)`` from the
    forward op's saved ``Out`` and ``Lse`` (``[B, H, Tq, 1]``), as
    ``fused_attention_grad`` calls ``flash_backward_spmd`` (:1013): over
    a mesh, per batch and head shard with the forward's shard seed."""
    from torch.distributed.tensor import DTensor

    from paddle_tpu_torch.parallel.plan import from_shard

    if isinstance(q, DTensor):
        mesh, places, lens_places, idx = _shard_layout(q, seq_lens)
        ql, kl, vl, ol, ll = _local_inputs(mesh, places, q, k, v, out, lse)
        gl = _local_inputs(mesh, places, g.reshape(q.shape))[0]
        (lens,) = _local_inputs(mesh, lens_places, seq_lens)
        grads = dispatch_attention_bwd(
            ql, kl, vl, ol, ll, gl, causal, scale, lens, dropout_rate,
            _shard_seed(seed, idx) if dropout_rate > 0.0 else seed)
        return tuple(from_shard(t, mesh, places) for t in grads)
    B, H, Tq = q.shape[0], q.shape[1], q.shape[2]
    return flash_attention_bwd(
        q.contiguous(), k.contiguous(), v.contiguous(),
        out.to(q.dtype).contiguous(), lse.reshape(B, H, Tq),
        g.to(q.dtype).reshape(q.shape).contiguous(), None, seq_lens, None,
        seed, causal, scale, dropout_rate)
