"""Flash-attention forward: a hand-written CUDA kernel and its plain torch
version — port of ``paddle_tpu/kernels/flash_attention.py``.

``flash_forward_cuda`` launches ``csrc/flash_fwd.cu``, which replaces the
Pallas TPU kernel ``_attn_kernel`` (flash_attention.py:110-181, launched
by ``_flash_forward`` :218-266). ``attention_lse_plain`` is the same
function in plain torch: it mirrors ``_xla_scores``/``_xla_attention_lse``
(:528-563) but takes the kernel's offsets and fully-masked-row rule and
draws its dropout mask with the kernel's hash, so the two agree exactly
up to float rounding. ``flash_attention_lse`` dispatches on ``q.is_cuda``:
a CUDA tensor goes to the kernel (which launches or raises), a CPU or
``meta`` tensor to the plain version — so build-time shape inference on
``meta`` tensors never launches anything, and nothing falls back.

``launches`` counts kernel launches (one per ``flash_forward_cuda`` call
that launched), so a run can show the main path went through the kernel.

The backward kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) are a later
slice (ROADMAP Queue 2); nothing here needs a gradient yet.
"""

import ctypes

import torch

from paddle_tpu_torch.ops.common import M32, _mul32, hash_mix_bits, \
    keep_threshold

_NEG = -1e30
D_MAX = 128

launches = 0


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
    ``(bits >> 8) >= keep_threshold(rate)``. Integer tensors broadcast."""
    idx = (q_pos * t_k + k_pos) & M32
    seed_term = ((int(seed) & M32) + _mul32((bh + 1) & M32, 0x9E3779B9)) & M32
    h = hash_mix_bits(idx ^ seed_term)
    return (h >> 8) >= keep_threshold(rate)


def attention_lse_plain(q, k, v, seq_lens=None, offsets=None, seed=0,
                        causal=False, scale=None, rate=0.0):
    """Plain torch attention over q [B, H, Tq, D], k/v [B, H, Tk, D]:
    ``(out, lse)``, out in q's dtype, lse float32 [B, H, Tq] of the
    pre-dropout softmax. Same semantics as ``flash_forward_cuda``."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = D ** -0.5 if scale is None else scale
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
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    live = m > 0.5 * _NEG
    l = torch.where(live, p.sum(dim=-1, keepdim=True), torch.zeros_like(m))
    l_safe = l.clamp(min=1e-30)
    lse = m + torch.log(l_safe)
    if rate > 0.0:
        bh = torch.arange(B * H, device=dev).reshape(B, H, 1, 1)
        keep = keep_mask(seed, bh, q_pos, k_pos, Tk, rate)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), torch.zeros_like(p))
    acc = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    out = torch.where(live, acc / l_safe, torch.zeros_like(acc))
    return out.to(q.dtype), lse.squeeze(-1)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


_lib_handle = None


def _lib():
    """The built kernel library, its C signatures declared once."""
    global _lib_handle
    if _lib_handle is None:
        from paddle_tpu_torch.kernels import build

        lib = build.load("flash_fwd")
        p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        lib.flash_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f, i,
                                  u, f, u, i, i, i, p]
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def flash_forward_cuda(q, k, v, seq_lens=None, offsets=None, seed=0,
                       causal=False, scale=None, rate=0.0):
    """Launch the CUDA flash forward on contiguous q [B, H, Tq, D] and
    k/v [B, H, Tk, D] (float32 or bfloat16, D <= 128) on one card.
    Returns ``(out, lse)`` as ``attention_lse_plain`` does; raises on any
    input the kernel does not take and on a refused launch."""
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_forward_cuda: q, k, v must be CUDA tensors "
                         "on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_forward_cuda: q, k, v must share a dtype in "
                         "float32/bfloat16, got %s %s %s"
                         % (q.dtype, k.dtype, v.dtype))
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_forward_cuda: q [B,H,Tq,D], k/v [B,H,Tk,D]")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError("flash_forward_cuda: q %s and k %s disagree"
                         % (tuple(q.shape), tuple(k.shape)))
    if D > D_MAX:
        raise ValueError("flash_forward_cuda: head dim %d > %d" % (D, D_MAX))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_forward_cuda: q, k, v must be contiguous")
    scale = D ** -0.5 if scale is None else float(scale)
    q_off, k_off = _offsets_pair(offsets)
    lens = None
    if seq_lens is not None:
        if seq_lens.numel() != B:
            raise ValueError("flash_forward_cuda: seq_lens needs %d entries"
                             % B)
        # int64 as fed; the kernel clamps lengths to >= 1 itself
        lens = seq_lens.reshape(B).to(device=q.device,
                                      dtype=torch.int64).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), None if lens is None else lens.data_ptr(),
            B * H, H, Tq, Tk, D, int(bool(causal)), scale,
            int(rate > 0.0), keep_threshold(rate),
            (1.0 / (1.0 - rate)) if rate > 0.0 else 1.0,
            int(seed) & M32, q_off, k_off, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError("flash_fwd launch failed: CUDA error %d (%s)"
                           % (rc, lib.flash_fwd_error_string(rc).decode()))
    launches += 1
    return out, lse


def flash_attention_lse(q, k, v, seq_lens=None, offsets=None, seed=0,
                        causal=False, scale=None, rate=0.0):
    """``(out, lse [B, H, Tq])``: the CUDA kernel for CUDA tensors, the
    plain version for CPU and ``meta`` tensors."""
    if q.is_cuda:
        return flash_forward_cuda(q, k, v, seq_lens, offsets, seed, causal,
                                  scale, rate)
    return attention_lse_plain(q, k, v, seq_lens, offsets, seed, causal,
                               scale, rate)


def dispatch_attention_lse(q, k, v, causal=False, scale=None, seq_lens=None,
                           dropout_rate=0.0, seed=0):
    """The ``fused_attention`` op's entry (``dispatch_attention_lse``,
    :952): ``(out, lse)`` with lse in the op's saved ``[B, H, Tq, 1]``
    layout. Inputs arrive as views from ``transpose2``; they are made
    contiguous here, where the op hands them to the kernel."""
    out, lse = flash_attention_lse(
        q.contiguous(), k.contiguous(), v.contiguous(), seq_lens, None,
        seed, causal, scale, dropout_rate)
    return out, lse.unsqueeze(-1)
