"""Why chip_smoke.py's float32 limits hold for the tensor-core flash
kernels, shown on the CPU.

``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu`` and
``csrc/flash_bwd_dkv.cu`` take their float32 products on the tensor cores
as 3xTF32: each operand x is split into big = tf32(x) and
small = tf32(x - big), and a.b is taken as big.big + big.small +
small.big in a float32 accumulator. These tests emulate that arithmetic
here, rounding to TF32 by bit masking as ``cvt.rna.tf32.f32`` does, and
run the kernels' formulas (the forward in its 64-key tiles with a running
max, dQ's three products, dK/dV's four) at the shapes of chip_smoke.py's
kernel cases, with B and H reduced. They
assert that the emulated float32 errors against the plain versions stay at
least 10x inside ``TOL``/``TOL_BWD``, and that one TF32 product per float32
product would fail those limits in every case. For
bfloat16 they emulate the forward's rounding of P at the running max and
hold it to chip_smoke.py's bfloat16 limit, whose P term is derived there.
Last, under a model of the tensor cores' float32 addition (operands cut
to the largest one's exponent, not rounded), P.V chained into one
accumulator comes out biased, though far inside the limit, and summed
step by step, as ``mma_3xtf32_acc`` sums it, it does not.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch.kernels.flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                               "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BLOCK_K = 64  # keys per K/V tile of flash_fwd.cu
LOG2E = 1.4426950408889634
NEG = tfa._NEG


def tf32(x):
    """float32 x rounded to TF32 (10 explicit mantissa bits, to nearest,
    ties away from zero: ``cvt.rna.tf32.f32``) by bit masking."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul(mode):
    """a @ b on float32 tensors as the kernels take it: "3xtf32"
    (big.big + big.small + small.big), "1xtf32" (one TF32 product), or
    "exact" (bfloat16 operands, whose products float32 holds exactly)."""
    def mm(a, b):
        if mode == "1xtf32":
            return tf32(a) @ tf32(b)
        if mode == "3xtf32":
            a_big, b_big = tf32(a), tf32(b)
            a_small, b_small = tf32(a - a_big), tf32(b - b_big)
            return a_small @ b_big + a_big @ b_small + a_big @ b_big
        return a @ b
    return mm


def _valid_and_keep(q, k, lens, offsets, causal, rate, seed):
    """The kernels' key mask [B, H, Tq, Tk] and dropout keep mask (or
    None), from the plain version's helpers."""
    scale = q.shape[3] ** -0.5
    s, q_pos, k_pos = tfa._scores(q, k, lens, offsets, causal, scale)
    keep = (tfa._dropout_keep(seed, q, q_pos, k_pos, rate) if rate > 0.0
            else None)
    return s > 0.5 * NEG, keep


def emulate_forward(q, k, v, lens, offsets, seed, causal, rate, mode):
    """flash_fwd.cu's arithmetic on float32 tensors: tiles of 64 keys,
    scores and running max in log2 units, P kept by dropout and scaled,
    then rounded to bfloat16 (mode "exact", the bf16 kernel) or split for
    TF32, and out = acc / l. Returns out (float32)."""
    mm = matmul(mode)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale_log2 = D ** -0.5 * LOG2E
    valid, keep = _valid_and_keep(q, k, lens, offsets, causal, rate, seed)
    m = torch.full((B, H, Tq, 1), NEG)
    l = torch.zeros((B, H, Tq, 1))
    acc = torch.zeros((B, H, Tq, D))
    for k0 in range(0, Tk, BLOCK_K):
        sl = slice(k0, k0 + BLOCK_K)
        x = mm(q, k[:, :, sl].transpose(-1, -2)) * scale_log2
        x = torch.where(valid[..., sl], x, torch.full_like(x, NEG))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        if keep is not None:
            p = torch.where(keep[..., sl], p / (1.0 - rate),
                            torch.zeros_like(p))
        if mode == "exact":
            p = p.to(torch.bfloat16).float()
        acc = acc * corr + mm(p, v[:, :, sl])
    live = m > 0.5 * NEG
    l_safe = torch.where(live, l, torch.zeros_like(l)).clamp(min=1e-30)
    return torch.where(live, acc / l_safe, torch.zeros_like(acc))


def _emulate_ds(q, k, v, out, lse, g, lens, offsets, seed, causal, rate,
                mm):
    """The backward kernels' shared arithmetic on float32 tensors: S and dP
    by the products ``mm``, p = exp2(s * scale * log2 e - lse * log2 e) (0
    on masked keys and fully masked rows), dropout on p_drop and dp, and
    dS. Returns (p_drop, ds)."""
    scale = q.shape[3] ** -0.5
    valid, keep = _valid_and_keep(q, k, lens, offsets, causal, rate, seed)
    lse = lse.unsqueeze(-1)
    valid = valid & (lse > 0.5 * NEG)
    s = mm(q, k.transpose(-1, -2))
    p = torch.where(valid, torch.exp2(s * (scale * LOG2E) - lse * LOG2E),
                    torch.zeros_like(s))
    dp = mm(g, v.transpose(-1, -2))
    p_drop = p
    if keep is not None:
        p_drop = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
        dp = torch.where(keep, dp / (1.0 - rate), torch.zeros_like(dp))
    return p_drop, p * (dp - tfa._delta(out, g, None).unsqueeze(-1)) * scale


def emulate_dkv(q, k, v, out, lse, g, lens, offsets, seed, causal, rate,
                mode):
    """flash_bwd_dkv.cu's arithmetic: p_drop and dS as ``_emulate_ds``
    takes them with ``mode``'s products, then dK = dS^T.Q and
    dV = p_drop^T.dO by the same products."""
    mm = matmul(mode)
    p_drop, ds = _emulate_ds(q, k, v, out, lse, g, lens, offsets, seed,
                             causal, rate, mm)
    return (mm(ds.transpose(-1, -2), q), mm(p_drop.transpose(-1, -2), g))


def emulate_dq(q, k, v, out, lse, g, lens, offsets, seed, causal, rate,
               mode):
    """flash_bwd_dq.cu's arithmetic: dS as ``_emulate_ds`` takes it with
    ``mode``'s products, then dQ = dS.K by the same products."""
    mm = matmul(mode)
    _, ds = _emulate_ds(q, k, v, out, lse, g, lens, offsets, seed, causal,
                        rate, mm)
    return (mm(ds, k),)


def _cases(dtype):
    """chip_smoke.py's kernel cases of ``dtype``, those at the
    Transformer's shapes too, B cut to 2 and H to 2."""
    for i, (name, B, H, Tq, Tk, D, dt, causal, lens, offs, rate) in \
            enumerate(chip_smoke.KERNEL_CASES
                      + chip_smoke.nmt_kernel_cases()):
        if dt == dtype:
            B, H = min(B, 2), min(H, 2)
            yield pytest.param(i, B, H, Tq, Tk, D, causal,
                               None if lens is None else lens[:B], offs,
                               rate, id=name)


def _inputs(i, B, H, Tq, Tk, D, lens, dtype=torch.float32):
    rng = np.random.RandomState(300 + i)
    q, k, v, g = (torch.from_numpy(rng.randn(B, H, t, D).astype(np.float32))
                  .to(dtype) for t in (Tq, Tk, Tk, Tq))
    return q, k, v, g, None if lens is None else torch.tensor(lens)


def _fwd_errors(args):
    """max |emulated - plain| of the forward's out for 3xTF32 and 1xTF32."""
    q, k, v, lens, offs, seed, causal, rate = args
    want, _ = tfa.attention_lse_plain(q, k, v, lens, offs, seed, causal,
                                      None, rate)
    return {mode: (emulate_forward(*args, mode) - want).abs().max().item()
            for mode in ("3xtf32", "1xtf32")}


def _bwd_excess(emulate, args, g):
    """Per mode, the largest ratio of |emulated - plain| to TOL_BWD's
    allowed difference over the grads ``emulate`` returns: (dq,) for
    ``emulate_dq``, (dk, dv) for ``emulate_dkv``."""
    q, k, v, lens, offs, seed, causal, rate = args
    out, lse = tfa.attention_lse_plain(*args[:7], None, rate)
    dq, dk, dv = tfa.attention_bwd_plain(q, k, v, out, lse, g, None, lens,
                                         offs, seed, causal, None, rate)
    want = (dq,) if emulate is emulate_dq else (dk, dv)
    tol = chip_smoke.TOL_BWD["float32"]
    ratio = {}
    for mode in ("3xtf32", "1xtf32"):
        got = emulate(q, k, v, out, lse, g, lens, offs, seed, causal, rate,
                      mode)
        ratio[mode] = max(
            ((a - b).abs() / (tol["rel"] * b.abs() + tol["abs_of_max"]
                              * b.abs().max() + tol["abs"])).max().item()
            for a, b in zip(got, want))
    return ratio


@pytest.mark.parametrize("i,B,H,Tq,Tk,D,causal,lens,offs,rate",
                         list(_cases("float32")))
def test_3xtf32_forward_stays_a_tenth_inside_tol(i, B, H, Tq, Tk, D, causal,
                                                 lens, offs, rate):
    q, k, v, _, lens_t = _inputs(i, B, H, Tq, Tk, D, lens)
    err = _fwd_errors((q, k, v, lens_t, offs, 1234, causal, rate))
    limit = chip_smoke.TOL["float32"]["out_abs"]
    assert err["3xtf32"] <= limit / 10, err
    assert err["1xtf32"] > limit, err


@pytest.mark.parametrize("i,B,H,Tq,Tk,D,causal,lens,offs,rate",
                         list(_cases("float32")))
def test_3xtf32_dkv_stays_a_tenth_inside_tol_bwd(i, B, H, Tq, Tk, D, causal,
                                                 lens, offs, rate):
    q, k, v, g, lens_t = _inputs(i, B, H, Tq, Tk, D, lens)
    ratio = _bwd_excess(emulate_dkv, (q, k, v, lens_t, offs, 4321, causal,
                                      rate), g)
    assert ratio["3xtf32"] <= 0.1, ratio
    assert ratio["1xtf32"] > 1.0, ratio


@pytest.mark.parametrize("i,B,H,Tq,Tk,D,causal,lens,offs,rate",
                         list(_cases("float32")))
def test_3xtf32_dq_stays_a_tenth_inside_tol_bwd(i, B, H, Tq, Tk, D, causal,
                                                lens, offs, rate):
    q, k, v, g, lens_t = _inputs(i, B, H, Tq, Tk, D, lens)
    ratio = _bwd_excess(emulate_dq, (q, k, v, lens_t, offs, 4321, causal,
                                     rate), g)
    assert ratio["3xtf32"] <= 0.1, ratio
    assert ratio["1xtf32"] > 1.0, ratio


@pytest.mark.parametrize("i,B,H,Tq,Tk,D,causal,lens,offs,rate",
                         list(_cases("bfloat16")))
def test_bf16_forward_p_rounding_stays_inside_tol(i, B, H, Tq, Tk, D,
                                                  causal, lens, offs, rate):
    """The bf16 kernel rounds P at the running max of its 64-key tiles,
    the plain version at the row max: the emulated kernel stays inside
    chip_smoke.py's bfloat16 limit, P term included."""
    q, k, v, _, lens_t = _inputs(i, B, H, Tq, Tk, D, lens, torch.bfloat16)
    args = (q, k, v, lens_t, offs, 1234, causal, rate)
    want, _ = tfa.attention_lse_plain(*args[:7], None, rate)
    got = emulate_forward(q.float(), k.float(), v.float(), *args[3:],
                          "exact").to(torch.bfloat16)
    tol = chip_smoke.TOL["bfloat16"]
    want = want.float()
    allowed = (tol["out_rel"] * want.abs() + tol["out_abs_of_max_v"]
               * v.float().abs().max() / (1.0 - rate) + tol["out_abs"])
    assert ((got.float() - want).abs() <= allowed).all()


def tensor_core_add(c, a8, b8):
    """One m16n8k8 TF32 mma, c + a8 . b8, under a model of the tensor
    cores' float32 addition: the eight exact products and c aligned to the
    largest exponent among them and cut, not rounded, to 24 bits, summed,
    and the sum cut to float32 towards zero."""
    terms = torch.cat([c.double().unsqueeze(-2),
                       a8.double().unsqueeze(-1) * b8.double().unsqueeze(-3)],
                      dim=-2)
    _, e = torch.frexp(terms.abs().amax(dim=-2))
    ulp = torch.ldexp(torch.ones_like(e, dtype=torch.float64),
                      e - 24).unsqueeze(-2)
    total = (torch.trunc(terms / ulp) * ulp).sum(-2)
    out = total.float()
    over = out.double().abs() > total.abs()
    return torch.where(over, torch.nextafter(out, torch.zeros_like(out)), out)


def tensor_core_3xtf32(a, b, stepwise):
    """a @ b as 3xTF32 mma steps 8 deep under ``tensor_core_add``: each
    step's three products summed from zero and added to the accumulator in
    float32 (``stepwise``), as ``mma_3xtf32_acc`` in csrc/flash_mma.cuh
    sums P.V, dP, dQ, dK and dV up to head dim 64, or chained into the
    accumulator itself, as the head-dim-128 float32 instances sum."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    c = torch.zeros(a.shape[:-1] + (b.shape[-1],))
    for k0 in range(0, a.shape[-1], 8):
        sl = slice(k0, k0 + 8)
        t = torch.zeros_like(c) if stepwise else c
        for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
            t = tensor_core_add(t, x[..., sl], y[..., sl, :])
        c = c + t if stepwise else t
    return c


def test_stepwise_3xtf32_keeps_pv_unbiased():
    """P.V over 256 keys at head dim 64, values with a common part, as the
    Transformer-base's activations have at random init. Chained into one
    accumulator under the tensor cores' cut additions, out shrinks by
    about 3e-6 of itself: a bias, a twentieth of chip_smoke.py's float32
    limit on out, so the chained head-dim-128 instances stay inside it.
    Summed step by step the bias is gone to a fiftieth."""
    torch.manual_seed(0)
    p = torch.softmax(torch.randn(2, 256, 256), -1)
    v = torch.randn(2, 256, 64) + 1.0
    exact = p.double() @ v.double()
    shrink = {}
    for stepwise in (False, True):
        out = tensor_core_3xtf32(p, v, stepwise).double()
        shrink[stepwise] = float((out * exact).sum() / (exact * exact).sum()
                                 - 1.0)
    assert shrink[False] < -1e-6, shrink
    assert (abs(shrink[False]) * float(exact.abs().max())
            <= chip_smoke.TOL["float32"]["out_abs"] / 10), shrink
    assert abs(shrink[True]) < abs(shrink[False]) / 50, shrink
