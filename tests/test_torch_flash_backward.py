"""The port's flash-attention backward (paddle_tpu_torch/kernels/
flash_attention.py: ``attention_bwd_plain`` behind the
``flash_attention_lse`` autograd.Function) against the JAX package's
``flash_attention_lse`` custom_vjp run in interpret mode on the CPU, which
runs the two Pallas backward kernels ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``.

On the CPU the autograd.Function's backward takes the plain version (the
CUDA dQ and dK/dV kernels are checked against it on the card by
chip_smoke.py). Inputs and cotangents come from numpy with a seed and go
through both. Tolerance: float32, rtol/atol 1e-5 — the Pallas kernels
accumulate tile by tile, the plain version in one product; the difference
is float32 rounding only. Dropout uses the same int32 seed on both sides,
so the two draw the same keep mask and the grads agree to the same
tolerance (another seed moves them by orders of magnitude more).
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu_torch.kernels.flash_attention as tfa
from test_torch_flash_attention import assert_within_bf16_ulps

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

RTOL, ATOL = 1e-5, 1e-5


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_grads(q, k, v, g, g_lse, seq_lens=None, offsets=None, seed=0,
               causal=False, rate=0.0, block_q=16, block_k=16,
               dtype=jnp.float32):
    """jax.vjp of the Pallas custom_vjp (interpret mode): (dq, dk, dv),
    as float32 numpy arrays; q, k, v and g in ``dtype``."""
    def f(q_, k_, v_):
        return jfa.flash_attention_lse(
            q_, k_, v_,
            None if seq_lens is None else jnp.asarray(seq_lens, jnp.int32),
            None if offsets is None else jnp.asarray(offsets, jnp.int32),
            seed, causal, None, rate, block_q, block_k, True)

    _, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return tuple(np.asarray(x.astype(jnp.float32))
                 for x in vjp((jnp.asarray(g, dtype), jnp.asarray(g_lse))))


def _port_grads(q, k, v, g, g_lse, seq_lens=None, offsets=None, seed=0,
                causal=False, rate=0.0, dtype=torch.float32):
    """torch.autograd through the port's flash_attention_lse (CPU tensors:
    the plain backward): (dq, dk, dv) as float32 numpy arrays; q, k, v and
    g in ``dtype``, the grads checked to come back in it."""
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    out, lse = tfa.flash_attention_lse(
        qt, kt, vt, None if seq_lens is None else torch.as_tensor(seq_lens),
        offsets, seed, causal, None, rate)
    grads = torch.autograd.grad((out, lse), (qt, kt, vt),
                                (torch.from_numpy(g).to(dtype),
                                 torch.from_numpy(g_lse)))
    assert all(x.dtype == dtype for x in grads)
    return tuple(x.float().numpy() for x in grads)


def _assert_match(got, want):
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def _case(B, H, Tq, Tk, D, seed, lse_cotangent=False):
    q = _rand((B, H, Tq, D), seed)
    k, v = _rand((B, H, Tk, D), seed + 1), _rand((B, H, Tk, D), seed + 2)
    g = _rand((B, H, Tq, D), seed + 3)
    g_lse = (_rand((B, H, Tq), seed + 4) if lse_cotangent
             else np.zeros((B, H, Tq), np.float32))
    return q, k, v, g, g_lse


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_backward_matches_interpret_kernels(causal, masked):
    args = _case(3, 2, 64, 64, 16, 0)
    lens = np.array([64, 37, 1], np.int64) if masked else None
    _assert_match(_port_grads(*args, lens, causal=causal),
                  _jax_grads(*args, lens, causal=causal))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_bf16_plain_backward_matches_interpret_kernels(causal, masked):
    """bfloat16 inputs and cotangent, one key tile (block_k = Tk): the plain
    forward and backward round p, p_drop and ds where the Pallas kernels
    cast them (flash_attention.py:163, :320, :383, :392), so dq, dk and dv
    agree within 2 bf16 ulps of the reference value plus 1e-5."""
    B, H, T, D = 2, 2, 64, 32
    q, k, v, g, g_lse = _case(B, H, T, T, D, 100, lse_cotangent=True)
    lens = np.array([64, 37], np.int64) if masked else None
    got = _port_grads(q, k, v, g, g_lse, lens, causal=causal,
                      dtype=torch.bfloat16)
    want = _jax_grads(q, k, v, g, g_lse, lens, causal=causal, block_k=T,
                      dtype=jnp.bfloat16)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert_within_bf16_ulps(a, b, name)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_tq_ne_tk(causal):
    args = _case(2, 2, 32, 64, 16, 10)
    lens = np.array([64, 20], np.int64)
    _assert_match(_port_grads(*args, lens, causal=causal),
                  _jax_grads(*args, lens, causal=causal, block_q=16,
                             block_k=32))


def test_backward_chunked_offsets_with_lse_cotangent():
    """TestChunkedLse's ring-step calls with a cotangent on lse (the merge
    differentiates through it): every (Q chunk, K chunk) pair at global
    offsets [i*t, j*t], including chunks wholly past the causal frontier,
    whose grads are exactly zero."""
    B, H, T, D = 1, 2, 32, 8
    q, k, v, g, g_lse = _case(B, H, T, T, D, 20, lse_cotangent=True)
    t = T // 2
    for i in range(2):
        for j in range(2):
            args = (q[:, :, i * t:(i + 1) * t], k[:, :, j * t:(j + 1) * t],
                    v[:, :, j * t:(j + 1) * t], g[:, :, i * t:(i + 1) * t],
                    g_lse[:, :, i * t:(i + 1) * t])
            got = _port_grads(*args, offsets=(i * t, j * t), causal=True)
            _assert_match(got, _jax_grads(*args, offsets=(i * t, j * t),
                                          causal=True, block_q=8,
                                          block_k=8))
            if j > i:
                assert all((x == 0).all() for x in got)


def test_backward_unaligned_offsets_with_lse_cotangent():
    """K split 8 + 24 under causal: rows 0..7 of the second call are fully
    masked (lse ~= -1e30) and must contribute no gradient, not
    exp(overflow)."""
    B, H, T, D = 1, 2, 32, 8
    q, k, v, g, g_lse = _case(B, H, T, T, D, 30, lse_cotangent=True)
    for lo, hi in ((0, 8), (8, 32)):
        args = (q, k[:, :, lo:hi], v[:, :, lo:hi], g, g_lse)
        got = _port_grads(*args, offsets=(0, lo), causal=True)
        _assert_match(got, _jax_grads(*args, offsets=(0, lo), causal=True,
                                      block_q=16, block_k=8))
        assert np.isfinite(got[0]).all()
    assert (got[0][:, :, :8] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_backward_dropout_same_seed_matches_interpret_kernels(causal):
    """Same int32 seed on both sides: the plain backward re-derives the
    forward kernel's keep mask from (seed, bh, q, k), as both Pallas
    backward kernels do."""
    args = _case(2, 2, 64, 64, 16, 40)
    lens = np.array([64, 40], np.int64)
    got = _port_grads(*args, lens, seed=7, causal=causal, rate=0.1)
    _assert_match(got, _jax_grads(*args, lens, seed=7, causal=causal,
                                  rate=0.1))
    other = _port_grads(*args, lens, seed=8, causal=causal, rate=0.1)
    assert max(np.abs(a - b).max() for a, b in zip(got, other)) > 1e-2


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_autograd_of_plain_forward(causal):
    """At rate 0 the explicit backward formulas equal torch autograd of
    attention_lse_plain, the lse cotangent included."""
    q, k, v, g, g_lse = _case(2, 3, 24, 40, 8, 50, lse_cotangent=True)
    lens = torch.tensor([40, 9])
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = tfa.attention_lse_plain(qt, kt, vt, lens, (3, 0), 0, causal)
    want = torch.autograd.grad((out, lse), (qt, kt, vt),
                               (torch.from_numpy(g), torch.from_numpy(g_lse)))
    got = tfa.attention_bwd_plain(
        qt.detach(), kt.detach(), vt.detach(), out.detach(), lse.detach(),
        torch.from_numpy(g), torch.from_numpy(g_lse), lens, (3, 0), 0,
        causal)
    _assert_match([x.numpy() for x in got], [x.numpy() for x in want])


def test_bf16_plain_backward_casts_like_the_kernels():
    """bfloat16 inputs: the grads come back in bfloat16, within bf16
    rounding of the float32 computation on the same (bf16-exact) values."""
    q, k, v, g, g_lse = _case(1, 2, 32, 32, 16, 60)
    to = [torch.from_numpy(x).bfloat16() for x in (q, k, v, g)]
    out, lse = tfa.attention_lse_plain(*to[:3], causal=True)
    got = tfa.attention_bwd_plain(*to[:3], out, lse, to[3], causal=True)
    assert [x.dtype for x in got] == [torch.bfloat16] * 3
    f32 = tfa.attention_bwd_plain(*(x.float() for x in to[:3]), out.float(),
                                  lse, to[3].float(), causal=True)
    for a, b in zip(got, f32):
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=2e-2,
                                   atol=2e-2)


def test_cpu_backward_launches_nothing_and_wrapper_refuses_cpu():
    q = torch.from_numpy(_rand((1, 1, 8, 4), 70)).requires_grad_()
    before = (tfa.launches_dq, tfa.launches_dkv)
    out, lse = tfa.flash_attention_lse(q, q, q)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert (tfa.launches_dq, tfa.launches_dkv) == before
    d = q.detach()
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_backward_cuda(d, d, d, out.detach(), lse.detach(), d)


def test_backward_composes_with_torch_func():
    """The setup_context form: torch.func.vjp through flash_attention_lse
    gives the autograd grads."""
    q, k, v, g, g_lse = _case(1, 2, 16, 16, 8, 80, lse_cotangent=True)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    _, vjp = torch.func.vjp(
        lambda a, b, c: tfa.flash_attention_lse(a, b, c, causal=True),
        qt, kt, vt)
    got = vjp((torch.from_numpy(g), torch.from_numpy(g_lse)))
    want = _port_grads(q, k, v, g, g_lse, causal=True)
    _assert_match([x.numpy() for x in got], want)


def test_meta_tensors_backward_shapes():
    q = torch.empty((1223, 12, 128, 64), device="meta")
    lse = torch.empty((1223, 12, 128, 1), device="meta")
    dq, dk, dv = tfa.dispatch_attention_bwd(q, q, q, q, lse, q, True)
    assert dq.shape == dk.shape == dv.shape == q.shape
