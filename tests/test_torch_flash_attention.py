"""The port's flash-attention forward (paddle_tpu_torch/kernels/
flash_attention.py) against the JAX package's Pallas kernel, run in
interpret mode on the CPU as tests/test_flash_attention.py runs it.

On the CPU the port's entry points take the kernel's plain torch version
(the CUDA kernel itself is checked against that plain version on the card
by chip_smoke.py). Inputs come from numpy with a seed and go through both.
Tolerance: float32, 1e-5 — the Pallas kernel accumulates tile by tile with
a running max, the plain version in one reduction; the difference is
float32 rounding only.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu_torch.kernels.flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

RTOL, ATOL = 1e-5, 1e-5


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_lse(q, k, v, seq_lens=None, offsets=None, seed=0, causal=False,
             rate=0.0, block_q=16, block_k=16, dtype=jnp.float32):
    """The Pallas kernel in interpret mode: (out, lse [B, H, Tq])."""
    out, lse = jfa.flash_attention_lse(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        None if seq_lens is None else jnp.asarray(seq_lens, jnp.int32),
        None if offsets is None else jnp.asarray(offsets, jnp.int32),
        seed, causal, None, rate, block_q, block_k, True)
    return np.asarray(out), np.asarray(lse)


def _port_lse(q, k, v, seq_lens=None, offsets=None, seed=0, causal=False,
              rate=0.0, dtype=torch.float32):
    out, lse = tfa.flash_attention_lse(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
        None if seq_lens is None else torch.as_tensor(seq_lens),
        offsets, seed, causal, None, rate)
    assert out.dtype == dtype
    return out.float().numpy(), lse.numpy()


def _assert_match(got, want):
    for g, w, name in zip(got, want, ("out", "lse")):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


def bf16_ulp(x):
    """One bfloat16 ulp of each value of x (8 significant bits)."""
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_within_bf16_ulps(got, want, name, ulps=2, atol=1e-5):
    """|got - want| <= ulps bf16 ulps of want, plus atol, element by
    element, reporting how many elements fail."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bad = np.abs(got - want) > ulps * bf16_ulp(want) + atol
    assert not bad.any(), "%s: %d of %d beyond %d bf16 ulps + %g" % (
        name, bad.sum(), bad.size, ulps, atol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_interpret_kernel(causal, masked):
    B, H, T, D = 3, 2, 64, 16
    q, k, v = (_rand((B, H, T, D), s) for s in (0, 1, 2))
    lens = np.array([64, 37, 1], np.int64) if masked else None
    _assert_match(_port_lse(q, k, v, lens, causal=causal),
                  _jax_lse(q, k, v, lens, causal=causal))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_bf16_plain_matches_interpret_kernel_one_key_tile(causal, masked):
    """bfloat16 inputs, one key tile (block_k = Tk), so the kernel's running
    max is the row max: the Pallas kernel rounds p to v's dtype before P.V
    (flash_attention.py:163) and the plain version must round the same
    values. Within 2 bf16 ulps of the reference value plus 1e-5 (without
    the rounding, hundreds of the 8192 outputs fall outside); lse (float32
    in both) within 1e-5."""
    B, H, T, D = 2, 2, 64, 32
    q, k, v = (_rand((B, H, T, D), s) for s in (90, 91, 92))
    lens = np.array([64, 37], np.int64) if masked else None
    got = _port_lse(q, k, v, lens, causal=causal, dtype=torch.bfloat16)
    want = _jax_lse(q, k, v, lens, causal=causal, block_k=T,
                    dtype=jnp.bfloat16)
    assert_within_bf16_ulps(got[0], want[0], "out")
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_tq_ne_tk(causal):
    B, H, Tq, Tk, D = 2, 2, 32, 64, 16
    q = _rand((B, H, Tq, D), 3)
    k, v = _rand((B, H, Tk, D), 4), _rand((B, H, Tk, D), 5)
    lens = np.array([64, 20], np.int64)
    _assert_match(_port_lse(q, k, v, lens, causal=causal),
                  _jax_lse(q, k, v, lens, causal=causal, block_q=16,
                           block_k=32))


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_offsets(causal):
    """TestChunkedLse's ring-step calls: each (Q chunk, K chunk) pair at
    global offsets [i*t, j*t], including chunks wholly past the causal
    frontier (out = 0, lse ~= -1e30)."""
    B, H, T, D = 2, 2, 64, 16
    q, k, v = (_rand((B, H, T, D), s) for s in (6, 7, 8))
    t = T // 4
    for i in range(4):
        for j in range(4):
            args = (q[:, :, i * t:(i + 1) * t], k[:, :, j * t:(j + 1) * t],
                    v[:, :, j * t:(j + 1) * t])
            off = (i * t, j * t)
            got = _port_lse(*args, offsets=off, causal=causal)
            want = _jax_lse(*args, offsets=off, causal=causal)
            _assert_match(got, want)
            if causal and j > i:
                assert (got[0] == 0).all() and (got[1] < -1e29).all()


def test_unaligned_offsets():
    """TestChunkedLse.test_unaligned_chunks_match_full: K split 8 + 24, so
    rows 0..7 of the second call are fully masked under causal."""
    B, H, T, D = 1, 2, 32, 8
    q, k, v = (_rand((B, H, T, D), s) for s in (12, 13, 14))
    for lo, hi in ((0, 8), (8, 32)):
        args = (q, k[:, :, lo:hi], v[:, :, lo:hi])
        got = _port_lse(*args, offsets=(0, lo), causal=True)
        _assert_match(got, _jax_lse(*args, offsets=(0, lo), causal=True,
                                    block_q=16, block_k=8))
    assert (got[0][:, :, :8] == 0).all()
    assert (got[1][:, :, :8] < -1e29).all()


def test_raw_lse_layout_matches_op_form():
    """The op saves Lse as [B, H, Tq, 1] (flash_attention_raw_lse)."""
    B, H, T, D = 2, 2, 32, 16
    q, k, v = (_rand((B, H, T, D), s) for s in (20, 21, 22))
    lens = np.array([32, 9], np.int64)
    j_out, j_lse = jfa.flash_attention_raw_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lens, jnp.int32), 0, False, D ** -0.5, 0.0, 16, 16,
        True)
    t_out, t_lse = tfa.dispatch_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        False, None, torch.from_numpy(lens))
    assert tuple(t_lse.shape) == tuple(j_lse.shape) == (B, H, T, 1)
    _assert_match((t_out.numpy(), t_lse.numpy()),
                  (np.asarray(j_out), np.asarray(j_lse)))


def test_keep_mask_bit_exact():
    """The port's hash reproduces _keep_mask bit for bit over a grid of
    (bh, q, k) coordinates, seeds (including negative int32 ones) and
    rates."""
    t_k = 97
    q_pos = np.arange(0, 130, 3, dtype=np.int32).reshape(-1, 1)
    k_pos = np.arange(t_k, dtype=np.int32).reshape(1, -1)
    for seed in (0, 7, 2 ** 31 - 1, -5):
        for bh in (0, 1, 13, 4095):
            for rate in (0.1, 0.5, 0.9):
                want = np.asarray(jfa._keep_mask(
                    jnp.int32(seed), jnp.int32(bh), jnp.asarray(q_pos),
                    jnp.asarray(k_pos), t_k, rate))
                got = tfa.keep_mask(seed, torch.tensor(bh),
                                    torch.from_numpy(q_pos).long(),
                                    torch.from_numpy(k_pos).long(), t_k,
                                    rate).numpy()
                np.testing.assert_array_equal(got, want)


def test_generic_dropout_hash_bit_exact():
    """hash_keep_mask (the generic dropout op's mask) from the same uint32
    seed the reference draws from its key."""
    import jax

    from paddle_tpu.ops.common import hash_keep_mask as j_mask
    from paddle_tpu_torch.ops.common import hash_keep_mask as t_mask

    for i, shape in enumerate(((4, 33), (2, 3, 17), (1000,))):
        key = jax.random.PRNGKey(i)
        seed = int(np.asarray(jax.random.bits(key, dtype=jnp.uint32)))
        want = np.asarray(j_mask(key, shape, 0.3))
        got = t_mask(seed, shape, 0.3, "cpu").numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_same_seed_matches_interpret_kernel(causal):
    B, H, T, D = 2, 2, 64, 16
    q, k, v = (_rand((B, H, T, D), s) for s in (30, 31, 32))
    lens = np.array([64, 40], np.int64)
    got = _port_lse(q, k, v, lens, seed=7, causal=causal, rate=0.1)
    _assert_match(got, _jax_lse(q, k, v, lens, seed=7, causal=causal,
                                rate=0.1))
    other = _port_lse(q, k, v, lens, seed=8, causal=causal, rate=0.1)
    assert np.abs(other[0] - got[0]).max() > 1e-3


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor goes to the plain version and launches nothing; the
    kernel wrapper refuses anything that is not a CUDA tensor."""
    q = torch.from_numpy(_rand((1, 1, 8, 4), 40))
    before = tfa.launches
    tfa.flash_attention_lse(q, q, q)
    assert tfa.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_forward_cuda(q, q, q)


def test_meta_tensors_infer_shapes_without_launching():
    q = torch.empty((1223, 12, 128, 64), device="meta")
    out, lse = tfa.dispatch_attention_lse(q, q, q, True)
    assert out.shape == q.shape and lse.shape == (1223, 12, 128, 1)
    assert lse.dtype == torch.float32
