"""The port's mesh path over four ranks on the CPU over gloo: dp=2 x tp=2
with the Megatron MLP rules (tests/test_parallel_spmd.py
``test_dp_tp_training_matches_single_device``), ZeRO-1 on top of them,
and ring attention at sp=4, against the JAX package's runs on its 8
virtual devices. One world of four spawned ranks runs every case
(tests/torch_mesh_worker.py).

Tolerances as in test_torch_parallel_dp.py: losses rtol 1e-5; state
|d| <= 1e-5 * max|want| + 1e-3, against the reference's runs and the
port's own without a mesh: a tenth of Adam's learning rate 0.01, which
sizes each step (test_torch_bert_training.py's rule), since Adam moves
an element whose grad is near rounding noise by a different fraction of
it (the largest seen, 1.2e-4, on 1 of the first fc's 100352 weights
after 3 steps: tp splits that weight's grad sum across two ranks);
ring attention:
output 2e-5 + 2e-4 * |want|, grads 2e-4 + 2e-3 * |want|.
"""

import numpy as np
import pytest

from paddle_tpu import parallel as j_parallel

import torch_mesh_reference as ref
import torch_mesh_worker as worker

WORLD = 4
AXES = {"dp": 2, "tp": 2}
LOSS_RTOL = 1e-5
STATE_REL, STATE_ABS, REF_ABS = 1e-5, 1e-3, 1e-3
W0, W1 = "fc_0.w_0_0", "fc_1.w_0_0"
# column-parallel first fc, row-parallel second (Megatron)
RULES = [(r"fc_0\.w_0", (None, "tp")), (r"fc_1\.w_0", ("tp", None))]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    state = ref.startup_state(*ref.MLP)
    batches = ref.mlp_batches(3, seed=4)
    rng = np.random.RandomState(6)
    q, k, v, g = (rng.randn(1, 2, 32, 8).astype(np.float32)
                  for _ in range(4))
    kind, kw = ref.MLP
    common = dict(kind=kind, model_kw=kw, state=state, batches=batches)
    cases = {
        "plain": ("train_case", dict(common, mode="plain")),
        "tp": ("train_case", dict(common, mode="compiled", axes=AXES,
                                  rules=RULES)),
        "zero_tp": ("counters_case", dict(
            common, axes=AXES, rules=RULES,
            flag_values={"zero": True, "grad_bucket_mb": 0.01})),
        "ring": ("ring_case", dict(q=q, k=k, v=v, g=g)),
    }
    out = worker.run_world(WORLD, cases, tmp_path_factory.mktemp("w4"))
    return (state, batches, (q, k, v, g)), out


def test_dp_tp_training_matches_single_device(world):
    """``CompiledProgram.with_spmd`` over dp=2 x tp=2 with the Megatron
    rules reproduces the single-device trajectory, the reference's
    dp x tp run and the port's run without a mesh."""
    (state, batches, _), out = world
    got = out[0]["tp"]
    want_tp = ref.train(*ref.MLP, state, batches, axes=AXES, rules=RULES)
    want_one = ref.train(*ref.MLP, state, batches)
    for want in (want_tp, want_one):
        np.testing.assert_allclose(ref.losses(got), ref.losses(want),
                                   rtol=LOSS_RTOL)
        ref.assert_state_close(got["state"], want["state"], STATE_REL,
                               REF_ABS)
    ref.assert_state_close(got["state"], out[0]["plain"]["state"],
                           STATE_REL, STATE_ABS)
    for r in range(1, WORLD):
        np.testing.assert_array_equal(ref.losses(out[r]["tp"]),
                                      ref.losses(got))


def test_sharded_state_stays_sharded(world):
    """The rule-sharded weights (and the Adam moments the rules match) stay
    split on tp between steps: each rank holds half the columns of the
    first fc and half the rows of the second."""
    _, out = world
    for r in range(WORLD):
        got = out[r]["tp"]
        assert got["placements"][W0] == "(Replicate(), Shard(dim=1))"
        assert got["local_shapes"][W0] == (784, 64)
        assert got["placements"][W1] == "(Replicate(), Shard(dim=0))"
        assert got["local_shapes"][W1] == (64, 64)
        assert got["local_shapes"][W0 + "_moment1_0"] == (784, 64)
        assert got["placements"]["fc_2.w_0_0"] == \
            "(Replicate(), Replicate())"


def test_zero1_over_tp_rules(world):
    """ZeRO-1 extends each rule's spec with the data axis on its first
    free dim (``zero1_extend_spec``): the first fc's moments split rows
    on dp and columns on tp; the trajectory is the replicated one's."""
    (state, batches, _), out = world
    got = out[0]["zero_tp"]
    want = ref.train(*ref.MLP, state, batches, axes=AXES, rules=RULES,
                     zero=True)
    np.testing.assert_allclose(ref.losses(got), ref.losses(want),
                               rtol=LOSS_RTOL)
    ref.assert_state_close(got["state"], want["state"], STATE_REL, REF_ABS)
    ref.assert_state_close(got["state"], out[0]["tp"]["state"], STATE_REL,
                           STATE_ABS)
    m1 = W0 + "_moment1_0"
    assert got["placements"][m1] == "(Shard(dim=0), Shard(dim=1))"
    assert got["local_shapes"][m1] == (392, 64)
    assert got["placements"][W0] == "(Replicate(), Shard(dim=1))"
    assert got["counters"]["engine.grad_buckets"] > 0


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_sp4_matches_reference(world, causal):
    import jax
    import jax.numpy as jnp

    (_, _, (q, k, v, g)), out = world
    mesh = j_parallel.make_mesh({"sp": WORLD})

    def ring(q_, k_, v_):
        return j_parallel.ring_attention(q_, k_, v_, mesh=mesh,
                                         causal=causal)

    want_out, vjp = jax.vjp(ring, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v))
    want = [want_out] + list(vjp(jnp.asarray(g)))
    got = out[0]["ring"][causal]
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=2e-5,
                               rtol=2e-4)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=2e-3)
    full = j_parallel.reference_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(got[0], np.asarray(full), atol=2e-5,
                               rtol=2e-4)
