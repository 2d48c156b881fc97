"""The Transformer NMT encoder-decoder of the port against the JAX
package, on the CPU, at a small size (2+2 layers, d_model 32, 2 heads,
d_inner 64, vocab 50, seq 16, batch 2, ragged source and target
lengths), and the lowerings it adds (``one_hot``, ``label_smooth``,
``assign_value``).

- Both front ends build the same main and startup descs, byte for byte:
  the startup holds the positional table as ``assign_value``'s
  ``fp32_values``, so the floats must print alike.
- The JAX package runs its startup; its scope is carried into the port
  by name; both take 3 Adam steps at dropout 0 (each package draws its
  dropout masks from its own RNG). The JAX package's attention is its
  plain composition; the port's the plain version of the flash kernels
  (encoder self-attention, causal decoder self-attention, and decoder
  queries over the encoder's keys). Tolerances, float32 on both sides:
  loss per step rtol 1e-5; every persistable after 3 steps within atol
  1e-4, a tenth of the learning rate 1e-3 that sizes each Adam step (the
  largest difference seen is 2.3e-6).
- Lowerings: exact for ``one_hot`` and ``assign_value``, rtol 1e-6 for
  ``label_smooth``.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import (LowerContext as JLowerContext,
                                      OpRegistry as JOpRegistry)
from paddle_tpu.models import transformer as j_transformer

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry)
from paddle_tpu_torch.models import transformer as t_transformer

CFG = dict(batch_size=2, seq_len=16, vocab_size=50, d_model=32, n_heads=2,
           d_inner=64, n_layers=2, lr=1e-3)
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4


def _models(dropout):
    with j_unique_name.guard():
        j = j_transformer.get_model(dropout=dropout, **CFG)
    with t_unique_name.guard():
        t = t_transformer.get_model(dropout=dropout, **CFG)
    return j, t


@pytest.mark.parametrize("program", ["main", "startup"])
def test_desc_parity(program):
    """At the model's default dropout 0.1 and label smoothing 0.1."""
    (j_main, j_startup, _), (t_main, t_startup, _) = _models(0.1)
    j_prog, t_prog = ((j_main, t_main) if program == "main"
                      else (j_startup, t_startup))
    j_desc = json.loads(j_prog.desc.serialize_to_string())
    t_desc = json.loads(t_prog.desc.serialize_to_string())
    types = [op["type"] for op in t_desc["blocks"][0]["ops"]]
    if program == "main":
        attn = [op for op in t_desc["blocks"][0]["ops"]
                if op["type"] == "fused_attention"]
        # per layer: encoder self, decoder causal self, decoder cross
        assert [op["attrs"]["causal"] for op in attn] == \
            [False] * 2 + [True, False] * 2
        assert types.count("fused_attention_grad") == 6
        for op_type in ("one_hot", "label_smooth", "adam"):
            assert op_type in types
    else:
        assert types.count("assign_value") == 2
    assert t_desc == j_desc
    assert t_prog.desc.serialize_to_string() == \
        j_prog.desc.serialize_to_string()


def test_positional_table_matches_jax():
    np.testing.assert_array_equal(
        t_transformer.positional_encoding_table(256, 512),
        j_transformer.positional_encoding_table(256, 512))


@pytest.mark.parametrize("varlen", [True, False], ids=["ragged", "full"])
def test_three_steps_follow_jax(varlen):
    (j_main, j_startup, j_h), (t_main, _, t_h) = _models(0.0)
    feeds = [j_transformer.make_fake_batch(
        CFG["batch_size"], CFG["seq_len"], CFG["vocab_size"],
        rng=np.random.RandomState(s), varlen=varlen) for s in range(STEPS)]
    names = sorted(v.name for v in j_main.list_vars() if v.persistable)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
        state = {n: np.array(scope.get(n)) for n in names}
        want = [float(np.asarray(exe.run(
            j_main, feed=f, fetch_list=[j_h["loss"]])[0]).reshape(-1)[0])
            for f in feeds]
        j_state = {n: np.array(scope.get(n)) for n in names}
    t_exe, t_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    with tfluid.scope_guard(t_scope):
        got = [float(t_exe.run(t_main, feed=f, fetch_list=[
            t_h["loss"]])[0].reshape(-1)[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for n in names:
        np.testing.assert_allclose(t_scope.get(n).numpy(), j_state[n],
                                   rtol=0, atol=PARAM_ATOL)
    # the positional tables are not trainable: unchanged
    for n in ("src_pos_emb", "trg_pos_emb"):
        assert np.array_equal(t_scope.get(n).numpy(), state[n])


def test_unfused_attention_raises_naming_the_roadmap():
    """The unfused composition builds (the reference's desc; the
    fuse-attention pass runs it on the kernels, test_torch_transforms.py);
    what still raises, naming its ROADMAP item, is the sequence-parallel
    ring attention."""
    with j_unique_name.guard():
        j = j_transformer.get_model(use_fused_attention=False, **CFG)
    with t_unique_name.guard():
        t = t_transformer.get_model(use_fused_attention=False, **CFG)
    assert t[0].desc.serialize_to_string() == \
        j[0].desc.serialize_to_string()
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        q = tfluid.layers.data(name="q", shape=[4, 8], dtype="float32")
        with pytest.raises(NotImplementedError, match="item 10"):
            t_transformer.multi_head_attention(q, q, q, 8, 2, 0.0,
                                               sequence_parallel=True)


def _lower_both(op_type, ins, attrs):
    j_ctx = JLowerContext(JOpDesc(op_type, {}, {}, attrs), None)
    t_ctx = TLowerContext(TOpDesc(op_type, {}, {}, attrs), None, "cpu")
    (j,) = JOpRegistry.get(op_type).lower(
        j_ctx, {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        attrs)["Out"]
    (t,) = TOpRegistry.get(op_type).lower(
        t_ctx, {k: [torch.from_numpy(v) for v in vs]
                for k, vs in ins.items()}, attrs)["Out"]
    return np.asarray(j), t.numpy()


OP_CASES = [
    ("one_hot_column", "one_hot",
     {"X": [np.array([[3], [0], [4], [3]], np.int64)]}, {"depth": 5}),
    ("one_hot_out_of_range", "one_hot",
     {"X": [np.array([[7], [-1], [2]], np.int64)]}, {"depth": 5}),
    ("one_hot_2d_ids", "one_hot",
     {"X": [np.array([[1, 2], [0, 4]], np.int64)]}, {"depth": 6}),
    ("label_smooth", "label_smooth",
     {"X": [np.eye(6, dtype=np.float32)[[1, 5, 0]]]}, {"epsilon": 0.1}),
    ("assign_value_fp32", "assign_value", {},
     {"shape": [2, 3], "dtype": 5,
      "fp32_values": [0.5, -1.25, 3.0, 1e-7, 2.5e8, -0.0]}),
    ("assign_value_int32", "assign_value", {},
     {"shape": [4], "dtype": 2, "int32_values": [1, -2, 3, 4]}),
]


# the lowerings this file holds against the JAX package's
# (tests/test_torch_ops.py checks every ported lowering has a case)
SLICE_OPS = {c[1] for c in OP_CASES}


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_lowering_matches_jax(case):
    _, op_type, ins, attrs = case
    j, t = _lower_both(op_type, ins, attrs)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
