"""DeepFM (sparse embedding grads, Adam) and word2vec (one table shared
by four lookups, SGD) of the port against the JAX package, on the CPU,
at small sizes, and the lowerings they add (``cast``, ``concat``,
``sigmoid_cross_entropy_with_logits``).

- Both front ends build the same main and startup descs, byte for byte.
- The JAX package runs its startup; its scope is carried into the port
  by name (``convert.load_numpy_state``); both take 3 steps on the same
  batches. Tolerances, float32 on both sides: loss per step rtol 1e-5;
  every persistable after 3 steps within atol of a tenth of the learning
  rate (the largest an update can differ by when a grad element is at
  the rounding noise; the difference seen is about 3e-8).
- Lowerings: rtol 1e-5 / atol 1e-6 on the same random inputs.
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
from paddle_tpu.models import deepfm as j_deepfm
from paddle_tpu.models import word2vec as j_word2vec

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry)
from paddle_tpu_torch.models import deepfm as t_deepfm
from paddle_tpu_torch.models import word2vec as t_word2vec

STEPS = 3
LOSS_RTOL = 1e-5

DEEPFM = dict(batch_size=8, num_features=200, num_fields=4, embed_dim=4,
              lr=1e-2)
WORD2VEC = dict(dict_size=50, embed_dim=8, hidden_size=16, lr=0.1)


def _deepfm_feeds():
    rng = np.random.RandomState(1)
    return [j_deepfm.make_fake_batch(8, DEEPFM["num_features"],
                                     DEEPFM["num_fields"], rng)
            for _ in range(STEPS)]


def _word2vec_feeds():
    rng = np.random.RandomState(2)
    return [j_word2vec.make_fake_batch(8, WORD2VEC["dict_size"], 4, rng)
            for _ in range(STEPS)]


MODELS = {
    "deepfm": (j_deepfm, t_deepfm, DEEPFM, _deepfm_feeds, DEEPFM["lr"]),
    "word2vec": (j_word2vec, t_word2vec, WORD2VEC, _word2vec_feeds,
                 WORD2VEC["lr"]),
}


def _models(name):
    j_mod, t_mod, cfg = MODELS[name][:3]
    with j_unique_name.guard():
        j = j_mod.get_model(**cfg)
    with t_unique_name.guard():
        t = t_mod.get_model(**cfg)
    return j, t


@pytest.mark.parametrize("program", ["main", "startup"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_desc_parity(name, program):
    (j_main, j_startup, _), (t_main, t_startup, _) = _models(name)
    j_prog, t_prog = ((j_main, t_main) if program == "main"
                      else (j_startup, t_startup))
    j_desc = json.loads(j_prog.desc.serialize_to_string())
    t_desc = json.loads(t_prog.desc.serialize_to_string())
    assert t_desc == j_desc
    assert t_prog.desc.serialize_to_string() == \
        j_prog.desc.serialize_to_string()
    if program == "main":
        types = [op["type"] for op in t_desc["blocks"][0]["ops"]]
        assert "lookup_table_grad" in types
        sparse = {op["attrs"]["is_sparse"]
                  for op in t_desc["blocks"][0]["ops"]
                  if op["type"] == "lookup_table_grad"}
        assert sparse == {name == "deepfm"}


@pytest.mark.parametrize("name,run_kw", [
    ("deepfm", {}), ("deepfm", {"remat_segments": 2}), ("word2vec", {})],
    ids=["deepfm", "deepfm_remat", "word2vec"])
def test_three_steps_follow_jax(name, run_kw):
    """3 steps from the JAX package's initial state: DeepFM's sparse
    tables through lazy Adam, word2vec's shared table through the
    ``sum`` of its four dense grads and SGD. Under remat the grads come
    from autograd, dense in both packages."""
    (j_main, j_startup, j_h), (t_main, t_startup, t_h) = _models(name)
    feeds, lr = MODELS[name][3](), MODELS[name][4]
    names = sorted(v.name for v in j_main.list_vars() if v.persistable)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
        state = {n: np.array(scope.get(n)) for n in names}
        want = [float(np.asarray(exe.run(
            j_main, feed=f, fetch_list=[j_h["loss"]],
            **run_kw)[0]).reshape(-1)[0]) for f in feeds]
        j_state = {n: np.array(scope.get(n)) for n in names}
    t_exe, t_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    with tfluid.scope_guard(t_scope):
        got = [float(t_exe.run(t_main, feed=f, fetch_list=[t_h["loss"]],
                               **run_kw)[0].reshape(-1)[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for n in names:
        np.testing.assert_allclose(t_scope.get(n).numpy(), j_state[n],
                                   rtol=0, atol=lr / 10)
    if name == "deepfm":
        # rows no batch touched have zero grads and moments: unchanged
        touched = np.unique(np.concatenate(
            [f["feat_ids"].reshape(-1) for f in feeds]))
        rest = np.setdiff1d(np.arange(DEEPFM["num_features"]), touched)
        for table in ("fm_v", "fm_w1"):
            assert np.array_equal(t_scope.get(table).numpy()[rest],
                                  state[table][rest])


def test_deepfm_predictions_follow_jax():
    """The ``pred`` head (sigmoid of the logit) of a ``for_test`` clone,
    from the same state, equals the JAX package's."""
    (j_main, j_startup, j_h), (t_main, t_startup, t_h) = _models("deepfm")
    feed = _deepfm_feeds()[0]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    names = sorted(v.name for v in j_main.list_vars() if v.persistable)
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
        state = {n: np.array(scope.get(n)) for n in names}
        (want,) = exe.run(j_main.clone(for_test=True),
                          feed={"feat_ids": feed["feat_ids"]},
                          fetch_list=[j_h["pred"]])
    t_exe, t_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    with tfluid.scope_guard(t_scope):
        (got,) = t_exe.run(t_main.clone(for_test=True),
                           feed={"feat_ids": feed["feat_ids"]},
                           fetch_list=[t_h["pred"]])
    assert got.shape == (8, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def _lower_both(op_type, ins, attrs, out_slot="Out"):
    j_ctx = JLowerContext(JOpDesc(op_type, {}, {}, attrs), None)
    t_ctx = TLowerContext(TOpDesc(op_type, {}, {}, attrs), None, "cpu")
    j = JOpRegistry.get(op_type).lower(
        j_ctx, {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        attrs)[out_slot]
    t = TOpRegistry.get(op_type).lower(
        t_ctx, {k: [torch.from_numpy(v) for v in vs]
                for k, vs in ins.items()}, attrs)[out_slot]
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _f(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


OP_CASES = [
    ("cast_int64_to_float32", "cast",
     {"X": [np.array([[0], [1], [5]], np.int64)]},
     {"in_dtype": 3, "out_dtype": 5}),
    ("cast_float32_to_int32", "cast", {"X": [_f((3, 2), 0) * 4]},
     {"in_dtype": 5, "out_dtype": 2}),
    ("concat_axis1", "concat", {"X": [_f((2, 3), 1), _f((2, 5), 2)]},
     {"axis": 1}),
    ("concat_axis0", "concat", {"X": [_f((1, 3), 3), _f((2, 3), 4),
                                      _f((3, 3), 5)]}, {"axis": 0}),
    ("sigmoid_ce", "sigmoid_cross_entropy_with_logits",
     {"X": [_f((6, 1), 6) * 3],
      "Label": [np.array([[0], [1], [1], [0], [1], [0]], np.float32)]}, {}),
    ("sigmoid_ce_ignore_normalize", "sigmoid_cross_entropy_with_logits",
     {"X": [_f((3, 2), 7)],
      "Label": [np.array([[0, 1], [-100, 1], [1, -100]], np.float32)]},
     {"ignore_index": -100, "normalize": True}),
]


# the lowerings this file holds against the JAX package's
# (tests/test_torch_ops.py checks every ported lowering has a case)
SLICE_OPS = {c[1] for c in OP_CASES}


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_lowering_matches_jax(case):
    _, op_type, ins, attrs = case
    (j,), (t,) = _lower_both(op_type, ins, attrs)
    assert t.shape == j.shape
    assert np.dtype(t.dtype).kind == np.dtype(j.dtype).kind
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_sigmoid_ce_grad_matches_jax():
    """The generic vjp grad of the loss against the JAX package's."""
    import jax

    x = _f((5, 1), 8) * 3
    label = np.array([[0], [1], [1], [0], [1]], np.float32)
    attrs = {"ignore_index": -100, "normalize": False}
    j_ctx = JLowerContext(JOpDesc("sigmoid_cross_entropy_with_logits", {},
                                  {}, attrs), None)
    j_info = JOpRegistry.get("sigmoid_cross_entropy_with_logits")
    j_grad = jax.grad(lambda v: j_info.lower(
        j_ctx, {"X": [v], "Label": [jnp.asarray(label)]},
        attrs)["Out"][0].sum())(jnp.asarray(x))
    t_info = TOpRegistry.get("sigmoid_cross_entropy_with_logits")
    xt = torch.from_numpy(x).requires_grad_()
    t_ctx = TLowerContext(TOpDesc("sigmoid_cross_entropy_with_logits", {},
                                  {}, attrs), None, "cpu")
    t_info.lower(t_ctx, {"X": [xt], "Label": [torch.from_numpy(label)]},
                 attrs)["Out"][0].sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_grad),
                               rtol=1e-5, atol=1e-6)
