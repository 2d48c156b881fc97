"""The port's training slice against the JAX package, on the CPU, for a
tiny BERT (2 layers, d_model 64, 2 heads, d_inner 128, seq 32, vocab 100,
Adam) and for the MNIST MLP of the verify skill.

- Both front ends build the same main and startup descs, with the backward
  and Adam ops, byte for byte.
- The JAX package runs its startup; its whole scope (parameters, Adam's
  moments and beta powers, the learning rate) is carried into the port by
  name with ``convert.load_numpy_state``. Both then take 3 Adam steps at
  dropout 0 on the same batch: full length, and ragged lengths from
  ``make_fake_batch(varlen=True)``. The JAX side runs at opt level 0 with
  its Pallas flash kernels forced (interpret mode), so its
  ``fused_attention_grad`` runs the two Pallas backward kernels; the
  port's runs their plain version (the CPU path of the same op).

Tolerances, float32 on both sides, the same formulas summed in other
orders (matmuls, reductions, the attention tiles):
- loss per step: rtol 1e-5;
- step-1 parameter grads: |d| <= 1e-4 * max|grad| of that parameter +
  1e-7 (the grads of the 2x2 NSP head and the 100-wide MLM head differ in
  scale by orders of magnitude, so each is held to its own);
- parameters after 3 steps: atol 1e-5, a tenth of the learning rate 1e-4
  that sizes each Adam step. Adam divides each element's m by its own
  sqrt(v), so an element whose grad is near the grads' rounding noise on
  both sides steps by a different fraction of the learning rate; the
  largest such difference seen was 2.9e-6 (ragged batch), the rest agree
  to float32 rounding.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.models import bert as j_bert

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.models import bert as t_bert

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

CFG = dict(batch_size=2, seq_len=32, vocab_size=100, d_model=64, n_layers=2,
           n_heads=2, d_inner=128, max_position=64, is_train=True)
GRAD_PARAMS = ("word_embedding", "pos_embedding", "fc_0.w_0_0",
               "layer_norm_0.w_0_0", "fc_4.w_0_0", "fc_11.w_0_0",
               "fc_12.b_0_0", "fc_15.w_0_0")
STEPS = 3
LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-4, 1e-7
PARAM_ATOL = 1e-5


@pytest.fixture
def forced_flash(monkeypatch):
    """Route the JAX package's attention dispatch, forward and backward,
    to its Pallas kernels in interpret mode (as in
    test_torch_bert_serving.py); counts the dispatches."""
    calls = []
    monkeypatch.setattr(jfa, "flash_dispatch_ok",
                        lambda tq, tk: calls.append((tq, tk)) or True)
    return calls


def _models(dropout):
    with j_unique_name.guard():
        j = j_bert.get_model(dropout=dropout, **CFG)
    with t_unique_name.guard():
        t = t_bert.get_model(dropout=dropout, **CFG)
    return j, t


@pytest.mark.parametrize("program", ["main", "startup"])
def test_train_desc_parity(program):
    """At the model's default dropout 0.1: forward, backward (with the
    ``sum`` dedup, ``fused_attention_grad`` and the ``@EMPTY@`` slots) and
    Adam, identical in both packages."""
    (j_main, j_startup, _), (t_main, t_startup, _) = _models(0.1)
    j_prog, t_prog = ((j_main, t_main) if program == "main"
                      else (j_startup, t_startup))
    j_desc = json.loads(j_prog.desc.serialize_to_string())
    t_desc = json.loads(t_prog.desc.serialize_to_string())
    types = [op["type"] for op in t_desc["blocks"][0]["ops"]]
    assert types == [op["type"] for op in j_desc["blocks"][0]["ops"]]
    if program == "main":
        for op_type in ("fused_attention_grad", "adam", "sum"):
            assert op_type in types
    assert t_desc == j_desc
    assert t_prog.desc.serialize_to_string() == \
        j_prog.desc.serialize_to_string()


def test_clone_for_test_prunes_backward_and_optimize():
    (_, _, _), (t_main, _, _) = _models(0.1)
    infer = t_main.clone(for_test=True)
    types = [op.type for op in infer.desc.global_block().ops]
    assert not any(t.endswith("_grad") for t in types)
    assert "adam" not in types and "sum" not in types
    assert all(op.attrs["is_test"] for op in infer.desc.global_block().ops
               if op.type == "dropout")


def _jax_run(varlen):
    """The JAX package's startup and STEPS Adam steps: (initial state,
    losses, step-1 grads, final params)."""
    main, startup, handles = _models(0.0)[0]
    feed = j_bert.make_fake_batch(2, CFG["seq_len"], CFG["vocab_size"],
                                  rng=np.random.RandomState(5),
                                  varlen=varlen)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    fetch = [handles["loss"]] + [p + "@GRAD" for p in GRAD_PARAMS]
    losses, grads = [], None
    with jfluid.scope_guard(scope):
        exe.run(startup)
        state = {n: np.array(scope.get(n)) for n in names}
        for _ in range(STEPS):
            out = exe.run(main, feed=feed, fetch_list=fetch, opt_level=0)
            losses.append(float(np.asarray(out[0]).reshape(())))
            grads = grads or [np.asarray(g) for g in out[1:]]
        params = {n: np.array(scope.get(n)) for n in names}
    return feed, state, losses, grads, params


def _port_run(feed, state):
    main, _, handles = _models(0.0)[1]
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, state, "cpu", program=main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    fetch = [handles["loss"]] + [p + "@GRAD" for p in GRAD_PARAMS]
    losses, grads = [], None
    with tfluid.scope_guard(scope):
        for _ in range(STEPS):
            out = exe.run(main, feed=feed, fetch_list=fetch)
            losses.append(float(out[0].reshape(())))
            grads = grads or out[1:]
    params = {n: scope.get(n).numpy() for n in state}
    return losses, grads, params


@pytest.mark.parametrize("varlen", [False, True], ids=["full", "varlen"])
def test_three_adam_steps_match_jax(forced_flash, varlen):
    feed, state, j_losses, j_grads, j_params = _jax_run(varlen)
    # the forward and the grad op of every layer took the kernel path
    assert len(forced_flash) >= CFG["n_layers"] * 2
    t_losses, t_grads, t_params = _port_run(feed, state)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    assert t_losses[-1] < t_losses[0]
    for name, g, w in zip(GRAD_PARAMS, t_grads, j_grads):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_REL * np.abs(w).max() + GRAD_ATOL,
            err_msg=name)
    assert sorted(t_params) == sorted(j_params)
    for name in j_params:
        np.testing.assert_allclose(t_params[name], j_params[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    # the Adam state moved: beta powers advanced once per step
    b1 = [n for n in j_params if n.endswith("beta1_pow_acc_0")][0]
    np.testing.assert_allclose(t_params[b1], 0.9 ** (STEPS + 1), rtol=1e-6)


def test_load_numpy_state_carries_training_state():
    """Every persistable var of the training program, Adam's accumulators
    and the learning rate included, carries across by name."""
    (j_main, j_startup, _), (t_main, _, _) = _models(0.0)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
    state = {v.name: np.array(scope.get(v.name)) for v in j_main.list_vars()
             if v.persistable}
    for kind in ("_moment1_", "_moment2_", "_beta1_pow_acc_",
                 "_beta2_pow_acc_", "learning_rate_"):
        assert any(kind in n for n in state), kind
    t_scope = tfluid.Scope()
    names = convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    assert names == sorted(state)
    for n in names:
        np.testing.assert_array_equal(t_scope.get(n).numpy(), state[n])


OPTIMIZERS = {
    "adam": lambda fluid: fluid.optimizer.Adam(learning_rate=1e-2),
    "sgd_l2_decay": lambda fluid: fluid.optimizer.SGD(
        learning_rate=0.1,
        regularization=fluid.regularizer.L2Decay(1e-3)),
    "momentum_nesterov": lambda fluid: fluid.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9, use_nesterov=True),
}


def _mlp(fluid, unique_name, optimizer="adam"):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[784], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        hidden = fluid.layers.fc(input=img, size=128, act="relu")
        pred = fluid.layers.fc(input=hidden, size=10)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits=pred, label=label))
        acc = fluid.layers.accuracy(input=fluid.layers.softmax(pred),
                                    label=label)
        OPTIMIZERS[optimizer](fluid).minimize(loss)
    return main, startup, (loss, acc)


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_mnist_mlp_five_steps_match_jax(optimizer):
    """The verify skill's MLP: fc + relu, softmax_with_cross_entropy, mean
    and Adam at lr 1e-2 (and SGD with L2 decay, Nesterov momentum), with
    its eval ops (softmax, top_k, accuracy); the same desc, the loss over
    5 steps within rtol 1e-5 and the accuracy equal."""
    j_main, j_startup, j_fetch = _mlp(jfluid, j_unique_name, optimizer)
    t_main, _, t_fetch = _mlp(tfluid, t_unique_name, optimizer)
    assert t_main.desc.serialize_to_string() == \
        j_main.desc.serialize_to_string()
    rng = np.random.RandomState(0)
    w = rng.randn(784, 10).astype(np.float32)
    feeds = []
    for _ in range(5):
        x = rng.randn(64, 784).astype(np.float32)
        feeds.append({"img": x, "label": np.argmax(x @ w, 1).astype(
            np.int64).reshape(-1, 1)})
    j_exe, j_scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(j_scope):
        j_exe.run(j_startup)
        state = {v.name: np.array(j_scope.get(v.name))
                 for v in j_main.list_vars() if v.persistable}
        want = [[float(np.asarray(v).reshape(-1)[0])
                 for v in j_exe.run(j_main, feed=f, fetch_list=j_fetch)]
                for f in feeds]
    t_exe, t_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    with tfluid.scope_guard(t_scope):
        got = [[float(np.asarray(v).reshape(-1)[0])
                for v in t_exe.run(t_main, feed=f, fetch_list=t_fetch)]
               for f in feeds]
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-5)
    assert [g[1] for g in got] == [w[1] for w in want]
    assert got[-1][0] < got[0][0]


def test_l1_decay_step_matches_jax():
    """L1 decay appends ``sign`` (and ``scale``, ``sum``): three SGD steps
    with ``L1Decay(1e-2)`` from the JAX package's startup state match it
    (losses rtol 1e-5, weights atol 1e-6)."""
    def build(fl, un):
        main, startup = fl.Program(), fl.Program()
        with un.guard(), fl.program_guard(main, startup):
            x = fl.layers.data(name="x", shape=[3], dtype="float32")
            loss = fl.layers.mean(fl.layers.fc(input=x, size=2))
            fl.optimizer.SGD(
                learning_rate=0.1,
                regularization=fl.regularizer.L1Decay(1e-2)).minimize(loss)
        return main, startup, loss

    j_main, j_startup, j_loss = build(jfluid, j_unique_name)
    t_main, _, t_loss = build(tfluid, t_unique_name)
    assert (json.loads(t_main.desc.serialize_to_string())
            == json.loads(j_main.desc.serialize_to_string()))
    assert "sign" in [op.type for op in t_main.desc.global_block().ops]
    feeds = [{"x": np.random.RandomState(s).randn(4, 3).astype(np.float32)}
             for s in range(3)]
    j_exe, j_scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(j_scope):
        j_exe.run(j_startup)
        names = [v.name for v in j_main.list_vars() if v.persistable]
        state = {n: np.array(j_scope.get(n)) for n in names}
        want = [float(np.asarray(j_exe.run(
            j_main, feed=f, fetch_list=[j_loss])[0]).reshape(-1)[0])
            for f in feeds]
        j_state = {n: np.array(j_scope.get(n)) for n in names}
    t_exe, t_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    with tfluid.scope_guard(t_scope):
        got = [float(t_exe.run(t_main, feed=f,
                               fetch_list=[t_loss])[0].reshape(-1)[0])
               for f in feeds]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(t_scope.get(n).numpy(), j_state[n],
                                   rtol=0, atol=1e-6)


def test_unported_training_ops_raise():
    """A sparse embedding grad raises NotImplementedError naming the
    ROADMAP item."""
    from paddle_tpu_torch.core.desc import OpDesc
    from paddle_tpu_torch.core.registry import LowerContext, OpRegistry

    attrs = {"is_sparse": True, "padding_idx": -1}
    ctx = LowerContext(OpDesc("lookup_table_grad", {}, {}, attrs), None,
                       "cpu")
    ins = {"Ids": [torch.zeros((2, 1), dtype=torch.int64)],
           "W": [torch.zeros((4, 3))], "Out@GRAD": [torch.ones((2, 3))]}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        OpRegistry.get("lookup_table_grad").lower(ctx, ins, attrs)
