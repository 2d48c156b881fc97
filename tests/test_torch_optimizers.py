"""The eight optimizers the port adds (LarsMomentum, Adagrad, Adamax,
DecayedAdagrad, Adadelta, RMSProp, Ftrl, ModelAverage) and the learning
rate schedulers (layers/learning_rate_scheduler.py: the eight decays and
append_LARS) against the JAX package, on the CPU.

Each case builds one small MLP (8 -> 16 relu -> 4, softmax cross entropy)
with both front ends (the descs must be byte-identical), runs the JAX
package's startup program, carries its scope into the port by name
(``convert.load_numpy_state``) and runs the same steps on the same
batches in both: 3 steps for an optimizer, 12 for a scheduler, whose
rate is fetched every step.

Tolerances, float32 on both sides, the same formulas in other summation
orders: losses and learning rates rtol 1e-5; every persistable var after
the steps |d| <= 1e-5 * max|want| + 1e-6 (Adagrad, Adadelta, RMSProp and
Ftrl divide by a square root of an accumulator, so an element whose grad
is near rounding noise moves by a different fraction of its step).
"""

import json

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name

RTOL = 1e-5
STATE_REL, STATE_ABS = 1e-5, 1e-6


def _mlp(fl):
    x = fl.layers.data(name="x", shape=[8], dtype="float32")
    y = fl.layers.data(name="y", shape=[1], dtype="int64")
    h = fl.layers.fc(input=x, size=16, act="relu",
                     param_attr=fl.ParamAttr(name="w1"))
    pred = fl.layers.fc(input=h, size=4, param_attr=fl.ParamAttr(name="w2"))
    return fl.layers.mean(fl.layers.softmax_with_cross_entropy(
        logits=pred, label=y))


def _feeds(n, batch=8):
    rng = np.random.RandomState(5)
    return [{"x": rng.randn(batch, 8).astype(np.float32),
             "y": rng.randint(0, 4, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _build(fl, unique_name, make):
    """(main, startup, fetch vars) of ``make(fl, loss)`` under a fresh
    name generator."""
    main, startup = fl.Program(), fl.Program()
    with unique_name.guard(), fl.program_guard(main, startup):
        loss = _mlp(fl)
        extra = make(fl, loss)
    return main, startup, [loss] + list(extra or [])


def _same_desc(j_prog, t_prog):
    j_desc = json.loads(j_prog.desc.serialize_to_string())
    t_desc = json.loads(t_prog.desc.serialize_to_string())
    assert t_desc == j_desc


def _run_both(make, steps, after=None):
    """Build ``make`` in both packages, run ``steps`` steps from the JAX
    package's startup state; returns (JAX fetches, port fetches, JAX
    state, port state), fetches as [step][fetch] float lists."""
    j_main, j_startup, j_fetch = _build(jfluid, j_unique_name, make)
    t_main, t_startup, t_fetch = _build(tfluid, t_unique_name, make)
    _same_desc(j_main, t_main)
    _same_desc(j_startup, t_startup)
    feeds = _feeds(steps)
    persist = [v.name for v in j_main.list_vars() if v.persistable]

    j_exe, j_scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(j_scope):
        j_exe.run(j_startup)
        state0 = {n: np.array(j_scope.get(n)) for n in persist}
        j_out = [[np.asarray(v).reshape(-1).tolist()
                  for v in j_exe.run(j_main, feed=f, fetch_list=j_fetch)]
                 for f in feeds]
        j_state = {n: np.array(j_scope.get(n)) for n in persist}
        if after is not None:
            j_state.update(after(jfluid, j_exe, j_scope, "j"))

    t_exe, t_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    convert.load_numpy_state(t_scope, state0, "cpu", program=t_main)
    with tfluid.scope_guard(t_scope):
        t_out = [[np.asarray(v).reshape(-1).tolist()
                  for v in t_exe.run(t_main, feed=f, fetch_list=t_fetch)]
                 for f in feeds]
        t_state = {n: t_scope.get(n).numpy().copy() for n in persist}
        if after is not None:
            t_state.update(after(tfluid, t_exe, t_scope, "t"))
    return j_out, t_out, j_state, t_state


def _close_state(j_state, t_state):
    assert sorted(t_state) == sorted(j_state)
    for n, want in j_state.items():
        got = t_state[n]
        assert got.shape == want.shape, n
        tol = STATE_REL * float(np.abs(want).max()) + STATE_ABS
        assert float(np.abs(got - want).max()) <= tol, (
            n, float(np.abs(got - want).max()), tol)


OPTIMIZERS = {
    "lars_momentum": lambda fl: fl.optimizer.LarsMomentum(
        learning_rate=0.1, momentum=0.9, lars_coeff=0.01),
    "adagrad": lambda fl: fl.optimizer.Adagrad(
        learning_rate=0.1, initial_accumulator_value=0.1),
    "adamax": lambda fl: fl.optimizer.Adamax(learning_rate=0.05),
    "decayed_adagrad": lambda fl: fl.optimizer.DecayedAdagrad(
        learning_rate=0.05),
    "adadelta": lambda fl: fl.optimizer.Adadelta(learning_rate=1.0),
    "rmsprop": lambda fl: fl.optimizer.RMSProp(learning_rate=0.01,
                                               momentum=0.5),
    "rmsprop_centered": lambda fl: fl.optimizer.RMSProp(
        learning_rate=0.01, centered=True),
    "ftrl": lambda fl: fl.optimizer.Ftrl(learning_rate=0.1, l1=0.01,
                                         l2=0.01),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_three_steps_match_jax(name):
    def make(fl, loss):
        OPTIMIZERS[name](fl).minimize(loss)

    j_out, t_out, j_state, t_state = _run_both(make, 3)
    np.testing.assert_allclose(np.array(t_out), np.array(j_out), rtol=RTOL)
    _close_state(j_state, t_state)
    # the updates moved the weights: the loss changed
    assert t_out[0][0] != t_out[-1][0]


def test_model_average_apply_and_restore_match_jax():
    """SGD steps with ModelAverage accumulating beside them; ``apply``
    swaps in the window averages, ``restore`` puts the weights back (the
    port copies in place, into the scope's own tensors)."""
    averages = {}

    def make(fl, loss):
        fl.optimizer.SGD(learning_rate=0.5).minimize(loss)
        averages[fl.__name__] = fl.optimizer.ModelAverage(
            0.15, min_average_window=2, max_average_window=3)

    def after(fl, exe, scope, side):
        out = {}
        before = {n: np.array(scope.get(n)) for n in ("w1", "w2")}
        ids = {n: id(scope.get(n)) for n in ("w1", "w2")}
        with averages[fl.__name__].apply(exe):
            for n in ("w1", "w2"):
                out[n + "@AVG"] = np.array(scope.get(n))
            if side == "t":
                assert {n: id(scope.get(n)) for n in ids} == ids
        for n in ("w1", "w2"):
            np.testing.assert_array_equal(np.array(scope.get(n)), before[n])
        return out

    j_out, t_out, j_state, t_state = _run_both(make, 5, after=after)
    np.testing.assert_allclose(np.array(t_out), np.array(j_out), rtol=RTOL)
    _close_state(j_state, t_state)
    assert not np.allclose(t_state["w1@AVG"], t_state["w1"])


SCHEDULERS = {
    "exponential_decay": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_decay_staircase": lambda L: L.exponential_decay(
        0.1, 3, 0.5, staircase=True),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 4, 0.3),
    "inverse_time_decay": lambda L: L.inverse_time_decay(
        0.1, 2, 0.5, staircase=True),
    "polynomial_decay": lambda L: L.polynomial_decay(0.1, 8, 0.01,
                                                     power=2.0),
    "polynomial_decay_cycle": lambda L: L.polynomial_decay(
        0.1, 5, 0.01, power=1.0, cycle=True),
    "piecewise_decay": lambda L: L.piecewise_decay([3, 7], [0.1, 0.05,
                                                            0.01]),
    "noam_decay": lambda L: L.noam_decay(64, 4),
    "cosine_decay": lambda L: L.cosine_decay(0.1, 3, 4),
    "linear_lr_warmup": lambda L: L.linear_lr_warmup(
        L.exponential_decay(0.1, 5, 0.5), 4, 0.0, 0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_values_over_12_steps_match_jax(name):
    def make(fl, loss):
        lr = SCHEDULERS[name](fl.layers)
        fl.optimizer.SGD(learning_rate=lr).minimize(loss)
        return [lr]

    j_out, t_out, j_state, t_state = _run_both(make, 12)
    j_lr = np.array([s[1] for s in j_out])
    t_lr = np.array([s[1] for s in t_out])
    np.testing.assert_allclose(t_lr, j_lr, rtol=RTOL)
    assert len(set(np.round(t_lr.reshape(-1), 7))) > 1  # it decays
    np.testing.assert_allclose(np.array([s[0] for s in t_out]),
                               np.array([s[0] for s in j_out]), rtol=RTOL)
    _close_state(j_state, t_state)
    assert float(t_state["@LR_DECAY_COUNTER@"][0]) == 12.0


def test_append_lars_per_param_rates_match_jax():
    """append_LARS between backward and apply_gradients: each parameter's
    rate lr * ||w|| / (||g|| + wd * ||w||), recomputed every step."""
    def make(fl, loss):
        opt = fl.optimizer.SGD(learning_rate=0.1)
        params_grads = opt.backward(loss)
        fl.layers.append_LARS(params_grads, 0.1, 0.01)
        rates = [p.optimize_attr["learning_rate"] for p, _ in params_grads]
        opt.apply_gradients(params_grads)
        return rates

    j_out, t_out, j_state, t_state = _run_both(make, 12)
    np.testing.assert_allclose(np.array(t_out), np.array(j_out), rtol=RTOL)
    _close_state(j_state, t_state)
