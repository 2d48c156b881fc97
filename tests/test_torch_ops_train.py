"""The training loop's ops of the port (ops/activation_ops.py in full, the
clip, norm and step ops, the eight optimizer updates) against the JAX
package's lowerings of the same ops, on the same random inputs (numpy,
seeded), through each package's registry and LowerContext
(``_run_jax``/``_run_torch`` of test_torch_ops.py).

Tolerance: float32, rtol 1e-5 / atol 1e-5, as in test_torch_ops.py: the
same formulas, other libm implementations (exp, log, tanh, erf, pow). The
grads the engine derives by vjp (every activation without a grad
lowering of its own, clip, clip_by_norm, pow and the elementwise
max/min/pow) are held the same way: ``torch.func.vjp`` of the port's
lowering against ``jax.vjp`` of the reference's, on one cotangent.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import (LowerContext as JLowerContext,
                                      OpRegistry as JOpRegistry)

from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry)

from test_torch_ops import ATOL, RTOL, _run_jax, _run_torch


def _f(shape, seed, scale=1.0, low=None):
    x = np.random.RandomState(seed).randn(*shape) * scale
    if low is not None:
        x = np.abs(x) + low
    return np.asarray(x, np.float32)


# X for the activations: values on both sides of every threshold
_X = _f((4, 9), 100, 3.0)
_POS = _f((4, 9), 101, 2.0, low=0.1)

UNARY = ["sigmoid", "exp", "tanh", "relu", "logsigmoid", "square", "abs",
         "softsign", "softplus", "tanh_shrink", "sin", "cos", "floor",
         "ceil", "round", "sign", "gelu"]
POSITIVE = ["sqrt", "rsqrt", "reciprocal", "log"]
PARAMETERISED = [
    ("leaky_relu", {"alpha": 0.1}), ("leaky_relu", {}),
    ("relu6", {"threshold": 4.0}), ("elu", {"alpha": 0.7}),
    ("hard_sigmoid", {"slope": 0.3, "offset": 0.4}), ("swish", {"beta": 1.5}),
    ("brelu", {"t_min": -1.0, "t_max": 2.0}), ("soft_relu", {"threshold": 2.0}),
    ("pow_activation", {"factor": 2.0}),
    ("stanh", {"scale_a": 0.5, "scale_b": 1.2}),
    ("hard_shrink", {"threshold": 1.0}), ("softshrink", {"lambda": 0.8}),
    ("thresholded_relu", {"threshold": 0.5}),
    ("log_softmax", {"axis": -1}), ("log_softmax", {"axis": 0}),
]

# (id, op type, {slot: [numpy arrays]}, attrs)
CASES = (
    [(t, t, {"X": [_X]}, {}) for t in UNARY]
    + [(t, t, {"X": [_POS]}, {}) for t in POSITIVE]
    + [("%s_%d" % (t, i), t, {"X": [_X]}, a)
       for i, (t, a) in enumerate(PARAMETERISED)]
    + [("%s_grad" % t, t + "_grad",
        {"X": [x], "Out": [_run_torch(t, {"X": [x]}, {}, False)["Out"][0]],
         "Out@GRAD": [_f((4, 9), 102)]}, {})
       for t, x in (("sigmoid", _X), ("exp", _X), ("sqrt", _POS),
                    ("rsqrt", _POS), ("reciprocal", _POS))]
    + [
        ("clip", "clip", {"X": [_X]}, {"min": -1.0, "max": 2.0}),
        ("clip_by_norm_scaled", "clip_by_norm", {"X": [_X]},
         {"max_norm": 1.0}),
        ("clip_by_norm_kept", "clip_by_norm", {"X": [_X]},
         {"max_norm": 1e3}),
        ("squared_l2_norm", "squared_l2_norm", {"X": [_X]}, {}),
        ("pow", "pow", {"X": [_POS]}, {"factor": 1.7}),
        ("elementwise_max", "elementwise_max",
         {"X": [_X], "Y": [_f((9,), 103)]}, {"axis": -1}),
        ("elementwise_min", "elementwise_min",
         {"X": [_X], "Y": [_f((4, 1), 104)]}, {"axis": 0}),
        ("elementwise_pow", "elementwise_pow",
         {"X": [_POS], "Y": [_f((1,), 105, 0.5)]}, {"axis": -1}),
        ("increment_f32", "increment", {"X": [np.array([3.0], np.float32)]},
         {"step": 1.0}),
        ("increment_i64", "increment", {"X": [np.array([5], np.int64)]},
         {"step": 2.0}),
    ]
)

_P = _f((6, 5), 110)
_G = _f((6, 5), 111)
_LR = np.array([0.05], np.float32)
OPTIMIZER_CASES = [
    ("lars_momentum", "lars_momentum",
     {"Param": [_P], "Grad": [_G], "Velocity": [_f((6, 5), 112)],
      "LearningRate": [_LR]},
     {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005}),
    ("adamax", "adamax",
     {"Param": [_P], "Grad": [_G], "Moment": [_f((6, 5), 113)],
      "InfNorm": [_f((6, 5), 114, low=0.01)], "LearningRate": [_LR],
      "Beta1Pow": [np.array([0.81], np.float32)]},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("adagrad", "adagrad",
     {"Param": [_P], "Grad": [_G], "Moment": [_f((6, 5), 115, low=0.0)],
      "LearningRate": [_LR]}, {"epsilon": 1e-6}),
    ("decayed_adagrad", "decayed_adagrad",
     {"Param": [_P], "Grad": [_G], "Moment": [_f((6, 5), 116, low=0.0)],
      "LearningRate": [_LR]}, {"decay": 0.9, "epsilon": 1e-6}),
    ("adadelta", "adadelta",
     {"Param": [_P], "Grad": [_G],
      "AvgSquaredGrad": [_f((6, 5), 117, low=0.0)],
      "AvgSquaredUpdate": [_f((6, 5), 118, low=0.0)]},
     {"rho": 0.9, "epsilon": 1e-6}),
    ("rmsprop", "rmsprop",
     {"Param": [_P], "Grad": [_G], "Moment": [_f((6, 5), 119)],
      "MeanSquare": [_f((6, 5), 120, low=0.0)],
      "MeanGrad": [_f((6, 5), 121, 0.1)], "LearningRate": [_LR]},
     {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5, "centered": False}),
    ("rmsprop_centered", "rmsprop",
     {"Param": [_P], "Grad": [_G], "Moment": [_f((6, 5), 122)],
      "MeanSquare": [_f((6, 5), 123, low=1.0)],
      "MeanGrad": [_f((6, 5), 124, 0.1)], "LearningRate": [_LR]},
     {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5, "centered": True}),
    ("ftrl", "ftrl",
     {"Param": [_P], "Grad": [_G],
      "SquaredAccumulator": [_f((6, 5), 125, low=0.1)],
      "LinearAccumulator": [_f((6, 5), 126)], "LearningRate": [_LR]},
     {"l1": 0.1, "l2": 0.01, "lr_power": -0.5}),
    ("model_average_accum_window", "model_average_accum",
     {"Param": [_P], "Sum": [_f((6, 5), 127)],
      "Cnt": [np.array([2.0], np.float32)], "OldSum": [_f((6, 5), 128)],
      "OldCnt": [np.array([4.0], np.float32)],
      "Total": [np.array([9.0], np.float32)]},
     {"average_window_rate": 0.15, "min_average_window": 10,
      "max_average_window": 20}),
    ("model_average_accum_restart", "model_average_accum",
     {"Param": [_P], "Sum": [_f((6, 5), 129)],
      "Cnt": [np.array([2.0], np.float32)], "OldSum": [_f((6, 5), 130)],
      "OldCnt": [np.array([4.0], np.float32)],
      "Total": [np.array([9.0], np.float32)]},
     {"average_window_rate": 0.15, "min_average_window": 3,
      "max_average_window": 20}),
]

# every lowering this file holds (with the grads the engine derives)
SLICE_OPS = ({c[1] for c in CASES} | {c[1] for c in OPTIMIZER_CASES})


def _compare(want, got):
    assert sorted(got) == sorted(want)
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for g, w in zip(got[slot], want[slot]):
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.floating):
                assert g.dtype == w.dtype, (slot, g.dtype, w.dtype)
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=slot)
            else:
                np.testing.assert_array_equal(g, w, err_msg=slot)


@pytest.mark.parametrize("case", CASES + OPTIMIZER_CASES,
                         ids=[c[0] for c in CASES + OPTIMIZER_CASES])
def test_lowering_matches_reference(case):
    _, op_type, ins, attrs = case
    _compare(_run_jax(op_type, ins, attrs, False),
             _run_torch(op_type, ins, attrs, False))


def test_optimizer_ops_keep_the_inplace_map():
    for _, op_type, _, _ in OPTIMIZER_CASES:
        assert (TOpRegistry.get(op_type).inplace_map
                == JOpRegistry.get(op_type).inplace_map), op_type


VJP_CASES = [c for c in CASES
             if c[1] != "increment" and not c[1].endswith("_grad")
             and c[1] not in ("squared_l2_norm",)]


@pytest.mark.parametrize("case", VJP_CASES, ids=[c[0] for c in VJP_CASES])
def test_vjp_grad_matches_reference(case):
    """The grad the engine derives for an op without a grad lowering (or
    its forward, for the out-based ones): vjp of each lowering on one
    cotangent."""
    _, op_type, ins, attrs = case
    slots = sorted(ins)
    cot = _f(_run_torch(op_type, ins, attrs, False)["Out"][0].shape, 131)

    def jfwd(*xs):
        op = JOpDesc(op_type, {s: ["x"] for s in slots}, {}, attrs)
        ctx = JLowerContext(op, None, rng_key=jax.random.PRNGKey(0),
                            op_index=0)
        return JOpRegistry.get(op_type).lower(
            ctx, {s: [x] for s, x in zip(slots, xs)}, attrs)["Out"][0]

    def tfwd(*xs):
        op = TOpDesc(op_type, {s: ["x"] for s in slots}, {}, attrs)
        ctx = TLowerContext(op, None, "cpu", rng_seed=(0, 1), op_index=0)
        return TOpRegistry.get(op_type).lower(
            ctx, {s: [x] for s, x in zip(slots, xs)}, attrs)["Out"][0]

    _, jvjp = jax.vjp(jfwd, *[jnp.asarray(ins[s][0]) for s in slots])
    want = jvjp(jnp.asarray(cot))
    _, tvjp = torch.func.vjp(tfwd, *[torch.from_numpy(ins[s][0].copy())
                                      for s in slots])
    got = tvjp(torch.from_numpy(cot))
    for s, g, w in zip(slots, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=s)


def test_every_activation_of_the_reference_is_ported():
    """ops/activation_ops.py in full: every op it registers (and the
    direct grads) is registered by the port."""
    import paddle_tpu.ops.activation_ops as jact

    ref = {t for t, info in JOpRegistry._ops.items()
           if info.lower.__module__ == jact.__name__}
    assert ref <= set(TOpRegistry.all_types())
    assert len(ref) == 43
