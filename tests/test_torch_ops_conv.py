"""The ResNet and MNIST slice's op lowerings in the port against the JAX
package's, on the CPU, on the same random inputs (numpy, seeded): conv2d
and its direct grad (strides, padding, groups, dilation, 1x1 and 7x7,
float32 and under AMP), depthwise_conv2d and its grad, pool2d (max, avg
exclusive and not, ceil mode, global, adaptive) and its vjp grad,
batch_norm and its direct grad (training, ``is_test``,
``use_global_stats``, all four statistic outputs, the grad without saved
statistics), sync_batch_norm, softmax, top_k, accuracy; and the random
initializer ops by their statistics.

Each case runs one op desc through each package's own ``run_op``, so a
grad op without a lowering of its own (pool2d_grad, softmax_grad) is each
package's generic vjp of the forward.

Tolerances:
- float32: |d| <= 1e-5 * max|want| + 1e-6 (the same formulas summed in
  other orders: the convs' products, the pools' window sums, the
  normalization's reductions). Integer outputs equal.
- bfloat16 (AMP, or bf16 input): |d| <= 2^-7 |want| + 2^-7 max|want|, as
  ``test_torch_amp.py``: both round a float32 result to bf16, and where
  the two float32 results straddle a rounding boundary they land one ulp
  apart. Every output's dtype must be the reference's.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import amp_scope as j_amp_scope
from paddle_tpu.engine import lowering as jlowering
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)

from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry,
                                            amp_scope as t_amp_scope)
from paddle_tpu_torch.core.types import VarType
from paddle_tpu_torch.engine import lowering as tlowering

F32_REL, F32_ABS = 1e-5, 1e-6


def _f(shape, seed, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _pos(shape, seed):
    return np.abs(_f(shape, seed)) + 0.5


def _conv(x, w, stride, pad, dilation=1, groups=1):
    return ({"Input": x, "Filter": w},
            {"strides": [stride, stride], "paddings": [pad, pad],
             "dilations": [dilation, dilation], "groups": groups,
             "use_cudnn": True})


def _pool(ptype, k, s, p, ceil=False, exclusive=True, glob=False,
          adaptive=False):
    attrs = {"pooling_type": ptype, "ksize": [k, k], "strides": [s, s],
             "paddings": [p, p], "global_pooling": glob, "ceil_mode": ceil,
             "exclusive": exclusive}
    if adaptive:
        attrs["adaptive"] = True
    return attrs


def _bn_ins(shape, seed):
    c = shape[1]
    return {"X": _f(shape, seed, 2.0) + 1.0, "Scale": _f((c,), seed + 1),
            "Bias": _f((c,), seed + 2), "Mean": _f((c,), seed + 3),
            "Variance": _pos((c,), seed + 4)}


BN_OUTS = ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance")
BN_ATTRS = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
            "data_layout": "NCHW", "use_global_stats": False}


def _grad_of(fwd_ins, fwd_outs, out_grads):
    """The attrs and the extra inputs of a generic grad op: the engine
    reads the forward's slot lists from the attrs."""
    return {"__fwd_inputs__": sorted(fwd_ins),
            "__fwd_outputs__": sorted(fwd_outs)}, out_grads


_X33 = _f((2, 3, 9, 9), 7)
_SM = _f((4, 10), 8, 3.0)

# (id, op type, {slot: array}, attrs, output slots, is_test, amp, slots
# cast to bf16 before the op)
CASES = []


def case(cid, op_type, ins, attrs, outs, is_test=False, amp=False,
         bf16=()):
    CASES.append((cid, op_type, ins, attrs, outs, is_test, amp, bf16))


for cid, (ins, attrs) in {
        "3x3_s1_p1": _conv(_f((2, 4, 9, 9), 0), _f((6, 4, 3, 3), 1), 1, 1),
        "7x7_s2_p3": _conv(_f((2, 3, 20, 20), 2), _f((8, 3, 7, 7), 3), 2,
                           3),
        "1x1_s2": _conv(_f((2, 8, 10, 10), 4), _f((16, 8, 1, 1), 5), 2, 0),
        "groups2_dilation2": _conv(_f((2, 4, 11, 11), 6),
                                   _f((6, 2, 3, 3), 9), 1, 2, dilation=2,
                                   groups=2),
}.items():
    case("conv2d_" + cid, "conv2d", ins, attrs, ["Output"])
    case("conv2d_grad_" + cid, "conv2d_grad",
         dict(ins, **{"Output@GRAD": _f((1,), 0)}), attrs,
         ["Input@GRAD", "Filter@GRAD"])
    if cid in ("3x3_s1_p1", "7x7_s2_p3"):
        case("conv2d_amp_" + cid, "conv2d", ins, attrs, ["Output"],
             amp=True)
        case("conv2d_grad_amp_" + cid, "conv2d_grad",
             dict(ins, **{"Output@GRAD": _f((1,), 0)}), attrs,
             ["Input@GRAD", "Filter@GRAD"], amp=True)

_DW = _conv(_f((2, 4, 9, 9), 10), _f((4, 1, 3, 3), 11), 2, 1)
case("depthwise_conv2d", "depthwise_conv2d", *_DW, ["Output"])
case("depthwise_conv2d_grad", "depthwise_conv2d_grad",
     dict(_DW[0], **{"Output@GRAD": _f((1,), 0)}), _DW[1],
     ["Input@GRAD", "Filter@GRAD"])

for cid, attrs, x in (
        ("max_3_2_1", _pool("max", 3, 2, 1), _X33),
        ("max_2_2_0", _pool("max", 2, 2, 0), _f((2, 3, 8, 8), 12)),
        # ceil mode adds a last partial window: 10 -> 5 (floor 4)
        ("max_ceil_3_2_0", _pool("max", 3, 2, 0, ceil=True),
         _f((2, 3, 10, 10), 13)),
        # the reference pads bottom/right by max(needed, p): here 2 > 1,
        # and torch's ceil mode would drop a last window starting in the
        # padding
        ("max_ceil_3_3_1", _pool("max", 3, 3, 1, ceil=True),
         _f((1, 2, 8, 8), 14)),
        ("avg_exclusive_3_2_1", _pool("avg", 3, 2, 1), _X33),
        ("avg_inclusive_3_2_1", _pool("avg", 3, 2, 1, exclusive=False),
         _X33),
        ("avg_exclusive_ceil_3_2_1", _pool("avg", 3, 2, 1, ceil=True),
         _f((2, 3, 10, 10), 15)),
        ("avg_inclusive_ceil_2_2_0", _pool("avg", 2, 2, 0, ceil=True,
                                           exclusive=False),
         _f((2, 3, 9, 9), 16)),
        ("avg_global", _pool("avg", 7, 1, 0, glob=True),
         _f((2, 5, 7, 7), 17)),
        ("max_global", _pool("max", 7, 1, 0, glob=True),
         _f((2, 5, 7, 7), 18)),
        ("avg_adaptive_1x1", _pool("avg", 1, 1, 0, adaptive=True),
         _f((2, 5, 6, 6), 19)),
):
    case("pool2d_" + cid, "pool2d", {"X": x}, attrs, ["Out"])
    if cid in ("max_3_2_1", "max_ceil_3_3_1", "avg_exclusive_ceil_3_2_1",
               "avg_inclusive_3_2_1", "avg_global"):
        gattrs, gins = _grad_of(["X"], ["Out"], {"Out@GRAD": _f((1,), 0)})
        case("pool2d_grad_" + cid, "pool2d_grad", dict({"X": x}, **gins),
             dict(attrs, **gattrs), ["X@GRAD"])
case("pool2d_avg_global_bf16", "pool2d", {"X": _f((2, 5, 7, 7), 20)},
     _pool("avg", 7, 1, 0, glob=True), ["Out"], bf16=("X",))

_BN4 = _bn_ins((4, 3, 5, 5), 30)
_BN2 = _bn_ins((6, 4), 40)
case("batch_norm_train", "batch_norm", _BN4, BN_ATTRS, BN_OUTS)
case("batch_norm_train_2d", "batch_norm", _BN2, BN_ATTRS, BN_OUTS)
case("batch_norm_is_test_attr", "batch_norm", _BN4,
     dict(BN_ATTRS, is_test=True), BN_OUTS)
case("batch_norm_is_test_run", "batch_norm", _BN4, BN_ATTRS, BN_OUTS,
     is_test=True)
case("batch_norm_use_global_stats", "batch_norm", _BN4,
     dict(BN_ATTRS, use_global_stats=True, momentum=0.5), BN_OUTS)
case("batch_norm_train_bf16_x", "batch_norm", _BN4, BN_ATTRS, BN_OUTS,
     bf16=("X",))
case("sync_batch_norm_train", "sync_batch_norm", _BN4, BN_ATTRS, BN_OUTS)


def _bn_grad_ins(ins, seed, saved=True, use_global=False):
    x = ins["X"].astype(np.float64)
    out = dict(ins, **{"Y@GRAD": _f(x.shape, seed)})
    if saved:
        axes = (0, 2, 3) if x.ndim == 4 else (0,)
        if use_global:
            out["SavedMean"] = ins["Mean"]
            out["SavedVariance"] = ins["Variance"]
        else:
            out["SavedMean"] = x.mean(axes).astype(np.float32)
            out["SavedVariance"] = x.var(axes).astype(np.float32)
    return out


BN_GRAD_OUTS = ("X@GRAD", "Scale@GRAD", "Bias@GRAD")
case("batch_norm_grad_train", "batch_norm_grad", _bn_grad_ins(_BN4, 31),
     BN_ATTRS, BN_GRAD_OUTS)
case("batch_norm_grad_train_2d", "batch_norm_grad", _bn_grad_ins(_BN2, 41),
     BN_ATTRS, BN_GRAD_OUTS)
case("batch_norm_grad_use_global_stats", "batch_norm_grad",
     _bn_grad_ins(_BN4, 32, use_global=True),
     dict(BN_ATTRS, use_global_stats=True), BN_GRAD_OUTS)
case("batch_norm_grad_no_saved_stats", "batch_norm_grad",
     _bn_grad_ins(_BN4, 33, saved=False), BN_ATTRS, BN_GRAD_OUTS)
case("batch_norm_grad_no_saved_stats_is_test", "batch_norm_grad",
     _bn_grad_ins(_BN4, 34, saved=False), BN_ATTRS, BN_GRAD_OUTS,
     is_test=True)
case("batch_norm_grad_bf16_x", "batch_norm_grad", _bn_grad_ins(_BN4, 35),
     BN_ATTRS, BN_GRAD_OUTS, bf16=("X", "Y@GRAD"))
case("sync_batch_norm_grad_train", "sync_batch_norm_grad",
     _bn_grad_ins(_BN4, 36), BN_ATTRS, BN_GRAD_OUTS)

case("softmax", "softmax", {"X": _SM}, {"axis": -1}, ["Out"])
case("softmax_axis1", "softmax", {"X": _f((2, 5, 3), 21)}, {"axis": 1},
     ["Out"])
case("softmax_bf16", "softmax", {"X": _SM}, {"axis": -1}, ["Out"],
     bf16=("X",))
case("softmax_grad", "softmax_grad",
     {"X": _SM, "Out@GRAD": _f((4, 10), 22)},
     dict({"axis": -1}, **_grad_of(["X"], ["Out"], {})[0]), ["X@GRAD"])
case("top_k_1", "top_k", {"X": _SM}, {"k": 1}, ["Out", "Indices"])
case("top_k_3", "top_k", {"X": _f((2, 3, 7), 23)}, {"k": 3},
     ["Out", "Indices"])
case("top_k_grad", "top_k_grad",
     {"X": _f((2, 3, 7), 23), "Out@GRAD": _f((2, 3, 3), 24)}, {"k": 3},
     ["X@GRAD"])
# ties: all-zero rows and repeated maxima take the lowest index first, as
# lax.top_k does (torch.topk orders them otherwise)
_TIED = np.array([[0, 0, 0, 0, 0], [1, 3, 3, 3, -1], [2, 2, 5, 5, 2],
                  [-1, -1, -1, 4, -1]], np.float32)
case("top_k_ties", "top_k", {"X": _TIED}, {"k": 3}, ["Out", "Indices"])
case("top_k_ties_bf16", "top_k", {"X": _TIED}, {"k": 2},
     ["Out", "Indices"], bf16=("X",))
case("top_k_ties_bf16_rounded", "top_k",
     {"X": np.array([[1.0, 1.001, 1.002, 0.5], [0.0, -0.0, 0.0, 0.0]],
                    np.float32)}, {"k": 2}, ["Out", "Indices"],
     bf16=("X",))
case("top_k_grad_ties", "top_k_grad",
     {"X": _TIED, "Out@GRAD": _f((4, 2), 27)}, {"k": 2}, ["X@GRAD"])
case("accuracy_top1", "accuracy",
     {"Out": _f((6, 1), 25), "Indices": np.array(
         [[3], [1], [4], [1], [5], [9]], np.int64),
      "Label": np.array([[3], [2], [4], [0], [5], [0]], np.int64)}, {},
     ["Accuracy", "Correct", "Total"])
case("accuracy_top3", "accuracy",
     {"Out": _f((4, 3), 26), "Indices": np.array(
         [[3, 1, 0], [1, 2, 7], [4, 6, 5], [0, 8, 2]], np.int64),
      "Label": np.array([[0], [9], [5], [2]], np.int64)}, {},
     ["Accuracy", "Correct", "Total"])


def _fill_grads(ins, op_type, attrs, is_test, amp):
    """An ``Output@GRAD``/``Out@GRAD`` placeholder of shape (1,) becomes a
    seeded cotangent of the forward output's shape."""
    fwd = op_type[: -len("_grad")]
    slot = {"conv2d": "Output", "depthwise_conv2d": "Output",
            "pool2d": "Out"}.get(fwd)
    if slot is None or ins.get(slot + "@GRAD", np.zeros(2)).shape != (1,):
        return ins
    fins = {s: v for s, v in ins.items() if not s.endswith("@GRAD")}
    fattrs = {k: v for k, v in attrs.items() if not k.startswith("__")}
    out, _ = _run("torch", fwd, fins, fattrs, [slot], is_test, False, ())
    return dict(ins, **{slot + "@GRAD": _f(out[slot].shape, 77)})


def _run(side, op_type, ins, attrs, outs, is_test, amp, bf16):
    """Run one op desc through ``side``'s run_op; returns ({slot: numpy
    array, float32 for bf16}, {slot: dtype name})."""
    in_names = {s: [s] for s in ins}
    out_names = {s: ["out." + s] for s in outs}
    if side == "jax":
        op = JOpDesc(op_type, in_names, out_names, attrs)
        env = {s: (jnp.asarray(v, jnp.bfloat16) if s in bf16
                   else jnp.asarray(v)) for s, v in ins.items()}
        with j_amp_scope(amp):
            jlowering.run_op(op, None, env, jax.random.PRNGKey(0), 0,
                             is_test)
        vals = {s: env["out." + s] for s in outs}
        return {s: (np.asarray(v.astype(jnp.float32))
                    if v.dtype == jnp.bfloat16 else np.asarray(v))
                for s, v in vals.items()}, {
                    s: str(v.dtype) for s, v in vals.items()}
    op = TOpDesc(op_type, in_names, out_names, attrs)
    env = {s: (torch.from_numpy(np.array(v)).to(torch.bfloat16)
               if s in bf16 else torch.from_numpy(np.array(v)))
           for s, v in ins.items()}
    with t_amp_scope(amp):
        tlowering.run_op(op, None, env, "cpu", (0, 1), 0, is_test)
    vals = {s: env["out." + s] for s in outs}
    return {s: v.float().numpy() if v.dtype == torch.bfloat16
            else v.numpy() for s, v in vals.items()}, {
                s: str(v.dtype).replace("torch.", "")
                for s, v in vals.items()}


def _run_case(c):
    _, op_type, ins, attrs, outs, is_test, amp, bf16 = c
    ins = _fill_grads(ins, op_type, attrs, is_test, amp)
    return (_run("jax", op_type, ins, attrs, outs, is_test, amp, bf16),
            _run("torch", op_type, ins, attrs, outs, is_test, amp, bf16))


@pytest.mark.parametrize("c", CASES, ids=[c[0] for c in CASES])
def test_lowering_matches_reference(c):
    (want, want_dt), (got, got_dt) = _run_case(c)
    low = c[6] or bool(c[7])
    for slot in c[4]:
        w, g = want[slot], got[slot]
        assert g.shape == w.shape, (slot, g.shape, w.shape)
        if not np.issubdtype(w.dtype, np.floating):
            # JAX holds int64 as int32 with 64-bit types off
            np.testing.assert_array_equal(g, w, err_msg=slot)
            continue
        assert got_dt[slot] == want_dt[slot], (slot, got_dt, want_dt)
        # equal values (-inf of a window wholly in max pooling's padding
        # included) differ by 0
        with np.errstate(invalid="ignore"):
            diff = np.where(g == w, 0.0, np.abs(g - w))
        peak = float(np.abs(w[np.isfinite(w)]).max())
        if low or want_dt[slot] == "bfloat16":
            allowed = 2.0 ** -7 * np.abs(w) + 2.0 ** -7 * peak
        else:
            allowed = F32_REL * peak + F32_ABS
        assert np.all(diff <= allowed), (slot, float(diff.max()), peak)


def test_every_lowering_of_the_slice_has_a_case():
    """Every op this slice ports (the random draws are held by their
    statistics below); pool2d's and softmax's grads are the engine's
    generic vjp, as in the reference."""
    assert {c[1] for c in CASES} | {
        "gaussian_random", "truncated_gaussian_random"} == SLICE_OPS
    generic = {"pool2d_grad", "softmax_grad"}
    assert SLICE_OPS - generic <= set(TOpRegistry.all_types())
    assert not generic & set(TOpRegistry.all_types())


SLICE_OPS = {
    "conv2d", "conv2d_grad", "depthwise_conv2d", "depthwise_conv2d_grad",
    "pool2d", "pool2d_grad", "batch_norm", "batch_norm_grad",
    "sync_batch_norm", "sync_batch_norm_grad", "softmax", "softmax_grad",
    "top_k", "top_k_grad", "accuracy", "gaussian_random",
    "truncated_gaussian_random"}


def test_max_pool_ties_send_the_grad_to_the_first_maximum():
    """With tied maxima in a window (all zeros after a ReLU, or two equal
    values) both packages send the window's grad to the first maximum in
    row-major order within the window: the reference's ``reduce_window``
    max transposes to a select-and-scatter whose select keeps the earlier
    element on ties, and torch's max pooling records the first maximum's
    index. Non-overlapping 2x2 windows, so each window's grad lands on one
    element."""
    x = np.maximum(_f((2, 3, 8, 8), 50) - 0.7, 0.0)
    x[0, 0, 0:2, 2:4] = [[0.5, 0.5], [0.5, 0.1]]   # a three-way tie
    x[1, 2, 4:6, 4:6] = [[0.0, 0.7], [0.7, 0.0]]   # a two-way tie
    attrs = dict(_pool("max", 2, 2, 0), **_grad_of(["X"], ["Out"], {})[0])
    ins = {"X": x, "Out@GRAD": _f((2, 3, 4, 4), 51)}
    (want, _), (got, _) = [
        _run(side, "pool2d_grad", ins, attrs, ["X@GRAD"], False, False, ())
        for side in ("jax", "torch")]
    np.testing.assert_array_equal(got["X@GRAD"], want["X@GRAD"])
    windows = x.reshape(2, 3, 4, 2, 4, 2).transpose(0, 1, 2, 4, 3, 5)
    first = windows.reshape(2, 3, 4, 4, 4).argmax(-1)  # first maximum
    gw = want["X@GRAD"].reshape(2, 3, 4, 2, 4, 2).transpose(
        0, 1, 2, 4, 3, 5).reshape(2, 3, 4, 4, 4)
    picked = np.take_along_axis(gw, first[..., None], -1)[..., 0]
    np.testing.assert_array_equal(picked, ins["Out@GRAD"])
    assert (np.count_nonzero(gw, axis=-1) <= 1).all()
    assert (windows.reshape(2, 3, 4, 4, 4).max(-1) == 0).sum() > 10


_FP32 = int(VarType.FP32)
# the standard normal truncated to [-2, 2]: its variance is
# 1 - 2 * 2 * pdf(2) / (cdf(2) - cdf(-2))
_PDF2 = math.exp(-2.0) / math.sqrt(2.0 * math.pi)
_TRUNC_STD = math.sqrt(1.0 - 4.0 * _PDF2 / math.erf(2.0 / math.sqrt(2.0)))


@pytest.mark.parametrize("op_type,std_factor", [
    ("gaussian_random", 1.0), ("truncated_gaussian_random", _TRUNC_STD)])
def test_random_normal_draws_statistics(op_type, std_factor):
    """The draws' bits are each package's own RNG, so the contract is
    compared: 65536 draws at mean 0.5, std 2 have their mean within 5
    standard errors, their std within 2 % (5 standard errors is 1.4 %) of
    the distribution's, and the truncated draws stay within 2 std of the
    mean and reach past 1.9 std; the same holds for the reference's draws.
    Each (seed, run, op) stream is reproducible and another run or op
    draws anew."""
    mean, std, n = 0.5, 2.0, 256 * 256
    attrs = {"shape": [256, 256], "dtype": _FP32, "mean": mean, "std": std,
             "seed": 0}
    lower = TOpRegistry.get(op_type).lower
    op = TOpDesc(op_type, {}, {"Out": ["w"]}, attrs)

    def draw(run, op_index):
        ctx = TLowerContext(op, None, "cpu", rng_seed=(3, run),
                            op_index=op_index)
        return lower(ctx, {}, attrs)["Out"][0]

    want, want_dt = _run("jax", op_type, {}, attrs, ["Out"], False, False,
                         ())
    got = draw(1, 0)
    assert tuple(got.shape) == want["Out"].shape
    assert str(got.dtype).replace("torch.", "") == want_dt["Out"]
    for z in (got.numpy().astype(np.float64), want["Out"].astype(
            np.float64)):
        dist_std = std * std_factor
        assert abs(z.mean() - mean) <= 5 * dist_std / math.sqrt(n)
        assert abs(z.std() / dist_std - 1.0) <= 0.02
        if std_factor != 1.0:
            assert np.abs(z - mean).max() <= 2 * std * (1 + 1e-6)
            assert np.abs(z - mean).max() > 1.9 * std
    assert torch.equal(got, draw(1, 0))
    assert not torch.equal(got, draw(2, 0))
    assert not torch.equal(got, draw(1, 1))
