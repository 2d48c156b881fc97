"""The misc op family's lowerings (ROADMAP Queue 1, step 5e) against the
JAX package's, on the same random inputs (numpy, seeded), through each
package's registry and LowerContext: the 40 ops of ``misc_ops`` that the
sequence slice left, forward and vjp grads.

The cases follow the JAX package's tests: ``tests/test_layer_surface.py``
(``test_misc_op_oracles``, ``test_ctc_greedy_decoder_collapse``,
``test_conv3d_pool3d_shapes_and_grad``, ``test_grid_sampler_identity``,
``test_selu_and_losses_finite``, ``test_final_batch_layers``,
``test_conv3d_transpose_shape_contract``, the ``py_func`` cases) and
``tests/test_last_layers.py::test_tree_conv_matches_dfs_oracle``.

Tolerance: each float output and grad within 1e-5 of the reference's
largest element (zero where the reference is all zeros); integer and
boolean outputs exact, by value (the JAX package runs with 64-bit types
off, so its int64 outputs come back int32). ``nce`` draws its negatives
from the port's own counter hash: the JAX lowering's draw is patched to
return the port's ids, then everything is compared. The random ops'
bits are each package's own, so only their contract is held: shape,
dtype, range, the statistics, and a fresh but reproducible stream per
(seed, run, op).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import (LowerContext as JLowerContext,
                                      OpRegistry as JOpRegistry)
from paddle_tpu.ops import misc_ops as j_misc
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)

from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry)
from paddle_tpu_torch.ops import misc_ops as t_misc
import paddle_tpu_torch.ops  # noqa: F401  (registers the torch lowerings)

REL_TO_MAX = 1e-5


def _f(shape, seed, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _i(values):
    return np.asarray(values, np.int64)


def _ints(low, high, shape, seed):
    return np.random.RandomState(seed).randint(low, high, shape).astype(
        np.int64)


def _probs(shape, seed):
    p = np.abs(_f(shape, seed)) + 0.05
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _tree_edges():
    """The two trees of test_tree_conv_matches_dfs_oracle (1-based
    parent->child edges, zero-terminated), and a chain with a leaf."""
    edges = np.zeros((3, 10, 2), np.int32)
    edges[0, :5] = [[1, 2], [1, 3], [2, 4], [2, 5], [2, 6]]
    edges[1, :3] = [[1, 2], [1, 3], [3, 4]]
    edges[2, :4] = [[1, 2], [2, 3], [3, 4], [1, 5]]
    return edges


# max pooling's ties: relu'd integers, as C3D's pools see after a ReLU
_TIED = np.maximum(np.round(_f((2, 2, 4, 6, 6), 60)), 0.0).astype(np.float32)
_INF = _f((3, 4), 61)
_INF[1, 2] = np.inf
_NAN = _f((3, 4), 62)
_NAN[0, 1] = np.nan
_CTC = np.zeros((1, 6, 3), np.float32)
for _t, _c in enumerate([1, 1, 0, 2, 2, 0]):
    _CTC[0, _t, _c] = 1.0

# (id, op type, {slot: [numpy arrays]}, attrs)
CASES = [
    ("cos_sim", "cos_sim", {"X": [_f((3, 5), 0)], "Y": [_f((3, 5), 1)]},
     {}),
    ("cos_sim_broadcast_y", "cos_sim",
     {"X": [_f((4, 5), 2)], "Y": [_f((1, 5), 3)]}, {}),
    ("affine_channel", "affine_channel",
     {"X": [_f((2, 3, 4, 4), 4)], "Scale": [_f((3,), 5)],
      "Bias": [_f((3,), 6)]}, {"data_layout": "NCHW"}),
    ("shuffle_channel", "shuffle_channel", {"X": [_f((2, 6, 3, 3), 7)]},
     {"group": 3}),
    ("space_to_depth", "space_to_depth", {"X": [_f((2, 3, 4, 6), 8)]},
     {"blocksize": 2}),
    ("crop_attrs", "crop", {"X": [_f((3, 5, 6), 9)]},
     {"shape": [2, 3, 4], "offsets": [1, 1, 2]}),
    ("crop_like_y", "crop",
     {"X": [_f((3, 5, 6), 10)], "Y": [_f((2, 4, 3), 11)]},
     {"offsets": [0, 1, 3]}),
    ("crop_offsets_tensor_clamped", "crop",
     {"X": [_f((3, 5, 6), 12)], "Offsets": [np.array([1, 4, 1], np.int32)]},
     {"shape": [2, 3, 4]}),
    ("pad_constant_like", "pad_constant_like",
     {"X": [_f((4, 5, 3), 13)], "Y": [_f((2, 3, 3), 14)]},
     {"pad_value": 1.5}),
    ("multiplex", "multiplex",
     {"X": [_f((4, 3), 15), _f((4, 3), 16), _f((4, 3), 17)],
      "Ids": [_i([[0], [2], [1], [2]])]}, {}),
    ("bilinear_tensor_product", "bilinear_tensor_product",
     {"X": [_f((3, 4), 18)], "Y": [_f((3, 5), 19)],
      "Weight": [_f((2, 4, 5), 20)], "Bias": [_f((1, 2), 21)]}, {}),
    ("bilinear_tensor_product_no_bias", "bilinear_tensor_product",
     {"X": [_f((3, 4), 22)], "Y": [_f((3, 5), 23)],
      "Weight": [_f((3, 4, 5), 24)]}, {}),
    ("rank_loss", "rank_loss",
     {"Label": [np.array([[0.], [1.], [1.], [0.]], np.float32)],
      "Left": [_f((4, 1), 25)], "Right": [_f((4, 1), 26)]}, {}),
    ("margin_rank_loss", "margin_rank_loss",
     {"Label": [np.array([[1.], [-1.], [1.], [-1.]], np.float32)],
      "X1": [_f((4, 1), 27)], "X2": [_f((4, 1), 28)]}, {"margin": 0.1}),
    ("bpr_loss", "bpr_loss",
     {"X": [_probs((4, 6), 29)], "Label": [_ints(0, 6, (4, 1), 30)]}, {}),
    ("teacher_student_sigmoid_loss", "teacher_student_sigmoid_loss",
     {"X": [_f((6, 1), 31, 12.0)],
      "Label": [np.array([[0.], [1.], [0.3], [-0.4], [1.7], [2.5]],
                         np.float32)]},
     {"soft_max_up_bound": 15.0, "soft_max_lower_bound": -15.0}),
    ("dice_loss_op", "dice_loss_op",
     {"X": [_probs((3, 4, 5), 32)],
      "Label": [_ints(0, 2, (3, 4, 5), 33).astype(np.float32)]},
     {"epsilon": 1e-5}),
    ("selu", "selu", {"X": [_f((4, 6), 34)]},
     {"scale": 1.0507009873554805, "alpha": 1.6732632423543772}),
    ("add_position_encoding", "add_position_encoding",
     {"X": [_f((2, 5, 6), 35)]}, {"alpha": 0.5, "beta": 2.0}),
    ("data_norm", "data_norm",
     {"X": [_f((4, 3), 36)],
      "BatchSize": [1e4 + np.abs(_f((3,), 37, 100.0))],
      "BatchSum": [_f((3,), 38, 50.0)],
      "BatchSquareSum": [1e4 + np.abs(_f((3,), 39, 100.0))]}, {}),
    ("mean_iou", "mean_iou",
     {"Predictions": [_ints(0, 4, (2, 8), 40)],
      "Labels": [_ints(0, 4, (2, 8), 41)]}, {"num_classes": 5}),
    ("hash_one", "hash",
     {"X": [_i([[0], [1], [12345], [-7], [2 ** 31 - 1]])]},
     {"num_hash": 1, "mod_by": 1000}),
    ("hash_two", "hash", {"X": [_ints(-10 ** 9, 10 ** 9, (6, 2), 42)]},
     {"num_hash": 2, "mod_by": 100000}),
    ("ctc_greedy_decoder_collapse", "ctc_greedy_decoder", {"Input": [_CTC]},
     {"blank": 0}),
    ("ctc_greedy_decoder", "ctc_greedy_decoder",
     {"Input": [np.round(_f((3, 9, 4), 43))]}, {"blank": 0}),
    ("ctc_greedy_decoder_blank_last", "ctc_greedy_decoder",
     {"Input": [_f((2, 7, 5), 44)]}, {"blank": 4}),
    ("isinf_true", "isinf", {"X": [_INF]}, {}),
    ("isinf_false", "isinf", {"X": [_NAN]}, {}),
    ("isnan_true", "isnan", {"X": [_NAN]}, {}),
    ("isnan_false", "isnan", {"X": [_INF]}, {}),
    ("isfinite_reduce_true", "isfinite_reduce", {"X": [_f((3, 4), 45)]},
     {}),
    ("isfinite_reduce_false", "isfinite_reduce", {"X": [_NAN]}, {}),
    ("is_empty_false", "is_empty", {"X": [_f((2, 3), 46)]}, {}),
    ("is_empty_true", "is_empty", {"X": [np.zeros((0, 3), np.float32)]},
     {}),
    ("grid_sampler", "grid_sampler",
     {"X": [_f((2, 3, 5, 6), 47)],
      "Grid": [np.random.RandomState(48).uniform(
          -1.3, 1.3, (2, 4, 3, 2)).astype(np.float32)]}, {}),
    ("affine_grid", "affine_grid", {"Theta": [_f((2, 2, 3), 49)]},
     {"output_shape": [2, 3, 4, 5]}),
    ("psroi_pool", "psroi_pool",
     {"X": [_f((2, 8, 6, 7), 50)],
      "ROIs": [np.array([[0, 0, 12, 10], [2, 3, 9, 11], [4.5, 1, 5, 2.2]],
                        np.float32)],
      "RoisBatchIdx": [_i([0, 1, 1])]},
     {"output_channels": 2, "pooled_height": 2, "pooled_width": 2,
      "spatial_scale": 0.5}),
    ("psroi_pool_no_batch_idx", "psroi_pool",
     {"X": [_f((1, 27, 8, 8), 51)],
      "ROIs": [np.array([[0, 0, 7, 7], [1, 2, 30, 5]], np.float32)]},
     {"output_channels": 3, "pooled_height": 3, "pooled_width": 3,
      "spatial_scale": 1.0}),
    ("tree_conv", "tree_conv",
     {"NodesVector": [_f((3, 10, 5), 52)], "EdgeSet": [_tree_edges()],
      "Filter": [_f((5, 3, 6, 2), 53)]}, {"max_depth": 2}),
    ("tree_conv_depth3", "tree_conv",
     {"NodesVector": [_f((3, 10, 4), 54)], "EdgeSet": [_tree_edges()],
      "Filter": [_f((4, 3, 3, 1), 55)]}, {"max_depth": 3}),
    ("conv3d", "conv3d",
     {"Input": [_f((2, 3, 5, 6, 6), 56)], "Filter": [_f((4, 3, 3, 3, 3), 57)]},
     {"strides": [1, 1, 1], "paddings": [1, 1, 1], "dilations": [1, 1, 1],
      "groups": 1}),
    ("conv3d_strided_grouped", "conv3d",
     {"Input": [_f((2, 4, 6, 7, 7), 58)], "Filter": [_f((6, 2, 2, 3, 3), 59)]},
     {"strides": [2, 1, 2], "paddings": [0, 1, 1], "dilations": [1, 2, 1],
      "groups": 2}),
    ("conv3d_transpose", "conv3d_transpose",
     {"Input": [_f((2, 4, 3, 3, 3), 63)],
      "Filter": [_f((4, 3, 3, 3, 3), 64)]},
     {"strides": [2, 2, 2], "paddings": [1, 1, 1], "groups": 1}),
    ("conv3d_transpose_unet", "conv3d_transpose",
     {"Input": [_f((2, 6, 2, 4, 4), 65)],
      "Filter": [_f((6, 3, 2, 2, 2), 66)]},
     {"strides": [2, 2, 2], "paddings": [0, 0, 0], "groups": 1}),
    ("conv3d_transpose_grouped_dilated", "conv3d_transpose",
     {"Input": [_f((1, 4, 3, 4, 3), 67)],
      "Filter": [_f((4, 2, 2, 3, 2), 68)]},
     {"strides": [1, 2, 3], "paddings": [0, 1, 1], "dilations": [2, 1, 1],
      "groups": 2}),
    ("pool3d_max_padded", "pool3d", {"X": [_f((2, 3, 5, 6, 6), 69)]},
     {"ksize": [3, 3, 3], "strides": [2, 2, 2], "paddings": [1, 1, 1],
      "pooling_type": "max"}),
    ("pool3d_max_ties", "pool3d", {"X": [_TIED]},
     {"ksize": [1, 2, 2], "strides": [1, 2, 2], "paddings": [0, 0, 0],
      "pooling_type": "max"}),
    ("pool3d_max_ties_overlap", "pool3d", {"X": [_TIED]},
     {"ksize": [2, 3, 3], "strides": [2, 2, 2], "paddings": [0, 1, 1],
      "pooling_type": "max"}),
    ("pool3d_avg_exclusive", "pool3d", {"X": [_f((2, 3, 5, 6, 6), 70)]},
     {"ksize": [2, 3, 3], "strides": [2, 2, 2], "paddings": [1, 1, 1],
      "pooling_type": "avg", "exclusive": True}),
    ("pool3d_avg_inclusive", "pool3d", {"X": [_f((2, 3, 5, 6, 6), 71)]},
     {"ksize": [2, 3, 3], "strides": [2, 2, 2], "paddings": [1, 1, 1],
      "pooling_type": "avg", "exclusive": False}),
    ("pool3d_global", "pool3d", {"X": [_f((2, 3, 4, 3, 5), 72)]},
     {"ksize": [1, 1, 1], "pooling_type": "avg", "global_pooling": True}),
    ("hierarchical_sigmoid", "hierarchical_sigmoid",
     {"X": [_f((5, 4), 73)], "W": [_f((6, 4), 74)],
      "Label": [_i([[0], [6], [3], [3], [5]])], "Bias": [_f((6, 1), 75)]},
     {"num_classes": 7}),
    ("hierarchical_sigmoid_pow2_no_bias", "hierarchical_sigmoid",
     {"X": [_f((6, 3), 76)], "W": [_f((7, 3), 77)],
      "Label": [_ints(0, 8, (6, 1), 78)]}, {"num_classes": 8}),
    ("print_op", "print_op", {"X": [_f((2, 3), 79)]}, {"message": "x:"}),
]


def _jax_value(v):
    return jnp.asarray(v)


def _run(side, op_type, ins, attrs, jit=True):
    """One run of ``side``'s lowering of ``op_type``: {slot: [numpy]}."""
    names = {s: ["x"] * len(v) for s, v in ins.items()}
    if side == "jax":
        ctx = JLowerContext(JOpDesc(op_type, names, {}, attrs), None,
                            rng_key=jax.random.PRNGKey(0), op_index=0)

        def lower(jins):
            return JOpRegistry.get(op_type).lower(ctx, jins, attrs)

        outs = (jax.jit(lower) if jit else lower)(
            {s: [jnp.asarray(a) for a in v] for s, v in ins.items()})
        return {s: [np.asarray(x) for x in v] for s, v in outs.items()}
    ctx = TLowerContext(TOpDesc(op_type, names, {}, attrs), None, "cpu",
                        rng_seed=(0, 1), op_index=0)
    outs = TOpRegistry.get(op_type).lower(
        ctx, {s: [torch.from_numpy(np.array(a)) for a in v]
              for s, v in ins.items()}, attrs)
    return {s: [x.numpy() for x in v] for s, v in outs.items()}


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=what)
    fin = np.isfinite(want)
    scale = float(np.abs(want[fin]).max()) if fin.any() else 0.0
    err = float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0
    assert err <= REL_TO_MAX * scale, (what, err, scale)


def _compare(want, got):
    assert sorted(got) == sorted(want)
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for k, (g, w) in enumerate(zip(got[slot], want[slot])):
            _close(g, w, "%s[%d]" % (slot, k))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_lowering_matches_reference(case):
    _, op_type, ins, attrs = case
    _compare(_run("jax", op_type, ins, attrs),
             _run("torch", op_type, ins, attrs))


def _primals(op_type, ins):
    """(slot, index) of each input the grad flows to: floats outside the
    op's ``no_grad_inputs``."""
    skip = TOpRegistry.get(op_type).no_grad_inputs
    return [(s, i) for s in sorted(ins) if s not in skip
            for i, v in enumerate(ins[s])
            if np.issubdtype(np.asarray(v).dtype, np.floating)]


def _vjp_pair(op_type, ins, attrs, jax_lower=None):
    """(JAX grads, port grads) of the float inputs outside
    ``no_grad_inputs``, on one seeded cotangent for every float output:
    ``jax.vjp`` of the reference's lowering (or ``jax_lower``) against
    ``torch.func.vjp`` of the port's."""
    primals = _primals(op_type, ins)
    names = {s: ["x"] * len(v) for s, v in ins.items()}
    outs = _run("torch", op_type, ins, attrs)
    out_keys = [(s, i) for s in sorted(outs) for i, v in enumerate(outs[s])
                if np.issubdtype(v.dtype, np.floating)]
    cots = [_f(outs[s][i].shape, 90 + k) for k, (s, i) in enumerate(out_keys)]
    jlower = jax_lower or JOpRegistry.get(op_type).lower

    def jfwd(*xs):
        jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
        for (s, i), x in zip(primals, xs):
            jins[s][i] = x
        ctx = JLowerContext(JOpDesc(op_type, names, {}, attrs), None,
                            rng_key=jax.random.PRNGKey(0), op_index=0)
        out = jlower(ctx, jins, attrs)
        return tuple(out[s][i] for s, i in out_keys)

    def tfwd(*xs):
        tins = {s: [torch.from_numpy(np.array(a)) for a in v]
                for s, v in ins.items()}
        for (s, i), x in zip(primals, xs):
            tins[s][i] = x
        ctx = TLowerContext(TOpDesc(op_type, names, {}, attrs), None, "cpu",
                            rng_seed=(0, 1), op_index=0)
        out = TOpRegistry.get(op_type).lower(ctx, tins, attrs)
        return tuple(out[s][i] for s, i in out_keys)

    want = jax.jit(lambda xs, cs: jax.vjp(jfwd, *xs)[1](cs))(
        [jnp.asarray(ins[s][i]) for s, i in primals],
        tuple(jnp.asarray(c) for c in cots))
    _, tvjp = torch.func.vjp(
        tfwd, *[torch.from_numpy(np.array(ins[s][i])) for s, i in primals])
    got = tvjp(tuple(torch.from_numpy(c) for c in cots))
    return primals, [np.asarray(w) for w in want], [g.numpy() for g in got]


VJP_CASES = [c for c in CASES
             if TOpRegistry.get(c[1]).grad_maker is not None
             and _primals(c[1], c[2])]


@pytest.mark.parametrize("case", VJP_CASES, ids=[c[0] for c in VJP_CASES])
def test_vjp_grad_matches_reference(case):
    """The grads the engine derives for the op (``torch.func.vjp`` of the
    port's lowering) against ``jax.vjp`` of the reference's."""
    _, op_type, ins, attrs = case
    primals, want, got = _vjp_pair(op_type, ins, attrs)
    for (s, i), g, w in zip(primals, got, want):
        _close(g, w, "%s@GRAD" % s)


# -- nce through the port's negatives -----------------------------------------

_NCE_INS = {"Input": [_f((6, 4), 80)], "Label": [_ints(0, 11, (6, 1), 81)],
            "Weight": [_f((11, 4), 82)], "Bias": [_f((11, 1), 83)]}
_NCE_ATTRS = {"num_total_classes": 11, "num_neg_samples": 5, "seed": 0}


def _jax_nce_drawing(neg):
    """The JAX package's nce lowering with its draw patched to return
    ``neg`` (the port's negatives), its file untouched."""
    def lower(ctx, ins, attrs):
        real = jax.random.randint
        jax.random.randint = lambda key, shape, lo, hi: jnp.asarray(neg)
        try:
            return j_misc.nce(ctx, ins, attrs)
        finally:
            jax.random.randint = real
    return lower


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_nce_matches_reference_through_the_ports_negatives(bias):
    ins = dict(_NCE_INS) if bias else {
        k: v for k, v in _NCE_INS.items() if k != "Bias"}
    got = _run("torch", "nce", ins, _NCE_ATTRS)
    neg = got["SampleLabels"][0][:, 1:]
    assert neg.min() >= 0 and neg.max() < 11
    np.testing.assert_array_equal(got["SampleLabels"][0][:, 0],
                                  ins["Label"][0].reshape(-1))
    names = {s: ["x"] * len(v) for s, v in ins.items()}
    ctx = JLowerContext(JOpDesc("nce", names, {}, _NCE_ATTRS), None,
                        rng_key=jax.random.PRNGKey(0), op_index=0)
    want = _jax_nce_drawing(neg)(
        ctx, {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        _NCE_ATTRS)
    _compare({s: [np.asarray(x) for x in v] for s, v in want.items()}, got)
    primals, jg, tg = _vjp_pair("nce", ins, _NCE_ATTRS,
                                jax_lower=_jax_nce_drawing(neg))
    assert {s for s, _ in primals} == ({"Input", "Weight", "Bias"} if bias
                                       else {"Input", "Weight"})
    for (s, i), g, w in zip(primals, tg, jg):
        _close(g, w, "%s@GRAD" % s)


def test_nce_negatives_fresh_per_seed_and_equal_for_the_same():
    """The negatives are a function of the op's seed alone: the same
    (seed, run, op) draws the same ids, another run or op other ones."""
    def draw(run, op_index):
        op = TOpDesc("nce", {s: ["x"] for s in _NCE_INS}, {}, _NCE_ATTRS)
        ctx = TLowerContext(op, None, "cpu", rng_seed=(3, run),
                            op_index=op_index)
        ins = {s: [torch.from_numpy(v[0])] for s, v in _NCE_INS.items()}
        return TOpRegistry.get("nce").lower(ctx, ins, _NCE_ATTRS)[
            "SampleLabels"][0]

    a = draw(1, 0)
    assert torch.equal(a, draw(1, 0))
    assert not torch.equal(a, draw(2, 0))
    assert not torch.equal(a, draw(1, 1))


# -- the ops the JAX package raises in ----------------------------------------


def test_hash_raises_from_three_hashes_in_both_packages():
    """``k * 0x85EBCA6B`` does not fit a uint32 from k = 2 on: both
    packages raise OverflowError at ``num_hash`` 3."""
    ins = {"X": [_i([[1], [2]])]}
    attrs = {"num_hash": 3, "mod_by": 100}
    with pytest.raises(OverflowError):
        _run("jax", "hash", ins, attrs)
    with pytest.raises(OverflowError):
        _run("torch", "hash", ins, attrs)


def test_add_position_encoding_raises_at_odd_width_in_both_packages():
    ins = {"X": [_f((2, 3, 5), 84)]}
    with pytest.raises((TypeError, ValueError)):
        _run("jax", "add_position_encoding", ins, {})
    with pytest.raises(ValueError):
        _run("torch", "add_position_encoding", ins, {})


def test_affine_grid_reads_an_output_shape_tensor():
    """Without the attr the port reads the ``OutputShape`` tensor (the JAX
    package does too, outside jit): the same grid as from the attr."""
    theta = _f((2, 2, 3), 85)
    want = _run("jax", "affine_grid", {"Theta": [theta]},
                {"output_shape": [2, 3, 4, 5]})
    got = _run("torch", "affine_grid", {
        "Theta": [theta], "OutputShape": [np.array([2, 3, 4, 5], np.int32)]},
        {})
    _compare(want, got)
    eager = _run("jax", "affine_grid", {
        "Theta": [theta], "OutputShape": [np.array([2, 3, 4, 5], np.int32)]},
        {}, jit=False)
    _compare(eager, got)


def test_affine_grid_with_a_shape_tensor_is_not_captured():
    info = TOpRegistry.get("affine_grid")
    with_attr = TOpDesc("affine_grid", {"Theta": ["t"]}, {"Output": ["o"]},
                        {"output_shape": [1, 1, 2, 2]})
    with_tensor = TOpDesc("affine_grid", {"Theta": ["t"],
                                          "OutputShape": ["s"]},
                          {"Output": ["o"]}, {})
    assert info.capturable(with_attr) and not info.capturable(with_tensor)


# -- the host ops ------------------------------------------------------------


def test_py_func_and_its_grad_match_reference():
    """``py_func`` and ``py_func_grad`` call the same Python on host
    arrays in both packages; an absent output grad arrives as zeros."""
    seen = []

    def fwd(a, b):
        return a * b, a + 1.0

    def bwd(a, b, d1, d2):
        seen.append(np.asarray(d2).copy())
        return d1 * b + d2, d1 * a

    ins = {"X": [_f((2, 3), 86), _f((2, 3), 87)]}
    out_d = {"out_shapes": [[2, 3], [2, 3]],
             "out_dtypes": ["float32", "float32"]}
    for side, mod in (("jax", j_misc), ("torch", t_misc)):
        attrs = dict(out_d, func_id=mod.register_py_func(fwd),
                     backward_func_id=mod.register_py_func(bwd))
        if side == "jax":
            want = _run(side, "py_func", ins, attrs, jit=False)
        else:
            got = _run(side, "py_func", ins, attrs)
        grad_ins = dict(ins, **{"Out@GRAD": [_f((2, 3), 88), None]})
        names = {s: ["x"] * len(v) for s, v in grad_ins.items()}
        if side == "jax":
            ctx = JLowerContext(JOpDesc("py_func_grad", names, {}, attrs),
                                None, op_index=0)
            jg = JOpRegistry.get("py_func_grad").lower(ctx, {
                s: [None if a is None else jnp.asarray(a) for a in v]
                for s, v in grad_ins.items()}, attrs)["X@GRAD"]
        else:
            ctx = TLowerContext(TOpDesc("py_func_grad", names, {}, attrs),
                                None, "cpu")
            tg = TOpRegistry.get("py_func_grad").lower(ctx, {
                s: [None if a is None else torch.from_numpy(a) for a in v]
                for s, v in grad_ins.items()}, attrs)["X@GRAD"]
    _compare(want, got)
    for g, w in zip(tg, jg):
        _close(g.numpy(), np.asarray(w), "X@GRAD")
    assert all(not s.any() for s in seen) and len(seen) == 2


def test_py_func_ids_count_from_zero_and_reuse_a_callable():
    def f(x):
        return x

    fid = t_misc.register_py_func(f)
    assert t_misc.register_py_func(f) == fid
    assert t_misc._PY_FUNC_REGISTRY[fid] is f
    assert sorted(t_misc._PY_FUNC_REGISTRY) == list(
        range(len(t_misc._PY_FUNC_REGISTRY)))


def test_host_ops_are_not_captured():
    for op_type in ("print_op", "py_func", "py_func_grad"):
        assert TOpRegistry.get(op_type).capturable is False, op_type


def test_print_op_prints_and_passes_through(capsys):
    x = _f((2, 2), 89)
    out = _run("torch", "print_op", {"X": [x]}, {"message": "probe"})
    np.testing.assert_array_equal(out["Out"][0], x)
    assert capsys.readouterr().out.startswith("probe [[")


def test_load_value_reads_npy_and_the_reference_stream(tmp_path):
    """``load_value`` reads a ``.npy`` file and one the reference's save
    op wrote (the JAX package's writer), as the JAX lowering does, in
    float16 too."""
    from paddle_tpu import compat

    arr = _f((4, 3), 90)
    npy = str(tmp_path / "w.npy")
    np.save(npy, arr)
    ref = str(tmp_path / "w_ref")
    compat.save_reference_var(arr * 2.0, ref)
    ints = str(tmp_path / "ids_ref")
    compat.save_reference_var(_ints(0, 50, (2, 5), 91), ints)
    for path, fp16 in ((npy, False), (ref, False), (npy, True),
                       (ints, False)):
        attrs = {"file_path": path, "load_as_fp16": fp16}
        want = _run("jax", "load_value", {}, attrs, jit=False)
        got = _run("torch", "load_value", {}, attrs)
        if fp16:
            assert got["Out"][0].dtype == np.float16
        _compare(want, got)


# -- the random ops, by their contract ----------------------------------------


def _draw(op_type, ins, attrs, run=1, op_index=0, seed=3):
    op = TOpDesc(op_type, {s: ["x"] for s in ins}, {"Out": ["o"]}, attrs)
    ctx = TLowerContext(op, None, "cpu", rng_seed=(seed, run),
                        op_index=op_index)
    return TOpRegistry.get(op_type).lower(
        ctx, {s: [torch.from_numpy(v)] for s, v in ins.items()},
        attrs)["Out"][0]


def _fresh_per_stream(op_type, ins, attrs):
    a = _draw(op_type, ins, attrs)
    assert torch.equal(a, _draw(op_type, ins, attrs))
    assert not torch.equal(a, _draw(op_type, ins, attrs, run=2))
    assert not torch.equal(a, _draw(op_type, ins, attrs, op_index=1))
    return a


def test_sampling_id_draws_by_the_probabilities():
    p = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    x = np.tile(p, (4000, 1))
    want = _run("jax", "sampling_id", {"X": [x[:3]]}, {})["Out"][0]
    ids = _fresh_per_stream("sampling_id", {"X": x}, {}).numpy()
    assert ids.shape == (4000,) and ids.dtype == np.int64
    assert want.shape == (3,)
    freq = np.bincount(ids, minlength=4) / 4000.0
    assert freq[1] == 0.0
    np.testing.assert_allclose(freq, p, atol=0.03)


def test_random_crop_is_a_slice_at_an_in_range_offset():
    x = np.arange(2 * 3 * 7 * 9, dtype=np.float32).reshape(2, 3, 7, 9)
    attrs = {"shape": [4, 5]}
    want = _run("jax", "random_crop", {"X": [x]}, attrs)["Out"][0]
    out = _fresh_per_stream("random_crop", {"X": x}, attrs).numpy()
    assert out.shape == want.shape == (2, 3, 4, 5)
    offsets = set()
    for seed in range(40):
        got = _draw("random_crop", {"X": x}, attrs, seed=seed).numpy()
        i, j = divmod(int(got[0, 0, 0, 0]), 9)
        assert 0 <= i <= 3 and 0 <= j <= 4
        np.testing.assert_array_equal(got, x[:, :, i:i + 4, j:j + 5])
        offsets.add((i, j))
    assert len(offsets) > 5


@pytest.mark.parametrize("op_type", ["uniform_random_batch_size_like",
                                     "gaussian_random_batch_size_like"])
def test_batch_size_like_draws_take_the_batch_and_their_law(op_type):
    ref = np.zeros((3000, 2), np.float32)
    attrs = {"shape": [-1, 7], "input_dim_idx": 0, "output_dim_idx": 0,
             "min": -0.5, "max": 0.25, "mean": 1.0, "std": 2.0, "seed": 0}
    want = _run("jax", op_type, {"Input": [ref]}, attrs)["Out"][0]
    out = _fresh_per_stream(op_type, {"Input": ref}, attrs).numpy()
    assert out.shape == want.shape == (3000, 7)
    assert out.dtype == want.dtype == np.float32
    if op_type.startswith("uniform"):
        assert out.min() >= -0.5 and out.max() < 0.25
        assert abs(out.mean() - (-0.125)) < 0.01
    else:
        assert abs(out.mean() - 1.0) < 0.05 and abs(out.std() - 2.0) < 0.05
    assert np.isfinite(out).all()


# every lowering this file holds
SLICE_OPS = {c[1] for c in CASES} | {
    "nce", "sampling_id", "random_crop", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "py_func", "py_func_grad",
    "load_value"}


def test_slice_holds_the_forty_ops():
    assert len(SLICE_OPS) == 40


def test_registration_matches_the_reference():
    """The ops the JAX package registers without a grad have none in the
    port either; those with one have the same ``no_grad_inputs``; those
    that draw random numbers draw them in both."""
    for op_type in SLICE_OPS:
        j, t = JOpRegistry.get(op_type), TOpRegistry.get(op_type)
        assert (j.grad_maker is None) == (t.grad_maker is None), op_type
        assert j.needs_rng == t.needs_rng, op_type
        if t.grad_maker is not None:
            assert j.no_grad_inputs == t.no_grad_inputs, op_type
    for op_type in ("nce", "sampling_id", "random_crop",
                    "uniform_random_batch_size_like",
                    "gaussian_random_batch_size_like"):
        info = TOpRegistry.get(op_type)
        assert info.capturable is True and info.seed_range({}), op_type


# a tensor built from host data (``torch.tensor``), a read of a device
# value on the host, and a shape that depends on the data: none of them
# can run while a CUDA graph is being captured
_UNCAPTURABLE_ATEN = ("aten.lift_fresh", "aten._local_scalar_dense",
                      "aten.nonzero", "aten.item")


@pytest.mark.parametrize("op_type,ins,attrs", [
    ("nce", {"Input": _f((6, 4), 95), "Label": _ints(0, 9, (6, 1), 96),
             "Weight": _f((9, 4), 97), "Bias": _f((9,), 98)},
     {"num_neg_samples": 3, "num_total_classes": 9}),
    ("sampling_id", {"X": np.full((5, 4), 0.25, np.float32)}, {}),
    ("random_crop", {"X": _f((2, 3, 7, 9), 99)}, {"shape": [4, 5]}),
    ("uniform_random_batch_size_like", {"Input": _f((5, 2), 100)},
     {"shape": [-1, 3], "min": -0.5, "max": 0.25}),
    ("gaussian_random_batch_size_like", {"Input": _f((5, 2), 101)},
     {"shape": [-1, 3], "mean": 1.0, "std": 2.0}),
])
def test_captured_random_ops_stay_on_the_device(op_type, ins, attrs):
    """Each random op registered capturable, run as an engine run runs it
    (its seed a 0-d tensor of the run's seed table), dispatches no op
    that a CUDA graph capture refuses."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    op = TOpDesc(op_type, {s: ["x"] for s in ins}, {"Out": ["o"]}, attrs)
    ctx = TLowerContext(op, None, "cpu", seeds={0: torch.tensor(
        1234567, dtype=torch.int64)})
    tins = {s: [torch.from_numpy(v)] for s, v in ins.items()}
    with Record() as rec:
        out = TOpRegistry.get(op_type).lower(ctx, tins, attrs)
    assert out and rec.names
    bad = [n for n in rec.names if n.startswith(_UNCAPTURABLE_ATEN)]
    assert not bad, (op_type, bad)


def test_gathers_add_their_grads_back_by_take():
    """``nce``'s and ``hierarchical_sigmoid``'s weight grads with
    repeated ids (every path through the root) sum each id's rows, as a
    dense reference does."""
    x = torch.from_numpy(_f((64, 3), 92))
    w = torch.from_numpy(_f((7, 3), 93))
    label = torch.from_numpy(_ints(0, 8, (64, 1), 94))
    attrs = {"num_classes": 8}
    ctx = TLowerContext(TOpDesc("hierarchical_sigmoid", {}, {}, attrs), None,
                        "cpu")

    def loss(w_):
        return TOpRegistry.get("hierarchical_sigmoid").lower(
            ctx, {"X": [x], "W": [w_], "Label": [label]}, attrs)["Out"][0]

    (g,) = torch.func.grad(lambda w_: loss(w_).sum())(w),
    w_ref = w.clone().requires_grad_(True)
    node = label.reshape(-1) + 8
    total = torch.zeros(())
    for _ in range(3):
        parent = node // 2
        s = (x * w_ref[parent - 1]).sum(1)
        total = total + torch.where(node > 1, torch.logaddexp(
            torch.zeros_like(s), s) - (node % 2).float() * s, 0.0).sum()
        node = parent
    total.backward()
    torch.testing.assert_close(g, w_ref.grad, rtol=1e-5, atol=1e-6)
    assert math.isclose(float(loss(w).sum()), float(total), rel_tol=1e-5)
