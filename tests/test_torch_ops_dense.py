"""The dense op families (ROADMAP Queue 1, step 5c) against the JAX
package's lowerings, on the same random inputs (numpy, seeded), through
each package's registry and LowerContext (``_run_jax``/``_run_torch`` of
test_torch_ops.py): the 18 tensor ops, the 9 image ops of nn_ops, the 6
regression and margin losses, ``auc``, ``precision_recall`` and
``chunk_eval``, and ``elementwise_mod``/``elementwise_floordiv`` with
negative operands.

Tolerances: float32 outputs and grads rtol 1e-5 / atol 1e-6 (the same
formulas, summed in other orders); integer and boolean outputs exact,
by value (the JAX package runs with 64-bit types off, so its int64
outputs come back int32). Grads: for every op that has one, ``jax.vjp``
of the reference's lowering against ``torch.func.vjp`` of the port's, the
float inputs outside ``no_grad_inputs`` as primals and one seeded
cotangent for every float output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import (LowerContext as JLowerContext,
                                      OpRegistry as JOpRegistry)

from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry)

from test_torch_ops import _run_jax, _run_torch

RTOL, ATOL = 1e-5, 1e-6


def _f(shape, seed, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _ties(shape, seed):
    """Values on a coarse grid: ties in every row."""
    return np.round(_f(shape, seed, 1.5)).astype(np.float32)


def _i(values):
    return np.asarray(values, np.int64)


def _probs(shape, seed):
    p = np.abs(_f(shape, seed)) + 0.05
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


_IMG = _f((2, 2, 4, 5), 10)
_STAT = np.random.RandomState(11).randint(0, 4, 16).astype(np.int64)
_PR_PRED = np.random.RandomState(12).randint(0, 4, (9, 1)).astype(np.int64)
_PR_LAB = np.random.RandomState(13).randint(0, 4, (9, 1)).astype(np.int64)


def _tags(num_tag, num_types, seed, shape=(3, 9)):
    """Random tags of ``num_types`` chunk types, outside labels among
    them."""
    return np.random.RandomState(seed).randint(
        0, num_types * num_tag + 1, shape).astype(np.int64)


def _chunk_cases():
    cases = []
    for scheme, num_tag in (("plain", 1), ("IOB", 2), ("IOE", 2),
                            ("IOBES", 4)):
        ins = {"Inference": [_tags(num_tag, 3, 20 + num_tag)],
               "Label": [_tags(num_tag, 3, 30 + num_tag)]}
        attrs = {"chunk_scheme": scheme, "num_chunk_types": 3}
        cases.append(("chunk_eval_" + scheme, "chunk_eval", ins, attrs))
    label = _tags(2, 2, 41, (2, 10, 1))
    inference = label.copy()
    inference[0, 3:5] = 1  # one chunk cut differently
    cases.append(("chunk_eval_IOB_lens_excluded", "chunk_eval",
                  {"Inference": [inference], "Label": [label],
                   "SeqLength": [_i([7, 10])]},
                  {"chunk_scheme": "IOB", "num_chunk_types": 2,
                   "excluded_chunk_types": [1]}))
    cases.append(("chunk_eval_IOBES_lens", "chunk_eval",
                  {"Inference": [_tags(4, 2, 42)], "Label": [_tags(4, 2, 42)],
                   "SeqLength": [_i([9, 4, 1])]},
                  {"chunk_scheme": "IOBES", "num_chunk_types": 2}))
    return cases


# (id, op type, {slot: [numpy arrays]}, attrs)
CASES = [
    # tensor_ops
    ("fill_zeros_like", "fill_zeros_like", {"X": [_f((3, 4), 0)]}, {}),
    ("reshape", "reshape", {"X": [_f((2, 6, 8), 1)]}, {"shape": [0, -1, 4]}),
    ("transpose", "transpose", {"X": [_f((2, 3, 4), 2)]},
     {"axis": [2, 0, 1]}),
    ("squeeze2_axes", "squeeze2", {"X": [_f((3, 1, 4, 1), 3)]},
     {"axes": [1, 3]}),
    ("squeeze2_all", "squeeze2", {"X": [_f((1, 3, 1, 4), 4)]}, {"axes": []}),
    ("stack", "stack", {"X": [_f((2, 4), 5), _f((2, 4), 6), _f((2, 4), 7)]},
     {"axis": 1}),
    ("stack_last", "stack", {"X": [_f((2, 3), 8), _f((2, 3), 9)]},
     {"axis": -1}),
    ("unstack", "unstack", {"X": [_f((3, 2, 4), 10)]}, {"axis": 1}),
    ("gather_repeats", "gather",
     {"X": [_f((7, 3), 11)], "Index": [_i([1, 3, 1, 6, 0, 1])]}, {}),
    ("gather_rank3", "gather",
     {"X": [_f((6, 2, 3), 12)], "Index": [_i([5, 0, 2, 2])]}, {}),
    ("scatter_overwrite", "scatter",
     {"X": [_f((6, 3), 13)], "Ids": [_i([4, 0, 2])],
      "Updates": [_f((3, 3), 14)]}, {"overwrite": True}),
    ("scatter_add_duplicates", "scatter",
     {"X": [_f((6, 3), 15)], "Ids": [_i([1, 4, 1, 1])],
      "Updates": [_f((4, 3), 16)]}, {"overwrite": False}),
    ("shape", "shape", {"Input": [_f((2, 3, 5), 17)]}, {}),
    ("arg_max_ties", "arg_max", {"X": [_ties((4, 7), 18)]}, {"axis": -1}),
    ("arg_max_axis0", "arg_max", {"X": [_ties((4, 7), 19)]}, {"axis": 0}),
    ("arg_min_ties", "arg_min", {"X": [_ties((4, 7), 20)]}, {"axis": 1}),
    ("argsort_stable", "argsort", {"X": [_ties((3, 8), 21)]}, {"axis": -1}),
    ("argsort_axis0", "argsort", {"X": [_ties((5, 3), 22)]}, {"axis": 0}),
    ("range_int", "range",
     {"Start": [_i([1])], "End": [_i([10])], "Step": [_i([3])]}, {}),
    ("range_float", "range",
     {"Start": [np.array([0.5], np.float32)],
      "End": [np.array([2.0], np.float32)],
      "Step": [np.array([0.25], np.float32)]}, {}),
    ("pad", "pad", {"X": [_f((2, 3), 23)]},
     {"paddings": [1, 0, 0, 2], "pad_value": 1.5}),
    ("pad2d_constant", "pad2d", {"X": [_IMG]},
     {"paddings": [1, 2, 2, 1], "mode": "constant", "pad_value": -0.5}),
    ("pad2d_reflect", "pad2d", {"X": [_IMG]},
     {"paddings": [1, 2, 3, 1], "mode": "reflect"}),
    ("pad2d_edge", "pad2d", {"X": [_IMG]},
     {"paddings": [2, 0, 1, 3], "mode": "edge"}),
    ("isfinite", "isfinite", {"X": [_f((2, 3), 24), _f((4,), 25)]}, {}),
    ("isfinite_inf", "isfinite",
     {"X": [_f((2, 3), 26), np.array([1.0, np.inf], np.float32)]}, {}),
    ("cumsum", "cumsum", {"X": [_f((3, 5), 27)]}, {"axis": 1}),
    ("cumsum_exclusive", "cumsum", {"X": [_f((3, 5), 28)]},
     {"axis": -1, "exclusive": True}),
    ("cumsum_reverse_axis0", "cumsum", {"X": [_f((4, 3), 29)]},
     {"axis": 0, "reverse": True}),
    ("cumsum_exclusive_reverse", "cumsum", {"X": [_f((3, 5), 30)]},
     {"axis": 1, "exclusive": True, "reverse": True}),
    ("reverse", "reverse", {"X": [_f((2, 3, 4), 31)]}, {"axis": [0, 2]}),
    ("reverse_int_axis", "reverse", {"X": [_f((2, 3), 32)]}, {"axis": 1}),
    # nn_ops
    ("conv2d_transpose", "conv2d_transpose",
     {"Input": [_f((2, 3, 5, 5), 40)], "Filter": [_f((3, 2, 4, 4), 41)]},
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
      "groups": 1}),
    ("conv2d_transpose_grouped_dilated", "conv2d_transpose",
     {"Input": [_f((2, 4, 4, 5), 42)], "Filter": [_f((4, 3, 3, 2), 43)]},
     {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1],
      "groups": 2}),
    ("lrn", "lrn", {"X": [_f((2, 6, 3, 3), 44)]},
     {"n": 5, "k": 2.0, "alpha": 0.1, "beta": 0.75}),
    ("lrn_n3", "lrn", {"X": [_f((1, 4, 2, 3), 45)]},
     {"n": 3, "k": 1.0, "alpha": 0.5, "beta": 0.5}),
    ("l2_normalize", "l2_normalize", {"X": [_f((3, 5), 46)]},
     {"axis": -1, "epsilon": 1e-12}),
    ("l2_normalize_axis0_floor", "l2_normalize",
     {"X": [np.concatenate([_f((3, 2), 47), np.zeros((3, 1), np.float32)
                            + 1e-4], 1)]}, {"axis": 0, "epsilon": 1e-3}),
    ("norm", "norm", {"X": [_f((3, 5), 48)]}, {"axis": 1, "epsilon": 1e-10}),
    ("group_norm", "group_norm",
     {"X": [_f((2, 6, 3, 3), 49)], "Scale": [_f((6,), 50)],
      "Bias": [_f((6,), 51)]}, {"groups": 3, "epsilon": 1e-5}),
    ("group_norm_n1_g1_noaffine", "group_norm",
     {"X": [_f((1, 4, 2, 2), 52)]}, {"groups": 1, "epsilon": 1e-5}),
    ("bilinear_align_corners", "bilinear_interp", {"X": [_IMG]},
     {"out_h": 7, "out_w": 9, "align_corners": True, "align_mode": 1}),
    ("bilinear_align_mode1", "bilinear_interp", {"X": [_IMG]},
     {"out_h": 7, "out_w": 9, "align_corners": False, "align_mode": 1}),
    ("bilinear_half_pixel", "bilinear_interp", {"X": [_IMG]},
     {"out_h": 8, "out_w": 10, "align_corners": False, "align_mode": 0}),
    ("bilinear_down", "bilinear_interp", {"X": [_IMG]},
     {"out_h": 3, "out_w": 2, "align_corners": True, "align_mode": 1}),
    ("nearest_align_corners", "nearest_interp", {"X": [_IMG]},
     {"out_h": 7, "out_w": 9, "align_corners": True}),
    ("nearest_floor", "nearest_interp", {"X": [_IMG]},
     {"out_h": 7, "out_w": 9, "align_corners": False}),
    ("nearest_down", "nearest_interp", {"X": [_IMG]},
     {"out_h": 3, "out_w": 2, "align_corners": False}),
    ("prelu_all", "prelu",
     {"X": [_f((2, 3, 2, 2), 53)], "Alpha": [np.array([0.3], np.float32)]},
     {"mode": "all"}),
    ("prelu_channel", "prelu",
     {"X": [_f((2, 3, 2, 2), 54)], "Alpha": [_f((1, 3, 1, 1), 55)]},
     {"mode": "channel"}),
    ("prelu_element", "prelu",
     {"X": [_f((2, 3, 2, 2), 56)], "Alpha": [_f((1, 3, 2, 2), 57)]},
     {"mode": "element"}),
    ("maxout_ties", "maxout", {"X": [_ties((2, 6, 3, 3), 58)]},
     {"groups": 2}),
    ("maxout_3", "maxout", {"X": [_f((1, 6, 2, 2), 59)]}, {"groups": 3}),
    # loss_ops
    ("squared_l2_distance", "squared_l2_distance",
     {"X": [_f((4, 5), 60)], "Y": [_f((4, 5), 61)]}, {}),
    ("log_loss", "log_loss",
     {"Predicted": [_probs((6, 2), 62)[:, :1].copy()],
      "Labels": [np.array([[0], [1], [1], [0], [1], [0]], np.float32)]},
     {"epsilon": 1e-4}),
    ("huber_loss", "huber_loss",
     {"X": [_f((8, 1), 63)], "Y": [_f((8, 1), 64)]}, {"delta": 0.5}),
    ("smooth_l1_loss", "smooth_l1_loss",
     {"X": [_f((4, 3), 65)], "Y": [_f((4, 3), 66)]}, {"sigma": 2.0}),
    ("smooth_l1_loss_rank3", "smooth_l1_loss",
     {"X": [_f((3, 2, 2), 67)], "Y": [_f((3, 2, 2), 68)]}, {}),
    ("hinge_loss", "hinge_loss",
     {"Logits": [_f((6, 1), 69, 2.0)],
      "Labels": [np.array([[0], [1], [1], [0], [1], [0]], np.float32)]},
     {}),
] + [
    ("kldiv_loss_" + red, "kldiv_loss",
     {"X": [np.log(_probs((3, 5), 70))],
      "Target": [_probs((3, 5), 71) * (_f((3, 5), 72) > -0.5)]},
     {"reduction": red})
    for red in ("mean", "sum", "batchmean", "none")
] + [
    # math_ops: the floor modulo and floor quotient, negative operands,
    # no zero divisor
    ("elementwise_mod_int", "elementwise_mod",
     {"X": [_i([[7, -7, 5], [-3, 0, 9]])], "Y": [_i([[3, 3, -2], [-4, 5, 4]])]},
     {"axis": -1}),
    ("elementwise_mod_float_bcast", "elementwise_mod",
     {"X": [_f((2, 3), 73, 5.0)], "Y": [np.array([1.5, -2.25, 0.75],
                                                np.float32)]}, {"axis": 1}),
    ("elementwise_floordiv_int", "elementwise_floordiv",
     {"X": [_i([[7, -7, 5], [-3, 0, 9]])], "Y": [_i([[3, 3, -2], [-4, 5, 4]])]},
     {"axis": -1}),
    ("elementwise_floordiv_float", "elementwise_floordiv",
     {"X": [_f((2, 3), 74, 5.0)], "Y": [_f((2, 3), 75, 2.0) + 0.25]},
     {"axis": -1}),
    # metric_ops
    ("auc", "auc",
     {"Predict": [np.concatenate([1 - _probs((12, 2), 76)[:, 1:],
                                  _probs((12, 2), 76)[:, 1:]], 1)],
      "Label": [np.random.RandomState(77).randint(0, 2, (12, 1))],
      "StatPos": [_STAT], "StatNeg": [_STAT[::-1].copy()]},
     {"curve": "ROC", "num_thresholds": 15}),
    ("auc_one_class", "auc",
     {"Predict": [_probs((5, 2), 78)], "Label": [np.ones((5, 1), np.int64)],
      "StatPos": [np.zeros(8, np.int64)], "StatNeg": [np.zeros(8, np.int64)]},
     {"num_thresholds": 7}),
    ("precision_recall", "precision_recall",
     {"Indices": [_PR_PRED], "Labels": [_PR_LAB]}, {"class_number": 4}),
    ("precision_recall_weighted_states", "precision_recall",
     {"Indices": [_PR_PRED], "Labels": [_PR_LAB],
      "Weights": [np.abs(_f((9, 1), 79))],
      "StatesInfo": [np.abs(_f((4, 4), 80, 3.0))]}, {"class_number": 4}),
] + _chunk_cases()

# every lowering this file holds
SLICE_OPS = {c[1] for c in CASES}


def _compare(want, got):
    assert sorted(got) == sorted(want)
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for g, w in zip(got[slot], want[slot]):
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            if slot == "XShape":
                continue  # shape-only carrier, no data
            if np.issubdtype(w.dtype, np.floating):
                assert g.dtype == w.dtype, (slot, g.dtype, w.dtype)
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=slot)
            else:
                np.testing.assert_array_equal(g, w, err_msg=slot)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_lowering_matches_reference(case):
    _, op_type, ins, attrs = case
    _compare(_run_jax(op_type, ins, attrs, False),
             _run_torch(op_type, ins, attrs, False))


def _primals(op_type, ins):
    """(slot, index) of each input the grad flows to: floats outside the
    op's ``no_grad_inputs``."""
    skip = TOpRegistry.get(op_type).no_grad_inputs
    return [(s, i) for s in sorted(ins) if s not in skip
            for i, v in enumerate(ins[s])
            if np.issubdtype(np.asarray(v).dtype, np.floating)]


VJP_CASES = [c for c in CASES
             if TOpRegistry.get(c[1]).grad_maker is not None
             and _primals(c[1], c[2])]


@pytest.mark.parametrize("case", VJP_CASES, ids=[c[0] for c in VJP_CASES])
def test_vjp_grad_matches_reference(case):
    """The grads the engine derives for the op (``torch.func.vjp`` of the
    port's lowering) against ``jax.vjp`` of the reference's, on seeded
    cotangents for every float output."""
    _, op_type, ins, attrs = case
    assert JOpRegistry.get(op_type).grad_maker is not None
    assert JOpRegistry.get(op_type).no_grad_inputs == \
        TOpRegistry.get(op_type).no_grad_inputs
    primals = _primals(op_type, ins)
    names = {s: ["x"] * len(v) for s, v in ins.items()}
    outs = _run_torch(op_type, ins, attrs, False)
    out_keys = [(s, i) for s in sorted(outs) for i, v in enumerate(outs[s])
                if np.issubdtype(v.dtype, np.floating)]
    cots = [_f(outs[s][i].shape, 90 + k) for k, (s, i) in enumerate(out_keys)]

    def jfwd(*xs):
        jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
        for (s, i), x in zip(primals, xs):
            jins[s][i] = x
        ctx = JLowerContext(JOpDesc(op_type, names, {}, attrs), None,
                            rng_key=jax.random.PRNGKey(0), op_index=0)
        out = JOpRegistry.get(op_type).lower(ctx, jins, attrs)
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

    _, jvjp = jax.vjp(jfwd, *[jnp.asarray(ins[s][i]) for s, i in primals])
    want = jvjp(tuple(jnp.asarray(c) for c in cots))
    _, tvjp = torch.func.vjp(
        tfwd, *[torch.from_numpy(np.array(ins[s][i])) for s, i in primals])
    got = tvjp(tuple(torch.from_numpy(c) for c in cots))
    for (s, i), g, w in zip(primals, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg="%s@GRAD" % s)


# the index ops whose grads add into a zero input (their CUDA path must
# not take float atomics, chip_smoke.py's dense_ops phase runs them twice)
SCATTER_GRAD_OPS = ("gather", "scatter", "pad2d", "bilinear_interp",
                    "nearest_interp", "maxout")


def _grad_nodes(fn):
    """The names of the autograd nodes behind ``fn()``'s outputs."""
    seen, names = set(), set()
    stack = [v.grad_fn for vs in fn().values() for v in vs
             if isinstance(v, torch.Tensor) and v.grad_fn is not None]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    return names


# grad nodes that add with float atomics on CUDA
_ATOMIC_GRADS = ("IndexSelectBackward", "IndexAddBackward", "GatherBackward",
                 "ReflectionPad2DBackward", "ReplicationPad2DBackward",
                 "UpsampleBilinear2DBackward", "UpsampleNearest2DBackward",
                 "EmbeddingBackward", "ScatterAddBackward")


@pytest.mark.parametrize("case", [c for c in VJP_CASES
                                  if c[1] in SCATTER_GRAD_OPS],
                         ids=[c[0] for c in VJP_CASES
                              if c[1] in SCATTER_GRAD_OPS])
def test_scatter_grads_take_the_sorted_path(case):
    """The grads of the index ops add through ``take`` (a sorted
    ``index_put_``) or are elementwise (``maxout``'s ``amax``): no node of
    their autograd graphs adds with float atomics on the card."""
    _, op_type, ins, attrs = case

    def run():
        tins = {s: [torch.from_numpy(np.array(a)) for a in v]
                for s, v in ins.items()}
        for s, i in _primals(op_type, ins):
            tins[s][i].requires_grad_(True)
        return TOpRegistry.get(op_type).lower(None, tins, attrs)

    names = _grad_nodes(run)
    assert not [n for n in names if n.startswith(_ATOMIC_GRADS)], names
    if op_type in ("gather", "pad2d", "bilinear_interp", "nearest_interp"):
        assert "_TakeBackward" in names or attrs.get("mode") == "constant", \
            names


def test_range_and_shape_read_shapes_not_data():
    """``range`` reads its bounds on the host, so the engine never captures
    it; ``shape`` is built by fills on the device and may be captured."""
    assert TOpRegistry.get("range").capturable is False
    assert TOpRegistry.get("shape").capturable is True
    out = _run_torch("shape", {"Input": [_f((2, 3, 5), 0)]}, {}, False)
    assert out["Out"][0].dtype == np.int32
