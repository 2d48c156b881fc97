"""The lowerings of the book programs and the unfused attention against
the JAX package's, on the same random inputs (numpy, seeded), through
each package's registry and LowerContext (``_run_jax``/``_run_torch`` of
test_torch_ops.py): ``matmul`` and ``matmul_grad`` (every transpose
combination, broadcast batch dims, rank-1 operands, ``alpha``), the
seven reduce ops, ``cross_entropy``, ``unsqueeze2``, ``expand`` and
``sequence_mask``.

Tolerances, float32: rtol 1e-5 / atol 1e-5, as in test_torch_ops.py (the
same formulas, summed in other orders); integer and boolean outputs
exact. The grads the engine derives by vjp (the reduce ops,
``cross_entropy``, ``expand``, ``unsqueeze2``) are held the same way:
``torch.func.vjp`` of the port's lowering against ``jax.vjp`` of the
reference's, on one cotangent. Under AMP (``amp_scope``) ``matmul`` and
``matmul_grad`` give the reference's dtypes, values within one bf16
rounding (test_torch_amp.py's ``_close``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import (LowerContext as JLowerContext,
                                      OpRegistry as JOpRegistry,
                                      amp_scope as j_amp_scope)

from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry,
                                            amp_scope as t_amp_scope)

from test_torch_amp import _as_f32, _close, _dtype_name, _jax_in, _torch_in
from test_torch_ops import ATOL, RTOL, _run_jax, _run_torch


def _f(shape, seed, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _mm(tx, ty, alpha=1.0):
    return {"transpose_X": tx, "transpose_Y": ty, "alpha": alpha}


# (id, X shape, Y shape, attrs): the four transpose combinations, alpha,
# broadcast batch dims on either side, rank-1 operands
MATMUL_SHAPES = [
    ("nn", (2, 3, 4), (2, 4, 5), _mm(False, False)),
    ("tn", (2, 4, 3), (2, 4, 5), _mm(True, False)),
    ("nt_alpha", (2, 2, 3, 4), (2, 2, 5, 4), _mm(False, True, 0.25)),
    ("tt", (2, 4, 3), (2, 5, 4), _mm(True, True, 2.0)),
    ("bcast_y", (2, 3, 4), (4, 5), _mm(False, False)),
    ("bcast_x_t", (3, 4), (2, 2, 5, 4), _mm(False, True)),
    ("bcast_unit_dim", (2, 1, 3, 4), (3, 4, 5), _mm(False, False)),
    ("rank1_x", (4,), (2, 4, 5), _mm(False, False)),
    ("rank1_y", (2, 3, 4), (4,), _mm(False, False, 0.5)),
    ("rank1_both", (4,), (4,), _mm(False, False)),
]


def _matmul_cases():
    cases = []
    for i, (name, xs, ys, attrs) in enumerate(MATMUL_SHAPES):
        x, y = _f(xs, 10 + 3 * i), _f(ys, 11 + 3 * i)
        out = _run_jax("matmul", {"X": [x], "Y": [y]}, attrs, False)
        cases.append(("matmul_" + name, "matmul", {"X": [x], "Y": [y]},
                      attrs))
        g = _f(out["Out"][0].shape, 12 + 3 * i)
        cases.append(("matmul_grad_" + name, "matmul_grad",
                      {"X": [x], "Y": [y], "Out@GRAD": [g]}, attrs))
    return cases


_R = _f((3, 4, 5), 60)
# ties in every row, so a max's or min's grad splits among them
_TIES = np.round(_f((3, 4, 5), 61, 1.5)).astype(np.float32)
_B = _f((3, 4, 5), 62) > 0


def _reduce_cases():
    cases = []
    for op in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
               "reduce_prod"):
        x = _TIES if op in ("reduce_max", "reduce_min") else _R
        for tag, attrs in (
                ("dim1", {"dim": [1], "keep_dim": False}),
                ("dims_keep", {"dim": [0, -1], "keep_dim": True}),
                ("all", {"dim": [0], "reduce_all": True})):
            cases.append(("%s_%s" % (op, tag), op, {"X": [x]}, attrs))
    cases.append(("reduce_mean_int", "reduce_mean",
                  {"X": [np.arange(12, dtype=np.int32).reshape(3, 4)]},
                  {"dim": [1]}))
    for op in ("reduce_all", "reduce_any"):
        cases.append((op + "_dim", op, {"X": [_B]}, {"dim": [2]}))
        cases.append((op + "_all_keep", op, {"X": [_B]},
                      {"dim": [0], "keep_dim": True, "reduce_all": True}))
    return cases


_PROBS = np.abs(_f((6, 7), 70)) + 1e-3
_PROBS /= _PROBS.sum(-1, keepdims=True)
_SOFT = np.abs(_f((6, 7), 71))
_SOFT /= _SOFT.sum(-1, keepdims=True)

CASES = (
    _matmul_cases()
    + _reduce_cases()
    + [
        ("cross_entropy_hard", "cross_entropy",
         {"X": [_PROBS], "Label": [np.array([[0], [6], [3], [1], [2], [5]],
                                            np.int64)]},
         {"soft_label": False}),
        ("cross_entropy_hard_flat", "cross_entropy",
         {"X": [_PROBS], "Label": [np.array([4, 0, 1, 6, 2, 3], np.int64)]},
         {}),
        ("cross_entropy_soft", "cross_entropy",
         {"X": [_PROBS], "Label": [_SOFT]}, {"soft_label": True}),
        ("cross_entropy_floor", "cross_entropy",
         {"X": [np.array([[0.0, 1.0], [1.0, 0.0]], np.float32)],
          "Label": [np.array([[0], [0]], np.int64)]}, {}),
        ("unsqueeze2", "unsqueeze2", {"X": [_f((3, 4), 72)]},
         {"axes": [0, 2]}),
        ("unsqueeze2_end", "unsqueeze2", {"X": [_f((3, 4), 73)]},
         {"axes": [2]}),
        ("expand", "expand", {"X": [_f((2, 1, 3), 74)]},
         {"expand_times": [1, 4, 2]}),
        ("sequence_mask", "sequence_mask",
         {"X": [np.array([3, 0, 5, 1], np.int64)]}, {"maxlen": 5}),
        ("sequence_mask_col", "sequence_mask",
         {"X": [np.array([[2], [7]], np.int64)]}, {"maxlen": 8}),
    ]
)

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


# the ops whose grads the engine derives by vjp, on float inputs
VJP_CASES = [c for c in CASES
             if c[1] in ("reduce_sum", "reduce_mean", "reduce_max",
                         "reduce_min", "reduce_prod", "cross_entropy",
                         "expand", "unsqueeze2")
             and c[2]["X"][0].dtype == np.float32]


@pytest.mark.parametrize("case", VJP_CASES, ids=[c[0] for c in VJP_CASES])
def test_vjp_grad_matches_reference(case):
    """The grad of ``X`` on one cotangent: vjp of each lowering, the other
    inputs held as data."""
    _, op_type, ins, attrs = case
    cot = _f(_run_torch(op_type, ins, attrs, False)["Out" if op_type !=
             "cross_entropy" else "Y"][0].shape, 80)
    out_slot = "Y" if op_type == "cross_entropy" else "Out"
    names = {s: ["x"] for s in ins}

    def jfwd(x):
        ctx = JLowerContext(JOpDesc(op_type, names, {}, attrs), None,
                            rng_key=jax.random.PRNGKey(0), op_index=0)
        jins = {s: [jnp.asarray(v[0])] for s, v in ins.items()}
        jins["X"] = [x]
        return JOpRegistry.get(op_type).lower(ctx, jins, attrs)[out_slot][0]

    def tfwd(x):
        ctx = TLowerContext(TOpDesc(op_type, names, {}, attrs), None, "cpu",
                            rng_seed=(0, 1), op_index=0)
        tins = {s: [torch.from_numpy(v[0].copy())] for s, v in ins.items()}
        tins["X"] = [x]
        return TOpRegistry.get(op_type).lower(ctx, tins, attrs)[out_slot][0]

    _, jvjp = jax.vjp(jfwd, jnp.asarray(ins["X"][0]))
    (want,) = jvjp(jnp.asarray(cot))
    _, tvjp = torch.func.vjp(tfwd, torch.from_numpy(ins["X"][0].copy()))
    (got,) = tvjp(torch.from_numpy(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_matmul_grad_is_the_vjp_of_matmul():
    """The direct grad lowering against ``torch.func.vjp`` of the forward
    lowering, in every case of MATMUL_SHAPES."""
    for name, op_type, ins, attrs in CASES:
        if op_type != "matmul_grad":
            continue
        x, y, g = (torch.from_numpy(ins[s][0]) for s in ("X", "Y",
                                                          "Out@GRAD"))
        lower = TOpRegistry.get("matmul").lower

        def fwd(xx, yy):
            return lower(None, {"X": [xx], "Y": [yy]}, attrs)["Out"][0]

        _, vjp = torch.func.vjp(fwd, x, y)
        want = vjp(g)
        got = _run_torch("matmul_grad", ins, attrs, False)
        for slot, w in zip(("X@GRAD", "Y@GRAD"), want):
            np.testing.assert_allclose(got[slot][0], w.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=name + slot)


# (id, op type, {slot: [(array, "bf16" or "f32")]}, attrs)
AMP_CASES = [
    ("matmul_f32_operands", "matmul",
     {"X": [(_f((2, 3, 8), 90), "f32")], "Y": [(_f((2, 5, 8), 91), "f32")]},
     _mm(False, True, 0.5)),
    ("matmul_bf16_f32", "matmul",
     {"X": [(_f((2, 3, 8), 92), "bf16")], "Y": [(_f((2, 8, 5), 93), "f32")]},
     _mm(False, False)),
    ("matmul_grad_bf16", "matmul_grad",
     {"X": [(_f((2, 3, 8), 94), "bf16")], "Y": [(_f((2, 5, 8), 95), "f32")],
      "Out@GRAD": [(_f((2, 3, 5), 96), "bf16")]},
     _mm(False, True, 0.5)),
    ("matmul_grad_f32_cotangent", "matmul_grad",
     {"X": [(_f((2, 8, 3), 97), "f32")], "Y": [(_f((8, 5), 98), "f32")],
      "Out@GRAD": [(_f((2, 3, 5), 99), "f32")]},
     _mm(True, False)),
]


@pytest.mark.parametrize("case", AMP_CASES, ids=[c[0] for c in AMP_CASES])
def test_amp_matmul_matches_reference(case):
    _, op_type, ins, attrs = case
    names = {s: ["x"] * len(v) for s, v in ins.items()}
    jctx = JLowerContext(JOpDesc(op_type, names, {}, attrs), None,
                         rng_key=jax.random.PRNGKey(0), op_index=0)
    tctx = TLowerContext(TOpDesc(op_type, names, {}, attrs), None, "cpu",
                         rng_seed=(0, 1), op_index=0)
    with j_amp_scope(True):
        want = JOpRegistry.get(op_type).lower(
            jctx, {s: [_jax_in(*a) for a in v] for s, v in ins.items()},
            attrs)
    with t_amp_scope(True):
        got = TOpRegistry.get(op_type).lower(
            tctx, {s: [_torch_in(*a) for a in v] for s, v in ins.items()},
            attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            assert tuple(g.shape) == tuple(w.shape), slot
            assert _dtype_name(g) == _dtype_name(w), (slot, g.dtype, w.dtype)
            _close(_as_f32(g), _as_f32(w), err_msg=slot)
