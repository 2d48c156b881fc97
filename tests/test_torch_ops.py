"""Every op lowering the port carries (paddle_tpu_torch/ops/) against the
JAX package's lowering of the same op, on the same random inputs (numpy,
seeded), through each package's own registry and LowerContext.

Tolerance: float32, rtol 1e-5 / atol 1e-5 — the two run the same formulas
with other summation orders (matmul, reductions) and other erf/tanh
implementations. Integer outputs, masks and shapes must be equal; JAX
runs with 64-bit types off, so an int64 input comes back int32 there and
is compared by value.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import (LowerContext as JLowerContext,
                                      OpRegistry as JOpRegistry)
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)

from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry)
from paddle_tpu_torch.core.types import VarType
import paddle_tpu_torch.ops  # noqa: F401  (registers the torch lowerings)

RTOL, ATOL = 1e-5, 1e-5


def _attention_residuals(q, k, v, lens=None, causal=False):
    """(Out, Lse [B, H, T, 1]) of the port's plain forward, the inputs a
    fused_attention_grad op reads."""
    from paddle_tpu_torch.kernels.flash_attention import dispatch_attention_lse

    out, lse = dispatch_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, None, None if lens is None else torch.from_numpy(lens))
    return out.numpy(), lse.numpy()


def _f(shape, seed, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _i(shape, high, seed, low=0):
    return np.random.RandomState(seed).randint(low, high, shape).astype(
        np.int64)


_ATT = [np.random.RandomState(s).randn(2, 2, 16, 8).astype(np.float32)
        for s in (43, 44, 45, 46)]
_ATT_LENS = np.array([[16], [5]], np.int64)
_ATT_RES = _attention_residuals(*_ATT[:3])
_ATT_RES_CAUSAL = _attention_residuals(*_ATT[:3], _ATT_LENS.reshape(-1),
                                       causal=True)
_RELU_X = np.random.RandomState(47).randn(4, 9).astype(np.float32)
_TANH_X = np.random.RandomState(48).randn(4, 9).astype(np.float32)

# (id, op type, {slot: [numpy arrays]}, attrs, is_test)
CASES = [
    ("mul_2d", "mul", {"X": [_f((4, 6), 0)], "Y": [_f((6, 5), 1)]},
     {"x_num_col_dims": 1, "y_num_col_dims": 1}, False),
    ("mul_flatten", "mul", {"X": [_f((2, 3, 8), 2)], "Y": [_f((8, 7), 3)]},
     {"x_num_col_dims": 2, "y_num_col_dims": 1}, False),
    ("elementwise_add_bias", "elementwise_add",
     {"X": [_f((2, 3, 8), 4)], "Y": [_f((8,), 5)]}, {"axis": 2}, False),
    ("elementwise_add_same", "elementwise_add",
     {"X": [_f((2, 3, 8), 6)], "Y": [_f((2, 3, 8), 7)]}, {"axis": -1},
     False),
    ("elementwise_sub_mid", "elementwise_sub",
     {"X": [_f((2, 3, 4), 8)], "Y": [_f((3,), 9)]}, {"axis": 1}, False),
    ("elementwise_mul_col", "elementwise_mul",
     {"X": [_f((6, 1), 10)], "Y": [_f((6, 1), 11)]}, {"axis": -1}, False),
    ("elementwise_div_scalar", "elementwise_div",
     {"X": [_f((), 12)], "Y": [np.abs(_f((1,), 13)) + 1.0]}, {"axis": -1},
     False),
    ("layer_norm", "layer_norm",
     {"X": [_f((2, 5, 16), 14)], "Scale": [_f((16,), 15)],
      "Bias": [_f((16,), 16)]},
     {"epsilon": 1e-5, "begin_norm_axis": 2}, False),
    ("layer_norm_axis1_noaffine", "layer_norm", {"X": [_f((3, 4, 5), 17)]},
     {"epsilon": 1e-6, "begin_norm_axis": 1}, False),
    ("dropout_test_upscale", "dropout", {"X": [_f((4, 8), 18)]},
     {"dropout_prob": 0.1, "is_test": True,
      "dropout_implementation": "upscale_in_train"}, False),
    ("dropout_test_downgrade", "dropout", {"X": [_f((4, 8), 19)]},
     {"dropout_prob": 0.3, "is_test": False,
      "dropout_implementation": "downgrade_in_infer"}, True),
    ("lookup_table", "lookup_table",
     {"Ids": [_i((3, 7), 11, 20)], "W": [_f((11, 6), 21)]},
     {"padding_idx": -1}, False),
    ("lookup_table_padding_col", "lookup_table",
     {"Ids": [_i((5, 1), 11, 22)], "W": [_f((11, 6), 23)]},
     {"padding_idx": 3}, False),
    ("gelu_exact", "gelu", {"X": [_f((4, 9), 24, 3.0)]}, {}, False),
    ("gelu_tanh", "gelu", {"X": [_f((4, 9), 25, 3.0)]},
     {"approximate": True}, False),
    ("tanh", "tanh", {"X": [_f((4, 9), 26, 2.0)]}, {}, False),
    ("fill_constant_f32", "fill_constant", {},
     {"shape": [2, 3], "dtype": int(VarType.FP32), "value": 1.5}, False),
    ("fill_constant_i64", "fill_constant", {},
     {"shape": [4], "dtype": int(VarType.INT64), "value": 7.0}, False),
    ("reshape2_zero_copy", "reshape2", {"X": [_f((2, 6, 8), 27)]},
     {"shape": [0, 0, 2, 4]}, False),
    ("reshape2_infer", "reshape2", {"X": [_f((2, 6, 8), 28)]},
     {"shape": [-1, 8]}, False),
    ("transpose2", "transpose2", {"X": [_f((2, 3, 4, 5), 29)]},
     {"axis": [0, 2, 1, 3]}, False),
    ("slice", "slice", {"Input": [_f((3, 6, 4), 30)]},
     {"axes": [1, 2], "starts": [1, 0], "ends": [4, 2]}, False),
    ("reduce_sum_all", "reduce_sum", {"X": [_f((3, 4), 31)]},
     {"dim": [0], "keep_dim": False, "reduce_all": True}, False),
    ("reduce_sum_dim_keep", "reduce_sum", {"X": [_f((3, 4, 5), 32)]},
     {"dim": [-1, 0], "keep_dim": True, "reduce_all": False}, False),
    ("softmax_xent_hard", "softmax_with_cross_entropy",
     {"Logits": [_f((6, 10), 33, 3.0)],
      "Label": [np.array([[0], [9], [3], [-100], [5], [2]], np.int64)]},
     {"soft_label": False, "ignore_index": -100}, False),
    ("softmax_xent_soft", "softmax_with_cross_entropy",
     {"Logits": [_f((5, 7), 34)],
      "Label": [np.abs(_f((5, 7), 35)) / 7.0]},
     {"soft_label": True}, False),
    ("mean", "mean", {"X": [_f((3, 5), 36)]}, {}, False),
    ("fused_attention", "fused_attention",
     {"Q": [_f((2, 2, 16, 8), 37)], "K": [_f((2, 2, 16, 8), 38)],
      "V": [_f((2, 2, 16, 8), 39)]},
     {"causal": False, "dropout_rate": 0.0, "scale": 0.35}, False),
    ("fused_attention_causal_lens", "fused_attention",
     {"Q": [_f((3, 2, 16, 8), 40)], "K": [_f((3, 2, 16, 8), 41)],
      "V": [_f((3, 2, 16, 8), 42)],
      "SeqLens": [np.array([[16], [5], [0]], np.int64)]},
     {"causal": True, "dropout_rate": 0.1}, True),
    # grad lowerings the JAX package registers directly
    ("mul_grad_2d", "mul_grad",
     {"X": [_f((4, 6), 50)], "Y": [_f((6, 5), 51)],
      "Out@GRAD": [_f((4, 5), 52)]},
     {"x_num_col_dims": 1, "y_num_col_dims": 1}, False),
    ("mul_grad_flatten", "mul_grad",
     {"X": [_f((2, 3, 8), 53)], "Y": [_f((8, 7), 54)],
      "Out@GRAD": [_f((2, 3, 7), 55)]},
     {"x_num_col_dims": 2, "y_num_col_dims": 1}, False),
    ("relu", "relu", {"X": [_RELU_X]}, {}, False),
    ("relu_grad", "relu_grad",
     {"X": [_RELU_X], "Out": [np.maximum(_RELU_X, 0)],
      "Out@GRAD": [_f((4, 9), 56)]}, {}, False),
    ("tanh_grad", "tanh_grad",
     {"X": [_TANH_X], "Out": [np.tanh(_TANH_X)],
      "Out@GRAD": [_f((4, 9), 57)]}, {}, False),
    ("gelu_grad_exact", "gelu_grad",
     {"X": [_f((4, 9), 58, 3.0)], "Out@GRAD": [_f((4, 9), 59)]}, {}, False),
    ("gelu_grad_tanh", "gelu_grad",
     {"X": [_f((4, 9), 60, 3.0)], "Out@GRAD": [_f((4, 9), 61)]},
     {"approximate": True}, False),
    ("softmax_xent_grad_hard", "softmax_with_cross_entropy_grad",
     {"Logits": [_f((6, 10), 62, 3.0)],
      "Label": [np.array([[0], [9], [3], [-100], [5], [2]], np.int64)],
      "Loss@GRAD": [_f((6, 1), 63)]},
     {"soft_label": False, "ignore_index": -100}, False),
    ("softmax_xent_grad_soft_with_softmax_grad",
     "softmax_with_cross_entropy_grad",
     {"Logits": [_f((5, 7), 64)], "Label": [np.abs(_f((5, 7), 65)) / 7.0],
      "Loss@GRAD": [_f((5, 1), 66)], "Softmax@GRAD": [_f((5, 7), 67)]},
     {"soft_label": True}, False),
    ("fused_attention_grad", "fused_attention_grad",
     {"Q": [_ATT[0]], "K": [_ATT[1]], "V": [_ATT[2]],
      "Out": [_ATT_RES[0]], "Lse": [_ATT_RES[1]], "Out@GRAD": [_ATT[3]]},
     {"causal": False, "dropout_rate": 0.0}, False),
    ("fused_attention_grad_causal_lens", "fused_attention_grad",
     {"Q": [_ATT[0]], "K": [_ATT[1]], "V": [_ATT[2]],
      "SeqLens": [_ATT_LENS], "Out": [_ATT_RES_CAUSAL[0]],
      "Lse": [_ATT_RES_CAUSAL[1]], "Out@GRAD": [_ATT[3]]},
     {"causal": True, "dropout_rate": 0.1}, True),
    ("lookup_table_grad_padding", "lookup_table_grad",
     {"Ids": [np.array([[1], [3], [1], [7], [3]], np.int64)],
      "W": [_f((11, 6), 68)], "Out@GRAD": [_f((5, 6), 69)]},
     {"padding_idx": 3, "is_sparse": False}, False),
    # the ops the backward and the optimizers append
    ("scale", "scale", {"X": [_f((3, 4), 70)]},
     {"scale": 0.5, "bias": 0.25}, False),
    ("scale_bias_first", "scale", {"X": [_f((3, 4), 71)]},
     {"scale": 0.5, "bias": 0.25, "bias_after_scale": False}, False),
    ("sum", "sum", {"X": [_f((3, 4), 72), _f((3, 4), 73), _f((3, 4), 74)]},
     {}, False),
    ("sgd", "sgd",
     {"Param": [_f((4, 3), 75)], "Grad": [_f((4, 3), 76)],
      "LearningRate": [np.array([0.1], np.float32)]}, {}, False),
    ("momentum", "momentum",
     {"Param": [_f((4, 3), 77)], "Grad": [_f((4, 3), 78)],
      "Velocity": [_f((4, 3), 79)],
      "LearningRate": [np.array([0.1], np.float32)]},
     {"mu": 0.9, "use_nesterov": False}, False),
    ("momentum_nesterov", "momentum",
     {"Param": [_f((4, 3), 80)], "Grad": [_f((4, 3), 81)],
      "Velocity": [_f((4, 3), 82)],
      "LearningRate": [np.array([0.1], np.float32)]},
     {"mu": 0.9, "use_nesterov": True}, False),
    ("adam", "adam",
     {"Param": [_f((4, 3), 83)], "Grad": [_f((4, 3), 84)],
      "Moment1": [_f((4, 3), 85, 0.1)],
      "Moment2": [np.abs(_f((4, 3), 86, 0.1))],
      "LearningRate": [np.array([1e-3], np.float32)],
      "Beta1Pow": [np.array([0.9 ** 3], np.float32)],
      "Beta2Pow": [np.array([0.999 ** 3], np.float32)]},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, False),
]


def _run_jax(op_type, ins, attrs, is_test):
    op = JOpDesc(op_type, {s: ["x"] * len(v) for s, v in ins.items()},
                 {}, attrs)
    ctx = JLowerContext(op, None, rng_key=jax.random.PRNGKey(0),
                        op_index=0, is_test=is_test)
    outs = JOpRegistry.get(op_type).lower(
        ctx, {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        attrs)
    return {s: [np.asarray(x) for x in v] for s, v in outs.items()}


def _run_torch(op_type, ins, attrs, is_test):
    op = TOpDesc(op_type, {s: ["x"] * len(v) for s, v in ins.items()},
                 {}, attrs)
    ctx = TLowerContext(op, None, "cpu", rng_seed=(0, 1), op_index=0,
                        is_test=is_test)
    outs = TOpRegistry.get(op_type).lower(
        ctx, {s: [torch.from_numpy(np.array(a)) for a in v]
              for s, v in ins.items()}, attrs)
    return {s: [x.numpy() for x in v] for s, v in outs.items()}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_lowering_matches_reference(case):
    _, op_type, ins, attrs, is_test = case
    want = _run_jax(op_type, ins, attrs, is_test)
    got = _run_torch(op_type, ins, attrs, is_test)
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


def test_every_ported_lowering_has_a_case():
    """Here, among the ResNet slice's ops in test_torch_ops_conv.py, among
    the training loop's in test_torch_ops_train.py, among the CTR and
    NMT models' in test_torch_ctr_models.py and
    test_torch_transformer_nmt.py, among the control-flow and
    recurrent ops in test_torch_control_flow.py and test_torch_rnn.py,
    among the book programs' and the unfused attention's in
    test_torch_ops_book.py, among the dense op families' in
    test_torch_ops_dense.py, among the sequence and beam-search ops' in
    test_torch_ops_sequence.py, among the misc family's in
    test_torch_ops_misc.py, among the detection and CTC families' in
    test_torch_ops_detection.py, among the quantization ops' in
    test_torch_int8.py, among the level-2 fuse's in
    test_torch_transforms_level2.py, or among the parameter server's
    in test_torch_distributed_ps.py."""
    from test_torch_control_flow import SLICE_OPS as CF_OPS
    from test_torch_ctr_models import SLICE_OPS as CTR_OPS
    from test_torch_distributed_ps import SLICE_OPS as PS_OPS
    from test_torch_int8 import SLICE_OPS as INT8_OPS
    from test_torch_ops_book import SLICE_OPS as BOOK_OPS
    from test_torch_ops_dense import SLICE_OPS as DENSE_OPS
    from test_torch_ops_detection import SLICE_OPS as DETECTION_OPS
    from test_torch_ops_misc import SLICE_OPS as MISC_OPS
    from test_torch_ops_sequence import SLICE_OPS as SEQUENCE_OPS
    from test_torch_ops_conv import SLICE_OPS
    from test_torch_ops_train import SLICE_OPS as TRAIN_OPS
    from test_torch_rnn import SLICE_OPS as RNN_OPS
    from test_torch_transformer_nmt import SLICE_OPS as NMT_OPS
    from test_torch_transforms_level2 import SLICE_OPS as LEVEL2_OPS

    registered = set(TOpRegistry.all_types())
    assert {c[1] for c in CASES} | (SLICE_OPS & registered) | TRAIN_OPS \
        | CTR_OPS | NMT_OPS | CF_OPS | RNN_OPS | BOOK_OPS | DENSE_OPS \
        | SEQUENCE_OPS | MISC_OPS | DETECTION_OPS | INT8_OPS | LEVEL2_OPS \
        | PS_OPS == registered - {"uniform_random"}


def test_uniform_random_draws_in_range_per_stream():
    """uniform_random's bits come from each package's own RNG, so only
    the contract is compared: shape, dtype, range, and a fresh but
    reproducible stream per (seed, run, op)."""
    attrs = {"shape": [64, 32], "dtype": int(VarType.FP32), "min": -0.5,
             "max": 0.25, "seed": 0}
    op = TOpDesc("uniform_random", {}, {"Out": ["w"]}, attrs)
    lower = TOpRegistry.get("uniform_random").lower

    def draw(run, op_index):
        ctx = TLowerContext(op, None, "cpu", rng_seed=(3, run),
                            op_index=op_index)
        return lower(ctx, {}, attrs)["Out"][0]

    want = _run_jax("uniform_random", {}, attrs, False)["Out"][0]
    a = draw(1, 0)
    assert tuple(a.shape) == want.shape and a.numpy().dtype == want.dtype
    assert a.min() >= -0.5 and a.max() < 0.25
    assert torch.equal(a, draw(1, 0))
    assert not torch.equal(a, draw(2, 0))
    assert not torch.equal(a, draw(1, 1))
