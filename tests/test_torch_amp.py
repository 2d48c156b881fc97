"""bfloat16 AMP in the port against the JAX package's, on the CPU.

- Op by op: every lowering the reference gives AMP rules (``mul`` and
  ``mul_grad``, the elementwise bf16-activation rule, ``fused_attention``
  and its grad, and the ops BERT's step runs on bf16 activations) under
  each package's ``amp_scope``, on the same inputs: every output's dtype
  equal, and its values within one bf16 rounding of the reference's
  (``_close``: |d| <= 2^-7 |want| + 2^-7 max|want|; both round a float32
  result to bf16, and a value whose two float32 results straddle a
  rounding boundary lands one ulp, 2^-8 of it, apart).
- A whole step: tiny BERT and the MNIST MLP built by both front ends,
  marked with ``enable_bf16`` (and the MLP minimized through
  ``decorate``), take 3 Adam steps from the JAX package's startup state
  (``convert.load_numpy_state``). In the first step every var the block
  writes is fetched on both sides: each one's dtype must be the
  reference's exactly (integer vars, which JAX holds as int32 with 64-bit
  types off, only as integers). Losses and grads within the tolerances
  below; the parameters stay float32.

Tolerances of the step: the two packages round different intermediates
to bf16 (XLA fuses elementwise chains and rounds once at the end of a
fusion; torch rounds after every op), so bf16 activations differ by a few
ulps (2^-8 relative each) and the differences grow through the layers.
Losses within rtol 1e-2 per step (measured 1.3e-3); step-1 grads and
Adam's moments after 3 steps within 5e-2 * max|x| of each (measured
1.5e-2 and 1.9e-2); parameters after 3 steps within 1e-3 (measured
5.1e-4): Adam moves an element by about lr = 1e-4 a step whatever its
grad's size, so an element whose grad is at bf16's rounding noise on both
sides may step the other way on each.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.contrib import mixed_precision as j_mp
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import (LowerContext as JLowerContext,
                                      OpRegistry as JOpRegistry,
                                      amp_scope as j_amp_scope)
from paddle_tpu.models import bert as j_bert

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.contrib import mixed_precision as t_mp
from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry,
                                            amp_enabled,
                                            amp_scope as t_amp_scope)
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import bert as t_bert

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

CFG = dict(batch_size=2, seq_len=32, vocab_size=100, d_model=64, n_layers=2,
           n_heads=2, d_inner=128, max_position=64, is_train=True)
GRAD_PARAMS = ("word_embedding", "pos_embedding", "fc_0.w_0_0",
               "layer_norm_0.w_0_0", "fc_4.w_0_0", "fc_11.w_0_0",
               "fc_12.b_0_0", "fc_15.w_0_0")
STEPS = 3
LOSS_RTOL = 1e-2
GRAD_REL = 5e-2
PARAM_ATOL = 1e-3
ULP = 2.0 ** -7


def _f(shape, seed, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _attention_residuals(q, k, v):
    """(Out, Lse) of the plain forward in bf16, as the AMP forward saves
    them for its grad op."""
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    out, lse = tfa.attention_lse_plain(*bf)
    return out.float().numpy(), lse.unsqueeze(-1).numpy()


_ATT = [_f((2, 2, 16, 8), s) for s in (43, 44, 45, 46)]
_ATT_RES = _attention_residuals(*_ATT[:3])

# (id, op type, {slot: [(array, "bf16" or "f32")]}, attrs)
CASES = [
    ("mul_f32_operands", "mul",
     {"X": [(_f((4, 6), 0), "f32")], "Y": [(_f((6, 5), 1), "f32")]},
     {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    ("mul_bf16_activation", "mul",
     {"X": [(_f((2, 3, 8), 2), "bf16")], "Y": [(_f((8, 7), 3), "f32")]},
     {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    ("mul_grad", "mul_grad",
     {"X": [(_f((2, 3, 8), 4), "bf16")], "Y": [(_f((8, 7), 5), "f32")],
      "Out@GRAD": [(_f((2, 3, 7), 6), "bf16")]},
     {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    ("elementwise_add_bf16_act_f32_bias", "elementwise_add",
     {"X": [(_f((2, 3, 8), 7), "bf16")], "Y": [(_f((8,), 8), "f32")]},
     {"axis": 2}),
    ("elementwise_add_f32_act_bf16", "elementwise_add",
     {"X": [(_f((2, 3, 8), 9), "f32")], "Y": [(_f((2, 3, 8), 10), "bf16")]},
     {"axis": -1}),
    ("elementwise_mul_bf16_f32", "elementwise_mul",
     {"X": [(_f((4, 5), 11), "bf16")], "Y": [(_f((4, 5), 12), "f32")]},
     {"axis": -1}),
    ("fused_attention", "fused_attention",
     {"Q": [(_ATT[0], "f32")], "K": [(_ATT[1], "f32")],
      "V": [(_ATT[2], "f32")]},
     {"causal": False, "dropout_rate": 0.0}),
    ("fused_attention_grad", "fused_attention_grad",
     {"Q": [(_ATT[0], "f32")], "K": [(_ATT[1], "f32")],
      "V": [(_ATT[2], "f32")], "Out": [(_ATT_RES[0], "bf16")],
      "Lse": [(_ATT_RES[1], "f32")], "Out@GRAD": [(_ATT[3], "bf16")]},
     {"causal": False, "dropout_rate": 0.0}),
    ("layer_norm_bf16", "layer_norm",
     {"X": [(_f((2, 5, 16), 13), "bf16")], "Scale": [(_f((16,), 14), "f32")],
      "Bias": [(_f((16,), 15), "f32")]},
     {"epsilon": 1e-5, "begin_norm_axis": 2}),
    ("gelu_bf16", "gelu", {"X": [(_f((4, 9), 16, 3.0), "bf16")]}, {}),
    ("gelu_grad_bf16", "gelu_grad",
     {"X": [(_f((4, 9), 17, 3.0), "bf16")],
      "Out@GRAD": [(_f((4, 9), 18), "bf16")]}, {}),
    ("tanh_grad_bf16", "tanh_grad",
     {"X": [(_f((4, 9), 19), "bf16")],
      "Out": [(np.tanh(_f((4, 9), 19)), "bf16")],
      "Out@GRAD": [(_f((4, 9), 20), "bf16")]}, {}),
    ("relu_grad_bf16", "relu_grad",
     {"X": [(_f((4, 9), 21), "bf16")],
      "Out": [(np.maximum(_f((4, 9), 21), 0), "bf16")],
      "Out@GRAD": [(_f((4, 9), 22), "bf16")]}, {}),
    ("softmax_xent_bf16", "softmax_with_cross_entropy",
     {"Logits": [(_f((6, 10), 23, 3.0), "bf16")],
      "Label": [(np.array([[0], [9], [3], [-100], [5], [2]]), "i64")]},
     {"soft_label": False, "ignore_index": -100}),
    ("softmax_xent_grad_bf16", "softmax_with_cross_entropy_grad",
     {"Logits": [(_f((6, 10), 24, 3.0), "bf16")],
      "Label": [(np.array([[0], [9], [3], [-100], [5], [2]]), "i64")],
      "Loss@GRAD": [(_f((6, 1), 25), "f32")]},
     {"soft_label": False, "ignore_index": -100}),
    ("lookup_table_grad_bf16_out_grad", "lookup_table_grad",
     {"Ids": [(np.array([[1], [3], [1], [7], [3]]), "i64")],
      "W": [(_f((11, 6), 26), "f32")],
      "Out@GRAD": [(_f((5, 6), 27), "bf16")]},
     {"padding_idx": -1, "is_sparse": False}),
]


def _jax_in(a, kind):
    if kind == "bf16":
        return jnp.asarray(a, jnp.bfloat16)
    if kind == "i64":
        return jnp.asarray(a, jnp.int32)
    return jnp.asarray(a)


def _torch_in(a, kind):
    if kind == "bf16":
        return torch.from_numpy(a).to(torch.bfloat16)
    if kind == "i64":
        return torch.from_numpy(np.asarray(a, np.int64))
    return torch.from_numpy(a)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, err_msg=""):
    atol = ULP * np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got, want, rtol=ULP, atol=atol,
                               err_msg=err_msg)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_amp_lowering_matches_reference(case):
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
        assert amp_enabled()
        got = TOpRegistry.get(op_type).lower(
            tctx, {s: [_torch_in(*a) for a in v] for s, v in ins.items()},
            attrs)
    assert not amp_enabled()
    assert sorted(got) == sorted(want)
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            assert tuple(g.shape) == tuple(w.shape), slot
            if jnp.issubdtype(w.dtype, jnp.floating):
                assert _dtype_name(g) == _dtype_name(w), (slot, g.dtype,
                                                          w.dtype)
                if slot != "XShape":
                    _close(_as_f32(g), _as_f32(w), err_msg=slot)


def test_amp_cast_passes_non_float32_through():
    from paddle_tpu_torch.ops.common import amp_cast

    x = torch.ones(2)
    i = torch.ones(2, dtype=torch.int64)
    assert amp_cast(x) is x
    with t_amp_scope(True):
        a, b, c = amp_cast(x, i, None)
        assert a.dtype == torch.bfloat16 and b is i and c is None


def test_flash_plain_takes_bf16_against_pallas():
    """The plain forward and backward on bf16 Q/K/V against the JAX
    package's Pallas kernels in interpret mode, dtypes and values."""
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in _ATT)
    lens = torch.tensor([16, 5])
    out, lse = tfa.attention_lse_plain(q, k, v, lens)
    dq, dk, dv = tfa.attention_bwd_plain(q, k, v, out, lse, g, None, lens)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in _ATT)
    jlens = jnp.asarray([16, 5], jnp.int32)

    def fwd(q_, k_, v_):
        return jfa.flash_attention_lse(q_, k_, v_, jlens, interpret=True)

    (jout, jlse), vjp = jax.vjp(fwd, jq, jk, jv)
    jdq, jdk, jdv = vjp((jg, jnp.zeros_like(jlse)))
    for got, want in ((out, jout), (dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_allclose(
            _as_f32(got), _as_f32(want), rtol=2 * ULP,
            atol=2 * ULP * float(np.abs(_as_f32(want)).max()))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-2)


@pytest.fixture
def forced_flash(monkeypatch):
    """The JAX package's attention on its Pallas kernels in interpret
    mode, as in test_torch_bert_training.py."""
    calls = []
    monkeypatch.setattr(jfa, "flash_dispatch_ok",
                        lambda tq, tk: calls.append((tq, tk)) or True)
    return calls


def _written(program):
    """Every var name the main block's ops write, in order."""
    names = []
    for op in program.desc.global_block().ops:
        for n in op.output_arg_names():
            if n != "@EMPTY@" and n not in names:
                names.append(n)
    return names


def _check_dtypes(t_vals, j_vals, names):
    assert len(t_vals) == len(j_vals) == len(names)
    floats = 0
    for n, t, j in zip(names, t_vals, j_vals):
        j = np.asarray(j)
        if np.issubdtype(j.dtype, np.integer) or j.dtype == np.bool_:
            assert not t.is_floating_point(), (n, t.dtype, j.dtype)
            continue
        assert _dtype_name(t) == str(j.dtype), (n, t.dtype, j.dtype)
        floats += 1
    return floats


def _steps(fluid, exe, scope, program, feed, fetch, names, port):
    """STEPS Adam steps; the first fetches every written var too. Returns
    (losses, step-1 grads, step-1 values of ``names``)."""
    losses, grads, values = [], None, None
    with fluid.scope_guard(scope):
        for i in range(STEPS):
            extra = names if i == 0 else []
            kw = {} if port else {"opt_level": 0}
            if port:
                out = exe.run(program, feed=feed, fetch_list=fetch + extra,
                              return_numpy=False)
            else:
                out = exe.run(program, feed=feed, fetch_list=fetch + extra,
                              **kw)
            losses.append(float(_as_f32(out[0]).reshape(())))
            if i == 0:
                grads = [_as_f32(g) for g in out[1:len(fetch)]]
                values = out[len(fetch):]
    return losses, grads, values


def test_bert_amp_three_adam_steps_match_jax(forced_flash):
    with j_unique_name.guard():
        j_main, j_startup, jh = j_bert.get_model(dropout=0.0, **CFG)
    with t_unique_name.guard():
        t_main, _, _ = t_bert.get_model(dropout=0.0, **CFG)
    j_mp.enable_bf16(j_main)
    assert t_mp.enable_bf16(t_main) is t_main and t_main._amp
    assert t_main.clone()._amp  # clone carries the mark
    feed = j_bert.make_fake_batch(2, CFG["seq_len"], CFG["vocab_size"],
                                  rng=np.random.RandomState(5), varlen=True)
    names = _written(t_main)
    assert names == _written(j_main)
    fetch = [jh["loss"].name] + [p + "@GRAD" for p in GRAD_PARAMS]

    j_exe, j_scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(j_scope):
        j_exe.run(j_startup)
    persist = sorted(v.name for v in j_main.list_vars() if v.persistable)
    state = {n: np.array(j_scope.get(n)) for n in persist}
    j_losses, j_grads, j_vals = _steps(jfluid, j_exe, j_scope, j_main, feed,
                                       fetch, names, port=False)
    assert forced_flash  # the reference took its Pallas kernels

    t_exe, t_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    t_losses, t_grads, t_vals = _steps(tfluid, t_exe, t_scope, t_main, feed,
                                       fetch, names, port=True)

    # the dtype of every var of the step's environment
    assert _check_dtypes(t_vals, j_vals, names) > 100
    bf16 = [n for n, v in zip(names, t_vals) if v.dtype == torch.bfloat16]
    assert any(n.startswith("fc_") for n in bf16)  # GEMM outputs
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    for name, g, w in zip(GRAD_PARAMS, t_grads, j_grads):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=name)
    params = {p.name for p in t_main.all_parameters()}
    for n in persist:
        t, j = t_scope.get(n), np.asarray(j_scope.get(n))
        assert t.dtype == torch.float32, n  # master weights stay float32
        # parameters move by at most about lr a step; Adam's moments are
        # running means of the grads, held as the grads are
        atol = PARAM_ATOL if n in params else GRAD_REL * np.abs(j).max()
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=atol,
                                   err_msg=n)


def _mlp(fluid, unique_name, mp):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[784], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        hidden = fluid.layers.fc(input=img, size=128, act="relu")
        pred = fluid.layers.fc(input=hidden, size=10)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits=pred, label=label))
        opt = mp.decorate(fluid.optimizer.Adam(learning_rate=1e-2))
        opt.minimize(loss)
    return main, startup, loss


def test_mnist_mlp_amp_decorate_matches_jax():
    """The verify skill's MLP minimized through ``decorate``: the program
    is marked, the descs are identical, every var's dtype is the
    reference's, the losses agree and fall, the weights stay float32."""
    j_main, j_startup, j_loss = _mlp(jfluid, j_unique_name, j_mp)
    t_main, _, t_loss = _mlp(tfluid, t_unique_name, t_mp)
    assert t_main._amp and j_main._amp
    assert t_main.desc.serialize_to_string() == \
        j_main.desc.serialize_to_string()
    rng = np.random.RandomState(0)
    w = rng.randn(784, 10).astype(np.float32)
    x = rng.randn(64, 784).astype(np.float32)
    feed = {"img": x,
            "label": np.argmax(x @ w, 1).astype(np.int64).reshape(-1, 1)}
    names = _written(t_main)
    fetch = [t_loss.name, "fc_0.w_0_0@GRAD"]
    j_exe, j_scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(j_scope):
        j_exe.run(j_startup)
    state = {v.name: np.array(j_scope.get(v.name))
             for v in j_main.list_vars() if v.persistable}
    j_losses, j_grads, j_vals = _steps(jfluid, j_exe, j_scope, j_main, feed,
                                       fetch, names, port=False)
    t_exe, t_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    t_losses, t_grads, t_vals = _steps(tfluid, t_exe, t_scope, t_main, feed,
                                       fetch, names, port=True)
    assert _check_dtypes(t_vals, j_vals, names) > 10
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    assert t_losses[-1] < t_losses[0]
    np.testing.assert_allclose(t_grads[0], j_grads[0], rtol=0,
                               atol=GRAD_REL * np.abs(j_grads[0]).max())
    for p in t_main.all_parameters():
        assert t_scope.get(p.name).dtype == torch.float32
    t_mp.disable_bf16(t_main)
    assert not t_main._amp
