"""The recurrent ops and layers of the port against the JAX package, on
the CPU, at tiny sizes (T <= 8, widths <= 16).

- ``dynamic_lstm`` (lengths, reverse, peepholes, other activations, the
  initial states) and ``dynamic_gru`` (lengths, reverse, ``origin_mode``,
  an initial state): the outputs of both lowerings on the same inputs,
  and the grads of every floating input (``jax.vjp`` and ``torch.func.vjp``
  with the same cotangents), rtol 1e-5 / atol 1e-5.
- ``sequence_pool`` in each pooling, outputs and grads likewise.
- Programs built by both front ends (descs byte-identical) and run from
  the JAX package's startup state: the numerics cases of
  ``tests/test_rnn_beam.py`` (``dynamic_lstm`` with lengths against
  numpy, ``dynamic_lstm`` trained by Adam, ``dynamic_gru`` against numpy),
  ``layers.lstm`` (two stacked layers, bidirectional, initial states)
  and ``dynamic_lstmp``: fetches rtol 1e-5 / atol 1e-6, losses rtol 1e-5,
  parameters after the steps atol 1e-5 (Adam's steps of 1e-2).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import (LowerContext as JLowerContext,
                                      OpRegistry as JOpRegistry)

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry)

RTOL, ATOL = 1e-5, 1e-5
B, T, H = 3, 6, 4


def _f(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _vjp_both(op_type, ins, attrs, out_slots):
    """Outputs and input grads of ``op_type`` in both packages, from the
    same inputs and cotangents; integer inputs are not differentiated."""
    diff = [(s, i) for s, vs in ins.items() for i, v in enumerate(vs)
            if v.dtype.kind == "f"]

    def call(reg, ctx, conv, prims):
        fin = {s: [conv(v) for v in vs] for s, vs in ins.items()}
        for (s, i), p in zip(diff, prims):
            fin[s][i] = p
        out = reg.get(op_type).lower(ctx, fin, attrs)
        return tuple(out[s][0] for s in out_slots)

    j_ctx = JLowerContext(JOpDesc(op_type, {}, {}, attrs), None)
    t_ctx = TLowerContext(TOpDesc(op_type, {}, {}, attrs), None, "cpu")
    j_prims = [jnp.asarray(ins[s][i]) for s, i in diff]
    t_prims = [torch.from_numpy(ins[s][i]) for s, i in diff]
    j_out, j_vjp = jax.vjp(lambda *p: call(JOpRegistry, j_ctx, jnp.asarray,
                                           p), *j_prims)
    t_out, t_vjp = torch.func.vjp(
        lambda *p: call(TOpRegistry, t_ctx, torch.from_numpy, p), *t_prims)
    cots = [_f(np.shape(o), 100 + k) for k, o in enumerate(j_out)]
    j_g = j_vjp(tuple(jnp.asarray(c) for c in cots))
    t_g = t_vjp(tuple(torch.from_numpy(c) for c in cots))
    return ([np.asarray(o) for o in j_out], [o.numpy() for o in t_out],
            [np.asarray(g) for g in j_g], [g.numpy() for g in t_g])


def _check(op_type, ins, attrs, out_slots):
    j_out, t_out, j_g, t_g = _vjp_both(op_type, ins, attrs, out_slots)
    for w, g in zip(j_out + j_g, t_out + t_g):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


LENS = np.array([6, 2, 4], np.int64)

LSTM_CASES = {
    "plain": ({}, {}),
    "seq_len": ({"SeqLen": [LENS]}, {}),
    "seq_len_col_reverse": ({"SeqLen": [LENS.reshape(-1, 1)]},
                            {"is_reverse": True}),
    "peepholes": ({"SeqLen": [LENS]}, {"use_peepholes": True}),
    "init_states_acts": ({"H0": [_f((B, H), 5)], "C0": [_f((B, H), 6)]},
                         {"gate_activation": "sigmoid",
                          "cell_activation": "relu",
                          "candidate_activation": "identity"}),
}


@pytest.mark.parametrize("name", sorted(LSTM_CASES))
def test_dynamic_lstm_matches_jax(name):
    extra, attrs = LSTM_CASES[name]
    peep = attrs.get("use_peepholes", False)
    ins = {"Input": [_f((B, T, 4 * H), 1)], "Weight": [_f((H, 4 * H), 2,
                                                           0.5)],
           "Bias": [_f((1, (7 if peep else 4) * H), 3, 0.5)]}
    ins.update(extra)
    _check("dynamic_lstm", ins, attrs, ("Hidden", "Cell"))


GRU_CASES = {
    "plain": ({}, {}),
    "seq_len_reverse": ({"SeqLen": [LENS]}, {"is_reverse": True}),
    "origin_mode_h0": ({"H0": [_f((B, H), 7)], "SeqLen": [LENS]},
                       {"origin_mode": True}),
}


@pytest.mark.parametrize("name", sorted(GRU_CASES))
def test_dynamic_gru_matches_jax(name):
    extra, attrs = GRU_CASES[name]
    ins = {"Input": [_f((B, T, 3 * H), 8)], "Weight": [_f((H, 3 * H), 9,
                                                           0.5)],
           "Bias": [_f((1, 3 * H), 10, 0.5)]}
    ins.update(extra)
    _check("dynamic_gru", ins, attrs, ("Hidden",))


@pytest.mark.parametrize("pooltype", ["SUM", "AVERAGE", "SQRT", "MAX",
                                      "LAST", "FIRST"])
def test_sequence_pool_matches_jax(pooltype):
    ins = {"X": [_f((B, T, H), 11)], "Length": [LENS.astype(np.int32)]}
    _check("sequence_pool", ins, {"pooltype": pooltype}, ("Out",))


# -- programs -----------------------------------------------------------------

def _lstm_masking(fluid):
    rng = np.random.RandomState(0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[T, 4 * H], dtype="float32")
        sl = fluid.layers.data(name="sl", shape=[1], dtype="int64")
        sl2 = fluid.layers.reshape(sl, shape=[-1])
        hidden, cell = fluid.layers.dynamic_lstm(
            input=x, size=4 * H, seq_len=sl2)
    feed = {"x": rng.randn(B, T, 4 * H).astype(np.float32),
            "sl": LENS.reshape(-1, 1)}
    return main, startup, [hidden, cell], [feed]


def _lstm_trains(fluid):
    rng = np.random.RandomState(1)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[5, 8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[8], dtype="float32")
        proj = fluid.layers.fc(input=x, size=32, num_flatten_dims=2)
        hidden, _ = fluid.layers.dynamic_lstm(input=proj, size=32)
        last = fluid.layers.slice(hidden, axes=[1], starts=[4], ends=[5])
        last = fluid.layers.reshape(last, shape=[-1, 8])
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=last, label=y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    feed = {"x": rng.randn(8, 5, 8).astype(np.float32),
            "y": rng.randn(8, 8).astype(np.float32)}
    return main, startup, [loss], [feed] * 4


def _gru(fluid):
    rng = np.random.RandomState(2)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4, 15], dtype="float32")
        hidden = fluid.layers.dynamic_gru(input=x, size=5)
    return main, startup, [hidden], [
        {"x": rng.randn(2, 4, 15).astype(np.float32)}]


def _stacked_lstm(fluid):
    """``layers.lstm``: two layers, bidirectional, initial states; the
    last steps by ``sequence_last_step``; trained by Adam."""
    rng = np.random.RandomState(3)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[T, 8], dtype="float32")
        h0 = fluid.layers.data(name="h0", shape=[H], dtype="float32")
        c0 = fluid.layers.data(name="c0", shape=[H], dtype="float32")
        out, last_h, last_c = fluid.layers.lstm(
            x, h0, c0, max_len=T, hidden_size=H, num_layers=2,
            is_bidirec=True)
        loss = fluid.layers.mean(fluid.layers.square(last_h))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    feed = {"x": rng.randn(B, T, 8).astype(np.float32),
            "h0": rng.randn(B, H).astype(np.float32),
            "c0": rng.randn(B, H).astype(np.float32)}
    return main, startup, [out, last_h, last_c, loss], [feed] * 3


def _lstmp(fluid):
    rng = np.random.RandomState(4)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[T, 4 * H], dtype="float32")
        sl = fluid.layers.data(name="sl", shape=[1], dtype="int64")
        proj, cell = fluid.layers.dynamic_lstmp(
            input=x, size=4 * H, proj_size=3, seq_len=sl,
            use_peepholes=True, is_reverse=False)
    feed = {"x": rng.randn(B, T, 4 * H).astype(np.float32),
            "sl": LENS.reshape(-1, 1)}
    return main, startup, [proj, cell], [feed]


PROGRAMS = {"lstm_masking": _lstm_masking, "lstm_trains": _lstm_trains,
            "gru": _gru, "stacked_lstm": _stacked_lstm, "lstmp": _lstmp}


def _build(name):
    with j_unique_name.guard():
        j = PROGRAMS[name](jfluid)
    with t_unique_name.guard():
        t = PROGRAMS[name](tfluid)
    return j, t


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _np_lstm(x, w, b, seq_len):
    h = np.zeros((x.shape[0], w.shape[0]), np.float32)
    c = np.zeros_like(h)
    hs = np.zeros(x.shape[:2] + (w.shape[0],), np.float32)
    for t in range(x.shape[1]):
        i, f, ch, o = np.split(x[:, t] + h @ w + b, 4, axis=1)
        c_new = _sigmoid(f) * c + _sigmoid(i) * np.tanh(ch)
        h_new = _sigmoid(o) * np.tanh(c_new)
        valid = (t < seq_len)[:, None]
        h, c = np.where(valid, h_new, h), np.where(valid, c_new, c)
        hs[:, t] = h
    return hs


def _np_gru(x, w, b):
    hd = w.shape[0]
    h = np.zeros((x.shape[0], hd), np.float32)
    hs = np.zeros(x.shape[:2] + (hd,), np.float32)
    for t in range(x.shape[1]):
        xt = x[:, t] + b
        g = xt[:, :2 * hd] + h @ w[:, :2 * hd]
        u, r = _sigmoid(g[:, :hd]), _sigmoid(g[:, hd:])
        cand = np.tanh(xt[:, 2 * hd:] + (r * h) @ w[:, 2 * hd:])
        h = u * h + (1 - u) * cand
        hs[:, t] = h
    return hs


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_jax(name):
    (j_main, j_startup, j_fetch, feeds), (t_main, t_startup, t_fetch, _) = \
        _build(name)
    for j_prog, t_prog in ((j_main, t_main), (j_startup, t_startup)):
        assert json.loads(t_prog.desc.serialize_to_string()) == \
            json.loads(j_prog.desc.serialize_to_string())
        assert t_prog.desc.serialize_to_string() == \
            j_prog.desc.serialize_to_string()
    names = sorted(v.name for v in j_main.list_vars() if v.persistable)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
        state = {n: np.array(scope.get(n)) for n in names}
        want = [[np.asarray(v) for v in exe.run(j_main, feed=f,
                                                  fetch_list=j_fetch)]
                for f in feeds]
        j_final = {n: np.array(scope.get(n)) for n in names}
    t_exe, t_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    with tfluid.scope_guard(t_scope):
        got = [t_exe.run(t_main, feed=f, fetch_list=t_fetch) for f in feeds]
    for w_step, g_step in zip(want, got):
        for w, g in zip(w_step, g_step):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    for n in names:
        np.testing.assert_allclose(t_scope.get(n).numpy(), j_final[n],
                                   rtol=0, atol=1e-5)
    params = {p.name: state[p.name] for p in t_main.all_parameters()}
    if name == "lstm_masking":
        w = next(v for k, v in params.items() if ".w" in k)
        b = next(v for k, v in params.items() if ".b" in k)
        hidden = got[0][0]
        np.testing.assert_allclose(
            hidden, _np_lstm(feeds[0]["x"], w, b, LENS), rtol=1e-4,
            atol=1e-5)
        np.testing.assert_array_equal(hidden[1, 3], hidden[1, 1])
    elif name == "gru":
        w = next(v for k, v in params.items() if ".w" in k)
        b = next(v for k, v in params.items() if ".b" in k)
        np.testing.assert_allclose(got[0][0], _np_gru(feeds[0]["x"], w, b),
                                   rtol=1e-4, atol=1e-5)
    elif name in ("lstm_trains", "stacked_lstm"):
        losses = [float(s[-1].reshape(-1)[0]) for s in got]
        assert losses[-1] < losses[0]


# the lowerings this file holds against the JAX package's
# (tests/test_torch_ops.py checks every ported lowering has a case)
SLICE_OPS = {"dynamic_lstm", "dynamic_gru", "sequence_pool"}
