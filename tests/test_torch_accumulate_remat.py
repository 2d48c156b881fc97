"""``Executor.run(accumulate_steps=k)`` and ``run(remat_segments=s)`` of
the port against the JAX package's, and against the port's own plain
step, on the CPU (reference tests: tests/test_grad_accumulation.py and
tests/test_remat.py).

Each case builds one program with both front ends (byte-identical
descs), runs the JAX package's startup program and carries its scope
into the port (``convert.load_numpy_state``); both then take the same
steps on the same batches.

- Accumulation: k=4 micro-batches of a batch of 32 match the JAX
  package's k=4 and the port's single batch of 32 (SGD, Adam, global-norm
  clip, a decaying learning rate); batch norm's running statistics move
  once per micro-batch (equal to four plain steps at lr 0 on the four
  micro-batches); per-example fetches concatenate and the loss averages;
  a batch k does not divide raises.
- Remat: the gradients through s checkpointed segments match the
  explicit grad chain and the JAX package's remat (an MLP with SGD and
  Adam, global-norm clip with batch norm, conv + batch norm + Momentum,
  more segments than ops, a tiny BERT through ``fused_attention``);
  dropout masks reproduce under recompute (remat equal to the plain
  step, dropout 0.3); batch norm's statistics flow through; a fetch of
  ``loss@GRAD`` is the fill constant; the reference's refusals raise
  with its messages.

Tolerances, float32, the same formulas summed in other orders (autograd
against the explicit grad ops, a micro-batch mean against one batch):
losses rtol 1e-5; parameters after the steps |d| <= 1e-5 * max|want| +
1e-6 (as test_grad_accumulation.py's rtol 1e-4 / atol 1e-6 allows).
"""

import json

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.models import bert as j_bert

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.models import bert as t_bert

RTOL = 1e-5
STATE_REL, STATE_ABS = 1e-5, 1e-6


def _mlp(fl, optimizer="sgd", with_bn=False, with_clip=False, dropout=0.0,
         lr=None, sched=False):
    x = fl.layers.data(name="x", shape=[12], dtype="float32")
    y = fl.layers.data(name="y", shape=[1], dtype="int64")
    h = fl.layers.fc(input=x, size=16, act="relu",
                     param_attr=fl.ParamAttr(name="w1"))
    if with_bn:
        h = fl.layers.batch_norm(h)
    if dropout:
        h = fl.layers.dropout(h, dropout_prob=dropout)
    h = fl.layers.fc(input=h, size=16, act="gelu",
                     param_attr=fl.ParamAttr(name="w1b"))
    pred = fl.layers.fc(input=h, size=4, param_attr=fl.ParamAttr(name="w2"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(
        logits=pred, label=y))
    if with_clip:
        fl.clip.set_gradient_clip(fl.clip.GradientClipByGlobalNorm(0.01))
    if sched:
        lr = fl.layers.polynomial_decay(0.05, 10, 0.001)
    if optimizer == "adam":
        fl.optimizer.Adam(learning_rate=0.05 if lr is None else lr
                          ).minimize(loss)
    else:
        fl.optimizer.SGD(learning_rate=0.5 if lr is None else lr
                         ).minimize(loss)
    fl.clip.set_gradient_clip(None)
    return loss, pred


def _mlp_feed(rng, batch=32):
    return {"x": rng.randn(batch, 12).astype(np.float32),
            "y": rng.randint(0, 4, (batch, 1)).astype(np.int64)}


def _conv(fl):
    img = fl.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    y = fl.layers.data(name="y", shape=[1], dtype="int64")
    h = fl.layers.conv2d(img, num_filters=8, filter_size=3, padding=1,
                         bias_attr=False, param_attr=fl.ParamAttr(name="cw1"))
    h = fl.layers.batch_norm(h, act="relu")
    h = fl.layers.conv2d(h, num_filters=8, filter_size=3, padding=1,
                         bias_attr=False, param_attr=fl.ParamAttr(name="cw2"))
    h = fl.layers.batch_norm(h, act="relu")
    h = fl.layers.pool2d(h, pool_size=8, pool_type="avg",
                         global_pooling=True)
    pred = fl.layers.fc(h, size=4, param_attr=fl.ParamAttr(name="cw3"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(
        logits=pred, label=y))
    fl.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return loss, pred


def _conv_feed(rng, batch=8):
    return {"img": rng.randn(batch, 3, 8, 8).astype(np.float32),
            "y": rng.randint(0, 4, (batch, 1)).astype(np.int64)}


def _build(fl, unique_name, make, **kw):
    main, startup = fl.Program(), fl.Program()
    with unique_name.guard(), fl.program_guard(main, startup):
        loss, pred = make(fl, **kw)
    return main, startup, loss, pred


def _state0(make, **kw):
    """(JAX main, JAX startup state, the port's main) of ``make``."""
    j_main, j_startup, _, _ = _build(jfluid, j_unique_name, make, **kw)
    t_main, t_startup, _, _ = _build(tfluid, t_unique_name, make, **kw)
    assert (json.loads(t_main.desc.serialize_to_string())
            == json.loads(j_main.desc.serialize_to_string()))
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(j_startup)
        return {v.name: np.array(scope.get(v.name))
                for v in j_main.list_vars() if v.persistable}


def _train(pkg, make, feeder, run_kw, steps=4, seed=7, fetch_pred=False,
           state0=None, **kw):
    """Losses (and preds) of ``steps`` steps, and the state after them,
    of package ``pkg`` ("j" or "t") from the JAX startup state."""
    fl, un = (jfluid, j_unique_name) if pkg == "j" else \
        (tfluid, t_unique_name)
    main, _, loss, pred = _build(fl, un, make, **kw)
    state0 = _state0(make, **kw) if state0 is None else state0
    exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
    rng = np.random.RandomState(seed)
    fetch = [loss, pred] if fetch_pred else [loss]
    with fl.scope_guard(scope):
        if pkg == "j":
            for n, v in state0.items():
                scope.set(n, v)
        else:
            convert.load_numpy_state(scope, state0, "cpu", program=main)
        outs = [exe.run(main, feed=feeder(rng), fetch_list=fetch, **run_kw)
                for _ in range(steps)]
        state = {n: np.array(scope.get(n)) for n in state0}
    return [[np.asarray(v) for v in o] for o in outs], state


def _losses(outs):
    return [float(o[0].reshape(-1)[0]) for o in outs]


def _close_state(want, got, names=None):
    for n in names or sorted(want):
        tol = STATE_REL * float(np.abs(want[n]).max()) + STATE_ABS
        assert float(np.abs(got[n] - want[n]).max()) <= tol, (
            n, float(np.abs(got[n] - want[n]).max()), tol)


# -- accumulation -------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(optimizer="sgd"), dict(optimizer="adam"),
    dict(optimizer="sgd", with_clip=True), dict(optimizer="adam", sched=True),
], ids=["sgd", "adam", "sgd_global_norm_clip", "adam_polynomial_decay"])
def test_accumulation_matches_jax_and_the_big_batch(kw):
    state0 = _state0(_mlp, **kw)
    j4, js = _train("j", _mlp, _mlp_feed, {"accumulate_steps": 4},
                    state0=state0, **kw)
    t4, ts = _train("t", _mlp, _mlp_feed, {"accumulate_steps": 4},
                    state0=state0, **kw)
    np.testing.assert_allclose(_losses(t4), _losses(j4), rtol=RTOL)
    _close_state(js, ts)
    if kw.get("sched"):
        # the counter advances once a micro-batch, as in the reference
        assert float(ts["@LR_DECAY_COUNTER@"][0]) == 16.0
        return
    t1, t1s = _train("t", _mlp, _mlp_feed, {}, state0=state0, **kw)
    np.testing.assert_allclose(_losses(t4), _losses(t1), rtol=RTOL)
    _close_state(t1s, ts)


def test_accumulation_bn_statistics_update_once_per_micro_batch():
    """One accumulated step of 4 micro-batches moves the running
    statistics as 4 plain steps on those micro-batches do (lr 0, so the
    weights stay put), and as the JAX package's accumulated step."""
    kw = dict(with_bn=True, lr=0.0)
    state0 = _state0(_mlp, **kw)
    feed = _mlp_feed(np.random.RandomState(3))
    micro = [{n: v[i * 8:(i + 1) * 8] for n, v in feed.items()}
             for i in range(4)]
    main, _, _, _ = _build(tfluid, t_unique_name, _mlp, **kw)
    stats = sorted(n for op in main.desc.global_block().ops
                   if op.type == "batch_norm"
                   for n in op.input("Mean") + op.input("Variance"))
    assert len(stats) == 2

    def run(pkg, feeds, k):
        it = iter(feeds)
        _, state = _train(pkg, _mlp, lambda rng: next(it),
                          {"accumulate_steps": k}, steps=len(feeds),
                          state0=state0, **kw)
        return state

    accumulated = run("t", [feed], 4)
    sequential = run("t", micro, 1)
    reference = run("j", [feed], 4)
    _close_state(sequential, accumulated, stats)
    _close_state(reference, accumulated, stats)
    for n in stats:
        assert not np.allclose(accumulated[n], state0[n])


def test_accumulation_concatenates_per_example_fetches():
    state0 = _state0(_mlp)
    j, _ = _train("j", _mlp, _mlp_feed, {"accumulate_steps": 4}, steps=1,
                  fetch_pred=True, state0=state0)
    t, _ = _train("t", _mlp, _mlp_feed, {"accumulate_steps": 4}, steps=1,
                  fetch_pred=True, state0=state0)
    assert t[0][1].shape == j[0][1].shape == (32, 4)
    np.testing.assert_allclose(t[0][1], j[0][1], rtol=RTOL, atol=1e-6)
    assert t[0][0].shape == j[0][0].shape


def test_accumulation_rejects_indivisible_batch():
    state0 = _state0(_mlp)
    with pytest.raises(ValueError, match="does not divide"):
        _train("t", _mlp, lambda rng: _mlp_feed(rng, batch=30),
               {"accumulate_steps": 4}, steps=1, state0=state0)


# -- remat ----------------------------------------------------------------------
@pytest.mark.parametrize("kw,segments", [
    (dict(optimizer="sgd", with_bn=True), 3),
    (dict(optimizer="adam", with_bn=True), 3),
    (dict(optimizer="sgd", with_bn=True, with_clip=True), 4),
    (dict(optimizer="sgd", with_bn=True), 1000),
], ids=["sgd", "adam", "global_norm_clip_bn", "more_segments_than_ops"])
def test_remat_matches_explicit_chain_and_jax(kw, segments):
    state0 = _state0(_mlp, **kw)
    t0, t0s = _train("t", _mlp, _mlp_feed, {}, state0=state0, **kw)
    ts_, tss = _train("t", _mlp, _mlp_feed, {"remat_segments": segments},
                      state0=state0, **kw)
    js_, jss = _train("j", _mlp, _mlp_feed, {"remat_segments": segments},
                      state0=state0, **kw)
    np.testing.assert_allclose(_losses(ts_), _losses(t0), rtol=RTOL)
    np.testing.assert_allclose(_losses(ts_), _losses(js_), rtol=RTOL)
    # every persistable: parameters, moments, the running statistics
    _close_state(t0s, tss)
    _close_state(jss, tss)


def test_remat_dropout_masks_reproduce():
    """The recomputed segments read the run's seed table, so remat WITH
    dropout is the same step as the explicit chain."""
    kw = dict(with_bn=True, dropout=0.3)
    state0 = _state0(_mlp, **kw)
    t0, t0s = _train("t", _mlp, _mlp_feed, {}, state0=state0, **kw)
    t2, t2s = _train("t", _mlp, _mlp_feed, {"remat_segments": 2},
                     state0=state0, **kw)
    np.testing.assert_allclose(_losses(t2), _losses(t0), rtol=RTOL)
    _close_state(t0s, t2s)


def test_remat_conv_bn_momentum():
    state0 = _state0(_conv)
    t0, t0s = _train("t", _conv, _conv_feed, {}, state0=state0)
    t2, t2s = _train("t", _conv, _conv_feed, {"remat_segments": 2},
                     state0=state0)
    j2, j2s = _train("j", _conv, _conv_feed, {"remat_segments": 2},
                     state0=state0)
    np.testing.assert_allclose(_losses(t2), _losses(t0), rtol=RTOL)
    np.testing.assert_allclose(_losses(t2), _losses(j2), rtol=RTOL)
    _close_state(t0s, t2s)
    _close_state(j2s, t2s)


BERT = dict(batch_size=2, seq_len=16, vocab_size=64, d_model=32, n_layers=2,
            n_heads=2, d_inner=64, max_position=32, is_train=True,
            dropout=0.0)


def test_remat_through_fused_attention_tiny_bert():
    """A tiny BERT (fused_attention, layer norm, gelu, lookup tables,
    Adam): 3 steps with 2 remat segments against the port's explicit
    chain and the JAX package's remat step, ragged lengths."""
    with j_unique_name.guard():
        j_main, j_startup, jh = j_bert.get_model(**BERT)
    with t_unique_name.guard():
        t_main, _, th = t_bert.get_model(**BERT)
    scope = jfluid.Scope()
    j_exe = jfluid.Executor(jfluid.CPUPlace())
    feeds = [j_bert.make_fake_batch(2, 16, 64, rng=np.random.RandomState(s),
                                    varlen=True) for s in range(3)]
    with jfluid.scope_guard(scope):
        j_exe.run(j_startup)
        state0 = {v.name: np.array(scope.get(v.name))
                  for v in j_main.list_vars() if v.persistable}
        want = [float(np.asarray(j_exe.run(
            j_main, feed=f, fetch_list=[jh["loss"]],
            remat_segments=2)[0]).reshape(-1)[0]) for f in feeds]
        j_state = {n: np.array(scope.get(n)) for n in state0}

    def port(run_kw):
        t_scope = tfluid.Scope()
        convert.load_numpy_state(t_scope, state0, "cpu", program=t_main)
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(t_scope):
            losses = [float(exe.run(t_main, feed=f, fetch_list=[th["loss"]],
                                    **run_kw)[0].reshape(-1)[0])
                      for f in feeds]
        return losses, {n: t_scope.get(n).numpy() for n in state0}

    plain, plain_state = port({})
    remat, remat_state = port({"remat_segments": 2})
    np.testing.assert_allclose(remat, plain, rtol=RTOL)
    np.testing.assert_allclose(remat, want, rtol=RTOL)
    # Adam divides by sqrt(v): an element whose grad is near rounding
    # noise moves by a different fraction of the lr (1e-3) in each
    # package (tests/test_torch_bert_training.py), so params to 1e-5
    for n in ("word_embedding", "fc_0.w_0_0", "layer_norm_0.w_0_0"):
        np.testing.assert_allclose(remat_state[n], plain_state[n],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(remat_state[n], j_state[n], rtol=0,
                                   atol=1e-5)


def test_remat_serves_loss_grad_fetch():
    main, startup, loss, _ = _build(tfluid, t_unique_name, _mlp,
                                    with_bn=True)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    feed = _mlp_feed(np.random.RandomState(0))
    with tfluid.scope_guard(scope):
        exe.run(startup)
        g0 = exe.run(main, feed=feed, fetch_list=[loss.name + "@GRAD"])[0]
        g2 = exe.run(main, feed=feed, fetch_list=[loss.name + "@GRAD"],
                     remat_segments=2)[0]
    np.testing.assert_array_equal(g2, g0)


def test_remat_refusals_raise_with_the_references_messages():
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        pred = tfluid.layers.fc(x, size=2)
    with tfluid.scope_guard(scope):
        exe.run(startup)
        with pytest.raises(NotImplementedError, match="training program"):
            exe.run(main, feed={"x": np.zeros((2, 4), np.float32)},
                    fetch_list=[pred], remat_segments=2)

    main, startup, loss, pred = _build(tfluid, t_unique_name, _mlp)
    feed = _mlp_feed(np.random.RandomState(0))
    with tfluid.scope_guard(scope):
        exe.run(startup)
        with pytest.raises(NotImplementedError, match="cannot combine"):
            exe.run(main, feed=feed, fetch_list=[loss], accumulate_steps=2,
                    remat_segments=2)
        with pytest.raises(NotImplementedError,
                           match="gradient of intermediate var"):
            exe.run(main, feed=feed, fetch_list=[pred.name + "@GRAD"],
                    remat_segments=2)
