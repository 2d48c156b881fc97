"""The stacked-LSTM classifier (``models/lstm.py``: embedding, two
``StaticRNN`` LSTM layers, the last step, fc, softmax loss, Adam) of the
port against the JAX package's, on the CPU, at tiny sizes, and the
op coverage of this slice's builders.

- Descs: training (forward, ``append_backward``'s ``recurrent_grad`` in
  block 0 with the cell weights' grads, Adam), the ``is_train=False``
  program and the training program's ``for_test`` clone, main and
  startup, sub-blocks included, byte for byte.
- Training: 3 Adam steps from the JAX package's startup state
  (``convert.load_numpy_state``): losses rtol 1e-5; every persistable
  after them atol 1e-5 (Adam's steps are 1e-2; the difference seen is
  about 4e-7).
- Inference: the ``for_test`` clone and the ``is_train=False`` program
  from the same state, logits rtol 1e-5 / atol 1e-6.
- Coverage: every op type in every block of the lstm, vgg, mobilenet and
  se_resnext builders (forward, after ``minimize``, and the ``for_test``
  clone) is registered in the port, or is a ``*_grad`` of a registered
  op that the engine lowers as the forward's vjp.
"""

import json

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu import models as j_models
from paddle_tpu.models import lstm as j_lstm

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch import models as t_models
from paddle_tpu_torch.core.registry import OpRegistry as TOpRegistry
from paddle_tpu_torch.models import lstm as t_lstm

CFG = dict(batch_size=4, seq_len=8, dict_dim=50, emb_dim=16, hidden_dim=16,
           lr=0.01)
STEPS = 3


def _models(**kw):
    cfg = dict(CFG, **kw)
    with j_unique_name.guard():
        j = j_lstm.get_model(**cfg)
    with t_unique_name.guard():
        t = t_lstm.get_model(**cfg)
    return j, t


def _feeds():
    rng = np.random.RandomState(0)
    return [{"seq": rng.randint(0, CFG["dict_dim"], (4, CFG["seq_len"])
                                ).astype(np.int64),
             "label": rng.randint(0, 2, (4, 1)).astype(np.int64)}
            for _ in range(STEPS)]


def _same_desc(j_prog, t_prog):
    assert json.loads(t_prog.desc.serialize_to_string()) == \
        json.loads(j_prog.desc.serialize_to_string())
    assert t_prog.desc.serialize_to_string() == \
        j_prog.desc.serialize_to_string()


@pytest.mark.parametrize("which", ["train", "infer", "for_test"])
def test_desc_parity(which):
    (j_main, j_startup, _), (t_main, t_startup, _) = _models(
        is_train=which != "infer")
    if which == "for_test":
        j_main, t_main = j_main.clone(for_test=True), \
            t_main.clone(for_test=True)
    _same_desc(j_main, t_main)
    _same_desc(j_startup, t_startup)
    blocks = t_main.desc.blocks
    assert len(blocks) == 3 and all(b.parent_idx == 0 for b in blocks[1:])
    types = [op.type for op in blocks[0].ops]
    assert types.count("recurrent") == 2
    assert types.count("recurrent_grad") == (2 if which == "train" else 0)
    if which == "train":
        grad = next(op for op in blocks[0].ops
                    if op.type == "recurrent_grad")
        assert grad.output("Params@GRAD") and all(
            n.endswith("@GRAD") for n in grad.output("Params@GRAD"))
        # the cell's ops stay in their sub-blocks, forward only
        assert not any(op.type.endswith("_grad")
                       for b in blocks[1:] for op in b.ops)


def _jax_state_and_run(j_main, j_startup, fetch, feeds):
    names = sorted(v.name for v in j_main.list_vars() if v.persistable)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
        state = {n: np.array(scope.get(n)) for n in names}
        outs = [np.asarray(exe.run(j_main, feed=f, fetch_list=[fetch])[0])
                for f in feeds]
        final = {n: np.array(scope.get(n)) for n in names}
    return names, state, outs, final


def test_three_adam_steps_match_jax():
    (j_main, j_startup, j_h), (t_main, _, t_h) = _models()
    feeds = _feeds()
    names, state, want, j_final = _jax_state_and_run(
        j_main, j_startup, j_h["loss"], feeds)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    convert.load_numpy_state(scope, state, "cpu", program=t_main)
    with tfluid.scope_guard(scope):
        got = [exe.run(t_main, feed=f, fetch_list=[t_h["loss"]])[0]
               for f in feeds]
    np.testing.assert_allclose(np.ravel(got), np.ravel(want), rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(scope.get(n).numpy(), j_final[n], rtol=0,
                                   atol=1e-5, err_msg=n)
    # every cell weight moved
    for p in t_main.all_parameters():
        assert not np.array_equal(scope.get(p.name).numpy(), state[p.name])


@pytest.mark.parametrize("which", ["for_test", "infer"])
def test_inference_matches_jax(which):
    (j_main, j_startup, j_h), (t_main, _, t_h) = _models(
        is_train=which == "for_test")
    if which == "for_test":
        j_main, t_main = j_main.clone(for_test=True), \
            t_main.clone(for_test=True)
    feeds = [{"seq": f["seq"]} for f in _feeds()[:2]]
    _, state, want, _ = _jax_state_and_run(j_main, j_startup, j_h["logits"],
                                           feeds)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    convert.load_numpy_state(scope, state, "cpu", program=t_main)
    with tfluid.scope_guard(scope):
        got = [exe.run(t_main, feed=f, fetch_list=[t_h["logits"]])[0]
               for f in feeds]
    for g, w in zip(got, want):
        assert g.shape == (4, 2)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


BUILDERS = {
    "lstm": CFG,
    "vgg": {},
    "mobilenet": dict(scale=0.25, image_shape=(3, 64, 64)),
    "se_resnext": dict(small=True, image_shape=(3, 16, 16)),
}


def _op_types(models, guard, name):
    """Op types in every block of the builder's forward, trained and
    ``for_test`` programs and its startup."""
    build = getattr(models, name).get_model
    with guard():
        infer, _, _ = build(is_train=False, **BUILDERS[name])
    with guard():
        train, startup, _ = build(**BUILDERS[name])
    return {op.type for prog in (infer, train, train.clone(for_test=True),
                                 startup)
            for block in prog.desc.blocks for op in block.ops}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_ops_all_lowered(name):
    """Both packages emit the same op types; the port lowers each."""
    types = _op_types(t_models, t_unique_name.guard, name)
    assert types == _op_types(j_models, j_unique_name.guard, name)
    missing = sorted(
        t for t in types
        if not TOpRegistry.has(t) and not (
            t.endswith("_grad") and TOpRegistry.has(t[: -len("_grad")])))
    assert not missing, missing
    if name == "lstm":
        assert {"recurrent", "recurrent_grad", "split",
                "fill_constant_batch_size_like"} <= types
