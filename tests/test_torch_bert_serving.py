"""The port's serving slice against the JAX package, on the CPU, for a
tiny BERT (2 layers, d_model 64, 2 heads, seq 32, is_train=False).

- Both front ends build the same main and startup descs, byte for byte.
- A model directory the JAX package saves is served by the port's
  predictor (``config.disable_gpu()``); ``enc_out`` matches the JAX
  predictor at opt level 0 with the Pallas flash kernel forced (interpret
  mode), at rtol 1e-4 / atol 1e-5: both compute in float32, and the
  matmuls sum in different orders.
- Weights carry across by name with ``convert.load_numpy_state``, and a
  directory the port saves is served by the JAX package.
"""

import importlib
import json

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.inference import predictor as j_predictor
from paddle_tpu.models import bert as j_bert

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert, inference as t_inference
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.models import bert as t_bert

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

CFG = dict(batch_size=2, seq_len=32, vocab_size=100, d_model=64, n_layers=2,
           n_heads=2, d_inner=128, dropout=0.1, is_train=False,
           max_position=64)
FEEDS = ["src_ids", "pos_ids", "sent_ids", "seq_lens"]
RTOL, ATOL = 1e-4, 1e-5


def _jax_model():
    with j_unique_name.guard():
        return j_bert.get_model(**CFG)


def _port_model():
    with t_unique_name.guard():
        return t_bert.get_model(**CFG)


def _feed(batch, varlen, seed):
    b = j_bert.make_fake_batch(batch, CFG["seq_len"], CFG["vocab_size"],
                               rng=np.random.RandomState(seed),
                               varlen=varlen)
    return {k: b[k] for k in FEEDS}


@pytest.fixture
def forced_flash(monkeypatch):
    """Route the JAX package's attention dispatch to the Pallas kernel in
    interpret mode (the op attr ``__force_flash__`` would not reach the
    lowering: the engine strips ``__`` attrs before calling it). Counts
    the dispatches."""
    calls = []
    monkeypatch.setattr(jfa, "flash_dispatch_ok",
                        lambda tq, tk: calls.append((tq, tk)) or True)
    return calls


@pytest.fixture(scope="module")
def jax_model_dir(tmp_path_factory):
    """The JAX package's startup + save_inference_model of tiny BERT."""
    main, startup, handles = _jax_model()
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    d = str(tmp_path_factory.mktemp("jax_bert"))
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(d, FEEDS, [handles["enc_out"]], exe,
                                       main_program=main)
    state = {v.name: np.asarray(scope.get(v.name))
             for v in main.list_vars() if v.persistable
             and scope.get(v.name) is not None}
    return d, state


def _jax_serve(model_dir, feed):
    cfg = j_predictor.AnalysisConfig(model_dir)
    cfg.disable_gpu()
    cfg.switch_ir_optim(False)  # opt level 0: the desc as saved
    return j_predictor.create_paddle_predictor(cfg).run(feed)[0].data


def _port_serve(model_dir, feed):
    cfg = t_inference.AnalysisConfig(model_dir)
    cfg.disable_gpu()
    return t_inference.create_paddle_predictor(cfg).run(feed)[0].data


@pytest.mark.parametrize("program", ["main", "startup"])
def test_desc_parity(program):
    j_main, j_startup, j_handles = _jax_model()
    t_main, t_startup, t_handles = _port_model()
    j_prog, t_prog = ((j_main, t_main) if program == "main"
                      else (j_startup, t_startup))
    j_desc = json.loads(j_prog.desc.serialize_to_string())
    t_desc = json.loads(t_prog.desc.serialize_to_string())
    assert [op["type"] for op in t_desc["blocks"][0]["ops"]] == \
        [op["type"] for op in j_desc["blocks"][0]["ops"]]
    assert t_desc == j_desc
    assert t_prog.desc.serialize_to_string() == \
        j_prog.desc.serialize_to_string()
    assert t_handles["enc_out"].name == j_handles["enc_out"].name


@pytest.mark.parametrize("varlen", [False, True], ids=["full", "varlen"])
def test_port_serves_jax_saved_model(jax_model_dir, forced_flash, varlen):
    model_dir, _ = jax_model_dir
    feed = _feed(3, varlen, seed=1)
    want = _jax_serve(model_dir, feed)
    assert len(forced_flash) == CFG["n_layers"]  # the kernel path ran
    got = _port_serve(model_dir, feed)
    assert got.shape == (3, CFG["seq_len"], CFG["d_model"])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_load_numpy_state_round_trip(jax_model_dir, forced_flash, tmp_path):
    """JAX scope -> numpy -> the port's scope by name; the port's executor
    then answers as the JAX predictor does, and the directory the port
    saves from that scope is served identically by the JAX package."""
    model_dir, state = jax_model_dir
    main, startup, handles = _port_model()
    infer = main.clone(for_test=True)
    scope = tfluid.Scope()
    names = convert.load_numpy_state(scope, state, "cpu", program=main)
    assert names == sorted(state)
    feed = _feed(2, True, seed=2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        (got,) = exe.run(infer, feed=feed, fetch_list=[handles["enc_out"]])
        out_dir = str(tmp_path / "port_bert")
        tfluid.io.save_inference_model(out_dir, FEEDS, [handles["enc_out"]],
                                       exe, main_program=main)
    want = _jax_serve(model_dir, feed)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with np.load(out_dir + "/__combined__.npz") as saved:
        assert sorted(saved.files) == sorted(state)
        for name in state:
            np.testing.assert_array_equal(saved[name], state[name])
    np.testing.assert_allclose(_jax_serve(out_dir, feed), want,
                               rtol=RTOL, atol=ATOL)


def test_load_numpy_state_checks_the_program(jax_model_dir):
    _, state = jax_model_dir
    main, _, _ = _port_model()
    scope = tfluid.Scope()
    name = "word_embedding"
    bad_shape = dict(state, **{name: state[name][:-1]})
    with pytest.raises(ValueError, match="shape"):
        convert.load_numpy_state(scope, bad_shape, "cpu", program=main)
    bad_dtype = dict(state, **{name: state[name].astype(np.float64)})
    with pytest.raises(ValueError, match="dtype"):
        convert.load_numpy_state(scope, bad_dtype, "cpu", program=main)
    missing = {k: v for k, v in state.items() if k != name}
    with pytest.raises(ValueError, match="missing"):
        convert.load_numpy_state(scope, missing, "cpu", program=main)
    assert scope.get(name) is None  # nothing written on a mismatch


def test_startup_then_serve_in_the_port(tmp_path):
    """The port's own entry points end to end on the CPU: build, startup,
    save_inference_model, create_paddle_predictor, run."""
    main, startup, handles = _port_model()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    d = str(tmp_path / "bert")
    with tfluid.scope_guard(scope):
        exe.run(startup)
        tfluid.io.save_inference_model(d, FEEDS, [handles["enc_out"]], exe,
                                       main_program=main)
    feed = _feed(4, True, seed=3)
    out = _port_serve(d, feed)
    assert out.shape == (4, CFG["seq_len"], CFG["d_model"])
    assert np.isfinite(out).all()
    # layer-normed rows: mean ~0, std ~1 per token
    np.testing.assert_allclose(out.mean(-1), 0.0, atol=1e-4)
    np.testing.assert_allclose(out.std(-1), 1.0, atol=1e-2)
