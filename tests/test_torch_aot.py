"""The port's AOT artifact (``paddle_tpu_torch/aot.py``, ``io.py``'s
``export_format="aot"``, the predictor's AOT branch) on the CPU, at a tiny
size (an MLP 16 -> 32 -> 4 with dropout, batch 8; LeNet at 8 and 16
filters, frozen, batch 4); it mirrors tests/test_aot_export.py.

- The file names and the ``__aot_meta__.json`` format are the JAX
  package's (the same meta dict for the same export).
- The artifact's answers equal the predictor's native path exactly (the
  same lowerings on the same CPU), dropout off, every call; the
  predictor takes the AOT branch; a feed of another shape raises; a
  native re-save removes the artifact.
- A fresh process runs the artifact importing ``paddle_tpu_torch.aot``
  alone (no front end, no op registry).
- The frozen LeNet (BN-free, as ``freeze_program`` leaves it) exports and
  answers as the predictor does.
- A JAX-written artifact does not load in the port: the predictor stays
  on the native files beside it, and answers as the JAX package's
  native path (rtol 1e-5).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import inference
from paddle_tpu_torch import nets as t_nets
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.aot import AotPredictor, has_aot_artifact

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mlp(fluid, guard):
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[16], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=32, act="relu")
        h = fluid.layers.dropout(h, dropout_prob=0.3)
        pred = fluid.layers.fc(input=h, size=4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=pred, label=label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, pred, loss


def _cpu_config(d):
    config = inference.AnalysisConfig(d)
    config.disable_gpu()
    return config


def _trained_port(d, x, export_format="aot"):
    main, startup, pred, loss = _mlp(tfluid, t_unique_name.guard)
    exe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(0)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed={
                "img": rng.randn(8, 16).astype(np.float32),
                "label": rng.randint(0, 4, (8, 1)).astype(np.int64)},
                fetch_list=[loss])
        tfluid.io.save_inference_model(
            d, ["img"], [pred], exe, main_program=main,
            export_format=export_format, example_feeds={"img": x})
    return main, pred, exe


def test_aot_files_and_meta_match_reference(tmp_path):
    x = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    d_t, d_j = str(tmp_path / "t"), str(tmp_path / "j")
    _trained_port(d_t, x)
    main, startup, pred, _ = _mlp(jfluid, j_unique_name.guard)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(
            d_j, ["img"], [pred], exe, main_program=main,
            export_format="aot", example_feeds={"img": x})
    assert sorted(os.listdir(d_t)) == sorted(os.listdir(d_j))
    with open(os.path.join(d_t, "__aot_meta__.json")) as f:
        t_meta = json.load(f)
    with open(os.path.join(d_j, "__aot_meta__.json")) as f:
        j_meta = json.load(f)
    assert t_meta == j_meta
    assert t_meta["feeds"]["img"] == {"shape": [8, 16], "dtype": "float32"}


def test_aot_answers_as_the_predictor(tmp_path):
    d = str(tmp_path / "model")
    x = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    main, pred, exe = _trained_port(d, x)
    p = AotPredictor(d)
    assert p.runs_on("cpu") and not p.runs_on("cuda")
    (aot,) = p.run({"img": x})
    (aot2,) = p.run({"img": x})
    np.testing.assert_array_equal(aot, aot2)  # dropout off
    ap = inference.create_paddle_predictor(_cpu_config(d))
    assert ap._aot is not None
    (out,) = ap.run({"img": x})
    np.testing.assert_array_equal(out.data, aot)
    # the native path beside it gives the same answers
    with tfluid.scope_guard(tfluid.Scope()):
        prog, feeds, fetches = tfluid.io.load_inference_model(d, exe)
        (live,) = exe.run(prog, feed={"img": x},
                          fetch_list=[f.name for f in fetches])
    np.testing.assert_array_equal(aot, live)
    with pytest.raises(ValueError, match="exported shape"):
        p.run({"img": np.zeros((4, 16), np.float32)})
    with tfluid.scope_guard(tfluid.Scope()):
        exe2 = tfluid.Executor(tfluid.CPUPlace())
        prog, _, fetches = tfluid.io.load_inference_model(d, exe2)
        tfluid.io.save_inference_model(d, ["img"], fetches, exe2,
                                       main_program=prog)
    assert not has_aot_artifact(d)
    assert inference.create_paddle_predictor(_cpu_config(d))._aot is None


def test_aot_runs_without_the_front_end(tmp_path):
    d = str(tmp_path / "model")
    x = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    _trained_port(d, x)
    (want,) = AotPredictor(d).run({"img": x})
    np.save(str(tmp_path / "x.npy"), x)
    code = (
        "import sys, numpy as np\n"
        "from paddle_tpu_torch.aot import AotPredictor\n"
        "out = AotPredictor(%r).run({'img': np.load(%r)})[0]\n"
        "assert 'paddle_tpu_torch.fluid' not in sys.modules\n"
        "assert 'paddle_tpu_torch.core.registry' not in sys.modules\n"
        "np.save(%r, out)\n" % (d, str(tmp_path / "x.npy"),
                                 str(tmp_path / "out.npy")))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=300)
    np.testing.assert_array_equal(np.load(str(tmp_path / "out.npy")), want)


def test_frozen_lenet_exports(tmp_path):
    from paddle_tpu_torch.inference import freeze_program

    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name="img", shape=[1, 28, 28],
                                 dtype="float32")
        c1 = t_nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=8, pool_size=2,
            pool_stride=2, act="relu")
        c2 = t_nets.simple_img_conv_pool(
            input=c1, filter_size=5, num_filters=16, pool_size=2,
            pool_stride=2, act="relu")
        pred = tfluid.layers.fc(input=c2, size=10, act="softmax")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    x = np.random.RandomState(2).rand(4, 1, 28, 28).astype(np.float32)
    d = str(tmp_path / "frozen")
    with tfluid.scope_guard(scope):
        exe.run(startup)
        frozen, _ = freeze_program(main, ["img"], [pred.name], scope=scope)
        tfluid.io.save_inference_model(
            d, ["img"], [frozen.global_block().var(pred.name)], exe,
            main_program=frozen, export_format="aot",
            example_feeds={"img": x})
        (want,) = exe.run(frozen, feed={"img": x}, fetch_list=[pred.name])
    (got,) = inference.create_paddle_predictor(_cpu_config(d)).run(
        {"img": x})
    np.testing.assert_array_equal(got.data, want)


def test_jax_artifact_leaves_the_port_on_native_files(tmp_path):
    d = str(tmp_path / "model")
    x = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    main, startup, pred, _ = _mlp(jfluid, j_unique_name.guard)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(
            d, ["img"], [pred], exe, main_program=main,
            export_format="aot", example_feeds={"img": x})
        prog, _, fetches = jfluid.io.load_inference_model(d, exe)
        (want,) = exe.run(prog, feed={"img": x},
                          fetch_list=[f.name for f in fetches])
    ap = inference.create_paddle_predictor(_cpu_config(d))
    assert ap._aot is None
    (got,) = ap.run({"img": x})
    np.testing.assert_allclose(got.data, np.asarray(want), rtol=1e-5,
                               atol=1e-7)
