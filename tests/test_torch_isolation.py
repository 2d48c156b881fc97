"""The port (paddle_tpu_torch/), chip_smoke.py and
tools/torch_flash_variants.py stand alone: they import
neither JAX nor the JAX package (the serving stack, observability and
flags included), and the port never falls back to the CPU when CUDA is
missing."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import inference, platform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CPU_RUN = r"""
import sys
import numpy as np
import paddle_tpu_torch
import paddle_tpu_torch.fluid as fluid
import paddle_tpu_torch.inference
import paddle_tpu_torch.observability
from paddle_tpu_torch import flags
from paddle_tpu_torch.inference import admission, serving
from paddle_tpu_torch.layers.nn import fused_attention
from paddle_tpu_torch.observability import (
    export, goodput, health, metrics, reqtrace, tracing)

main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup):
    x = fluid.layers.data(name="x", shape=[2, 8, 4], dtype="float32")
    lens = fluid.layers.data(name="lens", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=x, size=4, num_flatten_dims=3, act="gelu")
    out = fused_attention(h, h, h, causal=True, seq_lens=lens)
exe = fluid.Executor(fluid.CPUPlace())
exe.run(startup)
(res,) = exe.run(main, feed={"x": np.ones((3, 2, 8, 4), np.float32),
                             "lens": np.array([[8], [3], [1]])},
                 fetch_list=[out])
assert res.shape == (3, 2, 8, 4) and np.isfinite(res).all()

# one training step: append_backward, Adam and the grad lowerings
# (fused_attention_grad, mul_grad, gelu_grad and the generic vjp)
train, train_startup = fluid.Program(), fluid.Program()
with fluid.program_guard(train, train_startup):
    x = fluid.layers.data(name="x", shape=[2, 8, 4], dtype="float32")
    lens = fluid.layers.data(name="lens", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=x, size=4, num_flatten_dims=3, act="gelu")
    att = fused_attention(h, h, h, causal=True, seq_lens=lens)
    loss = fluid.layers.mean(att)
    fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
exe.run(train_startup)
(l0,) = exe.run(train, feed={"x": np.ones((3, 2, 8, 4), np.float32),
                             "lens": np.array([[8], [3], [1]])},
                fetch_list=[loss])
assert np.isfinite(l0).all()
assert any(op.type == "fused_attention_grad" for op in train.desc.global_block().ops)

# the same step under bf16 AMP (contrib.mixed_precision), whose cache
# entry runs with check_nan_inf on
from paddle_tpu_torch.contrib import mixed_precision
mixed_precision.enable_bf16(train)
flags.set_flags({"check_nan_inf": True})
(l1,) = fluid.Executor(fluid.CPUPlace()).run(
    train, feed={"x": np.ones((3, 2, 8, 4), np.float32),
                 "lens": np.array([[8], [3], [1]])}, fetch_list=[loss])
assert np.isfinite(l1).all()

# the ResNet slice: conv2d, batch_norm, pool2d and their grads, Momentum,
# the normal initializers, softmax, top_k and accuracy
from paddle_tpu_torch.layers import metric_op
from paddle_tpu_torch.models import mnist, resnet
from paddle_tpu_torch.ops import metric_ops
for build in (lambda: resnet.get_model(dataset="cifar10", depth=8),
              lambda: mnist.get_model(use_conv=True)):
    net, net_startup, h = build()
    exe.run(net_startup)
    loss_acc = exe.run(net, feed={"img": np.ones((2,) + tuple(
        h["img"].shape[1:]), np.float32), "label": np.array([[1], [2]])},
        fetch_list=[h["loss"], h["acc"]])
    assert all(np.isfinite(v).all() for v in loss_acc)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "paddle_tpu" or m.startswith("paddle_tpu."))
print("LOADED", bad)
"""


def test_import_and_cpu_run_load_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CPU_RUN], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def _port_sources():
    pkg = os.path.join(ROOT, "paddle_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh", ".h")):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "tools", "torch_flash_variants.py")


@pytest.mark.parametrize("pattern", [
    r"\bjax\b",                          # the module, in any form
    r"\bpaddle_tpu\.",                   # a JAX-package module path
    r"\b(?:from|import)\s+paddle_tpu\b",  # an import of the JAX package
])
def test_no_source_names_jax(pattern):
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                if re.search(pattern, line):
                    offenders.append("%s:%d: %s" % (
                        os.path.relpath(path, ROOT), lineno, line.strip()))
    assert not offenders, "\n".join(offenders)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_executor_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fluid.Executor(fluid.CUDAPlace(0))
    assert platform.default_place() == fluid.CUDAPlace(0)
    fluid.Executor(fluid.CPUPlace())  # the CPU only when asked for


def test_predictor_without_cuda_raises(no_cuda, tmp_path):
    from paddle_tpu_torch import unique_name

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        y = fluid.layers.fc(input=x, size=2)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path), ["x"], [y], exe,
                                      main_program=main)
    config = inference.AnalysisConfig(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.create_paddle_predictor(config)
    config.disable_gpu()
    predictor = inference.create_paddle_predictor(config)
    (out,) = predictor.run({"x": np.ones((2, 3), np.float32)})
    assert out.data.shape == (2, 2)
    # serve() puts a server over the predictor's own (CPU) executor
    server = predictor.serve(buckets=(1, 2))
    assert isinstance(server, inference.InferenceServer)
    assert server.device == torch.device("cpu")
    with server:
        (served,) = server.run({"x": np.ones((1, 3), np.float32)})
    np.testing.assert_allclose(served, out.data[:1], rtol=1e-6)


def test_server_without_cuda_raises(no_cuda):
    """A server built over the default executor (``Executor()``, the
    card) raises without CUDA rather than serving on the CPU."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        y = fluid.layers.fc(input=x, size=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.InferenceServer(main, ["x"], [y], scope=fluid.Scope())


def test_unported_paths_raise():
    config = inference.AnalysisConfig("unused")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        config.enable_mkldnn()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        config.enable_tensorrt_engine()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fluid.io.save_inference_model("unused", [], [], None,
                                      export_format="aot")
