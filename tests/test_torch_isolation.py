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
# the training loop's features: the schedulers, the new optimizers, the
# clip ops, accumulation, remat, the dispatch window and the feeder
from paddle_tpu_torch.engine import pipeline
from paddle_tpu_torch.layers import learning_rate_scheduler, ops
loop, loop_startup = fluid.Program(), fluid.Program()
with fluid.program_guard(loop, loop_startup):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    h = fluid.layers.batch_norm(fluid.layers.fc(input=x, size=4,
                                                act="sigmoid"))
    loss = fluid.layers.mean(fluid.layers.square(h))
    fluid.clip.set_gradient_clip(fluid.clip.GradientClipByGlobalNorm(1.0))
    fluid.optimizer.RMSProp(
        learning_rate=fluid.layers.linear_lr_warmup(
            fluid.layers.noam_decay(8, 2), 2, 0.0, 0.1),
        regularization=fluid.regularizer.L1Decay(1e-3)).minimize(loss)
    fluid.clip.set_gradient_clip(None)
exe.run(loop_startup)
batches = [{"x": np.full((4, 4), i, np.float32)} for i in range(3)]
for kw in ({"accumulate_steps": 2}, {"remat_segments": 2},
           {"dispatch_steps": 2}):
    for f in pipeline.prefetch_to_device(lambda: iter(batches),
                                         device="cpu")():
        out = exe.run(loop, feed=f, fetch_list=[loss], **kw)
    exe.sync()
    assert np.isfinite(np.asarray(out[0])).all()
# control flow and recurrence: the stacked LSTM trained a step, its
# for_test clone, and a While loop
from paddle_tpu_torch.layers import control_flow
from paddle_tpu_torch.models import lstm, mobilenet, se_resnext, vgg
from paddle_tpu_torch.ops import controlflow_ops, rnn_ops, sequence_ops
net, net_startup, h = lstm.get_model(batch_size=2, seq_len=4, dict_dim=20,
                                     emb_dim=8, hidden_dim=8)
exe.run(net_startup)
seq = {"seq": np.ones((2, 4), np.int64), "label": np.array([[0], [1]])}
(l2,) = exe.run(net, feed=seq, fetch_list=[h["loss"]])
(lg,) = exe.run(net.clone(for_test=True), feed={"seq": seq["seq"]},
                fetch_list=[h["logits"]])
assert np.isfinite(l2).all() and lg.shape == (2, 2)
loop, loop_startup = fluid.Program(), fluid.Program()
with fluid.program_guard(loop, loop_startup):
    i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
    n = fluid.layers.fill_constant(shape=[1], dtype="int64", value=3)
    cond = fluid.layers.less_than(x=i, y=n)
    with fluid.While(cond=cond).block():
        fluid.layers.increment(i, value=1, in_place=True)
        fluid.layers.less_than(x=i, y=n, cond=cond)
(iv,) = exe.run(loop, feed={}, fetch_list=[i])
assert int(iv[0]) == 3
# the dense op families: an FCN-style head (conv2d_transpose,
# group_norm, prelu, resize_bilinear) trained a step, a nets block, and
# the streaming auc against the host-side metric
from paddle_tpu_torch import metrics as host_metrics, nets
from paddle_tpu_torch.ops import loss_ops, math_ops, nn_ops, tensor_ops
head, head_startup = fluid.Program(), fluid.Program()
with fluid.program_guard(head, head_startup):
    img = fluid.layers.data(name="img", shape=[4, 3, 3], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    up = fluid.layers.conv2d_transpose(img, num_filters=4, filter_size=4,
                                       stride=2, padding=1)
    up = fluid.layers.prelu(fluid.layers.group_norm(up, groups=2),
                            mode="channel")
    up = nets.simple_img_conv_pool(up, num_filters=2, filter_size=1,
                                   pool_size=2, pool_stride=2)
    up = fluid.layers.resize_bilinear(up, out_shape=[4, 4])
    logits = fluid.layers.reshape(fluid.layers.transpose(
        up, perm=[0, 2, 3, 1]), shape=[-1, 2])
    probs = fluid.layers.softmax(logits)
    auc, _ = fluid.layers.auc(probs, label)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
exe.run(head_startup)
hfeed = {"img": np.ones((2, 4, 3, 3), np.float32),
         "label": np.array([[0], [1]] * 16)}
l3, a3, p3 = exe.run(head, feed=hfeed, fetch_list=[loss, auc, probs])
host_auc = host_metrics.Auc()
host_auc.update(p3, hfeed["label"])
assert np.isfinite(l3).all() and abs(host_auc.eval() - float(a3)) < 1e-6
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
    exe = fluid.Executor(fluid.CPUPlace())
    for kw, item in (({"opt_level": 2}, "item 8"), ({"mesh": "dp"}, "item 10"),
                     ({"opt_level": 3}, "analysis and transforms")):
        with pytest.raises(NotImplementedError, match=item):
            exe.run(fluid.Program(), **kw)
