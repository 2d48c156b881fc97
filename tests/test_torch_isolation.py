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
att_out = out

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
# the sequence and beam-search slice: a BeamSearchDecoder decode over a
# gru_unit cell, and a CRF tagger's step and Viterbi path
from paddle_tpu_torch.contrib import decoder
from paddle_tpu_torch.ops import beam_search_ops, misc_ops
dec, dec_startup = fluid.Program(), fluid.Program()
with fluid.program_guard(dec, dec_startup):
    init_ids = fluid.layers.data(name="init_ids", shape=[1], dtype="int64")
    init_scores = fluid.layers.data(name="init_scores", shape=[1],
                                    dtype="float32")
    boot = fluid.layers.data(name="boot", shape=[4], dtype="float32")
    cell = decoder.StateCell(inputs={"x": None},
                             states={"h": decoder.InitState(init=boot)},
                             out_state="h")

    @cell.state_updater
    def updater(c):
        gates = fluid.layers.fc(input=c.get_input("x"), size=12)
        c.set_state("h", fluid.layers.gru_unit(gates, c.get_state("h"),
                                               size=12)[0])

    beam = decoder.BeamSearchDecoder(
        state_cell=cell, init_ids=init_ids, init_scores=init_scores,
        target_dict_dim=9, word_dim=4, sparse_emb=False, max_len=3,
        beam_size=2, end_id=1)
    beam.decode()
    sent_ids, sent_scores = beam()
exe.run(dec_startup)
ids, scores = exe.run(dec, feed={
    "init_ids": np.zeros((4, 1), np.int64),
    "init_scores": np.array([[0.0], [-1e9]] * 2, np.float32),
    "boot": np.ones((4, 4), np.float32)}, fetch_list=[sent_ids, sent_scores])
assert ids.shape == (4, 256) and np.isfinite(scores).all()
tag, tag_startup = fluid.Program(), fluid.Program()
with fluid.program_guard(tag, tag_startup):
    words = fluid.layers.data(name="words", shape=[5, 3], dtype="float32")
    labels = fluid.layers.data(name="labels", shape=[5], dtype="int64")
    lens = fluid.layers.data(name="lens", shape=[1], dtype="int64")
    emission = fluid.layers.fc(input=words, size=4, num_flatten_dims=2)
    ll = fluid.layers.linear_chain_crf(
        emission, labels, param_attr=fluid.ParamAttr(name="crfw"),
        length=lens)
    crf_loss = fluid.layers.mean(fluid.layers.scale(ll, scale=-1.0))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(crf_loss)
    path = fluid.layers.crf_decoding(
        emission, param_attr=fluid.ParamAttr(name="crfw"), length=lens)
exe.run(tag_startup)
l4, p4 = exe.run(tag, feed={"words": np.ones((2, 5, 3), np.float32),
                            "labels": np.ones((2, 5), np.int64),
                            "lens": np.array([[5], [2]])},
                 fetch_list=[crf_loss, path])
assert np.isfinite(l4).all() and p4.shape == (2, 5) and not p4[1, 2:].any()
# the misc family: a skip-gram step through the nce head, and a program
# through py_func (with its grad) and Print
import chip_smoke
from paddle_tpu_torch.layers import nn as nn_layers
sg, sg_startup = fluid.Program(), fluid.Program()
with fluid.program_guard(sg, sg_startup):
    sgh = chip_smoke.skipgram(fluid, vocab=30, dim=4, neg=3, lr=0.1)
exe.run(sg_startup)
(l5,) = exe.run(sg, feed=chip_smoke.skipgram_feed(8, vocab=30, seed=1),
                fetch_list=[sgh["loss"]])
assert np.isfinite(l5).all()
hp, hp_startup = fluid.Program(), fluid.Program()
with fluid.program_guard(hp, hp_startup):
    hph = chip_smoke.host_ops(fluid, 4, 3)
exe.run(hp_startup)
(l6,) = exe.run(hp, feed={"x": np.ones((4, 3), np.float32)},
                fetch_list=[hph["loss"]])
assert np.isfinite(l6).all()
# the detection and CTC families: a tiny SSD step (the match scan, the
# matching ops, ssd_loss), its detections (multiclass_nms), a CTC step,
# the samplers and detection_map
from paddle_tpu_torch.layers import detection
from paddle_tpu_torch.models import mobilenet
from paddle_tpu_torch.ops import detection_ops, loss_ops
ssd_cfg = dict(classes=3, image=64, scale=0.125, gt_boxes=2,
               min_sizes=[12.0, 21.0, 30.0, 39.0, 48.0, 57.0],
               max_sizes=[[], 30.0, 39.0, 48.0, 57.0, 64.0], lr=0.01,
               momentum=0.9, l2=5e-4)
nms = dict(nms_threshold=0.45, nms_top_k=10, keep_top_k=5,
           score_threshold=0.01)
for is_train in (True, False):
    sd, sd_startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(sd, sd_startup):
        sdh = chip_smoke.ssd_mobilenet(fluid, mobilenet, 2,
                                       is_train=is_train, nms=nms,
                                       **ssd_cfg)
    exe.run(sd_startup)
    sd_feed = chip_smoke.ssd_feed(2, seed=1, **ssd_cfg)
    if not is_train:
        sd_feed = {"image": sd_feed["image"]}
    (o7,) = exe.run(sd, feed=sd_feed,
                    fetch_list=[sdh["loss" if is_train else "dets"]])
    assert np.isfinite(o7).all() if is_train else o7.shape == (2, 5, 6)
ct, ct_startup = fluid.Program(), fluid.Program()
with fluid.program_guard(ct, ct_startup):
    cx = fluid.layers.data(name="cx", shape=[6, 4], dtype="float32")
    cl = fluid.layers.data(name="cl", shape=[2], dtype="int64")
    ctc = fluid.layers.mean(fluid.layers.warpctc(
        fluid.layers.fc(input=cx, size=5, num_flatten_dims=2), cl))
    dist, _ = fluid.layers.edit_distance(cl, cl)
    fluid.optimizer.SGD(learning_rate=0.1).minimize(ctc)
    m_ap = fluid.layers.detection_map(
        fluid.layers.data(name="dets", shape=[3, 6], dtype="float32"),
        fluid.layers.data(name="gts", shape=[2, 5], dtype="float32"),
        class_num=3)
exe.run(ct_startup)
l8, d8, m8 = exe.run(ct, feed={
    "cx": np.ones((2, 6, 4), np.float32),
    "cl": np.array([[1, 2], [3, 3]]),
    "dets": np.array([[[1, 0.9, 0.1, 0.1, 0.5, 0.5]] * 3] * 2, np.float32),
    "gts": np.array([[[1, 0.1, 0.1, 0.5, 0.5]] * 2] * 2, np.float32)},
    fetch_list=[ctc, dist, m_ap])
assert np.isfinite(l8).all() and not d8.any() and 0 < float(m8[0]) <= 1
# the input pipeline: the native layer, RecordIO, the readers, the
# datasets, the DataFeeder and the reader layers, feeding a py_reader
import os, tempfile
from paddle_tpu_torch import (core_shim, data_feed_desc, data_feeder,
                              dataset, native, reader, recordio,
                              recordio_writer)
from paddle_tpu_torch.contrib.reader import ctr_reader
from paddle_tpu_torch.layers import io as io_layers
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "mnist.rio")
    recordio_writer.convert_reader_to_recordio_file(
        path, reader.firstn(dataset.mnist.train(), 8))
    rio, rio_startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(rio, rio_startup):
        rd = fluid.layers.py_reader(capacity=2, shapes=[[-1, 784], [-1]],
                                    dtypes=["float32", "int64"])
        pred = fluid.layers.fc(input=rd.vars[0], size=10)
        lbl = fluid.layers.reshape(rd.vars[1], [-1, 1])
        rloss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(pred, lbl))
    rows = fluid.layers.open_files(path, shapes=[[784], []],
                                   dtypes=["float32", "int64"])
    rd.decorate_paddle_reader(reader.map_readers(
        lambda b: [np.stack([r[0] for r in b]), np.stack([r[1] for r in b])],
        fluid.layers.batch(rows, 4)))
    exe.run(rio_startup)
    rd.start()
    seen = []
    while True:
        try:
            seen.append(exe.run(rio, fetch_list=[rloss])[0])
        except fluid.EOFException:
            break
assert len(seen) == 2 and all(np.isfinite(v).all() for v in seen)
assert native.loaded_path().startswith(os.path.join(
    os.path.dirname(paddle_tpu_torch.__file__), "native", "_build"))
# checkpoints, the reference format and the fault seams: the training
# program's state saved and restored in place, the attention program
# exported in the reference format and served, a compile fault retried
from paddle_tpu_torch import checkpoint, compat, resilience
from paddle_tpu_torch.resilience import faultinject, retrying
with tempfile.TemporaryDirectory() as d:
    mgr = fluid.io.CheckpointManager(os.path.join(d, "ckpt"))
    fluid.io.save_checkpoint_async(mgr, 1, main_program=train,
                                   blocking=True)
    assert fluid.io.load_checkpoint(mgr, main_program=train) == 1
    ref = os.path.join(d, "ref")
    fluid.io.save_inference_model(ref, ["x", "lens"], [att_out], exe,
                                  main_program=main,
                                  export_format="reference")
    prog, _, fetches = compat.load_reference_inference_model(ref, exe)
    (r2,) = exe.run(prog, feed={"x": np.ones((3, 2, 8, 4), np.float32),
                                "lens": np.array([[8], [3], [1]])},
                    fetch_list=[v.name for v in fetches])
    assert np.array_equal(r2, res)
    with open(os.path.join(ref, "__model__"), "rb") as f:
        fluid.Program.parse_from_string(f.read())
flags.set_flags({"fault_spec": "compile@1"})
try:
    fluid.Executor(fluid.CPUPlace()).run(loop, feed={}, fetch_list=[i])
except faultinject.InjectedFault:
    pass
else:
    raise AssertionError("the compile fault did not fire")
flags.reset_flag("fault_spec")
# the opt-level ladder and the INT8 path: a conv net at level 3 under a
# tiny budget with the NHWC layout pass, frozen, calibrated, quantized,
# served INT8 and exported AOT
from paddle_tpu_torch import aot, inference as inference_pkg
from paddle_tpu_torch.analysis import layout, memory as memplan
from paddle_tpu_torch.contrib import int8_inference, quantize, slim
from paddle_tpu_torch.inference import freeze, quantize as ptq
from paddle_tpu_torch.observability import memory as obs_memory
from paddle_tpu_torch.ops import quant_ops
conv, conv_startup = fluid.Program(), fluid.Program()
with fluid.program_guard(conv, conv_startup):
    img = fluid.layers.data(name="img", shape=[1, 8, 8], dtype="float32")
    lbl = fluid.layers.data(name="label", shape=[1], dtype="int64")
    c = fluid.layers.batch_norm(fluid.layers.conv2d(img, num_filters=4,
                                                    filter_size=3,
                                                    padding=1), act="relu")
    prob = fluid.layers.fc(input=fluid.layers.pool2d(c, pool_size=2),
                           size=3, act="softmax")
    closs = fluid.layers.mean(fluid.layers.cross_entropy(prob, lbl))
    fluid.optimizer.Adam(1e-2).minimize(closs)
cfeed = {"img": np.ones((2, 1, 8, 8), np.float32),
         "label": np.array([[0], [1]])}
flags.set_flags({"layout": "nhwc", "device_memory_bytes": 1 << 16})
with fluid.scope_guard(fluid.Scope()):   # its filters are baked HWIO
    exe.run(conv_startup)
    (cl,) = exe.run(conv, feed=cfeed, fetch_list=[closs], opt_level=3)
assert np.isfinite(cl).all() and obs_memory.device_memory_limit() == 1 << 16
flags.reset_flag("layout")
flags.reset_flag("device_memory_bytes")
exe.run(conv_startup)
int8_prog, _, qrep = ptq.post_training_quantize(
    conv, [{"img": cfeed["img"]}], feed_names=["img"],
    fetch_names=[prob.name], executor=exe, freeze_first=True)
assert qrep.quantized
(qp,) = exe.run(int8_prog, feed={"img": cfeed["img"]}, fetch_list=[prob])
assert np.isfinite(qp).all()
with tempfile.TemporaryDirectory() as d:
    fluid.io.save_inference_model(d, ["img"], [prob], exe,
                                  main_program=conv, export_format="aot",
                                  example_feeds={"img": cfeed["img"]})
    (ap,) = aot.AotPredictor(d).run({"img": cfeed["img"]})
    assert ap.shape == (2, 3)
# the mesh path: a 1-rank gloo world, the conv net trained over a dp=1
# mesh with ZeRO-1 through CompiledProgram and ParallelExecutor, and the
# ring at sp=1
from paddle_tpu_torch import compiler, parallel, parallel_executor
from paddle_tpu_torch.parallel import env, mesh, plan, ring_attention
from paddle_tpu_torch.parallel import sharding
env.init_single_process("cpu")
flags.set_flags({"zero": True, "grad_bucket_mb": 1.0})
with fluid.scope_guard(fluid.Scope()):
    exe.run(conv_startup)
    cp = fluid.CompiledProgram(conv).with_spmd(
        mesh_axes={"dp": 1}, device_type="cpu",
        shard_rules=parallel.ShardingRules(
            [("conv2d", parallel.PartitionSpec())]))
    (ml,) = exe.run(cp, feed=cfeed, fetch_list=[closs])
    (pl,) = fluid.ParallelExecutor(use_cuda=False, main_program=conv).run(
        [closs], feed=cfeed)
assert np.isfinite(ml).all() and np.isfinite(pl).all()
flags.reset_flag("zero")
flags.reset_flag("grad_bucket_mb")
import torch
qkv = torch.ones(1, 2, 4, 8)
assert parallel.ring_attention(qkv, qkv, qkv, mesh=mesh.make_mesh(
    {"sp": 1}, device_type="cpu"), causal=True).shape == (1, 2, 4, 8)
# the SPMD analysis and the parameter-server path: the conv net analysed
# over a dp=2 mesh (no devices) and transpiled for two pservers; the
# wire's framing round trip
from paddle_tpu_torch import distributed, transpiler
from paddle_tpu_torch.analysis import spmd
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.ops import distributed_ops
rep = spmd.analyze_spmd(conv, mesh={"dp": 2}, feed_shapes={
    "img": (2, 1, 8, 8), "label": (2, 1)}, fetch_names=[closs.name])
assert rep.psum_count > 0 and "spmd over mesh" in rep.render()
tr = fluid.DistributeTranspiler()
tr.transpile(0, program=conv, pservers="127.0.0.1:1,127.0.0.1:2",
             trainers=2, startup_program=conv_startup)
assert any(op.type == "send"
           for op in tr.get_trainer_program().desc.global_block().ops)
assert ps._decode_msg(ps._encode_msg(("get", torch.ones(2)))
                      )[1].tolist() == [1.0, 1.0]
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
            if name.endswith((".py", ".cu", ".cuh", ".h", ".cc")):
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
    # a program fed by a py_reader: its executor, a DataFeeder's staging
    # onto the card and a Preprocessor on the default place all raise
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        rd = fluid.layers.py_reader(capacity=2, shapes=[[-1, 3]],
                                    dtypes=["float32"])
        out = fluid.layers.fc(input=rd.vars[0], size=2)
    rd.decorate_paddle_reader(lambda: iter([[np.ones((2, 3), np.float32)]]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fluid.Executor().run(startup)
    feeder = fluid.DataFeeder(rd.vars, fluid.CUDAPlace(0), program=main)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        feeder.decorate_reader(lambda: iter([]), prefetch=True)
    pre = fluid.layers.Preprocessor(reader=rd)
    with pre.block():
        (x,) = pre.inputs()
        pre.outputs(fluid.layers.scale(x, scale=2.0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pre()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    rd.start()
    (res,) = exe.run(main, fetch_list=[out])
    assert res.shape == (2, 2)
    rd.reset()


def test_native_layer_builds_only_from_the_ports_sources(tmp_path,
                                                         monkeypatch):
    """The g++ command takes its sources from paddle_tpu_torch/native/
    alone and writes under native/_build/; the JAX package's copies and
    its in-place library are never read."""
    from paddle_tpu_torch import native

    calls = []

    class _Done:
        returncode = 0
        stdout = stderr = ""

    def record(cmd, **kw):
        calls.append(list(cmd))
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return _Done()

    monkeypatch.setattr(native.subprocess, "run", record)
    out = os.path.join(native.BUILD_DIR, "isolation-check.so")
    try:
        native._build(out)
    finally:
        if os.path.exists(out):
            os.remove(out)
    (cmd,) = calls
    port_dir = os.path.join(ROOT, "paddle_tpu_torch", "native")
    sources = [a for a in cmd if a.endswith((".cc", ".cpp", ".c", ".h"))]
    assert sorted(os.path.basename(a) for a in sources) == \
        sorted(native.SOURCES)
    assert all(os.path.dirname(a) == port_dir for a in sources), cmd
    assert cmd[cmd.index("-o") + 1].startswith(
        os.path.join(port_dir, "_build") + os.sep)
    assert os.path.dirname(native.library_path()) == \
        os.path.join(port_dir, "_build")
    assert not any(os.sep + "paddle_tpu" + os.sep in a for a in cmd)


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
    """``ParallelExecutor`` refuses the transpiler's transports with the
    reference's ``ValueError`` (pserver and nccl2 go through
    ``DistributeTranspiler``, ported with the parameter server); the INT8
    switches, the AOT export and levels 2 and 3, which raised before the
    opt-level ladder and the INT8 path were ported, do not, nor does
    ``mesh=`` since the mesh path was ported."""
    config = inference.AnalysisConfig("unused")
    config.enable_mkldnn()
    config.enable_tensorrt_engine()
    assert config._int8
    with pytest.raises(ValueError, match="export_format"):
        fluid.io.save_inference_model("unused", [], [], None,
                                      export_format="stablehlo")
    exe = fluid.Executor(fluid.CPUPlace())
    for strategy in ("pserver", "nccl2"):
        with pytest.raises(ValueError,
                           match="go through DistributeTranspiler"):
            fluid.ParallelExecutor(use_cuda=False, dist_strategy=strategy)
    for level in (2, 3):
        assert exe.run(fluid.Program(), opt_level=level) == []
