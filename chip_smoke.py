#!/usr/bin/env python3
"""On-card smoke test of ``paddle_tpu_torch``, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It drives the port's main paths, serving and training BERT-base and
ResNet-50 (with the training loop's accumulation, remat, dispatch
window, prefetching feeder, schedulers, clipping and optimizers),
training DeepFM with sparse embedding grads, word2vec and the
Transformer-base NMT model, the stacked-LSTM classifier with the
control-flow ops, VGG, MobileNet and SE-ResNeXt, BERT-base and the
Transformer built with unfused attention and fused back onto the
kernels at ``opt_level`` 1, the book programs, the dense op families, an
FCN decoder head and DeepFM with its streaming AUC, and its kernels on
the card and prints one JSON line per phase:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is turned off for matmul and cuDNN.
2. build   — builds every CUDA kernel of the port from the checkout's
   sources (one nvcc per source, started together) and times the build.
3. kernel  — the flash-attention forward kernel against its plain torch
   version on the same inputs, out and lse, case by case: BERT shapes
   (B=8, H=12, D=64) at T=128 and 512, float32 and bfloat16, causal or
   not, ragged seq_lens, a fully masked row under causal with offsets,
   Tq != Tk and T not a multiple of the tile (Tq = Tk = 200 in bf16: a
   partial last ring stage), unaligned offsets, head dims 32, 40 and 128,
   a head dim of 33 (rows not 16-byte aligned, which the kernels stage by
   plain loads), and dropout rate 0.1 with the same seed (identical
   masks); every kernel instance (head dims 32, 64, 128 in float32 and
   bfloat16) runs in at least one case. Then the shapes the Transformer's
   training step gives the kernels (B=32, H=8, T=256, D=64, dropout 0.1,
   the nmt batch's lengths), causal and not, float32 and bfloat16.
4. kernel_bwd — the dQ and dK/dV backward kernels against
   ``attention_bwd_plain`` on the same inputs, dq, dk and dv, in the same
   cases plus one with a nonzero lse cotangent; dropout with the same seed
   as the forward, and another seed must change the grads.
5. serve   — BERT-base (d 768, 12 layers, 12 heads, d_inner 3072, vocab
   30522, seq 128, fp32, random weights from the seed) built with
   ``models.bert.get_model``, initialised on the card by the startup
   program, saved with ``io.save_inference_model``, loaded by
   ``inference.create_paddle_predictor``, answering requests of batch 1, 4
   and 8 with ragged seq_lens. Checks shapes, finiteness, exactly 12 kernel
   launches per request, and one batch-1 answer against the same model
   directory served on the CPU (``config.disable_gpu()``).
6. serve_batched — the continuous-batching server over the same model
   directory: ``predictor.serve()`` with the default buckets (1, 2, 4, 8,
   16, 32) and max-wait 5 ms, ``warmup`` first, then closed-loop clients
   at 1, 8 and 32 threads, each sending batch-1 requests (200 at each
   level). Checks every answer against the same request answered alone by
   ``predictor.run`` (rtol 1e-4 / atol 1e-4), exactly 12 forward launches
   per dispatch (``fa.launches`` against ``serving.batches``), fewer
   dispatches than requests at 8 and 32 clients, an overload burst
   (``queue_limit`` 8, deadlines of a few batch times, 4x the top bucket
   at once, then ``stop()``) whose every future resolves to a result,
   ``DeadlineExceeded`` or ``Rejected`` with the ``serving.*`` counters
   adding up to the requests sent, and two threads launching the forward
   on an empty build directory (one build, no error). Prints requests per
   second, p50 and p99 of ``serving.request_ms`` and mean ``batch_fill``
   at each client count, and the device-busy share of one bucket-32
   dispatch.
7. times   — device times from torch.profiler for the forward kernel, its
   plain version and ``scaled_dot_product_attention`` (a yardstick the port
   never calls), the least time the card could take (bytes over 3.35 TB/s,
   or operations over the card's peak for the input type: 165 TFLOP/s
   float32, the 3xTF32 rate of the tensor cores, and 989 TFLOP/s bfloat16
   dense; float32 rows add bound_ffma_ms, the operations over 67 TFLOP/s,
   the float32 rate outside the tensor cores), at the main path's shape in
   float32 and in bfloat16 (the AMP path's), and the predictor's
   per-request latency at batch 1 and 8 (replayed graphs). A profiler
   window that holds no device activity is profiled again; a call whose
   kernel no window recorded is timed whole by CUDA events instead, and
   listed under ``event_timed`` in the last ``times`` line.
8. determinism — one BERT-base training step (batch 8, dropout 0.1) run
   twice eagerly from the same state, feed and run counter: every grad and
   the loss must be bitwise equal. The same two steps with the embedding
   grad scattered by ``index_add_`` (float atomics on CUDA, the scatter
   before ``index_put_``) print how many elements differ.
9. train   — BERT-base pre-training at the same width,
   ``get_model(is_train=True)`` (append_backward + Adam), dropout 0.1,
   startup on the card, 5 steps on a repeated ragged batch of 8, run
   eagerly and captured (one CUDA graph of the whole step, replayed from
   step 2) from the same state, step by step: the losses and every state
   tensor bitwise equal at every step. Checks finite and falling loss,
   exactly 12 forward, 12 dQ and 12 dK/dV launches a step (counted across
   replays, and checked once against the profiler's kernel counts), the
   step captured once and no block run eagerly, and one step at batch 2
   against the same step of the port on the CPU (loss and six parameter
   grads, from the same initial state via ``convert.load_numpy_state``).
10. train_amp — the same model minimized through
   ``contrib.mixed_precision.decorate`` (bfloat16 AMP), 5 captured steps
   from the same state: the loss finite and falling, the first loss within
   TRAIN_AMP_TOL of the float32 step's, the weights float32, 12 launches
   of each kernel a step, all bfloat16 instances.
11. times   — the backward kernels at the training shape (B=8 H=12 T=128
   D=64 float32 and bfloat16, ragged lengths) and at T=512 float32 and
   bfloat16: each kernel's device time and bound, the plain backward's,
   and the backward of ``scaled_dot_product_attention``; the training
   step's median wall, device-busy share and top kernels, eager and
   captured, and the AMP step's.
12. resnet50_serve — ResNet-50 (``models.resnet.get_model(dataset=
   "imagenet", depth=50, class_num=1000)``: 224x224, random weights from
   the seed) built, initialised on the card, saved with
   ``io.save_inference_model`` (feed ``img``, target ``logits``) and served
   by ``predictor.run`` at batch 1, 8 and 32: each shape eager once, then
   captured and replayed, the replays bitwise equal to the eager answer;
   no flash launch; the batch norms' running statistics read and never
   written; batch 2 against the CPU predictor (SERVE_TOL); request times
   and the batch-32 request's device profile.
13. resnet50_determinism — one ResNet-50 training step (batch 32) run
   twice eagerly from the same state, with cuDNN's default algorithms
   (printed: how many elements of which grads differ) and with the
   deterministic ones the port's CUDA engine selects (every grad and the
   loss bitwise equal).
14. resnet50_train — ResNet-50 trained with Momentum 0.9 at lr 0.1 (the
   JAX package's ResNet-50 bench), batch 32, one batch repeated, 5 steps
   eagerly and captured from the same state: losses and every state
   tensor (the running statistics included) bitwise equal at every step;
   the loss finite and lower after the first step (it climbs after, in
   the JAX package too: tests/test_torch_resnet_trajectory.py); every
   running statistic moved; no flash launch; the ``for_test`` clone
   deterministic and reading the running statistics only;
   ``memory_reserved`` after the capture; one step at batch 2 against the
   CPU: the loss end to end (TRAIN_TOL), and every op of the step run on
   the card from the CPU's operands (RESNET_OP_TOL).
15. resnet50_train_amp — the same model under ``enable_bf16``, 5 captured
   steps: the first loss within TRAIN_AMP_TOL of the float32 step's, the
   loss falling, weights and running statistics float32, the convolution
   kernels bf16 (profiler), no flash launch.
16. times   — the ResNet-50 step's median wall, images per second, busy
   ms, idle share and top kernels: eager, captured, captured under AMP,
   and captured with cuDNN's default algorithms (the deterministic
   algorithms' cost).
17. optimizers — the eight update ops of the training loop's slice
   (lars_momentum, adamax, adagrad, decayed_adagrad, adadelta, rmsprop,
   ftrl, model_average_accum) on the card against the CPU from identical
   operands, at BERT-base's word embedding (30522 x 768) and an FFN
   weight (768 x 3072): every output within OPT_TOL * max|want|. Then
   ``ModelAverage`` beside SGD on a small MLP, captured: ``apply``
   writes each window mean in place, a captured evaluation reads it, and
   ``restore`` puts the weights back bitwise.
18. bert_recipe — BERT-base at seq 512 (ragged, dropout 0.1, float32),
   the forward of ``models.bert`` with the reference's pre-training
   recipe appended here: Adam over ``linear_lr_warmup(polynomial_decay)``,
   ``GradientClipByGlobalNorm(1.0)`` and ``L2Decay(0.01)``. Run captured
   and, step by step, eagerly from the same state: (b) batch 8 with
   ``remat_segments=12`` and with none (the peak allocation of the eager
   first run, ``memory_reserved`` after the capture, 24 forward and 12
   dQ and dK/dV launches a remat step against 12 each, the remat step
   run twice bitwise equal, remat against plain within TRAIN_TOL); (a)
   ``accumulate_steps=4`` over a batch of 32; (c) 8 steps at
   ``dispatch_steps=4`` captured and eager and at depth 1, read only at
   the end. Every captured run bitwise equal to its eager run, the
   learning rate fetched each step on its closed form (under
   accumulation the mean over the micro-batches' counter values); step
   ms, sequences/s, busy ms and idle share of each.
19. resnet50_pipelined — ResNet-50 at batch 32 (Momentum, captured), fed
   from a pool of 3 host batches: the synchronous loop against
   ``prefetch_to_device`` (pinned buffers, a copy stream, depth 2) with
   ``dispatch_steps=2``, from the same state: losses bitwise equal; step
   ms, images/s, the card's active ms and idle share, and the feed's
   host-to-device copy time a step and the share of it during which a
   kernel ran (profiler intervals).
20. mfu — the ``mfu.*`` gauges (goodput ledger on, ``peak_flops`` the
   card's: 67 TFLOP/s float32 on the FFMA path, TF32 being off, 989
   bf16) of the captured BERT-base (seq 128, batch 8) and ResNet-50
   (batch 32) steps, float32 and AMP; ResNet-50's counted FLOPs within
   MFU_TOL of the analytic 0.79 TFLOP a step.
21. ctr    — DeepFM as the JAX package's CTR bench builds it (39 fields
   over 1M ids, 16-dim ``is_sparse`` tables, batch 2048, Adam 1e-3):
   ``lookup_table_grad`` and lazy Adam at that geometry under
   ``torch.cuda.set_sync_debug_mode("error")`` (no op waits for the
   card); 4 steps captured and eagerly from the same state, step by step,
   losses and every state tensor bitwise equal; a second captured run
   bitwise equal; the step one graph; the rows no batch touched bitwise
   unchanged in each table and both its moments, the touched ones moved;
   no flash launch; one step at batch 64 against the CPU (loss and
   grads, TRAIN_TOL); the sparse step's and the dense control's
   (``is_sparse`` off) ms, examples/s and top kernels. Then word2vec at
   its defaults: 3 captured steps against the CPU (losses TRAIN_TOL,
   parameters OPT_TOL * max).
22. nmt    — Transformer-base as the JAX package's NMT bench builds it
   (6+6 layers, d_model 512, 8 heads, d_inner 2048, vocab 32768, seq
   256, batch 32, ragged lengths, dropout 0.1, label smoothing 0.1,
   Adam), float32 and under ``enable_bf16``: 4 captured steps, 18 launches
   of each flash kernel a step (6 encoder, 6 causal decoder and 6 cross
   attentions; the profiler's count of a replay agrees), one graph, the
   eager first run's peak allocation, step ms, target tokens/s, idle
   share and top kernels, the ``mfu.*`` gauges; AMP's first loss within
   TRAIN_AMP_TOL of float32's. One step at batch 2 and dropout 0 against
   the CPU: the loss end to end (TRAIN_TOL), every op on the CPU's
   operands (RESNET_OP_TOL), and every grad end to end against the CPU
   step that takes the card's relu decisions (TRAIN_TOL; a relu input
   within rounding of 0 may decide otherwise on the CPU, and moves its
   token's grads by percents); the same step and the attention ops again
   with the plain torch attention in the kernels' place on the card, and
   both card runs' relu decisions unlike the CPU's printed. The kernels
   at B=32 H=8 T=256 D=64 with the batch's lengths, causal and not,
   float32 and bfloat16: ms, bound, plain and SDPA.
23. lstm   — the stacked-LSTM classifier (``models.lstm``: two
   ``StaticRNN`` LSTM layers, each one ``recurrent`` op looping over the
   time steps) at the width of the reference benchmark the JAX builder
   names (benchmark/fluid/models/stacked_dynamic_lstm.py: embedding and
   LSTM 512 wide, 5000 words), batch 32, seq 256 (cut from the
   benchmark's 1500-token crop), float32, Adam: 5 steps eagerly and
   captured from the same state, the losses and every state tensor
   bitwise equal at every step; the loss finite and lower after the first
   step; one graph, captured once, no eager block; no flash launch;
   ``memory_reserved`` after the capture; one step at batch 2 against the
   CPU (loss TRAIN_TOL, every parameter grad within 1e-3 of its max). The
   ``for_test`` clone served at batch 1 and 32, eager and then replayed,
   the replays bitwise equal to the eager answer, batch 2 against the CPU
   (SERVE_TOL). The captured and eager step's median ms, examples/s and
   tokens/s, the device-busy share, kernel launches a captured step and
   top kernels, the capture run's ms, and the ``recurrent`` and
   ``recurrent_grad`` ops' ms in an eager step. ``dynamic_lstm`` and
   ``dynamic_gru`` at [32, 256, 4x512 / 3x512] with ragged lengths,
   reversed, with peepholes, ``origin_mode``: forward and grads against
   the CPU (RNN_OP_TOL). A ``While`` loop writing a tensor array runs
   eagerly and counts in ``engine.eager_runs``; an ``IfElse`` and a
   ``Switch`` are captured and agree with the CPU; dropout inside a
   ``StaticRNN`` cell, captured against eager, bitwise equal, its masks
   differing between time steps.
24. image_models — VGG-16 (``models.vgg``, 3x32x32, 10 classes, Adam),
   MobileNet-V1 (224x224, 1000 classes, scale 1.0, Momentum) and
   SE-ResNeXt-50 (224x224, 1000 classes, cardinality 32, Momentum), each
   at batch 32, float32: 3 steps eagerly and captured from the same
   state, bitwise equal (cuDNN's deterministic algorithms, grouped and
   depthwise convolutions included); the loss finite; one graph; no
   flash launch; one step at batch 2 against the CPU, every op on the
   CPU's operands (IMAGE_OP_TOL: RESNET_OP_TOL, and for a grad that sums
   to rounding noise, 1e-4 of the op's incoming grad) and the loss end to
   end (TRAIN_TOL);
   step ms, images/s, idle share and top kernels.
25. fuse_attention — BERT-base built unfused (``use_fused_attention=
   False``: matmul, the ``attention_bias_from_lens`` mask, softmax,
   dropout, matmul) from the ``train`` phase's initial state, trained at
   the default ``opt_level`` 1: the engine's fuse-attention pass rewrites
   the 12 attentions at the cache miss (``transform.*`` counters,
   ``transform.pipeline_ms``), 5 steps eagerly and captured, bitwise
   equal, 12 launches of each kernel a step. At dropout 0, 3 steps of the
   fused builder's program, of the unfused one at level 1 (losses within
   FUSE_TOL's 1e-6, printed whether bitwise, every grad within 1e-3 of
   its max) and at level 0 (the composition: no flash launch, losses
   within 1e-4 of level 1's): each one's captured step time and eager
   first-run peak.
26. verify — one unfused step with ``verify=True``: no ERROR finding;
   the findings of the desc that ran, by severity.
27. fuse_attention_serve — the unfused BERT-base saved for serving and
   answered by the predictor at the default level (12 forward launches a
   request) and with ``switch_ir_optim(False)`` (none), batch 1 and 8:
   the answers across levels, batches and the CPU within SERVE_TOL;
   replayed latencies.
28. nmt_unfused — Transformer-base at its ``nmt`` width built unfused,
   dropout 0: 12 rewrites (6 encoder self, 6 cross; the causal ones are
   fused as built), 18 launches of each kernel a step, 2 captured steps
   against the fused program's (FUSE_TOL's 1e-5), step ms.
29. book — the four book programs (``models.book``: fit_a_line,
   recognize_digits, word2vec, machine_translation) with Adam, 5 steps on
   the card (captured) against the CPU's on the same seeded batches
   (TRAIN_TOL), then saved, loaded and served against the training
   program's ``for_test`` clone.
30. dense_ops — every lowering of the dense op families (the tensor
   ops, the image ops of nn_ops, the regression losses, auc,
   precision_recall, chunk_eval, elementwise mod and floordiv) on the card
   against the same lowering on the CPU from the same seeded operands, at
   the shapes their users give them (``dense_cases``: group_norm(32) at
   ResNet-50's stage 2, the 28 -> 56 transposed convolution and resizes,
   AlexNet's lrn, BERT's tokens and vocab logits, DeepFM's 2048 x 39 ids
   into a 1M-row table, ...): forward and the vjp grads within DENSE_TOL,
   integer and bool outputs exact; gather, scatter, the resizes and
   maxout run twice, bitwise equal; device ms of each forward and vjp.
31. upsample_head — an FCN decoder (UPSAMPLE) built from
   ``fluid.layers`` on ResNet-50's last stage at 224x224, batch 8:
   ``conv2d_transpose``, ``group_norm``, ``prelu``, a 1x1 conv to 21
   classes, ``resize_bilinear`` to 224x224, per-pixel softmax cross
   entropy, Momentum: 5 steps eagerly and captured, bitwise equal; one
   graph; no flash launch; one step against the CPU (UPSAMPLE_TOL); step
   ms, idle share and top kernels.
32. ctr_auc — the ctr phase's DeepFM with ``layers.auc`` on its
   predictions: 20 steps captured and eagerly, the int64 histograms
   bitwise equal step by step and equal to ``metrics.Auc`` fed the
   fetched predictions on the host, the AUC within CTR_AUC_TOL of the
   ``auc`` lowering on the CPU; one graph, captured once; the step's ms
   against the program without the auc op.
33. kernels — one JSON object listing every ported kernel, with its
   design: all three run their products on the tensor cores (mma.sync
   bf16, 3xTF32 for float32) from a cp.async tile ring, and read their
   dropout seed from device memory; each kernel's launches on every path,
   the ResNet-50, training-loop, CTR, NMT, LSTM, image, unfused-attention,
   book and dense-op paths included, and its
   times at the Transformer's shapes (``nmt_t256``).

Served requests and dispatches run as captured CUDA graphs too: the first
run of each shape (and each server bucket) is eager, the second captures
it, later ones replay; ``serve_batched``'s ``warmup`` captures every
bucket, checks that no served block ran eagerly, and prints
``torch.cuda.memory_reserved()`` after every capture.

The last line is ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero; it exits non-zero without a result when
CUDA is unavailable or the port's package is not beside it.
"""

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM, NVIDIA data sheet: HBM rate and the dense peak for each input
# type. Every kernel takes its products on the tensor cores, float32 ones
# as 3xTF32: three TF32 products each at 495 TFLOP/s, so bound_ms takes
# float32 operations at 165 TFLOP/s. Float32 rows also carry
# bound_ffma_ms, the same operations at the 67 TFLOP/s rate outside the
# tensor cores, the bound that PRs 1-3 reported as bound_ms, so rows stay
# comparable over time.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_FFMA_FLOPS_PER_S = 67e12
PEAKS = ("3.35 TB/s HBM; 165 TFLOP/s float32 as 3xTF32 on the tensor "
         "cores (bound_ffma_ms: 67 TFLOP/s, float32 outside the tensor "
         "cores), 989 TFLOP/s bfloat16 dense on the tensor cores")
# how every kernel computes its products, and where it reads its seed
DESIGN = "mma.sync bf16 / 3xTF32, cp.async ring"
SEED = "int64 in device memory (the engine's seed table)"

# out, |kernel - plain| <= rel * |plain| + abs_of_max_v * max|v| / (1 -
# rate) + abs. float32: the kernel takes its products as 3xTF32 (float32
# accuracy; the dropped small*small term is 2^-22 relative) and sums tiles
# of 64 keys with a running max, the plain version in one reduction
# (tests/test_torch_flash_tolerances.py emulates both on the CPU). bfloat16:
# both round a float32 result to bfloat16 at the end, and where the two
# float32 values straddle a rounding boundary they land one ulp apart, at
# most 2^-7 of the value. Both also round p to bfloat16 before P.V, as the
# reference's kernel does, but the kernel rounds exp(s - running max) and
# the plain version exp(s - row max): each rounding moves p_j by at most
# 2^-9 of itself, so the two sums differ by at most
# 2 * 2^-9 * sum_j p_j |v_j| / l <= 2^-8 * max|v| * sum_j p_j / l, and
# sum_j p_j / l is 1, or at most 1/(1-rate) after the dropout scale.
# lse is float32 in both.
TOL = {"float32": {"out_rel": 0.0, "out_abs_of_max_v": 0.0, "out_abs": 1e-4,
                   "lse": 1e-4},
       "bfloat16": {"out_rel": 2.0 ** -7, "out_abs_of_max_v": 2.0 ** -8,
                    "out_abs": 1e-5, "lse": 1e-4}}
# dq, dk, dv: |kernel - plain| <= rel * |plain| + abs_of_max * max|plain|
# + abs. float32: sums of up to 512 products taken in another order (the
# kernels loop over tiles, the plain version is one product), the kernels'
# as 3xTF32 products.
# bfloat16: both round p_drop and ds to bfloat16 before the products, as
# the reference's kernels do, and the grads to bfloat16 at the end. Where
# the two float32 values of one ds straddle a rounding boundary they take
# neighbouring bf16 values; that moves a grad by one ulp of one term, far
# below 2^-8 of the largest grad. The final rounding is one ulp, at most
# 2^-7 of the value; 2^-6 allows it twice.
TOL_BWD = {"float32": {"rel": 1e-4, "abs_of_max": 0.0, "abs": 1e-4},
           "bfloat16": {"rel": 2.0 ** -6, "abs_of_max": 2.0 ** -8,
                        "abs": 0.0}}
# training: steps on the card, and one step of the card against the CPU
# (batch 2): float32 GEMMs (TF32 off) summed in other orders by cuBLAS and
# the CPU, forward and backward through 12 layers; each grad is held to
# its own largest element
TRAIN_STEPS = 5
TRAIN_GRADS = ("word_embedding", "fc_0.w_0_0", "fc_40.w_0_0",
               "layer_norm_12.w_0_0", "fc_73.w_0_0", "fc_75.w_0_0")
TRAIN_TOL = {"loss_rtol": 1e-4, "grad_rel_to_max": 1e-3}
# the AMP step's first loss against the float32 step's, same state, feed
# and masks: bfloat16 GEMM operands and activations (8 bits of mantissa)
# through 12 layers and the 30522-way softmax
TRAIN_AMP_TOL = {"first_loss_rtol": 2e-2}
# fuse_attention: the unfused program at level 1 against the fused
# builder's at dropout 0 (the same kernels on the same operands; only the
# ops' order and names may differ), and the composition at level 0
# (cuBLAS and softmax in place of the kernels' 3xTF32 tiles)
FUSE_STEPS = 3
FUSE_TOL = {"loss_rtol": 1e-6, "grad_rel_to_max": 1e-3,
            "level0_loss_rtol": 1e-4, "nmt_loss_rtol": 1e-5}
NMT_UNFUSED_STEPS = 2
# book: batches of the reference's book tests' size, Adam steps
BOOK_BATCH = 64
BOOK_STEPS = 5
# the served model against the CPU: float32 GEMMs (TF32 off) summed in
# another order by cuBLAS than by the CPU GEMM, over 12 layers
SERVE_TOL = {"rtol": 1e-3, "atol": 2e-3}
# a request answered in a bucket against the same request answered alone,
# both on the card: cuBLAS may take another algorithm for 32 rows than for
# 1, so the float32 sums may differ in their last bits over 12 layers
SERVE_BATCHED_TOL = {"rtol": 1e-4, "atol": 1e-4}
SERVE_CLIENTS = (1, 8, 32)
# the served numbers of the eager engine, before CUDA graphs, at each
# client count (PERF.md §5; NVIDIA H100 80GB HBM3, 700.00 W): requests/s,
# p50 and p99 ms
SERVE_EAGER = {1: {"qps": 35.37, "p50_ms": 27.68, "p99_ms": 42.14},
             8: {"qps": 155.9, "p50_ms": 50.33, "p99_ms": 60.54},
             32: {"qps": 470.0, "p50_ms": 56.01, "p99_ms": 77.71}}
SERVE_REQUESTS = 200   # batch-1 requests at each client count
SERVE_POOL = 64        # distinct requests the clients cycle through

# ResNet-50 (models/resnet.py, ImageNet: 224x224, 1000 classes), trained
# at batch 32 as the JAX package's ResNet-50 bench trains it, served at
# batch 1, 8 and 32
RESNET = dict(dataset="imagenet", depth=50, class_num=1000, lr=0.1)
RESNET_BATCH = 32
RESNET_SERVE_BATCHES = (1, 8, 32)
# the first conv filter, the last batch norm's scale and the fc weight
RESNET_GRADS = ("conv2d_0.w_0_0", "batch_norm_52.w_0_0", "fc_0.w_0_0")
# one op of the ResNet-50 step on the card against the same op on the CPU,
# on the same operands: float32 (TF32 off) sums in cuDNN's order and in
# the CPU's, up to 25088 products a filter-grad element; each output is
# held to its own largest element. The step is compared op by op and not
# end to end: at random init the 50 layers magnify float32 rounding about
# 1e5-fold down and back, so two float32 orders of one step give grads
# percents apart (tests/test_torch_resnet50.py measures it on the JAX
# package against itself)
RESNET_OP_TOL = {"rel_to_max": 1e-3}
# the image builders' ops likewise, plus a term for grads that are sums
# cancelling to rounding noise: a conv bias before a batch norm (VGG) has
# a grad of 0 up to rounding, so its own largest element is noise; such a
# grad is held to 1e-4 of the largest grad flowing into its op
IMAGE_OP_TOL = dict(RESNET_OP_TOL, cot_rel=1e-4)
# words cuDNN's convolution kernels carry in their names (its workspace
# initialisation names the convolution it serves, and is not one)
CONV_KERNEL = r"^(?!.*workspace).*(conv|fprop|dgrad|wgrad|winograd|scudnn)"

# ragged key lengths of the kernel cases (batch 8)
LENS8 = [128, 70, 1, 64, 127, 33, 100, 5]
KERNEL_CASES = [
    # name, B, H, Tq, Tk, D, dtype, causal, lens, offsets, rate
    ("bert_t128_f32", 8, 12, 128, 128, 64, "float32", False, None, None, 0.0),
    ("bert_t128_f32_causal", 8, 12, 128, 128, 64, "float32", True, None, None, 0.0),
    ("bert_t512_f32", 8, 12, 512, 512, 64, "float32", False, None, None, 0.0),
    ("bert_t512_f32_causal", 8, 12, 512, 512, 64, "float32", True, None, None, 0.0),
    ("bert_t128_bf16", 8, 12, 128, 128, 64, "bfloat16", False, None, None, 0.0),
    ("bert_t512_bf16_causal", 8, 12, 512, 512, 64, "bfloat16", True, None, None, 0.0),
    ("ragged_lens", 8, 12, 128, 128, 64, "float32", False, LENS8, None, 0.0),
    ("ragged_lens_causal", 8, 12, 128, 128, 64, "float32", True, LENS8, None, 0.0),
    ("masked_rows_causal_offsets", 8, 12, 64, 96, 64, "float32", True, LENS8, (0, 40), 0.0),
    ("tq_ne_tk_ragged_tiles", 2, 3, 100, 77, 64, "float32", False, None, None, 0.0),
    ("tq_ne_tk_ragged_tiles_causal", 2, 3, 100, 77, 64, "float32", True, None, (50, 0), 0.0),
    ("unaligned_offsets", 8, 12, 128, 128, 64, "float32", True, None, (37, 5), 0.0),
    ("head_dim_128", 2, 4, 200, 200, 128, "float32", False, None, None, 0.0),
    ("head_dim_40_bf16", 2, 4, 90, 130, 40, "bfloat16", True, None, None, 0.0),
    ("dropout_0.1", 8, 12, 128, 128, 64, "float32", False, LENS8, None, 0.1),
    ("dropout_0.1_causal_bf16", 8, 12, 128, 128, 64, "bfloat16", True, LENS8, None, 0.1),
    ("head_dim_32_bf16", 2, 4, 128, 128, 32, "bfloat16", False, None, None, 0.0),
    ("tk_not_multiple_of_64_causal_bf16", 2, 4, 200, 200, 64, "bfloat16", True, None, None, 0.0),
    # rows of 33 floats are not 16-byte aligned: plain loads, not cp.async
    ("head_dim_33_unaligned_rows", 2, 3, 70, 90, 33, "float32", True, [90, 41], (20, 0), 0.0),
    # the bf16 kD=128 and float32 kD=32 instances of every kernel
    ("head_dim_128_bf16_causal_dropout", 2, 4, 200, 200, 128, "bfloat16", True, [200, 77], None, 0.1),
    ("head_dim_32_f32_ragged", 2, 4, 96, 130, 32, "float32", False, [130, 41], None, 0.0),
]

BERT = dict(vocab_size=30522, d_model=768, n_layers=12, n_heads=12,
            d_inner=3072, max_position=512, seq_len=128)

# bert_recipe: BERT-base at seq 512 under the reference's pre-training
# recipe (Adam over linear_lr_warmup(polynomial_decay), global-norm clip
# 1.0, L2 decay 0.01); the schedule is short so that every step's rate
# differs; the learning rate fetched each step within lr_rtol of its
# closed form (float32 ops against float64)
RECIPE = dict(seq_len=512, lr=1e-4, end_lr=1e-5, warmup=3, decay_steps=12,
              power=1.0, clip_norm=1.0, l2=0.01, remat_segments=12)
RECIPE_STEPS = 4      # eager warm-up, capture, two replays
WINDOW_STEPS = 8
RECIPE_TOL = {"lr_rtol": 1e-5}
PIPELINE_STEPS = 12   # resnet50_pipelined: steps of each loop
# optimizers: the update ops this slice ports, each held on the card
# against the CPU within OPT_TOL * max|want| of every output
OPTIMIZER_OPS = ("lars_momentum", "adamax", "adagrad", "decayed_adagrad",
                 "adadelta", "rmsprop", "ftrl", "model_average_accum")
OPT_TOL = 1e-5
# mfu: the card's peak for the step's type (NVIDIA's H100 SXM data sheet,
# dense): float32 runs on the FFMA path (TF32 is off), AMP in bf16 on the
# tensor cores. ResNet-50's step is 3 x 2 x 4.1 G multiply-adds an image
# (forward, data and filter grads), 0.79 TFLOP at batch 32; the counted
# FLOPs must come within MFU_TOL of it
MFU_PEAKS = {"H100": {"float32": 67e12, "bfloat16": 989e12}}
RESNET_STEP_FLOPS = 3 * 2 * 4.1e9 * 32
MFU_TOL = 0.10


# ctr: DeepFM as the JAX package's CTR bench builds it (bench.py:341-344):
# 39 fields over a 1M-id space, 16-dim is_sparse embeddings, batch 2048,
# Adam at 1e-3
CTR = dict(batch_size=2048, num_features=1000000, num_fields=39,
           embed_dim=16, lr=1e-3)
CTR_STEPS = 4         # eager warm-up, capture, two replays
CTR_CPU_BATCH = 64
WORD2VEC_BATCH = 64
WORD2VEC_STEPS = 3
# nmt: Transformer-base as the JAX package's NMT bench builds it
# (bench.py:305-313): 6+6 layers, d_model 512, 8 heads, d_inner 2048,
# vocab 32768, seq 256, batch 32, dropout 0.1, label smoothing 0.1
NMT = dict(batch_size=32, seq_len=256, d_model=512, n_heads=8,
           d_inner=2048, n_layers=6, vocab_size=32768, dropout=0.1,
           lr=1e-4)
NMT_STEPS = 4
NMT_FEED_SEED = 71
NMT_CPU_BATCH = 2
# the grads the card-vs-CPU step prints first: both embeddings (the
# deepest), the first encoder weight and the output projection
NMT_GRADS = ("src_word_emb", "trg_word_emb", "fc_0.w_0_0", "fc_96.w_0_0")

# lstm: the stacked-LSTM classifier at the width of the reference
# benchmark the JAX builder names (benchmark/fluid/models/
# stacked_dynamic_lstm.py: 512-wide embedding and LSTM, 5000 words); the
# sequence is cut from the benchmark's 1500-token crop to 256 to keep the
# phase short
LSTM = dict(batch_size=32, seq_len=256, dict_dim=5000, emb_dim=512,
            hidden_dim=512, stacked_num=2)
LSTM_STEPS = 5
LSTM_CPU_BATCH = 2
LSTM_SERVE_BATCHES = (1, 32)
# dynamic_lstm and dynamic_gru at the classifier's width on the card
# against the CPU, forward and grads: (op, attrs, gates a hidden unit)
RNN_OP_CASES = [
    ("dynamic_lstm", {}, 4),
    ("dynamic_lstm", {"is_reverse": True}, 4),
    ("dynamic_lstm", {"use_peepholes": True}, 4),
    ("dynamic_gru", {}, 3),
    ("dynamic_gru", {"is_reverse": True, "origin_mode": True}, 3),
]
# one op on the card against the CPU on the same operands: float32 (TF32
# off) GEMMs summed in cuBLAS's order and the CPU's through 256 steps of
# recurrence, each output held to its own largest element
RNN_OP_TOL = {"rel_to_max": 1e-3}
# image_models: the three image builders with all their ops ported, at
# their own input sizes, batch 32, float32
IMAGE_MODELS = {
    "vgg": dict(class_num=10, image_shape=(3, 32, 32)),
    "mobilenet": dict(class_num=1000, image_shape=(3, 224, 224),
                      scale=1.0),
    "se_resnext": dict(class_num=1000, image_shape=(3, 224, 224),
                       small=False),
}
IMAGE_BATCH = 32
IMAGE_STEPS = 3
# dense_ops: each lowering of the dense op families on the card against
# the same lowering on the CPU from the same operands: float outputs and
# grads within 1e-5 of the CPU's largest element, integer and bool
# outputs exact; the ops whose grads add into a zero input (or take a max
# among ties) run twice, bitwise equal
DENSE_TOL = {"rel_to_max": 1e-5}
DENSE_TWICE = ("gather", "scatter", "bilinear_interp", "nearest_interp",
               "maxout")
# upsample_head: the FCN decoder (Long et al., Fully Convolutional
# Networks) on ResNet-50's last stage at 224x224 (2048 x 7 x 7), two
# stride-2 transposed convolutions (k4 p1) to 512 and 256 channels, each
# with group_norm(32) and a per-channel prelu, a 1x1 conv to PASCAL VOC's
# 21 classes, resized to 224x224, Momentum 0.9
UPSAMPLE = dict(channels=2048, hw=7, widths=(512, 256), groups=32,
                classes=21, out_hw=224, lr=0.01)
UPSAMPLE_BATCH = 8
UPSAMPLE_STEPS = 5
UPSAMPLE_TOL = {"loss_rtol": 1e-4, "grad_rel_to_max": 1e-3}
# ctr_auc: the ctr phase's DeepFM with the streaming auc layer on its
# predictions; AUC within 1e-6 of the CPU's over the same predictions
CTR_AUC_STEPS = 20
CTR_AUC_TOL = 1e-6


# profiler windows that dropped device activity and were run again: per
# window, the calls and up to four kernels whose count was off (none: the
# window held no device activity)
PARTIAL_PROFILES = []
# a window with no device activity at all is profiled again up to this many
# times (seen: a few such windows in a whole run, one at a time; and a run
# whose last retry of a window was empty after two partial ones)
EMPTY_WINDOW_RETRIES = 5
# calls whose device time came from CUDA events because the profiler
# recorded none of their kernels in any window: [kernel name, ms]
EVENT_TIMED = []


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError("chip_smoke check failed: %s" % what)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(log):
    """{"kernel<type, D>": {"registers", "spill_stores", "spill_loads"}}
    for every kernel instance in an nvcc ``-Xptxas=-v`` log."""
    found, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for \S*?\d(flash_[a-z_]+_kernel)"
                      r"I(f|13__nv_bfloat16)Li(\d+)E", ln)
        if m:
            name = "%s<%s, %s>" % (m.group(1), "float" if m.group(2) == "f"
                                   else "bf16", m.group(3))
            found[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if name and m:
            found[name]["spill_stores"] = int(m.group(1))
            found[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if name and m:
            found[name]["registers"] = int(m.group(1))
            name = None
    return found


def profiled(fn, calls=1):
    """Run ``fn`` (``calls`` calls of some function, for the record) under
    torch.profiler and return the profile; a window
    with no device activity at all (``fn`` always launches kernels) is
    profiled again, up to EMPTY_WINDOW_RETRIES times, and recorded in
    PARTIAL_PROFILES. Returns the last window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(EMPTY_WINDOW_RETRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            return prof
        PARTIAL_PROFILES.append({"calls": calls, "odd_counts": []})
    return prof


def profile_kernels(fn, n, attempts=3, expect=None):
    """Run ``fn`` ``n`` times under torch.profiler; returns {kernel name:
    {"ms": device ms per call, "per_call": launches per call, "count":
    launches in the window}} of the CUDA kernels it launched. ``fn``
    launches the same kernels on every call, so each kernel's count in the
    window should be a multiple of ``n``. On the H100 a window can miss one
    launch of a kernel (seen in 28 of the 54 windows of one run, always one
    of torch's own kernels: 19 launches of 20, 39 of 40), so a kernel's
    launches per call are its count over ``n`` rounded, and its time per
    call its mean launch time times those launches.
    A window with no device activity at all is rerun by ``profiled``. A
    window with a kernel further off dropped more (seen: one that held
    about a quarter of each kernel's launches); so is one where the
    kernels whose names hold a key of ``expect`` launched, together, more
    than one launch off ``n`` times its value. Such a window is profiled
    again, up to ``attempts`` times, and recorded in PARTIAL_PROFILES.
    Returns the last window."""
    from torch.autograd import DeviceType

    def calls():
        for _ in range(n):
            fn()

    for _ in range(attempts):
        prof = profiled(calls, n)
        kernels, odd = {}, []
        for e in prof.key_averages():
            if (e.device_type != DeviceType.CUDA
                    or e.self_device_time_total <= 0):
                continue
            per_call = round(e.count / n)
            if per_call == 0 or abs(e.count - per_call * n) > 1:
                odd.append([e.key[:60], e.count])
            kernels[e.key] = {"ms": e.self_device_time_total / e.count
                              * max(per_call, 1) / 1e3,
                              "per_call": per_call, "count": e.count}
        for part, want in (expect or {}).items():
            got = sum(k["count"] for key, k in kernels.items()
                      if part in key)
            if abs(got - n * want) > 1:
                odd.append([part, got])
        if kernels and not odd:
            return kernels
        PARTIAL_PROFILES.append({"calls": n, "odd_counts": odd[:4]})
    return kernels


def device_kernels(fn, n):
    """{kernel name: device ms per call} of ``profile_kernels``."""
    return {key: k["ms"] for key, k in profile_kernels(fn, n).items()}


def event_ms(fn, n):
    """Device ms per call of ``fn`` by CUDA events around ``n`` calls: the
    time from the first call's first kernel to the last call's end, so
    it holds whatever else ``fn`` launches too."""
    import torch

    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def device_ms(fn, name=None, n=20, warmup=3):
    """Device time per call (ms) of the kernels whose name contains
    ``name`` (all kernels when None), from the profiler. When no window
    of the profiler recorded such a kernel, the time of the whole call by
    CUDA events instead, recorded in EVENT_TIMED; raises when that is not
    positive either."""
    for _ in range(warmup):
        fn()
    kernels = device_kernels(fn, n)
    total = sum(ms for key, ms in kernels.items()
                if name is None or name in key)
    if total <= 0:
        total = event_ms(fn, n)
        EVENT_TIMED.append([name, total, sorted(kernels)[:4]])
    check(total > 0, "no device time of kernel %r, by the profiler (saw "
          "%s) or by CUDA events" % (name, sorted(kernels)))
    return total


def attention_inputs(B, H, Tq, Tk, D, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((B, H, t, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
               for t in (Tq, Tk, Tk))
    return q, k, v


def case_inputs(i, case):
    """q, k, v and the int64 lengths (or None) of kernel case ``i``."""
    import torch

    _, B, H, Tq, Tk, D, dt, _, lens, _, _ = case
    q, k, v = attention_inputs(B, H, Tq, Tk, D, getattr(torch, dt), 100 + i)
    lens_t = None if lens is None else torch.tensor(lens[:B], device="cuda")
    return q, k, v, lens_t


def phase_kernel(fa, extra=()):
    """Kernel against plain version case by case, KERNEL_CASES and then
    ``extra`` (cases of the same form); returns the worst out error over
    all cases."""
    import torch

    cases = list(KERNEL_CASES) + list(extra)
    worst = 0.0
    for i, (name, B, H, Tq, Tk, D, dt, causal, lens, offs, rate) in \
            enumerate(cases):
        q, k, v, lens_b = case_inputs(i, cases[i])
        seed = 1234
        out_k, lse_k = fa.flash_forward_cuda(q, k, v, lens_b, offs, seed,
                                             causal, None, rate)
        out_p, lse_p = fa.attention_lse_plain(q, k, v, lens_b, offs, seed,
                                              causal, None, rate)
        torch.cuda.synchronize()
        tol = TOL[dt]
        diff = (out_k.float() - out_p.float()).abs()
        err_out = diff.max().item()
        # the largest excess over the allowed difference (TOL)
        allowed = (tol["out_rel"] * out_p.float().abs()
                   + tol["out_abs_of_max_v"] * v.float().abs().max().item()
                   / (1.0 - rate) + tol["out_abs"])
        excess = (diff - allowed).max().item()
        err_lse = (lse_k - lse_p).abs().max().item()
        row = {"phase": "kernel", "case": name, "shape": [B, H, Tq, Tk, D],
               "dtype": dt, "causal": causal, "seq_lens": lens is not None,
               "offsets": offs, "rate": rate,
               "max_abs_err_out": err_out,
               "tol_out": {"rel": tol["out_rel"],
                           "abs_of_max_v": tol["out_abs_of_max_v"],
                           "abs": tol["out_abs"]},
               "max_excess_out": excess,
               "max_abs_err_lse": err_lse, "tol_lse": tol["lse"]}
        if offs is not None and causal:
            # rows whose every key lies past the causal frontier
            masked = lse_k < -1e29
            row["fully_masked_rows"] = int(masked.sum().item())
            row["masked_rows_out_zero"] = bool(
                (out_k.float()[masked] == 0).all().item())
            check(row["masked_rows_out_zero"],
                  "%s: fully masked rows must publish out = 0" % name)
        if rate > 0.0:
            # the same seed gives the same mask; another seed must not
            other, _ = fa.flash_forward_cuda(q, k, v, lens_b, offs, seed + 1,
                                             causal, None, rate)
            row["other_seed_max_diff"] = (
                other.float() - out_k.float()).abs().max().item()
            check(row["other_seed_max_diff"] > 0.1,
                  "%s: a different seed must draw a different mask" % name)
        emit(row)
        check(np.isfinite(err_out) and excess <= 0,
              "%s out error %g beyond %s" % (name, err_out, row["tol_out"]))
        check(np.isfinite(err_lse) and err_lse <= tol["lse"],
              "%s lse error %g > %g" % (name, err_lse, tol["lse"]))
        worst = max(worst, err_out)
    return worst


def phase_kernel_bwd(fa, extra=()):
    """The dQ and dK/dV kernels against ``attention_bwd_plain``, case by
    case: every forward case (``extra`` too) plus one with a nonzero lse
    cotangent. Both take the same (q, k, v), the forward kernel's (out,
    lse) and the same cotangents. Returns the worst error of each kernel
    over all cases: {"flash_bwd_dq": dq, "flash_bwd_dkv": max(dk, dv)}."""
    import torch

    n = len(KERNEL_CASES)
    cases = list(enumerate(KERNEL_CASES)) + [(n, (
        "lse_cotangent_causal_offsets", 8, 12, 64, 96, 64, "float32", True,
        LENS8, (0, 40), 0.0))] + [(n + 1 + j, c) for j, c in enumerate(extra)]
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for i, case in cases:
        name, B, H, Tq, Tk, D, dt, causal, lens, offs, rate = case
        q, k, v, lens_t = case_inputs(i, case)
        gen = torch.Generator(device="cuda").manual_seed(500 + i)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        g_lse = None
        if name.startswith("lse_cotangent"):
            g_lse = torch.randn((B, H, Tq), generator=gen, device="cuda")
        seed = 4321
        args = (lens_t, offs, seed, causal, None, rate)
        out, lse = fa.flash_forward_cuda(q, k, v, *args)
        got = fa.flash_backward_cuda(q, k, v, out, lse, g, g_lse, *args)
        want = fa.attention_bwd_plain(q, k, v, out, lse, g, g_lse, *args)
        torch.cuda.synchronize()
        tol = TOL_BWD[dt]
        row = {"phase": "kernel_bwd", "case": name,
               "shape": [B, H, Tq, Tk, D], "dtype": dt, "causal": causal,
               "seq_lens": lens is not None, "offsets": offs, "rate": rate,
               "lse_cotangent": g_lse is not None, "tol": tol}
        for grad, a, b in zip(("dq", "dk", "dv"), got, want):
            a, b = a.float(), b.float()
            diff = (a - b).abs()
            allowed = (tol["rel"] * b.abs()
                       + tol["abs_of_max"] * b.abs().max() + tol["abs"])
            row["max_abs_err_" + grad] = diff.max().item()
            row["max_excess_" + grad] = (diff - allowed).max().item()
            row["max_abs_" + grad] = b.abs().max().item()
        if offs is not None and causal:
            # rows whose every key lies past the causal frontier carry
            # lse ~= -1e30 and must get dq = 0, not exp(overflow)
            masked = lse < -1e29
            row["fully_masked_rows"] = int(masked.sum().item())
            row["masked_rows_dq_zero"] = bool(
                (got[0].float()[masked] == 0).all().item())
            check(row["masked_rows_dq_zero"],
                  "%s: fully masked rows must get dq = 0" % name)
        if rate > 0.0:
            # the same seed re-derives the forward's mask; another must not
            other = fa.flash_backward_cuda(q, k, v, out, lse, g, g_lse,
                                           lens_t, offs, seed + 1, causal,
                                           None, rate)
            row["other_seed_max_diff"] = max(
                (o.float() - a.float()).abs().max().item()
                for o, a in zip(other, got))
            check(row["other_seed_max_diff"] > 1e-2,
                  "%s: a different seed must draw a different mask" % name)
        emit(row)
        for grad in ("dq", "dk", "dv"):
            err = row["max_abs_err_" + grad]
            check(np.isfinite(err) and row["max_excess_" + grad] <= 0,
                  "%s %s error %g beyond %s" % (name, grad, err, tol))
            kernel = "flash_bwd_dq" if grad == "dq" else "flash_bwd_dkv"
            worst[kernel] = max(worst[kernel], err)
    return worst


def captured(engine, tag=None):
    """The engine's cache entries that run as a CUDA graph (those tagged
    ``tag`` at the front of their ``cache_key_extra``, when given)."""
    out = []
    for key, c in engine._cache.items():
        extra = key[7]
        if tag is not None and (extra is None or extra[:len(tag)] != tag):
            continue
        if c.capture:
            out.append(c)
    return out


def bert_feed(batch, rng):
    from paddle_tpu_torch.models import bert

    b = bert.make_fake_batch(batch, BERT["seq_len"], BERT["vocab_size"],
                             rng=rng, varlen=True)
    return {k: b[k] for k in ("src_ids", "pos_ids", "sent_ids", "seq_lens")}


def phase_serve(fa, model_dir):
    """Build, initialise, save and serve BERT-base on the card. Returns
    (predictor, launches during the served requests, batch-8 feed)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import inference, unique_name
    from paddle_tpu_torch.models import bert

    t0 = time.perf_counter()
    with unique_name.guard():
        main, startup, handles = bert.get_model(
            batch_size=8, dropout=0.1, is_train=False, **BERT)
    main.random_seed = startup.random_seed = 2024
    exe = fluid.Executor()  # CUDAPlace(0)
    scope = fluid.Scope()
    feeds = ["src_ids", "pos_ids", "sent_ids", "seq_lens"]
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, feeds, [handles["enc_out"]],
                                      exe, main_program=main)
    n_params = sum(int(np.prod(scope.get(p.name).shape))
                   for p in main.all_parameters())
    predictor = inference.create_paddle_predictor(
        inference.AnalysisConfig(model_dir))
    setup_s = time.perf_counter() - t0
    n_layers = BERT["n_layers"]

    rng = np.random.RandomState(7)
    requests = {b: bert_feed(b, rng) for b in (1, 4, 8)}
    torch.cuda.synchronize()
    fa.launches = 0  # the main path starts here
    per_request = []
    outs = {}
    replay_err = 0.0
    for b, feed in requests.items():
        # the eager warm-up of this shape, the run that captures its
        # graph, and a replay
        for rep in range(3):
            before = fa.launches
            (out,) = predictor.run(feed)
            per_request.append(fa.launches - before)
            if rep == 0:
                outs[b] = out.data
            else:
                replay_err = max(replay_err,
                                 float(np.abs(out.data - outs[b]).max()))
    torch.cuda.synchronize()
    launches = fa.launches  # ... and ends here
    for b, out in outs.items():
        check(out.shape == (b, BERT["seq_len"], BERT["d_model"]),
              "enc_out shape %s at batch %d" % (out.shape, b))
        check(np.isfinite(out).all(), "enc_out finite at batch %d" % b)
    check(per_request == [n_layers] * 3 * len(requests),
          "flash kernel launches per request %s, want %d each"
          % (per_request, n_layers))
    entries = captured(predictor._exe.engine)
    check(len(entries) == len(requests)
          and all(c.captures == 1 and c.replays == 2 for c in entries),
          "served requests: %d graphs, captures %s, replays %s" % (
              len(entries), [c.captures for c in entries],
              [c.replays for c in entries]))
    check(replay_err <= SERVE_BATCHED_TOL["atol"],
          "replayed answers differ from eager by %g" % replay_err)

    cpu_cfg = inference.AnalysisConfig(model_dir)
    cpu_cfg.disable_gpu()
    (cpu_out,) = inference.create_paddle_predictor(cpu_cfg).run(requests[1])
    err = float(np.abs(cpu_out.data - outs[1]).max())
    close = bool(np.allclose(outs[1], cpu_out.data, **SERVE_TOL))
    emit({"phase": "serve", "model": "bert_base", "params": n_params,
          "seq_len": BERT["seq_len"], "batches": list(requests),
          "seq_lens": {b: f["seq_lens"].reshape(-1).tolist()
                       for b, f in requests.items()},
          "setup_s": setup_s, "launches_per_request": per_request,
          "launches": launches, "graphs": len(entries),
          "replay_vs_eager_max_abs_err": replay_err,
          "cpu_vs_card_max_abs_err": err, "tol": SERVE_TOL})
    check(close, "card vs CPU enc_out max abs err %g beyond %s"
          % (err, SERVE_TOL))
    return predictor, launches, requests[8]


def closed_loop(server, pool, clients, n):
    """``clients`` threads, each sending batch-1 requests from ``pool``
    one after another through ``server.run`` until ``n`` are answered.
    Returns (answers by request index, pool index of each, wall s)."""
    import threading

    answers, errors = [None] * n, []

    def client(c):
        try:
            for i in range(c, n, clients):
                answers[i] = server.run(pool[i % len(pool)], timeout=300)[0]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads),
          "%d clients: a client hung" % clients)
    check(not errors, "%d clients: %s" % (clients, errors[:3]))
    return answers, [i % len(pool) for i in range(n)], wall


def max_err_against(answers, which, alone):
    """Largest |served - alone| over the answers, and whether every
    answer is within SERVE_BATCHED_TOL of its request answered alone."""
    err, close = 0.0, True
    for out, j in zip(answers, which):
        check(out.shape == alone[j].shape and np.isfinite(out).all(),
              "served answer shape %s or not finite" % (out.shape,))
        err = max(err, float(np.abs(out - alone[j]).max()))
        close = close and bool(np.allclose(out, alone[j], **SERVE_BATCHED_TOL))
    return err, close


def overload_burst(predictor, pool, alone, batch_ms):
    """A server with ``queue_limit`` 8 takes a burst of 4x the top bucket
    at once, each request with a deadline of three batch times (every
    fourth with 0 ms, expired on arrival, which a full queue evicts
    first), then ``stop()`` drains it. Every future must be resolved by
    then, to a result, ``DeadlineExceeded`` or ``Rejected``, and the
    ``serving.*`` counters must add up to the requests sent."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference import DeadlineExceeded, Rejected

    flags.set_flags({"queue_limit": 8})
    try:
        server = predictor.serve(name="overload")
    finally:
        flags.reset_flag("queue_limit")
    n = 4 * server.buckets[-1]
    deadline_ms = 3.0 * batch_ms
    obs.reset()
    futures, refused = [], 0
    with server:
        for i in range(n):
            try:
                futures.append((i, server.submit(
                    pool[i % len(pool)],
                    deadline_ms=0.0 if i % 4 == 3 else deadline_ms)))
            except Rejected:
                refused += 1
    check(all(f.done() for _, f in futures),
          "overload: %d futures unresolved after stop()"
          % sum(not f.done() for _, f in futures))
    served, expired, shed, answers, which = 0, 0, 0, [], []
    for i, f in futures:
        try:
            answers.append(f.result(timeout=0)[0])
            which.append(i % len(pool))
            served += 1
        except DeadlineExceeded:
            expired += 1
        except Rejected:
            shed += 1
    c = obs.snapshot()["counters"]
    counted = {k: c.get("serving." + k, 0)
               for k in ("requests", "rejected", "expired", "shed",
                         "cancelled")}
    err, close = max_err_against(answers, which, alone)
    row = {"requests_sent": n, "queue_limit": 8,
           "deadline_ms": deadline_ms, "served": served,
           "rejected_at_submit": refused, "expired": expired,
           "shed": shed, "counters": counted, "max_abs_err": err}
    check(served + refused + expired + shed == n,
          "overload: outcomes %s do not add up to %d" % (row, n))
    check(counted["requests"] == served
          and counted["rejected"] == refused
          and counted["expired"] == expired
          and counted["shed"] == shed and counted["cancelled"] == 0,
          "overload: serving.* counters %s against outcomes %s"
          % (counted, row))
    check(close, "overload: served answers beyond %s of alone"
          % SERVE_BATCHED_TOL)
    return row


def first_load_race(fa):
    """Two threads launch the forward at once on an empty build
    directory, as a serving worker and a caller's direct run can: one
    build, no error, no temporary file left, both outputs right."""
    import threading

    import torch
    from paddle_tpu_torch.kernels import build

    q, k, v = attention_inputs(8, 12, 128, 128, 64, torch.float32, 77)
    lens = torch.tensor(LENS8, device="cuda")
    want, _ = fa.attention_lse_plain(q, k, v, lens)
    saved = (build.BUILD_DIR, dict(build._loaded), dict(fa._libs))
    outs, errors = [None, None], []
    barrier = threading.Barrier(2)

    def launch(i):
        try:
            barrier.wait(timeout=60)
            outs[i] = fa.flash_forward_cuda(q, k, v, lens)[0]
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_build_") as d:
        build.BUILD_DIR = d
        build._loaded.clear()
        fa._libs.clear()
        try:
            threads = [threading.Thread(target=launch, args=(i,))
                       for i in range(2)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            seconds = time.perf_counter() - t0
            files = sorted(os.listdir(d))
        finally:
            build.BUILD_DIR = saved[0]
            build._loaded.clear()
            build._loaded.update(saved[1])
            fa._libs.clear()
            fa._libs.update(saved[2])
    check(not any(t.is_alive() for t in threads), "first load: hung")
    check(not errors, "first load from two threads: %s" % errors)
    libs = [f for f in files if f.endswith(".so")]
    check(len(libs) == 1 and not [f for f in files if f.endswith(".tmp")],
          "first load: build directory holds %s" % files)
    err = max(float((o - want).abs().max().item()) for o in outs)
    check(err <= TOL["float32"]["out_abs"],
          "first load: out error %g" % err)
    return {"threads": 2, "seconds": seconds, "files": files,
            "max_abs_err": err}


def phase_serve_batched(fa, predictor, smi):
    """The continuous-batching server over the predictor's model, driven
    by closed-loop clients at each count in SERVE_CLIENTS. Returns the
    forward's launches over the three levels."""
    import torch

    from paddle_tpu_torch import observability as obs

    n_layers = BERT["n_layers"]
    rng = np.random.RandomState(21)
    pool = [bert_feed(1, rng) for _ in range(SERVE_POOL)]
    alone = [predictor.run(f)[0].data for f in pool]

    obs.set_enabled(True)
    server = predictor.serve()  # the flags' buckets and max-wait
    check(server.buckets == (1, 2, 4, 8, 16, 32)
          and server.max_wait_ms == 5.0,
          "serve(): buckets %s, max-wait %s" % (server.buckets,
                                                server.max_wait_ms))
    with server:
        t0 = time.perf_counter()
        server.warmup(pool[0])
        warmup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        graphs = captured(server._engine, ("serving", server.name))
        check(sorted(c.feed_bufs[0].shape[0] for c in graphs)
              == list(server.buckets)
              and all(c.captures == 1 for c in graphs),
              "warmup: %d bucket graphs for buckets %s" % (len(graphs),
                                                          server.buckets))
        reserved = torch.cuda.memory_reserved()
        fa.launches = 0  # the served path starts here
        for clients in SERVE_CLIENTS:
            obs.reset()
            before = fa.launches
            answers, which, wall = closed_loop(server, pool, clients,
                                               SERVE_REQUESTS)
            launches = fa.launches - before
            snap = obs.snapshot()
            hist, cnt = snap["histograms"], snap["counters"]
            batches = cnt["serving.batches"]
            err, close = max_err_against(answers, which, alone)
            row = {"phase": "serve_batched", "card": smi,
                   "clients": clients, "requests": SERVE_REQUESTS,
                   "wall_s": wall, "qps": SERVE_REQUESTS / wall,
                   "request_ms_p50": hist["serving.request_ms"]["p50"],
                   "request_ms_p99": hist["serving.request_ms"]["p99"],
                   "queue_ms_p50": hist["serving.queue_ms"]["p50"],
                   "batch_ms_mean": hist["serving.batch_ms"]["mean"],
                   "batch_fill_mean": hist["serving.batch_fill"]["mean"],
                   "batches": batches,
                   "padded_rows": cnt.get("serving.padded_rows", 0),
                   "replays": cnt.get("engine.replays", 0),
                   "launches": launches, "max_abs_err": err,
                   "tol": SERVE_BATCHED_TOL,
                   "eager_engine": SERVE_EAGER[clients]}
            emit(row)
            check(cnt.get("engine.eager_runs", 0) == 0
                  and cnt.get("engine.captures", 0) == 0,
                  "%d clients: %d eager runs, %d captures while serving"
                  % (clients, cnt.get("engine.eager_runs", 0),
                     cnt.get("engine.captures", 0)))
            check(cnt["serving.requests"] == SERVE_REQUESTS,
                  "%d clients: serving.requests %d" % (
                      clients, cnt["serving.requests"]))
            check(launches == n_layers * batches,
                  "%d clients: %d forward launches for %d dispatches"
                  % (clients, launches, batches))
            check(clients == 1 or batches < SERVE_REQUESTS,
                  "%d clients: %d dispatches for %d requests, no "
                  "coalescing" % (clients, batches, SERVE_REQUESTS))
            check(close, "%d clients: served answers beyond %s of alone "
                  "(max abs err %g)" % (clients, SERVE_BATCHED_TOL, err))
            batch_ms = row["batch_ms_mean"]
        torch.cuda.synchronize()
        launches = fa.launches  # ... and ends here

        # one bucket-32 dispatch on this thread: its wall, and the device
        # time of its kernels from the profiler
        top = server.buckets[-1]
        feed = {k: np.concatenate([pool[i][k] for i in range(top)])
                for k in pool[0]}
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server._run_padded(feed, top)  # ends in the copy to the host
            walls.append((time.perf_counter() - t0) * 1e3)
        emit(dict({"phase": "serve_batched", "card": smi,
                   "profile": "bucket-%d dispatch" % top},
                  **profile_request(lambda: server._run_padded(feed, top),
                                    statistics.median(walls))))
    emit(dict({"phase": "serve_batched", "card": smi,
               "overload": True},
              **overload_burst(predictor, pool, alone, batch_ms)))
    obs.set_enabled(None)
    emit(dict({"phase": "serve_batched", "card": smi,
               "first_load_race": True}, **first_load_race(fa)))
    emit({"phase": "serve_batched", "warmup_s": warmup_s,
          "bucket_graphs": len(graphs),
          "memory_reserved_after_captures": reserved,
          "launches": launches})
    return launches


def train_feed(batch, rng):
    from paddle_tpu_torch.models import bert

    return bert.make_fake_batch(batch, BERT["seq_len"], BERT["vocab_size"],
                                rng=rng, varlen=True)


def bert_train_program(amp, fused=True, dropout=0.1):
    """BERT-base pre-training (dropout 0.1, Adam lr 1e-4), as
    ``models.bert.get_model(is_train=True)`` builds it; with ``amp`` the
    optimizer is wrapped by ``contrib.mixed_precision.decorate``, which
    marks the program for bfloat16. ``fused`` False builds the unfused
    attention composition (``use_fused_attention=False``), with the same
    parameters. Returns (main, startup, loss)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        T = BERT["seq_len"]
        data = {n: fluid.layers.data(name=n, shape=[T], dtype="int64")
                for n in ("src_ids", "pos_ids", "sent_ids")}
        seq_lens = fluid.layers.data(name="seq_lens", shape=[1],
                                     dtype="int64")
        mask_label = fluid.layers.data(name="mask_label", shape=[T],
                                       dtype="int64")
        mask_weight = fluid.layers.data(name="mask_weight", shape=[T],
                                        dtype="float32")
        ns_label = fluid.layers.data(name="ns_label", shape=[1],
                                     dtype="int64")
        enc = bert.bert_encoder(
            data["src_ids"], data["pos_ids"], data["sent_ids"], seq_lens,
            BERT["vocab_size"], max_position=BERT["max_position"],
            d_model=BERT["d_model"], n_layers=BERT["n_layers"],
            n_heads=BERT["n_heads"], d_inner=BERT["d_inner"],
            dropout=dropout, is_train=True, use_fused_attention=fused)
        loss, _, _ = bert.pretrain_heads(
            enc, mask_label, mask_weight, ns_label, BERT["vocab_size"],
            BERT["d_model"], is_train=True)
        opt = fluid.optimizer.Adam(learning_rate=1e-4)
        if amp:
            opt = mixed_precision.decorate(opt)
        opt.minimize(loss)
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss


def start_state(main, startup):
    """Run the startup program on the card; returns every persistable var
    as a host array, the state every training phase starts from."""
    import paddle_tpu_torch.fluid as fluid

    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CUDAPlace(0)).run(startup)
    return {v.name: scope.get(v.name).cpu().numpy()
            for v in main.list_vars() if v.persistable}


def fresh(startup, graphs=True):
    """A new executor on the card and a new scope, initialised by the
    startup program as a user would (its run is the executor's first, so
    training steps run at counters 2, 3, ...); ``graphs`` False runs every
    block eagerly. Every executor made here starts from the same state."""
    import paddle_tpu_torch.fluid as fluid

    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.engine.cuda_graphs = graphs
    with fluid.scope_guard(scope):
        exe.run(startup)
    return exe, scope


def _lookup_table_grad_index_add(ctx, ins, attrs):
    """The embedding grad as the port scattered it before this check: a
    zero table ``index_add_``-ed at the batch's ids (float atomics on
    CUDA)."""
    import torch

    from paddle_tpu_torch.ops.common import flatten_lookup_ids, single

    w = single(ins, "W")
    rows = flatten_lookup_ids(single(ins, "Ids")).reshape(-1).long()
    vals = single(ins, "Out@GRAD").reshape(
        (rows.shape[0],) + tuple(w.shape[1:])).to(w.dtype)
    return {"W@GRAD": [torch.zeros_like(w).index_add_(0, rows, vals)]}


def phase_determinism(main, startup, loss, feed8):
    """One eager step, twice, from the same state, feed and run counter:
    the loss and every grad must be bitwise equal. The same pair of steps
    with the embedding grad scattered by ``index_add_`` counts how many
    elements differ with float atomics."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.registry import OpRegistry

    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    fetch = [loss.name] + grads

    def two_steps():
        outs = []
        for _ in range(2):
            exe, scope = fresh(startup, graphs=False)
            with fluid.scope_guard(scope):
                outs.append(exe.run(main, feed=feed8, fetch_list=fetch,
                                    return_numpy=False))
        torch.cuda.synchronize()
        differing = {}
        for name, a, b in zip(fetch, *outs):
            n = int((a != b).sum().item())
            if n:
                differing[name] = n
        return differing

    info = OpRegistry.get("lookup_table_grad")
    repaired = info.lower
    info.lower = _lookup_table_grad_index_add
    try:
        before = two_steps()
    finally:
        info.lower = repaired
    after = two_steps()
    emit({"phase": "determinism", "model": "bert_base", "batch": 8,
          "dropout": 0.1, "grads": len(grads),
          "index_add_differing_elements": before,
          "index_put_differing_elements": after})
    check(not after, "two identical steps differ: %s" % after)
    return before


def step_counts(fa):
    return (fa.launches, fa.launches_dq, fa.launches_dkv)


def flash_launches(fa):
    return dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                    step_counts(fa)))


def flash_kernel_counts(fn, expect):
    """Launches of each flash kernel a call of ``fn``, by the profiler
    over 3 calls (the cross-check of the launch counters; a window can
    miss a launch, see ``profile_kernels``), {kernel: ``expect``'s launches
    a call}: returns (launches a call, launches in the window, the
    instances' names)."""
    kernels = profile_kernels(fn, 3, expect={
        name + "_kernel": n for name, n in expect.items()})
    per_call, window, names = {}, {}, set()
    for key, k in kernels.items():
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            if name + "_kernel" in key:
                per_call[name] = per_call.get(name, 0) + k["per_call"]
                window[name] = window.get(name, 0) + k["count"]
                names.add(key[:90])
    return per_call, {"calls": 3, "launches": window}, sorted(names)


def phase_train(fa, main, startup, loss, state0, feed8):
    """BERT-base training on the card, TRAIN_STEPS steps eagerly and
    captured from the same state, step by step: losses and every state
    tensor bitwise equal; 12 launches of each kernel a step, counted
    across replays and checked against the profiler; the step captured
    once and no block run eagerly; then one step at batch 2 on the card
    against the same step on the CPU. Returns (the two executors and
    scopes, launches by kernel on the captured path, the bitwise
    record)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch import observability as obs

    n_layers = BERT["n_layers"]
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    ops = [op.type for op in main.desc.global_block().ops]
    persistable = sorted(state0)
    eager, eager_scope = fresh(startup, graphs=False)
    graph, graph_scope = fresh(startup)
    losses = {"eager": [], "captured": []}
    per_step, unequal = [], []
    obs.set_enabled(True)
    obs.reset()
    torch.cuda.synchronize()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    eager_runs = 0  # the captured executor's
    for step in range(TRAIN_STEPS):
        before = step_counts(fa)
        eager_before = obs.counter_value("engine.eager_runs")
        with fluid.scope_guard(graph_scope):
            (out,) = graph.run(main, feed=feed8, fetch_list=[loss])
        eager_runs += obs.counter_value("engine.eager_runs") - eager_before
        losses["captured"].append(float(out.reshape(-1)[0]))
        per_step.append([a - b for a, b in zip(step_counts(fa), before)])
        counted = step_counts(fa)
        with fluid.scope_guard(eager_scope):
            (out,) = eager.run(main, feed=feed8, fetch_list=[loss])
        losses["eager"].append(float(out.reshape(-1)[0]))
        # the eager executor's launches are not the captured path's
        fa.launches, fa.launches_dq, fa.launches_dkv = counted
        for n in persistable:
            if not torch.equal(graph_scope.get(n), eager_scope.get(n)):
                unequal.append([step + 1, n, float(
                    (graph_scope.get(n) - eager_scope.get(n)).abs().max())])
    torch.cuda.synchronize()
    launches = flash_launches(fa)  # ... and ends here
    obs.set_enabled(None)
    entries = captured(graph.engine)
    # the profiler's count of a replayed step's flash kernels (3 replays)
    with fluid.scope_guard(graph_scope):
        profiled, window, instances = flash_kernel_counts(
            lambda: graph.run(main, feed=feed8, fetch_list=[loss]),
            dict.fromkeys(names, n_layers))
    row = {"phase": "train", "model": "bert_base", "batch": 8,
           "seq_len": BERT["seq_len"], "dropout": 0.1, "ops": len(ops),
           "grad_ops": sum(t.endswith("_grad") for t in ops),
           "params": sum(int(np.prod(p.shape))
                         for p in main.all_parameters()),
           "seq_lens": feed8["seq_lens"].reshape(-1).tolist(),
           "losses": losses, "state_tensors": len(persistable),
           "unequal_state": unequal[:10],
           "launches_per_step": per_step, "launches": launches,
           "profiled_replay_launches": profiled,
           "profiled_window": window,
           "graphs": len(entries),
           "captures": [c.captures for c in entries],
           "replays": [c.replays for c in entries],
           "eager_runs": eager_runs}
    emit(row)
    check(all(np.isfinite(losses["captured"])),
          "training losses %s" % losses)
    check(losses["captured"][-1] < losses["captured"][0],
          "loss did not fall: %s" % losses)
    check(losses["captured"] == losses["eager"] and not unequal,
          "captured and eager steps differ: losses %s, state %s"
          % (losses, unequal[:5]))
    check(per_step == [[n_layers] * 3] * TRAIN_STEPS,
          "fwd/dq/dkv launches per step %s, want %d each"
          % (per_step, n_layers))
    check(profiled == dict.fromkeys(names, n_layers),
          "the profiler counted %s flash launches in a replayed step"
          % profiled)
    check(len(entries) == 1 and entries[0].captures == 1
          and row["eager_runs"] == 0,
          "the training step: %d graphs, captures %s, %d eager runs"
          % (len(entries), row["captures"], row["eager_runs"]))

    # one step at batch 2, on the card and on the CPU, from the same
    # initial state; fresh executors, so both engines run at the same run
    # counter and draw the same dropout seeds, and the hash masks are the
    # same on both devices
    feed2 = train_feed(2, np.random.RandomState(12))
    fetch = [loss.name] + [n + "@GRAD" for n in TRAIN_GRADS]
    results = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        step_scope = fluid.Scope()
        convert.load_numpy_state(step_scope, state0, place.torch_device(),
                                 program=main)
        step_exe = fluid.Executor(place)
        with fluid.scope_guard(step_scope):
            results.append(step_exe.run(main, feed=feed2, fetch_list=fetch))
    card, cpu = results
    loss_err = abs(float(card[0].reshape(-1)[0] - cpu[0].reshape(-1)[0]))
    grad_errs = {}
    for name, a, b in zip(TRAIN_GRADS, card[1:], cpu[1:]):
        check(a.shape == b.shape and np.isfinite(a).all(),
              "%s@GRAD shape %s vs %s or not finite" % (name, a.shape,
                                                         b.shape))
        grad_errs[name] = {"max_abs_err": float(np.abs(a - b).max()),
                           "max_abs": float(np.abs(b).max())}
    emit({"phase": "train", "cpu_step": {
        "batch": 2, "loss_card": float(card[0].reshape(-1)[0]),
        "loss_cpu": float(cpu[0].reshape(-1)[0]),
        "loss_abs_err": loss_err, "grads": grad_errs}, "tol": TRAIN_TOL})
    check(loss_err <= TRAIN_TOL["loss_rtol"]
          * abs(float(cpu[0].reshape(-1)[0])),
          "card vs CPU step loss error %g" % loss_err)
    for name, e in grad_errs.items():
        check(e["max_abs_err"] <= TRAIN_TOL["grad_rel_to_max"] * e["max_abs"],
              "card vs CPU %s@GRAD error %g (max |grad| %g)"
              % (name, e["max_abs_err"], e["max_abs"]))
    return ((eager, eager_scope), (graph, graph_scope), launches,
            losses["captured"])


def phase_train_amp(fa, feed8, f32_losses):
    """The same model minimized through ``mixed_precision.decorate``:
    TRAIN_STEPS captured steps from the same state. Returns (executor,
    scope, program, loss, launches by kernel)."""
    import torch

    import paddle_tpu_torch.fluid as fluid

    n_layers = BERT["n_layers"]
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    main, startup, loss = bert_train_program(amp=True)
    check(getattr(main, "_amp", False), "decorate did not mark the program")
    exe, scope = fresh(startup)
    losses, per_step = [], []
    torch.cuda.synchronize()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    with fluid.scope_guard(scope):
        for _ in range(TRAIN_STEPS):
            before = step_counts(fa)
            (out,) = exe.run(main, feed=feed8, fetch_list=[loss])
            losses.append(float(out.reshape(-1)[0]))
            per_step.append([a - b for a, b in zip(step_counts(fa),
                                                   before)])
    torch.cuda.synchronize()
    launches = flash_launches(fa)  # ... and ends here
    with fluid.scope_guard(scope):
        profiled, window, instances = flash_kernel_counts(
            lambda: exe.run(main, feed=feed8, fetch_list=[loss]),
            dict.fromkeys(names, n_layers))
    dtypes = sorted({str(scope.get(p.name).dtype)
                     for p in main.all_parameters()})
    entries = captured(exe.engine)
    first_err = abs(losses[0] - f32_losses[0]) / abs(f32_losses[0])
    emit({"phase": "train_amp", "model": "bert_base", "batch": 8,
          "losses": losses, "float32_losses": f32_losses,
          "first_loss_rel_err": first_err, "tol": TRAIN_AMP_TOL,
          "param_dtypes": dtypes, "launches_per_step": per_step,
          "launches": launches, "profiled_replay_launches": profiled,
          "profiled_window": window, "flash_instances": instances,
          "captures": [c.captures for c in entries]})
    check(all(np.isfinite(losses)), "AMP losses %s" % losses)
    check(losses[-1] < losses[0], "AMP loss did not fall: %s" % losses)
    check(first_err <= TRAIN_AMP_TOL["first_loss_rtol"],
          "AMP first loss %g against float32 %g" % (losses[0],
                                                    f32_losses[0]))
    check(dtypes == ["torch.float32"], "AMP weights are %s" % dtypes)
    check(per_step == [[n_layers] * 3] * TRAIN_STEPS
          and profiled == dict.fromkeys(names, n_layers),
          "AMP launches per step %s, profiled %s" % (per_step, profiled))
    check(instances and all("bfloat16" in n for n in instances),
          "AMP flash instances %s are not all bfloat16" % instances)
    check(len(entries) == 1 and entries[0].captures == 1,
          "the AMP step: %d graphs" % len(entries))
    return exe, scope, main, loss, launches


def valid_keys(B, H, Tk, lens):
    """Keys below each sequence's length (clamped to [1, Tk]), summed over
    the batch and heads."""
    if lens is None:
        return B * H * Tk
    return sum(min(max(int(n), 1), Tk) for n in lens) * H


def key_mask(lens_t, B, T, causal=False):
    """The boolean mask SDPA takes for int64 key lengths and, if causal,
    the causal triangle; None for neither."""
    import torch

    mask = None
    if lens_t is not None:
        mask = (torch.arange(T, device="cuda").reshape(1, 1, 1, T)
                < lens_t.clamp(min=1).reshape(B, 1, 1, 1))
    if causal:
        tri = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
        mask = tri if mask is None else mask & tri
    return mask


def valid_pairs(B, H, Tq, Tk, lens, causal):
    """(query, key) pairs below each sequence's key length (clamped to
    [1, Tk]) and, if causal, at or before the query, summed over the
    batch and heads."""
    total = 0
    for n in (lens if lens is not None else [Tk] * B):
        n = min(max(int(n), 1), Tk)
        total += (sum(min(i + 1, n) for i in range(Tq)) if causal
                  else Tq * n)
    return total * H


def attention_work(B, H, Tq, Tk, D, itemsize, lens, causal=False):
    """(bytes, flops) the function needs on these inputs: q and out whole,
    the k/v rows below each sequence's length, lse, the int64 lengths;
    QK^T and PV over the valid (query, key) pairs only."""
    keys = valid_keys(B, H, Tk, lens)
    nbytes = (2 * B * H * Tq * D * itemsize + 2 * keys * D * itemsize
              + B * H * Tq * 4 + (B * 8 if lens is not None else 0))
    flops = 4 * valid_pairs(B, H, Tq, Tk, lens, causal) * D
    return nbytes, flops


def time_kernel(fa, B, H, T, D, dtype, lens, causal=False):
    """Kernel, plain version and SDPA at one shape; returns a dict."""
    import torch
    import torch.nn.functional as F

    q, k, v = attention_inputs(B, H, T, T, D, dtype, 99)
    lens_t = None if lens is None else torch.as_tensor(
        lens, device="cuda").reshape(B)
    mask = key_mask(lens_t, B, T, causal)
    calls = {
        "": (lambda: fa.flash_forward_cuda(q, k, v, lens_t, causal=causal),
             "flash_fwd"),
        "plain_": (lambda: fa.attention_lse_plain(q, k, v, lens_t,
                                                  causal=causal), None),
        "library_": (lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=D ** -0.5), None),
    }
    dt = str(dtype).split(".")[-1]
    row = {"shape": [B, H, T, T, D], "dtype": dt, "causal": causal,
           "seq_lens": None if lens is None else [int(n) for n in lens]}
    # device time per call of the call's kernels, from the profiler
    for prefix, (fn, kernel_name) in calls.items():
        row[prefix + "ms"] = device_ms(fn, kernel_name)
    nbytes, flops = attention_work(B, H, T, T, D, q.element_size(), lens,
                                   causal)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_PER_S[dt] * 1e3
    row.update({"bytes": nbytes, "flops": flops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    if dt == "float32":
        row["bound_ffma_ms"] = max(t_bytes,
                                   flops / PEAK_FFMA_FLOPS_PER_S * 1e3)
    return row


def attention_bwd_work(kernel, B, H, Tq, Tk, D, itemsize, lens,
                       causal=False):
    """(bytes, flops) a backward kernel needs on these inputs, from its
    code. Both read q and dO whole, the k/v rows below each sequence's
    length, lse and delta (float32). flash_bwd_dq writes dq and does three
    products per valid (q row, key) pair over D: s = q.k, dp = dO.v,
    dq += ds.k. flash_bwd_dkv writes dk and dv (every key row) and does
    four: s, dp, dv += p.dO, dk += ds.q."""
    keys = valid_keys(B, H, Tk, lens)
    pairs = valid_pairs(B, H, Tq, Tk, lens, causal)
    nbytes = (2 * B * H * Tq * D * itemsize + 2 * keys * D * itemsize
              + 2 * B * H * Tq * 4 + (B * 8 if lens is not None else 0))
    if kernel == "flash_bwd_dq":
        return nbytes + B * H * Tq * D * itemsize, 6 * pairs * D
    return nbytes + 2 * B * H * Tk * D * itemsize, 8 * pairs * D


def time_bwd_kernels(fa, B, H, T, D, dtype, lens, causal=False):
    """The dQ and dK/dV kernels' device times from one profile of
    ``flash_backward_cuda`` (the delta precompute, a torch op, excluded),
    the plain backward's, and SDPA's backward (its backward kernels only:
    the forward runs once, outside the profiled window), with each
    kernel's bound; returns a dict."""
    import torch
    import torch.nn.functional as F

    q, k, v = attention_inputs(B, H, T, T, D, dtype, 98)
    g = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(97)
                    ).to(dtype)
    lens_t = None if lens is None else torch.as_tensor(
        lens, device="cuda").reshape(B)
    out, lse = fa.flash_forward_cuda(q, k, v, lens_t, causal=causal)

    def kernels():
        return fa.flash_backward_cuda(q, k, v, out, lse, g, None, lens_t,
                                      causal=causal)

    for _ in range(3):
        kernels()
    n = 20
    by_name = device_kernels(kernels, n)
    dt = str(dtype).split(".")[-1]
    row = {"shape": [B, H, T, T, D], "dtype": dt, "causal": causal,
           "seq_lens": None if lens is None else [int(x) for x in lens]}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        ms = sum(t for key, t in by_name.items() if name + "_kernel" in key)
        check(ms > 0, "the profiler recorded no %s kernel (saw %s)"
              % (name, sorted(by_name)))
        nbytes, flops = attention_bwd_work(name, B, H, T, T, D,
                                           q.element_size(), lens, causal)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS_PER_S[dt] * 1e3
        row[name] = {"ms": ms, "bytes": nbytes, "flops": flops,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
        if dt == "float32":
            row[name]["bound_ffma_ms"] = max(
                t_bytes, flops / PEAK_FFMA_FLOPS_PER_S * 1e3)
    row["plain_ms"] = device_ms(lambda: fa.attention_bwd_plain(
        q, k, v, out, lse, g, None, lens_t, causal=causal))
    mask = key_mask(lens_t, B, T, causal)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                       scale=D ** -0.5)
    row["library_ms"] = device_ms(lambda: torch.autograd.grad(
        o, (qs, ks, vs), g, retain_graph=True))
    return row


def host_ms_by_kind(step, n=3):
    """Host time per step spent in the engine's ``run_op``, by kind of op:
    forward, optimizer (op_role Optimize), a grad op with a lowering of
    its own, and a grad op derived as ``torch.func.vjp`` of its forward
    (which re-runs that forward). Ops are dispatched asynchronously, so
    this is the Python and launch cost of each kind; ``n`` steps are run
    with ``run_op`` wrapped in a host clock."""
    from paddle_tpu_torch.core.registry import OpRegistry
    from paddle_tpu_torch.engine import lowering
    from paddle_tpu_torch.framework import OpRole

    def kind(op):
        if op.type.endswith("_grad"):
            return "direct_grad" if OpRegistry.has(op.type) else "vjp_grad"
        if int(op.attrs.get("op_role", 0)) & OpRole.Optimize:
            return "optimizer"
        return "forward"

    totals, counts = {}, {}
    run_op = lowering.run_op

    def timed(op, *args, **kwargs):
        t0 = time.perf_counter()
        run_op(op, *args, **kwargs)
        k = kind(op)
        totals[k] = totals.get(k, 0.0) + time.perf_counter() - t0
        counts[k] = counts.get(k, 0) + 1

    lowering.run_op = timed
    try:
        for _ in range(n):
            step()
    finally:
        lowering.run_op = run_op
    return {k: {"ms": totals[k] * 1e3 / n, "ops": counts[k] // n}
            for k in sorted(totals)}


def timed_runs(run, n=10, warmup=2):
    """Median, min and max wall ms of ``run()`` (host clock, after
    ``warmup`` runs; each run ends in its fetch's copy to the host)."""
    import torch

    for _ in range(warmup):
        run()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(walls), "min_ms": min(walls),
            "max_ms": max(walls)}


def time_train_step(exe, scope, main, loss, feed, host=False, run_kw=None):
    """Median wall of a training step (``timed_runs``), the device time of
    3 more steps by kernel from the profiler, and with ``host`` the host
    time of 3 more by kind of op (an eager executor's: a replayed graph
    runs no op from Python). ``run_kw`` goes to ``exe.run``."""
    import paddle_tpu_torch.fluid as fluid

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss], **(run_kw or {}))

    with fluid.scope_guard(scope):
        row = timed_runs(step)
        kernels = device_kernels(step, 3)
        by_kind = host_ms_by_kind(step) if host else None
    wall = row["median_ms"]
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    flash = {name: sum(t for key, t in kernels.items()
                       if name + "_kernel" in key)
             for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    row.update({"device_busy_ms": busy,
                "device_idle_share": 1.0 - busy / wall,
                "flash_kernels_ms": flash, "kernel_names": len(kernels),
                "top_kernels_ms": [[name[:80], ms] for name, ms in top]})
    if by_kind is not None:
        row["host_ms_by_kind"] = by_kind
    return row


def profile_request(run, wall_ms):
    """Device time of one served request ``run()`` by kernel (profiler),
    against the request's unprofiled median wall ``wall_ms``."""
    kernels = device_kernels(run, 3)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "kernel_names": len(kernels),
            "top_kernels_ms": [[name[:80], ms] for name, ms in top]}


def phase_times(fa, predictor, feed8):
    import torch

    lens8 = feed8["seq_lens"].reshape(-1).tolist()
    rows = {
        "main_path": time_kernel(fa, 8, 12, 128, 64, torch.float32, lens8),
        "main_path_bf16": time_kernel(fa, 8, 12, 128, 64, torch.bfloat16,
                                      lens8),
        "t128_f32_full": time_kernel(fa, 8, 12, 128, 64, torch.float32, None),
        "t512_f32_full": time_kernel(fa, 8, 12, 512, 64, torch.float32, None),
        "t128_bf16_full": time_kernel(fa, 8, 12, 128, 64, torch.bfloat16,
                                      None),
        "t512_bf16_full": time_kernel(fa, 8, 12, 512, 64, torch.bfloat16,
                                      None),
    }
    for name, row in rows.items():
        emit(dict({"phase": "times", "kernel": "flash_fwd", "case": name,
                   "peaks": PEAKS},
                  **row))
    latency = {b: timed_runs(lambda f=feed: predictor.run(f))
               for b, feed in ((1, {k: v[:1] for k, v in feed8.items()}),
                               (8, feed8))}
    emit({"phase": "times", "predictor_request_ms": latency,
          "model": "bert_base", "seq_len": BERT["seq_len"]})
    emit(dict({"phase": "times", "profile": "batch-8 request"},
              **profile_request(lambda: predictor.run(feed8),
                                latency[8]["median_ms"])))
    return rows["main_path"], rows["main_path_bf16"]


def phase_times_train(fa, runs, main, loss, feed8):
    """The backward kernels at the training path's shape (B=8 H=12 T=128
    D=64, the batch's ragged lengths; float32, and bfloat16 as under AMP)
    and at T=512 float32 and bfloat16, then the training step: eager,
    captured, and captured under AMP (``runs``: {label: (executor, scope,
    program, loss)}). Returns the main-path rows, float32 and bf16."""
    import torch

    lens8 = feed8["seq_lens"].reshape(-1).tolist()
    rows = {
        "main_path": time_bwd_kernels(fa, 8, 12, 128, 64, torch.float32,
                                      lens8),
        "main_path_bf16": time_bwd_kernels(fa, 8, 12, 128, 64,
                                           torch.bfloat16, lens8),
        "t512_f32_full": time_bwd_kernels(fa, 8, 12, 512, 64, torch.float32,
                                          None),
        "t512_bf16_full": time_bwd_kernels(fa, 8, 12, 512, 64,
                                           torch.bfloat16, None),
    }
    for name, row in rows.items():
        emit(dict({"phase": "times", "kernel": "flash_bwd", "case": name,
                   "peaks": PEAKS, "plain": "attention_bwd_plain (dq, dk "
                   "and dv)", "library": "scaled_dot_product_attention "
                   "backward (dq, dk and dv)"}, **row))
    for label, (exe, scope, prog, prog_loss) in runs.items():
        emit(dict({"phase": "times", "profile": "batch-8 training step",
                   "run": label, "model": "bert_base",
                   "seq_len": BERT["seq_len"], "tf32": False},
                  **time_train_step(exe, scope, prog, prog_loss, feed8,
                                    host=label == "eager")))
    return rows["main_path"], rows["main_path_bf16"]


# -- unfused attention, fused back at opt_level 1 ---------------------------


def state_executor(main, state, graphs=True, place=None):
    """A new executor (on the card unless ``place`` says) and a scope
    holding ``state`` (host arrays by name), so that its first run is the
    program's: two executors made here draw the same dropout seeds step
    by step."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert

    place = place or fluid.CUDAPlace(0)
    scope = fluid.Scope()
    convert.load_numpy_state(scope, state, place.torch_device(),
                             program=main)
    exe = fluid.Executor(place)
    exe.engine.cuda_graphs = graphs
    return exe, scope


def block_op_types(exe):
    """The op types of the block ``exe`` analyzed last: the desc that
    ran, after the transforms."""
    bp = list(exe.engine._blocks.values())[-1]
    return [op.type for op in bp.ops]


def fused_steps(fa, main, loss, state, feed, steps, grads=(),
                opt_level=None):
    """``steps`` runs of ``main`` on a fresh captured executor from
    ``state``: the first fetches ``grads`` too (its own cache entry,
    eager); the others run one entry (eager, captured, replayed). Returns
    {losses, grads of the first step, flash launches a step, the first
    run's peak allocation above the state, executor, scope}."""
    import torch

    import paddle_tpu_torch.fluid as fluid

    exe, scope = state_executor(main, state)
    release_memory()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, per_step, first = [], [], None
    with fluid.scope_guard(scope):
        for step in range(steps):
            fetch = [loss.name] + (list(grads) if step == 0 else [])
            before = step_counts(fa)
            out = exe.run(main, feed=feed, fetch_list=fetch,
                          opt_level=opt_level)
            per_step.append([a - b for a, b in zip(step_counts(fa),
                                                   before)])
            losses.append(float(out[0].reshape(-1)[0]))
            if step == 0:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                first = out[1:]
    return {"losses": losses, "grads": first, "per_step": per_step,
            "peak": peak, "exe": exe, "scope": scope}


def phase_fuse_attention(fa, state0, feed8, smi):
    """BERT-base built unfused (``use_fused_attention=False``: matmul,
    the lengths mask, softmax, dropout, matmul) and trained at the
    default opt_level 1, where the engine's fuse-attention pass rewrites
    every attention back onto the flash kernels: TRAIN_STEPS steps eagerly
    and captured from the train phase's initial state, step by step,
    bitwise equal; 12 rewrites at the miss, 12 launches of each kernel a
    step. At dropout 0 against the fused builder's program (FUSE_TOL),
    and at opt_level 0 (the composition: no flash launch, FUSE_TOL's
    level-0 bound), with both levels' captured step times and eager
    first-run peaks. Then one step with ``verify=True``. Returns the
    launches by path."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.analysis import Severity, verify_program

    n_layers = BERT["n_layers"]
    main, _, loss = bert_train_program(False, fused=False)
    persistable = sorted(state0)
    check(sorted(v.name for v in main.list_vars() if v.persistable)
          == persistable, "the unfused program's state is not the fused "
          "program's")
    eager, eager_scope = state_executor(main, state0, graphs=False)
    graph, graph_scope = state_executor(main, state0)
    losses = {"eager": [], "captured": []}
    per_step, unequal, rewrites = [], [], None
    obs.set_enabled(True)
    obs.reset()
    torch.cuda.synchronize()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    for step in range(TRAIN_STEPS):
        before = step_counts(fa)
        seen = obs.counter_value("transform.fuse-attention.rewrites")
        with fluid.scope_guard(graph_scope):
            (out,) = graph.run(main, feed=feed8, fetch_list=[loss])
        if step == 0:
            rewrites = obs.counter_value(
                "transform.fuse-attention.rewrites") - seen
        losses["captured"].append(float(out.reshape(-1)[0]))
        per_step.append([a - b for a, b in zip(step_counts(fa), before)])
        counted = step_counts(fa)
        with fluid.scope_guard(eager_scope):
            (out,) = eager.run(main, feed=feed8, fetch_list=[loss])
        losses["eager"].append(float(out.reshape(-1)[0]))
        # the eager executor's launches are not the captured path's
        fa.launches, fa.launches_dq, fa.launches_dkv = counted
        for n in persistable:
            if not torch.equal(graph_scope.get(n), eager_scope.get(n)):
                unequal.append([step + 1, n, float(
                    (graph_scope.get(n) - eager_scope.get(n)).abs().max())])
    torch.cuda.synchronize()
    launches = flash_launches(fa)  # ... and ends here
    snap = obs.snapshot()
    obs.set_enabled(None)
    types = block_op_types(graph)
    entries = captured(graph.engine)
    row = {"phase": "fuse_attention", "model": "bert_base", "card": smi,
           "built": "use_fused_attention=False", "opt_level": 1,
           "batch": 8, "seq_len": BERT["seq_len"], "dropout": 0.1,
           "ops_built": len(main.desc.global_block().ops),
           "ops_run": len(types),
           "rewrites_at_miss": rewrites,
           "pruned_ops": snap["counters"].get("transform.pruned_ops"),
           "transform_pipeline_ms": snap["histograms"].get(
               "transform.pipeline_ms"),
           "engine_trace_ms": snap["histograms"].get("engine.trace_ms"),
           "fused_ops_run": {t: types.count(t) for t in (
               "fused_attention", "fused_attention_grad", "matmul",
               "softmax", "sequence_mask")},
           "losses": losses, "unequal_state": unequal[:10],
           "launches_per_step": per_step, "launches": launches,
           "graphs": [(c.captures, c.replays) for c in entries]}
    emit(row)
    check(rewrites == n_layers, "fuse-attention rewrote %s attentions at "
          "the miss, want %d" % (rewrites, n_layers))
    check(row["fused_ops_run"] == {
        "fused_attention": n_layers, "fused_attention_grad": n_layers,
        "matmul": 0, "softmax": 0, "sequence_mask": 0},
        "ops run after the rewrite: %s" % row["fused_ops_run"])
    check(all(np.isfinite(losses["captured"])),
          "unfused training losses %s" % losses)
    check(losses["captured"] == losses["eager"] and not unequal,
          "captured and eager unfused steps differ: losses %s, state %s"
          % (losses, unequal[:5]))
    check(per_step == [[n_layers] * 3] * TRAIN_STEPS,
          "unfused fwd/dq/dkv launches per step %s, want %d each"
          % (per_step, n_layers))
    check(len(entries) == 1 and entries[0].captures == 1,
          "unfused step graphs %s" % row["graphs"])
    del eager, eager_scope, graph, graph_scope
    release_memory()

    # dropout 0: the fused builder's program, the unfused one at level 1
    # and at level 0, from the same state, the step-1 grads fetched
    fused_main, _, fused_loss = bert_train_program(False, dropout=0.0)
    main0, _, loss0 = bert_train_program(False, fused=False, dropout=0.0)
    grads = [p.name + "@GRAD" for p in fused_main.all_parameters()]
    runs = {}
    for label, prog, prog_loss, level in (
            ("fused", fused_main, fused_loss, None),
            ("unfused_level1", main0, loss0, None),
            ("unfused_level0", main0, loss0, 0)):
        fa.launches = fa.launches_dq = fa.launches_dkv = 0
        runs[label] = fused_steps(fa, prog, prog_loss, state0, feed8,
                                  FUSE_STEPS, grads, opt_level=level)
        runs[label]["launches"] = flash_launches(fa)
        runs[label]["time"] = time_train_step(
            runs[label]["exe"], runs[label]["scope"], prog, prog_loss, feed8,
            run_kw={"opt_level": level})
        runs[label]["ops_run"] = len(block_op_types(runs[label]["exe"]))
        del runs[label]["exe"], runs[label]["scope"]
        release_memory()
    f, u1, u0 = (runs[k] for k in ("fused", "unfused_level1",
                                   "unfused_level0"))
    grad_rel = {}
    for name, a, b in zip(grads, u1["grads"], f["grads"]):
        grad_rel[name] = float(np.abs(a - b).max()) / max(
            float(np.abs(b).max()), 1e-30)
    grad_rel0 = {}
    for name, a, b in zip(grads, u0["grads"], u1["grads"]):
        grad_rel0[name] = float(np.abs(a - b).max()) / max(
            float(np.abs(b).max()), 1e-30)
    worst = max(grad_rel, key=grad_rel.get)
    worst0 = max(grad_rel0, key=grad_rel0.get)
    row = {"phase": "fuse_attention", "dropout": 0.0, "card": smi,
           "steps": FUSE_STEPS, "tol": FUSE_TOL, "grads": len(grads),
           "losses": {k: r["losses"] for k, r in runs.items()},
           "unfused_level1_bitwise_fused": u1["losses"] == f["losses"],
           "unfused_level1_grads_bitwise_fused": all(
               np.array_equal(a, b) for a, b in zip(u1["grads"],
                                                    f["grads"])),
           "worst_grad_rel_to_max": [worst, grad_rel[worst]],
           "level0_worst_grad_rel_to_max": [worst0, grad_rel0[worst0]],
           "launches_per_step": {k: r["per_step"] for k, r in runs.items()},
           "ops_run": {k: r["ops_run"] for k, r in runs.items()},
           "eager_first_run_peak_above_state_bytes": {
               k: r["peak"] for k, r in runs.items()},
           "captured_step": {k: {m: r["time"][m] for m in (
               "median_ms", "min_ms", "max_ms", "device_busy_ms",
               "device_idle_share", "flash_kernels_ms")}
               for k, r in runs.items()}}
    emit(row)
    check(np.allclose(u1["losses"], f["losses"], rtol=FUSE_TOL["loss_rtol"],
                      atol=0.0),
          "unfused level 1 losses %s against the fused program's %s"
          % (u1["losses"], f["losses"]))
    check(grad_rel[worst] <= FUSE_TOL["grad_rel_to_max"],
          "unfused level 1 %s differs from the fused program's by %g of "
          "its max" % (worst, grad_rel[worst]))
    check(np.allclose(u0["losses"], u1["losses"],
                      rtol=FUSE_TOL["level0_loss_rtol"], atol=0.0),
          "level 0 losses %s against level 1's %s"
          % (u0["losses"], u1["losses"]))
    want = [[n_layers] * 3] * FUSE_STEPS
    check(f["per_step"] == want and u1["per_step"] == want,
          "flash launches a step: fused %s, unfused level 1 %s"
          % (f["per_step"], u1["per_step"]))
    check(u0["per_step"] == [[0, 0, 0]] * FUSE_STEPS,
          "flash launches at level 0: %s" % u0["per_step"])

    # the verifier on the card's unfused training step
    exe, scope = state_executor(main, state0, graphs=False)
    with fluid.scope_guard(scope):
        (out,) = exe.run(main, feed=feed8, fetch_list=[loss], verify=True)
    bp = list(exe.engine._blocks.values())[-1]
    report = verify_program(bp.block.program,
                            feed_names=sorted(feed8), fetch_names=[loss.name])
    counts = {str(s): len(report.by_severity(s)) for s in Severity}
    emit({"phase": "verify", "model": "bert_base", "program": "unfused "
          "training step after the level-1 rewrite", "findings": counts,
          "loss": float(out.reshape(-1)[0])})
    check(counts["ERROR"] == 0 and np.isfinite(out).all(),
          "verify=True on the unfused step: %s" % counts)
    del exe, scope
    release_memory()
    return {"fuse_attention": launches,
            "fuse_attention_level0": u0["launches"]}


def phase_fuse_attention_serve(fa, smi):
    """BERT-base built unfused for serving (``is_train=False``), saved and
    served by the predictor at the default level (the rewrite at the
    first run: 12 forward launches a request) and with
    ``switch_ir_optim(False)`` (level 0: none), batch 1 and 8, each shape
    eager, captured and replayed: the answers at both levels and both
    batches, and against the same directory served on the CPU, within
    SERVE_TOL; latencies of replayed requests. Returns the launches by
    path."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import inference, unique_name
    from paddle_tpu_torch.models import bert

    n_layers = BERT["n_layers"]
    feeds = ["src_ids", "pos_ids", "sent_ids", "seq_lens"]
    feed8 = bert_feed(8, np.random.RandomState(17))
    feed1 = {k: v[:1] for k, v in feed8.items()}
    rows, launches, answers = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_unfused_") as d:
        with unique_name.guard():
            main, startup, handles = bert.get_model(
                batch_size=8, dropout=0.1, is_train=False,
                use_fused_attention=False, **BERT)
        main.random_seed = startup.random_seed = 2024
        exe, scope = fluid.Executor(), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            fluid.io.save_inference_model(d, feeds, [handles["enc_out"]],
                                          exe, main_program=main)
        del exe, scope
        for ir_optim in (True, False):
            label = "level1" if ir_optim else "level0"
            cfg = inference.AnalysisConfig(d)
            cfg.switch_ir_optim(ir_optim)
            pred = inference.create_paddle_predictor(cfg)
            torch.cuda.synchronize()
            fa.launches = fa.launches_dq = fa.launches_dkv = 0  # starts
            per_request = []
            for b, feed in ((1, feed1), (8, feed8)):
                for rep in range(3):
                    before = fa.launches
                    (out,) = pred.run(feed)
                    per_request.append(fa.launches - before)
                    if rep == 0:
                        answers[label, b] = out.data
            torch.cuda.synchronize()
            launches["fuse_attention_serve" + (
                "" if ir_optim else "_level0")] = flash_launches(fa)  # ends
            latency = {b: timed_runs(lambda f=feed: pred.run(f), n=20)
                       for b, feed in ((1, feed1), (8, feed8))}
            rows[label] = {"launches_per_request": per_request,
                           "latency_ms": latency,
                           "graphs": len(captured(pred._exe.engine))}
            want = n_layers if ir_optim else 0
            check(per_request == [want] * 6,
                  "served unfused BERT (%s): flash launches a request %s, "
                  "want %d" % (label, per_request, want))
            del pred
            release_memory()
        cfg = inference.AnalysisConfig(d)
        cfg.disable_gpu()
        cpu = inference.create_paddle_predictor(cfg)
        cpu_out = {b: cpu.run(f)[0].data for b, f in ((1, feed1),
                                                      (8, feed8))}
    errs = {
        "level1_b1_vs_b8_row0": float(np.abs(
            answers["level1", 1] - answers["level1", 8][:1]).max()),
        "level0_vs_level1_b8": float(np.abs(
            answers["level0", 8] - answers["level1", 8]).max()),
        "level0_b1_vs_b8_row0": float(np.abs(
            answers["level0", 1] - answers["level0", 8][:1]).max()),
        "card_vs_cpu_b8": float(np.abs(
            answers["level1", 8] - cpu_out[8]).max()),
        "card_vs_cpu_b1": float(np.abs(
            answers["level1", 1] - cpu_out[1]).max())}
    emit({"phase": "fuse_attention_serve", "model": "bert_base",
          "card": smi, "built": "use_fused_attention=False, is_train=False",
          "seq_lens": feed8["seq_lens"].reshape(-1).tolist(),
          "runs": rows, "max_abs_err": errs, "tol": SERVE_TOL})
    pairs = ((answers["level1", 1], answers["level1", 8][:1]),
             (answers["level0", 8], answers["level1", 8]),
             (answers["level0", 1], answers["level0", 8][:1]),
             (answers["level1", 8], cpu_out[8]),
             (answers["level1", 1], cpu_out[1]))
    check(all(np.isfinite(a).all() and np.allclose(a, b, **SERVE_TOL)
              for a, b in pairs),
          "served unfused answers beyond %s: %s" % (SERVE_TOL, errs))
    return launches


def phase_nmt_unfused(fa, smi):
    """Transformer-base at its nmt width built unfused (the 6 encoder
    self- and 6 cross-attentions; the 6 causal decoder self-attentions
    are fused as built) at dropout 0: 12 rewrites, 18 launches of each
    kernel a step, NMT_UNFUSED_STEPS captured steps against the fused
    program's from the same state (FUSE_TOL's nmt bound). Returns the
    launches by path."""
    from paddle_tpu_torch import observability as obs

    feed = nmt_feed(NMT["batch_size"], NMT_FEED_SEED)
    fused_main, fused_startup, fh = nmt_program(dropout=0.0)
    main, _, h = nmt_program(dropout=0.0, fused=False)
    state = start_state(fused_main, fused_startup)
    check(sorted(v.name for v in main.list_vars() if v.persistable)
          == sorted(state), "the unfused NMT program's state differs")
    want = [[3 * NMT["n_layers"]] * 3] * NMT_UNFUSED_STEPS
    runs = {}
    for label, prog, loss in (("fused", fused_main, fh["loss"]),
                              ("unfused", main, h["loss"])):
        obs.set_enabled(True)
        obs.reset()
        fa.launches = fa.launches_dq = fa.launches_dkv = 0  # starts
        r = fused_steps(fa, prog, loss, state, feed, NMT_UNFUSED_STEPS)
        r["launches"] = flash_launches(fa)  # ... and ends here
        r["rewrites"] = obs.counter_value("transform.fuse-attention.rewrites")
        obs.set_enabled(None)
        r["time"] = timed_runs(lambda: r["exe"].run(
            prog, feed=feed, fetch_list=[loss], scope=r["scope"]), n=5,
            warmup=1)
        del r["exe"], r["scope"], r["grads"]
        runs[label] = r
        release_memory()
    emit({"phase": "nmt_unfused", "model": "transformer_base", "card": smi,
          "batch": NMT["batch_size"], "seq_len": NMT["seq_len"],
          "n_layers": NMT["n_layers"], "dropout": 0.0,
          "tol": FUSE_TOL["nmt_loss_rtol"],
          "runs": {k: {m: r[m] for m in ("losses", "per_step", "rewrites",
                                         "peak", "time")}
                   for k, r in runs.items()},
          "bitwise": runs["unfused"]["losses"] == runs["fused"]["losses"]})
    check(runs["unfused"]["rewrites"] == 2 * NMT["n_layers"]
          and runs["fused"]["rewrites"] == 0,
          "NMT rewrites: unfused %d, fused %d" % (
              runs["unfused"]["rewrites"], runs["fused"]["rewrites"]))
    check(runs["unfused"]["per_step"] == want
          and runs["fused"]["per_step"] == want,
          "NMT flash launches a step: unfused %s, fused %s"
          % (runs["unfused"]["per_step"], runs["fused"]["per_step"]))
    check(np.allclose(runs["unfused"]["losses"], runs["fused"]["losses"],
                      rtol=FUSE_TOL["nmt_loss_rtol"], atol=0.0),
          "unfused NMT losses %s against fused %s" % (
              runs["unfused"]["losses"], runs["fused"]["losses"]))
    return {"nmt_unfused": runs["unfused"]["launches"]}


def phase_book(fa, smi):
    """The four book programs (``models.book``: fit_a_line,
    recognize_digits, word2vec, machine_translation) with Adam, from the
    card's startup state: BOOK_STEPS steps on the card (captured) and on
    the CPU on the same seeded batches, losses within TRAIN_TOL; then
    saved, loaded and served on the card against the training program's
    ``for_test`` clone (the reference's round trip). Returns the
    launches by path (none)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import book

    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    for i, name in enumerate(sorted(book.BOOK_BUILDERS)):
        with unique_name.guard():
            main, startup, _, fetch, loss = book.get_model(name)
        main.random_seed = startup.random_seed = 2024
        state = start_state(main, startup)
        rng = np.random.RandomState(300 + i)
        batches = [book.make_batch(name, BOOK_BATCH, rng)
                   for _ in range(BOOK_STEPS)]
        losses = {}
        for where, place in (("card", None), ("cpu", fluid.CPUPlace())):
            exe, scope = state_executor(main, state, place=place)
            with fluid.scope_guard(scope):
                losses[where] = [float(exe.run(
                    main, feed=b, fetch_list=[loss])[0].reshape(-1)[0])
                    for b in batches]
            if where == "card":
                card_exe, card_scope = exe, scope
        save_names = book.SAVE_NAMES[name]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_book_") as d, \
                fluid.scope_guard(card_scope):
            fluid.io.save_inference_model(d, save_names, [fetch], card_exe,
                                          main_program=main)
            prog, feed_names, fetches = fluid.io.load_inference_model(
                d, card_exe)
            feed = batches[0]
            (out,) = card_exe.run(prog, feed={k: feed[k]
                                              for k in save_names},
                                  fetch_list=fetches)
            (ref,) = card_exe.run(main.clone(for_test=True), feed=feed,
                                  fetch_list=[fetch])
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                   losses["cpu"])]
        infer_err = float(np.abs(out - ref).max())
        emit({"phase": "book", "program": name, "card": smi,
              "batch": BOOK_BATCH, "losses": losses,
              "worst_loss_rel_err": max(rel),
              "graphs": len(captured(card_exe.engine)),
              "saved_feeds": feed_names, "infer_shape": list(out.shape),
              "infer_vs_for_test_max_abs_err": infer_err,
              "tol": TRAIN_TOL})
        check(all(np.isfinite(losses["card"]))
              and max(rel) <= TRAIN_TOL["loss_rtol"],
              "book %s: card losses %s against the CPU's %s"
              % (name, losses["card"], losses["cpu"]))
        check(feed_names == save_names
              and np.allclose(out, ref, rtol=1e-4, atol=1e-5),
              "book %s: the loaded model's answer differs by %g"
              % (name, infer_err))
        del card_exe, card_scope
    launches = flash_launches(fa)  # ... and ends here
    check(not any(launches.values()), "flash launches in book: %s"
          % launches)
    return {"book": launches}


# -- ResNet-50 ----------------------------------------------------------


def resnet_program(is_train, amp=False):
    """ResNet-50 as ``models.resnet.get_model(dataset="imagenet",
    depth=50, class_num=1000)`` builds it (224x224, Momentum 0.9 at lr 0.1
    as the JAX package's ResNet-50 bench trains it), random weights from
    the seed; ``amp`` marks the program for bfloat16
    (``contrib.mixed_precision.enable_bf16``). Returns (main, startup,
    handles)."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import resnet

    with unique_name.guard():
        main, startup, handles = resnet.get_model(is_train=is_train,
                                                  **RESNET)
    main.random_seed = startup.random_seed = 2024
    if amp:
        mixed_precision.enable_bf16(main)
    return main, startup, handles


def resnet_feed(batch, rng):
    return {"img": rng.randn(batch, 3, 224, 224).astype(np.float32),
            "label": rng.randint(0, RESNET["class_num"], (batch, 1)).astype(
                np.int64)}


def bn_stat_names(program):
    return sorted(n for op in program.desc.global_block().ops
                  if op.type == "batch_norm"
                  for n in op.input("Mean") + op.input("Variance"))


def phase_resnet50_serve(fa, model_dir, smi):
    """ResNet-50's inference program built, initialised on the card,
    saved and served by ``predictor.run`` at batch 1, 8 and 32: each shape
    eager once, then captured and replayed, the replays bitwise equal to
    the eager answer; no flash launch; the running statistics read and
    never written; batch 2 against the CPU predictor on the same
    directory. Returns the flash kernels' launches on this path."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import inference

    t0 = time.perf_counter()
    main, startup, handles = resnet_program(is_train=False)
    exe, scope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, ["img"],
                                      [handles["logits"]], exe,
                                      main_program=main)
    del exe, scope
    predictor = inference.create_paddle_predictor(
        inference.AnalysisConfig(model_dir))
    setup_s = time.perf_counter() - t0
    stats = {n: predictor._scope.get(n) for n in bn_stat_names(main)}
    stats0 = {n: t.clone() for n, t in stats.items()}

    rng = np.random.RandomState(31)
    requests = {b: {"img": resnet_feed(b, rng)["img"]}
                for b in RESNET_SERVE_BATCHES}
    torch.cuda.synchronize()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    outs, replay_equal = {}, True
    for b, feed in requests.items():
        for rep in range(3):  # eager, the run that captures, a replay
            (out,) = predictor.run(feed)
            if rep == 0:
                outs[b] = out.data
            else:
                replay_equal = replay_equal and np.array_equal(out.data,
                                                               outs[b])
    torch.cuda.synchronize()
    launches = flash_launches(fa)  # ... and ends here
    reserved = torch.cuda.memory_reserved()
    graphs = [(c.captures, c.replays)
              for c in captured(predictor._exe.engine)]
    stats_kept = all(predictor._scope.get(n) is t and torch.equal(
        t, stats0[n]) for n, t in stats.items())

    feed2 = {"img": resnet_feed(2, rng)["img"]}
    (card,) = predictor.run(feed2)
    cpu_cfg = inference.AnalysisConfig(model_dir)
    cpu_cfg.disable_gpu()
    (cpu,) = inference.create_paddle_predictor(cpu_cfg).run(feed2)
    err = float(np.abs(card.data - cpu.data).max())
    latency = {b: timed_runs(lambda f=feed: predictor.run(f))
               for b, feed in requests.items()}
    emit({"phase": "resnet50_serve", "card": smi, "model": "resnet50",
          "image": [3, 224, 224], "classes": RESNET["class_num"],
          "params": sum(int(np.prod(p.shape))
                        for p in main.all_parameters()),
          "ops": len(main.desc.global_block().ops), "setup_s": setup_s,
          "batches": list(requests), "launches": launches,
          "graphs_captures_replays": graphs,
          "replays_bitwise_equal_eager": replay_equal,
          "running_stats": len(stats), "running_stats_unwritten": stats_kept,
          "memory_reserved_after_captures": reserved,
          "cpu_vs_card_batch2_max_abs_err": err,
          "max_abs_logit": float(np.abs(cpu.data).max()), "tol": SERVE_TOL,
          "request_ms": latency, "tf32": False})
    emit(dict({"phase": "resnet50_serve", "card": smi,
               "profile": "batch-32 request"},
              **profile_request(lambda: predictor.run(requests[32]),
                                latency[32]["median_ms"])))
    for b, out in outs.items():
        check(out.shape == (b, RESNET["class_num"])
              and np.isfinite(out).all(),
              "resnet50 logits shape %s or not finite at batch %d"
              % (out.shape, b))
    check(not any(launches.values()), "flash launches serving ResNet-50: "
          "%s" % launches)
    check(graphs == [(1, 2)] * len(requests),
          "resnet50 served: (captures, replays) of each graph %s" % graphs)
    check(replay_equal, "resnet50: replayed answers differ from eager")
    check(stats_kept, "resnet50 serving wrote the running statistics")
    check(np.allclose(card.data, cpu.data, **SERVE_TOL),
          "resnet50 card vs CPU logits max abs err %g beyond %s"
          % (err, SERVE_TOL))
    return launches


def phase_resnet50_determinism(main, startup, loss, feed):
    """One eager ResNet-50 step, twice, from the same state, feed and run
    counter, with cuDNN's default algorithms (deterministic off, as torch
    starts) and with the deterministic algorithms the port's CUDA engine
    selects: the loss and every grad must be bitwise equal with the
    latter; prints how far RESNET_GRADS moved between the two
    default-algorithm steps, relative to each grad's largest element."""
    import torch

    import paddle_tpu_torch.fluid as fluid

    fetch = [loss.name] + [p.name + "@GRAD" for p in main.all_parameters()]

    def two_steps(deterministic):
        runs = [fresh(startup, graphs=False) for _ in range(2)]
        torch.backends.cudnn.deterministic = deterministic
        try:
            outs = []
            for exe, scope in runs:
                with fluid.scope_guard(scope):
                    outs.append(exe.run(main, feed=feed, fetch_list=fetch,
                                        return_numpy=False))
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = True
        differing, rel = {}, {}
        for name, a, b in zip(fetch, *outs):
            n = int((a != b).sum().item())
            if n:
                differing[name] = n
            if name[: -len("@GRAD")] in RESNET_GRADS:
                rel[name] = float((a - b).abs().max() / b.abs().max())
        return differing, rel

    before, before_rel = two_steps(False)
    after, _ = two_steps(True)
    emit({"phase": "resnet50_determinism", "batch": RESNET_BATCH,
          "grads": len(fetch) - 1,
          "default_cudnn_differing_elements": before,
          "default_cudnn_grad_rel_diff": before_rel,
          "deterministic_cudnn_differing_elements": after})
    check(not after, "two identical ResNet-50 steps differ: %s" % after)


def replay_ops_on_card(main, state, feed, tol, witness=None):
    """The step's ops one by one on the CPU (the port's lowerings), each
    op's operands copied to the card and the op run there too: every
    output within ``tol`` of the CPU's (|d| <= rel_to_max * max|cpu|,
    plus, where ``tol`` has ``cot_rel``, that times the largest incoming
    grad of the op; integer outputs equal). ``witness`` maps an op type to another
    lowering, run on the card on the same operands beside the port's.
    Returns ({op type: largest relative difference}, the CPU values of
    every var, and for each output of a witnessed op its difference from
    the CPU's, the witness's and the two's, each relative to max|cpu|)."""
    import torch

    from paddle_tpu_torch.engine import lowering

    env = {n: torch.from_numpy(np.array(v)) for n, v in
           dict(state, **feed).items()}
    block = main.desc.global_block()
    worst, bad, witnessed = {}, [], []
    for i, op in enumerate(block.ops):
        if op.type in ("feed", "fetch"):
            continue
        card = {n: env[n].to("cuda") for n in op.input_arg_names()
                if n != lowering.EMPTY_VAR_NAME}
        alt = dict(card) if op.type in (witness or {}) else None
        lowering.run_op(op, block, env, "cpu", (2024, 1), i, False)
        lowering.run_op(op, block, card, "cuda", (2024, 1), i, False)
        if alt is not None:
            with lowered_by(op.type, witness[op.type]):
                lowering.run_op(op, block, alt, "cuda", (2024, 1), i, False)
        for n in op.output_arg_names():
            if n == lowering.EMPTY_VAR_NAME:
                continue
            want, got = env[n], card[n].cpu()
            if not want.is_floating_point():
                if not torch.equal(got, want):
                    bad.append([op.type, n, "integers differ"])
                continue
            peak = float(want.abs().max()) if want.numel() else 0.0
            d = float((got - want).abs().max()) if want.numel() else 0.0
            worst[op.type] = max(worst.get(op.type, 0.0), d / (peak or 1.0))
            limit = tol["rel_to_max"] * peak
            if tol.get("cot_rel"):
                limit += tol["cot_rel"] * max(
                    [float(env[m].abs().max()) for m in op.input_arg_names()
                     if m.endswith("@GRAD") and m in env
                     and env[m].numel()] or [0.0])
            if d > limit:
                bad.append([op.type, n, d, peak])
            if alt is not None and want.numel():
                other = alt[n].cpu()
                witnessed.append({
                    "op": i, "type": op.type, "out": n,
                    "slot": [k for k, v in op.outputs.items() if n in v][0],
                    "causal": bool(op.attrs.get("causal", False)),
                    "max_abs": peak,
                    "port": d / (peak or 1.0),
                    "witness": float((other - want).abs().max())
                    / (peak or 1.0),
                    "port_vs_witness": float((got - other).abs().max())
                    / (peak or 1.0)})
        del card, alt
    check(not bad, "ops on the card beyond %s of the CPU: %s"
          % (tol, bad[:5]))
    return worst, env, witnessed


def phase_resnet50_train(fa, main, startup, loss, handles, feed, smi):
    """ResNet-50 training on the card, TRAIN_STEPS Momentum steps eagerly
    and captured from the same state, step by step: losses and every state
    tensor (the running statistics included) bitwise equal; no flash
    launch; the step captured once and no block run eagerly; the
    ``for_test`` clone deterministic and reading the running statistics
    only; then one step at batch 2 against the CPU. Returns (the two
    executors and scopes, the captured losses, flash launches)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch import observability as obs

    persistable = sorted(v.name for v in main.list_vars() if v.persistable)
    stats = bn_stat_names(main)
    mean_names = {n for op in main.desc.global_block().ops
                  if op.type == "batch_norm" for n in op.input("Mean")}
    eager, eager_scope = fresh(startup, graphs=False)
    graph, graph_scope = fresh(startup)
    losses = {"eager": [], "captured": []}
    unequal, eager_runs = [], 0
    obs.set_enabled(True)
    obs.reset()
    torch.cuda.synchronize()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    for step in range(TRAIN_STEPS):
        eager_before = obs.counter_value("engine.eager_runs")
        with fluid.scope_guard(graph_scope):
            (out,) = graph.run(main, feed=feed, fetch_list=[loss])
        eager_runs += obs.counter_value("engine.eager_runs") - eager_before
        losses["captured"].append(float(out.reshape(-1)[0]))
        with fluid.scope_guard(eager_scope):
            (out,) = eager.run(main, feed=feed, fetch_list=[loss])
        losses["eager"].append(float(out.reshape(-1)[0]))
        for n in persistable:
            if not torch.equal(graph_scope.get(n), eager_scope.get(n)):
                unequal.append([step + 1, n])
    torch.cuda.synchronize()
    launches = flash_launches(fa)  # ... and ends here
    obs.set_enabled(None)
    reserved = torch.cuda.memory_reserved()
    entries = captured(graph.engine)
    # every running statistic has left its init (mean 0, variance 1)
    moved = sum(bool((graph_scope.get(n) != (
        0.0 if n in mean_names else 1.0)).any()) for n in stats)

    # the for_test clone, captured, on the trained state: reads only
    test_prog = main.clone(for_test=True)
    before = {n: graph_scope.get(n).clone() for n in persistable}
    with fluid.scope_guard(graph_scope):
        clone_outs = [graph.run(test_prog, feed={"img": feed["img"]},
                                fetch_list=[handles["logits"]])[0]
                      for _ in range(3)]
    clone_equal = all(np.array_equal(o, clone_outs[0]) for o in clone_outs)
    clone_read_only = all(torch.equal(graph_scope.get(n), before[n])
                          for n in persistable)
    row = {"phase": "resnet50_train", "card": smi, "model": "resnet50",
           "batch": RESNET_BATCH, "optimizer": "momentum 0.9, lr 0.1",
           "ops": len(main.desc.global_block().ops),
           "grad_ops": sum(op.type.endswith("_grad")
                           for op in main.desc.global_block().ops),
           "state_tensors": len(persistable), "running_stats": len(stats),
           "running_stats_moved": moved, "losses": losses,
           "unequal_state": unequal[:10], "launches": launches,
           "graphs": len(entries), "captures": [c.captures for c in entries],
           "eager_runs": eager_runs,
           "memory_reserved_after_capture": reserved,
           "for_test_clone_deterministic": clone_equal,
           "for_test_clone_read_only": clone_read_only}
    emit(row)
    check(all(np.isfinite(losses["captured"])), "ResNet-50 losses %s"
          % losses)
    # one batch repeated at lr 0.1 with momentum 0.9: the first step
    # lowers the loss, the next ones overshoot and it climbs, in the JAX
    # package as in the port (tests/test_torch_resnet_trajectory.py)
    check(losses["captured"][1] < losses["captured"][0],
          "ResNet-50 loss did not fall: %s" % losses["captured"])
    check(losses["captured"] == losses["eager"] and not unequal,
          "ResNet-50 captured and eager steps differ: losses %s, state %s"
          % (losses, unequal[:5]))
    check(moved == len(stats), "%d of %d running statistics moved"
          % (moved, len(stats)))
    check(not any(launches.values()), "flash launches in ResNet-50 "
          "training: %s" % launches)
    check(len(entries) == 1 and entries[0].captures == 1
          and eager_runs == 0,
          "the ResNet-50 step: %d graphs, captures %s, %d eager runs"
          % (len(entries), row["captures"], eager_runs))
    check(clone_equal and clone_read_only,
          "the for_test clone: deterministic %s, read only %s"
          % (clone_equal, clone_read_only))

    # one step at batch 2 on the card against the CPU, from the card's
    # initial state: the loss end to end, every op on the same operands
    state0 = start_state(main, startup)
    feed2 = resnet_feed(2, np.random.RandomState(12))
    worst, cpu_env, _ = replay_ops_on_card(main, state0, feed2,
                                           RESNET_OP_TOL)
    fetch = [loss.name] + [n + "@GRAD" for n in RESNET_GRADS]
    step_scope = fluid.Scope()
    convert.load_numpy_state(step_scope, state0, "cuda", program=main)
    with fluid.scope_guard(step_scope):
        card = fluid.Executor(fluid.CUDAPlace(0)).run(
            main, feed=feed2, fetch_list=fetch)
    cpu = [cpu_env[n].numpy() for n in fetch]
    loss_err = abs(float(card[0].reshape(-1)[0] - cpu[0].reshape(-1)[0]))
    grad_rel = {n: float(np.abs(a - b).max() / np.abs(b).max())
                for n, a, b in zip(fetch[1:], card[1:], cpu[1:])}
    emit({"phase": "resnet50_train", "cpu_step": {
        "batch": 2, "loss_card": float(card[0].reshape(-1)[0]),
        "loss_cpu": float(cpu[0].reshape(-1)[0]), "loss_abs_err": loss_err,
        "ops_replayed_worst_rel_to_max": worst, "op_tol": RESNET_OP_TOL,
        "end_to_end_grad_rel_diff": grad_rel}, "tol": TRAIN_TOL})
    check(loss_err <= TRAIN_TOL["loss_rtol"] * abs(float(
        cpu[0].reshape(-1)[0])), "ResNet-50 card vs CPU loss error %g"
        % loss_err)
    return ((eager, eager_scope), (graph, graph_scope), losses["captured"],
            launches)


def conv_kernel_dtypes(fn):
    """Names of the convolution kernels one profiled call of ``fn``
    launches (cuDNN's forward, data-grad and filter-grad kernels, by the
    words their names carry), and whether each names bf16."""
    from torch.autograd import DeviceType

    prof = profiled(fn)
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and re.search(CONV_KERNEL, e.key, re.I)})
    return {n[:100]: bool(re.search("bf16|bfloat16", n, re.I))
            for n in names}


def phase_resnet50_train_amp(fa, feed, f32_losses, smi):
    """The same model marked with ``enable_bf16``: TRAIN_STEPS captured
    steps from the same state. Returns (executor, scope, program, loss,
    flash launches)."""
    import torch

    import paddle_tpu_torch.fluid as fluid

    main, startup, handles = resnet_program(is_train=True, amp=True)
    loss = handles["loss"]
    exe, scope = fresh(startup)
    losses = []
    torch.cuda.synchronize()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    with fluid.scope_guard(scope):
        for _ in range(TRAIN_STEPS):
            (out,) = exe.run(main, feed=feed, fetch_list=[loss])
            losses.append(float(out.reshape(-1)[0]))
    torch.cuda.synchronize()
    launches = flash_launches(fa)  # ... and ends here
    reserved = torch.cuda.memory_reserved()
    with fluid.scope_guard(scope):
        convs = conv_kernel_dtypes(
            lambda: exe.run(main, feed=feed, fetch_list=[loss]))
    dtypes = sorted({str(scope.get(p.name).dtype)
                     for p in main.all_parameters()})
    stat_dtypes = sorted({str(scope.get(n).dtype)
                          for n in bn_stat_names(main)})
    entries = captured(exe.engine)
    first_err = abs(losses[0] - f32_losses[0]) / abs(f32_losses[0])
    emit({"phase": "resnet50_train_amp", "card": smi, "batch": RESNET_BATCH,
          "losses": losses, "float32_losses": f32_losses,
          "first_loss_rel_err": first_err, "tol": TRAIN_AMP_TOL,
          "param_dtypes": dtypes, "running_stat_dtypes": stat_dtypes,
          "launches": launches, "conv_kernels_bf16": convs,
          "captures": [c.captures for c in entries],
          "memory_reserved_after_capture": reserved})
    check(all(np.isfinite(losses)), "ResNet-50 AMP losses %s" % losses)
    check(losses[1] < losses[0], "ResNet-50 AMP loss did not fall: %s"
          % losses)
    check(first_err <= TRAIN_AMP_TOL["first_loss_rtol"],
          "ResNet-50 AMP first loss %g against float32 %g"
          % (losses[0], f32_losses[0]))
    check(dtypes == ["torch.float32"] and stat_dtypes == ["torch.float32"],
          "ResNet-50 AMP weights %s, running stats %s" % (dtypes,
                                                         stat_dtypes))
    check(convs and all(convs.values()),
          "ResNet-50 AMP convolution kernels not all bf16: %s" % convs)
    check(not any(launches.values()), "flash launches in ResNet-50 AMP "
          "training: %s" % launches)
    check(len(entries) == 1 and entries[0].captures == 1,
          "the ResNet-50 AMP step: %d graphs" % len(entries))
    return exe, scope, main, loss, launches


def phase_resnet50_times(runs, startup, feed, smi):
    """The ResNet-50 step's median wall, images per second, the card's
    busy ms and idle share and the ten kernels with the most device time,
    for each run in ``runs`` ({label: (executor, scope, program, loss)}),
    and the captured float32 step again with cuDNN's default algorithms
    (deterministic off) on a new executor: what the deterministic
    algorithms cost."""
    import torch

    rows = {}
    for label, (exe, scope, prog, prog_loss) in runs.items():
        rows[label] = time_train_step(exe, scope, prog, prog_loss, feed)
    exe, scope = fresh(startup)
    prog, prog_loss = runs["captured"][2:]
    torch.backends.cudnn.deterministic = False
    try:
        rows["captured_default_cudnn"] = time_train_step(
            exe, scope, prog, prog_loss, feed)
    finally:
        torch.backends.cudnn.deterministic = True
    del exe, scope
    for label, row in rows.items():
        row["images_per_s"] = RESNET_BATCH / (row["median_ms"] / 1e3)
        emit(dict({"phase": "times", "card": smi,
                   "profile": "ResNet-50 training step", "run": label,
                   "batch": RESNET_BATCH, "tf32": False}, **row))
    return rows


# -- the training loop's features ----------------------------------------


def _lr_recipe(c):
    """The recipe's learning rate after the step counter reached ``c``:
    ``linear_lr_warmup(polynomial_decay(...))`` in closed form, float64
    (learning_rate_scheduler.py: the warmup's fraction and its done
    indicator are clips of the counter)."""
    r = RECIPE
    warm = r["lr"] * min(max(c / r["warmup"], 0.0), 1.0)
    poly = ((r["lr"] - r["end_lr"])
            * (1.0 - min(max(c, 0.0), r["decay_steps"])
               / r["decay_steps"]) ** r["power"] + r["end_lr"])
    done = min(max(c - r["warmup"] + 0.5, 0.0), 1.0)
    return warm * (1.0 - done) + poly * done


def recipe_program():
    """BERT-base at seq 512 (dropout 0.1, float32), its forward built with
    ``models.bert``'s ``bert_encoder`` and ``pretrain_heads`` as
    ``get_model`` builds it, then the reference's pre-training recipe
    appended here: Adam over ``linear_lr_warmup(polynomial_decay(...))``,
    ``GradientClipByGlobalNorm(1.0)`` and ``L2Decay(0.01)``. Returns
    (main, startup, loss, learning-rate var)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import bert

    r = RECIPE
    T = r["seq_len"]
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        data = {n: fluid.layers.data(name=n, shape=[T], dtype="int64")
                for n in ("src_ids", "pos_ids", "sent_ids")}
        seq_lens = fluid.layers.data(name="seq_lens", shape=[1],
                                     dtype="int64")
        mask_label = fluid.layers.data(name="mask_label", shape=[T],
                                       dtype="int64")
        mask_weight = fluid.layers.data(name="mask_weight", shape=[T],
                                        dtype="float32")
        ns_label = fluid.layers.data(name="ns_label", shape=[1],
                                     dtype="int64")
        enc = bert.bert_encoder(
            data["src_ids"], data["pos_ids"], data["sent_ids"], seq_lens,
            BERT["vocab_size"], max_position=BERT["max_position"],
            d_model=BERT["d_model"], n_layers=BERT["n_layers"],
            n_heads=BERT["n_heads"], d_inner=BERT["d_inner"], dropout=0.1,
            is_train=True, use_fused_attention=True)
        loss, _, _ = bert.pretrain_heads(
            enc, mask_label, mask_weight, ns_label, BERT["vocab_size"],
            BERT["d_model"], is_train=True)
        lr = fluid.layers.linear_lr_warmup(
            fluid.layers.polynomial_decay(r["lr"], r["decay_steps"],
                                          r["end_lr"], power=r["power"]),
            r["warmup"], 0.0, r["lr"])
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(r["clip_norm"]))
        fluid.optimizer.Adam(
            learning_rate=lr,
            regularization=fluid.regularizer.L2Decay(r["l2"])).minimize(loss)
        fluid.clip.set_gradient_clip(None)
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss, lr


def recipe_feed(batch, rng):
    from paddle_tpu_torch.models import bert

    return bert.make_fake_batch(batch, RECIPE["seq_len"],
                                BERT["vocab_size"], rng=rng, varlen=True)


def lockstep(fa, main, startup, fetch, feeds, run_kw, steps, on_first=None):
    """``steps`` steps of ``main`` on a captured and an eager executor
    started alike, step by step with the same feeds (``feeds[i %
    len(feeds)]``). Returns a dict: each executor's fetches a step, the
    state tensors that differed after any step, the captured executor's
    flash launches a step (the eager one's are taken back out), and the
    captured executor and scope. ``on_first(run)`` makes the first
    captured step (the eager warm-up) by calling ``run()``."""
    import torch

    import paddle_tpu_torch.fluid as fluid

    persistable = sorted(v.name for v in main.list_vars() if v.persistable)
    graph, graph_scope = fresh(startup)
    eager, eager_scope = fresh(startup, graphs=False)
    out = {"captured": [], "eager": [], "unequal": [], "launches": []}
    for step in range(steps):
        feed = feeds[step % len(feeds)]
        before = step_counts(fa)
        with fluid.scope_guard(graph_scope):
            if step == 0 and on_first is not None:
                vals = on_first(lambda: graph.run(
                    main, feed=feed, fetch_list=fetch, **run_kw))
            else:
                vals = graph.run(main, feed=feed, fetch_list=fetch, **run_kw)
        out["captured"].append([np.asarray(v).reshape(-1).tolist()
                                for v in vals])
        counted = step_counts(fa)
        out["launches"].append([a - b for a, b in zip(counted, before)])
        with fluid.scope_guard(eager_scope):
            vals = eager.run(main, feed=feed, fetch_list=fetch, **run_kw)
        out["eager"].append([np.asarray(v).reshape(-1).tolist()
                             for v in vals])
        fa.launches, fa.launches_dq, fa.launches_dkv = counted
        for n in persistable:
            if not torch.equal(graph_scope.get(n), eager_scope.get(n)):
                out["unequal"].append([step + 1, n])
    out["graph"] = (graph, graph_scope)
    out["entries"] = [(c.captures, c.replays)
                      for c in captured(graph.engine)]
    del eager, eager_scope
    return out


def check_lr(lrs, per_step):
    """The fetched learning rates against the closed form: step s (from
    1) read the mean over its counter values (``per_step`` of them, one
    a micro-batch under accumulation). Returns the worst relative
    error."""
    worst = 0.0
    for s, got in enumerate(lrs, 1):
        cs = [per_step * (s - 1) + i for i in range(1, per_step + 1)]
        want = sum(_lr_recipe(float(c)) for c in cs) / per_step
        worst = max(worst, abs(got - want) / want)
    return worst


def recipe_times(exe, scope, main, loss, feed, run_kw, batch):
    row = time_train_step(exe, scope, main, loss, feed, run_kw=run_kw)
    row["sequences_per_s"] = batch / (row["median_ms"] / 1e3)
    return {k: row[k] for k in ("median_ms", "min_ms", "max_ms",
                                "sequences_per_s", "device_busy_ms",
                                "device_idle_share", "flash_kernels_ms",
                                "top_kernels_ms")}


def phase_bert_recipe(fa, smi):
    """BERT-base at seq 512 under the pre-training recipe, captured three
    ways against eager runs of the same steps: (b) remat over 12 segments
    and no remat at batch 8, (a) 4 accumulated micro-batches of 8, (c) a
    dispatch window of 4 against depth 1. Returns the flash launches of
    each path's steps."""
    import torch

    import paddle_tpu_torch.fluid as fluid

    r = RECIPE
    main, startup, loss, lr = recipe_program()
    fetch = [loss, lr]
    n_layers = BERT["n_layers"]
    feed8 = recipe_feed(8, np.random.RandomState(51))
    launches = {}
    rows = {}

    # (b) remat 12 against none, batch 8
    for segments in (0, r["remat_segments"]):
        release_memory()
        peak = {}

        def first(run):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            vals = run()
            torch.cuda.synchronize()
            peak["eager_first_run_peak_bytes"] = \
                torch.cuda.max_memory_allocated()
            peak["allocated_before_bytes"] = base
            return vals

        kw = {"remat_segments": segments} if segments else {}
        fa.launches = fa.launches_dq = fa.launches_dkv = 0
        out = lockstep(fa, main, startup, fetch, [feed8], kw,
                       RECIPE_STEPS, on_first=first)
        name = "remat%d" % segments
        launches[name] = flash_launches(fa)
        graph, graph_scope = out["graph"]
        # what the captured executor holds: its state, its graph's pool
        # (the eager executor and the allocator's cache released)
        release_memory()
        peak["memory_reserved_after_capture_bytes"] = \
            torch.cuda.memory_reserved()
        lrs = [v[1][0] for v in out["captured"]]
        row = {"batch": 8, "remat_segments": segments,
               "losses": [v[0][0] for v in out["captured"]],
               "lr": lrs, "lr_worst_rel_err": check_lr(lrs, 1),
               "unequal_state": out["unequal"][:5],
               "captured_equals_eager": out["captured"] == out["eager"],
               "launches_per_step": out["launches"],
               "graphs": out["entries"], "memory": peak}
        if segments:
            # the remat step run twice: a second captured executor from
            # the same state, the same steps
            again, again_scope = fresh(startup)
            with fluid.scope_guard(again_scope):
                twice = [np.asarray(again.run(
                    main, feed=feed8, fetch_list=fetch, **kw)[0]).tolist()
                    for _ in range(RECIPE_STEPS)]
            row["run_twice_equal"] = (
                [t[0] for t in twice] == row["losses"]
                and all(torch.equal(again_scope.get(n), graph_scope.get(n))
                        for n in graph_scope.local_var_names()))
            del again, again_scope
        row.update(recipe_times(graph, graph_scope, main, loss, feed8, kw, 8))
        rows[name] = row
        emit(dict({"phase": "bert_recipe", "card": smi, "path": name,
                   "seq_len": r["seq_len"]}, **row))
        want = [[n_layers * (2 if segments else 1), n_layers, n_layers]] \
            * RECIPE_STEPS
        check(row["launches_per_step"] == want,
              "%s: flash launches a step %s, want %s"
              % (name, row["launches_per_step"], want[0]))
        check(row["captured_equals_eager"] and not row["unequal_state"],
              "%s: captured and eager steps differ: %s" % (
                  name, row["unequal_state"]))
        check(all(np.isfinite(row["losses"])), "%s losses" % name)
        check(row["lr_worst_rel_err"] <= RECIPE_TOL["lr_rtol"],
              "%s: lr %s off the closed form" % (name, lrs))
        check(len(row["graphs"]) == 1 and row["graphs"][0][0] == 1,
              "%s: graphs %s" % (name, row["graphs"]))
        if segments:
            check(row["run_twice_equal"], "the remat step run twice differs")
        del out, graph, graph_scope
    # the remat grads come from autograd, the plain ones from the explicit
    # grad ops: the same step up to float rounding
    plain, remat = (rows[k]["losses"] for k in (
        "remat0", "remat%d" % r["remat_segments"]))
    worst = max(abs(a - b) / abs(b) for a, b in zip(remat, plain))
    emit({"phase": "bert_recipe", "remat_vs_plain_loss_worst_rel": worst,
          "tol": TRAIN_TOL["loss_rtol"]})
    check(worst <= TRAIN_TOL["loss_rtol"], "remat and plain losses differ: "
          "%s against %s" % (remat, plain))

    # (a) 4 accumulated micro-batches of 8 (batch 32)
    release_memory()
    feed32 = recipe_feed(32, np.random.RandomState(52))
    kw = {"accumulate_steps": 4}
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    out = lockstep(fa, main, startup, fetch, [feed32], kw, RECIPE_STEPS)
    launches["accumulate4"] = flash_launches(fa)
    graph, graph_scope = out["graph"]
    lrs = [v[1][0] for v in out["captured"]]
    row = {"batch": 32, "accumulate_steps": 4,
           "losses": [v[0][0] for v in out["captured"]], "lr": lrs,
           "lr_worst_rel_err": check_lr(lrs, 4),
           "counter": float(graph_scope.get("@LR_DECAY_COUNTER@")[0]),
           "unequal_state": out["unequal"][:5],
           "captured_equals_eager": out["captured"] == out["eager"],
           "launches_per_step": out["launches"], "graphs": out["entries"]}
    row.update(recipe_times(graph, graph_scope, main, loss, feed32, kw, 32))
    emit(dict({"phase": "bert_recipe", "card": smi, "path": "accumulate4",
               "seq_len": r["seq_len"]}, **row))
    check(row["launches_per_step"] == [[4 * n_layers] * 3] * RECIPE_STEPS,
          "accumulate: flash launches a step %s" % row["launches_per_step"])
    check(row["captured_equals_eager"] and not row["unequal_state"],
          "accumulate: captured and eager steps differ: %s"
          % row["unequal_state"])
    check(all(np.isfinite(row["losses"])), "accumulate losses")
    check(row["lr_worst_rel_err"] <= RECIPE_TOL["lr_rtol"],
          "accumulate: lr %s off the closed form" % lrs)
    del out, graph, graph_scope

    # (c) a dispatch window of 4 against depth 1, 8 steps, each loop read
    # only at its end
    release_memory()
    pool = [recipe_feed(8, np.random.RandomState(60 + i)) for i in range(2)]
    runs = {}
    for label, graphs, depth in (("captured_depth4", True, 4),
                                 ("eager_depth4", False, 4),
                                 ("captured_depth1", True, 1)):
        exe, scope = fresh(startup, graphs=graphs)
        before = step_counts(fa)
        with fluid.scope_guard(scope):
            vals = [exe.run(main, feed=pool[i % 2], fetch_list=fetch,
                            dispatch_steps=depth)
                    for i in range(WINDOW_STEPS)]
            exe.sync()
        counted = [a - b for a, b in zip(step_counts(fa), before)]
        runs[label] = {"exe": exe, "scope": scope, "launches": counted,
                       "fetches": [[np.asarray(v).reshape(-1).tolist()
                                    for v in step] for step in vals]}
    launches["window4"] = dict(zip(
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
        runs["captured_depth4"]["launches"]))
    ref = runs["captured_depth4"]
    names = sorted(ref["scope"].local_var_names())
    same = {label: run["fetches"] == ref["fetches"] and all(
        torch.equal(run["scope"].get(n), ref["scope"].get(n)) for n in names)
        for label, run in runs.items()}
    lrs = [v[1][0] for v in ref["fetches"]]

    def loop(exe, scope, depth):
        def run():
            with fluid.scope_guard(scope):
                vals = [exe.run(main, feed=pool[i % 2], fetch_list=[loss],
                                dispatch_steps=depth)[0]
                        for i in range(WINDOW_STEPS)]
                exe.sync()
                return float(np.asarray(vals[-1]).reshape(-1)[0])
        return run

    # the idle share of a loop: the gaps in the card's timeline between
    # its first and last kernel (a synchronous loop's host waits)
    timing = {}
    for depth in (1, 4):
        run_ = runs["captured_depth%d" % depth]
        run = loop(run_["exe"], run_["scope"], depth)
        walls = timed_runs(run, n=3, warmup=1)
        _, _, active_ms, span_ms = profiled_loop(run)
        step_ms = walls["median_ms"] / WINDOW_STEPS
        timing["depth%d" % depth] = {
            "step_ms": step_ms, "sequences_per_s": 8 / (step_ms / 1e3),
            "device_active_ms": active_ms / WINDOW_STEPS,
            "device_idle_share": 1.0 - active_ms / span_ms,
            "loop_ms": walls}
    row = {"batch": 8, "dispatch_steps": 4, "steps": WINDOW_STEPS,
           "losses": {k: [v[0][0] for v in r_["fetches"]]
                      for k, r_ in runs.items()},
           "lr": lrs, "lr_worst_rel_err": check_lr(lrs, 1),
           "bitwise_equal_to_captured_depth4": same,
           "launches": {k: r_["launches"] for k, r_ in runs.items()},
           "graphs": [(c.captures, c.replays)
                      for c in captured(ref["exe"].engine)],
           "times": timing}
    emit(dict({"phase": "bert_recipe", "card": smi, "path": "window4",
               "seq_len": r["seq_len"]}, **row))
    check(all(same.values()), "window: depth 4, eager and depth 1 differ: "
          "%s" % same)
    check(row["lr_worst_rel_err"] <= RECIPE_TOL["lr_rtol"],
          "window: lr %s off the closed form" % lrs)
    check(ref["launches"] == [n_layers * WINDOW_STEPS] * 3,
          "window: flash launches %s over %d steps" % (ref["launches"],
                                                       WINDOW_STEPS))
    del runs, ref
    release_memory()
    return launches


def _union(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def device_intervals(prof):
    """From a profile's device events: (ms of host-to-device copies, the
    share of that time during which a kernel ran, ms the card was active
    at all (the union of kernels and copies), ms from the first event's
    start to the last one's end)."""
    from torch.autograd import DeviceType

    copies, kernels = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if e.name.startswith("Memcpy HtoD"):
            copies.append(span)
        elif not e.name.startswith(("Memcpy", "Memset")):
            kernels.append(span)
    busy = _union(kernels)
    total = sum(b - a for a, b in copies)
    over = 0.0
    for a, b in copies:
        for ka, kb in busy:
            if kb <= a:
                continue
            if ka >= b:
                break
            over += min(b, kb) - max(a, ka)
    spans = _union(kernels + copies)
    active = sum(b - a for a, b in spans)
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    return (total / 1e3, (over / total if total else 0.0), active / 1e3,
            span / 1e3)


def profiled_loop(run):
    """One profiled call of ``run`` (a loop of steps ending in a wait);
    its ``device_intervals``."""
    return device_intervals(profiled(run))


def phase_resnet50_pipelined(fa, main, startup, loss, smi):
    """ResNet-50 at batch 32, Momentum, captured, fed from a rotating pool
    of 3 host batches: the synchronous loop (numpy feeds, depth 1)
    against ``prefetch_to_device`` (pinned buffers, a copy stream,
    ``prefetch_depth`` 2) with ``dispatch_steps=2``, from the same state:
    losses bitwise equal; step ms, images/s, the idle share of the
    card's timeline, the feed's copy time and how much of it overlaps
    kernels. Returns the flash launches (none)."""

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.engine.pipeline import prefetch_to_device

    pool = [resnet_feed(RESNET_BATCH, np.random.RandomState(70 + i))
            for i in range(3)]
    n = PIPELINE_STEPS

    def reader(count):
        def read():
            for i in range(count):
                yield pool[i % 3]
        return read

    def sync_loop(exe, scope, count):
        with fluid.scope_guard(scope):
            return [float(exe.run(main, feed=pool[i % 3],
                                  fetch_list=[loss])[0].reshape(-1)[0])
                    for i in range(count)]

    def pipelined_loop(exe, scope, count):
        with fluid.scope_guard(scope):
            vals = [exe.run(main, feed=f, fetch_list=[loss],
                            dispatch_steps=2)[0]
                    for f in prefetch_to_device(reader(count), depth=2)()]
            exe.sync()
        return [float(np.asarray(v).reshape(-1)[0]) for v in vals]

    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    rows, losses = {}, {}
    for name, loop in (("synchronous", sync_loop),
                       ("prefetch_window2", pipelined_loop)):
        release_memory()
        exe, scope = fresh(startup)
        losses[name] = loop(exe, scope, n)
        walls = timed_runs(lambda: loop(exe, scope, n), n=3, warmup=0)
        copy_ms, overlap, active_ms, span_ms = profiled_loop(
            lambda: loop(exe, scope, n))
        step_ms = walls["median_ms"] / n
        rows[name] = {"step_ms": step_ms,
                      "images_per_s": RESNET_BATCH / (step_ms / 1e3),
                      "device_active_ms": active_ms / n,
                      "device_idle_share": 1.0 - active_ms / span_ms,
                      "h2d_copy_ms_per_step": copy_ms / n,
                      "h2d_overlapping_kernels_share": overlap,
                      "graphs": [(c.captures, c.replays)
                                 for c in captured(exe.engine)]}
        del exe, scope
    launches = flash_launches(fa)
    emit({"phase": "resnet50_pipelined", "card": smi, "batch": RESNET_BATCH,
          "steps": n, "pool": 3, "prefetch_depth": 2, "dispatch_steps": 2,
          "losses": losses, "runs": rows, "launches": launches})
    check(losses["synchronous"] == losses["prefetch_window2"],
          "the prefetched loop's losses differ: %s" % losses)
    check(all(np.isfinite(losses["synchronous"])), "ResNet-50 losses")
    check(not any(launches.values()), "flash launches in ResNet-50")
    release_memory()
    return launches


def optimizer_operands(op_type, shape, seed):
    """The operands of one optimizer update at ``shape`` (float32 CPU
    tensors from ``seed``), as the op's slots take them: weights of a few
    hundredths, grads of a hundredth, accumulators as some steps of such
    grads leave them (FTRL's squared sum about ten grads' squares)."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def f(low=None, scale=1.0):
        x = torch.randn(shape, generator=gen) * scale
        return x.abs() + low if low is not None else x

    one = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    lr = one(0.01)
    p, g = f(scale=0.05), f(scale=0.01)
    return {
        "lars_momentum": ({"Param": p, "Grad": g, "Velocity": f(scale=0.01),
                           "LearningRate": lr},
                          {"mu": 0.9, "lars_coeff": 0.001,
                           "lars_weight_decay": 0.0005}),
        "adamax": ({"Param": p, "Grad": g, "Moment": f(scale=0.01),
                    "InfNorm": f(low=0.01, scale=0.01), "LearningRate": lr,
                    "Beta1Pow": one(0.81)},
                   {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "adagrad": ({"Param": p, "Grad": g, "Moment": f(low=0.0, scale=0.01),
                     "LearningRate": lr}, {"epsilon": 1e-6}),
        "decayed_adagrad": ({"Param": p, "Grad": g,
                             "Moment": f(low=0.0, scale=0.01),
                             "LearningRate": lr},
                            {"decay": 0.95, "epsilon": 1e-6}),
        "adadelta": ({"Param": p, "Grad": g,
                      "AvgSquaredGrad": f(low=0.0, scale=0.01),
                      "AvgSquaredUpdate": f(low=0.0, scale=0.01)},
                     {"rho": 0.95, "epsilon": 1e-6}),
        "rmsprop": ({"Param": p, "Grad": g, "Moment": f(scale=0.01),
                     "MeanSquare": f(low=1e-3, scale=0.01),
                     "MeanGrad": f(scale=0.001), "LearningRate": lr},
                    {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9,
                     "centered": True}),
        "ftrl": ({"Param": p, "Grad": g,
                  "SquaredAccumulator": 10.0 * g * g + f(low=1e-6,
                                                         scale=1e-5),
                  "LinearAccumulator": f(scale=0.01), "LearningRate": lr},
                 {"l1": 0.001, "l2": 0.001, "lr_power": -0.5}),
        "model_average_accum": ({"Param": p, "Sum": f(), "Cnt": one(5.0),
                                 "OldSum": f(), "OldCnt": one(10.0),
                                 "Total": one(30.0)},
                                {"average_window_rate": 0.15,
                                 "min_average_window": 6,
                                 "max_average_window": 20}),
    }[op_type]


def phase_optimizers(smi):
    """Each of the eight update ops the port adds on the card against the
    CPU, from identical operands, at BERT-base's word embedding (30522 x
    768) and an FFN weight (768 x 3072): every output within
    OPT_TOL * max|want|. Then ``ModelAverage.apply``/``restore`` on the
    card around a captured evaluation."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import unique_name

    worst = {}
    for i, op_type in enumerate(OPTIMIZER_OPS):
        for shape in ((BERT["vocab_size"], BERT["d_model"]),
                      (BERT["d_model"], BERT["d_inner"])):
            ins, attrs = optimizer_operands(op_type, shape, 80 + i)
            outs = {}
            for device in ("cpu", "cuda"):
                got = lower_op(op_type, {s: [v.to(device)]
                                         for s, v in ins.items()},
                               attrs, device)
                outs[device] = {s: v[0].cpu() for s, v in got.items()}
            errs = {}
            for slot, want in outs["cpu"].items():
                err = float((outs["cuda"][slot] - want).abs().max())
                scale = float(want.abs().max())
                errs[slot] = err / scale if scale else err
                check(err <= OPT_TOL * scale, "%s %s on the card: %s off "
                      "by %g (max |want| %g)" % (op_type, shape, slot, err,
                                                 scale))
            worst["%s %dx%d" % ((op_type,) + shape)] = max(errs.values())

    # ModelAverage beside SGD on a small MLP, captured on the card
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=64, act="relu")
        logits = fluid.layers.fc(input=h, size=8)
        avg_loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits=logits, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_loss)
        average = fluid.optimizer.ModelAverage(0.15, min_average_window=2,
                                               max_average_window=4)
    test = main.clone(for_test=True)
    rng = np.random.RandomState(90)
    feed = {"x": rng.randn(16, 64).astype(np.float32),
            "y": rng.randint(0, 8, (16, 1)).astype(np.int64)}
    exe, scope = fresh(startup)
    params = [p.name for p in main.all_parameters()]
    with fluid.scope_guard(scope):
        for _ in range(6):
            exe.run(main, feed=feed, fetch_list=[avg_loss])
        trained = {n: scope.get(n).clone() for n in params}
        eval_trained = exe.run(test, feed={"x": feed["x"]},
                               fetch_list=[logits])[0]
        want = {}
        for p, s, c, old_s, old_c in average._avg_params:
            cnt = float((scope.get(c.name) + scope.get(old_c.name))[0])
            want[p.name] = (scope.get(s.name) + scope.get(old_s.name)) / cnt
        with average.apply(exe):
            applied = {n: torch.equal(scope.get(n), want[n].to(
                scope.get(n).dtype)) for n in params}
            eval_avg = exe.run(test, feed={"x": feed["x"]},
                               fetch_list=[logits])[0]
        restored = all(torch.equal(scope.get(n), trained[n])
                       for n in params)
        eval_again = exe.run(test, feed={"x": feed["x"]},
                             fetch_list=[logits])[0]
    row = {"phase": "optimizers", "card": smi, "tol_rel_to_max": OPT_TOL,
           "worst_rel_err": worst, "model_average": {
               "applied_equal_to_window_mean": applied,
               "restored_bitwise": restored,
               "eval_changed_under_apply": not np.array_equal(eval_avg,
                                                              eval_trained),
               "eval_after_restore_equal": np.array_equal(eval_again,
                                                          eval_trained),
               "graphs": [(c.captures, c.replays)
                          for c in captured(exe.engine)]}}
    emit(row)
    ma = row["model_average"]
    check(all(applied.values()) and restored
          and ma["eval_changed_under_apply"]
          and ma["eval_after_restore_equal"],
          "ModelAverage apply/restore on the card: %s" % ma)
    del exe, scope
    release_memory()


def mfu_run(label, program, startup, loss, feed, peak, smi, steps=5):
    """The mfu.* gauges and the counted FLOPs a step of ``steps``
    replayed steps: a fresh executor (the startup run outside the
    ledger), the goodput ledger on for the eager first run (which counts
    the FLOPs, charged to compile) and the capture, then reset, so the
    rates are the replays'."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import goodput

    exe, scope = fresh(startup)
    flags.set_flags({"goodput": True, "peak_flops": peak})
    try:
        goodput.reset()
        with fluid.scope_guard(scope):
            for _ in range(2):
                exe.run(program, feed=feed, fetch_list=[loss])
            warm_up = goodput.snapshot()["categories"]
            goodput.reset()
            # a reset ledger anchors at its first mark: anchor it here, so
            # the first replay's time is charged with its FLOPs
            goodput.mark("idle")
            for _ in range(steps):
                exe.run(program, feed=feed, fetch_list=[loss])
        snap = goodput.snapshot()
        gauges = {g: obs.registry.gauge_value(g) for g in (
            "mfu.model_flops_per_step", "mfu.achieved_flops_per_s",
            "mfu.mfu", "mfu.goodput_mfu", "mfu.peak_flops")}
    finally:
        flags.reset_flag("goodput")
        flags.reset_flag("peak_flops")
        goodput.reset()
    row = {"phase": "mfu", "card": smi, "run": label, "steps": steps,
           "gauges": gauges, "goodput_frac": snap["goodput_frac"],
           "categories_ms": {k: v for k, v in snap["categories"].items()
                             if v},
           "warm_up_categories_ms": {k: v for k, v in warm_up.items()
                                     if v}}
    emit(row)
    check(gauges["mfu.model_flops_per_step"] > 0 and gauges["mfu.mfu"] > 0,
          "%s: mfu gauges %s" % (label, gauges))
    del exe, scope
    return row


def phase_mfu(smi, name):
    """The mfu.* gauges of the captured BERT-base (seq 128, batch 8) and
    ResNet-50 (batch 32) steps, float32 and AMP, against the card's peak
    for the step's type (float32: the FFMA rate, since TF32 is off;
    AMP: bf16 dense). ResNet-50's FLOPs a step within MFU_TOL of the
    analytic 0.79 TFLOP."""
    peaks = MFU_PEAKS.get("H100" if "H100" in name else None)
    check(peaks is not None, "no peak FLOP/s known for %r" % name)
    rows = {}
    feed8 = train_feed(8, np.random.RandomState(11))
    for amp in (False, True):
        main, startup, loss = bert_train_program(amp)
        rows["bert_amp" if amp else "bert"] = mfu_run(
            "bert_base_seq128_b8" + ("_amp" if amp else ""), main, startup,
            loss, feed8, peaks["bfloat16" if amp else "float32"], smi)
        release_memory()
    r_feed = resnet_feed(RESNET_BATCH, np.random.RandomState(41))
    for amp in (False, True):
        r_main, r_startup, r_handles = resnet_program(True, amp=amp)
        rows["resnet_amp" if amp else "resnet"] = mfu_run(
            "resnet50_b32" + ("_amp" if amp else ""), r_main, r_startup,
            r_handles["loss"], r_feed,
            peaks["bfloat16" if amp else "float32"], smi)
        release_memory()
    flops = rows["resnet"]["gauges"]["mfu.model_flops_per_step"]
    emit({"phase": "mfu", "resnet50_flops_per_step": flops,
          "analytic": RESNET_STEP_FLOPS,
          "ratio": flops / RESNET_STEP_FLOPS, "peaks": peaks})
    check(abs(flops / RESNET_STEP_FLOPS - 1.0) <= MFU_TOL,
          "ResNet-50 counted %g FLOPs a step, analytic %g"
          % (flops, RESNET_STEP_FLOPS))
    return rows


# -- DeepFM CTR and word2vec (sparse embedding grads) -------------------


def deepfm_program(is_sparse=True):
    """DeepFM as ``models.deepfm.get_model(**CTR)`` builds it (the JAX
    package's CTR bench, bench.py:341-344), random weights from the seed.
    ``is_sparse=False`` is the dense control: the same desc with its
    lookups' ``is_sparse`` turned off, so the tables take dense grads and
    dense Adam. Returns (main, startup, handles)."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import deepfm

    with unique_name.guard():
        main, startup, handles = deepfm.get_model(**CTR)
    if not is_sparse:
        for op in main.desc.global_block().ops:
            if op.type in ("lookup_table", "lookup_table_grad"):
                op.attrs["is_sparse"] = False
        main._bump_version()
    main.random_seed = startup.random_seed = 2024
    return main, startup, handles


def ctr_feeds(batch, n, seed):
    from paddle_tpu_torch.models import deepfm

    rng = np.random.RandomState(seed)
    return [deepfm.make_fake_batch(batch, CTR["num_features"],
                                   CTR["num_fields"], rng) for _ in range(n)]


def adam_state_names(main, param):
    """(param, Moment1, Moment2) names of ``param``'s adam op."""
    for op in main.desc.global_block().ops:
        if op.type == "adam" and op.input("Param") == [param]:
            return (param, op.input("Moment1")[0], op.input("Moment2")[0])
    raise RuntimeError("no adam op updates %r" % param)


def sparse_ops_without_sync():
    """``lookup_table_grad`` (is_sparse) and the lazy ``adam`` branch run
    directly on the card at the CTR geometry under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any op
    that waits for the card (``.item()``, ``nonzero``, ``torch.unique``).
    Returns the rows the merge kept."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    n_ids = CTR["batch_size"] * CTR["num_fields"]
    shape = (CTR["num_features"], CTR["embed_dim"])
    ids = torch.randint(0, CTR["num_features"] // 8, (n_ids, 1),
                        generator=gen, device="cuda")
    w = torch.randn(shape, generator=gen, device="cuda")
    og = torch.randn((n_ids, CTR["embed_dim"]), generator=gen, device="cuda")
    one = lambda v: torch.tensor([v], device="cuda")  # noqa: E731

    def lower(op_type, ins, attrs):
        return lower_op(op_type, ins, attrs, "cuda")

    # every operand made first: a host value's copy to the card waits
    adam_ins = {"Param": [w], "Moment1": [torch.zeros_like(w)],
                "Moment2": [torch.zeros_like(w)],
                "LearningRate": [one(1e-3)], "Beta1Pow": [one(0.9)],
                "Beta2Pow": [one(0.999)]}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (g,) = lower("lookup_table_grad",
                     {"Ids": [ids], "W": [w], "Out@GRAD": [og]},
                     {"is_sparse": True, "padding_idx": -1})["W@GRAD"]
        outs = lower("adam", dict(adam_ins, Grad=[g]),
                     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
        merged = g.merged()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    unique = int((merged.rows < merged.height).sum())
    check(unique == int(torch.unique(ids).numel()),
          "the merge kept %d rows, torch.unique %d" % (
              unique, int(torch.unique(ids).numel())))
    check(all(torch.isfinite(v[0]).all() for v in outs.values()),
          "sparse adam outputs not finite")
    return unique


def phase_ctr(fa, smi):
    """DeepFM at the CTR geometry (CTR): the sparse step captured and run
    eagerly from the same state, step by step, bitwise equal; a second
    captured run bitwise equal to the first; rows outside the batches
    bitwise unchanged in each table and both its moments; no flash
    launch; the sparse ops under the sync guard; one step at batch 64
    against the CPU; sparse and dense step times. Returns the flash
    launches of its steps (none)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch import observability as obs

    main, startup, handles = deepfm_program()
    loss = handles["loss"]
    feeds = ctr_feeds(CTR["batch_size"], CTR_STEPS, 61)
    tables = [adam_state_names(main, p) for p in ("fm_v", "fm_w1")]
    persistable = sorted(v.name for v in main.list_vars() if v.persistable)
    unique_rows = sparse_ops_without_sync()

    def run_steps(exe, scope):
        with fluid.scope_guard(scope):
            return [float(exe.run(main, feed=f, fetch_list=[loss])[0]
                          .reshape(-1)[0]) for f in feeds]

    before = step_counts(fa)
    graph, graph_scope = fresh(startup)
    initial = {n: graph_scope.get(n).clone() for t in tables for n in t}
    eager, eager_scope = fresh(startup, graphs=False)
    obs.set_enabled(True)
    obs.reset()
    losses = {"captured": [], "eager": []}
    unequal = []
    for step, feed in enumerate(feeds):
        eager_before = obs.counter_value("engine.eager_runs")
        with fluid.scope_guard(graph_scope):
            (out,) = graph.run(main, feed=feed, fetch_list=[loss])
        check(obs.counter_value("engine.eager_runs") == eager_before,
              "the captured executor ran the sparse step eagerly")
        losses["captured"].append(float(out.reshape(-1)[0]))
        with fluid.scope_guard(eager_scope):
            (out,) = eager.run(main, feed=feed, fetch_list=[loss])
        losses["eager"].append(float(out.reshape(-1)[0]))
        for n in persistable:
            if not torch.equal(graph_scope.get(n), eager_scope.get(n)):
                unequal.append([step + 1, n])
    obs.set_enabled(None)
    entries = captured(graph.engine)
    again, again_scope = fresh(startup)
    twice = run_steps(again, again_scope)
    twice_equal = twice == losses["captured"] and all(
        torch.equal(again_scope.get(n), graph_scope.get(n))
        for n in persistable)
    del eager, eager_scope, again, again_scope
    # rows no batch touched: every table and both its moments unchanged
    touched = torch.zeros(CTR["num_features"], dtype=torch.bool,
                          device="cuda")
    for f in feeds:
        touched[torch.as_tensor(f["feat_ids"].reshape(-1),
                                device="cuda")] = True
    untouched = {}
    for names in tables:
        for n in names:
            now, was = graph_scope.get(n), initial[n]
            untouched[n] = bool(torch.equal(now[~touched], was[~touched]))
        moved = not torch.equal(graph_scope.get(names[0])[touched],
                                initial[names[0]][touched])
        check(moved, "%s: the batches' rows did not move" % names[0])
    launched = [a - b for a, b in zip(step_counts(fa), before)]
    row = {"phase": "ctr", "card": smi, "model": "deepfm",
           "config": CTR, "steps": CTR_STEPS, "losses": losses,
           "unequal_state": unequal[:10],
           "captured_equals_eager": losses["captured"] == losses["eager"]
           and not unequal, "run_twice_equal": twice_equal,
           "graphs": [(c.captures, c.replays) for c in entries],
           "rows_touched": int(touched.sum()),
           "untouched_rows_unchanged": untouched,
           "sync_guard_unique_rows": unique_rows,
           "flash_launches": launched}
    emit(row)
    check(all(np.isfinite(losses["captured"])), "ctr losses %s" % losses)
    check(row["captured_equals_eager"],
          "ctr: captured and eager steps differ: %s" % unequal[:5])
    check(twice_equal, "ctr: two captured runs differ")
    check(len(entries) == 1 and entries[0].captures == 1,
          "ctr: graphs %s" % row["graphs"])
    check(all(untouched.values()), "ctr: untouched rows changed: %s"
          % untouched)
    check(launched == [0, 0, 0], "ctr launched flash kernels %s" % launched)

    # one step at batch 64 on the card and on the CPU, same state
    state0 = start_state(main, startup)
    feed64 = ctr_feeds(CTR_CPU_BATCH, 1, 62)[0]
    grads = ["fm_v", "fm_w1"] + [p.name for p in main.all_parameters()
                                 if p.name.startswith("fc_")][:2]
    fetch = [loss.name] + [g + "@GRAD" for g in grads]
    results = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        convert.load_numpy_state(scope, state0, place.torch_device(),
                                 program=main)
        with fluid.scope_guard(scope):
            results.append(fluid.Executor(place).run(
                main, feed=feed64, fetch_list=fetch))
    del state0
    card, cpu = results
    loss_err = abs(float(card[0].reshape(-1)[0] - cpu[0].reshape(-1)[0]))
    grad_errs = {n: {"max_abs_err": float(np.abs(a - b).max()),
                     "max_abs": float(np.abs(b).max())}
                 for n, a, b in zip(grads, card[1:], cpu[1:])}
    emit({"phase": "ctr", "cpu_step": {
        "batch": CTR_CPU_BATCH, "loss_card": float(card[0].reshape(-1)[0]),
        "loss_cpu": float(cpu[0].reshape(-1)[0]), "loss_abs_err": loss_err,
        "grads": grad_errs}, "tol": TRAIN_TOL})
    check(loss_err <= TRAIN_TOL["loss_rtol"]
          * abs(float(cpu[0].reshape(-1)[0])),
          "ctr: card vs CPU loss error %g" % loss_err)
    for n, e in grad_errs.items():
        check(e["max_abs_err"] <= TRAIN_TOL["grad_rel_to_max"] * e["max_abs"],
              "ctr: card vs CPU %s@GRAD error %g (max %g)"
              % (n, e["max_abs_err"], e["max_abs"]))
    del results, card, cpu

    # sparse and dense step times (captured, one batch repeated)
    dense_main = deepfm_program(is_sparse=False)[0]
    times = {}
    for label, (prog, exe, scope) in (
            ("sparse", (main, graph, graph_scope)),
            ("dense", (dense_main,) + fresh(startup))):
        t = time_train_step(exe, scope, prog, loss, feeds[0])
        t["examples_per_s"] = CTR["batch_size"] / (t["median_ms"] / 1e3)
        times[label] = {k: t[k] for k in (
            "median_ms", "min_ms", "max_ms", "examples_per_s",
            "device_busy_ms", "device_idle_share", "top_kernels_ms")}
        del exe, scope
    emit({"phase": "ctr", "card": smi, "times": times,
          "batch": CTR["batch_size"]})
    del graph, graph_scope
    release_memory()
    return launched


def phase_word2vec(smi):
    """word2vec at its defaults (four lookups of one table, dense, SGD):
    WORD2VEC_STEPS captured steps on the card against the same steps on
    the CPU from the same state: losses within TRAIN_TOL, every parameter
    within OPT_TOL * max|want|."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import word2vec

    with unique_name.guard():
        main, startup, h = word2vec.get_model()
    main.random_seed = startup.random_seed = 2024
    state0 = start_state(main, startup)
    rng = np.random.RandomState(63)
    feeds = [word2vec.make_fake_batch(WORD2VEC_BATCH, 1000, 4, rng)
             for _ in range(WORD2VEC_STEPS)]
    runs = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        convert.load_numpy_state(scope, state0, place.torch_device(),
                                 program=main)
        exe = fluid.Executor(place)
        with fluid.scope_guard(scope):
            losses = [float(exe.run(main, feed=f, fetch_list=[h["loss"]])[0]
                            .reshape(-1)[0]) for f in feeds]
        runs.append((losses, {n: scope.get(n).cpu() for n in state0},
                     captured(exe.engine)))
    (card, card_state, entries), (cpu, cpu_state, _) = runs
    param_errs = {n: float((card_state[n] - cpu_state[n]).abs().max()
                           / max(float(cpu_state[n].abs().max()), 1e-30))
                  for n in state0 if card_state[n].is_floating_point()}
    row = {"phase": "ctr", "card": smi, "model": "word2vec",
           "losses_card": card, "losses_cpu": cpu,
           "param_rel_errs": param_errs,
           "graphs": [(c.captures, c.replays) for c in entries]}
    emit(row)
    check(all(abs(a - b) <= TRAIN_TOL["loss_rtol"] * abs(b)
              for a, b in zip(card, cpu)),
          "word2vec: card losses %s, CPU %s" % (card, cpu))
    check(max(param_errs.values()) <= OPT_TOL,
          "word2vec: params off the CPU's: %s" % param_errs)
    check(len(entries) == 1 and entries[0].captures == 1,
          "word2vec: graphs %s" % row["graphs"])
    check(all(np.isfinite(card)), "word2vec losses %s" % card)


# -- Transformer-base NMT -----------------------------------------------


def nmt_program(amp=False, dropout=None, fused=True):
    """Transformer-base as ``models.transformer.get_model(**NMT)`` builds
    it (bench.py:305-313), random weights from the seed; ``amp`` marks it
    for bfloat16, ``dropout`` overrides the rate, ``fused`` False builds
    the unfused attention composition. Returns (main, startup,
    handles)."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import transformer

    cfg = dict(NMT, use_fused_attention=fused)
    if dropout is not None:
        cfg["dropout"] = dropout
    with unique_name.guard():
        main, startup, handles = transformer.get_model(**cfg)
    main.random_seed = startup.random_seed = 2024
    if amp:
        mixed_precision.enable_bf16(main)
    return main, startup, handles


def nmt_feed(batch, seed):
    from paddle_tpu_torch.models import transformer

    return transformer.make_fake_batch(
        batch, NMT["seq_len"], NMT["vocab_size"],
        rng=np.random.RandomState(seed), varlen=True)


def nmt_kernel_cases():
    """The flash kernels' cases (KERNEL_CASES' form) at the shapes the
    Transformer's training step gives them: B=32, H=8, T=256, D=64 at the
    step's attention dropout, with the batch's source lengths (encoder
    self and cross attention) and its target lengths (the causal decoder),
    in float32 and in bfloat16 (AMP)."""
    feed = nmt_feed(NMT["batch_size"], NMT_FEED_SEED)
    B, H, T = NMT["batch_size"], NMT["n_heads"], NMT["seq_len"]
    D, rate = NMT["d_model"] // H, NMT["dropout"]
    cases = []
    for dt in ("float32", "bfloat16"):
        for causal, lens in ((False, feed["src_lens"]),
                             (True, feed["trg_lens"])):
            cases.append(("nmt_t256_%s%s_dropout_%g" % (
                dt, "_causal" if causal else "", rate), B, H, T, T, D, dt,
                causal, [int(n) for n in lens.reshape(-1)], None, rate))
    return cases


def nmt_steps(fa, main, startup, loss, feed, label, smi):
    """NMT_STEPS steps of one program on a fresh captured executor:
    losses, flash launches a step (every step 18 of each kernel, checked
    against the profiler once), the eager first run's peak allocation,
    one graph; then its step times. Returns (row, launches, executor,
    scope)."""
    import torch

    import paddle_tpu_torch.fluid as fluid

    want = [3 * NMT["n_layers"]] * 3
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    exe, scope = fresh(startup)
    losses, per_step = [], []
    release_memory()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    with fluid.scope_guard(scope):
        for step in range(NMT_STEPS):
            before = step_counts(fa)
            (out,) = exe.run(main, feed=feed, fetch_list=[loss])
            losses.append(float(out.reshape(-1)[0]))
            per_step.append([a - b for a, b in zip(step_counts(fa),
                                                   before)])
            if step == 0:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.synchronize()
    launches = flash_launches(fa)  # ... and ends here
    with fluid.scope_guard(scope):
        profiled, window, instances = flash_kernel_counts(
            lambda: exe.run(main, feed=feed, fetch_list=[loss]),
            dict(zip(names, want)))
    release_memory()
    entries = captured(exe.engine)
    t = time_train_step(exe, scope, main, loss, feed)
    tokens = int(feed["trg_lens"].sum())
    row = {"phase": "nmt", "card": smi, "run": label, "batch":
           NMT["batch_size"], "seq_len": NMT["seq_len"],
           "target_tokens": tokens, "losses": losses,
           "launches_per_step": per_step, "launches": launches,
           "profiled_replay_launches": profiled,
           "profiled_window": window, "flash_instances": instances,
           "graphs": [(c.captures, c.replays) for c in entries],
           "eager_first_run_peak_above_state_bytes": peak,
           "memory_reserved_after_capture_bytes":
           torch.cuda.memory_reserved(),
           "target_tokens_per_s": tokens / (t["median_ms"] / 1e3)}
    row.update({k: t[k] for k in ("median_ms", "min_ms", "max_ms",
                                  "device_busy_ms", "device_idle_share",
                                  "flash_kernels_ms", "top_kernels_ms")})
    emit(row)
    check(all(np.isfinite(losses)), "%s losses %s" % (label, losses))
    check(per_step == [want] * NMT_STEPS
          and profiled == dict(zip(names, want)),
          "%s: flash launches a step %s, profiled %s, want %s"
          % (label, per_step, profiled, want))
    check(len(entries) == 1 and entries[0].captures == 1,
          "%s: graphs %s" % (label, row["graphs"]))
    return row, launches, exe, scope


def _fused_attention_plain(ctx, ins, attrs):
    """``fused_attention`` by the plain torch attention, on any device:
    the witness that tells the kernel's part in a difference between the
    card and the CPU from that of the card's other float32 sums."""
    from paddle_tpu_torch.kernels.flash_attention import attention_lse_plain
    from paddle_tpu_torch.ops.nn_ops import _attention_args

    q, k, v, lens, rate, seed = _attention_args(ctx, ins, attrs)
    out, lse = attention_lse_plain(q, k, v, lens, None, seed,
                                   bool(attrs.get("causal", False)),
                                   attrs.get("scale", None), rate)
    return {"Out": [out], "Lse": [lse.unsqueeze(-1)]}


def _fused_attention_grad_plain(ctx, ins, attrs):
    """``fused_attention_grad`` by ``attention_bwd_plain``, on any
    device, from the forward's saved Out and Lse (the witness of
    ``_fused_attention_plain``)."""
    import torch

    from paddle_tpu_torch.kernels.flash_attention import attention_bwd_plain
    from paddle_tpu_torch.ops.common import single
    from paddle_tpu_torch.ops.nn_ops import _attention_args

    q, k, v, lens, rate, seed = _attention_args(ctx, ins, attrs)
    B, H, Tq = q.shape[:3]
    g = single(ins, "Out@GRAD")
    g = torch.zeros_like(q) if g is None else g.to(q.dtype).reshape(q.shape)
    dq, dk, dv = attention_bwd_plain(
        q, k, v, single(ins, "Out").to(q.dtype),
        single(ins, "Lse").reshape(B, H, Tq), g, None, lens, None, seed,
        bool(attrs.get("causal", False)), attrs.get("scale", None), rate)
    return {"Q@GRAD": [dq], "K@GRAD": [dk], "V@GRAD": [dv]}


PLAIN_ATTENTION = {"fused_attention": _fused_attention_plain,
                   "fused_attention_grad": _fused_attention_grad_plain}


def _relu_with_masks(masks):
    """``relu`` and ``relu_grad`` lowerings that keep the elements another
    run's relu kept, and pass their grads: ``masks`` maps each relu's
    output name to that run's ``Out > 0``."""
    import torch

    from paddle_tpu_torch.ops.common import single

    def relu(ctx, ins, attrs):
        x = single(ins, "X")
        keep = masks[ctx.op.output("Out")[0]].to(x.device)
        return {"Out": [torch.where(keep, x, torch.zeros_like(x))]}

    def relu_grad(ctx, ins, attrs):
        g = single(ins, "Out@GRAD")
        keep = masks[ctx.op.input("Out")[0]].to(g.device)
        return {"X@GRAD": [torch.where(keep, g, torch.zeros_like(g))]}

    return {"relu": relu, "relu_grad": relu_grad}


def nmt_cpu_step():
    """One Transformer-base step at batch NMT_CPU_BATCH and dropout 0
    from one state: on the card (the flash kernels), on the card with the
    plain torch attention in their place (PLAIN_ATTENTION), and on the
    CPU. The loss end to end (TRAIN_TOL); every op of the step on the
    CPU's operands (RESNET_OP_TOL), the attention ops also by the plain
    attention on the card. A relu whose input lies within float32
    rounding of 0 can decide the other way on the card than on the CPU,
    and one such element moves its token's grads through every layer
    below it by percents, so the end-to-end grads are also held against
    the CPU run with each card run's relu decisions (``_relu_with_masks``):
    the card's within TRAIN_TOL of it. Both card runs' decisions that
    differ from the CPU's, and their end-to-end grads against both CPU
    runs, are printed."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.core.registry import OpRegistry

    main, startup, h = nmt_program(dropout=0.0)
    state0 = start_state(main, startup)
    params = [p.name for p in main.all_parameters()]
    relus = [op.output("Out")[0] for op in main.desc.global_block().ops
             if op.type == "relu"]
    fetch = [h["loss"].name] + [p + "@GRAD" for p in params] + relus
    feed2 = nmt_feed(NMT_CPU_BATCH, 72)

    def run(place, lowers):
        port = {t: OpRegistry.get(t).lower for t in lowers}
        for t, fn in lowers.items():
            OpRegistry.get(t).lower = fn
        try:
            scope = fluid.Scope()
            convert.load_numpy_state(scope, state0, place.torch_device(),
                                     program=main)
            with fluid.scope_guard(scope):
                out = fluid.Executor(place).run(main, feed=feed2,
                                                fetch_list=fetch)
        finally:
            for t, fn in port.items():
                OpRegistry.get(t).lower = fn
        return {"loss": float(out[0].reshape(-1)[0]),
                "grads": out[1:1 + len(params)],
                "relu": dict(zip(relus, out[1 + len(params):]))}

    def against(r, want):
        rel = {n: float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                   1e-30)
               for n, a, b in zip(params, r["grads"], want["grads"])}
        return {"loss_abs_err": abs(r["loss"] - want["loss"]),
                "grads_rel_to_max": {n: rel[n] for n in NMT_GRADS},
                "worst_grads_rel_to_max": sorted(
                    rel.items(), key=lambda kv: -kv[1])[:5]}

    cpu = run(fluid.CPUPlace(), {})
    ends = {}
    for label, lowers in (("card", {}),
                          ("card_plain_attention", PLAIN_ATTENTION)):
        r = run(fluid.CUDAPlace(0), lowers)
        masks = {n: torch.from_numpy(v > 0) for n, v in r["relu"].items()}
        pinned = run(fluid.CPUPlace(), _relu_with_masks(masks))
        ends[label] = {
            "relu_decisions_unlike_cpu": {
                n: int(((v > 0) != (cpu["relu"][n] > 0)).sum())
                for n, v in r["relu"].items()},
            "against_cpu": against(r, cpu),
            "against_cpu_with_its_relu_decisions": against(r, pinned)}
        del r, masks, pinned
    worst, _, witnessed = replay_ops_on_card(
        main, state0, feed2, RESNET_OP_TOL,
        witness={"fused_attention_grad": _fused_attention_grad_plain,
                 "fused_attention": _fused_attention_plain})
    del state0
    by_slot = {}
    for w in witnessed:
        key = "%s %s" % (w["type"], w["slot"])
        by_slot[key] = {k: max(by_slot.get(key, {}).get(k, 0.0), w[k])
                        for k in ("port", "witness", "port_vs_witness")}
    emit({"phase": "nmt", "cpu_step": {
        "batch": NMT_CPU_BATCH, "dropout": 0.0, "loss_cpu": cpu["loss"],
        "end_to_end": ends, "ops_worst_rel_to_max": worst,
        "attention_ops_worst_rel_to_max": by_slot},
        "tol": TRAIN_TOL, "op_tol": RESNET_OP_TOL})
    emit({"phase": "nmt", "attention_ops_on_card": witnessed})
    card = ends["card"]["against_cpu"]
    check(card["loss_abs_err"] <= TRAIN_TOL["loss_rtol"] * abs(cpu["loss"]),
          "nmt: card vs CPU loss error %g" % card["loss_abs_err"])
    pinned = ends["card"]["against_cpu_with_its_relu_decisions"]
    check(pinned["worst_grads_rel_to_max"][0][1]
          <= TRAIN_TOL["grad_rel_to_max"],
          "nmt: card vs CPU with the card's relu decisions: %s"
          % pinned["worst_grads_rel_to_max"])


def phase_nmt(fa, smi, name):
    """Transformer-base NMT (NMT) on the card: the float32 and the AMP
    step (captured, 18 launches of each kernel a step: 6 encoder, 6
    causal decoder and 6 cross attentions), their times, memory and
    mfu.* gauges, AMP's first loss against float32's; one step at batch 2
    and dropout 0 against the CPU; the kernels at the Transformer's
    shapes (T=256, causal and not, float32 and bfloat16). Returns
    (launches by run, kernel rows)."""
    import torch

    feed = nmt_feed(NMT["batch_size"], NMT_FEED_SEED)
    rows, launches = {}, {}
    for amp in (False, True):
        label = "nmt_amp" if amp else "nmt"
        main, startup, h = nmt_program(amp=amp)
        row, launches[label], exe, scope = nmt_steps(
            fa, main, startup, h["loss"], feed, label, smi)
        del exe, scope
        release_memory()
        peaks = MFU_PEAKS["H100" if "H100" in name else None]
        row["mfu"] = mfu_run(label, main, startup, h["loss"], feed,
                             peaks["bfloat16" if amp else "float32"],
                             smi)["gauges"]
        rows[label] = row
        release_memory()
    first_err = (abs(rows["nmt_amp"]["losses"][0] - rows["nmt"]["losses"][0])
                 / abs(rows["nmt"]["losses"][0]))
    emit({"phase": "nmt", "amp_first_loss_rel_err": first_err,
          "tol": TRAIN_AMP_TOL})
    check(first_err <= TRAIN_AMP_TOL["first_loss_rtol"],
          "nmt: AMP first loss %g against float32 %g"
          % (rows["nmt_amp"]["losses"][0], rows["nmt"]["losses"][0]))
    check(rows["nmt_amp"]["flash_instances"] and all(
        "bfloat16" in n for n in rows["nmt_amp"]["flash_instances"]),
        "nmt AMP flash instances %s" % rows["nmt_amp"]["flash_instances"])

    nmt_cpu_step()
    release_memory()

    # the kernels at the Transformer's shapes: the batch's source lengths
    # (encoder, cross) and target lengths (the causal decoder)
    B, H, T, D = (NMT["batch_size"], NMT["n_heads"], NMT["seq_len"],
                  NMT["d_model"] // NMT["n_heads"])
    kernel_rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        for causal, lens in ((False, feed["src_lens"]),
                             (True, feed["trg_lens"])):
            case = "t256_%s%s" % (dt, "_causal" if causal else "")
            lens = lens.reshape(-1).tolist()
            fwd = time_kernel(fa, B, H, T, D, dtype, lens, causal=causal)
            bwd = time_bwd_kernels(fa, B, H, T, D, dtype, lens,
                                   causal=causal)
            kernel_rows[case] = {"fwd": fwd, "bwd": bwd}
            emit(dict({"phase": "times", "kernel": "flash_fwd",
                       "case": "nmt_" + case, "peaks": PEAKS}, **fwd))
            emit(dict({"phase": "times", "kernel": "flash_bwd",
                       "case": "nmt_" + case, "peaks": PEAKS}, **bwd))
    return launches, kernel_rows


# -- recurrence and control flow; the image builders ------------------------


def lstm_program(is_train=True):
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import lstm

    with unique_name.guard():
        main, startup, h = lstm.get_model(is_train=is_train, **LSTM)
    main.random_seed = startup.random_seed = 2024
    return main, startup, h


def lstm_feed(batch, rng):
    return {"seq": rng.randint(0, LSTM["dict_dim"], (
        batch, LSTM["seq_len"])).astype(np.int64),
        "label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}


def lockstep_steps(fa, main, startup, loss, feed, steps):
    """``steps`` training steps on two executors from the same startup
    state, one eager and one captured, step by step: returns (the two
    (executor, scope) pairs, their losses, the state tensors that
    differed, the captured run's eager block runs, the flash launches, the
    captured run's wall ms a step)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import observability as obs

    persistable = sorted(v.name for v in main.list_vars() if v.persistable)
    eager, eager_scope = fresh(startup, graphs=False)
    graph, graph_scope = fresh(startup)
    losses = {"eager": [], "captured": []}
    unequal, eager_runs, walls = [], 0, []
    obs.set_enabled(True)
    obs.reset()
    torch.cuda.synchronize()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    for step in range(steps):
        before = obs.counter_value("engine.eager_runs")
        t0 = time.perf_counter()
        with fluid.scope_guard(graph_scope):
            (out,) = graph.run(main, feed=feed, fetch_list=[loss])
        walls.append((time.perf_counter() - t0) * 1e3)
        eager_runs += obs.counter_value("engine.eager_runs") - before
        losses["captured"].append(float(out.reshape(-1)[0]))
        with fluid.scope_guard(eager_scope):
            (out,) = eager.run(main, feed=feed, fetch_list=[loss])
        losses["eager"].append(float(out.reshape(-1)[0]))
        for n in persistable:
            if not torch.equal(graph_scope.get(n), eager_scope.get(n)):
                unequal.append([step + 1, n])
    torch.cuda.synchronize()
    launches = flash_launches(fa)  # ... and ends here
    obs.set_enabled(None)
    return ((eager, eager_scope), (graph, graph_scope), losses, unequal,
            eager_runs, launches, walls)


def profiled_step(exe, scope, main, loss, feed, n=10):
    """``timed_runs`` of a step and its device profile over 3 more:
    busy ms (the union of the kernels' intervals: a captured graph may
    run independent kernels at once, so their times can sum past the
    wall), idle share, kernel launches a step, the top kernels."""
    import paddle_tpu_torch.fluid as fluid

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss])

    with fluid.scope_guard(scope):
        row = timed_runs(step, n=n)
        kernels = profile_kernels(step, 3)
        _, _, active, _ = profiled_loop(lambda: [step() for _ in range(3)])
    busy = active / 3
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:8]
    row.update({"device_busy_ms": busy,
                "kernel_ms_sum": sum(k["ms"] for k in kernels.values()),
                "device_idle_share": 1.0 - busy / row["median_ms"],
                "kernel_launches_per_step": sum(
                    k["per_call"] for k in kernels.values()),
                "top_kernels_ms": [[name[:80], k["ms"]]
                                   for name, k in top]})
    return row


def recurrent_op_ms(exe, scope, main, loss, feed):
    """Wall ms of each top-level ``recurrent`` and ``recurrent_grad`` op
    of one eager step, the card synchronised around each (the vjp grad
    runs the loop again before its backward)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.engine import lowering

    totals = {}
    run_op = lowering.run_op

    def timed(op, block, *args, **kwargs):
        if op.type not in ("recurrent", "recurrent_grad") or \
                block.idx != 0:
            return run_op(op, block, *args, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_op(op, block, *args, **kwargs)
        torch.cuda.synchronize()
        totals.setdefault(op.type, []).append(
            (time.perf_counter() - t0) * 1e3)

    lowering.run_op = timed
    try:
        with fluid.scope_guard(scope):
            exe.run(main, feed=feed, fetch_list=[loss])
    finally:
        lowering.run_op = run_op
    return totals


def rnn_op_case(op_type, attrs, gates, seed):
    """``op_type`` at the classifier's width ([B, T, gates * H], ragged
    lengths) on the card and on the CPU from the same operands: the
    outputs and every input's grad (``torch.func.vjp``, the engine's
    generic grad, with the same cotangents); returns the worst difference
    of each, relative to its largest element, and the card's ms."""
    import torch

    from paddle_tpu_torch.core.desc import OpDesc
    from paddle_tpu_torch.core.registry import LowerContext, OpRegistry

    B, T, H = LSTM["batch_size"], LSTM["seq_len"], LSTM["hidden_dim"]
    rng = np.random.RandomState(seed)
    n_bias = 7 * H if attrs.get("use_peepholes") else gates * H
    ins = {"Input": rng.randn(B, T, gates * H).astype(np.float32) * 0.5,
           "Weight": rng.randn(H, gates * H).astype(np.float32) * 0.05,
           "Bias": rng.randn(1, n_bias).astype(np.float32) * 0.1,
           "H0": rng.randn(B, H).astype(np.float32) * 0.1}
    lens = rng.randint(1, T + 1, B).astype(np.int64)
    lens[0] = T
    outs = ("Hidden", "Cell") if op_type == "dynamic_lstm" else ("Hidden",)
    cots = [rng.randn(B, T, H).astype(np.float32) for _ in outs]
    op = OpDesc(op_type, {}, {}, attrs)
    info = OpRegistry.get(op_type)
    slots = sorted(ins)

    def run(device):
        ctx = LowerContext(op, None, device)
        extra = {"SeqLen": [torch.from_numpy(lens).to(device)]}

        def fwd(*prims):
            fin = dict(extra, **{s: [p] for s, p in zip(slots, prims)})
            out = info.lower(ctx, fin, attrs)
            return tuple(out[s][0] for s in outs)

        prims = [torch.from_numpy(ins[s]).to(device) for s in slots]
        got, vjp = torch.func.vjp(fwd, *prims)
        grads = vjp(tuple(torch.from_numpy(c).to(device) for c in cots))
        return [t.cpu() for t in got + grads]

    card, cpu = run("cuda"), run("cpu")
    names = list(outs) + [s + "@GRAD" for s in slots]
    worst = {}
    for n, a, b in zip(names, card, cpu):
        peak = float(b.abs().max())
        worst[n] = float((a - b).abs().max()) / (peak or 1.0)

    def on_card():
        run("cuda")

    ms = timed_runs(on_card, n=3, warmup=1)["median_ms"]
    return worst, ms, int(lens.sum())


def while_array_program():
    """The JAX package's while-with-array test (tests/test_control_flow.py):
    write i*i into a tensor array for i < 5, then its length and element
    4."""
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        limit = fluid.layers.fill_constant(shape=[1], dtype="int64", value=5)
        arr = fluid.layers.create_array(dtype="float32", capacity=8)
        zero = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                          value=0.0)
        fluid.layers.array_write(zero, i, array=arr)
        cond = fluid.layers.less_than(x=i, y=limit)
        with fluid.While(cond=cond).block():
            sq = fluid.layers.cast(i, "float32")
            fluid.layers.array_write(fluid.layers.elementwise_mul(sq, sq),
                                     i, array=arr)
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.less_than(x=i, y=limit, cond=cond)
        ln = fluid.layers.array_length(arr)
        last = fluid.layers.array_read(
            arr, fluid.layers.fill_constant(shape=[1], dtype="int64",
                                            value=4))
    return main, startup, [ln, last]


def branch_programs():
    """An ``IfElse`` (rows whose sum is negative doubled, the rest through
    an fc) and a ``Switch`` cascade (a piecewise rate by step), the JAX
    package's control-flow test programs."""
    import paddle_tpu_torch.fluid as fluid

    ifelse, ifelse_startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(ifelse, ifelse_startup):
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        zero = fluid.layers.fill_constant_batch_size_like(
            input=x, shape=[-1, 1], dtype="float32", value=0.0)
        cond = fluid.layers.less_than(
            x=fluid.layers.reduce_sum(x, dim=1, keep_dim=True), y=zero)
        ie = fluid.layers.IfElse(cond)
        with ie.true_block():
            ie.output(fluid.layers.scale(ie.input(x), scale=2.0))
        with ie.false_block():
            ie.output(fluid.layers.fc(input=ie.input(x), size=64))
        (merged,) = ie()
    switch, switch_startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(switch, switch_startup):
        step = fluid.layers.data(name="step", shape=[1], dtype="float32",
                                 append_batch_size=False)
        lr = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                        value=0.001)
        sw = fluid.Switch()
        for bound, value in ((10.0, 1.0), (20.0, 0.1)):
            b = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                           value=bound)
            with sw.case(fluid.layers.less_than(x=step, y=b)):
                fluid.layers.assign(fluid.layers.fill_constant(
                    shape=[1], dtype="float32", value=value), output=lr)
        with sw.default():
            fluid.layers.assign(fluid.layers.fill_constant(
                shape=[1], dtype="float32", value=0.01), output=lr)
    return ((ifelse, ifelse_startup, merged), (switch, switch_startup, lr))


def dropout_cell_program():
    """A ``StaticRNN`` whose cell drops out its fc output (rate 0.5), with
    its loss, SGD and a seed: the seed-table slot of a sub-block."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import unique_name

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 2024
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[32, 64], dtype="float32")
        h0 = fluid.layers.fill_constant(shape=[32, 64], dtype="float32",
                                        value=0.0)
        rnn = fluid.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            hprev = rnn.memory(init=h0)
            z = fluid.layers.fc(input=[xt, hprev], size=64, act="tanh")
            d = fluid.layers.dropout(z, dropout_prob=0.5)
            rnn.update_memory(hprev, d)
            rnn.step_output(d)
        out = rnn()
        loss = fluid.layers.mean(fluid.layers.square(out))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, out, loss


def phase_control_flow(smi):
    """The control-flow cases of the ``lstm`` phase: a ``While`` writing
    a tensor array (eager, counted by ``engine.eager_runs``), an
    ``IfElse`` and a ``Switch`` (captured, against the CPU), and dropout
    in a ``StaticRNN`` cell captured against eager (bitwise) with the
    masks differing between steps."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import observability as obs

    row = {"phase": "lstm", "case": "control_flow", "card": smi}
    def graphs_of(exe, prog):
        # the engine's graphs of ``prog`` (its startup's are not counted)
        return [c for c in captured(exe.engine)
                if c.block_program.block is prog.desc.global_block()]

    main, startup, fetch = while_array_program()
    exe, scope = fresh(startup)
    obs.set_enabled(True)
    obs.reset()
    with fluid.scope_guard(scope):
        outs = [exe.run(main, feed={}, fetch_list=fetch) for _ in range(3)]
    row["while"] = {"length": int(outs[-1][0][0]),
                    "element_4": float(outs[-1][1][0]),
                    "eager_runs": obs.counter_value("engine.eager_runs"),
                    "graphs": len(graphs_of(exe, main))}
    obs.set_enabled(None)
    check(all(int(o[0][0]) == 5 and float(o[1][0]) == 16.0 for o in outs),
          "the While loop's array: %s" % row["while"])
    check(row["while"]["eager_runs"] == 3 and not row["while"]["graphs"],
          "the While block ran eagerly %d of 3 times, %d graphs"
          % (row["while"]["eager_runs"], row["while"]["graphs"]))

    (ie, ie_startup, merged), (sw, sw_startup, lr) = branch_programs()
    rng = np.random.RandomState(61)
    x = rng.randn(32, 64).astype(np.float32)
    cases = [(ie, ie_startup, merged, [{"x": x}] * 4),
             (sw, sw_startup, lr, [{"step": np.array([v], np.float32)}
                                   for v in (5.0, 15.0, 25.0, 5.0)])]
    branch = {}
    for name, (prog, prog_startup, out, feeds) in zip(("ifelse", "switch"),
                                                     cases):
        exe, scope = fresh(prog_startup)
        cpu = fluid.Executor(fluid.CPUPlace())
        cpu_scope = fluid.Scope()
        for n in (v.name for v in prog.list_vars() if v.persistable):
            cpu_scope.set(n, scope.get(n).cpu())
        obs.set_enabled(True)
        obs.reset()
        with fluid.scope_guard(scope):
            got = [exe.run(prog, feed=f, fetch_list=[out])[0]
                   for f in feeds]
        eager_runs = obs.counter_value("engine.eager_runs")
        obs.set_enabled(None)
        with fluid.scope_guard(cpu_scope):
            want = [cpu.run(prog, feed=f, fetch_list=[out])[0]
                    for f in feeds]
        entries = graphs_of(exe, prog)
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        branch[name] = {"graphs": len(entries),
                        "captures": [c.captures for c in entries],
                        "replays": [c.replays for c in entries],
                        "eager_runs": eager_runs, "max_abs_err_cpu": err}
        check(entries and eager_runs == 0, "%s not captured: %s"
              % (name, branch[name]))
        check(all(np.allclose(g, w, rtol=SERVE_TOL["rtol"],
                              atol=SERVE_TOL["atol"])
                  for g, w in zip(got, want)),
              "%s on the card against the CPU: %g" % (name, err))
    check([float(g[0]) for g in got] == [float(np.float32(v)) for v in
                                         (1.0, 0.1, 0.01, 1.0)],
          "the Switch's rates %s" % [float(g[0]) for g in got])
    row.update(branch)

    # dropout inside a StaticRNN cell: captured against eager
    main, startup, out, loss = dropout_cell_program()
    feed = {"x": rng.randn(16, 32, 64).astype(np.float32)}
    eager, eager_scope = fresh(startup, graphs=False)
    graph, graph_scope = fresh(startup)
    same, masks = True, None
    for _ in range(4):
        with fluid.scope_guard(graph_scope):
            g = graph.run(main, feed=feed, fetch_list=[out, loss])
        with fluid.scope_guard(eager_scope):
            e = eager.run(main, feed=feed, fetch_list=[out, loss])
        same = same and all(np.array_equal(a, b) for a, b in zip(g, e))
        masks = g[0] != 0
    per_step_differ = all(not np.array_equal(masks[0], masks[t])
                          for t in range(1, masks.shape[0]))
    row["dropout_cell"] = {
        "captured_equals_eager": same, "keep_share": float(masks.mean()),
        "masks_differ_between_steps": per_step_differ,
        "graphs": len(graphs_of(graph, main))}
    check(same and per_step_differ and row["dropout_cell"]["graphs"] == 1,
          "dropout in a StaticRNN cell: %s" % row["dropout_cell"])
    del exe, scope, eager, graph
    torch.cuda.synchronize()
    emit(row)


def phase_lstm(fa, smi):
    """The stacked-LSTM classifier on the card: 5 Adam steps eagerly and
    captured, bitwise equal; one step at batch 2 against the CPU; the
    ``for_test`` clone served at batch 1 and 32 (eager, then replayed,
    bitwise equal) and at batch 2 against the CPU; times; the recurrent
    ops against the CPU; the control-flow cases. Returns the flash
    launches of the path (none)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert

    main, startup, h = lstm_program()
    loss = h["loss"]
    feed = lstm_feed(LSTM["batch_size"], np.random.RandomState(51))
    t0 = time.perf_counter()
    (eager, graph, losses, unequal, eager_runs, launches,
     walls) = lockstep_steps(fa, main, startup, loss, feed, LSTM_STEPS)
    lockstep_s = time.perf_counter() - t0
    reserved = torch.cuda.memory_reserved()
    entries = captured(graph[0].engine)
    blocks = main.desc.blocks
    row = {"phase": "lstm", "card": smi, "model": "stacked_dynamic_lstm",
           "config": LSTM, "optimizer": "adam, lr 0.01",
           "blocks": len(blocks),
           "ops": [len(b.ops) for b in blocks],
           "losses": losses, "unequal_state": unequal[:10],
           "launches": launches, "graphs": len(entries),
           "captures": [c.captures for c in entries],
           "eager_runs": eager_runs,
           "captured_run_walls_ms": walls,
           "lockstep_seconds": lockstep_s,
           "memory_reserved_after_capture": reserved}
    emit(row)
    check(all(np.isfinite(losses["captured"])), "LSTM losses %s" % losses)
    # one batch repeated at Adam's 0.01 with no clipping: the first step
    # lowers the loss, later ones may overshoot (the JAX package's step
    # does too from the same state, PERF.md §6)
    check(losses["captured"][1] < losses["captured"][0],
          "LSTM loss did not fall: %s" % losses["captured"])
    check(losses["captured"] == losses["eager"] and not unequal,
          "LSTM captured and eager steps differ: losses %s, state %s"
          % (losses, unequal[:5]))
    check(len(entries) == 1 and entries[0].captures == 1
          and eager_runs == 0,
          "the LSTM step: %d graphs, captures %s, %d eager runs"
          % (len(entries), row["captures"], eager_runs))
    check(not any(launches.values()), "flash launches in the LSTM path: %s"
          % launches)

    # times: captured (with the device profile) and eager; the recurrent
    # ops of an eager step
    cap = profiled_step(graph[0], graph[1], main, loss, feed)
    with fluid.scope_guard(eager[1]):
        eag = timed_runs(lambda: eager[0].run(main, feed=feed,
                                              fetch_list=[loss]))
    rec = recurrent_op_ms(eager[0], eager[1], main, loss, feed)
    tokens = LSTM["batch_size"] * LSTM["seq_len"]
    for label, r in (("captured", cap), ("eager", eag)):
        emit(dict({"phase": "times", "card": smi,
                   "profile": "stacked LSTM training step", "run": label,
                   "batch": LSTM["batch_size"], "seq_len": LSTM["seq_len"],
                   "examples_per_s": LSTM["batch_size"] / (
                       r["median_ms"] / 1e3),
                   "tokens_per_s": tokens / (r["median_ms"] / 1e3),
                   "tf32": False}, **r))
    emit({"phase": "times", "card": smi,
          "profile": "recurrent ops of an eager LSTM step (synchronised)",
          "ms": rec, "capture_run_ms": walls[1],
          "replay_ms": cap["median_ms"]})
    del eager, graph, entries
    release_memory()

    # one step at batch 2 against the CPU, from the card's initial state
    state0 = start_state(main, startup)
    feed2 = lstm_feed(LSTM_CPU_BATCH, np.random.RandomState(52))
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    fetch = [loss.name] + grads
    outs = {}
    for device, place in (("cuda", fluid.CUDAPlace(0)),
                          ("cpu", fluid.CPUPlace())):
        scope = fluid.Scope()
        convert.load_numpy_state(scope, state0, device, program=main)
        with fluid.scope_guard(scope):
            outs[device] = fluid.Executor(place).run(main, feed=feed2,
                                                     fetch_list=fetch)
    card, cpu = outs["cuda"], outs["cpu"]
    loss_err = abs(float(card[0].reshape(-1)[0] - cpu[0].reshape(-1)[0]))
    grad_rel = {n: float(np.abs(a - b).max() / (np.abs(b).max() or 1.0))
                for n, a, b in zip(grads, card[1:], cpu[1:])}
    emit({"phase": "lstm", "cpu_step": {
        "batch": LSTM_CPU_BATCH, "loss_card": float(card[0].reshape(-1)[0]),
        "loss_cpu": float(cpu[0].reshape(-1)[0]), "loss_abs_err": loss_err,
        "grad_rel_to_max": grad_rel}, "tol": TRAIN_TOL})
    check(loss_err <= TRAIN_TOL["loss_rtol"] * abs(float(
        cpu[0].reshape(-1)[0])), "LSTM card vs CPU loss error %g" % loss_err)
    bad = {n: d for n, d in grad_rel.items()
           if d > TRAIN_TOL["grad_rel_to_max"]}
    check(not bad, "LSTM card vs CPU grads beyond %s: %s" % (TRAIN_TOL, bad))

    # inference on the for_test clone: batch 1 and 32 eager, then captured
    # and replayed; batch 2 against the CPU
    test_prog = main.clone(for_test=True)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    convert.load_numpy_state(scope, state0, "cuda", program=main)
    serve = {}
    rng = np.random.RandomState(53)
    for batch in LSTM_SERVE_BATCHES:
        seq = {"seq": lstm_feed(batch, rng)["seq"]}
        with fluid.scope_guard(scope):
            answers = [exe.run(test_prog, feed=seq,
                               fetch_list=[h["logits"]])[0]
                       for _ in range(4)]
            ms = timed_runs(lambda: exe.run(test_prog, feed=seq,
                                            fetch_list=[h["logits"]]))
        serve[batch] = {"replays_equal_eager": all(
            np.array_equal(a, answers[0]) for a in answers[1:]),
            "shape": list(answers[0].shape), "request_ms": ms}
        check(serve[batch]["replays_equal_eager"]
              and answers[0].shape == (batch, 2)
              and np.isfinite(answers[0]).all(),
              "LSTM served at batch %d: %s" % (batch, serve[batch]))
    test_entries = [c for c in captured(exe.engine)]
    seq2 = {"seq": feed2["seq"]}
    with fluid.scope_guard(scope):
        (card2,) = exe.run(test_prog, feed=seq2, fetch_list=[h["logits"]])
    cpu_scope = fluid.Scope()
    convert.load_numpy_state(cpu_scope, state0, "cpu", program=main)
    with fluid.scope_guard(cpu_scope):
        (cpu2,) = fluid.Executor(fluid.CPUPlace()).run(
            test_prog, feed=seq2, fetch_list=[h["logits"]])
    serve_err = float(np.abs(card2 - cpu2).max())
    emit({"phase": "lstm", "serve": serve, "graphs": len(test_entries),
          "batch2_max_abs_err_cpu": serve_err, "tol": SERVE_TOL})
    check(len(test_entries) == len(LSTM_SERVE_BATCHES),
          "LSTM serving graphs: %d" % len(test_entries))
    check(np.allclose(card2, cpu2, rtol=SERVE_TOL["rtol"],
                      atol=SERVE_TOL["atol"]),
          "LSTM served on the card against the CPU: %g" % serve_err)
    del exe, scope, test_entries
    release_memory()

    # dynamic_lstm and dynamic_gru against the CPU
    cases = []
    for i, (op_type, attrs, gates) in enumerate(RNN_OP_CASES):
        worst, ms, valid = rnn_op_case(op_type, attrs, gates, 80 + i)
        cases.append({"op": op_type, "attrs": attrs,
                      "shape": [LSTM["batch_size"], LSTM["seq_len"],
                                gates * LSTM["hidden_dim"]],
                      "valid_steps": valid, "rel_to_max": worst,
                      "fwd_bwd_ms": ms})
    emit({"phase": "lstm", "rnn_ops": cases, "tol": RNN_OP_TOL})
    bad = [(c["op"], c["attrs"], n, d) for c in cases
           for n, d in c["rel_to_max"].items()
           if d > RNN_OP_TOL["rel_to_max"]]
    check(not bad, "recurrent ops on the card beyond %s: %s"
          % (RNN_OP_TOL, bad))
    phase_control_flow(smi)
    release_memory()
    return launches


def image_program(name, is_train=True):
    import paddle_tpu_torch.models as models
    from paddle_tpu_torch import unique_name

    with unique_name.guard():
        main, startup, h = getattr(models, name).get_model(
            is_train=is_train, **IMAGE_MODELS[name])
    main.random_seed = startup.random_seed = 2024
    return main, startup, h


def image_feed(name, batch, rng):
    cfg = IMAGE_MODELS[name]
    return {"img": rng.randn(batch, *cfg["image_shape"]).astype(np.float32),
            "label": rng.randint(0, cfg["class_num"], (batch, 1)).astype(
                np.int64)}


def phase_image_models(fa, smi):
    """VGG, MobileNet and SE-ResNeXt-50 trained on the card at batch 32:
    IMAGE_STEPS steps eagerly and captured, bitwise equal; one step at
    batch 2 against the CPU, op by op (IMAGE_OP_TOL) and the loss end to
    end (TRAIN_TOL); step ms, images/s and idle share. Returns the flash
    launches of the path (none)."""
    import torch

    paths = {}
    for i, name in enumerate(IMAGE_MODELS):
        main, startup, h = image_program(name)
        loss = h["loss"]
        feed = image_feed(name, IMAGE_BATCH, np.random.RandomState(90 + i))
        (eager, graph, losses, unequal, eager_runs, launches,
         walls) = lockstep_steps(fa, main, startup, loss, feed, IMAGE_STEPS)
        entries = captured(graph[0].engine)
        reserved = torch.cuda.memory_reserved()
        row = {"phase": "image_models", "card": smi, "model": name,
               "config": IMAGE_MODELS[name], "batch": IMAGE_BATCH,
               "ops": len(main.desc.global_block().ops),
               "losses": losses, "unequal_state": unequal[:10],
               "launches": launches, "graphs": len(entries),
               "captures": [c.captures for c in entries],
               "eager_runs": eager_runs,
               "memory_reserved_after_capture": reserved}
        emit(row)
        check(all(np.isfinite(losses["captured"])), "%s losses %s"
              % (name, losses))
        check(losses["captured"] == losses["eager"] and not unequal,
              "%s captured and eager steps differ: losses %s, state %s"
              % (name, losses, unequal[:5]))
        check(len(entries) == 1 and entries[0].captures == 1
              and eager_runs == 0,
              "the %s step: %d graphs, captures %s, %d eager runs"
              % (name, len(entries), row["captures"], eager_runs))
        check(not any(launches.values()), "flash launches in %s: %s"
              % (name, launches))
        paths[name] = launches
        cap = profiled_step(graph[0], graph[1], main, loss, feed)
        emit(dict({"phase": "times", "card": smi,
                   "profile": "%s training step" % name, "run": "captured",
                   "batch": IMAGE_BATCH, "images_per_s": IMAGE_BATCH / (
                       cap["median_ms"] / 1e3), "tf32": False}, **cap))
        del eager, graph, entries
        release_memory()

        # one step at batch 2 on the card against the CPU
        state0 = start_state(main, startup)
        feed2 = image_feed(name, 2, np.random.RandomState(95 + i))
        worst, cpu_env, _ = replay_ops_on_card(main, state0, feed2,
                                               IMAGE_OP_TOL)
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch import convert

        step_scope = fluid.Scope()
        convert.load_numpy_state(step_scope, state0, "cuda", program=main)
        with fluid.scope_guard(step_scope):
            (card,) = fluid.Executor(fluid.CUDAPlace(0)).run(
                main, feed=feed2, fetch_list=[loss])
        cpu = cpu_env[loss.name].numpy()
        loss_err = abs(float(card.reshape(-1)[0] - cpu.reshape(-1)[0]))
        emit({"phase": "image_models", "model": name, "cpu_step": {
            "batch": 2, "loss_card": float(card.reshape(-1)[0]),
            "loss_cpu": float(cpu.reshape(-1)[0]), "loss_abs_err": loss_err,
            "ops_replayed_worst_rel_to_max": worst,
            "op_tol": IMAGE_OP_TOL}, "tol": TRAIN_TOL})
        check(loss_err <= TRAIN_TOL["loss_rtol"] * abs(float(
            cpu.reshape(-1)[0])), "%s card vs CPU loss error %g"
            % (name, loss_err))
        del cpu_env, step_scope
        release_memory()
    return paths


# -- the dense op families (ROADMAP Queue 1, step 5c) --------------------


@contextlib.contextmanager
def lowered_by(op_type, fn):
    """Op ``op_type`` lowered by ``fn`` in the block (a witness beside the
    port's lowering), the port's lowering restored after."""
    from paddle_tpu_torch.core.registry import OpRegistry

    info = OpRegistry.get(op_type)
    port, info.lower = info.lower, fn
    try:
        yield
    finally:
        info.lower = port


def _conv2d_transpose_cudnn(ctx, ins, attrs):
    """cuDNN's float32 transposed convolution (``F.conv_transpose2d``):
    the witness run beside the port's lowering, which sums in float64."""
    import torch.nn.functional as F

    return {"Output": [F.conv_transpose2d(
        ins["Input"][0], ins["Filter"][0],
        stride=tuple(attrs.get("strides", [1, 1])),
        padding=tuple(attrs.get("paddings", [0, 0])),
        dilation=tuple(attrs.get("dilations", [1, 1])),
        groups=attrs.get("groups", 1))]}


# lowerings run on the card beside the port's in dense_ops, printed and
# held to no limit
DENSE_WITNESS = {"conv2d_transpose": _conv2d_transpose_cudnn}


def dense_cases():
    """(name, op type, a function of a RandomState giving the inputs as
    numpy arrays, attrs) of the dense_ops phase: every lowering of the
    dense op families at the shapes its users give it."""
    def f(*shape):
        return lambda rng: rng.randn(*shape).astype(np.float32)

    def ins(**makers):
        return lambda rng: {slot: [m(rng) for m in ms]
                            for slot, ms in makers.items()}

    def ints(low, high, *shape):
        return lambda rng: rng.randint(low, high, shape).astype(np.int64)

    def probs(*shape):
        def make(rng):
            p = np.abs(rng.randn(*shape)) + 0.05
            return (p / p.sum(-1, keepdims=True)).astype(np.float32)
        return make

    def binary(*shape):
        return lambda rng: rng.randint(0, 2, shape).astype(np.float32)

    def table_ids(unique):
        # DeepFM's batch of 2048 x 39 ids into a 1M-row table
        n = CTR["batch_size"] * CTR["num_fields"]
        if unique:
            return lambda rng: rng.permutation(CTR["num_features"])[:n]
        return ints(0, CTR["num_features"], n)

    def tags(rng):
        # IOB tags of 8 chunk types over [64, 256], 17 = outside
        return rng.randint(0, 17, (64, 256)).astype(np.int64)

    def mod_operands(rng):
        x = rng.randint(-1000, 1000, (1024, 1024)).astype(np.int64)
        y = rng.randint(1, 50, (1024, 1024)) * rng.choice([-1, 1],
                                                         (1024, 1024))
        return {"X": [x], "Y": [y.astype(np.int64)]}

    def float_mod_operands(rng):
        y = (rng.rand(1024, 1024) * 4 + 0.25) * rng.choice([-1, 1],
                                                           (1024, 1024))
        return {"X": [(rng.randn(1024, 1024) * 10).astype(np.float32)],
                "Y": [y.astype(np.float32)]}

    bert = (1024, 768)  # BERT-base tokens
    vocab = (1024, 30522)  # BERT's vocab logits
    img = (32, 256, 28, 28)
    interp = [("bilinear_" + ("align_corners" if ac else "mode%d" % am),
               "bilinear_interp", ins(X=[f(*img)]),
               {"out_h": 56, "out_w": 56, "align_corners": ac,
                "align_mode": am})
              for ac, am in ((True, 1), (False, 1), (False, 0))]
    interp += [("nearest_" + ("align_corners" if ac else "floor"),
                "nearest_interp",
                ins(X=[f(*img)]), {"out_h": 56, "out_w": 56,
                                   "align_corners": ac})
               for ac in (True, False)]
    cases = [
        ("fill_zeros_like", "fill_zeros_like", ins(X=[f(*bert)]), {}),
        ("reshape", "reshape", ins(X=[f(8, 128, 768)]),
         {"shape": [0, 0, 12, 64]}),
        ("transpose", "transpose", ins(X=[f(8, 128, 12, 64)]),
         {"axis": [0, 2, 1, 3]}),
        ("squeeze2", "squeeze2", ins(X=[f(32, 2048, 1, 1)]),
         {"axes": [2, 3]}),
        ("stack", "stack", ins(X=[f(8, 128, 768)] * 12), {"axis": 0}),
        ("unstack", "unstack", ins(X=[f(12, 8, 128, 768)]), {"axis": 0}),
        ("gather", "gather", ins(X=[f(CTR["num_features"], 16)],
                                 Index=[table_ids(False)]), {}),
        ("scatter", "scatter",
         ins(X=[f(CTR["num_features"], 16)], Ids=[table_ids(True)],
             Updates=[f(CTR["batch_size"] * CTR["num_fields"], 16)]),
         {"overwrite": True}),
        ("scatter_add", "scatter",
         ins(X=[f(CTR["num_features"], 16)], Ids=[table_ids(False)],
             Updates=[f(CTR["batch_size"] * CTR["num_fields"], 16)]),
         {"overwrite": False}),
        ("shape", "shape", ins(Input=[f(32, 3, 224, 224)]), {}),
        ("arg_max", "arg_max", ins(X=[f(*vocab)]), {"axis": -1}),
        ("arg_min", "arg_min", ins(X=[f(*vocab)]), {"axis": -1}),
        ("argsort", "argsort", ins(X=[f(*vocab)]), {"axis": -1}),
        ("range", "range",
         ins(Start=[lambda rng: np.array([0.0], np.float32)],
             End=[lambda rng: np.array([512.0], np.float32)],
             Step=[lambda rng: np.array([0.125], np.float32)]), {}),
        ("pad", "pad", ins(X=[f(8, 120, 768)]),
         {"paddings": [0, 0, 0, 8, 0, 0], "pad_value": 0.0}),
        ("pad2d_reflect", "pad2d", ins(X=[f(32, 3, 224, 224)]),
         {"paddings": [3, 3, 3, 3], "mode": "reflect"}),
        ("pad2d_edge", "pad2d", ins(X=[f(32, 3, 224, 224)]),
         {"paddings": [3, 3, 3, 3], "mode": "edge"}),
        ("isfinite", "isfinite", ins(X=[f(*bert), f(768, 3072)]), {}),
        ("cumsum", "cumsum", ins(X=[f(2048, 4096)]), {"axis": -1}),
        ("cumsum_exclusive", "cumsum", ins(X=[f(2048, 4096)]),
         {"axis": -1, "exclusive": True}),
        ("cumsum_reverse", "cumsum", ins(X=[f(2048, 4096)]),
         {"axis": -1, "reverse": True}),
        ("reverse", "reverse", ins(X=[f(32, 256, 768)]), {"axis": [1]}),
        ("conv2d_transpose", "conv2d_transpose",
         ins(Input=[f(32, 512, 28, 28)],
             Filter=[lambda rng: (rng.randn(512, 256, 4, 4) * 0.02).astype(
                 np.float32)]),
         {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
          "groups": 1}),
        ("conv2d_transpose_grouped", "conv2d_transpose",
         ins(Input=[f(32, 512, 28, 28)],
             Filter=[lambda rng: (rng.randn(512, 8, 4, 4) * 0.05).astype(
                 np.float32)]),
         {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
          "groups": 32}),
        ("lrn", "lrn", ins(X=[f(32, 96, 55, 55)]),
         {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75}),
        ("l2_normalize", "l2_normalize", ins(X=[f(*bert)]),
         {"axis": -1, "epsilon": 1e-12}),
        ("norm", "norm", ins(X=[f(*bert)]), {"axis": 1, "epsilon": 1e-10}),
        ("group_norm", "group_norm",
         ins(X=[f(32, 256, 56, 56)], Scale=[f(256)], Bias=[f(256)]),
         {"groups": 32, "epsilon": 1e-5}),
    ] + interp + [
        ("prelu_" + mode, "prelu",
         ins(X=[f(32, 64, 112, 112)], Alpha=[f(*shape)]), {"mode": mode})
        for mode, shape in (("all", (1,)), ("channel", (1, 64, 1, 1)),
                            ("element", (1, 64, 112, 112)))
    ] + [
        ("maxout", "maxout", ins(X=[f(32, 256, 14, 14)]), {"groups": 2}),
        ("squared_l2_distance", "squared_l2_distance",
         ins(X=[f(2048, 128)], Y=[f(2048, 128)]), {}),
        ("log_loss", "log_loss",
         ins(Predicted=[lambda rng: rng.rand(2048, 1).astype(np.float32)],
             Labels=[binary(2048, 1)]), {"epsilon": 1e-4}),
        ("huber_loss", "huber_loss", ins(X=[f(2048, 1)], Y=[f(2048, 1)]),
         {"delta": 1.0}),
        ("smooth_l1_loss", "smooth_l1_loss",
         ins(X=[f(2048, 4)], Y=[f(2048, 4)]), {"sigma": 3.0}),
        ("kldiv_loss", "kldiv_loss",
         ins(X=[lambda rng: np.log(probs(*vocab)(rng))],
             Target=[probs(*vocab)]), {"reduction": "batchmean"}),
        ("hinge_loss", "hinge_loss",
         ins(Logits=[f(2048, 1)], Labels=[binary(2048, 1)]), {}),
        ("elementwise_mod", "elementwise_mod", mod_operands, {"axis": -1}),
        ("elementwise_mod_float", "elementwise_mod", float_mod_operands,
         {"axis": -1}),
        ("elementwise_floordiv", "elementwise_floordiv", mod_operands,
         {"axis": -1}),
        ("elementwise_floordiv_float", "elementwise_floordiv",
         float_mod_operands, {"axis": -1}),
        ("auc", "auc",
         ins(Predict=[probs(2048, 2)], Label=[ints(0, 2, 2048, 1)],
             StatPos=[ints(0, 100, 4096)], StatNeg=[ints(0, 100, 4096)]),
         {"curve": "ROC", "num_thresholds": 4095}),
        ("precision_recall", "precision_recall",
         ins(Indices=[ints(0, 10, 2048, 1)], Labels=[ints(0, 10, 2048, 1)],
             StatesInfo=[lambda rng: rng.randint(0, 500, (10, 4)).astype(
                 np.float32)]), {"class_number": 10}),
        ("chunk_eval", "chunk_eval",
         ins(Inference=[tags], Label=[tags],
             SeqLength=[ints(1, 257, 64)]),
         {"chunk_scheme": "IOB", "num_chunk_types": 8}),
    ]
    return cases


def lower_op(op_type, ins, attrs, device):
    """One run of the port's lowering of ``op_type`` on ``ins`` (torch
    tensors on ``device``)."""
    from paddle_tpu_torch.core.desc import OpDesc
    from paddle_tpu_torch.core.registry import LowerContext, OpRegistry

    names = {s: ["x"] * len(v) for s, v in ins.items()}
    ctx = LowerContext(OpDesc(op_type, names, {}, attrs), None, device,
                       rng_seed=(0, 1))
    return OpRegistry.get(op_type).lower(ctx, ins, attrs)


def grad_primals(op_type, ins):
    """(slot, index) of each input the op's grad flows to: floats outside
    its ``no_grad_inputs``; none for an op without a grad."""
    from paddle_tpu_torch.core.registry import OpRegistry

    info = OpRegistry.get(op_type)
    if info.grad_maker is None:
        return []
    return [(s, i) for s in sorted(ins) if s not in info.no_grad_inputs
            for i, v in enumerate(ins[s]) if v.is_floating_point()]


def op_vjp(op_type, ins, attrs, device, cots):
    """The grads the engine derives for the op (``torch.func.vjp`` of its
    lowering) on the cotangents ``cots`` of its float outputs, in
    ``grad_primals`` order."""
    import torch

    primals = grad_primals(op_type, ins)

    def fwd(*xs):
        run_ins = {s: list(v) for s, v in ins.items()}
        for (s, i), x in zip(primals, xs):
            run_ins[s][i] = x
        out = lower_op(op_type, run_ins, attrs, device)
        return tuple(v for s in sorted(out) for v in out[s]
                     if v.is_floating_point())

    _, vjp = torch.func.vjp(fwd, *[ins[s][i] for s, i in primals])
    return vjp(tuple(cots))


def dense_errors(cpu, primals, out, grads):
    """Card outputs ``out`` and grads ``grads`` against the CPU run
    ``cpu`` ({"out", "grads"}): {output or grad: [max |card - cpu|, max
    |cpu|]} of the float ones, and those off DENSE_TOL or, for integer
    and bool ones, not equal."""
    import torch

    pairs = [("out." + s, a, b) for s in sorted(cpu["out"])
             for a, b in zip(out[s], cpu["out"][s])]
    pairs += [("grad.%s%d" % p, a, b) for p, a, b in zip(
        primals, grads, cpu.get("grads", []))]
    errs, off = {}, []
    for key, a, b in pairs:
        if not b.is_floating_point():
            if not torch.equal(a, b):
                off.append([key, "integer or bool outputs differ"])
            continue
        scale = float(b.abs().max()) if b.numel() else 0.0
        err = float((a - b).abs().max()) if b.numel() else 0.0
        errs[key] = [err, scale]
        if err > DENSE_TOL["rel_to_max"] * scale:
            off.append([key, err, scale])
    return errs, off


def phase_dense_ops(fa, smi):
    """Every lowering of the dense op families (``dense_cases``) on the
    card against the same lowering on the CPU from the same operands,
    forward and, for an op with a grad, the vjp grads on seeded
    cotangents (DENSE_TOL); the DENSE_TWICE ops run twice on the card,
    bitwise equal; device ms of the forward and of the vjp. Returns the
    flash launches of the phase (none)."""
    import torch

    import paddle_tpu_torch.fluid as fluid

    fluid.Executor(fluid.CUDAPlace(0))  # cuDNN's deterministic algorithms
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    rows, failed = [], []
    for k, (name, op_type, make, attrs) in enumerate(dense_cases()):
        host = make(np.random.RandomState(500 + k))
        runs = {}
        for device in ("cuda", "cpu"):
            ins = {s: [torch.as_tensor(a, device=device) for a in v]
                   for s, v in host.items()}
            out = lower_op(op_type, ins, attrs, device)
            runs[device] = {"ins": ins, "out": {s: [v.cpu() for v in vs]
                                                for s, vs in out.items()}}
        card_ins = runs["cuda"]["ins"]
        floats = [v for s in sorted(runs["cpu"]["out"])
                  for v in runs["cpu"]["out"][s] if v.is_floating_point()]
        crng = np.random.RandomState(900 + k)
        cots = [torch.as_tensor(np.asarray(crng.randn(*v.shape),
                                           np.float32)) for v in floats]
        card_cots = [c.cuda() for c in cots]
        primals = grad_primals(op_type, runs["cpu"]["ins"])
        if primals:
            for device, dev_cots in (("cuda", card_cots), ("cpu", cots)):
                runs[device]["grads"] = [g.cpu() for g in op_vjp(
                    op_type, runs[device]["ins"], attrs, device, dev_cots)]
        errs, off = dense_errors(runs["cpu"], primals, runs["cuda"]["out"],
                                 runs["cuda"].get("grads", []))
        failed += [[name] + o for o in off]
        exact = not any(isinstance(o[1], str) for o in off)
        row = {"case": name, "op": op_type,
               "shapes": {s: [list(a.shape) for a in v]
                          for s, v in host.items()},
               "max_abs_err_and_max": errs, "exact_ints": exact}
        if op_type in DENSE_TWICE:
            again = lower_op(op_type, card_ins, attrs, "cuda")
            same = all(torch.equal(a.cpu(), b) for s in again
                       for a, b in zip(again[s], runs["cuda"]["out"][s]))
            if primals:
                grads = op_vjp(op_type, card_ins, attrs, "cuda", card_cots)
                same = same and all(torch.equal(a.cpu(), b) for a, b in
                                    zip(grads, runs["cuda"]["grads"]))
            row["twice_bitwise_equal"] = same
            if not same:
                failed.append([name, "run twice on the card differs"])
        row["ms"] = device_ms(lambda: lower_op(op_type, card_ins, attrs,
                                               "cuda"), n=5, warmup=1)
        if primals:
            row["vjp_ms"] = device_ms(lambda: op_vjp(
                op_type, card_ins, attrs, "cuda", card_cots), n=5, warmup=1)
        if op_type in DENSE_WITNESS:
            with lowered_by(op_type, DENSE_WITNESS[op_type]):
                out = lower_op(op_type, card_ins, attrs, "cuda")
                grads = op_vjp(op_type, card_ins, attrs, "cuda", card_cots)
                row["witness"] = {
                    "max_abs_err_and_max": dense_errors(
                        runs["cpu"], primals,
                        {s: [v.cpu() for v in vs] for s, vs in out.items()},
                        [g.cpu() for g in grads])[0],
                    "ms": device_ms(lambda: lower_op(
                        op_type, card_ins, attrs, "cuda"), n=5, warmup=1),
                    "vjp_ms": device_ms(lambda: op_vjp(
                        op_type, card_ins, attrs, "cuda", card_cots), n=5,
                        warmup=1)}
        rows.append(row)
        del runs, card_ins, host
        release_memory()
    launches = flash_launches(fa)  # ... and ends here
    emit({"phase": "dense_ops", "card": smi, "tol": DENSE_TOL,
          "ops": sorted({r["op"] for r in rows}), "cases": rows,
          "flash_launches": launches})
    check(not failed, "dense_ops: %s" % failed[:10])
    check(not any(launches.values()), "flash launches in dense_ops: %s"
          % launches)
    return launches


def upsample_head(fluid, channels, hw, widths, groups, classes, out_hw, lr):
    """The FCN-style decoder of UPSAMPLE, built from ``fluid.layers`` of
    ``fluid`` (either package's: the parity tests build it with both)
    under the caller's ``program_guard``: feeds ``feat`` [B, channels, hw,
    hw] and ``label`` [B * out_hw * out_hw, 1]; returns the loss."""
    feat = fluid.layers.data(name="feat", shape=[channels, hw, hw],
                             dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    x = feat
    for width in widths:
        x = fluid.layers.conv2d_transpose(x, num_filters=width,
                                          filter_size=4, stride=2, padding=1,
                                          bias_attr=False)
        x = fluid.layers.group_norm(x, groups=groups)
        x = fluid.layers.prelu(x, mode="channel")
    logits = fluid.layers.conv2d(x, num_filters=classes, filter_size=1)
    logits = fluid.layers.resize_bilinear(logits, out_shape=[out_hw, out_hw])
    rows = fluid.layers.reshape(
        fluid.layers.transpose(logits, perm=[0, 2, 3, 1]),
        shape=[-1, classes])
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(rows, label))
    fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    return loss


def upsample_feed(batch, channels, hw, classes, out_hw, seed, **_):
    rng = np.random.RandomState(seed)
    return {"feat": rng.randn(batch, channels, hw, hw).astype(np.float32),
            "label": rng.randint(0, classes, (batch * out_hw * out_hw, 1))
            .astype(np.int64)}


def phase_upsample_head(fa, smi):
    """The FCN decoder (UPSAMPLE) at batch 8: UPSAMPLE_STEPS steps eagerly
    and captured from the same state, the losses and every state tensor
    bitwise equal; one graph, captured once; no flash launch; one step
    against the CPU from the same state (UPSAMPLE_TOL: the loss, every
    parameter grad); the captured step's ms, idle share and top kernels.
    Returns the flash launches of the path (none)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import unique_name

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        loss = upsample_head(fluid, **UPSAMPLE)
    main.random_seed = startup.random_seed = 2024
    feed = upsample_feed(UPSAMPLE_BATCH, seed=81, **UPSAMPLE)
    (eager, graph, losses, unequal, eager_runs, launches,
     walls) = lockstep_steps(fa, main, startup, loss, feed, UPSAMPLE_STEPS)
    entries = captured(graph[0].engine)
    emit({"phase": "upsample_head", "card": smi, "config": UPSAMPLE,
          "batch": UPSAMPLE_BATCH, "ops": [op.type for op in
                                           main.desc.global_block().ops],
          "losses": losses, "unequal_state": unequal[:10],
          "launches": launches, "graphs": len(entries),
          "captures": [c.captures for c in entries],
          "eager_runs": eager_runs})
    check(all(np.isfinite(losses["captured"])), "upsample_head losses %s"
          % losses)
    check(losses["captured"] == losses["eager"] and not unequal,
          "upsample_head: captured and eager steps differ: losses %s, "
          "state %s" % (losses, unequal[:5]))
    check(len(entries) == 1 and entries[0].captures == 1
          and eager_runs == 0, "upsample_head: graphs %s, %d eager runs"
          % ([c.captures for c in entries], eager_runs))
    check(not any(launches.values()), "flash launches in upsample_head: %s"
          % launches)
    cap = profiled_step(graph[0], graph[1], main, loss, feed)
    emit(dict({"phase": "times", "card": smi,
               "profile": "upsample_head training step", "run": "captured",
               "batch": UPSAMPLE_BATCH, "images_per_s": UPSAMPLE_BATCH / (
                   cap["median_ms"] / 1e3), "tf32": False}, **cap))
    del eager, graph, entries
    release_memory()

    # one step on the card and on the CPU from the same state
    state0 = start_state(main, startup)
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    results = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        exe, scope = state_executor(main, state0, place=place)
        with fluid.scope_guard(scope):
            results.append(exe.run(main, feed=feed,
                                   fetch_list=[loss.name] + grads))
        del exe, scope
    card, cpu = results
    loss_err = abs(float(card[0].reshape(-1)[0] - cpu[0].reshape(-1)[0]))
    grad_errs = {n: [float(np.abs(a - b).max()), float(np.abs(b).max())]
                 for n, a, b in zip(grads, card[1:], cpu[1:])}
    emit({"phase": "upsample_head", "cpu_step": {
        "batch": UPSAMPLE_BATCH, "loss_card": float(card[0].reshape(-1)[0]),
        "loss_cpu": float(cpu[0].reshape(-1)[0]), "loss_abs_err": loss_err,
        "grads_max_abs_err_and_max": grad_errs}, "tol": UPSAMPLE_TOL})
    check(loss_err <= UPSAMPLE_TOL["loss_rtol"]
          * abs(float(cpu[0].reshape(-1)[0])),
          "upsample_head: card vs CPU loss error %g" % loss_err)
    bad = {n: e for n, e in grad_errs.items()
           if e[0] > UPSAMPLE_TOL["grad_rel_to_max"] * e[1]}
    check(not bad, "upsample_head: card vs CPU grads %s" % bad)
    # the same step with cuDNN's float32 transposed convolution in the
    # port's place (printed, held to no limit)
    with lowered_by("conv2d_transpose", _conv2d_transpose_cudnn):
        exe, scope = state_executor(main, state0)
        with fluid.scope_guard(scope):
            witness = exe.run(main, feed=feed,
                              fetch_list=[loss.name] + grads)
        del exe, scope
    emit({"phase": "upsample_head", "cpu_step_witness_cudnn": {
        n: [float(np.abs(a - b).max()), float(np.abs(b).max())]
        for n, a, b in zip(grads, witness[1:], cpu[1:])}})
    del results, card, cpu, state0, witness
    release_memory()
    return launches


def with_auc(fluid, main, startup, pred, label):
    """The streaming ``auc`` layer of ``fluid`` (either package's) appended
    to a CTR program on ``concat([1 - pred, pred])``: returns (AUC, the
    two-column predictions, [stat_pos, stat_neg])."""
    with fluid.program_guard(main, startup):
        probs = fluid.layers.concat(
            [fluid.layers.scale(pred, scale=-1.0, bias=1.0), pred], axis=1)
        value, stats = fluid.layers.auc(probs, label)
    return value, probs, stats


def phase_ctr_auc(fa, smi):
    """The ctr phase's DeepFM with ``layers.auc`` on its predictions:
    CTR_AUC_STEPS steps captured and eagerly from the same state, the
    histograms bitwise equal step by step and equal to ``metrics.Auc``
    fed the fetched predictions on the host, the AUC within CTR_AUC_TOL of
    the ``auc`` lowering run on the CPU over the same predictions; the
    step one graph, captured once; no flash launch; the step's ms against
    the same program without the auc op. Returns the flash launches of
    the path (none)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import metrics, unique_name
    from paddle_tpu_torch.models import deepfm

    with unique_name.guard():
        main, startup, h = deepfm.get_model(**CTR)
        value, probs, stats = with_auc(fluid, main, startup, h["pred"],
                                       h["label"])
    main.random_seed = startup.random_seed = 2024
    stat_names = [v.name for v in stats]
    feeds = ctr_feeds(CTR["batch_size"], CTR_AUC_STEPS, 63)
    fetch = [h["loss"], value, probs]
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    graph, graph_scope = fresh(startup)
    eager, eager_scope = fresh(startup, graphs=False)
    host = metrics.Auc(num_thresholds=4095)
    aucs = {"captured": [], "eager": []}
    fetched, unequal = [], []
    for step, feed in enumerate(feeds):
        with fluid.scope_guard(graph_scope):
            _, auc_v, p = graph.run(main, feed=feed, fetch_list=fetch)
        aucs["captured"].append(float(auc_v))
        host.update(p, feed["label"])
        fetched.append(p)
        with fluid.scope_guard(eager_scope):
            _, auc_v, _ = eager.run(main, feed=feed, fetch_list=fetch)
        aucs["eager"].append(float(auc_v))
        for n in stat_names:
            if not torch.equal(graph_scope.get(n), eager_scope.get(n)):
                unequal.append([step + 1, n])
    launches = flash_launches(fa)  # ... and ends here
    entries = captured(graph.engine)
    card_stats = [graph_scope.get(n).cpu().numpy() for n in stat_names]
    host_equal = (np.array_equal(card_stats[0], host._stat_pos)
                  and np.array_equal(card_stats[1], host._stat_neg))
    # the auc lowering on the CPU over the same predictions, step by step
    cpu_stats = [torch.zeros(4096, dtype=torch.int64) for _ in range(2)]
    cpu_aucs = []
    for p, feed in zip(fetched, feeds):
        out = lower_op("auc", {
            "Predict": [torch.as_tensor(p)],
            "Label": [torch.as_tensor(feed["label"])],
            "StatPos": [cpu_stats[0]], "StatNeg": [cpu_stats[1]]},
            {"curve": "ROC", "num_thresholds": 4095}, "cpu")
        cpu_stats = [out["StatPosOut"][0], out["StatNegOut"][0]]
        cpu_aucs.append(float(out["AUC"][0]))
    auc_err = max(abs(a - b) for a, b in zip(aucs["captured"], cpu_aucs))
    row = {"phase": "ctr_auc", "card": smi, "config": CTR,
           "steps": CTR_AUC_STEPS, "auc": aucs, "auc_cpu": cpu_aucs,
           "auc_host_metric": host.eval(), "auc_max_abs_err_vs_cpu": auc_err,
           "stats_equal_host_metric": host_equal,
           "stats_equal_cpu": all(np.array_equal(a, b.numpy()) for a, b in
                                  zip(card_stats, cpu_stats)),
           "unequal_stats": unequal[:10],
           "positives_negatives": [int(card_stats[0].sum()),
                                   int(card_stats[1].sum())],
           "graphs": [(c.captures, c.replays) for c in entries],
           "flash_launches": launches}
    emit(row)
    check(aucs["captured"] == aucs["eager"] and not unequal,
          "ctr_auc: captured and eager differ: %s, %s" % (aucs, unequal[:5]))
    check(host_equal and row["stats_equal_cpu"],
          "ctr_auc: the card's stats differ from metrics.Auc's or the CPU's")
    check(auc_err <= CTR_AUC_TOL, "ctr_auc: AUC off the CPU's by %g"
          % auc_err)
    check(len(entries) == 1 and entries[0].captures == 1,
          "ctr_auc: graphs %s" % row["graphs"])
    check(not any(launches.values()), "flash launches in ctr_auc: %s"
          % launches)
    del eager, eager_scope
    release_memory()

    # the step's ms with the auc op and without it (the ctr phase's
    # program), captured, one batch repeated
    plain, plain_startup, plain_h = deepfm_program()
    times = {}
    for label, (prog, exe, scope, loss) in (
            ("with_auc", (main, graph, graph_scope, h["loss"])),
            ("ctr", (plain,) + fresh(plain_startup) + (plain_h["loss"],))):
        t = time_train_step(exe, scope, prog, loss, feeds[0])
        times[label] = {k: t[k] for k in (
            "median_ms", "min_ms", "max_ms", "device_busy_ms",
            "device_idle_share", "top_kernels_ms")}
        del exe, scope
    emit({"phase": "ctr_auc", "card": smi, "times": times,
          "batch": CTR["batch_size"]})
    del graph, graph_scope
    release_memory()
    return launches


def release_memory():
    """Free what no live object holds, CUDA graphs and their pools too,
    and return the cached blocks to the card."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "paddle_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repo "
              "(paddle_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count(),
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})

    from paddle_tpu_torch.kernels import build
    import paddle_tpu_torch.kernels.flash_attention as fa

    t0 = time.perf_counter()
    built = build.build_all()
    ptxas = {}
    for name in build.SOURCES:
        ptxas.update(ptxas_summary(build.build_log(name)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built, "ptxas": ptxas})
    spilled = [k for k, v in ptxas.items()
               if v["spill_stores"] or v["spill_loads"]]
    check(ptxas and not spilled, "ptxas spills in %s" % spilled)

    # KERNEL_CASES, then the kernels at the Transformer's shapes
    nmt_cases = nmt_kernel_cases()
    worst = phase_kernel(fa, nmt_cases)
    worst_bwd = phase_kernel_bwd(fa, nmt_cases)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bert_") as model_dir:
        predictor, serve_launches, feed8 = phase_serve(fa, model_dir)
        batched_launches = phase_serve_batched(fa, predictor, smi)
        main_row, main_bf16_row = phase_times(fa, predictor, feed8)
    del predictor
    main_prog, startup, loss = bert_train_program(amp=False)
    state0 = start_state(main_prog, startup)
    train_feed8 = train_feed(8, np.random.RandomState(11))
    phase_determinism(main_prog, startup, loss, train_feed8)
    eager, graph, launches, f32_losses = phase_train(
        fa, main_prog, startup, loss, state0, train_feed8)
    amp_exe, amp_scope, amp_prog, amp_loss, amp_launches = phase_train_amp(
        fa, train_feed8, f32_losses)
    bwd_row, bwd_bf16_row = phase_times_train(fa, {
        "eager": eager + (main_prog, loss),
        "captured": graph + (main_prog, loss),
        "captured_amp": (amp_exe, amp_scope, amp_prog, amp_loss)},
        main_prog, loss, train_feed8)
    # BERT's executors, graphs and their memory go before ResNet-50's (an
    # engine and its cache entries refer to each other: a collection frees
    # them)
    del eager, graph, amp_exe, amp_scope
    release_memory()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_resnet_") as d:
        r_serve_launches = phase_resnet50_serve(fa, d, smi)
    release_memory()
    r_main, r_startup, r_handles = resnet_program(is_train=True)
    r_loss = r_handles["loss"]
    r_feed = resnet_feed(RESNET_BATCH, np.random.RandomState(41))
    phase_resnet50_determinism(r_main, r_startup, r_loss, r_feed)
    r_eager, r_graph, r_losses, r_launches = phase_resnet50_train(
        fa, r_main, r_startup, r_loss, r_handles, r_feed, smi)
    r_amp = phase_resnet50_train_amp(fa, r_feed, r_losses, smi)
    r_amp_launches = r_amp[4]
    phase_resnet50_times({"eager": r_eager + (r_main, r_loss),
                          "captured": r_graph + (r_main, r_loss),
                          "captured_amp": r_amp[:4]}, r_startup, r_feed,
                         smi)
    del r_eager, r_graph, r_amp
    release_memory()

    # the training loop's features
    phase_optimizers(smi)
    recipe_launches = phase_bert_recipe(fa, smi)
    r_pipe_launches = phase_resnet50_pipelined(fa, r_main, r_startup,
                                               r_loss, smi)
    phase_mfu(smi, torch.cuda.get_device_name(0))
    release_memory()

    # the two north-star models: DeepFM (sparse grads) and Transformer NMT
    ctr_launches = phase_ctr(fa, smi)
    phase_word2vec(smi)
    nmt_launches, t256 = phase_nmt(fa, smi, torch.cuda.get_device_name(0))
    release_memory()

    # recurrence and control flow; the image builders
    lstm_launches = phase_lstm(fa, smi)
    image_launches = phase_image_models(fa, smi)
    release_memory()

    # unfused attention fused back onto the kernels at opt_level 1 (from
    # BERT's initial state of the train phase); the book programs
    fuse_launches = phase_fuse_attention(fa, state0, train_feed8, smi)
    fuse_launches.update(phase_fuse_attention_serve(fa, smi))
    release_memory()
    fuse_launches.update(phase_nmt_unfused(fa, smi))
    fuse_launches.update(phase_book(fa, smi))
    release_memory()

    # the dense op families, an FCN decoder head and DeepFM with auc
    dense_launches = {"dense_ops": phase_dense_ops(fa, smi)}
    dense_launches["upsample_head"] = phase_upsample_head(fa, smi)
    dense_launches["ctr_auc"] = phase_ctr_auc(fa, smi)
    release_memory()
    emit({"phase": "times", "partial_profiler_windows_rerun":
          len(PARTIAL_PROFILES), "partial_windows": PARTIAL_PROFILES,
          "event_timed": EVENT_TIMED})
    other_paths = {"resnet50_serve": r_serve_launches,
                    "resnet50_train": r_launches,
                    "resnet50_train_amp": r_amp_launches,
                    "resnet50_pipelined": r_pipe_launches}
    other_paths.update(("bert_recipe_" + p, n)
                        for p, n in recipe_launches.items())
    other_paths["ctr"] = dict(zip(("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"), ctr_launches))
    other_paths.update(nmt_launches)
    other_paths["lstm"] = lstm_launches
    other_paths.update(image_launches)
    other_paths.update(fuse_launches)
    other_paths.update(dense_launches)

    def t256_rows(name):
        # the kernel at the Transformer's shapes (B=32 H=8 T=256 D=64)
        out = {}
        for case, r in t256.items():
            row = r["fwd"] if name == "flash_fwd" else dict(
                r["bwd"][name], plain_ms=r["bwd"]["plain_ms"],
                library_ms=r["bwd"]["library_ms"])
            out[case] = {k: row[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        return out

    # launches: the training path's (forward, dQ and dK/dV each 12 a
    # step, counted across replays); the forward's on the served paths and
    # the AMP path's are in launches_by_path. Each kernel's numbers are
    # the float32 main path's; the bf16 (AMP) main path's are in "bf16".
    def bf16(row, launched):
        return {"launches": launched, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    kernels = [{
        "name": "flash_fwd", "route": "cuda", "design": DESIGN,
        "seed": SEED,
        "source": "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:110",
        "launches": launches["flash_fwd"],
        "launches_by_path": dict({
            "serve": serve_launches, "serve_batched": batched_launches,
            "train": launches["flash_fwd"],
            "train_amp": amp_launches["flash_fwd"]},
            **{p: n["flash_fwd"] for p, n in other_paths.items()}),
        "max_abs_err": worst,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "bf16": bf16(main_bf16_row, amp_launches["flash_fwd"]),
        "nmt_t256": t256_rows("flash_fwd")}]
    for name, line in (("flash_bwd_dq", 269), ("flash_bwd_dkv", 328)):
        kernels.append({
            "name": name, "route": "cuda", "design": DESIGN, "seed": SEED,
            "source": "paddle_tpu_torch/kernels/csrc/%s.cu" % name,
            "replaces": "paddle_tpu/kernels/flash_attention.py:%d" % line,
            "launches": launches[name],
            "launches_by_path": dict({
                "train": launches[name], "train_amp": amp_launches[name]},
                **{p: n[name] for p, n in other_paths.items()}),
            "max_abs_err": worst_bwd[name],
            "ms": bwd_row[name]["ms"], "plain_ms": bwd_row["plain_ms"],
            "bound_ms": bwd_row[name]["bound_ms"],
            "bound_by": bwd_row[name]["bound_by"],
            "library_ms": bwd_row["library_ms"],
            "bf16": bf16(dict(bwd_bf16_row[name],
                              plain_ms=bwd_bf16_row["plain_ms"],
                              library_ms=bwd_bf16_row["library_ms"]),
                         amp_launches[name]),
            "nmt_t256": t256_rows(name)})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
