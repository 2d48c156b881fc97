#!/usr/bin/env python3
"""On-card smoke test of ``paddle_tpu_torch``, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It drives the port's main paths, serving and training BERT-base (and
checkpointing it, rolling it back after a fault and serving its
reference-format export) and
ResNet-50 (with the training loop's accumulation, remat, dispatch
window, prefetching feeder, schedulers, clipping and optimizers),
ResNet-50 trained from a RecordIO file through a ``py_reader``,
training DeepFM with sparse embedding grads, word2vec and the
Transformer-base NMT model, the stacked-LSTM classifier with the
control-flow ops, VGG, MobileNet and SE-ResNeXt, BERT-base and the
Transformer built with unfused attention and fused back onto the
kernels at ``opt_level`` 1, the book programs, the dense op families, an
FCN decoder head and DeepFM with its streaming AUC, the sequence ops, a
beam-search decoder, a text-convolution classifier and a CRF tagger, the
misc ops, skip-gram with NCE and hsigmoid heads and the C3D video model,
SSD-MobileNet-v1 and the detection and CTC ops, and its kernels on the
card and prints one JSON line per phase:

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
   at 1, 8 and 32 threads, each sending batch-1 requests (100 at each
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
11a. checkpoint — BERT-base trained at the same width (dropout 0,
   captured, state written in place, a dispatch window of 2) and
   checkpointed by ``io.save_checkpoint_async`` under a ``ckpt_write``
   fault: the write retried once and published, every restored var
   bitwise equal to a device copy of the saved step while training went
   on; a ``step_nan`` fault trips the deferred nan guard, and
   ``io.load_checkpoint`` restores the step in place (no recapture): the
   steps replayed give the uninterrupted run's losses bitwise. The step
   ms without saves; a loop with a save after each of its first two
   steps that trains on until both writes have published: each step's
   ms, each snapshot's ms on the step thread, each write's wall and GB,
   the hidden fraction, and the checkpoint root's filesystem; then the
   trained encoder exported in the
   native and the reference format (``compat.py``) and served from each:
   the answers bitwise equal.
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
   ``accumulate_steps=4`` over a batch of 32; (c) 4 steps at
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
20. reader_pipeline — ResNet-50 (batch 32, 224 x 224, Momentum, captured)
   trained from a RecordIO file of 8 batches (uint8 images, int64
   labels, seeded numpy) as a user feeds it: ``layers.open_files``
   through the native RecordIO reader, ``reader.map_readers`` normalising
   in numpy, ``layers.shuffle`` and ``layers.batch``; three loops from the
   same state over the same batches: a ``py_reader`` popped by
   ``Executor.run`` until ``EOFException``,
   ``DataFeeder.decorate_reader(prefetch=True)`` with ``dispatch_steps=2``,
   and the batches pre-staged as numpy feeds: losses bitwise equal; step
   ms, images/s, idle share, host decode ms a batch, the queue's pop wait
   a step, records/s read from the file, and the native library's path
   and whether this process built it (g++, from the checkout's sources).
21. mfu — the ``mfu.*`` gauges (goodput ledger on, ``peak_flops`` the
   card's: 67 TFLOP/s float32 on the FFMA path, TF32 being off, 989
   bf16) of the captured BERT-base (seq 128, batch 8) and ResNet-50
   (batch 32) steps, float32 and AMP; ResNet-50's counted FLOPs within
   MFU_TOL of the analytic 0.79 TFLOP a step.
22. ctr    — DeepFM as the JAX package's CTR bench builds it (39 fields
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
23. nmt    — Transformer-base as the JAX package's NMT bench builds it
   (6+6 layers, d_model 512, 8 heads, d_inner 2048, vocab 32768, seq
   256, batch 32, ragged lengths, dropout 0.1, label smoothing 0.1,
   Adam), float32 and under ``enable_bf16``: 3 captured steps, 18 launches
   of each flash kernel a step (6 encoder, 6 causal decoder and 6 cross
   attentions; the profiler's count of a replay agrees), one graph, the
   eager first run's peak allocation, step ms, target tokens/s, idle
   share and top kernels, the ``mfu.*`` gauges; AMP's first loss within
   TRAIN_AMP_TOL of float32's. One step at batch NMT_CPU_BATCH and
   dropout 0 against the CPU: the loss end to end (TRAIN_TOL), every op on the CPU's
   operands (RESNET_OP_TOL), and every grad end to end against the CPU
   step that takes the card's relu decisions (TRAIN_TOL; a relu input
   within rounding of 0 may decide otherwise on the CPU, and moves its
   token's grads by percents); the same step and the attention ops again
   with the plain torch attention in the kernels' place on the card, and
   both card runs' relu decisions unlike the CPU's printed. The kernels
   at B=32 H=8 T=256 D=64 with the batch's lengths, causal and not,
   float32 and bfloat16: ms, bound, plain and SDPA.
24. lstm   — the stacked-LSTM classifier (``models.lstm``: two
   ``StaticRNN`` LSTM layers, each one ``recurrent`` op looping over the
   time steps) at the width of the reference benchmark the JAX builder
   names (benchmark/fluid/models/stacked_dynamic_lstm.py: embedding and
   LSTM 512 wide, 5000 words), batch 32, seq 256 (cut from the
   benchmark's 1500-token crop), float32, Adam: 3 steps eagerly and
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
   reversed, with peepholes, ``origin_mode``: forward and grads of the
   first RNN_OP_CPU_ROWS sequences against the CPU (RNN_OP_TOL), the
   card's ms on all 32. A ``While`` loop writing a tensor array runs
   eagerly and counts in ``engine.eager_runs``; an ``IfElse`` and a
   ``Switch`` are captured and agree with the CPU; dropout inside a
   ``StaticRNN`` cell, captured against eager, bitwise equal, its masks
   differing between time steps.
25. image_models — VGG-16 (``models.vgg``, 3x32x32, 10 classes, Adam),
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
26. fuse_attention — BERT-base built unfused (``use_fused_attention=
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
27. verify — one unfused step with ``verify=True``: no ERROR finding;
   the findings of the desc that ran, by severity.
28. fuse_attention_serve — the unfused BERT-base saved for serving and
   answered by the predictor at the default level (12 forward launches a
   request) and with ``switch_ir_optim(False)`` (none), batch 1 and 8:
   the answers across levels, batches and the CPU within SERVE_TOL;
   replayed latencies.
29. nmt_unfused — Transformer-base at its ``nmt`` width built unfused,
   dropout 0: 12 rewrites (6 encoder self, 6 cross; the causal ones are
   fused as built), 18 launches of each kernel a step, 2 captured steps
   against the fused program's (FUSE_TOL's 1e-5), step ms.
30. book — the four book programs (``models.book``: fit_a_line,
   recognize_digits, word2vec, machine_translation) with Adam, 5 steps on
   the card (captured) against the CPU's on the same seeded batches
   (TRAIN_TOL), then saved, loaded and served against the training
   program's ``for_test`` clone.
31. dense_ops — every lowering of the dense op families (the tensor
   ops, the image ops of nn_ops, the regression losses, auc,
   precision_recall, chunk_eval, elementwise mod and floordiv) on the card
   against the same lowering on the CPU from the same seeded operands, at
   the shapes their users give them (``dense_cases``: group_norm(32) at
   ResNet-50's stage 2, the 28 -> 56 transposed convolution and resizes,
   AlexNet's lrn, BERT's tokens and vocab logits, DeepFM's 2048 x 39 ids
   into a 1M-row table, ...): forward and the vjp grads within DENSE_TOL,
   integer and bool outputs exact; gather, scatter, the resizes and
   maxout run twice, bitwise equal; device ms of each forward and vjp,
   all in one profiler window (``window_ms``).
   ``top_k`` at BERT's vocab logits, and with ties (rows of zeros,
   repeated maxima, float32 and bfloat16), its indices the CPU's
   exactly; its ms as ``torch.topk`` and as the port's stable sort.
32. upsample_head — an FCN decoder (UPSAMPLE) built from
   ``fluid.layers`` on ResNet-50's last stage at 224x224, batch 8:
   ``conv2d_transpose``, ``group_norm``, ``prelu``, a 1x1 conv to 21
   classes, ``resize_bilinear`` to 224x224, per-pixel softmax cross
   entropy, Momentum: 5 steps eagerly and captured, bitwise equal; one
   graph; no flash launch; one step against the CPU (UPSAMPLE_TOL); step
   ms, idle share and top kernels.
33. ctr_auc — the ctr phase's DeepFM with ``layers.auc`` on its
   predictions: 20 steps captured and eagerly, the int64 histograms
   bitwise equal step by step and equal to ``metrics.Auc`` fed the
   fetched predictions on the host, the AUC within CTR_AUC_TOL of the
   ``auc`` lowering on the CPU; one graph, captured once; the step's ms
   against the program without the auc op.
34. sequence_ops — every lowering of the sequence and beam-search slice
   (the 11 remaining sequence ops, beam_search, beam_search_decode, the
   CRF, gru_unit, lstm_unit, row_conv, sequence_reshape,
   sequence_scatter, tensor_array_to_tensor) on the card against the
   CPU at its users' shapes (``sequence_cases``), as ``dense_ops`` holds
   its ops; sequence_scatter twice, bitwise equal.
35. nmt_beam — the PaddlePaddle book's chapter-8 encoder-decoder
   (NMT_BEAM: dictionaries of 30,000, 512 wide, a bidirectional
   dynamic_gru encoder, a gru_unit decoder cell, no attention) decoded by
   ``contrib.BeamSearchDecoder`` through ``Executor.run`` on the
   ``for_test`` clone: 16 sources of 10-50 words, 3 beams, 250 steps.
   The decode twice, bitwise equal; one loop step built as a flat
   program (``nmt_beam_step``) replayed op by op on the card's own
   operands from the decode's lattice (DENSE_TOL; top_k and beam_search
   exact); beam_search_decode on the card's arrays equal to the CPU's and
   to the decode's; at batch 2 the steps equal to a CPU decode
   (printed); the decode's ms, ms and launches a step, target tokens/s,
   host ms a step and idle share.
36. sentiment_conv — chapter 6's convolution_net (SENTIMENT: two
   ``nets.sequence_conv_pool`` branches over 128-wide embeddings, hid
   512, Adagrad) at batch 128 over reviews of 32-400 words: 5 steps
   eagerly and captured, bitwise equal, one graph; a batch-2 step
   against the CPU (TRAIN_TOL); step ms, examples/s, idle share, an
   eager step's peak.
37. srl_crf — chapter 7's db_lstm (SRL: 8 stacked LSTMs of alternating
   direction, 59 labels) under ``linear_chain_crf`` at batch 10 over
   sentences of 8-64 words, SGD: 3 steps eagerly and captured, bitwise
   equal; a batch-2 step op by op against the CPU (RNN_OP_TOL); on the
   ``for_test`` clone crf_decoding's paths and chunk_eval's counts equal
   to the CPU's on the card's emissions; step ms, tokens/s, launches a
   step, idle share.
38. misc_ops — every lowering of the misc family (the 40 remaining
   misc_ops) on the card against the CPU at its users' shapes
   (``misc_cases``: the skip-gram heads at 692K words, C3D's
   convolutions and pools, a 3-D U-Net up-convolution beside cuDNN's
   float32 one, R-FCN's position-sensitive pooling, a spatial
   transformer, a CTC head, ...), as ``dense_ops`` holds its ops; the
   gathers whose grads add rows back, and the float64 up-convolution,
   twice, bitwise equal; the random ops by their contract, and a
   program of the four captured once, each replay equal to the eager
   run and drawing anew; a ``py_func``/``Print`` program trained on the
   card (its block eager) against the CPU.
39. skipgram_nce — skip-gram at word2vec's published widths (SKIPGRAM:
   692K words, 300 dims, 5 negatives, batch 4096, SGD) with the NCE and
   the hsigmoid head: 5 steps eagerly and captured, bitwise equal, one
   graph; step ms, pairs/s, idle share, eager peak; 3 steps at batch
   256 against the CPU (losses TRAIN_TOL, parameters OPT_TOL), the NCE
   negatives equal.
40. c3d — C3D (C3D: 8 conv3d, 5 pool3d, fc6/fc7 4096, 487 classes, 3 x
   16 x 112 x 112 clips) at batch 8, Momentum: 3 steps eagerly and
   captured, bitwise equal, one graph; the forward's counted FLOPs
   against the paper's; step ms, clips/s, idle share, eager peak, MFU
   on the model's operations (no data grad of conv1);
   a batch-2 step op by op against the CPU (IMAGE_OP_TOL); the
   ``for_test`` clone served at batch 1 and 8 against the CPU
   (SERVE_TOL), its latency.
41. ssd    — SSD-MobileNet-v1 (SSD: MobileNet-v1 at scale 1.0, four
   extra conv pairs, ``multi_box_head`` over six maps, 1917 priors, 21
   classes, 300 x 300 images) at batch 32, Momentum with L2 decay,
   ``ssd_loss`` per image summed: 3 steps eagerly and captured, bitwise
   equal, one graph; step ms, images/s, idle share, eager peak,
   launches; a batch-4 step against the CPU, the loss (TRAIN_TOL) and
   every op on the CPU's operands (IMAGE_OP_TOL), the grads end to end
   printed; the inference build (softmax, ``detection_output`` at nms
   0.45, top 400, keep 200, score 0.01) saved and served at batch 1 and
   8 against the CPU predictor: the head within SERVE_TOL, the
   detections' counts equal and rows within SERVE_TOL
   (``detections_match``), the card's NMS equal to the CPU's NMS of the
   card's head; ms a request; ``detection_map`` of the served
   detections on the card (its ``py_func`` block eager) equal to the
   CPU's.
42. detection_ops — every lowering of the detection and CTC families on
   the card against the CPU at its users' shapes (``detection_cases``:
   SSD's priors, matching and NMS; Faster R-CNN's RPN on a ResNet-50-C4
   map of an 800 x 1333 image, its samplers, RoI align and pool; Mask
   R-CNN's mask targets; YOLOv3 at 608; an EAST-style text detector; a
   line recogniser's CTC), as ``dense_ops`` holds its ops, each case's
   launches a call; the NMS, RoI, CTC and YOLO ops twice, bitwise equal;
   ``F.ctc_loss`` beside ``warpctc``; the greedy NMS scan alone at its
   two users' shapes, its ms, launches and share of the op.
43. opt_levels — BERT-base (float32, dropout 0, batch 8) captured
   OPT_STEPS steps at levels 1 and 2 from one state: each level's
   transform report from the metrics registry (rewrites by pass,
   crashes, the pipeline's ms), losses bitwise equal where no level-2
   pass fires (FUSE_TOL otherwise), 12 launches of each kernel a step;
   its encoder served at levels 1 and 2 (the add + gelu fuse fires 12
   times; FUSE_TOL); the seq-512 recipe at level 3 under a budget of
   OPT3_BUDGET_FRAC of its plain step's measured peak: the plan's
   segments, predicted against measured peak, the re-plan, no planner
   crash, the measured peak under the budget, losses within TRAIN_TOL of
   the plain step's, step ms.
44. layout_nhwc — ResNet-50 at batch 32 at NCHW and at layout=nhwc from
   one state: every NHWC conv, pool and batch-norm op of the first step
   (and its grad op) against its NCHW lowering on the same operands
   (IMAGE_OP_TOL), the first loss, later losses and served logits
   (LAYOUT_TOL), one graph each; the seams and weights baked; captured
   step and served ms in each layout, float32 and AMP bf16; cuDNN's
   layout-reorder kernels of one profiled NHWC step.
45. int8_serve — LeNet trained on the repo's MNIST reader, frozen,
   calibrated and quantized: INT8 top-1 within INT8_TOP1_POINTS of FP32;
   ResNet-50 served through ``enable_mkldnn`` at batch 1, 8 and 32 (the
   first INT8_SERVE_CALIB requests calibrate): request ms float32
   (frozen) and INT8, the quantized ops' share of the INT8 request's
   device time, INT8-vs-float32 top-1 agreement, every quantized op of
   one batch bitwise equal to its float64 emulation; the frozen model
   exported AOT and served through the predictor's AOT branch (AOT_TOL).
46. mesh — the mesh path (``parallel/``, the engine's mesh entries):
   BERT-base at full width and depth (batch 8, dropout 0.1) trained
   MESH_STEPS steps under the ``mesh`` flag ``dp=1`` on a one-rank NCCL
   group, captured: losses and every state var bitwise those of the same
   steps without a mesh, 12 launches of each kernel a step, both step
   times. Then two spawned ranks sharing the card: which collectives
   gloo takes on CUDA tensors, and each case whose collectives it takes
   — ``dp2`` (BERT-base width, MESH_DP2_LAYERS layers, batch 8 split
   4 + 4) and ``sp2`` (the Transformer's attention with
   ``sequence_parallel``, T=MESH_SP["seq_len"], split over two ranks'
   ring) — against the one-rank run at the same global batch (MESH_TOL);
   a collective that keeps a case off is named. With two or more cards
   the cases run on NCCL, one card a rank, captured. Last, the ring's
   step function at every rank's offsets in this process, sp = 2 and 4
   blocks of a T=MESH_RING_T attention, float32 and bfloat16, causal or
   not: forward and the three grads through the ring's backward against
   one full-sequence kernel call (TOL, TOL_BWD). The ``dp2`` ranks run
   under ``spmd_predict`` with ``verify=True``: the static SPMD plan's
   figures (``spmd_plan``, ``engine.spmd_plan_ms``), its
   ``spmd.prediction_delta`` against the collectives the first step
   issued, the parameter-gradient all-reduces equal to the plan's
   parameter-gradient psums var by var and byte by byte, and no ERROR
   from the verifier over the mesh (``mesh`` line ``dp2_spmd``).
47. pserver — the parameter-server path: DeepFM at the ``ctr`` width
   (CTR) with ``is_distributed`` tables, ``fluid.DistributeTranspiler``
   for PSERVER_SERVERS pservers and PSERVER_TRAINERS trainers on
   localhost, all threads of this process, every executor on the card;
   PSERVER_STEPS steps at a global batch of CTR["batch_size"] (half a
   trainer) from the state of one startup, against the same model
   trained in one process on the card: each trainer's loss against the
   single-process loss of its half of the batch, the mean against the
   full-batch loss, the final table shards against the single-process
   tables (PSERVER_TOL); the step split into engine, RPC and host copy
   ms, the bytes a trainer sends and receives a step, the servers'
   update ms.
48. kernels — one JSON object listing every ported kernel, with its
   design: all three run their products on the tensor cores (mma.sync
   bf16, 3xTF32 for float32) from a cp.async tile ring, and read their
   dropout seed from device memory; each kernel's launches on every path,
   the checkpoint, ResNet-50, training-loop, CTR, NMT, LSTM, image,
   unfused-attention, book, dense-op, sequence, misc, detection and
   opt-level paths included, and its
   times at the Transformer's shapes (``nmt_t256``).

49. opprof — run right after 11's training-step times: the captured
   BERT-base step's op table through ``fluid.profiler``
   (``phase_opprof``, OPPROF_TOL), the memory gauges, the pressure
   event, the heartbeat's peak and the host cost of the ``opprof`` flag.

The CPU sides of the optimizers, the LSTM's RNN-op comparison and the
four op phases (their inputs, CPU outputs and vjp grads) are made by a
thread (``CaseReferences``) from the start of the run, while the card's
earlier phases run; each phase then runs only its card side.

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
import functools
import gc
import json
import os
import queue
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
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
SERVE_REQUESTS = 100   # batch-1 requests at each client count
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
RECIPE_STEPS = 3      # eager warm-up, capture, one replay
WINDOW_STEPS = 4
RECIPE_TOL = {"lr_rtol": 1e-5}
PIPELINE_STEPS = 6    # resnet50_pipelined: steps of each loop
TIMED_RUNS = 3        # timed_runs/profiled_step: timed calls after warm-up
PROFILED_STEPS = 2    # time_train_step/profiled_step: steps a profile
DEVICE_MS_CALLS = 10  # device_ms: calls a profile (after 3 warm-up calls)
HOST_MS_STEPS = 2     # host_ms_by_kind: eager steps with run_op on a clock
CKPT_STEPS = 6        # checkpoint: the uninterrupted run's steps
CKPT_SAVE_AT = 3      # checkpoint: the step saved asynchronously
CKPT_TIMED_SAVES = 1  # checkpoint: timed steps in a row with a save after each
CKPT_PLAIN_STEPS = 10  # checkpoint: timed steps without saves, before
#                        and after the saving loop
CKPT_LOOP_CAP_S = 20.0  # checkpoint: the saving loop stops here, writes or not
OP_CASES_RELEASE_BYTES = 20 << 30  # phase_op_cases collects above this
# phase_op_cases: the cases whose card-vs-CPU comparison (outputs and vjp
# grads, the card twice) runs on the first rows of the named inputs, on
# both devices; the card is timed at the users' full shapes. Each op is
# independent across those rows (images, sequences, RoIs) and has no
# parameter whose grad sums over them (a conv's filter grad summed over
# 2 of 8 clips came out 1.1e-5 of max off the CPU's, past DENSE_TOL);
# these are the longest CPU references (the mesh phase took the room)
OP_CPU_ROWS = {
    "bilinear_align_corners": {"X": 8}, "bilinear_mode1": {"X": 8},
    "bilinear_mode0": {"X": 8}, "nearest_align_corners": {"X": 8},
    "nearest_floor": {"X": 8}, "reshape": {"X": 2}, "stack": {"X": 2},
    "lrn": {"X": 8}, "argsort": {"X": 128}, "top_k": {"X": 128},
    "top_k_ties": {"X": 128}, "top_k_ties_bf16": {"X": 128},
    "pool3d_c3d_pool1": {"X": 2}, "grid_sampler_stn": {"X": 2, "Grid": 2},
    "pad_constant_like_fcn": {"X": 8, "Y": 8},
    "roi_align_c4_14x14": {"ROIs": 32, "RoisBatchIdx": 32},
    "roi_pool_c4_14x14": {"ROIs": 32, "RoisBatchIdx": 32},
}
READER_BATCHES = 8    # reader_pipeline: batches in the RecordIO file
READER_SEED = 16      # reader_pipeline: the images', labels' and shuffle's
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
NMT_STEPS = 3
NMT_FEED_SEED = 71
NMT_CPU_BATCH = 1      # the CPU step is the phase's long pole
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
LSTM_STEPS = 3
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
# the recurrent ops' card-vs-CPU comparison runs on this many of the
# batch's sequences (the longest first), the card's time on all of them
RNN_OP_CPU_ROWS = 8
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
# sequence_ops: each lowering of the sequence and beam-search slice alone
# at its users' shapes (the three programs below), on the card against
# the CPU, at DENSE_TOL; sequence_scatter run twice, bitwise equal
SEQUENCE_TWICE = ("sequence_scatter",)
# nmt_beam: the PaddlePaddle book's chapter 8 (machine_translation)
# encoder-decoder at its widths, decoded by contrib's BeamSearchDecoder:
# a bidirectional dynamic_gru encoder, the boot fc(first step of the
# backward GRU, tanh), a gru_unit cell over the previous word's
# embedding (the chapter's attention is left out: it needs the encoder's
# states for every beam row); 16 sources of 10-50 words, 3 beams, 250
# steps (a tensor array holds 256 entries)
NMT_BEAM = dict(src_dict=30000, trg_dict=30000, word_dim=512, hidden=512,
                beam_size=3, max_length=250, start_id=0, end_id=1)
NMT_BEAM_BATCH, NMT_BEAM_SRC_LEN, NMT_BEAM_MIN_LEN = 16, 50, 10
NMT_BEAM_CPU_BATCH = 2
NMT_BEAM_PROBE_STEP = 7      # the loop step replayed op by op
# sentiment_conv: chapter 6's (understand_sentiment) convolution_net,
# two sequence_conv_pool branches over the IMDB dictionary's 5,147 words
# (synthetic ids), batch 128 reviews of 32-400 words, Adagrad
SENTIMENT = dict(dict_dim=5147, emb_dim=128, hid_dim=512, class_dim=2,
                 lr=0.002)
SENTIMENT_BATCH, SENTIMENT_LEN, SENTIMENT_MIN_LEN = 128, 400, 32
SENTIMENT_STEPS = 5
# srl_crf: chapter 7's (label_semantic_roles) db_lstm, 8 stacked LSTMs
# of alternating direction under a linear-chain CRF, batch 10 sentences
# of 8-64 words, SGD; crf_decoding and chunk_eval (IOB, 29 chunk types)
# on the for_test clone
SRL = dict(word_dict=44068, pred_dict=3162, mark_dict=2, label_dict=59,
           word_dim=32, mark_dim=5, hidden_dim=512, depth=8, lr=0.01)
SRL_BATCH, SRL_LEN, SRL_MIN_LEN = 10, 64, 8
SRL_STEPS = 3
# misc_ops: each lowering of the misc family alone at its users' shapes
# (misc_cases), on the card against the CPU at DENSE_TOL; the gathers
# whose grads add rows back, and the float64 transposed 3-D convolution,
# run twice, bitwise equal; beside the port's, cuDNN's float32 one and
# one F.conv_transpose3d on float64 operands
MISC_TWICE = ("nce", "hierarchical_sigmoid", "multiplex", "psroi_pool",
              "grid_sampler", "bpr_loss", "conv3d_transpose")
# ... and a program of the four random ops (random_ops) run RANDOM_RUNS
# times eagerly and captured: a random crop of [RANDOM_BATCH, 3, 240,
# 320] frames to 224 x 224, one id a row of 1000-way probabilities, and
# noise of the batch's size
RANDOM_OPS = dict(image=[3, 240, 320], crop=[224, 224], classes=1000,
                  width=64)
RANDOM_BATCH, RANDOM_RUNS = 32, 3
# skipgram_nce: skip-gram with negative sampling at the settings of
# Mikolov et al. 2013, "Distributed Representations of Words and Phrases
# and their Compositionality" (arXiv 1310.4546, sections 2.2 and 4):
# 300-dim vectors, k = 5 negatives, a 692K-word vocabulary, SGD at
# word2vec's starting rate 0.025; 4096 (centre, context) pairs a batch,
# ids drawn Zipf-like. Cuts: uniform noise for the unigram^(3/4) one, the
# complete binary tree for the Huffman one (the hsigmoid head)
SKIPGRAM = dict(vocab=692000, dim=300, neg=5, lr=0.025)
SKIPGRAM_BATCH, SKIPGRAM_STEPS = 4096, 5
SKIPGRAM_CPU_BATCH, SKIPGRAM_CPU_STEPS = 256, 3
# c3d: C3D of Tran et al. 2015, "Learning Spatiotemporal Features with 3D
# Convolutional Networks" (section 3.3): 8 conv3d 3x3x3 stride 1 pad 1
# with 64, 128, 256, 256, 512, 512, 512, 512 filters and ReLU; 5 max
# pools (pool1 1x2x2, the others 2x2x2, pool5 padded [0, 1, 1] to 512 x
# 1 x 4 x 4); fc6 and fc7 of 4096 with dropout 0.5; 487 classes
# (Sports-1M); 3 x 16 x 112 x 112 clips; Momentum 0.9 at the paper's lr
# 0.003. Cut: batch 8 for the paper's 30
C3D = dict(stages=[((64,), [1, 2, 2], 0), ((128,), 2, 0),
                   ((256, 256), 2, 0), ((512, 512), 2, 0),
                   ((512, 512), 2, [0, 1, 1])],
           fc=4096, classes=487, clip=[16, 112, 112], dropout=0.5,
           lr=0.003, momentum=0.9)
C3D_BATCH, C3D_STEPS = 8, 3
C3D_SERVE_BATCHES = (1, 8)
# the paper's forward count of a clip, in multiply-adds (38.5 G; the
# engine's FlopCounterMode counts two operations a multiply-add)
C3D_CLIP_GMACS = 38.5
# ssd: SSD-MobileNet-v1 as PaddlePaddle/models builds it
# (fluid/object_detection/mobilenet_ssd.py): MobileNet-v1 at scale 1.0
# up to its 19 x 19 (512) and 10 x 10 (1024) maps, four extra 1x1/3x3
# conv pairs down to 5, 3, 2 and 1; multi_box_head at base size 300, min
# sizes 60-285, aspect ratios [2] and [2, 3] x 5, flip and clip: 1917
# priors; PASCAL VOC's 21 classes; 300 x 300 images. Trained as Liu et
# al. 2016, "SSD: Single Shot MultiBox Detector" (arXiv 1512.02325,
# section 3): Momentum 0.9 at 1e-3, L2 5e-4, batch 32, the loss
# ``ssd_loss`` (one image a layer, as the reference's) over slices of
# the batch, summed. Served by ``detection_output`` at nms 0.45,
# nms_top_k 400, keep_top_k 200, score threshold 0.01. Cut: the ground
# truth padded to 16 boxes an image with zero boxes of label 0, which
# never match
SSD = dict(classes=21, image=300, scale=1.0, gt_boxes=16,
           min_sizes=[60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
           max_sizes=[[], 150.0, 195.0, 240.0, 285.0, 300.0],
           lr=1e-3, momentum=0.9, l2=5e-4)
SSD_NMS = dict(nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
               score_threshold=0.01)
SSD_PRIORS = 1917
SSD_BATCH, SSD_STEPS = 32, 3
SSD_CPU_BATCH = 4
SSD_SERVE_BATCHES = (1, 8)
# detection_ops: each lowering of the detection and CTC families alone at
# its users' shapes (detection_cases), on the card against the CPU at
# DENSE_TOL; the NMS and RoI ops and the grads that add rows back run
# twice, bitwise equal; F.ctc_loss beside warpctc
DETECTION_TWICE = ("multiclass_nms", "generate_proposals", "roi_align",
                   "roi_pool", "roi_perspective_transform",
                   "gather_encoded", "yolov3_loss", "warpctc")
# ops whose grad is an op of its own that the engine runs, never the vjp
# of the forward (py_func's runs Python on host arrays)
OWN_GRAD_OP = ("py_func",)
# opt_levels: BERT-base (float32, dropout 0) trained OPT_STEPS captured
# steps at levels 1 and 2 and served at both (the level-2 passes run the
# registered lowerings: FUSE_TOL's loss bound, bitwise where no pass
# fires); the seq-512 recipe at level 3 under a budget of OPT3_BUDGET_FRAC
# of its plain step's measured peak, re-planned from the measured peak
# beyond OPT3_REPLAN_TOL, its losses within TRAIN_TOL of the plain step's
OPT_STEPS = 3
OPT3_BUDGET_FRAC = 0.6
OPT3_REPLAN_TOL = 0.25
# layout_nhwc: ResNet-50 at batch 32 trained LAYOUT_STEPS captured steps
# at NCHW and at NHWC from one state, and served both ways. cuDNN picks
# other algorithms (and sums otherwise) per layout, so nothing is
# bitwise: each NHWC conv, pool and batch-norm op of the first step (and
# its grad op) is held against its NCHW lowering on the same operands,
# permuted (IMAGE_OP_TOL), the first loss to 1e-5 and the served logits
# to 1e-3 of their largest; end to end the step's grads are printed, not
# held (the 50 layers magnify rounding: percents apart, as the card's
# step against the CPU's in resnet50_train), and at lr 0.1 from random
# weights the loss doubles by the third step, the rounding growing about
# tenfold a step (0.3 % after one update, 2.0 % after two on an H100),
# so the later losses hold to 5e-2
LAYOUT_STEPS = 3
LAYOUT_TOL = {"first_loss_rtol": 1e-5, "loss_rtol": 5e-2,
              "logits_rel_to_max": 1e-3}
LAYOUT_OPS = ("conv2d", "depthwise_conv2d", "conv2d_grad",
              "depthwise_conv2d_grad", "pool2d", "batch_norm",
              "batch_norm_grad")
# cuDNN's (and torch's) kernels that reorder a tensor's layout: a filter
# copy shows among these in an NHWC step
LAYOUT_COPY_KERNEL = r"(nchw|nhwc|transpose|reorder|convert|permute|copy)"
# int8_serve: LeNet (tests/test_int8_accuracy.py, 8 and 16 filters) on
# the repo's MNIST reader, INT8_LENET's Adam epochs at its batch, then
# frozen, calibrated on INT8_CALIB_BATCHES train batches and quantized:
# the INT8 top-1 within INT8_TOP1_POINTS points of FP32 on the test split.
# ResNet-50 served INT8 through enable_mkldnn (INT8_SERVE_CALIB requests
# calibrate), its quantized ops bitwise equal to a float64 emulation of
# their int8 operands; the AOT artifact of the frozen float32 model
# within AOT_TOL of the predictor
INT8_LENET = dict(batch=64, epochs=3, lr=2e-3)
INT8_CALIB_BATCHES = 8
INT8_TOP1_POINTS = 0.5
INT8_SERVE_CALIB = 4
INT8_SERVE_BATCHES = (1, 8, 32)
INT8_AGREE_IMAGES = 256
AOT_BATCH = 8
AOT_TOL = {"rtol": 1e-4, "atol": 1e-4}

# mesh: BERT-base steps under a 1-rank mesh against no mesh (bitwise);
# the two-rank cases against one rank at the same global batch, within
# the step tolerances of PERF.md section 2 (the batch split into two
# partial sums, the grads all-reduced); the parameters after the steps
# within 1e-3 of each one's max plus a tenth of Adam's learning rate
# 1e-4, which sizes each step (a bias that starts at zero is a few steps
# of it; tests/test_torch_bert_training.py's rule); each case's
# collectives
MESH_STEPS = 3
MESH_DP2_LAYERS = 2
MESH_DP2_STEPS = 2
MESH_SP = dict(batch=4, seq_len=256, d_model=512, n_heads=8)
MESH_RING_T = 512
MESH_TOL = {"loss_rtol": 1e-4, "grad_rel_to_max": 1e-3,
            "state_rel_to_max": 1e-3, "state_abs": 1e-5}
MESH_CASES = {"dp2": ("all_reduce", "all_gather_into_tensor"),
              "sp2": ("all_reduce", "all_gather_into_tensor",
                      "batch_isend_irecv")}
# pserver: DeepFM at the ctr width on 2 pservers and 2 trainers (threads
# of this process), held against one process on the card at the
# reference's cluster tolerances (tests/test_dist_lookup_table.py:166-175)
PSERVER_SERVERS = 2
PSERVER_TRAINERS = 2
PSERVER_STEPS = 3
PSERVER_TOL = {"loss_rtol": 1e-4, "loss_atol": 1e-5, "table_rtol": 1e-4,
               "table_atol": 1e-6}


# opprof: a profiled window of the captured BERT-base step holds this many
# steps (the entry's tagged eager run, then replays joined to it); the
# limits of the phase's checks; the eager steps whose ops are timed with
# opprof on and off, each op half its calls each way (host_ms_by_flag)
OPPROF_STEPS = 4
OPPROF_TOL = {"attributed_frac": 0.95, "rows_vs_busy": 0.05,
              "flash_rows": 0.15, "host_ms": 0.03, "live_peak": 0.10}
OPPROF_HOST_TURNS = 8

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


# the script's start on the host clock; each phase line carries the
# seconds since it (``elapsed_s``), so a run's log shows where its time
# went
STARTED = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - STARTED)
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


def profiled(fn, calls=1, host=False):
    """Run ``fn`` (``calls`` calls of some function, for the record) under
    torch.profiler and return the profile: the card's activity, and with
    ``host`` the host's ops and ranges too (only ``window_ms`` reads
    them; without them a window records, stops and aggregates several
    times sooner). A window with no device activity at all (``fn``
    always launches kernels) is profiled again, up to
    EMPTY_WINDOW_RETRIES times, and recorded in PARTIAL_PROFILES.
    Returns the last window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = ([ProfilerActivity.CPU] if host else []) + [
        ProfilerActivity.CUDA]
    for _ in range(EMPTY_WINDOW_RETRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            return prof
        PARTIAL_PROFILES.append({"calls": calls, "odd_counts": []})
    return prof


def profile_kernels(fn, n, attempts=3, expect=None, windows=None):
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
    ``windows`` (a list) gets each profile taken."""
    from torch.autograd import DeviceType

    def calls():
        for _ in range(n):
            fn()

    for _ in range(attempts):
        prof = profiled(calls, n)
        if windows is not None:
            windows.append(prof)
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


def kernel_launches(fn):
    """(kernels launched, their device ms) of one call of ``fn``, by a
    profiler of the card's activity alone (no host events to process); a
    window that recorded none is profiled again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(EMPTY_WINDOW_RETRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        spans = [e.time_range for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if spans:
            return len(spans), sum(t.end - t.start for t in spans) / 1e3
        PARTIAL_PROFILES.append({"calls": 1, "odd_counts": []})
    return 0, 0.0


def device_ms(fn, name=None, n=DEVICE_MS_CALLS, warmup=3):
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


def window_ms(calls, n=5, warmup=1, launches=None):
    """Device ms per call of each ``(key, fn)`` of ``calls``, all in one
    profiler window: ``fn``'s ``n`` calls run under a ``record_function``
    label of their own, and each kernel counts for the label whose host
    span holds the host event that launched it, on any thread (a vjp's
    backward launches from autograd's device thread, outside the label's
    own events, while the calling thread waits inside the span). A
    kernel a label launched within one launch of a multiple of ``n``
    times counts, as in ``profile_kernels``, its mean launch time times
    its launches per call, so a launch the window dropped costs its
    label nothing (one such drop of a 60 ms kernel once read a vjp below
    its own forward); any other kernel counts its window time over
    ``n``. A window with no device activity is profiled again
    (``profiled``); a call whose label holds no device time is timed by
    CUDA events instead, recorded in EVENT_TIMED. Returns {key: ms};
    fills ``launches``, where given, with {key: kernel launches a call}
    (a label's launches over ``n``, rounded)."""
    import bisect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    for _, fn in calls:
        for _ in range(warmup):
            fn()
    labels = ["chip_smoke_call_%d" % i for i in range(len(calls))]

    def run():
        for label, (_, fn) in zip(labels, calls):
            with record_function(label):
                for _ in range(n):
                    fn()

    prof = profiled(run, n * len(calls), host=True)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    # {label: {kernel name: [launches, us]}}
    launched = {label: {} for label in labels}
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.name in launched)
    starts = [sp[0] for sp in spans]
    for e in events:
        if e.name in launched or not e.kernels:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= spans[i][1]:
            for k in e.kernels:
                c = launched[spans[i][2]].setdefault(k.name, [0, 0.0])
                c[0] += 1
                c[1] += k.duration

    def per_call_us(count, us):
        per_call = round(count / n)
        if per_call and abs(count - per_call * n) <= 1:
            return us / count * per_call
        return us / n

    out = {}
    for label, (key, fn) in zip(labels, calls):
        ms = sum(per_call_us(c, us)
                 for c, us in launched[label].values()) / 1e3
        if ms <= 0:
            ms = event_ms(fn, n)
            EVENT_TIMED.append([str(key), ms, []])
        check(ms > 0, "no device time of %r, by the profiler or by CUDA "
              "events" % (key,))
        out[key] = ms
        if launches is not None:
            launches[key] = round(sum(
                c for c, _ in launched[label].values()) / n)
    torch.cuda.synchronize()
    return out


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


def host_ms_by_kind(step, n=HOST_MS_STEPS):
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


def host_ms_by_flag(step, flag, turns):
    """Host ms of ``turns`` calls of ``step()`` by ``run_op`` call (the
    clock of ``host_ms_by_kind``, call by call), with the bool flag
    ``flag`` set before each call: up for the even calls of even turns
    and the odd calls of odd turns, down for the rest. So each op is
    timed ``turns / 2`` times each way, in the same steps as the other
    way, and whatever moves a whole step's host time moves both ways
    alike. Returns {True: ms, False: ms}: each op's median, summed."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.engine import lowering

    times = {True: {}, False: {}}
    run_op = lowering.run_op
    for turn in range(turns):
        count = [0]

        def timed(*args, **kwargs):
            i = count[0]
            count[0] += 1
            up = (i + turn) % 2 == 0
            flags.set_flags({flag: up})
            t0 = time.perf_counter()
            run_op(*args, **kwargs)
            times[up].setdefault(i, []).append(
                (time.perf_counter() - t0) * 1e3)

        lowering.run_op = timed
        try:
            step()
        finally:
            lowering.run_op = run_op
            flags.reset_flag(flag)
    return {up: sum(statistics.median(t) for t in by_op.values())
            for up, by_op in times.items()}


def timed_runs(run, n=TIMED_RUNS, warmup=1):
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
    PROFILED_STEPS more steps by kernel from the profiler, and with
    ``host`` the host time of 3 more by kind of op (an eager executor's: a replayed graph
    runs no op from Python). ``run_kw`` goes to ``exe.run``."""
    import paddle_tpu_torch.fluid as fluid

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss], **(run_kw or {}))

    with fluid.scope_guard(scope):
        row = timed_runs(step)
        kernels = device_kernels(step, PROFILED_STEPS)
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
    steps = {}
    for label, (exe, scope, prog, prog_loss) in runs.items():
        steps[label] = time_train_step(exe, scope, prog, prog_loss, feed8,
                                       host=label == "eager")
        emit(dict({"phase": "times", "profile": "batch-8 training step",
                   "run": label, "model": "bert_base",
                   "seq_len": BERT["seq_len"], "tf32": False},
                  **steps[label]))
    return rows["main_path"], rows["main_path_bf16"], steps


def phase_opprof(fa, main, state0, loss, eager, feed8, flash_ms, smi):
    """Op-level profiling of the captured BERT-base training step through
    ``fluid.profiler`` (``observability/opprof.py``): a fresh executor
    from ``state0`` warms up and captures, then OPPROF_STEPS steps run in
    a profiler session (``profiler.profile_steps``, which reruns a window
    the profiler dropped activity from): the first eagerly under the op
    ranges, the rest replays joined to it by kernel order. Checks: the
    table's ``source`` is "cuda", at least OPPROF_TOL's share of device
    time attributed, every registered op in the table, ``gate_issues``
    empty; its rows within 5 % of the window's device busy time (the
    profile's own events, read apart from the table); the flash kernels
    all in the ``fused_attention``/``fused_attention_grad`` rows, their
    ms there within 15 % of the ``times`` phase's device ms a launch in
    the captured step (``flash_ms``) times their launches; losses bitwise
    those of an executor from the same state with ``opprof`` off and no
    profiler; the memory gauges (``hbm.live_bytes_peak`` within 10 % of
    ``torch.cuda.max_memory_allocated``), one ``memory_pressure`` event
    an excursion, a heartbeat's ``hbm_peak_bytes``; and the ``eager``
    executor's host ms a step (``host_ms_by_flag`` over
    OPPROF_HOST_TURNS steps: each op's median, summed) with ``opprof`` on
    and no profiler within 3 % of off (CASE_REFERENCES held). Each
    number stands beside ``smi``."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import flags, profiler
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import health, memory, opprof

    t0 = time.perf_counter()
    trace_root = tempfile.mkdtemp(prefix="chip_smoke_opprof_")
    flags.set_flags({"peak_flops": MFU_PEAKS["H100"]["float32"],
                     "peak_membw_bytes": HBM_BYTES_PER_S,
                     "trace_dir": os.path.join(trace_root, "trace")})
    on, on_scope = state_executor(main, state0)
    off, off_scope = state_executor(main, state0)

    def run(exe, scope):
        with fluid.scope_guard(scope):
            (out,) = exe.run(main, feed=feed8, fetch_list=[loss])
        return float(out.reshape(-1)[0])

    parts = {}
    losses = {"on": [run(on, on_scope), run(on, on_scope)]}
    parts["warm_up_and_capture"] = time.perf_counter() - t0
    opprof.reset()
    memory.reset_peaks()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    table, rejected = profiler.profile_steps(
        lambda: losses["on"].append(run(on, on_scope)), OPPROF_STEPS,
        profile_path=os.path.join(flags.get_flag("trace_dir"), "profile"))
    launches = flash_launches(fa)  # ... and ends here
    session = profiler.last_session()
    parts["profiled_window"] = time.perf_counter() - t0 - sum(parts.values())
    max_allocated = int(torch.cuda.max_memory_allocated())
    live_peak = obs.registry.gauge_value("hbm.live_bytes_peak")
    flags.set_flags({"opprof": False})
    losses["off"] = [run(off, off_scope) for _ in losses["on"]]
    flags.reset_flag("opprof")

    # the window's device busy time, from the profile's own events: the
    # union of its kernels, copies and fills (not the device-side spans
    # the profiler draws for the host ranges, which cover idle time)
    from torch.autograd import DeviceType

    busy_ms = sum(b - a for a, b in _union([
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in session["profile"].profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA
        and not e.name().startswith(("pt.", "opprof."))])) / 1e6
    rows_ms = sum(r["ms"] for r in table["ops"].values())
    snap = opprof.registry_snapshot()
    entry = [label for label, kind in snap["instr_kinds"].items()
             if kind == "captured"]
    missing = [t for label in entry for t in snap["instr_tags"][label]
               if t not in table["ops"]]
    # the flash kernels' rows, against the times phase's device ms a
    # launch of each kernel in the captured training step (``flash_ms``;
    # ``time_train_step``'s profile of that step); beside them, each
    # kernel alone, called in a loop at this step's lengths and attention
    # dropout, for the record (a kernel in the step runs with the step's
    # clocks and caches, not the loop's)
    q, k, v, g = attention_inputs(8, 12, 128, 128, 64, torch.float32, 99) \
        + (torch.randn(8, 12, 128, 64, device="cuda"),)
    lens_t = torch.as_tensor(feed8["seq_lens"].reshape(-1), device="cuda")
    seed_t = torch.tensor(7, dtype=torch.int64, device="cuda")
    rate = next(float(op.attrs.get("dropout_rate", 0.0))
                for op in main.desc.global_block().ops
                if op.type == "fused_attention")

    def attention_step():
        out, lse = fa.flash_forward_cuda(q, k, v, lens_t, seed=seed_t,
                                         rate=rate)
        fa.flash_backward_cuda(q, k, v, out, lse, g, None, lens_t,
                               seed=seed_t, rate=rate)

    by_name = device_kernels(attention_step, 10)
    alone_ms = {name: sum(ms for key, ms in by_name.items()
                          if name + "_kernel" in key)
                for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    del q, k, v, g
    events = session["events"]
    flash = {}
    for name, op_type in (("flash_fwd", "fused_attention"),
                          ("flash_bwd_dq", "fused_attention_grad"),
                          ("flash_bwd_dkv", "fused_attention_grad")):
        mine = [(ms, tag) for n, ms, tag in events
                if name + "_kernel" in n]
        per_step = BERT["n_layers"]
        flash[name] = {
            # ms of each step's launches: the tagged eager run, then the
            # replays (device_op_events lists the eager run first)
            "ms_by_step": [sum(ms for ms, _ in mine[i:i + per_step])
                           for i in range(0, len(mine), per_step)],
            "launches": len(mine),
            "in_rows": sum(opprof.tag_op_type(t) == op_type
                           for _, t in mine),
            "ms": sum(ms for ms, _ in mine),
            "times_ms_x_launches": flash_ms[name] * len(mine),
            "alone_ms_x_launches": alone_ms[name] * len(mine)}
    attn_rows = {op: {"rows": sum(r["op_type"] == op
                                  for r in table["ops"].values()),
                      "ms": sum(r["ms"] for r in table["ops"].values()
                                if r["op_type"] == op),
                      "launches": sum(r["events"] for r in
                                      table["ops"].values()
                                      if r["op_type"] == op)}
                 for op in ("fused_attention", "fused_attention_grad")}

    parts["off_steps_and_reads"] = (time.perf_counter() - t0
                                    - sum(parts.values()))
    # memory: one pressure event an excursion, then the heartbeat
    flags.set_flags({"metrics": True})
    limit = memory.device_memory_limit()
    low = 0.5 * torch.cuda.memory_allocated() / limit
    events_before = obs.counter_value("memory.pressure_events")
    for frac in (low, low, 0.99, low):
        flags.set_flags({"memory_pressure_frac": frac})
        run(on, on_scope)
    pressure = obs.counter_value("memory.pressure_events") - events_before
    flags.reset_flag("memory_pressure_frac")
    flags.reset_flag("metrics")
    beat = health.HeartbeatEmitter(interval_ms=1000.0).emit_now()

    # the eager step's host ms, opprof on (no session) and off, in turns
    exe_e, scope_e = eager
    gc.collect()
    gc.disable()  # no collection inside a timed step
    held = (CASE_REFERENCES.held() if CASE_REFERENCES is not None
            else contextlib.nullcontext())
    try:
        with held, fluid.scope_guard(scope_e):
            exe_e.run(main, feed=feed8, fetch_list=[loss])  # a warm-up
            by_flag = host_ms_by_flag(lambda: exe_e.run(
                main, feed=feed8, fetch_list=[loss]), "opprof",
                OPPROF_HOST_TURNS)
    finally:
        gc.enable()
    parts["memory_and_host_turns"] = (time.perf_counter() - t0
                                      - sum(parts.values()))
    host_ms = {"on": by_flag[True], "off": by_flag[False]}
    host_ratio = host_ms["on"] / host_ms["off"]
    for name in ("peak_flops", "peak_membw_bytes", "trace_dir"):
        flags.reset_flag(name)
    shutil.rmtree(trace_root, ignore_errors=True)

    by_type = {}
    for row in table["ops"].values():
        t = by_type.setdefault(row["op_type"],
                               {"ms": 0.0, "launches": 0, "rows": 0})
        t["ms"] += row["ms"]
        t["launches"] += row["events"]
        t["rows"] += 1
    by_type = dict(sorted(by_type.items(), key=lambda kv: -kv[1]["ms"])[:12])
    top = [{"tag": tag, "op": row["op_type"], "ms": row["ms"],
            "launches": row["events"], "flops": row["flops"],
            "bytes": row["bytes"], "intensity": row["intensity"],
            "verdict": row["verdict"]}
           for tag, row in opprof.top_rows(table, 15)]
    emit({"phase": "opprof", "card": smi, "model": "bert_base",
          "batch": 8, "seq_len": BERT["seq_len"], "captured": True,
          "steps_a_window": OPPROF_STEPS, "rejected_windows": rejected,
          "peaks": {"flops": MFU_PEAKS["H100"]["float32"],
                    "membw_bytes": HBM_BYTES_PER_S},
          "top": top, "by_op_type": by_type,
          "ops_in_table": len(table["ops"]),
          "ops_with_device_time": sum(r["ms"] > 0
                                      for r in table["ops"].values()),
          "source": table["source"], "join": table["join"],
          "attributed_frac": table["attributed_frac"],
          "unattributed_ms": table["unattributed_ms"],
          "total_ms": table["total_ms"], "rows_ms": rows_ms,
          "busy_ms": busy_ms, "gate_issues": opprof.gate_issues(table),
          "attention_rows": attn_rows, "flash_in_rows": flash,
          "flash_launches": launches,
          "flash_ms_a_launch": {"times_captured_step": flash_ms,
                                "alone": alone_ms},
          "attention_dropout": rate,
          "losses": losses,
          "memory": {"hbm.live_bytes_peak": live_peak,
                     "max_memory_allocated": max_allocated,
                     "pressure_events": pressure,
                     "heartbeat_hbm_peak_bytes": beat.get(
                         "hbm_peak_bytes"),
                     "peak_hbm_bytes": memory.peak_hbm_bytes()},
          "host_ms": {"opprof_on": host_ms["on"],
                      "opprof_off": host_ms["off"],
                      "on_over_off": host_ratio,
                      "steps": OPPROF_HOST_TURNS},
          "tol": OPPROF_TOL, "seconds": time.perf_counter() - t0,
          "seconds_by_part": parts})
    check(table["source"] == "cuda", "opprof source %r, join %s"
          % (table["source"], table["join"]))
    check(table["attributed_frac"] >= OPPROF_TOL["attributed_frac"],
          "opprof attributed %.4f" % table["attributed_frac"])
    check(entry and not missing, "opprof: no captured entry, or ops "
          "missing from the table: %s" % missing[:5])
    check(not opprof.gate_issues(table), "opprof gate: %s"
          % opprof.gate_issues(table))
    check(abs(rows_ms - busy_ms) <= OPPROF_TOL["rows_vs_busy"] * busy_ms,
          "opprof rows %.3f ms against %.3f ms busy" % (rows_ms, busy_ms))
    for name, f in flash.items():
        check(f["launches"] and f["in_rows"] == f["launches"],
              "%s: %d launches, %d in their op's rows"
              % (name, f["launches"], f["in_rows"]))
        check(abs(f["ms"] - f["times_ms_x_launches"])
              <= OPPROF_TOL["flash_rows"] * f["times_ms_x_launches"],
              "%s: %.4f ms in the rows against %.4f ms from times"
              % (name, f["ms"], f["times_ms_x_launches"]))
    windows = OPPROF_STEPS * (1 + len(rejected))
    check(launches == dict.fromkeys(launches, windows * BERT["n_layers"]),
          "opprof: flash launches %s in %d profiled steps" % (launches,
                                                             windows))
    check(losses["on"] == losses["off"], "opprof changed the losses: %s"
          % losses)
    check(live_peak and abs(live_peak - max_allocated)
          <= OPPROF_TOL["live_peak"] * max_allocated,
          "hbm.live_bytes_peak %s against max_memory_allocated %d"
          % (live_peak, max_allocated))
    check(pressure == 2, "%d memory_pressure events for 2 excursions"
          % pressure)
    check(beat.get("hbm_peak_bytes") == memory.peak_hbm_bytes() > 0,
          "heartbeat hbm_peak_bytes %s" % beat.get("hbm_peak_bytes"))
    check(host_ratio <= 1.0 + OPPROF_TOL["host_ms"],
          "eager host ms with opprof on %.2f over off %.2f: %.4f"
          % (host_ms["on"], host_ms["off"], host_ratio))
    del on, off, on_scope, off_scope
    release_memory()
    return launches


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
            latency = {b: timed_runs(lambda f=feed: pred.run(f),
                                     n=2 * TIMED_RUNS)
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


def reader_pipeline_program(capacity):
    """ResNet-50 as ``resnet_program(is_train=True)`` builds it, fed by a
    ``layers.py_reader`` (an image and a label slot) in place of the two
    ``layers.data`` vars; the same parameters and startup. Returns (main,
    startup, the PyReader, loss)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        rd = fluid.layers.py_reader(
            capacity=capacity, shapes=[[-1, 3, 224, 224], [-1, 1]],
            dtypes=["float32", "int64"], name="train_reader")
        rd = fluid.layers.double_buffer(rd)
        img, label = rd.vars
        feat = resnet.resnet_imagenet(img, depth=RESNET["depth"],
                                      is_train=True)
        logits = fluid.layers.fc(input=feat, size=RESNET["class_num"])
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits=logits, label=label))
        fluid.optimizer.Momentum(learning_rate=RESNET["lr"],
                                 momentum=0.9).minimize(loss)
    main.random_seed = startup.random_seed = 2024
    return main, startup, rd, loss


def phase_reader_pipeline(fa, smi):
    """ResNet-50 (batch 32, 224 x 224, Momentum, captured) trained from a
    RecordIO file as a user feeds it: ``recordio_writer`` writes 8
    batches of uint8 images and int64 labels from seeded numpy;
    ``layers.open_files`` reads them through the native RecordIO reader,
    ``reader.map_readers`` normalises each image to float32 in numpy,
    ``layers.shuffle`` (a fixed seed) and ``layers.batch`` group them,
    and three loops train from the same initial state over the same
    batches: a ``py_reader`` that ``Executor.run`` pops with no feed
    until ``EOFException``; ``DataFeeder.decorate_reader(prefetch=True)``
    with ``dispatch_steps=2``; and the pre-staged control, the same
    batches as numpy feeds already in memory. Losses bitwise equal; step
    ms, images/s, the card's idle share; the host's decode ms a batch,
    the queue's pop wait a step and the records/s read from the file; the
    native library built and loaded. Returns the flash launches (none)."""
    import random

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import native, reader, recordio_writer

    n = READER_BATCHES
    rng = np.random.RandomState(READER_SEED)
    images = rng.randint(0, 256, (n * RESNET_BATCH, 3, 224, 224)).astype(
        np.uint8)
    labels = rng.randint(0, RESNET["class_num"], n * RESNET_BATCH).astype(
        np.int64)

    def normalise(sample):
        img, label = sample
        return img.astype(np.float32) / 127.5 - 1.0, label

    def stack(rows):
        return [np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])]

    # the native library's first use in this process: g++ builds it from
    # the checkout's sources unless a build of these sources is on disk
    built_here = not os.path.exists(native.library_path())
    t0 = time.perf_counter()
    native.lib()
    native_s = time.perf_counter() - t0
    main, startup, rd, loss = reader_pipeline_program(capacity=4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_reader_") as d:
        path = os.path.join(d, "train.recordio")
        t0 = time.perf_counter()
        written = recordio_writer.convert_reader_to_recordio_file(
            path, lambda: zip(images, labels), max_num_records=64)
        write_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
        records = fluid.layers.open_files(
            path, shapes=[[3, 224, 224], [1]], dtypes=["uint8", "int64"])
        rows = fluid.layers.batch(fluid.layers.shuffle(
            reader.map_readers(normalise, records), 2 * RESNET_BATCH),
            RESNET_BATCH)
        batches = reader.map_readers(stack, rows)

        def epoch_order():
            random.seed(READER_SEED)  # the shuffle draws from Python's

        # the host side alone: the file read, and the whole decode chain
        t0 = time.perf_counter()
        read = sum(1 for _ in records())
        read_s = time.perf_counter() - t0
        epoch_order()
        t0 = time.perf_counter()
        staged = list(batches())
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(staged)
        check(written == read == n * RESNET_BATCH and len(staged) == n,
              "records written %d, read %d, batches %d"
              % (written, read, len(staged)))
        names = rd.var_names
        rd.decorate_paddle_reader(batches)
        pops = []
        pop = rd.next_feed

        def timed_pop():
            t = time.perf_counter()
            try:
                return pop()
            finally:
                pops.append((time.perf_counter() - t) * 1e3)

        rd.next_feed = timed_pop
        feeder = fluid.DataFeeder(feed_list=rd.vars, place=fluid.CUDAPlace(0),
                                  program=main)

        def py_reader_loop(exe, scope):
            epoch_order()
            rd.start()
            vals = []
            with fluid.scope_guard(scope):
                while True:
                    try:
                        vals.append(exe.run(main, fetch_list=[loss])[0])
                    except fluid.EOFException:
                        break
            return [float(v.reshape(-1)[0]) for v in vals]

        def prefetch_loop(exe, scope):
            epoch_order()
            with fluid.scope_guard(scope):
                vals = [exe.run(main, feed=f, fetch_list=[loss],
                                dispatch_steps=2)[0]
                        for f in feeder.decorate_reader(
                            rows, prefetch=True, prefetch_depth=2)()]
                exe.sync()
            return [float(np.asarray(v).reshape(-1)[0]) for v in vals]

        feeds = [dict(zip(names, b)) for b in staged]

        def staged_loop(exe, scope):
            with fluid.scope_guard(scope):
                return [float(exe.run(main, feed=f, fetch_list=[loss])[0]
                              .reshape(-1)[0]) for f in feeds]

        fa.launches = fa.launches_dq = fa.launches_dkv = 0
        loops = (("py_reader", py_reader_loop),
                 ("prefetch_window2", prefetch_loop),
                 ("pre_staged", staged_loop))
        runs, losses = {}, {}
        for name, loop in loops:
            release_memory()
            exe, scope = fresh(startup)
            losses[name] = loop(exe, scope)
            del pops[:]
            walls = timed_runs(lambda: loop(exe, scope), n=1, warmup=0)
            pop_ms = sum(pops) / max(len(pops), 1)
            copy_ms, overlap, active_ms, span_ms = profiled_loop(
                lambda: loop(exe, scope))
            step_ms = walls["median_ms"] / n
            runs[name] = {"step_ms": step_ms,
                          "images_per_s": RESNET_BATCH / (step_ms / 1e3),
                          "device_active_ms": active_ms / n,
                          "device_idle_share": 1.0 - active_ms / span_ms,
                          "h2d_copy_ms_per_step": copy_ms / n,
                          "h2d_overlapping_kernels_share": overlap,
                          "graphs": [(c.captures, c.replays)
                                     for c in captured(exe.engine)]}
            if name == "py_reader":
                runs[name]["pop_wait_ms_per_step"] = pop_ms
            del exe, scope
        rd.reset()
    launches = flash_launches(fa)
    emit({"phase": "reader_pipeline", "card": smi, "batch": RESNET_BATCH,
          "batches": n, "records": written, "file_bytes": file_bytes,
          "write_s": write_s, "records_per_s_read": read / read_s,
          "decode_ms_per_batch": decode_ms,
          "native_library": native.loaded_path(),
          "native_built_here": built_here, "native_first_use_s": native_s,
          "queue_capacity": 4,
          "prefetch_depth": 2, "losses": losses, "runs": runs,
          "launches": launches})
    check(losses["py_reader"] == losses["pre_staged"]
          == losses["prefetch_window2"],
          "the reader loops' losses differ: %s" % losses)
    check(len(losses["py_reader"]) == n
          and all(np.isfinite(losses["py_reader"])), "ResNet-50 losses")
    check(not any(launches.values()), "flash launches in ResNet-50")
    release_memory()
    return launches


def optimizer_operands(op_type, shape, seed):
    """The operands of one optimizer update at ``shape`` (float32 CPU
    tensors from ``seed``), as the op's slots take them: weights of a few
    hundredths, grads of a hundredth, accumulators as some steps of such
    grads leave them (FTRL's squared sum about ten grads' squares). The
    ops' operands are drawn from one stream in OPTIMIZER_OPS' order; the
    ops after ``op_type`` draw nothing, which leaves its values as they
    are when every op draws."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def f(low=None, scale=1.0):
        x = torch.randn(shape, generator=gen) * scale
        return x.abs() + low if low is not None else x

    one = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    lr = one(0.01)
    p, g = f(scale=0.05), f(scale=0.01)
    ops = {
        "lars_momentum": lambda: (
            {"Param": p, "Grad": g, "Velocity": f(scale=0.01),
             "LearningRate": lr},
            {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005}),
        "adamax": lambda: (
            {"Param": p, "Grad": g, "Moment": f(scale=0.01),
             "InfNorm": f(low=0.01, scale=0.01), "LearningRate": lr,
             "Beta1Pow": one(0.81)},
            {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "adagrad": lambda: (
            {"Param": p, "Grad": g, "Moment": f(low=0.0, scale=0.01),
             "LearningRate": lr}, {"epsilon": 1e-6}),
        "decayed_adagrad": lambda: (
            {"Param": p, "Grad": g, "Moment": f(low=0.0, scale=0.01),
             "LearningRate": lr}, {"decay": 0.95, "epsilon": 1e-6}),
        "adadelta": lambda: (
            {"Param": p, "Grad": g,
             "AvgSquaredGrad": f(low=0.0, scale=0.01),
             "AvgSquaredUpdate": f(low=0.0, scale=0.01)},
            {"rho": 0.95, "epsilon": 1e-6}),
        "rmsprop": lambda: (
            {"Param": p, "Grad": g, "Moment": f(scale=0.01),
             "MeanSquare": f(low=1e-3, scale=0.01),
             "MeanGrad": f(scale=0.001), "LearningRate": lr},
            {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9,
             "centered": True}),
        "ftrl": lambda: (
            {"Param": p, "Grad": g,
             "SquaredAccumulator": 10.0 * g * g + f(low=1e-6, scale=1e-5),
             "LinearAccumulator": f(scale=0.01), "LearningRate": lr},
            {"l1": 0.001, "l2": 0.001, "lr_power": -0.5}),
        "model_average_accum": lambda: (
            {"Param": p, "Sum": f(), "Cnt": one(5.0), "OldSum": f(),
             "OldCnt": one(10.0), "Total": one(30.0)},
            {"average_window_rate": 0.15, "min_average_window": 6,
             "max_average_window": 20}),
    }
    for name, draw in ops.items():
        operands = draw()
        if name == op_type:
            return operands
    raise KeyError(op_type)


def optimizer_cases():
    """(op type, shape, seed) of each update the optimizers phase holds
    on the card against the CPU: every op of OPTIMIZER_OPS at BERT-base's
    word embedding and an FFN weight."""
    return [(op_type, shape, 80 + i)
            for i, op_type in enumerate(OPTIMIZER_OPS)
            for shape in ((BERT["vocab_size"], BERT["d_model"]),
                          (BERT["d_model"], BERT["d_inner"]))]


def prepare_optimizer_case(k, case):
    """The CPU side of one optimizers case: its operands
    (``optimizer_operands``) and the update's CPU outputs."""
    op_type, shape, seed = case
    ins, attrs = optimizer_operands(op_type, shape, seed)
    got = lower_op(op_type, {s: [v.to("cpu")] for s, v in ins.items()},
                   attrs, "cpu")
    return {"key": (op_type, shape), "ins": ins, "attrs": attrs,
            "cpu": {s: v[0].cpu() for s, v in got.items()}}


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
    cases = optimizer_cases()
    for (op_type, shape, _), prep in zip(cases, prepared(
            "optimizers", [c[:2] for c in cases], cases,
            prepare_optimizer_case)):
        got = lower_op(op_type, {s: [v.to("cuda")]
                                 for s, v in prep["ins"].items()},
                       prep["attrs"], "cuda")
        card = {s: v[0].cpu() for s, v in got.items()}
        errs = {}
        for slot, want in prep["cpu"].items():
            err = float((card[slot] - want).abs().max())
            scale = float(want.abs().max())
            errs[slot] = err / scale if scale else err
            check(err <= OPT_TOL * scale, "%s %s on the card: %s off "
                  "by %g (max |want| %g)" % (op_type, shape, slot, err,
                                             scale))
        worst["%s %dx%d" % ((op_type,) + shape)] = max(errs.values())
        del got, card, prep

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
    differ from the CPU's and their end-to-end grads against the CPU run
    are printed, and the kernel run's against the pinned one."""
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
        ends[label] = {
            "relu_decisions_unlike_cpu": {
                n: int(((v > 0) != (cpu["relu"][n] > 0)).sum())
                for n, v in r["relu"].items()},
            "against_cpu": against(r, cpu)}
        if label == "card":
            # the CPU step again with the card's relu decisions: the
            # plain-attention witness's own is not rerun (a second CPU
            # step for a run no check reads)
            masks = {n: torch.from_numpy(v > 0)
                     for n, v in r["relu"].items()}
            pinned = run(fluid.CPUPlace(), _relu_with_masks(masks))
            ends[label]["against_cpu_with_its_relu_decisions"] = against(
                r, pinned)
            del masks, pinned
        del r
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


def profiled_step(exe, scope, main, loss, feed, n=TIMED_RUNS,
                  profiled_steps=PROFILED_STEPS):
    """``timed_runs`` of a step and its device profile over
    ``profiled_steps`` more, one profiler window: busy ms (the union of
    the kernels' intervals: a captured graph may run independent kernels
    at once, so their times can sum past the wall), idle share, kernel
    launches a step, the top kernels."""
    import paddle_tpu_torch.fluid as fluid

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss])

    windows = []
    with fluid.scope_guard(scope):
        row = timed_runs(step, n=n)
        kernels = profile_kernels(step, profiled_steps, windows=windows)
    _, _, active, _ = device_intervals(windows[-1])
    busy = active / profiled_steps
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


def _rnn_operands(op_type, attrs, gates, seed):
    """The operands of an ``rnn_op_case`` at the classifier's width, from
    ``seed``: (inputs, lengths, cotangents, output slots)."""
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
    return ins, lens, cots, outs


def _rnn_run(op_type, attrs, operands, device, rows=None):
    """The op and every input's grad (``torch.func.vjp``, the engine's
    generic grad) on ``device`` for the first ``rows`` sequences (H0 and
    the per-sequence operands cut alike; Weight and Bias whole): the
    outputs, then the grads, on the host."""
    import torch

    from paddle_tpu_torch.core.desc import OpDesc
    from paddle_tpu_torch.core.registry import LowerContext, OpRegistry

    ins, lens, cots, outs = operands
    rows = len(lens) if rows is None else rows
    info = OpRegistry.get(op_type)
    slots = sorted(ins)
    ctx = LowerContext(OpDesc(op_type, {}, {}, attrs), None, device)
    extra = {"SeqLen": [torch.from_numpy(lens[:rows]).to(device)]}

    def fwd(*prims):
        fin = dict(extra, **{s: [p] for s, p in zip(slots, prims)})
        out = info.lower(ctx, fin, attrs)
        return tuple(out[s][0] for s in outs)

    prims = [torch.from_numpy(ins[s][:rows] if s in ("Input", "H0")
                              else ins[s]).to(device) for s in slots]
    got, vjp = torch.func.vjp(fwd, *prims)
    grads = vjp(tuple(torch.from_numpy(c[:rows]).to(device) for c in cots))
    return [t.cpu() for t in got + grads]


def prepare_rnn_case(k, case):
    """The CPU side of RNN_OP_CASES' case ``k``: its operands and the CPU
    run on RNN_OP_CPU_ROWS of the batch's sequences (the CPU's recurrence
    is the comparison's long pole)."""
    op_type, attrs, gates = case
    operands = _rnn_operands(op_type, attrs, gates, 80 + k)
    return {"key": (op_type, tuple(sorted(attrs.items()))),
            "operands": operands,
            "cpu": _rnn_run(op_type, attrs, operands, "cpu",
                            RNN_OP_CPU_ROWS)}


def rnn_op_case(op_type, attrs, prep):
    """``op_type`` at the classifier's width ([B, T, gates * H], ragged
    lengths) on the card against the CPU from the same operands
    (``prep``, from ``prepare_rnn_case``): the outputs and every input's
    grad with the same cotangents, on RNN_OP_CPU_ROWS of the sequences;
    returns the worst difference of each, relative to its largest
    element, the card's ms on the whole batch, and the compared steps."""
    operands = prep["operands"]
    card = _rnn_run(op_type, attrs, operands, "cuda", RNN_OP_CPU_ROWS)
    names = list(operands[3]) + [s + "@GRAD" for s in sorted(operands[0])]
    worst = {}
    for n, a, b in zip(names, card, prep["cpu"]):
        peak = float(b.abs().max())
        worst[n] = float((a - b).abs().max()) / (peak or 1.0)

    def on_card():
        _rnn_run(op_type, attrs, operands, "cuda")

    ms = timed_runs(on_card, n=1, warmup=1)["median_ms"]
    return worst, ms, int(operands[1][:RNN_OP_CPU_ROWS].sum())


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
    """The stacked-LSTM classifier on the card: 3 Adam steps eagerly and
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
    lockstep_checks("lstm", losses, unequal, entries, eager_runs, launches)
    # one batch repeated at Adam's 0.01 with no clipping: the first step
    # lowers the loss, later ones may overshoot (the JAX package's step
    # does too from the same state, PERF.md §6)
    check(losses["captured"][1] < losses["captured"][0],
          "LSTM loss did not fall: %s" % losses["captured"])

    # times: captured (with the device profile) and eager; the recurrent
    # ops of an eager step
    cap = profiled_step(graph[0], graph[1], main, loss, feed)
    with fluid.scope_guard(eager[1]):
        eag = timed_runs(lambda: eager[0].run(main, feed=feed,
                                              fetch_list=[loss]),
                         n=1, warmup=0)
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
    cpu_row, ok = card_cpu_step(main, state0, loss, feed2)
    emit({"phase": "lstm", "cpu_step": dict(cpu_row, batch=LSTM_CPU_BATCH)})
    check(ok, "LSTM card vs CPU step %s" % cpu_row)

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
    for (op_type, attrs, gates), prep in zip(RNN_OP_CASES, prepared(
            "lstm_rnn_ops", [(t, tuple(sorted(a.items())))
                             for t, a, _ in RNN_OP_CASES],
            RNN_OP_CASES, prepare_rnn_case)):
        worst, ms, valid = rnn_op_case(op_type, attrs, prep)
        cases.append({"op": op_type, "attrs": attrs,
                      "shape": [LSTM["batch_size"], LSTM["seq_len"],
                                gates * LSTM["hidden_dim"]],
                      "compared_rows": RNN_OP_CPU_ROWS,
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
DENSE_WITNESS = {"conv2d_transpose": {"cudnn_float32":
                                      _conv2d_transpose_cudnn}}


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

    def tied(*shape):
        # values on a coarse grid, the first rows all zero: ties at the
        # top of every row, which top_k takes lowest index first
        def make(rng):
            x = np.round(rng.randn(*shape) * 0.5).astype(np.float32)
            x[:8] = 0.0
            return x
        return make

    def tied_bf16(*shape):
        def make(rng):
            import torch
            return torch.from_numpy(tied(*shape)(rng)).to(torch.bfloat16)
        return make

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
        # top_k at BERT's vocab logits, with ties (the cases above keep
        # their seeds)
        ("top_k", "top_k", ins(X=[f(*vocab)]), {"k": 5}),
        ("top_k_ties", "top_k", ins(X=[tied(*vocab)]), {"k": 5}),
        ("top_k_ties_bf16", "top_k", ins(X=[tied_bf16(*vocab)]), {"k": 5}),
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
    its ``no_grad_inputs``; none for an op without a grad, or whose grad
    is an op of its own (OWN_GRAD_OP)."""
    from paddle_tpu_torch.core.registry import OpRegistry

    info = OpRegistry.get(op_type)
    if info.grad_maker is None or op_type in OWN_GRAD_OP:
        return []
    return [(s, i) for s in sorted(ins) if s not in info.no_grad_inputs
            for i, v in enumerate(ins[s])
            if not isinstance(v, dict) and v.is_floating_point()]


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


def _on(device, v):
    """A case's input (a numpy array, a torch tensor, or a tensor array of
    them) on ``device``; on the CPU a tensor that shares the array's
    memory."""
    import torch

    if isinstance(v, dict):  # a tensor array
        return {k: torch.as_tensor(a, device=device) for k, a in v.items()}
    return torch.as_tensor(v, device=device)


def _own_copy(v):
    """A CPU tensor (or tensor array) of ``v`` in memory of its own."""
    import torch

    if isinstance(v, dict):
        return {k: _own_copy(a) for k, a in v.items()}
    return torch.as_tensor(v).clone()


def prepare_case(k, case):
    """The CPU side of case ``k`` of an op phase (``phase_op_cases``):
    its inputs from RandomState(500 + k) (``full``; ``host``, cut to the
    OP_CPU_ROWS rows it is compared on), the lowering's CPU outputs and,
    for an op with a grad, the vjp grads on the cotangents from
    RandomState(900 + k) (shaped as the float outputs), on copies of the
    inputs (the card's operands stay as made)."""
    import torch

    name, op_type, make, attrs = case
    full = make(np.random.RandomState(500 + k))
    cut = OP_CPU_ROWS.get(name, {})
    host = {s: [a[:cut[s]] for a in v] if s in cut else v
            for s, v in full.items()}
    ins = {s: [_own_copy(a) for a in v] for s, v in host.items()}
    out = lower_op(op_type, ins, attrs, "cpu")
    cpu = {"out": {s: [v.cpu() for v in vs] for s, vs in out.items()}}
    floats = [v for s in sorted(cpu["out"]) for v in cpu["out"][s]
              if v.is_floating_point()]
    crng = np.random.RandomState(900 + k)
    cots = [torch.as_tensor(np.asarray(crng.randn(*v.shape),
                                       np.float32)).to(v.dtype)
            for v in floats]
    primals = grad_primals(op_type, ins)
    if primals:
        cpu["grads"] = [g.cpu() for g in op_vjp(op_type, ins, attrs, "cpu",
                                                 cots)]
    return {"key": (name, op_type), "full": full, "host": host,
            "cut": cut, "cpu": cpu, "cots": cots, "primals": primals}


class CaseReferences(threading.Thread):
    """The CPU sides of cases that phases compare the card against, made
    on a thread of their own while the card's earlier phases run:
    ``phases`` is [(phase, a function of a directory giving its cases,
    the function of (index, case) that prepares one: a dict with its
    ``key``)], made in that order (the misc cases write their files into
    a directory the thread keeps). Torch's CPU ops and numpy's draws run
    outside Python's lock, so the thread takes little from the card's
    phases; the phase itself then runs only the card's side.
    ``take(phase, keys)`` yields the prepared cases in order (their keys
    checked against ``keys``), blocking until each is ready, and raises
    what the thread raised."""

    def __init__(self, phases):
        super().__init__(name="chip_smoke_case_references", daemon=True)
        self.phases = phases
        self.ready = {phase: queue.Queue() for phase, _, _ in phases}
        self.tmpdir = tempfile.mkdtemp(prefix="chip_smoke_cases_")
        self.seconds = {}
        # held(): the thread waits between cases while ``_go`` is clear,
        # and sets ``_idle`` while it waits (or when it is done)
        self._go = threading.Event()
        self._go.set()
        self._idle = threading.Event()
        self._stopped = False

    def stop(self, timeout=120.0):
        """Prepare no more cases, and wait for the thread to end."""
        self._stopped = True
        self._go.set()
        self.join(timeout)

    @contextlib.contextmanager
    def held(self, timeout=10.0):
        """Within the block the thread prepares no case (it finishes the
        one it is on first, waited for up to ``timeout`` s): for host
        times that nothing else on the CPU should move."""
        self._go.clear()
        try:
            if self.is_alive():
                self._idle.wait(timeout)
            yield
        finally:
            self._go.set()

    def _wait_go(self):
        if not self._go.is_set():
            self._idle.set()
            self._go.wait()
            self._idle.clear()

    def run(self):
        # the scheduler's lowest priority for the thread, where it takes
        # one: the card's phases keep the CPU they use. (Its torch ops
        # keep the default threads: a CPU reference's float sums then add
        # in the order they did when the phases made them; on two threads
        # conv3d's filter grad came out 2.7e-5 of max off the card's.)
        try:
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
        except (AttributeError, OSError):
            pass
        try:
            for phase, make_cases, prepare in self.phases:
                t0 = time.perf_counter()
                q = self.ready[phase]
                try:
                    for k, case in enumerate(make_cases(self.tmpdir)):
                        self._wait_go()
                        if self._stopped:
                            return
                        q.put(("case", prepare(k, case)))
                except BaseException as e:  # noqa: BLE001 (re-raised)
                    q.put(("error", e))
                self.seconds[phase] = time.perf_counter() - t0
        finally:
            self._idle.set()
            shutil.rmtree(self.tmpdir, ignore_errors=True)

    def take(self, phase, keys):
        q = self.ready[phase]
        for key in keys:
            kind, got = q.get()
            if kind == "error":
                raise got
            check(got["key"] == key, "%s: prepared case %s, want %s" % (
                phase, got["key"], key))
            yield got


def prepared(phase, keys, cases, prepare):
    """The prepared cases of ``phase`` in order: CASE_REFERENCES' when it
    prepares the phase, else each made here."""
    refs = CASE_REFERENCES
    if refs is not None and phase in refs.ready:
        return refs.take(phase, keys)
    return (prepare(k, case) for k, case in enumerate(cases))


# the running CaseReferences (main starts it), or None: each phase then
# prepares its cases itself; the phases it prepares, in the order the
# script reaches them
CASE_REFERENCES = None
CASE_PHASES = (
    ("optimizers", lambda tmpdir: optimizer_cases(),
     prepare_optimizer_case),
    ("lstm_rnn_ops", lambda tmpdir: RNN_OP_CASES, prepare_rnn_case),
    ("dense_ops", lambda tmpdir: dense_cases(), prepare_case),
    ("sequence_ops", lambda tmpdir: sequence_cases(), prepare_case),
    ("misc_ops", lambda tmpdir: misc_cases(tmpdir), prepare_case),
    ("detection_ops", lambda tmpdir: detection_cases(), prepare_case),
)


def phase_op_cases(fa, smi, phase, cases, twice, witness=None, rows=None,
                   window_n=1):
    """Each case of ``cases`` ((name, op type, a function of a
    RandomState giving the inputs: numpy arrays, torch tensors, or
    tensor arrays of them, attrs)) on the card against the same lowering
    on the CPU from the same operands, forward and, for an op with a
    grad, the vjp grads on seeded cotangents (DENSE_TOL); the ops in
    ``twice`` run twice on the card, bitwise equal; the ``witness``
    lowerings ({op type: {label: lowering}}) run beside the port's,
    their errors and ms printed; device ms of the forward and of the
    vjp, every case's in one profiler window (``window_ms``, ``window_n``
    calls each), with their kernel launches a call, the card operands kept until it (the
    OP_CPU_ROWS cases compare on their first rows, timed whole). The
    CPU side of each case (``prepare_case``) comes from CASE_REFERENCES,
    which made it beside the earlier phases, or is made here. Emits
    ``phase``'s row (its case rows also appended to ``rows``) and
    returns its flash launches (none)."""
    import torch

    import paddle_tpu_torch.fluid as fluid

    on = _on
    fluid.Executor(fluid.CUDAPlace(0))  # cuDNN's deterministic algorithms
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    rows = [] if rows is None else rows
    failed, timed, witnessed = [], [], []
    ready = prepared(phase, [(c[0], c[1]) for c in cases], cases,
                     prepare_case)
    for k, ((name, op_type, _, attrs), prep) in enumerate(
            zip(cases, ready)):
        full, cut, host = prep["full"], prep["cut"], prep["host"]
        check(not (cut and (witness or {}).get(op_type)),
              "%s: a witness compares at the compared rows" % name)
        ins = {s: [on("cuda", a) for a in v] for s, v in host.items()}
        out = lower_op(op_type, ins, attrs, "cuda")
        runs = {"cpu": prep["cpu"],
                "cuda": {"ins": ins, "out": {s: [v.cpu() for v in vs]
                                             for s, vs in out.items()}}}
        del out
        card_ins = runs["cuda"]["ins"]
        cots = prep["cots"]
        card_cots = [c.cuda() for c in cots]
        primals = prep["primals"]
        if primals:
            runs["cuda"]["grads"] = [g.cpu() for g in op_vjp(
                op_type, card_ins, attrs, "cuda", card_cots)]
        errs, off = dense_errors(runs["cpu"], primals, runs["cuda"]["out"],
                                 runs["cuda"].get("grads", []))
        failed += [[name] + o for o in off]
        exact = not any(isinstance(o[1], str) for o in off)
        row = {"case": name, "op": op_type,
               "shapes": {s: [{k: list(np.shape(x)) for k, x in a.items()}
                              if isinstance(a, dict) else list(a.shape)
                              for a in v] for s, v in host.items()},
               "max_abs_err_and_max": errs, "exact_ints": exact}
        if op_type in twice:
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
        if cut:
            # timed at the users' full shapes
            card_ins = {s: [on("cuda", a) for a in v]
                        for s, v in full.items()}
            full_out = lower_op(op_type, card_ins, attrs, "cuda")
            card_cots = [torch.randn(v.shape, device="cuda").to(v.dtype)
                         for s in sorted(full_out) for v in full_out[s]
                         if v.is_floating_point()]
            row["compared_rows"] = cut
            del full_out
        fwd = functools.partial(lower_op, op_type, card_ins, attrs, "cuda")
        vjp = functools.partial(op_vjp, op_type, card_ins, attrs, "cuda",
                                card_cots)
        timed.append(((k, "ms"), fwd))
        if primals:
            timed.append(((k, "vjp_ms"), vjp))
        for label, lowering in (witness or {}).get(op_type, {}).items():
            with lowered_by(op_type, lowering):
                out = lower_op(op_type, card_ins, attrs, "cuda")
                grads = op_vjp(op_type, card_ins, attrs, "cuda", card_cots)
            row.setdefault("witness", {})[label] = {
                "max_abs_err_and_max": dense_errors(
                    runs["cpu"], primals,
                    {s: [v.cpu() for v in vs] for s, vs in out.items()},
                    [g.cpu() for g in grads])[0]}
            witnessed.append((k, op_type, label, fwd, vjp))
            del out, grads
        rows.append(row)
        del runs, host, full, prep
        if torch.cuda.memory_allocated() > OP_CASES_RELEASE_BYTES:
            release_memory()  # a collection costs ~0.1 s a case
    # the timings: one profiler window for every case's forward and vjp,
    # then one for the witnesses (each under its own lowering)
    counts = {}
    # (no warm-up call: every call timed here ran on the card above, at
    # these shapes)
    for (k, key), ms in window_ms(timed, n=window_n, warmup=0,
                                  launches=counts).items():
        rows[k][key] = ms
        rows[k][key.replace("ms", "launches")] = counts[(k, key)]
    for k, op_type, label, fwd, vjp in witnessed:
        with lowered_by(op_type, witness[op_type][label]):
            rows[k]["witness"][label].update(
                {key[1]: ms for key, ms in window_ms(
                    [((k, "ms"), fwd), ((k, "vjp_ms"), vjp)],
                    warmup=0).items()})
    del timed, witnessed
    release_memory()
    launches = flash_launches(fa)  # ... and ends here
    emit({"phase": phase, "card": smi, "tol": DENSE_TOL,
          "ops": sorted({r["op"] for r in rows}), "cases": rows,
          "flash_launches": launches})
    check(not failed, "%s: %s" % (phase, failed[:10]))
    check(not any(launches.values()), "flash launches in %s: %s"
          % (phase, launches))
    return launches


def phase_dense_ops(fa, smi):
    """Every lowering of the dense op families (``dense_cases``) through
    ``phase_op_cases``, the DENSE_TWICE ops twice, cuDNN's transposed
    convolution beside the port's; then ``top_k``'s ranking at BERT's
    vocab logits, device ms of each way: ``torch.topk`` (ties in its own
    order, the port's until it took ``lax.top_k``'s rule), a stable
    descending sort cut to k, and the port's
    ``topk_lowest_index_first``. Returns the flash launches of the phase
    (none)."""
    import torch

    from paddle_tpu_torch.ops.common import topk_lowest_index_first

    launches = phase_op_cases(fa, smi, "dense_ops", dense_cases(),
                              DENSE_TWICE, DENSE_WITNESS)
    x = torch.as_tensor(np.random.RandomState(7).randn(1024, 30522).astype(
        np.float32), device="cuda")
    emit({"phase": "dense_ops", "card": smi, "top_k": {
        "shape": [1024, 30522], "k": 5,
        "torch_topk_ms": device_ms(lambda: torch.topk(x, 5, dim=-1), n=10),
        "stable_sort_ms": device_ms(lambda: torch.sort(
            x, dim=-1, descending=True, stable=True), n=10),
        "port_ms": device_ms(lambda: topk_lowest_index_first(x, 5),
                             n=10)}})
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


# -- sequences and beam search (ROADMAP Queue 1, step 5d) -----------------


def nmt_beam(fluid, src_dict, trg_dict, word_dim, hidden, beam_size,
             max_length, start_id, end_id, src_len):
    """The chapter-8 encoder-decoder built by ``fluid`` (either
    package's) and decoded by ``contrib.BeamSearchDecoder``. Feeds:
    ``src`` [B, src_len] ids and ``src_len`` [B, 1] lengths; the beam
    rows' ``init_ids`` and ``init_scores`` [B * beam_size, 1]
    (``start_id`` is the caller's to feed). Returns {"ids", "scores": the
    decoded sentences [B * beam, 256] and their scores [B * beam, 1];
    "encoded": the encoder's states [B, src_len, 2 * hidden], which the
    chapter's attention reads; "lattice": the decoder's ids [B * beam,
    256], scores [B * beam, 256], parents [256 * B * beam] and states
    [256 * B * beam, hidden] arrays as tensors (``tensor_array_to_tensor``),
    and "steps": their live length}."""
    del start_id  # the init_ids feed carries it
    layers = fluid.layers
    src = layers.data(name="src", shape=[src_len], dtype="int64")
    lens = layers.data(name="src_len", shape=[1], dtype="int64")
    emb = layers.embedding(src, size=[src_dict, word_dim], dtype="float32",
                           param_attr=fluid.ParamAttr(name="src_emb"))
    grus = [layers.dynamic_gru(
        layers.fc(input=emb, size=3 * hidden, num_flatten_dims=2,
                  bias_attr=False),
        size=hidden, is_reverse=reverse,
        seq_len=layers.reshape(lens, shape=[-1]))
        for reverse in (False, True)]
    encoded = layers.concat(grus, axis=2)
    boot = layers.fc(input=layers.sequence_first_step(grus[1], length=lens),
                     size=hidden, act="tanh", bias_attr=False)
    init_ids = layers.data(name="init_ids", shape=[1], dtype="int64")
    init_scores = layers.data(name="init_scores", shape=[1],
                              dtype="float32")
    # each source's boot state gathered for its beam rows, row r taking
    # source floor((r + 0.5) / beam): rows counted from init_ids keep the
    # batch dim unknown at build time, as the decoder's states need
    rows = layers.cumsum(layers.fill_constant_batch_size_like(
        init_ids, shape=[-1, 1], dtype="float32", value=1.0), axis=0,
        exclusive=True)
    source = layers.cast(layers.floor(layers.scale(
        rows, scale=1.0 / beam_size, bias=0.5 / beam_size)), "int64")
    boot = layers.gather(boot, layers.reshape(source, shape=[-1]))
    cell = fluid.contrib.StateCell(
        inputs={"x": None},
        states={"h": fluid.contrib.InitState(init=boot)}, out_state="h")

    @cell.state_updater
    def updater(c):
        gates = layers.fc(input=c.get_input("x"), size=3 * hidden,
                          bias_attr=False)
        h, _, _ = layers.gru_unit(gates, c.get_state("h"), size=3 * hidden)
        c.set_state("h", h)

    decoder = fluid.contrib.BeamSearchDecoder(
        state_cell=cell, init_ids=init_ids, init_scores=init_scores,
        target_dict_dim=trg_dict, word_dim=word_dim, sparse_emb=False,
        max_len=max_length, beam_size=beam_size, end_id=end_id)
    decoder.decode()
    ids, scores = decoder()
    arrays = (decoder._ids_array, decoder._scores_array,
              decoder._parents_array,
              cell._states_holder["h"][id(decoder)]._array)
    lattice = [layers.tensor_array_to_tensor(a, axis=axis)
               for a, axis in zip(arrays, (1, 1, 0, 0))]
    return {"ids": ids, "scores": scores, "encoded": encoded,
            "lattice": [t for t, _ in lattice], "steps": lattice[0][1]}


def nmt_beam_feed(batch, src_len, min_len, src_dict, beam_size, start_id,
                  end_id, seed, **_):
    """Sources of ``min_len``-``src_len`` words (ids past a row's length
    are ``end_id``), start ids, and initial scores 0 for each source's
    first beam and -1e9 for the others, so the beams differ."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(min_len, src_len + 1, (batch, 1)).astype(np.int64)
    src = rng.randint(2, src_dict, (batch, src_len)).astype(np.int64)
    src[np.arange(src_len)[None, :] >= lens] = end_id
    rows = batch * beam_size
    scores = np.where(np.arange(rows) % beam_size == 0, 0.0, -1e9)
    return {"src": src, "src_len": lens,
            "init_ids": np.full((rows, 1), start_id, np.int64),
            "init_scores": scores.astype(np.float32).reshape(rows, 1)}


def sentiment_conv(fluid, dict_dim, emb_dim, hid_dim, class_dim, lr,
                   seq_len, conv_pool=None):
    """Chapter 6's ``convolution_net`` built by ``fluid`` (either
    package's): an ``is_sparse`` embedding, two ``conv_pool`` branches
    (``nets.sequence_conv_pool`` of ``fluid`` by default) of filter
    sizes 3 and 4 over the rows' ``lens`` words, ``fc`` to the classes
    with softmax, cross entropy, accuracy, Adagrad. Feeds ``words`` [B,
    seq_len], ``lens`` [B, 1], ``label`` [B, 1]; returns {"loss", "acc",
    "pred"}."""
    layers = fluid.layers
    conv_pool = conv_pool or fluid.nets.sequence_conv_pool
    words = layers.data(name="words", shape=[seq_len], dtype="int64")
    lens = layers.data(name="lens", shape=[1], dtype="int64")
    label = layers.data(name="label", shape=[1], dtype="int64")
    emb = layers.embedding(words, size=[dict_dim, emb_dim], is_sparse=True)
    convs = [conv_pool(input=emb, num_filters=hid_dim, filter_size=k,
                       act="tanh", pool_type="sqrt", length=lens)
             for k in (3, 4)]
    pred = layers.fc(input=convs, size=class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=pred, label=label))
    acc = layers.accuracy(input=pred, label=label)
    fluid.optimizer.Adagrad(learning_rate=lr).minimize(loss)
    return {"loss": loss, "acc": acc, "pred": pred}


def sentiment_feed(batch, seq_len, min_len, dict_dim, seed, **_):
    """Reviews of ``min_len``-``seq_len`` synthetic word ids (0 past a
    row's length) and 0/1 labels."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(min_len, seq_len + 1, (batch, 1)).astype(np.int64)
    words = rng.randint(1, dict_dim, (batch, seq_len)).astype(np.int64)
    words[np.arange(seq_len)[None, :] >= lens] = 0
    return {"words": words, "lens": lens,
            "label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}


SRL_WORDS = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")


def srl_crf(fluid, word_dict, pred_dict, mark_dict, label_dict, word_dim,
            mark_dim, hidden_dim, depth, lr, seq_len):
    """Chapter 7's ``db_lstm`` built by ``fluid`` (either package's): the
    word and its five context words through one frozen embedding
    (``emb``), the predicate's (``vemb``) and the mark's; each through an
    ``fc`` (tanh) and summed; ``depth`` stacked ``dynamic_lstm``s (relu
    candidates, sigmoid gates and cells, alternating direction), each
    fed the sum of ``fc``s of the layer below's mix and LSTM; the label
    scores the sum of two such ``fc``s; the loss the mean of the negated
    ``linear_chain_crf`` log-likelihood (transitions ``crfw``), SGD; then
    ``crf_decoding`` and ``chunk_eval`` (IOB) for the ``for_test`` clone.
    Feeds [B, seq_len] ids ``SRL_WORDS``, ``verb``, ``mark`` and
    ``target``, and ``lens`` [B, 1]; returns {"loss", "feature",
    "path", "chunks": chunk_eval's six outputs}."""
    layers = fluid.layers

    def ids(name):
        return layers.data(name=name, shape=[seq_len], dtype="int64")

    def fc(x, size):
        return layers.fc(input=x, size=size, act="tanh", num_flatten_dims=2)

    words = [ids(n) for n in SRL_WORDS]
    verb, mark, target = ids("verb"), ids("mark"), ids("target")
    lens = layers.data(name="lens", shape=[1], dtype="int64")
    steps = layers.reshape(lens, shape=[-1])
    embs = [layers.embedding(w, size=[word_dict, word_dim],
                             param_attr=fluid.ParamAttr(name="emb",
                                                        trainable=False))
            for w in words]
    embs.append(layers.embedding(verb, size=[pred_dict, word_dim],
                                 param_attr="vemb"))
    embs.append(layers.embedding(mark, size=[mark_dict, mark_dim]))
    mix = layers.sums([fc(e, hidden_dim) for e in embs])
    lstm = None
    for i in range(depth):
        if i:
            mix = layers.sums([fc(mix, hidden_dim), fc(lstm, hidden_dim)])
        lstm, _ = layers.dynamic_lstm(
            mix, size=hidden_dim, candidate_activation="relu",
            gate_activation="sigmoid", cell_activation="sigmoid",
            is_reverse=i % 2 == 1, seq_len=steps)
    feature = layers.sums([fc(mix, label_dict), fc(lstm, label_dict)])
    crfw = fluid.ParamAttr(name="crfw")
    ll = layers.linear_chain_crf(feature, target, param_attr=crfw,
                                 length=lens)
    loss = layers.mean(layers.scale(ll, scale=-1.0))
    fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    path = layers.crf_decoding(feature, param_attr=crfw, length=lens)
    chunks = layers.chunk_eval(path, target, chunk_scheme="IOB",
                               num_chunk_types=(label_dict - 1) // 2,
                               seq_length=lens)
    return {"loss": loss, "feature": feature, "path": path,
            "chunks": list(chunks)}


def srl_feed(batch, seq_len, min_len, word_dict, pred_dict, mark_dict,
             label_dict, seed, **_):
    """Sentences of ``min_len``-``seq_len`` words: random ids of each
    input's dictionary, IOB labels, 0 past a row's length."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(min_len, seq_len + 1, (batch, 1)).astype(np.int64)
    pad = np.arange(seq_len)[None, :] >= lens
    feed = {"lens": lens}
    for name, high in [(n, word_dict) for n in SRL_WORDS] + [
            ("verb", pred_dict), ("mark", mark_dict),
            ("target", label_dict)]:
        v = rng.randint(0, high, (batch, seq_len)).astype(np.int64)
        v[pad] = 0
        feed[name] = v
    return feed


def sequence_cases():
    """(name, op type, a function of a RandomState giving the inputs,
    attrs) of the sequence_ops phase: each lowering of the sequence and
    beam-search slice at the shapes its users give it: the nmt_beam
    decoder's 48 beam rows over 30,000 words (top 50 candidates) and
    its 16 sources of 10-50 words, 512 wide; sentiment_conv's 128 reviews
    of 32-400 words, 128 wide, its 512 filters; srl_crf's 10 sentences of
    8-64 words over 59 labels; ``row_conv`` at DeepSpeech 2's lookahead
    (2 future steps) over [32, 256, 1024] and ``im2sequence`` at the OCR
    CRNN's columns ([32, 128, 6, 96] features, 6 x 1 windows)."""
    bw = NMT_BEAM_BATCH * NMT_BEAM["beam_size"]
    width, vocab, cap = NMT_BEAM["hidden"], NMT_BEAM["trg_dict"], 256
    top = min(50, vocab)  # the decoder's candidates a row

    def f(*shape, scale=1.0):
        return lambda rng: (rng.randn(*shape) * scale).astype(np.float32)

    def ins(**makers):
        return lambda rng: {slot: [m(rng) for m in ms]
                            for slot, ms in makers.items()}

    def lengths(batch, low, high):
        return lambda rng: rng.randint(low, high + 1, batch).astype(np.int64)

    def ints(high, *shape):
        return lambda rng: rng.randint(0, high, shape).astype(np.int64)

    src = lengths(NMT_BEAM_BATCH, NMT_BEAM_MIN_LEN, NMT_BEAM_SRC_LEN)
    reviews = lengths(SENTIMENT_BATCH, SENTIMENT_MIN_LEN, SENTIMENT_LEN)
    sentences = lengths(SRL_BATCH, SRL_MIN_LEN, SRL_LEN)
    review = (SENTIMENT_BATCH, SENTIMENT_LEN, SENTIMENT["emb_dim"])
    source = (NMT_BEAM_BATCH, NMT_BEAM_SRC_LEN, width)

    def beam_rows(finished):
        # the decoder's previous ids and scores, some beams finished
        def make(rng):
            ids = rng.randint(2, vocab, (bw, 1)).astype(np.int64)
            ids[rng.rand(bw) < finished] = NMT_BEAM["end_id"]
            return ids
        return make

    def candidates(rng):
        # each row's best words, accumulated log-probabilities
        ids = np.stack([rng.permutation(vocab)[:top] for _ in range(bw)])
        return ids.astype(np.int64)

    def acc_scores(rng):
        return -np.sort(rng.rand(bw, top).astype(np.float32) * 5.0 + 2.0)

    def equal_beams(rng):
        # every beam of a source the same scores, rounded: exact ties
        one = np.round(rng.randn(NMT_BEAM_BATCH, top) * 2).astype(np.float32)
        return np.repeat(one, NMT_BEAM["beam_size"], axis=0)

    def lattice(rng):
        # a finished decode's arrays: 251 live entries of 256, parents
        # within each source's beams
        n = NMT_BEAM["max_length"] + 1
        beam = NMT_BEAM["beam_size"]
        par = (np.arange(bw) // beam * beam)[None, :] + rng.randint(
            0, beam, (cap, bw))
        return {"Ids": [{"buf": rng.randint(0, vocab, (cap, bw, 1)),
                         "len": np.int32(n)}],
                "ParentIdx": [{"buf": par.astype(np.int64),
                               "len": np.int32(n)}],
                "Scores": [{"buf": rng.randn(cap, bw, 1).astype(np.float32),
                            "len": np.int32(n)}]}

    def crf(label):
        def make(rng):
            c = SRL["label_dict"]
            out = {"Emission": [f(SRL_BATCH, SRL_LEN, c)(rng)],
                   "Transition": [f(c + 2, c, scale=0.1)(rng)],
                   "Length": [sentences(rng)]}
            if label:
                out["Label"] = [ints(c, SRL_BATCH, SRL_LEN)(rng)]
            return out
        return make

    def scatter(rng):
        # a bag of words: each review's ids counted into its row
        words = rng.randint(0, SENTIMENT["dict_dim"],
                            (SENTIMENT_BATCH, SENTIMENT_LEN))
        return {"X": [np.zeros((SENTIMENT_BATCH, SENTIMENT["dict_dim"]),
                               np.float32)],
                "Ids": [words.astype(np.int64)],
                "Updates": [rng.rand(SENTIMENT_BATCH,
                                     SENTIMENT_LEN).astype(np.float32)]}

    beam = {"beam_size": NMT_BEAM["beam_size"], "end_id": NMT_BEAM["end_id"]}
    return [
        ("sequence_softmax", "sequence_softmax",
         ins(X=[f(bw, NMT_BEAM_SRC_LEN)],
             Length=[lambda rng: np.repeat(src(rng),
                                           NMT_BEAM["beam_size"])]), {}),
        ("sequence_expand", "sequence_expand",
         ins(X=[f(NMT_BEAM_BATCH, width)],
             Y=[f(NMT_BEAM_BATCH, NMT_BEAM_SRC_LEN, 2 * width)]), {}),
        ("sequence_reverse", "sequence_reverse",
         ins(X=[f(*source)], Length=[src]), {}),
        ("im2sequence", "im2sequence", ins(X=[f(32, 128, 6, 96)]),
         {"kernels": [6, 1], "strides": [1, 1], "paddings": [0, 0, 0, 0]}),
        ("sequence_concat", "sequence_concat",
         ins(X=[f(*source), f(*source)], Length=[src, src]), {}),
        ("sequence_slice", "sequence_slice",
         ins(X=[f(*review)], Offset=[lengths(SENTIMENT_BATCH, 0, 16)],
             Length=[lengths(SENTIMENT_BATCH, 16, 384)]), {}),
        ("sequence_expand_as", "sequence_expand_as",
         ins(X=[f(NMT_BEAM_BATCH, 2 * width)],
             Y=[f(NMT_BEAM_BATCH, NMT_BEAM_SRC_LEN, 1)]), {}),
        ("sequence_pad", "sequence_pad",
         ins(X=[f(*review)], Length=[reviews],
             PadValue=[lambda rng: np.array([0.0], np.float32)]),
         {"padded_length": SENTIMENT_LEN}),
        ("sequence_unpad", "sequence_unpad",
         ins(X=[f(*review)], Length=[reviews]), {}),
        ("sequence_conv_3", "sequence_conv",
         ins(X=[f(*review)], Length=[reviews],
             Filter=[f(3 * review[2], SENTIMENT["hid_dim"], scale=0.05)]),
         {"contextLength": 3, "contextStart": -1, "contextStride": 1}),
        ("sequence_conv_4", "sequence_conv",
         ins(X=[f(*review)], Length=[reviews],
             Filter=[f(4 * review[2], SENTIMENT["hid_dim"], scale=0.05)]),
         {"contextLength": 4, "contextStart": -1, "contextStride": 1}),
        ("sequence_enumerate", "sequence_enumerate",
         ins(X=[ints(SENTIMENT["dict_dim"], SENTIMENT_BATCH,
                     SENTIMENT_LEN)], Length=[reviews]),
         {"win_size": 3, "pad_value": 0}),
        ("row_conv", "row_conv",
         ins(X=[f(32, 256, 1024)], Filter=[f(3, 1024)]), {}),
        ("lstm_unit", "lstm_unit",
         ins(X=[f(bw, 4 * width)], C_prev=[f(bw, width)]),
         {"forget_bias": 0.0}),
        ("gru_unit", "gru_unit",
         ins(Input=[f(bw, 3 * width)], HiddenPrev=[f(bw, width)],
             Weight=[f(width, 3 * width, scale=0.05)],
             Bias=[f(1, 3 * width)]), {}),
        ("linear_chain_crf", "linear_chain_crf", crf(True), {}),
        ("crf_decoding", "crf_decoding", crf(False), {}),
        ("crf_decoding_label", "crf_decoding", crf(True), {}),
        ("sequence_reshape", "sequence_reshape", ins(X=[f(*review)]),
         {"new_dim": 2 * review[2]}),
        ("sequence_scatter", "sequence_scatter", scatter, {}),
        ("tensor_array_to_tensor", "tensor_array_to_tensor",
         ins(X=[lambda rng: {"buf": f(cap, bw, width)(rng),
                             "len": np.int32(NMT_BEAM["max_length"] + 1)}]),
         {"axis": 0}),
        ("beam_search", "beam_search",
         ins(pre_ids=[beam_rows(0.2)], pre_scores=[f(bw, 1)],
             ids=[candidates], scores=[acc_scores]), dict(beam)),
        ("beam_search_probabilities", "beam_search",
         ins(pre_ids=[beam_rows(0.2)], pre_scores=[f(bw, 1)],
             ids=[candidates],
             scores=[lambda rng: rng.rand(bw, top).astype(np.float32)]),
         dict(beam, is_accumulated=False)),
        ("beam_search_first_step", "beam_search",
         ins(pre_ids=[beam_rows(0.0)], pre_scores=[f(bw, 1)],
             ids=[candidates], scores=[acc_scores]),
         dict(beam, first_step=True)),
        ("beam_search_equal_beams", "beam_search",
         ins(pre_ids=[beam_rows(0.0)],
             pre_scores=[lambda rng: np.zeros((bw, 1), np.float32)],
             ids=[candidates], scores=[equal_beams]), dict(beam)),
        ("beam_search_decode", "beam_search_decode", lattice, dict(beam)),
    ]


def phase_sequence_ops(fa, smi):
    """Every lowering of the sequence and beam-search slice
    (``sequence_cases``) through ``phase_op_cases``, ``sequence_scatter``
    twice. Returns the flash launches of the phase (none)."""
    return phase_op_cases(fa, smi, "sequence_ops", sequence_cases(),
                          SEQUENCE_TWICE)


def decoder_params(main):
    """{role: parameter name} of the decode loop's layers in an
    ``nmt_beam`` program, which ``BeamSearchDecoder.decode`` names: the
    target embedding, the cell's input projection, the ``gru_unit``'s
    weight and bias, and the output ``fc``'s weight and bias."""
    ops = [op for b in main.desc.blocks[1:] for op in b.ops]
    muls = [op for op in ops if op.type == "mul"]
    gru = next(op for op in ops if op.type == "gru_unit")
    out_add = next(op for op in ops if op.type == "elementwise_add"
                   and op.inputs["X"] == muls[1].outputs["Out"])
    return {"trg_emb": next(op for op in ops
                            if op.type == "lookup_table").inputs["W"][0],
            "cell_w": muls[0].inputs["Y"][0],
            "gru_w": gru.inputs["Weight"][0], "gru_b": gru.inputs["Bias"][0],
            "out_w": muls[1].inputs["Y"][0], "out_b": out_add.inputs["Y"][0]}


def nmt_beam_step(fluid, names, trg_dict, word_dim, hidden, beam_size,
                  end_id, topk_size=50, **_):
    """One step of ``nmt_beam``'s decode loop as a flat program of
    ``fluid`` over the decode's parameters ``names``
    (``decoder_params``), the layers ``BeamSearchDecoder.decode`` appends
    in its loop: feeds ``prev_ids`` and ``prev_scores`` [B * beam, 1]
    and the state ``h`` [B * beam, hidden]; returns [the selected ids,
    their scores, the parent rows, the next state]."""
    layers = fluid.layers

    def attr(role):
        return fluid.ParamAttr(name=names[role])

    prev_ids = layers.data(name="prev_ids", shape=[1], dtype="int64")
    prev_scores = layers.data(name="prev_scores", shape=[1],
                              dtype="float32")
    h = layers.data(name="h", shape=[hidden], dtype="float32")
    x = layers.embedding(prev_ids, size=[trg_dict, word_dim],
                         dtype="float32", param_attr=attr("trg_emb"))
    gates = layers.fc(input=x, size=3 * hidden, bias_attr=False,
                      param_attr=attr("cell_w"))
    h, _, _ = layers.gru_unit(gates, h, size=3 * hidden,
                              param_attr=attr("gru_w"),
                              bias_attr=attr("gru_b"))
    probs = layers.fc(input=h, size=trg_dict, act="softmax",
                      param_attr=attr("out_w"), bias_attr=attr("out_b"))
    top_scores, top_ids = layers.topk(probs, k=min(topk_size, trg_dict))
    acc = layers.elementwise_add(
        x=layers.log(top_scores),
        y=layers.reshape(prev_scores, shape=[-1, 1]), axis=0)
    ids, scores, parents = layers.beam_search(
        prev_ids, prev_scores, top_ids, acc, beam_size, end_id=end_id,
        return_parent_idx=True)
    return [ids, scores, parents,
            layers.gather(h, layers.reshape(parents, shape=[-1]))]


def lattice_step(lattice, k, rows):
    """The operands of decode step ``k`` from ``nmt_beam``'s lattice (its
    arrays as host arrays, ``rows`` beam rows): {prev_ids, prev_scores,
    h} and the step's results [ids, scores, parents, next state]."""
    ids, scores, parents, states = lattice
    feed = {"prev_ids": ids[:, k:k + 1], "prev_scores": scores[:, k:k + 1],
            "h": states[k * rows:(k + 1) * rows]}
    return feed, [ids[:, k + 1:k + 2], scores[:, k + 1:k + 2],
                  parents[(k + 1) * rows:(k + 2) * rows],
                  states[(k + 1) * rows:(k + 2) * rows]]


def loop_host_ms(run):
    """Host ms of one call of ``run`` spent in the engine's ``run_op`` on
    the ops of sub-blocks (a loop's body), each op's own time (its nested
    sub-block ops' taken out), summed by op type; garbage is collected
    first, so that no collection of earlier objects lands in an op."""
    from paddle_tpu_torch.engine import lowering

    totals, stack = {}, []
    run_op = lowering.run_op

    def timed(op, block, *args, **kwargs):
        stack.append(0.0)
        t0 = time.perf_counter()
        try:
            return run_op(op, block, *args, **kwargs)
        finally:
            spent = time.perf_counter() - t0
            nested = stack.pop()
            if stack:
                stack[-1] += spent
            if block.idx != 0:
                totals[op.type] = (totals.get(op.type, 0.0)
                                   + (spent - nested) * 1e3)

    gc.collect()
    lowering.run_op = timed
    try:
        run()
    finally:
        lowering.run_op = run_op
    return totals


def phase_nmt_beam(fa, smi):
    """The chapter-8 encoder-decoder (NMT_BEAM) decoding 16 sources into
    3 beams of 250 words through ``Executor.run`` on the ``for_test``
    clone (its ``while`` block eager): the decode twice, bitwise equal;
    one loop step (NMT_BEAM_PROBE_STEP) as a flat program replayed op by
    op on the card's own operands from the lattice (DENSE_TOL; ``top_k``
    and ``beam_search`` exact); ``beam_search_decode`` on the card's
    arrays equal to the CPU's and to the decode's; at batch 2 the steps
    equal to a CPU decode (printed); the decode's ms, target tokens/s,
    launches and host ms a step, idle share. Returns the flash launches
    of the path (none)."""
    import torch
    from torch.autograd import DeviceType

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert, unique_name
    from paddle_tpu_torch import observability as obs

    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            h = nmt_beam(fluid, src_len=NMT_BEAM_SRC_LEN, **NMT_BEAM)
    main.random_seed = startup.random_seed = 2024
    test_prog = main.clone(for_test=True)
    fetch = [h["ids"], h["scores"], h["encoded"], h["steps"]] + h["lattice"]
    feed = nmt_beam_feed(NMT_BEAM_BATCH, NMT_BEAM_SRC_LEN, NMT_BEAM_MIN_LEN,
                         seed=61, **NMT_BEAM)
    rows = NMT_BEAM_BATCH * NMT_BEAM["beam_size"]
    steps = NMT_BEAM["max_length"]
    exe, scope = fresh(startup)
    state0 = {v.name: scope.get(v.name).cpu().numpy()
              for v in main.list_vars() if v.persistable}

    def decode(f=feed):
        with fluid.scope_guard(scope):
            return exe.run(test_prog, feed=f, fetch_list=fetch)

    obs.set_enabled(True)
    obs.reset()
    torch.cuda.synchronize()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    t0 = time.perf_counter()
    first = decode()
    first_s = time.perf_counter() - t0
    second = decode()
    torch.cuda.synchronize()
    launches = flash_launches(fa)  # ... and ends here
    eager_runs = obs.counter_value("engine.eager_runs")
    obs.set_enabled(None)
    ids, scores, encoded, n, *lattice = first
    n = int(n.reshape(-1)[0])
    same = all(np.array_equal(a, b) for a, b in zip(first, second))
    row = {"phase": "nmt_beam", "card": smi, "config": NMT_BEAM,
           "batch": NMT_BEAM_BATCH, "src_len": NMT_BEAM_SRC_LEN,
           "beam_rows": rows, "lattice_steps": n,
           "first_decode_s": first_s, "eager_runs": eager_runs,
           "twice_bitwise_equal": same, "flash_launches": launches,
           "sentence_ids_head": ids[:3, :12].tolist(),
           "sentence_scores_head": scores[:6].ravel().tolist()}
    emit(row)
    check(same, "nmt_beam: the decode twice differs")
    check(n == steps + 1 and ids.shape == (rows, 256)
          and (ids[:, 0] == NMT_BEAM["start_id"]).all()
          and ((ids >= 0) & (ids < NMT_BEAM["trg_dict"])).all()
          and np.isfinite(scores).all() and np.isfinite(encoded).all()
          and encoded.shape == (NMT_BEAM_BATCH, NMT_BEAM_SRC_LEN,
                                2 * NMT_BEAM["hidden"]),
          "nmt_beam: the decode's outputs: %s" % row)
    check(eager_runs >= 2, "nmt_beam: the while block ran %d times eagerly"
          % eager_runs)
    check(not any(launches.values()), "flash launches in nmt_beam: %s"
          % launches)

    # one loop step as a flat program, op by op on the card's operands
    names = decoder_params(main)
    with unique_name.guard():
        step_main, step_startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(step_main, step_startup):
            step_out = nmt_beam_step(fluid, names, **NMT_BEAM)
    k = NMT_BEAM_PROBE_STEP
    step_feed, step_next = lattice_step(lattice, k, rows)
    worst, env, _ = replay_ops_on_card(
        step_main, {r: state0[r] for r in names.values()}, step_feed,
        DENSE_TOL)
    exact = {t: worst.get(t, 0.0) for t in ("top_k", "beam_search")}
    cpu_next = [env[v.name].numpy() for v in step_out]
    emit({"phase": "nmt_beam", "probe_step": k, "ops_rel_to_max": worst,
          "tol": DENSE_TOL, "exact": exact,
          "cpu_step_equals_card_lattice": {
              part: bool(np.array_equal(a.reshape(-1), b.reshape(-1)))
              for part, a, b in zip(("ids", "scores", "parents", "state"),
                                    cpu_next, step_next)}})
    check(not any(exact.values()),
          "nmt_beam: top_k or beam_search not exact on the card: %s" % exact)

    # beam_search_decode on the card's arrays, card and CPU
    ids_l, scores_l, parents_l, _ = lattice
    cap = ids_l.shape[1]
    arrays = {"Ids": ids_l.T.reshape(cap, rows, 1),
              "ParentIdx": parents_l.reshape(cap, rows),
              "Scores": scores_l.T.reshape(cap, rows, 1)}
    back = {}
    for device in ("cuda", "cpu"):
        ins = {s: [{"buf": torch.as_tensor(np.ascontiguousarray(a),
                                           device=device),
                    "len": torch.tensor(n, dtype=torch.int32,
                                        device=device)}]
               for s, a in arrays.items()}
        out = lower_op("beam_search_decode", ins, {
            "beam_size": NMT_BEAM["beam_size"],
            "end_id": NMT_BEAM["end_id"]}, device)
        back[device] = [out["sentence_ids"][0].cpu().numpy(),
                        out["sentence_scores"][0].cpu().numpy()]
    backtrack = {"card_equals_cpu": all(np.array_equal(a, b) for a, b in
                                        zip(back["cuda"], back["cpu"])),
                 "equals_decode": bool(np.array_equal(back["cuda"][0], ids)
                                       and np.array_equal(back["cuda"][1],
                                                          scores))}
    emit({"phase": "nmt_beam", "beam_search_decode": backtrack})
    check(all(backtrack.values()), "nmt_beam: backtrack %s" % backtrack)

    # times: the decode's wall, its launches and idle share (profiler),
    # the host time of its loop's ops
    gc.collect()
    wall = timed_runs(decode, n=1, warmup=0)
    prof = profiled(decode)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    _, _, active, _ = device_intervals(prof)
    host = loop_host_ms(decode)
    ms = wall["median_ms"]
    emit({"phase": "times", "card": smi, "profile": "nmt_beam decode",
          "beam_rows": rows, "steps": steps, "decode_ms": wall,
          "ms_per_step": ms / steps,
          "target_tokens_per_s": rows * steps / (ms / 1e3),
          "launches_per_step": sum(e.count for e in kernels) / steps,
          "device_busy_ms": active, "device_idle_share": 1.0 - active / ms,
          "loop_ops_host_ms_per_step": sum(host.values()) / steps,
          "loop_ops_host_ms_per_step_by_op": {
              t: v / steps for t, v in sorted(host.items(),
                                              key=lambda kv: -kv[1])[:12]},
          "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3]
                             for e in kernels[:8]]})

    # batch 2 on the card and on the CPU from the same state
    feed2 = nmt_beam_feed(NMT_BEAM_CPU_BATCH, NMT_BEAM_SRC_LEN,
                          NMT_BEAM_MIN_LEN, seed=62, **NMT_BEAM)
    card2 = decode(feed2)
    cpu_scope = fluid.Scope()
    convert.load_numpy_state(cpu_scope, state0, "cpu", program=main)
    with fluid.scope_guard(cpu_scope):
        cpu2 = fluid.Executor(fluid.CPUPlace()).run(test_prog, feed=feed2,
                                                    fetch_list=fetch[:2])
    agree = (card2[0] == cpu2[0]).all(axis=0)[:steps + 1]
    emit({"phase": "nmt_beam", "cpu_decode": {
        "batch": NMT_BEAM_CPU_BATCH, "steps_equal": int(agree.sum()),
        "of": steps + 1, "first_step_differing": int(np.argmin(agree))
        if not agree.all() else None,
        "scores_max_abs_diff": float(np.abs(card2[1] - cpu2[1]).max())}})
    del exe, scope, cpu_scope
    release_memory()
    return launches


def card_cpu_step(main, state0, loss, feed):
    """One training step of ``main`` from ``state0`` on the card and on
    the CPU: the loss and every parameter grad of each; returns the row
    and whether it holds TRAIN_TOL."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert

    grads = [p.name + "@GRAD" for p in main.all_parameters()
             if p.trainable]
    outs = {}
    for device, place in (("cuda", fluid.CUDAPlace(0)),
                          ("cpu", fluid.CPUPlace())):
        scope = fluid.Scope()
        convert.load_numpy_state(scope, state0, device, program=main)
        with fluid.scope_guard(scope):
            outs[device] = fluid.Executor(place).run(
                main, feed=feed, fetch_list=[loss.name] + grads)
    card, cpu = outs["cuda"], outs["cpu"]
    want = float(cpu[0].reshape(-1)[0])
    loss_err = abs(float(card[0].reshape(-1)[0]) - want)
    rel = {n: float(np.abs(a - b).max() / (np.abs(b).max() or 1.0))
           for n, a, b in zip(grads, card[1:], cpu[1:])}
    ok = loss_err <= TRAIN_TOL["loss_rtol"] * abs(want) and all(
        d <= TRAIN_TOL["grad_rel_to_max"] for d in rel.values())
    return {"loss_card": float(card[0].reshape(-1)[0]), "loss_cpu": want,
            "loss_abs_err": loss_err, "grad_rel_to_max": rel,
            "tol": TRAIN_TOL}, ok


def eager_step_peak(exe, scope, main, loss, feed):
    """Bytes one eager step of ``main`` allocates above what was held
    before it (the peak)."""
    import torch

    import paddle_tpu_torch.fluid as fluid

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with fluid.scope_guard(scope):
        exe.run(main, feed=feed, fetch_list=[loss])
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def lockstep_checks(phase, losses, unequal, entries, eager_runs, launches):
    """The checks of a ``lockstep_steps`` run: finite losses, captured
    and eager equal step by step, one graph captured once, no eager
    block, no flash launch."""
    check(all(np.isfinite(losses["captured"])), "%s losses %s"
          % (phase, losses))
    check(losses["captured"] == losses["eager"] and not unequal,
          "%s: captured and eager steps differ: losses %s, state %s"
          % (phase, losses, unequal[:5]))
    check(len(entries) == 1 and entries[0].captures == 1
          and eager_runs == 0, "%s: %d graphs, captures %s, %d eager runs"
          % (phase, len(entries), [c.captures for c in entries],
             eager_runs))
    check(not any(launches.values()), "flash launches in %s: %s"
          % (phase, launches))


def phase_sentiment_conv(fa, smi):
    """Chapter 6's convolution_net (SENTIMENT) at batch 128 over reviews
    of 32-400 words: SENTIMENT_STEPS Adagrad steps eagerly and captured
    from the same state, bitwise equal, one graph; one step at batch 2
    against the CPU (TRAIN_TOL); step ms, examples/s, idle share, an
    eager step's peak memory. Returns the flash launches (none)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import unique_name

    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            h = sentiment_conv(fluid, seq_len=SENTIMENT_LEN, **SENTIMENT)
    main.random_seed = startup.random_seed = 2024
    loss = h["loss"]
    feed = sentiment_feed(SENTIMENT_BATCH, SENTIMENT_LEN, SENTIMENT_MIN_LEN,
                          seed=71, **SENTIMENT)
    (eager, graph, losses, unequal, eager_runs, launches,
     walls) = lockstep_steps(fa, main, startup, loss, feed, SENTIMENT_STEPS)
    entries = captured(graph[0].engine)
    emit({"phase": "sentiment_conv", "card": smi, "config": SENTIMENT,
          "batch": SENTIMENT_BATCH, "seq_len": SENTIMENT_LEN,
          "words": int(feed["lens"].sum()), "losses": losses,
          "unequal_state": unequal[:10], "graphs": len(entries),
          "eager_runs": eager_runs, "launches": launches,
          "captured_run_walls_ms": walls})
    lockstep_checks("sentiment_conv", losses, unequal, entries, eager_runs,
                    launches)
    peak = eager_step_peak(eager[0], eager[1], main, loss, feed)
    cap = profiled_step(graph[0], graph[1], main, loss, feed)
    emit(dict({"phase": "times", "card": smi,
               "profile": "sentiment_conv training step", "run": "captured",
               "batch": SENTIMENT_BATCH,
               "examples_per_s": SENTIMENT_BATCH / (cap["median_ms"] / 1e3),
               "eager_step_peak_bytes": peak}, **cap))
    del eager, graph, entries
    release_memory()
    state0 = start_state(main, startup)
    row, ok = card_cpu_step(main, state0, loss, sentiment_feed(
        2, SENTIMENT_LEN, SENTIMENT_MIN_LEN, seed=72, **SENTIMENT))
    emit({"phase": "sentiment_conv", "cpu_step": row})
    check(ok, "sentiment_conv: card vs CPU step %s" % row)
    release_memory()
    return launches


def phase_srl_crf(fa, smi):
    """Chapter 7's db_lstm under a linear-chain CRF (SRL) at batch 10
    over sentences of 8-64 words: SRL_STEPS SGD steps eagerly and
    captured from the same state, bitwise equal, one graph; one step at
    batch 2 op by op against the CPU (RNN_OP_TOL); on the ``for_test``
    clone ``crf_decoding``'s paths equal to the CPU's on the card's
    emissions and ``crfw``, and ``chunk_eval``'s counts equal to the
    CPU's; step ms, tokens/s, launches a step, idle share. Returns the
    flash launches (none)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import unique_name

    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            h = srl_crf(fluid, seq_len=SRL_LEN, **SRL)
    main.random_seed = startup.random_seed = 2024
    loss = h["loss"]
    feed = srl_feed(SRL_BATCH, SRL_LEN, SRL_MIN_LEN, seed=81, **SRL)
    (eager, graph, losses, unequal, eager_runs, launches,
     walls) = lockstep_steps(fa, main, startup, loss, feed, SRL_STEPS)
    entries = captured(graph[0].engine)
    emit({"phase": "srl_crf", "card": smi, "config": SRL,
          "batch": SRL_BATCH, "seq_len": SRL_LEN,
          "words": int(feed["lens"].sum()), "losses": losses,
          "unequal_state": unequal[:10], "graphs": len(entries),
          "eager_runs": eager_runs, "launches": launches,
          "captured_run_walls_ms": walls})
    lockstep_checks("srl_crf", losses, unequal, entries, eager_runs,
                    launches)
    # one step profiled: it launches 69 K kernels
    cap = profiled_step(graph[0], graph[1], main, loss, feed,
                        profiled_steps=1)
    emit(dict({"phase": "times", "card": smi,
               "profile": "srl_crf training step", "run": "captured",
               "batch": SRL_BATCH,
               "tokens_per_s": int(feed["lens"].sum())
               / (cap["median_ms"] / 1e3),
               "padded_tokens_per_s": SRL_BATCH * SRL_LEN
               / (cap["median_ms"] / 1e3)}, **cap))

    # the for_test clone: the Viterbi paths and the chunk counts against
    # the CPU's lowerings on the card's emissions
    test_prog = main.clone(for_test=True)
    exe, scope = graph
    with fluid.scope_guard(scope):
        feature, path, *chunks = exe.run(
            test_prog, feed=feed,
            fetch_list=[h["feature"], h["path"]] + h["chunks"])
    lens = torch.as_tensor(feed["lens"])
    cpu_path = lower_op("crf_decoding", {
        "Emission": [torch.as_tensor(feature)],
        "Transition": [scope.get("crfw").cpu()], "Length": [lens]}, {},
        "cpu")["ViterbiPath"][0].numpy()
    cpu_chunks = lower_op("chunk_eval", {
        "Inference": [torch.as_tensor(path)],
        "Label": [torch.as_tensor(feed["target"])], "SeqLength": [lens]},
        {"chunk_scheme": "IOB", "num_chunk_types": (SRL["label_dict"] - 1)
         // 2, "excluded_chunk_types": []}, "cpu")
    counts = [int(np.asarray(c).reshape(-1)[0]) for c in chunks[3:]]
    cpu_counts = [int(cpu_chunks[s][0].reshape(-1)[0]) for s in (
        "NumInferChunks", "NumLabelChunks", "NumCorrectChunks")]
    decode = {"paths_equal_cpu": bool(np.array_equal(path, cpu_path)),
              "chunk_counts": counts, "chunk_counts_cpu": cpu_counts,
              "precision_recall_f1": [float(np.asarray(c).reshape(-1)[0])
                                      for c in chunks[:3]]}
    emit({"phase": "srl_crf", "decode": decode})
    check(decode["paths_equal_cpu"] and counts == cpu_counts,
          "srl_crf: crf_decoding or chunk_eval off the CPU's: %s" % decode)
    del eager, graph, entries, exe, scope
    release_memory()

    # one step at batch 2, op by op against the CPU
    state0 = start_state(main, startup)
    worst, _, _ = replay_ops_on_card(
        main, state0, srl_feed(2, SRL_LEN, SRL_MIN_LEN, seed=82, **SRL),
        RNN_OP_TOL)
    emit({"phase": "srl_crf", "cpu_ops_rel_to_max": worst,
          "tol": RNN_OP_TOL})
    release_memory()
    return launches


# -- the misc op family (ROADMAP Queue 1, step 5e) ------------------------


def _conv3d_transpose_cudnn(ctx, ins, attrs):
    """cuDNN's float32 transposed 3-D convolution
    (``F.conv_transpose3d``): the witness run beside the port's lowering,
    which sums in float64."""
    import torch.nn.functional as F

    return {"Output": [F.conv_transpose3d(
        ins["Input"][0], ins["Filter"][0],
        stride=tuple(attrs.get("strides", [1, 1, 1])),
        padding=tuple(attrs.get("paddings", [0, 0, 0])),
        dilation=tuple(attrs.get("dilations", [1, 1, 1])),
        groups=attrs.get("groups", 1))]}


def _conv3d_transpose_float64(ctx, ins, attrs):
    """``F.conv_transpose3d`` on float64 operands, rounded once: the one
    call that sums as the port's lowering does (its GEMM and strided slab
    adds), run beside it."""
    import torch.nn.functional as F

    x, w = ins["Input"][0], ins["Filter"][0]
    return {"Output": [F.conv_transpose3d(
        x.double(), w.double(),
        stride=tuple(attrs.get("strides", [1, 1, 1])),
        padding=tuple(attrs.get("paddings", [0, 0, 0])),
        dilation=tuple(attrs.get("dilations", [1, 1, 1])),
        groups=attrs.get("groups", 1)).to(x.dtype)]}


MISC_WITNESS = {"conv3d_transpose": {
    "cudnn_float32": _conv3d_transpose_cudnn,
    "float64_call": _conv3d_transpose_float64}}


def _np_tanh(x):
    return np.tanh(x)


def _np_tanh_grad(x, dout):
    return (1.0 - np.tanh(x) ** 2) * dout


def random_trees(rng, batch, nodes):
    """[batch, nodes - 1, 2] 1-based parent->child edges of random trees
    (each node's parent an earlier node), each sample cut to a random
    node count and zero-terminated, as ``tree_conv`` reads them."""
    edges = np.zeros((batch, nodes - 1, 2), np.int32)
    for b in range(batch):
        n = rng.randint(nodes // 2, nodes + 1)
        child = np.arange(2, n + 1)
        edges[b, :n - 1, 0] = [rng.randint(1, c) for c in child]
        edges[b, :n - 1, 1] = child
    return edges


def misc_cases(tmpdir):
    """(name, op type, a function of a RandomState giving the inputs as
    numpy arrays, attrs) of the misc_ops phase: every lowering of the
    misc family at the shapes its users give it: the skip-gram trainer's
    heads at 692K words, C3D's convolutions and pools, a 3-D U-Net's
    up-convolution, R-FCN's position-sensitive pooling, a spatial
    transformer on 224 x 224 images, a CTC head over 5000 classes, and
    the rest at their models' widths. ``py_func`` calls a numpy tanh
    registered in the port, ``load_value`` reads a ``.npy`` file written
    under ``tmpdir``."""
    from paddle_tpu_torch.ops import misc_ops

    def f(*shape, scale=1.0):
        return lambda rng: (np.random.default_rng(rng.randint(2 ** 31))
                            .standard_normal(shape, dtype=np.float32)
                            * np.float32(scale))

    def relu(*shape):
        return lambda rng: np.maximum(f(*shape)(rng), 0.0)

    def ins(**makers):
        return lambda rng: {slot: [m(rng) for m in ms]
                            for slot, ms in makers.items()}

    def ints(low, high, *shape, dtype=np.int64):
        return lambda rng: rng.randint(low, high, shape).astype(dtype)

    def probs(*shape):
        def make(rng):
            p = np.abs(rng.randn(*shape)) + 0.05
            return (p / p.sum(-1, keepdims=True)).astype(np.float32)
        return make

    def binary(*shape):
        return lambda rng: rng.randint(0, 2, shape).astype(np.float32)

    def signs(*shape):
        return lambda rng: (2 * rng.randint(0, 2, shape) - 1).astype(
            np.float32)

    def const(value):
        return lambda rng: value

    vocab, dim, batch = SKIPGRAM["vocab"], SKIPGRAM["dim"], SKIPGRAM_BATCH

    def rfcn_rois(rng):
        # 300 proposals in a 600 x 800 image
        xy = rng.uniform(0, [700, 500], (300, 2))
        wh = rng.uniform(16, 300, (300, 2))
        return np.concatenate([xy, np.minimum(xy + wh, [799, 599])],
                              1).astype(np.float32)

    def stn_theta(rng):
        eye = np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32),
                      (8, 1, 1))
        return (eye + 0.1 * rng.randn(8, 2, 3)).astype(np.float32)

    def stn_grid(rng):
        ys, xs = np.meshgrid(np.linspace(-1, 1, 224), np.linspace(-1, 1, 224),
                             indexing="ij")
        base = np.stack([xs, ys, np.ones_like(xs)], -1)
        return np.einsum("hwk,njk->nhwj", base, stn_theta(rng)).astype(
            np.float32)

    def teacher_labels(rng):
        # clicks (0, 1) and teachers' scores outside [0, 1]
        lab = rng.randint(0, 2, (2048, 1)).astype(np.float32)
        soft = rng.uniform(-2, 3, (2048, 1)).astype(np.float32)
        return np.where(rng.rand(2048, 1) < 0.3, soft, lab)

    def with_inf(rng):
        x = f(30522, 768)(rng)
        x[1234, 56] = np.inf
        return x

    tanh_id = misc_ops.register_py_func(_np_tanh)
    tanh_grad_id = misc_ops.register_py_func(_np_tanh_grad)
    py_attrs = {"func_id": tanh_id, "backward_func_id": tanh_grad_id,
                "out_shapes": [[batch, dim]], "out_dtypes": ["float32"]}
    load_path = os.path.join(tmpdir, "emb.npy")
    np.save(load_path, np.random.RandomState(7).randn(5000, 512).astype(
        np.float32))
    c3d_pool = {"pooling_type": "max", "global_pooling": False,
                "exclusive": True}
    cases = [
        # the skip-gram trainer's heads (SKIPGRAM)
        ("nce_skipgram", "nce",
         ins(Input=[f(batch, dim)], Label=[ints(0, vocab, batch, 1)],
             Weight=[f(vocab, dim, scale=0.05)],
             Bias=[f(vocab, 1, scale=0.05)]),
         {"num_total_classes": vocab, "num_neg_samples": SKIPGRAM["neg"],
          "seed": 0}),
        ("hsigmoid_skipgram", "hierarchical_sigmoid",
         ins(X=[f(batch, dim)], W=[f(vocab - 1, dim, scale=0.05)],
             Label=[ints(0, vocab, batch, 1)],
             Bias=[f(vocab - 1, 1, scale=0.05)]),
         {"num_classes": vocab}),
        # C3D's first and widest convolutions and its pools, batch 8
        ("conv3d_c3d_conv1", "conv3d",
         ins(Input=[f(8, 3, 16, 112, 112)],
             Filter=[f(64, 3, 3, 3, 3, scale=0.1)]),
         {"strides": [1, 1, 1], "paddings": [1, 1, 1],
          "dilations": [1, 1, 1], "groups": 1}),
        ("conv3d_c3d_conv4b", "conv3d",
         ins(Input=[relu(8, 512, 4, 14, 14)],
             Filter=[f(512, 512, 3, 3, 3, scale=0.02)]),
         {"strides": [1, 1, 1], "paddings": [1, 1, 1],
          "dilations": [1, 1, 1], "groups": 1}),
        ("pool3d_c3d_pool1", "pool3d", ins(X=[relu(8, 64, 16, 112, 112)]),
         dict(c3d_pool, ksize=[1, 2, 2], strides=[1, 2, 2],
              paddings=[0, 0, 0])),
        ("pool3d_c3d_pool5", "pool3d", ins(X=[relu(8, 512, 2, 7, 7)]),
         dict(c3d_pool, ksize=[2, 2, 2], strides=[2, 2, 2],
              paddings=[0, 1, 1])),
        ("pool3d_avg_overlapping", "pool3d", ins(X=[f(8, 64, 16, 56, 56)]),
         {"ksize": [3, 3, 3], "strides": [2, 2, 2], "paddings": [1, 1, 1],
          "pooling_type": "avg", "exclusive": True}),
        # a 3-D U-Net decoder stage: 256 -> 128 channels, x2 up
        ("conv3d_transpose_unet", "conv3d_transpose",
         ins(Input=[f(2, 256, 8, 32, 32)],
             Filter=[f(256, 128, 2, 2, 2, scale=0.05)]),
         {"strides": [2, 2, 2], "paddings": [0, 0, 0], "groups": 1}),
        # R-FCN's head: 7 x 7 bins of 21 classes, 300 RoIs, stride 16
        ("psroi_pool_rfcn", "psroi_pool",
         ins(X=[f(1, 21 * 49, 38, 50)], ROIs=[rfcn_rois],
             RoisBatchIdx=[ints(0, 1, 300)]),
         {"output_channels": 21, "pooled_height": 7, "pooled_width": 7,
          "spatial_scale": 1.0 / 16}),
        # a spatial transformer on 224 x 224 images, batch 8
        ("affine_grid_stn", "affine_grid", ins(Theta=[stn_theta]),
         {"output_shape": [8, 3, 224, 224]}),
        ("grid_sampler_stn", "grid_sampler",
         ins(X=[f(8, 3, 224, 224)], Grid=[stn_grid]), {}),
        # a CTC head: 32 utterances of 200 frames over 5000 classes
        ("ctc_greedy_decoder_head", "ctc_greedy_decoder",
         ins(Input=[f(32, 200, 5000)]), {"blank": 0}),
        # TBCNN over programs' syntax trees: 32 trees of up to 128 nodes
        ("tree_conv_tbcnn", "tree_conv",
         ins(NodesVector=[f(32, 128, 64)],
             EdgeSet=[lambda rng: random_trees(rng, 32, 128)],
             Filter=[f(64, 3, 256, 1, scale=0.1)]), {"max_depth": 2}),
        ("cos_sim_word_vectors", "cos_sim",
         ins(X=[f(batch, dim)], Y=[f(batch, dim)]), {}),
        ("affine_channel_frozen_bn", "affine_channel",
         ins(X=[f(32, 256, 56, 56)], Scale=[f(256)], Bias=[f(256)]),
         {"data_layout": "NCHW"}),
        ("shuffle_channel_shufflenet_v2", "shuffle_channel",
         ins(X=[f(32, 232, 28, 28)]), {"group": 2}),
        ("space_to_depth_yolo_reorg", "space_to_depth",
         ins(X=[f(32, 64, 26, 26)]), {"blocksize": 2}),
        ("crop_fcn", "crop", ins(X=[f(32, 21, 250, 250)]),
         {"shape": [32, 21, 224, 224], "offsets": [0, 0, 13, 13]}),
        ("crop_fcn_offsets_tensor", "crop",
         ins(X=[f(32, 21, 250, 250)],
             Offsets=[const(np.array([0, 0, 13, 19], np.int32))]),
         {"shape": [32, 21, 224, 224]}),
        ("pad_constant_like_fcn", "pad_constant_like",
         ins(X=[f(32, 21, 224, 224)], Y=[f(32, 21, 200, 200)]),
         {"pad_value": 0.0}),
        ("multiplex_4x512", "multiplex",
         ins(X=[f(batch, 512)] * 4, Ids=[ints(0, 4, batch, 1)]), {}),
        ("bilinear_tensor_product", "bilinear_tensor_product",
         ins(X=[f(batch, 128)], Y=[f(batch, 128)],
             Weight=[f(64, 128, 128, scale=0.1)], Bias=[f(1, 64)]), {}),
        ("rank_loss_ranknet", "rank_loss",
         ins(Label=[binary(batch, 1)], Left=[f(batch, 1)],
             Right=[f(batch, 1)]), {}),
        ("margin_rank_loss", "margin_rank_loss",
         ins(Label=[signs(batch, 1)], X1=[f(batch, 1)], X2=[f(batch, 1)]),
         {"margin": 0.1}),
        ("bpr_loss_1000_items", "bpr_loss",
         ins(X=[f(2048, 1000)], Label=[ints(0, 1000, 2048, 1)]), {}),
        ("teacher_student_sigmoid_loss", "teacher_student_sigmoid_loss",
         ins(X=[f(2048, 1, scale=10.0)], Label=[teacher_labels]),
         {"soft_max_up_bound": 15.0, "soft_max_lower_bound": -15.0}),
        ("dice_loss_vnet", "dice_loss_op",
         ins(X=[lambda rng: 1.0 / (1.0 + np.exp(-f(4, 1, 64, 128, 128)(
             rng)))], Label=[binary(4, 1, 64, 128, 128)]),
         {"epsilon": 1e-5}),
        ("selu_snn", "selu", ins(X=[f(batch, 1024)]),
         {"scale": 1.0507009873554805, "alpha": 1.6732632423543772}),
        ("add_position_encoding", "add_position_encoding",
         ins(X=[f(32, 256, 512)]), {"alpha": 1.0, "beta": 1.0}),
        ("data_norm_ctr", "data_norm",
         ins(X=[f(2048, 512)],
             BatchSize=[lambda rng: (1e4 + 100 * rng.rand(512)).astype(
                 np.float32)],
             BatchSum=[f(512, scale=50.0)],
             BatchSquareSum=[lambda rng: (1e4 + 100 * rng.rand(512))
                             .astype(np.float32)]), {}),
        ("mean_iou_voc", "mean_iou",
         ins(Predictions=[ints(0, 21, 8, 512 * 512, dtype=np.int32)],
             Labels=[ints(0, 21, 8, 512 * 512, dtype=np.int32)]),
         {"num_classes": 21}),
        ("hash_ctr_features", "hash",
         ins(X=[ints(0, 10 ** 9, batch, 39)]),
         {"num_hash": 2, "mod_by": 1000000}),
        ("isinf_bert_embedding", "isinf", ins(X=[with_inf]), {}),
        ("isnan_bert_embedding", "isnan", ins(X=[with_inf]), {}),
        ("isfinite_bert_embedding", "isfinite_reduce",
         ins(X=[f(30522, 768)]), {}),
        ("is_empty", "is_empty", ins(X=[f(30522, 768)]), {}),
        ("sampling_id_1000", "sampling_id", ins(X=[probs(batch, 1000)]),
         {"seed": 0}),
        ("random_crop_224", "random_crop", ins(X=[f(32, 3, 256, 256)]),
         {"shape": [224, 224]}),
        ("uniform_random_batch_size_like", "uniform_random_batch_size_like",
         ins(Input=[f(batch, 8)]),
         {"shape": [-1, 512], "input_dim_idx": 0, "output_dim_idx": 0,
          "min": -0.5, "max": 0.5, "seed": 0}),
        ("gaussian_random_batch_size_like",
         "gaussian_random_batch_size_like", ins(Input=[f(batch, 8)]),
         {"shape": [-1, 512], "input_dim_idx": 0, "output_dim_idx": 0,
          "mean": 0.0, "std": 0.02, "seed": 0}),
        ("print_op", "print_op", ins(X=[f(2, 3)]),
         {"message": "misc_ops print_op"}),
        ("py_func_tanh", "py_func", ins(X=[f(batch, dim)]), py_attrs),
        ("py_func_grad_tanh", "py_func_grad",
         ins(X=[f(batch, dim)], **{"Out@GRAD": [f(batch, dim)]}), py_attrs),
        ("load_value", "load_value", ins(), {"file_path": load_path,
                                             "load_as_fp16": False}),
    ]
    return cases


def random_op_contracts():
    """The random ops on the card by their contract: shape, dtype and
    range; the same (seed, run, op) draws the same values, another run
    other ones; ``sampling_id``'s frequencies within 0.01 of the
    probabilities over 100,000 rows; ``random_crop`` a slice of its input
    at an in-range offset. Returns {op: row}."""
    import torch

    from paddle_tpu_torch.core.desc import OpDesc
    from paddle_tpu_torch.core.registry import LowerContext, OpRegistry

    def draw(op_type, x, attrs, run):
        ctx = LowerContext(OpDesc(op_type, {"X": ["x"]}, {}, attrs), None,
                           "cuda", rng_seed=(11, run))
        slot = "X" if op_type in ("sampling_id", "random_crop") else "Input"
        return OpRegistry.get(op_type).lower(ctx, {slot: [x]}, attrs)[
            "Out"][0]

    rows = {}
    p = torch.tensor([0.05, 0.0, 0.5, 0.15, 0.3], device="cuda")
    ids = draw("sampling_id", p.expand(100000, 5).contiguous(), {}, 1)
    freq = torch.bincount(ids, minlength=5).double() / ids.numel()
    rows["sampling_id"] = {
        "freq": freq.tolist(), "probs": p.tolist(),
        "ok": bool((freq - p.double()).abs().max() < 0.01
                   and ids.dtype == torch.int64
                   and torch.equal(ids, draw("sampling_id", p.expand(
                       100000, 5).contiguous(), {}, 1)))}
    x = torch.arange(2 * 3 * 40 * 50, dtype=torch.float32,
                     device="cuda").reshape(2, 3, 40, 50)
    ok = True
    for run in (1, 2, 3):
        out = draw("random_crop", x, {"shape": [32, 24]}, run)
        i, j = divmod(int(out[0, 0, 0, 0]), 50)
        ok = ok and 0 <= i <= 8 and 0 <= j <= 26 and torch.equal(
            out, x[:, :, i:i + 32, j:j + 24])
    rows["random_crop"] = {"ok": ok}
    ref = torch.zeros(200000, 1, device="cuda")
    for op_type, attrs, law in (
            ("uniform_random_batch_size_like",
             {"shape": [-1, 4], "min": -0.5, "max": 0.25},
             lambda v: v.min() >= -0.5 and v.max() < 0.25
             and abs(float(v.mean()) + 0.125) < 0.005),
            ("gaussian_random_batch_size_like",
             {"shape": [-1, 4], "mean": 1.0, "std": 2.0},
             lambda v: abs(float(v.mean()) - 1.0) < 0.02
             and abs(float(v.std()) - 2.0) < 0.02)):
        a, b = draw(op_type, ref, attrs, 1), draw(op_type, ref, attrs, 2)
        rows[op_type] = {
            "mean": float(a.mean()), "std": float(a.std()),
            "ok": bool(tuple(a.shape) == (200000, 4)
                       and a.dtype == torch.float32 and law(a)
                       and torch.equal(a, draw(op_type, ref, attrs, 1))
                       and not torch.equal(a, b))}
    return rows


def host_ops(fluid, batch, width):
    """A program through the host ops: an fc, a numpy tanh by
    ``layers.py_func`` with its numpy grad, ``layers.Print`` of the
    result, the mean as the loss, SGD."""
    layers = fluid.layers
    x = layers.data(name="x", shape=[width], dtype="float32")
    h = layers.fc(input=x, size=width, param_attr=fluid.ParamAttr(
        name="host_w"), bias_attr=False)
    y = fluid.default_main_program().global_block().create_var(
        name="host_tanh", shape=[batch, width], dtype="float32")
    layers.py_func(_np_tanh, h, y, backward_func=_np_tanh_grad)
    y = layers.Print(y, message="host_ops")
    loss = layers.mean(y)
    fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return {"loss": loss, "out": y}


def random_ops(fluid, image, crop, classes, width):
    """A program of the four random ops: ``layers.random_crop`` of the
    frames ``img`` to ``crop``, ``layers.sampling_id`` of the
    probabilities ``probs``, and uniform (in [-0.5, 0.25)) and normal
    (mean 1, std 2) noise [B, width] of ``img``'s batch size."""
    layers = fluid.layers
    img = layers.data(name="img", shape=image, dtype="float32")
    probs = layers.data(name="probs", shape=[classes], dtype="float32")
    return {"crop": layers.random_crop(img, shape=crop),
            "ids": layers.sampling_id(probs),
            "uniform": layers.uniform_random_batch_size_like(
                img, shape=[-1, width], min=-0.5, max=0.25),
            "normal": layers.gaussian_random_batch_size_like(
                img, shape=[-1, width], mean=1.0, std=2.0)}


def random_feed(batch, image, classes, seed, **_):
    """Frames whose values are their flat positions in a frame (so a
    crop's offset reads off its first value), and probability rows."""
    rng = np.random.RandomState(seed)
    img = np.broadcast_to(np.arange(int(np.prod(image)), dtype=np.float32)
                          .reshape(image), [batch] + image)
    p = rng.rand(batch, classes).astype(np.float32)
    return {"img": np.ascontiguousarray(img),
            "probs": p / p.sum(1, keepdims=True)}


def random_draws_ok(out, feed, image, crop, classes, **_):
    """The contract of one run of ``random_ops``: the crop is the frames'
    slice at an in-range offset, the ids integers in [0, classes), the
    noise in its range and finite; returns the reasons it fails."""
    bad = []
    c, h, w = image
    i, j = divmod(int(out["crop"].reshape(-1)[0]), w)
    if not (0 <= i <= h - crop[0] and 0 <= j <= w - crop[1]
            and np.array_equal(out["crop"], feed["img"][
                :, :, i:i + crop[0], j:j + crop[1]])):
        bad.append("crop at (%d, %d)" % (i, j))
    if not np.issubdtype(out["ids"].dtype, np.integer) or not (
            0 <= out["ids"].min() and out["ids"].max() < classes):
        bad.append("ids")
    if not (out["uniform"].min() >= -0.5 and out["uniform"].max() < 0.25):
        bad.append("uniform range")
    if not np.all(np.isfinite(out["normal"])):
        bad.append("normal not finite")
    return bad


def random_program_runs(fa, smi):
    """``random_ops`` run RANDOM_RUNS times on an eager executor and on
    a captured one from the same program: each run's draws equal on the
    two; one graph, captured once at the second run and replayed at it
    and every later one, no eager block; fresh draws at each replay;
    every run within the contract (``random_draws_ok``)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import unique_name

    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            h = random_ops(fluid, **RANDOM_OPS)
    main.random_seed = startup.random_seed = 2024
    feed = random_feed(RANDOM_BATCH, seed=61, **RANDOM_OPS)
    names = sorted(h)
    fetch = [h[n] for n in names]
    eager, eager_scope = fresh(startup, graphs=False)
    graph, graph_scope = fresh(startup)
    obs.set_enabled(True)
    obs.reset()
    runs = {"eager": [], "captured": []}
    eager_runs = 0
    for _ in range(RANDOM_RUNS):
        for key, exe, scope in (("captured", graph, graph_scope),
                                ("eager", eager, eager_scope)):
            before = obs.counter_value("engine.eager_runs")
            with fluid.scope_guard(scope):
                runs[key].append(dict(zip(names, exe.run(
                    main, feed=feed, fetch_list=fetch))))
            if key == "captured":
                eager_runs += obs.counter_value("engine.eager_runs") - before
    obs.set_enabled(None)
    # the empty startup program's entry may capture too, but ran once
    entries = [c for c in captured(graph.engine) if c.captures]
    cap = runs["captured"]
    row = {
        "equal_eager": [all(np.array_equal(a[n], b[n]) for n in names)
                        for a, b in zip(cap, runs["eager"])],
        "fresh_draws": [[n for n in ("ids", "uniform", "normal")
                         if not np.array_equal(a[n], b[n])]
                        for a, b in zip(cap, cap[1:])],
        "contract": [random_draws_ok(o, feed, **RANDOM_OPS) for o in cap],
        "graphs": len(entries), "captures": [c.captures for c in entries],
        "replays": [c.replays for c in entries], "eager_runs": eager_runs}
    emit({"phase": "misc_ops", "card": smi, "random_program": row})
    check(all(row["equal_eager"]) and not any(row["contract"])
          and all(len(f) == 3 for f in row["fresh_draws"]),
          "misc_ops: the random-op program %s" % row)
    check(len(entries) == 1 and entries[0].captures == 1
          and entries[0].replays == RANDOM_RUNS - 1 and eager_runs == 0,
          "misc_ops: the random-op program not captured once: %s" % row)


def phase_misc_ops(fa, smi):
    """Every lowering of the misc family (``misc_cases``) through
    ``phase_op_cases``, the MISC_TWICE ops twice, cuDNN's float32
    transposed 3-D convolution and a float64 ``F.conv_transpose3d``
    beside the port's; the random ops by their contract on the card, and
    in a captured program (``random_program_runs``); then a
    ``host_ops`` program (``py_func`` with its grad and ``Print``)
    trained 3 steps on the card: its block reported uncapturable and run
    eagerly at every step, the losses and the weight the CPU's
    (TRAIN_TOL). Returns the flash launches (none)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert, unique_name
    from paddle_tpu_torch import observability as obs

    with tempfile.TemporaryDirectory(prefix="chip_smoke_misc_") as tmpdir:
        launches = phase_op_cases(fa, smi, "misc_ops", misc_cases(tmpdir),
                                  MISC_TWICE, MISC_WITNESS)
    contracts = random_op_contracts()
    emit({"phase": "misc_ops", "card": smi, "random_contracts": contracts})
    check(all(r["ok"] for r in contracts.values()),
          "misc_ops: random ops off their contract: %s" % contracts)
    random_program_runs(fa, smi)

    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            h = host_ops(fluid, 64, 32)
    main.random_seed = startup.random_seed = 2024
    feed = {"x": np.random.RandomState(5).randn(64, 32).astype(np.float32)}
    state0 = start_state(main, startup)
    runs = {}
    for device, place in (("cuda", fluid.CUDAPlace(0)),
                          ("cpu", fluid.CPUPlace())):
        scope = fluid.Scope()
        convert.load_numpy_state(scope, state0, device, program=main)
        exe = fluid.Executor(place)
        obs.set_enabled(True)
        obs.reset()
        with fluid.scope_guard(scope):
            losses = [float(exe.run(main, feed=feed, fetch_list=[
                h["loss"]])[0].reshape(-1)[0]) for _ in range(3)]
        runs[device] = {"losses": losses, "w": scope.get("host_w").cpu(),
                        "eager_runs": obs.counter_value("engine.eager_runs"),
                        "uncapturable": sorted({
                            t for c in exe.engine._cache.values()
                            for t in c.block_program.uncapturable_ops})
                        if device == "cuda" else None}
        obs.set_enabled(None)
    card, cpu = runs["cuda"], runs["cpu"]
    w_err = float((card["w"] - cpu["w"]).abs().max()
                  / (cpu["w"].abs().max() or 1.0))
    row = {"phase": "misc_ops", "card": smi, "host_ops": {
        "losses_card": card["losses"], "losses_cpu": cpu["losses"],
        "weight_rel_to_max": w_err, "eager_runs": card["eager_runs"],
        "uncapturable_ops": card["uncapturable"], "tol": TRAIN_TOL}}
    emit(row)
    check(card["eager_runs"] == 3 and {"py_func", "py_func_grad",
                                       "print_op"} <= set(
        card["uncapturable"]), "misc_ops: the host-op block %s" % row)
    check(np.allclose(card["losses"], cpu["losses"],
                      rtol=TRAIN_TOL["loss_rtol"], atol=0)
          and w_err <= TRAIN_TOL["grad_rel_to_max"],
          "misc_ops: the host-op program off the CPU's: %s" % row)
    release_memory()
    return launches


def skipgram(fluid, vocab, dim, neg, lr, head="nce"):
    """Skip-gram (SKIPGRAM) from ``fluid.layers``: the centre word's
    vector from a sparse embedding, scored against the context word by
    ``layers.nce`` (``num_neg_samples`` uniform negatives) or by
    ``layers.hsigmoid`` over the complete binary tree, the batch mean,
    SGD."""
    layers = fluid.layers
    centre = layers.data(name="centre", shape=[1], dtype="int64")
    context = layers.data(name="context", shape=[1], dtype="int64")
    vec = layers.embedding(centre, size=[vocab, dim], is_sparse=True,
                           param_attr=fluid.ParamAttr(name="emb_in"))
    out_w = fluid.ParamAttr(name="emb_out")
    out_b = fluid.ParamAttr(name="emb_out_b")
    if head == "nce":
        cost = layers.nce(vec, context, num_total_classes=vocab,
                          num_neg_samples=neg, param_attr=out_w,
                          bias_attr=out_b)
    else:
        cost = layers.hsigmoid(vec, context, num_classes=vocab,
                               param_attr=out_w, bias_attr=out_b)
    loss = layers.mean(cost)
    fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return {"loss": loss, "cost": cost}


def skipgram_feed(batch, vocab, seed, **_):
    """(centre, context) id pairs drawn Zipf-like (rank r with weight
    about 1/r) over the vocabulary."""
    rng = np.random.RandomState(seed)

    def zipf():
        return np.minimum(np.floor(vocab ** rng.rand(batch, 1)), vocab) \
            .astype(np.int64) - 1

    return {"centre": zipf(), "context": zipf()}


def nce_op_outputs(main):
    """The ``SampleLabels`` var of the program's ``nce`` op."""
    (op,) = [o for o in main.desc.global_block().ops if o.type == "nce"]
    return op.outputs["SampleLabels"][0]


def phase_skipgram_nce(fa, smi):
    """The skip-gram trainer (SKIPGRAM) at full width with each head:
    SKIPGRAM_STEPS steps at batch 4096 eagerly and captured from the same
    state, bitwise equal, one graph (``nce`` draws from the seed table,
    so the step is captured); step ms, pairs/s, idle share, an eager
    step's peak memory and the top kernels; then SKIPGRAM_CPU_STEPS steps
    at batch 256 on the card and on the CPU from the same state: the
    losses within TRAIN_TOL, every parameter within OPT_TOL of the CPU's
    largest, the NCE negatives equal at every step. Returns the flash
    launches (none)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert, unique_name

    paths = {}
    for head in ("nce", "hsigmoid"):
        with unique_name.guard():
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                h = skipgram(fluid, head=head, **SKIPGRAM)
        main.random_seed = startup.random_seed = 2024
        loss = h["loss"]
        feed = skipgram_feed(SKIPGRAM_BATCH, seed=2024, **SKIPGRAM)
        (eager, graph, losses, unequal, eager_runs, launches,
         walls) = lockstep_steps(fa, main, startup, loss, feed,
                                 SKIPGRAM_STEPS)
        entries = captured(graph[0].engine)
        emit({"phase": "skipgram_nce", "card": smi, "head": head,
              "config": SKIPGRAM, "batch": SKIPGRAM_BATCH,
              "losses": losses, "unequal_state": unequal[:10],
              "graphs": len(entries), "eager_runs": eager_runs,
              "launches": launches, "captured_run_walls_ms": walls})
        lockstep_checks("skipgram_nce " + head, losses, unequal, entries,
                        eager_runs, launches)
        paths[head] = launches
        peak = eager_step_peak(eager[0], eager[1], main, loss, feed)
        cap = profiled_step(graph[0], graph[1], main, loss, feed,
                            profiled_steps=2)
        emit(dict({"phase": "times", "card": smi,
                   "profile": "skipgram_nce %s training step" % head,
                   "run": "captured", "batch": SKIPGRAM_BATCH,
                   "pairs_per_s": SKIPGRAM_BATCH / (cap["median_ms"] / 1e3),
                   "eager_step_peak_bytes": peak}, **cap))
        del eager, graph, entries
        release_memory()

        # the same steps on the card and on the CPU from one state
        state0 = start_state(main, startup)
        feeds = [skipgram_feed(SKIPGRAM_CPU_BATCH, seed=7 + i, **SKIPGRAM)
                 for i in range(SKIPGRAM_CPU_STEPS)]
        fetch = [loss.name] + ([nce_op_outputs(main)] if head == "nce"
                               else [])
        runs = {}
        for device, place in (("cuda", fluid.CUDAPlace(0)),
                              ("cpu", fluid.CPUPlace())):
            scope = fluid.Scope()
            convert.load_numpy_state(scope, state0, device, program=main)
            exe = fluid.Executor(place)
            with fluid.scope_guard(scope):
                outs = [exe.run(main, feed=f, fetch_list=fetch)
                        for f in feeds]
            runs[device] = {
                "losses": [float(o[0].reshape(-1)[0]) for o in outs],
                "negatives": [o[1] for o in outs] if head == "nce" else [],
                "params": {p.name: scope.get(p.name).cpu()
                           for p in main.all_parameters()}}
            del scope, exe
        card, cpu = runs["cuda"], runs["cpu"]
        rel = {n: float((card["params"][n] - w).abs().max()
                        / (w.abs().max() or 1.0))
               for n, w in cpu["params"].items()}
        same_negatives = all(np.array_equal(a, b) for a, b in zip(
            card["negatives"], cpu["negatives"]))
        row = {"head": head, "batch": SKIPGRAM_CPU_BATCH,
               "losses_card": card["losses"], "losses_cpu": cpu["losses"],
               "params_rel_to_max": rel, "negatives_equal": same_negatives,
               "tol": {"loss_rtol": TRAIN_TOL["loss_rtol"],
                       "param_rel_to_max": OPT_TOL}}
        emit({"phase": "skipgram_nce", "cpu_steps": row})
        check(np.allclose(card["losses"], cpu["losses"],
                          rtol=TRAIN_TOL["loss_rtol"], atol=0)
              and max(rel.values()) <= OPT_TOL and same_negatives,
              "skipgram_nce %s: card vs CPU steps %s" % (head, row))
        del runs, card, cpu
        release_memory()
    torch.cuda.synchronize()
    return {k: sum(p[k] for p in paths.values())
            for k in paths["nce"]}


def c3d(fluid, stages, fc, classes, clip, dropout, lr, momentum,
        is_train=True):
    """C3D (C3D) from ``fluid.layers``: per stage its 3x3x3 conv3d
    layers (stride 1, pad 1, ReLU) and a max pool3d of the stage's
    window (stride the window, the stage's padding); two fc layers with
    ReLU and dropout, the class fc, softmax cross entropy, Momentum."""
    layers = fluid.layers
    h = layers.data(name="clip", shape=[3] + list(clip), dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    for filters, window, pad in stages:
        for n in filters:
            h = layers.conv3d(h, num_filters=n, filter_size=3, padding=1,
                              act="relu")
        h = layers.pool3d(h, pool_size=window, pool_stride=window,
                          pool_padding=pad)
    for _ in range(2):
        h = layers.dropout(layers.fc(input=h, size=fc, act="relu"),
                           dropout_prob=dropout, is_test=not is_train)
    logits = layers.fc(input=h, size=classes)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    if is_train:
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=momentum).minimize(loss)
    return {"logits": logits, "loss": loss}


def c3d_feed(batch, clip, classes, seed, **_):
    rng = np.random.RandomState(seed)
    return {"clip": rng.randn(batch, 3, *clip).astype(np.float32),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}


def counted_flops(exe, scope, program, feed, fetch):
    """The operations of one run of ``program`` as the engine counts them
    (``FlopCounterMode`` over the lowerings, on the first run of a cache
    entry with the goodput flag up: a new entry, or one that has run
    only with the flag down)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.observability import goodput

    counted = {id(c) for c in exe.engine._cache.values()
               if c.flops is not None}
    flags.set_flags({"goodput": True})
    try:
        with fluid.scope_guard(scope):
            exe.run(program, feed=feed, fetch_list=fetch)
    finally:
        flags.reset_flag("goodput")
        goodput.reset()
    (flops,) = [c.flops for c in exe.engine._cache.values()
                if id(c) not in counted and c.flops is not None]
    return flops


def phase_c3d(fa, smi):
    """C3D (C3D) trained and served at full width: C3D_STEPS Momentum
    steps at batch 8 eagerly and captured from the same state, bitwise
    equal, one graph; step ms, clips/s, idle share, an eager step's peak
    and MFU against 67 TFLOP/s FFMA on the model's operations: the
    forward, its data grads and its filter grads, but no data grad of
    conv1, whose input is the clip (the forward's FlopCounterMode count
    on the ``for_test`` clone at batch 1, within MFU_TOL of the paper's
    38.5 G multiply-adds a clip; conv1's from its shape); beside it the
    count of one eager training step as it runs (each grad op reruns its
    forward in ``torch.func.vjp``); one step at batch 2 op by op against
    the CPU (IMAGE_OP_TOL); the ``for_test`` clone saved by
    ``io.save_inference_model`` and served by ``create_paddle_predictor``
    at batch 1 and 8 against the CPU predictor (SERVE_TOL), its latency.
    Returns the flash launches (none)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert, inference, unique_name

    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            h = c3d(fluid, **C3D)
    main.random_seed = startup.random_seed = 2024
    loss = h["loss"]
    feed = c3d_feed(C3D_BATCH, seed=2024, **C3D)
    (eager, graph, losses, unequal, eager_runs, launches,
     walls) = lockstep_steps(fa, main, startup, loss, feed, C3D_STEPS)
    entries = captured(graph[0].engine)
    test_prog = main.clone(for_test=True)
    macs = counted_flops(eager[0], eager[1], test_prog, {
        "clip": feed["clip"][:1]}, [h["logits"]]) / 2
    emit({"phase": "c3d", "card": smi, "config": C3D, "batch": C3D_BATCH,
          "params": sum(int(np.prod(p.shape)) for p in main.all_parameters()),
          "losses": losses, "unequal_state": unequal[:10],
          "graphs": len(entries), "eager_runs": eager_runs,
          "launches": launches, "captured_run_walls_ms": walls,
          "clip_forward_gmacs": macs / 1e9,
          "paper_clip_gmacs": C3D_CLIP_GMACS})
    lockstep_checks("c3d", losses, unequal, entries, eager_runs, launches)
    check(abs(macs / 1e9 - C3D_CLIP_GMACS) <= MFU_TOL * C3D_CLIP_GMACS,
          "c3d: %.2f G multiply-adds a clip, the paper's %.1f"
          % (macs / 1e9, C3D_CLIP_GMACS))
    (conv1,), _, _ = C3D["stages"][0]
    conv1_macs = conv1 * 3 * 27 * int(np.prod(C3D["clip"]))
    step_flops = 2 * C3D_BATCH * (3 * macs - conv1_macs)
    run_flops = counted_flops(eager[0], eager[1], main, feed, [loss])
    peak = eager_step_peak(eager[0], eager[1], main, loss, feed)
    cap = profiled_step(graph[0], graph[1], main, loss, feed, n=5,
                        profiled_steps=2)
    emit(dict({"phase": "times", "card": smi,
               "profile": "c3d training step", "run": "captured",
               "batch": C3D_BATCH,
               "clips_per_s": C3D_BATCH / (cap["median_ms"] / 1e3),
               "step_flops": step_flops,
               "conv1_data_grad_flops_not_needed": 2 * C3D_BATCH
               * conv1_macs, "step_flops_as_run": run_flops,
               "mfu_ffma": step_flops / (cap["median_ms"] / 1e3)
               / PEAK_FFMA_FLOPS_PER_S,
               "eager_step_peak_bytes": peak, "tf32": False}, **cap))
    del eager, graph, entries
    release_memory()

    # one step at batch 2 on the card against the CPU, op by op
    state0 = start_state(main, startup)
    worst, _, _ = replay_ops_on_card(
        main, state0, c3d_feed(2, seed=2025, **C3D), IMAGE_OP_TOL)
    emit({"phase": "c3d", "cpu_ops_rel_to_max": worst, "tol": IMAGE_OP_TOL})
    release_memory()

    # served: the for_test clone, saved and loaded by the predictor
    with tempfile.TemporaryDirectory(prefix="chip_smoke_c3d_") as d:
        scope = fluid.Scope()
        convert.load_numpy_state(scope, state0, "cuda", program=main)
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, ["clip"], [h["logits"]],
                                          fluid.Executor(fluid.CUDAPlace(0)),
                                          main_program=test_prog)
        del scope
        predictor = inference.create_paddle_predictor(
            inference.AnalysisConfig(d))
        cpu_cfg = inference.AnalysisConfig(d)
        cpu_cfg.disable_gpu()
        cpu_pred = inference.create_paddle_predictor(cpu_cfg)
        torch.cuda.synchronize()
        fa.launches = fa.launches_dq = fa.launches_dkv = 0  # path starts
        served = {}
        for b in C3D_SERVE_BATCHES:
            req = {"clip": c3d_feed(b, seed=300 + b, **C3D)["clip"]}
            (card,) = predictor.run(req)
            (cpu,) = cpu_pred.run(req)
            served[b] = {
                "max_abs_err": float(np.abs(card.data - cpu.data).max()),
                "max_abs_logit": float(np.abs(cpu.data).max()),
                "close": bool(np.allclose(card.data, cpu.data,
                                          **SERVE_TOL)),
                "shape": list(card.data.shape),
                "request_ms": timed_runs(lambda r=req: predictor.run(r),
                                         n=5)}
        serve_launches = flash_launches(fa)  # ... and ends here
    emit({"phase": "c3d", "card": smi, "serve": served, "tol": SERVE_TOL,
          "launches": serve_launches})
    check(all(r["close"] and r["shape"] == [b, C3D["classes"]]
              for b, r in served.items()),
          "c3d served off the CPU's: %s" % served)
    check(not any(serve_launches.values()), "flash launches serving c3d: "
          "%s" % serve_launches)
    del predictor, cpu_pred
    release_memory()
    return {k: launches[k] + serve_launches[k] for k in launches}


def ssd_mobilenet(fluid, mobilenet, batch, classes, image, scale, gt_boxes,
                  min_sizes, max_sizes, lr, momentum, l2, is_train=True,
                  nms=None):
    """SSD-MobileNet-v1 (SSD) from ``fluid.layers`` and the package's
    ``models.mobilenet`` (``mobilenet``: its ``conv_bn`` and
    ``depthwise_separable``): the backbone up to its 19 x 19 and 10 x 10
    maps, four extra 1x1/3x3 pairs, ``multi_box_head`` over the six maps.
    ``is_train``: ``ssd_loss`` per image of the ``batch`` (slices of the
    batch), summed, Momentum with L2 decay; else the softmax scores and
    ``detection_output`` at ``nms``, batch norm on its running
    statistics. Both builds name the parameters alike."""
    layers = fluid.layers
    img = layers.data(name="image", shape=[3, image, image],
                      dtype="float32")

    def conv_bn(x, filters, size, stride=1, padding=0):
        return mobilenet.conv_bn(x, int(filters * scale), size,
                                 stride=stride, padding=padding,
                                 is_train=is_train)

    def separable(x, ch_in, ch_out, stride):
        return mobilenet.depthwise_separable(x, ch_in, ch_out, stride,
                                             scale, is_train=is_train)

    h = conv_bn(img, 32, 3, stride=2, padding=1)
    for ch_in, ch_out, stride in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                                  (128, 256, 2), (256, 256, 1),
                                  (256, 512, 2)) + ((512, 512, 1),) * 5:
        h = separable(h, ch_in, ch_out, stride)
    maps = [h]
    h = separable(separable(h, 512, 1024, 2), 1024, 1024, 1)
    maps.append(h)
    for c1, c2 in ((256, 512), (128, 256), (128, 256), (64, 128)):
        h = conv_bn(conv_bn(h, c1, 1), c2, 3, stride=2, padding=1)
        maps.append(h)
    locs, confs, box, var = layers.multi_box_head(
        inputs=maps, image=img, base_size=image, num_classes=classes,
        aspect_ratios=[[2.0]] + [[2.0, 3.0]] * 5, min_ratio=20,
        max_ratio=90, min_sizes=min_sizes, max_sizes=max_sizes, offset=0.5,
        flip=True, clip=True)
    handles = {"locs": locs, "confs": confs, "box": box, "var": var}
    if not is_train:
        handles["scores"] = layers.softmax(confs)
        handles["dets"] = layers.detection_output(
            locs, handles["scores"], box, var, **nms)
        return handles
    gt_box = layers.data(name="gt_box", shape=[gt_boxes, 4],
                         dtype="float32")
    gt_label = layers.data(name="gt_label", shape=[gt_boxes, 1],
                           dtype="int64")

    def image_rows(v, i, width):
        return layers.reshape(layers.slice(v, axes=[0], starts=[i],
                                           ends=[i + 1]), shape=[-1, width])

    loss = layers.sums([layers.ssd_loss(
        image_rows(locs, i, 4), image_rows(confs, i, classes),
        image_rows(gt_box, i, 4), image_rows(gt_label, i, 1), box, var)
        for i in range(batch)])
    fluid.optimizer.Momentum(
        learning_rate=lr, momentum=momentum,
        regularization=fluid.regularizer.L2Decay(l2)).minimize(loss)
    handles["loss"] = loss
    return handles


def ssd_feed(batch, image, classes, gt_boxes, seed, **_):
    """Images, and 1-8 ground-truth boxes an image (normalized corners,
    sides 0.1-0.4 of the image, labels 1 .. classes-1), the rest of the
    ``gt_boxes`` rows zero boxes of label 0."""
    rng = np.random.RandomState(seed)
    box = np.zeros((batch, gt_boxes, 4), np.float32)
    label = np.zeros((batch, gt_boxes, 1), np.int64)
    for b in range(batch):
        n = rng.randint(1, min(8, gt_boxes) + 1)
        xy = rng.uniform(0.0, 0.6, (n, 2))
        wh = rng.uniform(0.1, 0.4, (n, 2))
        box[b, :n] = np.concatenate([xy, xy + wh], 1)
        label[b, :n, 0] = rng.randint(1, classes, n)
    return {"image": rng.randn(batch, 3, image, image).astype(np.float32),
            "gt_box": box, "gt_label": label}


def detection_map_program(fluid, keep_top_k, gt_boxes, classes):
    """``layers.detection_map`` (11-point mAP at IoU 0.5, on the host
    through ``py_func``) of [B, keep_top_k, 6] detections against [B,
    gt_boxes, 5] ground truths (label, box)."""
    layers = fluid.layers
    dets = layers.data(name="dets", shape=[keep_top_k, 6], dtype="float32")
    gts = layers.data(name="gts", shape=[gt_boxes, 5], dtype="float32")
    return layers.detection_map(dets, gts, class_num=classes,
                                overlap_threshold=0.5, ap_version="11point")


def map_ground_truth(feed):
    """[B, G, 5] (label, x1, y1, x2, y2) rows of an ``ssd_feed``."""
    return np.concatenate([feed["gt_label"].astype(np.float32),
                           feed["gt_box"]], -1)


def detections_match(got, want, rtol, atol):
    """[B, K, 6] detection rows against the reference's, image by image:
    the counts (rows of label >= 0) equal, and each row within tolerance
    of the row at its place or, inside a run of rows whose scores lie
    within the tolerance of each other (a near tie float rounding may
    order either way), of another row of that run, each used once. In
    the run at the cut of the K rows, a row may be another candidate of
    the same score within the tolerance (the near tie at the cut kept the
    other one). Returns (whether it holds, {counts, max_abs_err,
    reordered_rows, rows_across_the_cut, unmatched})."""
    got, want = np.asarray(got), np.asarray(want)
    counts = [(got[..., 0] >= 0).sum(-1).tolist(),
              (want[..., 0] >= 0).sum(-1).tolist()]
    worst, moved, cut, unmatched = 0.0, 0, [], []

    def near(a, b):
        return abs(a - b) <= atol + rtol * abs(b)

    for b, (g, w) in enumerate(zip(got, want)):
        start = 0
        while start < len(w):
            end = start + 1
            while end < len(w) and near(w[end, 1], w[end - 1, 1]):
                end += 1
            free = list(range(start, end))
            for k in range(start, end):
                close = [j for j in free
                         if np.allclose(g[k], w[j], rtol=rtol, atol=atol)]
                if not close:
                    if end == len(w) and any(near(g[k, 1], w[j, 1])
                                             for j in free):
                        cut.append([b, k])
                    else:
                        unmatched.append([b, k])
                    continue
                j = k if k in close else close[0]
                free.remove(j)
                moved += j != k
                with np.errstate(invalid="ignore"):  # inf - inf
                    d = np.where(g[k] == w[j], 0.0, np.abs(g[k] - w[j]))
                worst = max(worst, float(d.max()))
            start = end
    ok = counts[0] == counts[1] and not unmatched
    return ok, {"counts": counts[0], "counts_want": counts[1],
                "max_abs_err": worst, "reordered_rows": moved,
                "rows_across_the_cut": cut[:10], "unmatched": unmatched[:10]}


def nms_on_host(head, nms):
    """The served detections recomputed by the port's ``box_coder``
    (decode) and ``multiclass_nms`` lowerings on the CPU from the card's
    head outputs ``head`` ({locs, scores, box, var}, host arrays)."""
    import torch

    dec = lower_op("box_coder", {
        "PriorBox": [torch.from_numpy(head["box"])],
        "PriorBoxVar": [torch.from_numpy(head["var"])],
        "TargetBox": [torch.from_numpy(head["locs"])]},
        {"code_type": "decode_center_size", "box_normalized": True,
         "axis": 0}, "cpu")["OutputBox"][0]
    scores = torch.from_numpy(head["scores"]).transpose(1, 2).contiguous()
    return lower_op("multiclass_nms", {"BBoxes": [dec], "Scores": [scores]},
                    dict(nms, background_label=0, normalized=True,
                         nms_eta=1.0), "cpu")["Out"][0].numpy()


def phase_ssd(fa, smi):
    """SSD-MobileNet-v1 (SSD) trained and served at full width:
    SSD_STEPS Momentum steps at batch 32 eagerly and captured from the
    same state, bitwise equal, one graph (``ssd_loss`` 32 times a step:
    the bipartite match's scan and the matching ops captured); step ms,
    images/s, idle share, eager peak, launches; one step at batch
    SSD_CPU_BATCH against the CPU from the same state: the loss
    (TRAIN_TOL) and every op on the CPU's operands (IMAGE_OP_TOL), the
    grads end to end printed; then the inference build (softmax,
    ``detection_output``) saved by ``io.save_inference_model`` with the
    initial weights (its batch norms on one training batch's statistics)
    and served by the predictor at batch 1 and 8 against
    the CPU predictor: the head's scores and boxes within SERVE_TOL, the
    detections' counts equal and rows within SERVE_TOL
    (``detections_match``), the card's detections and the CPU's NMS of
    the card's head equal; ms a request; ``detection_map`` of the batch
    8 detections on the card (its ``py_func`` block eager) and on the CPU,
    equal. Returns the flash launches (none)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert, inference, unique_name
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.models import mobilenet

    def build(batch, is_train):
        with unique_name.guard():
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                h = ssd_mobilenet(fluid, mobilenet, batch, is_train=is_train,
                                  nms=SSD_NMS, **SSD)
        main.random_seed = startup.random_seed = 2024
        return main, startup, h

    main, startup, h = build(SSD_BATCH, True)
    loss = h["loss"]
    check(h["box"].shape[0] == SSD_PRIORS, "ssd: %s priors, not %d"
          % (h["box"].shape, SSD_PRIORS))
    feed = ssd_feed(SSD_BATCH, seed=2024, **SSD)
    (eager, graph, losses, unequal, eager_runs, launches,
     walls) = lockstep_steps(fa, main, startup, loss, feed, SSD_STEPS)
    entries = captured(graph[0].engine)
    emit({"phase": "ssd", "card": smi, "config": SSD, "batch": SSD_BATCH,
          "priors": SSD_PRIORS,
          "params": sum(int(np.prod(p.shape)) for p in main.all_parameters()),
          "losses": losses, "unequal_state": unequal[:10],
          "graphs": len(entries), "eager_runs": eager_runs,
          "launches": launches, "captured_run_walls_ms": walls})
    lockstep_checks("ssd", losses, unequal, entries, eager_runs, launches)
    peak = eager_step_peak(eager[0], eager[1], main, loss, feed)
    cap = profiled_step(graph[0], graph[1], main, loss, feed, n=5,
                        profiled_steps=2)
    emit(dict({"phase": "times", "card": smi,
               "profile": "ssd training step", "run": "captured",
               "batch": SSD_BATCH,
               "images_per_s": SSD_BATCH / (cap["median_ms"] / 1e3),
               "eager_step_peak_bytes": peak, "tf32": False}, **cap))
    del eager, graph, entries
    release_memory()

    # one step on the card and on the CPU from the same state: the loss
    # end to end, every op on the CPU's operands (the grads end to end
    # printed: at random init the batch norms over the 2 x 2 and 1 x 1
    # maps magnify float32 rounding by orders of magnitude on the way
    # down and back, as in ResNet-50 and the image models)
    cpu_main, cpu_startup, cpu_h = build(SSD_CPU_BATCH, True)
    cpu_state = start_state(cpu_main, cpu_startup)
    cpu_feed = ssd_feed(SSD_CPU_BATCH, seed=2025, **SSD)
    row, _ = card_cpu_step(cpu_main, cpu_state, cpu_h["loss"], cpu_feed)
    worst, _, _ = replay_ops_on_card(cpu_main, cpu_state, cpu_feed,
                                     IMAGE_OP_TOL)
    grads = row.pop("grad_rel_to_max")
    emit({"phase": "ssd", "card": smi, "cpu_step": dict(
        row, batch=SSD_CPU_BATCH, ops_rel_to_max=worst,
        ops_tol=IMAGE_OP_TOL,
        grads_end_to_end_rel_to_max_worst=max(grads.items(),
                                              key=lambda kv: kv[1]),
        grads_end_to_end_rel_to_max_median=float(np.median(
            list(grads.values()))))})
    check(row["loss_abs_err"] <= TRAIN_TOL["loss_rtol"]
          * abs(row["loss_cpu"]), "ssd: the card's loss off the CPU's: "
          "%s / %s" % (row["loss_card"], row["loss_cpu"]))
    release_memory()

    # served: the inference build with the initial weights, its batch
    # norms on the statistics of one training batch (3 steps leave the
    # running ones 27 % of the way from (0, 1) to the data's, and the
    # summed per-image loss, every negative weighted, at the paper's lr
    # blows the head's logits up: its scores saturate and its boxes
    # overflow)
    served = start_state(main, startup)
    bns = [(op.input("Mean")[0], op.output("SavedMean")[0],
            op.input("Variance")[0], op.output("SavedVariance")[0])
           for op in main.desc.global_block().ops if op.type == "batch_norm"]
    exe0, scope0 = fresh(startup, graphs=False)
    with fluid.scope_guard(scope0):
        stats = exe0.run(main, feed=feed, fetch_list=[
            n for _, saved_mean, _, saved_var in bns
            for n in (saved_mean, saved_var)])
    for k, (mean, _, var, _) in enumerate(bns):
        served[mean] = np.asarray(stats[2 * k]).reshape(served[mean].shape)
        served[var] = np.asarray(stats[2 * k + 1]).reshape(
            served[var].shape)
    del exe0, scope0, stats
    test_main, _, th = build(1, False)
    fetch = [th[k] for k in ("dets", "scores", "locs", "box", "var")]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssd_") as d:
        scope = fluid.Scope()
        convert.load_numpy_state(scope, {
            k: v for k, v in served.items()
            if test_main.global_block().has_var(k)}, "cuda",
            program=test_main)
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, ["image"], fetch,
                                          fluid.Executor(fluid.CUDAPlace(0)),
                                          main_program=test_main)
        del scope
        predictor = inference.create_paddle_predictor(
            inference.AnalysisConfig(d))
        cpu_cfg = inference.AnalysisConfig(d)
        cpu_cfg.disable_gpu()
        cpu_pred = inference.create_paddle_predictor(cpu_cfg)
        torch.cuda.synchronize()
        fa.launches = fa.launches_dq = fa.launches_dkv = 0  # path starts
        served, dets8 = {}, None
        for b in SSD_SERVE_BATCHES:
            req_feed = ssd_feed(b, seed=300 + b, **SSD)
            req = {"image": req_feed["image"]}
            card = [t.data for t in predictor.run(req)]
            cpu = [t.data for t in cpu_pred.run(req)]
            head = dict(zip(("scores", "locs", "box", "var"), card[1:]))
            same, match = detections_match(card[0], cpu[0], **SERVE_TOL)
            # the same inputs: only the decode's rounding (a fused
            # multiply-add on the card) may move a box
            own, own_match = detections_match(
                card[0], nms_on_host(head, SSD_NMS), rtol=1e-5, atol=1e-6)
            served[b] = {
                "shape": list(card[0].shape), "detections": match,
                "head_max_abs_err": [float(np.abs(a - c).max())
                                     for a, c in zip(card[1:3], cpu[1:3])],
                "head_close": all(np.allclose(a, c, **SERVE_TOL)
                                  for a, c in zip(card[1:], cpu[1:])),
                "detections_close": same,
                "nms_of_card_head_on_cpu_equal": own,
                "nms_of_card_head_on_cpu": own_match,
                "request_ms": timed_runs(lambda r=req: predictor.run(r),
                                         n=5)}
            if b == 8:
                dets8 = (card[0], map_ground_truth(req_feed))
        serve_launches = flash_launches(fa)  # ... and ends here
    emit({"phase": "ssd", "card": smi, "serve": served, "tol": SERVE_TOL,
          "nms": SSD_NMS, "launches": serve_launches})
    check(all(r["head_close"] and r["detections_close"]
              and r["nms_of_card_head_on_cpu_equal"]
              and r["shape"] == [b, SSD_NMS["keep_top_k"], 6]
              for b, r in served.items()),
          "ssd served off the CPU's: %s" % served)
    check(not any(serve_launches.values()), "flash launches serving ssd: "
          "%s" % serve_launches)
    del predictor, cpu_pred

    # mAP of the batch-8 detections, on the host through py_func
    with unique_name.guard():
        map_main, map_startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(map_main, map_startup):
            m_ap = detection_map_program(fluid, SSD_NMS["keep_top_k"],
                                         SSD["gt_boxes"], SSD["classes"])
    values = {}
    for device, place in (("cuda", fluid.CUDAPlace(0)),
                          ("cpu", fluid.CPUPlace())):
        obs.set_enabled(True)
        obs.reset()
        with fluid.scope_guard(fluid.Scope()):
            (v,) = fluid.Executor(place).run(
                map_main, feed={"dets": dets8[0], "gts": dets8[1]},
                fetch_list=[m_ap])
        values[device] = (float(np.asarray(v).reshape(-1)[0]),
                          obs.counter_value("engine.eager_runs"))
        obs.set_enabled(None)
    emit({"phase": "ssd", "card": smi, "detection_map": {
        "map_card": values["cuda"][0], "map_cpu": values["cpu"][0],
        "eager_runs_card": values["cuda"][1]}})
    check(values["cuda"][0] == values["cpu"][0]
          and np.isfinite(values["cuda"][0]) and values["cuda"][1] == 1,
          "ssd: detection_map %s" % values)
    release_memory()
    return {k: launches[k] + serve_launches[k] for k in launches}


def _ctc_loss_library(ctx, ins, attrs):
    """``F.ctc_loss`` (cuDNN's or ATen's CTC; its CUDA backward adds with
    atomics) on the log-softmax of the logits: a witness beside the
    port's ``warpctc``."""
    import torch.nn.functional as F

    logits = ins["Logits"][0]
    loss = F.ctc_loss(F.log_softmax(logits.float(), -1).transpose(0, 1),
                      ins["Label"][0], ins["LogitsLength"][0].reshape(-1),
                      ins["LabelLength"][0].reshape(-1),
                      blank=int(attrs.get("blank", 0)), reduction="none")
    return {"Loss": [loss.reshape(-1, 1).to(logits.dtype)]}


DETECTION_WITNESS = {"warpctc": {"F.ctc_loss": _ctc_loss_library}}


def detection_cases():
    """(name, op type, a function of a RandomState giving the inputs as
    numpy arrays, attrs) of the detection_ops phase: every lowering of the
    detection and CTC families at the shapes its users give it: SSD's
    1917 priors, 21 classes and batch 8 (the matching ops at 16 ground
    truths an image, one image a layer as ``ssd_loss`` runs them, the
    match batched over 32); Faster R-CNN's RPN on a ResNet-50-C4 map of
    an 800 x 1333 image (50 x 84, 15 anchors: 63,000; pre/post NMS
    6000/1000 at 0.7; 256 anchors an image at 0.5 positive); its
    second-stage sampler at 512 RoIs and 0.25 foreground over 81 classes;
    RoI align and pool at 14 x 14 and 1/16 on 1024 channels; Mask R-CNN's
    mask targets at resolution 14; YOLOv3 at 608 (Redmon and Farhadi
    2018, arXiv 1804.02767: 19/38/76 maps, 80 classes, 9 anchors, 50
    ground truths); an EAST-style text detector's geometry and quads at a
    128 x 128 map; a line recogniser's CTC and edit distance (batch 32,
    96 steps, 96 classes, labels of 10-30 ids)."""
    import torch

    import paddle_tpu_torch.ops  # noqa: F401  (registers the lowerings)

    def f(*shape, scale=1.0):
        return lambda rng: (np.random.default_rng(rng.randint(2 ** 31))
                            .standard_normal(shape, dtype=np.float32)
                            * np.float32(scale))

    def ins(**makers):
        return lambda rng: {slot: [m(rng) for m in ms]
                            for slot, ms in makers.items()}

    def const(value):
        return lambda rng: value

    def boxes(rng, n, extent=(1.0, 1.0), lo=0.05, hi=0.4):
        ext = np.asarray(extent, np.float32)
        xy = rng.uniform(0, 1 - hi, (n, 2)) * ext
        wh = rng.uniform(lo, hi, (n, 2)) * ext
        return np.concatenate([xy, xy + wh], 1).astype(np.float32)

    def iou(a, b):
        return lower_op("iou_similarity", {
            "X": [torch.from_numpy(a)], "Y": [torch.from_numpy(b)]},
            {"box_normalized": True}, "cpu")["Out"][0].numpy()

    priors = boxes(np.random.RandomState(11), SSD_PRIORS, lo=0.02, hi=0.5)
    pvar = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (SSD_PRIORS, 1))
    ssd_nms = dict(SSD_NMS, background_label=0, normalized=True,
                   nms_eta=1.0)
    img_hw = (1333.0, 800.0)     # (x, y) extent of the Faster R-CNN image
    rpn_anchors = lower_op("anchor_generator", {
        "Input": [torch.empty((1, 1, 50, 84))]},
        {"anchor_sizes": [32.0, 64.0, 128.0, 256.0, 512.0],
         "aspect_ratios": [0.5, 1.0, 2.0], "stride": [16.0, 16.0],
         "variances": [1.0, 1.0, 1.0, 1.0], "offset": 0.5}, "cpu")
    anchors = rpn_anchors["Anchors"][0].numpy()
    im_info = np.float32([[800.0, 1333.0, 1.0]])
    yolo_anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116,
                    90, 156, 198, 373, 326]

    def ssd_match(rng):
        return np.stack([iou(boxes(rng, 16), priors) for _ in range(32)])

    def match_row(rng):
        m = np.full((1, SSD_PRIORS), -1, np.int32)
        hit = rng.choice(SSD_PRIORS, 120, replace=False)
        m[0, hit] = rng.randint(0, 16, 120)
        return m

    def nms_boxes(rng):
        return np.stack([boxes(rng, SSD_PRIORS, lo=0.02, hi=0.6)
                         for _ in range(8)])

    def class_probs(rng):
        z = rng.randn(8, SSD["classes"], SSD_PRIORS) * 2.0
        e = np.exp(z - z.max(1, keepdims=True))
        return (e / e.sum(1, keepdims=True)).astype(np.float32)

    def gts(rng, n=20):
        return boxes(rng, n, img_hw, 0.03, 0.3)

    def proposals(rng):
        # 2000 proposals, a third of them jittered ground truths
        g = gts(np.random.RandomState(5))
        near = g[rng.randint(0, 20, 700)] + rng.randn(700, 4).astype(
            np.float32) * 20.0
        return np.concatenate([near, boxes(rng, 1300, img_hw, 0.02, 0.4)]
                              ).astype(np.float32)

    def polygons(rng):
        g = gts(np.random.RandomState(5))
        segms = np.zeros((20, 2, 30, 2), np.float32)
        lens = np.zeros((20, 2), np.int32)
        for i, (x1, y1, x2, y2) in enumerate(g):
            for k in range(2):
                n = rng.randint(8, 31)
                ang = np.sort(rng.uniform(0, 2 * np.pi, n))
                rad = rng.uniform(0.3, 0.5, (n, 1))
                c = np.float32([(x1 + x2) / 2, (y1 + y2) / 2])
                half = np.float32([(x2 - x1) / 2, (y2 - y1) / 2])
                segms[i, k, :n] = c + rad * half * np.stack(
                    [np.cos(ang), np.sin(ang)], 1) * (1 + k)
                lens[i, k] = n
        return segms, lens

    def mask_rois(rng):
        g = gts(np.random.RandomState(5))
        fg = g[rng.randint(0, 20, 128)] + rng.randn(128, 4).astype(
            np.float32) * 8.0
        return np.concatenate([fg, boxes(rng, 384, img_hw, 0.02, 0.4)]
                              ).astype(np.float32)

    def mask_labels(rng):
        return np.concatenate([rng.randint(1, 81, 128),
                               np.zeros(384, np.int64)]).astype(np.int32)

    def quads(rng, r=64, size=512.0):
        out = np.zeros((r, 8), np.float32)
        for i in range(r):
            x0, y0 = rng.uniform(8, size * 0.6, 2)
            w, h = rng.uniform(64, 200), rng.uniform(12, 40)
            a = rng.uniform(-0.3, 0.3)
            ca, sa = np.cos(a), np.sin(a)
            pts = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
            rot = pts @ np.float32([[ca, sa], [-sa, ca]])
            out[i] = (rot + [x0, y0]).reshape(-1)
        return out

    def yolo_gt(rng):
        box = np.zeros((8, 50, 4), np.float32)
        for b in range(8):
            n = rng.randint(5, 31)
            box[b, :n, :2] = rng.uniform(0.05, 0.95, (n, 2))
            box[b, :n, 2:] = rng.uniform(0.02, 0.5, (n, 2))
        return box

    def ctc_lens(rng):
        return (96 - rng.randint(0, 16, 32)).astype(np.int64)

    def label_lens(rng):
        return rng.randint(10, 31, 32).astype(np.int64)

    def ids(rng, high=96):
        return rng.randint(1, high, (32, 30)).astype(np.int64)

    def yolo(name, hw, mask, downsample):
        return ("yolov3_loss_" + name, "yolov3_loss", ins(
            X=[f(8, 255, hw, hw, scale=0.5)], GTBox=[yolo_gt],
            GTLabel=[lambda rng: rng.randint(0, 80, (8, 50)).astype(
                np.int64)]),
            {"anchors": yolo_anchors, "anchor_mask": mask, "class_num": 80,
             "ignore_thresh": 0.7, "downsample_ratio": downsample})

    return [
        ("prior_box_ssd_19x19", "prior_box", ins(
            Input=[f(32, 512, 19, 19)], Image=[f(32, 3, 300, 300)]),
         {"min_sizes": [60.0], "max_sizes": [], "aspect_ratios": [2.0],
          "variances": [0.1, 0.1, 0.2, 0.2], "flip": True, "clip": True,
          "step_w": 0.0, "step_h": 0.0, "offset": 0.5,
          "min_max_aspect_ratios_order": False}),
        ("density_prior_box_pyramidbox_160", "density_prior_box", ins(
            Input=[f(1, 256, 160, 160)], Image=[f(1, 3, 640, 640)]),
         {"densities": [4, 2, 1], "fixed_sizes": [32.0, 64.0, 128.0],
          "fixed_ratios": [1.0], "variances": [0.1, 0.1, 0.2, 0.2],
          "clip": True, "step_w": 0.0, "step_h": 0.0, "offset": 0.5}),
        ("anchor_generator_rpn_c4", "anchor_generator", ins(
            Input=[f(1, 1024, 50, 84)]),
         {"anchor_sizes": [32.0, 64.0, 128.0, 256.0, 512.0],
          "aspect_ratios": [0.5, 1.0, 2.0], "stride": [16.0, 16.0],
          "variances": [1.0, 1.0, 1.0, 1.0], "offset": 0.5}),
        ("box_coder_encode_ssd", "box_coder", ins(
            PriorBox=[const(priors)], PriorBoxVar=[const(pvar)],
            TargetBox=[lambda rng: boxes(rng, 16)]),
         {"code_type": "encode_center_size", "box_normalized": True}),
        ("box_coder_decode_ssd", "box_coder", ins(
            PriorBox=[const(priors)], PriorBoxVar=[const(pvar)],
            TargetBox=[f(8, SSD_PRIORS, 4, scale=0.5)]),
         {"code_type": "decode_center_size", "box_normalized": True,
          "axis": 0}),
        ("iou_similarity_ssd", "iou_similarity", ins(
            X=[lambda rng: boxes(rng, 16)], Y=[const(priors)]),
         {"box_normalized": True}),
        ("box_clip_rpn", "box_clip", ins(
            Input=[f(2, 1000, 4, scale=700.0)],
            ImInfo=[const(np.float32([[800, 1333, 1], [600, 1000, 0.75]]))]),
         {}),
        ("polygon_box_transform_east", "polygon_box_transform", ins(
            Input=[f(8, 8, 128, 128, scale=20.0)]), {}),
        ("bipartite_match_ssd_batch32", "bipartite_match", ins(
            DistMat=[ssd_match]),
         {"match_type": "per_prediction", "dist_threshold": 0.5}),
        ("target_assign_ssd_labels", "target_assign", ins(
            X=[lambda rng: rng.randint(1, 21, (16, 1)).astype(np.int64)],
            MatchIndices=[match_row]), {"mismatch_value": 0}),
        ("gather_encoded_ssd", "gather_encoded", ins(
            Encoded=[f(16, SSD_PRIORS, 4)], MatchIndices=[match_row]), {}),
        ("multiclass_nms_ssd", "multiclass_nms", ins(
            BBoxes=[nms_boxes], Scores=[class_probs]), ssd_nms),
        ("generate_proposals_rpn_c4", "generate_proposals", ins(
            Scores=[lambda rng: (1.0 / (1.0 + np.exp(-f(2, 15, 50, 84)(
                rng)))).astype(np.float32)],
            BboxDeltas=[f(2, 60, 50, 84, scale=0.1)],
            ImInfo=[const(np.concatenate([im_info, im_info]))],
            Anchors=[const(anchors)],
            Variances=[const(np.ones_like(anchors))]),
         {"pre_nms_topN": 6000, "post_nms_topN": 1000, "nms_thresh": 0.7,
          "min_size": 0.0, "eta": 1.0}),
        ("rpn_target_assign_c4", "rpn_target_assign", ins(
            Anchor=[const(anchors.reshape(-1, 4))], GtBoxes=[gts],
            IsCrowd=[const(np.zeros((20,), np.int32))],
            ImInfo=[const(im_info)]),
         {"rpn_batch_size_per_im": 256, "rpn_fg_fraction": 0.5,
          "rpn_positive_overlap": 0.7, "rpn_negative_overlap": 0.3,
          "rpn_straddle_thresh": 0.0, "use_random": True}),
        ("generate_proposal_labels_512", "generate_proposal_labels", ins(
            RpnRois=[proposals],
            GtClasses=[lambda rng: rng.randint(1, 81, (20, 1)).astype(
                np.int32)],
            GtBoxes=[lambda rng: gts(np.random.RandomState(5))],
            IsCrowd=[const(np.zeros((20, 1), np.int32))],
            ImInfo=[const(im_info)],
            RpnRoisNum=[const(np.int32([2000]))]),
         {"batch_size_per_im": 512, "fg_fraction": 0.25, "fg_thresh": 0.5,
          "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0,
          "bbox_reg_weights": [0.1, 0.1, 0.2, 0.2], "class_nums": 81,
          "use_random": True}),
        ("roi_align_c4_14x14", "roi_align", ins(
            X=[f(2, 1024, 50, 84)],
            ROIs=[lambda rng: boxes(rng, 128, img_hw, 0.02, 0.4)],
            RoisBatchIdx=[lambda rng: rng.randint(0, 2, 128).astype(
                np.int32)]),
         {"pooled_height": 14, "pooled_width": 14, "spatial_scale": 0.0625,
          "sampling_ratio": 2}),
        ("roi_pool_c4_14x14", "roi_pool", ins(
            X=[f(2, 1024, 50, 84)],
            ROIs=[lambda rng: boxes(rng, 128, img_hw, 0.02, 0.4)],
            RoisBatchIdx=[lambda rng: rng.randint(0, 2, 128).astype(
                np.int32)]),
         {"pooled_height": 14, "pooled_width": 14,
          "spatial_scale": 0.0625}),
        ("roi_perspective_transform_east", "roi_perspective_transform", ins(
            X=[f(2, 128, 128, 128)], ROIs=[quads],
            RoisBatchIdx=[lambda rng: rng.randint(0, 2, 64).astype(
                np.int32)]),
         {"transformed_height": 8, "transformed_width": 64,
          "spatial_scale": 0.25}),
        yolo("19x19", 19, [6, 7, 8], 32),
        yolo("38x38", 38, [3, 4, 5], 16),
        yolo("76x76", 76, [0, 1, 2], 8),
        ("generate_mask_labels_maskrcnn_14", "generate_mask_labels", ins(
            ImInfo=[const(im_info)],
            GtClasses=[lambda rng: rng.randint(1, 81, (20, 1)).astype(
                np.int32)],
            IsCrowd=[const(np.zeros((20, 1), np.int32))],
            GtSegms=[lambda rng: polygons(np.random.RandomState(6))[0]],
            GtPolyLens=[lambda rng: polygons(np.random.RandomState(6))[1]],
            Rois=[mask_rois], LabelsInt32=[mask_labels]),
         {"num_classes": 81, "resolution": 14}),
        ("similarity_focus_text_32", "similarity_focus", ins(
            X=[f(32, 2, 32, 32)]), {"axis": 1, "indexes": [0, 1]}),
        ("warpctc_line_32x96", "warpctc", ins(
            Logits=[f(32, 96, 96)], Label=[ids], LogitsLength=[ctc_lens],
            LabelLength=[label_lens]),
         {"blank": 0, "norm_by_times": False}),
        ("edit_distance_line_32", "edit_distance", ins(
            Hyps=[ids], Refs=[ids], HypsLength=[label_lens],
            RefsLength=[label_lens]),
         {"normalized": True, "ignored_tokens": []}),
    ]


def phase_detection_ops(fa, smi):
    """Every lowering of the detection and CTC families
    (``detection_cases``) through ``phase_op_cases``, the DETECTION_TWICE
    ops twice, ``F.ctc_loss`` beside ``warpctc``; each case's launches a
    call; then the greedy NMS scan (``greedy_keep``) alone at
    ``generate_proposals``' and ``multiclass_nms``' shapes, its device ms
    and launches (``kernel_launches``) and its share of the op's ms.
    Returns the flash launches (none)."""
    import torch

    from paddle_tpu_torch.ops.detection_ops import greedy_keep

    rows = []
    # one call a case in the window (the default): the RPN's scan launches
    # 30,000 kernels a call, and the profiler's host events cost seconds
    launches = phase_op_cases(fa, smi, "detection_ops", detection_cases(),
                              DETECTION_TWICE, DETECTION_WITNESS, rows=rows)
    by_case = {r["case"]: r for r in rows}
    scans = {}
    for case, shape in (("generate_proposals_rpn_c4", (2, 6000)),
                        ("multiclass_nms_ssd", (8, SSD["classes"] - 1,
                                                SSD_NMS["nms_top_k"]))):
        g = torch.Generator(device="cuda").manual_seed(7)
        over = torch.rand(shape + shape[-1:], device="cuda",
                          generator=g) < 0.01
        valid = torch.rand(shape, device="cuda", generator=g) < 0.9
        scan = functools.partial(greedy_keep, over, valid)
        scan()
        count, ms = kernel_launches(scan)
        scans[case] = {"shape": list(shape), "ms": ms, "launches": count,
                       "share_of_op": ms / by_case[case]["ms"]}
        del over, valid
    emit({"phase": "detection_ops", "card": smi, "greedy_nms_scan": scans})
    release_memory()
    return launches


def filesystem_of(path):
    """(mount point, type, device) of the filesystem holding ``path``,
    from /proc/mounts (the longest mount point that contains it)."""
    path = os.path.realpath(path)
    best = ("?", "?", "?")
    with open("/proc/mounts") as f:
        for ln in f:
            dev, mnt, fstype = ln.split()[:3]
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and (best[0] == "?" or len(mnt) > len(best[0])):
                best = (mnt, fstype, dev)
    return best


def phase_checkpoint(fa, smi):
    """Checkpoints on the card: BERT-base (``bert_train_program``,
    dropout 0 for the bitwise checks), Adam, float32, captured with the
    state donated (written in place at every replay), the steps run in a
    dispatch window of 2 so a save is enqueued while its step may still
    run. ``io.save_checkpoint_async`` after step CKPT_SAVE_AT under
    ``PADDLE_GPU_FAULT_SPEC=ckpt_write@<s>``, training on at once to step
    CKPT_STEPS: the write fails once and its retry publishes the step
    (``recovery.ckpt_retry`` 1). Then ``step_nan`` at the next step: the
    deferred nan guard names that step; ``io.load_checkpoint`` restores
    step s in place (no recapture), every var bitwise equal to a device
    copy taken at step s, and steps s+1..CKPT_STEPS replayed with the
    same feeds give the uninterrupted run's losses bitwise. Times (with
    the card's name and power limit): CKPT_PLAIN_STEPS steps without
    saves; then a loop that saves after each of its first
    CKPT_TIMED_SAVES steps and trains on until every write has published
    (or CKPT_LOOP_CAP_S, then it waits for them): each step's ms, each
    snapshot's ms on the step thread, each write's wall (``ckpt.write_ms``,
    transfer to publish) and bytes, and the hidden fraction, 1 - (the
    loop's wall - its steps x the plain step) / the writes' walls. The
    root is a temporary directory of the machine's disk (its filesystem
    printed). Then the trained encoder
    saved in the native and the reference format and served from each on
    the card: the answers bitwise equal. Returns the flash launches."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import compat, flags, unique_name
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.resilience import faultinject

    t_phase = time.perf_counter()
    main, startup, loss = bert_train_program(amp=False, dropout=0.0)
    feeds = [train_feed(8, np.random.RandomState(300 + i))
             for i in range(CKPT_STEPS + 1)]
    exe, scope = fresh(startup)
    names = [v.name for v in main.list_vars()
             if v.persistable and scope.get(v.name) is not None]
    state_bytes = sum(scope.get(n).numel() * scope.get(n).element_size()
                      for n in names)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    mount, fstype, fsdev = filesystem_of(tmp)
    st = os.statvfs(tmp)
    mgr = fluid.io.CheckpointManager(os.path.join(tmp, "ckpt"))

    def step(i, **kw):
        with fluid.scope_guard(scope):
            return exe.run(main, feed=feeds[i - 1], fetch_list=[loss], **kw)

    def write_walls():
        hist = obs.registry.histogram("ckpt.write_ms")
        return list(hist.samples) if hist is not None else []

    def arm(spec):
        flags.set_flags({"fault_spec": spec})
        faultinject.reset()

    obs.set_enabled(True)
    obs.reset()
    torch.cuda.synchronize()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    try:
        for i in range(1, CKPT_SAVE_AT + 1):
            step(i, dispatch_steps=2)
        s = CKPT_SAVE_AT
        # a device copy of step s's state, ordered like the snapshot
        ref = {n: scope.get(n).clone() for n in names}
        arm("ckpt_write@%d" % s)
        t0 = time.perf_counter()
        fluid.io.save_checkpoint_async(mgr, s, main_program=main,
                                       scope=scope)
        first_snapshot_ms = (time.perf_counter() - t0) * 1000.0
        outs = [step(i, dispatch_steps=2)
                for i in range(s + 1, CKPT_STEPS + 1)]
        exe.sync()
        uninterrupted = [float(o[0]) for o in outs]
        moved = sum(not torch.equal(scope.get(n), ref[n]) for n in names)
        t0 = time.perf_counter()
        mgr.wait()
        first_wait_ms = (time.perf_counter() - t0) * 1000.0
        mgr.check_error()
        retries = obs.counter_value("recovery.ckpt_retry")
        flags.reset_flag("fault_spec")
        faultinject.reset()

        # the rollback: a NaN at the next step, the guard, the restore
        exe.engine.check_nan_inf = True
        bad = exe.engine._run_counter + 1
        arm("step_nan@%d" % bad)
        nan_error = None
        try:
            step(CKPT_STEPS + 1, dispatch_steps=2)
            exe.sync()
        except RuntimeError as e:
            nan_error = str(e)
        flags.reset_flag("fault_spec")
        faultinject.reset()
        exe.engine.discard_window()
        exe.engine.check_nan_inf = False
        entries = captured(exe.engine)
        captures = [c.captures for c in entries]
        recaptures = obs.counter_value("engine.recapture")
        held = {n: scope.get(n) for n in names}
        t0 = time.perf_counter()
        fluid.io.load_checkpoint(mgr, main_program=main, scope=scope, step=s)
        restore_ms = (time.perf_counter() - t0) * 1000.0
        in_place = all(scope.get(n) is t for n, t in held.items())
        # what the files held (restored in place), byte for byte against
        # the device copy of step s
        torn = [n for n in names if not torch.equal(
            scope.get(n).reshape(-1).view(torch.uint8),
            ref[n].reshape(-1).view(torch.uint8))]
        del ref
        outs = [step(i, dispatch_steps=2)
                for i in range(s + 1, CKPT_STEPS + 1)]
        exe.sync()
        replayed = [float(o[0]) for o in outs]
        recaptures = obs.counter_value("engine.recapture") - recaptures
        captures_after = [c.captures for c in captured(exe.engine)]

        # times: steps without saves, then a loop that saves after each
        # of its first steps and trains on while the writes run
        def plain_steps():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CKPT_PLAIN_STEPS):
                step(CKPT_STEPS)
            return (time.perf_counter() - t0) * 1000.0 / CKPT_PLAIN_STEPS

        plain_before = plain_steps()
        walls_before = len(write_walls())
        step_ms, snapshot_ms = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            step(CKPT_STEPS)
            k = len(step_ms)
            if k < CKPT_TIMED_SAVES:
                t2 = time.perf_counter()
                fluid.io.save_checkpoint_async(mgr, 100 + k,
                                               main_program=main,
                                               scope=scope)
                snapshot_ms.append((time.perf_counter() - t2) * 1000.0)
            step_ms.append((time.perf_counter() - t1) * 1000.0)
            if len(step_ms) >= CKPT_TIMED_SAVES and not mgr.in_flight:
                break
            if time.perf_counter() - t0 > CKPT_LOOP_CAP_S:
                break
        capped = mgr.in_flight
        mgr.wait()
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) * 1000.0
        mgr.check_error()
        written = [sum(os.path.getsize(os.path.join(d, f))
                       for f in os.listdir(d))
                   for d in (os.path.join(mgr.root, "step_%d" % (100 + k))
                             for k in range(CKPT_TIMED_SAVES))]
        timed_walls = write_walls()[walls_before:]
        # the plain step before and after the loop, for drift
        plain_after = plain_steps()
        plain_ms = (plain_before + plain_after) / 2.0
        extra_ms = loop_ms - len(step_ms) * plain_ms
        hidden = 1.0 - extra_ms / sum(timed_walls)
        hist = obs.snapshot()["histograms"].get("ckpt.snapshot_ms", {})
        saving = sorted(step_ms[CKPT_TIMED_SAVES:])

        # the trained encoder served from the native and the reference
        # format: the eager and the captured answers of each
        with unique_name.guard():
            infer, _, handles = bert.get_model(
                batch_size=8, dropout=0.0, is_train=False, **BERT)
        feed_names = ["src_ids", "pos_ids", "sent_ids", "seq_lens"]
        request = bert_feed(8, np.random.RandomState(301))
        answers = {}
        export_s = {}
        for fmt in ("native", "reference"):
            d = os.path.join(tmp, fmt)
            t0 = time.perf_counter()
            with fluid.scope_guard(scope):
                fluid.io.save_inference_model(
                    d, feed_names, [handles["enc_out"]], exe,
                    main_program=infer, export_format=fmt)
            export_s[fmt] = time.perf_counter() - t0
            served, served_scope = fluid.Executor(), fluid.Scope()
            with fluid.scope_guard(served_scope):
                if fmt == "native":
                    prog, _, fetch = fluid.io.load_inference_model(d, served)
                else:
                    prog, _, fetch = compat.load_reference_inference_model(
                        d, served, scope=served_scope)
                answers[fmt] = [served.run(
                    prog, feed=request, fetch_list=[v.name for v in fetch])[0]
                    for _ in range(2)]
        torch.cuda.synchronize()
        launches = flash_launches(fa)  # ... and ends here
    finally:
        flags.reset_flag("fault_spec")
        faultinject.reset()
        obs.set_enabled(None)
        shutil.rmtree(tmp, ignore_errors=True)
    want = answers["native"][0]
    served_equal = all(np.array_equal(a, want) for a in
                       answers["native"] + answers["reference"])
    emit({"phase": "checkpoint", "nvidia_smi": smi, "model": "bert_base",
          "batch": 8, "seq_len": BERT["seq_len"], "dropout": 0.0,
          "state_vars": len(names), "state_gb": state_bytes / 1e9,
          "root": {"mount": mount, "fstype": fstype, "device": fsdev,
                   "free_gb": st.f_bavail * st.f_frsize / 1e9},
          "saved_step": s, "ckpt_write_retries": retries,
          "torn_vars": torn[:10], "vars_moved_since_save": moved,
          "losses_uninterrupted": uninterrupted,
          "losses_after_rollback": replayed,
          "nan_error": nan_error, "nan_step": bad,
          "restored_in_place": in_place, "recaptures": recaptures,
          "captures": [captures, captures_after],
          "served_shape": list(np.shape(want)),
          "served_bitwise_equal": served_equal,
          "export_s": export_s, "launches": launches})
    emit({"phase": "checkpoint", "times": {
        "nvidia_smi": smi,
        "step_ms": plain_ms, "plain_steps": CKPT_PLAIN_STEPS,
        "step_ms_before_after": [plain_before, plain_after],
        "saves": CKPT_TIMED_SAVES, "loop_steps": len(step_ms),
        "loop_ms": loop_ms, "loop_capped": capped,
        "saving_step_ms": step_ms[:CKPT_TIMED_SAVES],
        "later_step_ms": {"median": saving[len(saving) // 2],
                          "max": saving[-1], "min": saving[0]}
        if saving else None,
        "first_snapshot_ms": first_snapshot_ms,
        "first_save_wait_ms": first_wait_ms, "restore_ms": restore_ms,
        "snapshot_ms": snapshot_ms, "snapshot_hist_ms": hist,
        "write_wall_ms": write_walls(),
        "written_gb": [b / 1e9 for b in written],
        "loop_extra_ms": extra_ms, "hidden_fraction": hidden,
        "phase_s": time.perf_counter() - t_phase}})
    check(retries == 1, "ckpt_write: %d retries, want 1" % retries)
    check(not torn, "restored vars differ from step %d: %s" % (s, torn[:5]))
    check(moved > 0, "no var changed after the save: the check is void")
    check(nan_error is not None and ("after step %d" % bad) in nan_error,
          "the nan guard at step %d: %s" % (bad, nan_error))
    check(in_place and recaptures == 0 and captures == captures_after,
          "the restore: in place %s, recaptures %d, captures %s -> %s"
          % (in_place, recaptures, captures, captures_after))
    check(replayed == uninterrupted and all(np.isfinite(replayed)),
          "losses after the rollback %s, uninterrupted %s"
          % (replayed, uninterrupted))
    check(served_equal and np.shape(want) == (8, BERT["seq_len"],
                                              BERT["d_model"]),
          "the reference format's answers differ from the native one's")
    return launches


# -- the opt-level ladder and the INT8 serving path --------------------------


def transform_counters():
    """The metrics registry's transform counters and its
    ``transform.pipeline_ms`` histogram's count and total, for
    ``transform_report``."""
    from paddle_tpu_torch import observability as obs

    snap = obs.snapshot()
    hist = snap["histograms"].get("transform.pipeline_ms", {})
    return (dict(snap["counters"]), hist.get("count", 0),
            hist.get("total", 0.0))


def transform_report(before, level):
    """What the engine's transforms did since ``transform_counters()``
    gave ``before`` (the metrics gate up): rewrites and crashes by pass,
    ops pruned, pipeline runs and their ms (the ``transform.pipeline_ms``
    histogram, the pipeline's host wall)."""
    (c0, n0, ms0), (c1, n1, ms1) = before, transform_counters()

    def by_pass(suffix):
        out = {}
        for k, v in c1.items():
            name = k[len("transform."):-len(suffix)]
            if (k.startswith("transform.") and k.endswith(suffix)
                    and name and v - c0.get(k, 0)):
                out[name] = v - c0.get(k, 0)
        return out

    return {"level": level, "rewrites": by_pass(".rewrites"),
            "crashed": by_pass(".crashes"),
            "pruned": c1.get("transform.pruned_ops", 0)
            - c0.get("transform.pruned_ops", 0),
            "pipeline_runs": n1 - n0, "transform_pipeline_ms": ms1 - ms0}


def serving_bert_program():
    """BERT-base's encoder built for serving (``is_train=False``, the
    train program's parameter names): (program, encoder output)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        T = BERT["seq_len"]
        data = {n: fluid.layers.data(name=n, shape=[T], dtype="int64")
                for n in ("src_ids", "pos_ids", "sent_ids")}
        seq_lens = fluid.layers.data(name="seq_lens", shape=[1],
                                     dtype="int64")
        enc = bert.bert_encoder(
            data["src_ids"], data["pos_ids"], data["sent_ids"], seq_lens,
            BERT["vocab_size"], max_position=BERT["max_position"],
            d_model=BERT["d_model"], n_layers=BERT["n_layers"],
            n_heads=BERT["n_heads"], d_inner=BERT["d_inner"], dropout=0.0,
            is_train=False, use_fused_attention=True)
    return main, enc


def rel_worst(a, b):
    """Worst |a - b| / |b| over two lists of losses."""
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def phase_opt_levels(fa, smi):
    """BERT-base (float32, dropout 0) captured OPT_STEPS steps at levels 1
    and 2 from one state: each level's transform report (rewrites by
    pass, the pipeline's ms) and losses, FUSE_TOL apart (bitwise where no
    level-2 pass fires: the fuse of an add into its activation blocks
    itself on a training program); the encoder served at levels 1 and 2,
    where the fuse fires; then the seq-512 recipe at level 3 under a
    budget of OPT3_BUDGET_FRAC of its plain step's measured peak: the
    plan's segments, its predicted peak against the measured one, whether
    the engine re-planned, the step's ms, the losses within TRAIN_TOL of
    the plain step's and the measured peak under the budget. Returns the
    flash launches of the three paths."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import observability as obs

    t_phase = time.perf_counter()
    n_layers = BERT["n_layers"]
    main, startup, loss = bert_train_program(False, dropout=0.0)
    state0 = start_state(main, startup)
    feed8 = train_feed(8, np.random.RandomState(81))
    launches, rows = {}, {}
    flags.set_flags({"metrics": True})  # the transform counters
    for level in (1, 2):
        exe, scope = state_executor(main, state0)
        fa.launches = fa.launches_dq = fa.launches_dkv = 0
        before = transform_counters()
        with fluid.scope_guard(scope):
            losses = [float(exe.run(main, feed=feed8, fetch_list=[loss],
                                    opt_level=level)[0].reshape(-1)[0])
                      for _ in range(OPT_STEPS)]
        report = transform_report(before, level)
        counted = flash_launches(fa)
        with fluid.scope_guard(scope):
            ms = timed_runs(lambda: exe.run(main, feed=feed8,
                                            fetch_list=[loss],
                                            opt_level=level))
        rows[level] = {"report": report, "losses": losses,
                       "launches": counted, "step_ms": ms,
                       "graphs": [(c.captures, c.replays)
                                  for c in captured(exe.engine)]}
        if level == 2:
            launches["opt_levels"] = counted
        del exe, scope
    release_memory()
    level2 = {k: v for k, v in rows[2]["report"]["rewrites"].items()
              if k != "fuse-attention"}
    fired = bool(level2)
    worst = rel_worst(rows[2]["losses"], rows[1]["losses"])
    emit({"phase": "opt_levels", "card": smi, "model": "bert_base",
          "batch": 8, "path": "train", "levels": rows,
          "level2_passes_fired": fired,
          "losses_bitwise_equal": rows[2]["losses"] == rows[1]["losses"],
          "loss_worst_rel": worst, "tol": FUSE_TOL["loss_rtol"]})
    for level, row in rows.items():
        check(not row["report"]["crashed"], "level %d: crashed passes %s"
              % (level, row["report"]["crashed"]))
        check(row["launches"] == dict(
            (k, OPT_STEPS * n_layers) for k in row["launches"]),
            "level %d: flash launches %s" % (level, row["launches"]))
        check(len(row["graphs"]) == 1 and row["graphs"][0][0] == 1,
              "level %d: graphs %s" % (level, row["graphs"]))
    if fired:
        check(worst <= FUSE_TOL["loss_rtol"], "level 2 losses %s against "
              "level 1's %s" % (rows[2]["losses"], rows[1]["losses"]))
    else:
        check(rows[2]["losses"] == rows[1]["losses"], "no level-2 pass "
              "fired, yet the losses differ: %s against %s"
              % (rows[2]["losses"], rows[1]["losses"]))

    # the encoder served at levels 1 and 2: eager, capture, replay
    serve, enc = serving_bert_program()
    names = {v.name for v in serve.list_vars() if v.persistable}
    s_state = {n: v for n, v in state0.items() if n in names}
    s_feed = {k: feed8[k] for k in ("pos_ids", "sent_ids", "seq_lens",
                                    "src_ids")}
    served = {}
    for level in (1, 2):
        exe, scope = state_executor(serve, s_state)
        fa.launches = fa.launches_dq = fa.launches_dkv = 0
        before = transform_counters()
        with fluid.scope_guard(scope):
            outs = [exe.run(serve, feed=s_feed, fetch_list=[enc],
                            opt_level=level)[0] for _ in range(3)]
            report = transform_report(before, level)
            ms = timed_runs(lambda: exe.run(serve, feed=s_feed,
                                            fetch_list=[enc],
                                            opt_level=level))
        served[level] = {"report": report, "out": outs[-1],
                         "replays_equal_eager": all(
                             np.array_equal(o, outs[0]) for o in outs),
                         "launches": flash_launches(fa), "request_ms": ms}
        if level == 2:
            launches["opt_levels_serve"] = served[level]["launches"]
        del exe, scope
    release_memory()
    a, b = served[2]["out"], served[1]["out"]
    s_err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
    fused = served[2]["report"]["rewrites"].get("fuse-elemwise-act", 0)
    emit({"phase": "opt_levels", "card": smi, "path": "serve", "batch": 8,
          "levels": {k: {kk: vv for kk, vv in v.items() if kk != "out"}
                     for k, v in served.items()},
          "fuse_elemwise_act_rewrites": fused,
          "bitwise_equal": bool(np.array_equal(a, b)),
          "rel_to_max": s_err, "tol": FUSE_TOL["loss_rtol"]})
    check(fused > 0, "level 2 fused no add + activation on the served "
          "encoder")
    check(all(v["replays_equal_eager"] for v in served.values()),
          "served replays differ from eager")
    check(s_err <= FUSE_TOL["loss_rtol"], "served level 2 vs level 1: %g"
          % s_err)

    # level 3: the seq-512 recipe under a budget below its plain peak
    r_main, r_startup, r_loss, _ = recipe_program()
    r_feed = recipe_feed(8, np.random.RandomState(53))

    def steps(exe, scope, level):
        with fluid.scope_guard(scope):
            return [float(exe.run(r_main, feed=r_feed, fetch_list=[r_loss],
                                  opt_level=level)[0].reshape(-1)[0])
                    for _ in range(OPT_STEPS)]

    release_memory()
    exe, scope = fresh(r_startup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with fluid.scope_guard(scope):
        first = float(exe.run(r_main, feed=r_feed, fetch_list=[r_loss],
                              opt_level=2)[0].reshape(-1)[0])
    torch.cuda.synchronize()
    plain_peak = int(torch.cuda.max_memory_allocated())
    with fluid.scope_guard(scope):
        plain = [first] + [
            float(exe.run(r_main, feed=r_feed, fetch_list=[r_loss],
                          opt_level=2)[0].reshape(-1)[0])
            for _ in range(OPT_STEPS - 1)]
    del exe, scope
    release_memory()
    total = torch.cuda.get_device_properties(0).total_memory
    budget = int(OPT3_BUDGET_FRAC * plain_peak)
    flags.set_flags({"device_memory_bytes": total,
                     "hbm_budget_frac": budget / total,
                     "replan_tolerance": OPT3_REPLAN_TOL})
    crashes0 = obs.counter_value("memory.plan_crashes")
    replans0 = obs.counter_value("memory.replan")
    try:
        exe, scope = fresh(r_startup)
        fa.launches = fa.launches_dq = fa.launches_dkv = 0
        before = transform_counters()
        losses = steps(exe, scope, 3)
        report = transform_report(before, 3)
        launches["opt_levels_l3"] = flash_launches(fa)
        entries = [c for c in exe.engine._cache.values()
                   if c.memory_plan is not None
                   and "src_ids" in c.block_program.feed_names]
        with fluid.scope_guard(scope):
            ms = timed_runs(lambda: exe.run(r_main, feed=r_feed,
                                            fetch_list=[r_loss],
                                            opt_level=3))
        engine = exe.engine
        crashes = obs.counter_value("memory.plan_crashes") - crashes0
        replans = obs.counter_value("memory.replan") - replans0
    finally:
        for name in ("device_memory_bytes", "hbm_budget_frac",
                     "replan_tolerance", "metrics"):
            flags.reset_flag(name)
    (entry,) = entries
    plan = entry.memory_plan
    row = {"seq_len": RECIPE["seq_len"], "batch": 8,
           "plain_peak_bytes": plain_peak, "budget_bytes": budget,
           "budget_frac_of_plain_peak": OPT3_BUDGET_FRAC,
           "device_memory_bytes": total,
           "plan_segments": int(plan.remat.n_segments),
           "plan_reason": plan.remat.reason,
           "lowered_segments": int(entry.remat_segments),
           "predicted_peak_bytes": int(plan.predicted_peak_bytes),
           "measured_peak_bytes": entry.peak_bytes,
           "replanned": bool(replans), "replans": replans,
           "plan_crashes": crashes, "transforms": report,
           "losses": losses, "plain_losses": plain,
           "loss_worst_rel": rel_worst(losses, plain),
           "tol": TRAIN_TOL["loss_rtol"], "step_ms": ms,
           "graphs": [(c.captures, c.replays) for c in captured(engine)],
           "launches": launches["opt_levels_l3"],
           "phase_s": time.perf_counter() - t_phase}
    emit(dict({"phase": "opt_levels", "card": smi, "path": "level3"}, **row))
    del exe, scope, engine, entries, entry
    release_memory()
    check(not report["crashed"] and not crashes, "level 3: crashed passes "
          "%s, planner crashes %s" % (report["crashed"], crashes))
    check(row["lowered_segments"] > 0, "level 3 lowered no remat segment "
          "under a budget of %.2f of the plain peak" % OPT3_BUDGET_FRAC)
    check(row["measured_peak_bytes"] is not None
          and row["measured_peak_bytes"] <= budget,
          "level 3: measured peak %s over the budget %d"
          % (row["measured_peak_bytes"], budget))
    check(row["loss_worst_rel"] <= TRAIN_TOL["loss_rtol"],
          "level 3 losses %s against the plain %s" % (losses, plain))
    return launches


@contextlib.contextmanager
def nhwc_against_nchw(errors):
    """While held, each NHWC op of LAYOUT_OPS that runs also runs its NCHW
    lowering on the same operands, permuted (activations NHWC -> NCHW,
    filters HWIO -> OIHW), and appends to ``errors`` (op type, output
    slot, max|NHWC - NCHW|, max|NCHW|, the largest incoming grad's max)
    for each float output."""
    import torch

    from paddle_tpu_torch.core.registry import OpRegistry

    acts, filters = ((0, 3, 1, 2), (0, 2, 3, 1)), ((3, 2, 0, 1), (2, 3, 1, 0))

    def perm(slot, t, back=False):
        if not hasattr(t, "dim") or t.dim() != 4:
            return t
        p = (filters if slot.startswith("Filter") else acts)[int(back)]
        return t.permute(*p)

    def wrap(op_type, lower):
        def fn(ctx, ins, attrs):
            out = lower(ctx, ins, attrs)
            key = "data_layout" if "batch_norm" in op_type else "data_format"
            if attrs.get(key, "NCHW") != "NHWC":
                return out
            # the NCHW operands as plain contiguous tensors, outside
            # any autograd a vjp of the op (pool2d's grad) records
            with torch.no_grad():
                nchw = lower(ctx, {k: [perm(k, t).detach().contiguous()
                                       if hasattr(t, "dim") else t
                                       for t in v]
                                   for k, v in ins.items()},
                             dict(attrs, **{key: "NCHW"}))
            cot = max([float(t.detach().abs().max()) for k, v in ins.items()
                       if k.endswith("@GRAD") for t in v if t.numel()]
                      or [0.0])
            for slot, vals in out.items():
                for a, b in zip(vals, nchw.get(slot, [])):
                    if a is None or not a.is_floating_point():
                        continue
                    a, b = a.detach(), perm(slot, b, back=True)
                    errors.append((op_type, slot, float(
                        (a.float() - b.float()).abs().max()),
                        float(b.float().abs().max()), cot))
            return out
        return fn

    saved = {t: OpRegistry.get(t).lower for t in LAYOUT_OPS}
    for t in LAYOUT_OPS:
        OpRegistry.get(t).lower = wrap(t, saved[t])
    try:
        yield errors
    finally:
        for t in LAYOUT_OPS:
            OpRegistry.get(t).lower = saved[t]


def phase_layout_nhwc(fa, smi):
    """ResNet-50 at batch 32 at layout=nhwc against NCHW, from one state:
    LAYOUT_STEPS captured Momentum steps each (losses within LAYOUT_TOL),
    the batch-32 logits served each way (LAYOUT_TOL of their largest);
    the transpose2 seams and the weights baked; the captured step's and
    the served request's ms in each layout, float32 and AMP bf16; from
    one profiled NHWC step, the device ms of the layout-reordering
    kernels (the filter copies among them). Returns the flash launches
    (none)."""
    import torch
    from torch.autograd import DeviceType

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.analysis import plan_layout

    t_phase = time.perf_counter()
    main, startup, handles = resnet_program(is_train=True)
    loss = handles["loss"]
    state0 = start_state(main, startup)
    feed = resnet_feed(RESNET_BATCH, np.random.RandomState(91))
    plan = plan_layout(main.desc, feed_names=sorted(feed),
                       fetch_names=[loss.name])
    serve, _, s_handles = resnet_program(is_train=False)
    s_names = {v.name for v in serve.list_vars() if v.persistable}
    s_state = {n: v for n, v in state0.items() if n in s_names}
    logits = s_handles["logits"]
    s_feed = {"img": feed["img"]}
    grads = [n + "@GRAD" for n in RESNET_GRADS]
    grad_shapes = [tuple(state0[n].shape) for n in RESNET_GRADS]
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    rows, copies, op_errs = {}, {}, []
    try:
        for layout in ("off", "nhwc"):
            flags.set_flags({"layout": layout})
            exe, scope = state_executor(main, state0)
            with fluid.scope_guard(scope), nhwc_against_nchw(op_errs):
                # the first step (an eager entry of its own: it fetches
                # grads too) runs each NHWC op beside its NCHW lowering
                first = exe.run(main, feed=feed, fetch_list=[loss] + grads)
            with fluid.scope_guard(scope):
                losses = [float(first[0].reshape(-1)[0])] + [
                    float(exe.run(main, feed=feed,
                                  fetch_list=[loss])[0].reshape(-1)[0])
                    for _ in range(LAYOUT_STEPS - 1)]
                # an NHWC filter's grad is HWIO: viewed OIHW to compare
                first_grads = [g.transpose(3, 2, 0, 1) if g.shape != shape
                               else g for g, shape in zip(first[1:],
                                                          grad_shapes)]

                def step():
                    return exe.run(main, feed=feed, fetch_list=[loss])

                step_ms = timed_runs(step)
                if layout == "nhwc":
                    prof = profiled(step)
                    for e in prof.key_averages():
                        if (e.device_type == DeviceType.CUDA
                                and re.search(LAYOUT_COPY_KERNEL, e.key,
                                              re.I)):
                            copies[e.key[:100]] = {
                                "ms": e.self_device_time_total / 1e3,
                                "launches": e.count}
            baked = len(getattr(scope, "_layout_hwio", ()))
            graphs = [(c.captures, c.replays) for c in captured(exe.engine)]
            del exe, scope
            s_exe, s_scope = state_executor(serve, s_state)
            with fluid.scope_guard(s_scope):
                outs = [s_exe.run(serve, feed=s_feed,
                                  fetch_list=[logits])[0] for _ in range(3)]
                serve_ms = timed_runs(lambda: s_exe.run(
                    serve, feed=s_feed, fetch_list=[logits]))
            del s_exe, s_scope
            # AMP bf16: the same programs marked for bfloat16
            amp_ms = {}
            for label, fetch, st, fd in (
                    ("train_step", loss, state0, feed),
                    ("serve", logits, s_state, s_feed)):
                prog = resnet_program(is_train=label == "train_step",
                                      amp=True)[0]
                a_exe, a_scope = state_executor(prog, st)
                with fluid.scope_guard(a_scope):
                    amp_ms[label] = timed_runs(lambda: a_exe.run(
                        prog, feed=fd, fetch_list=[fetch.name]))
                del a_exe, a_scope
            release_memory()
            rows[layout] = {"losses": losses, "step_ms": step_ms,
                            "first_grads": first_grads,
                            "serve_ms": serve_ms, "amp_bf16_ms": amp_ms,
                            "weights_baked_in_scope": baked,
                            "graphs": graphs, "logits": outs[-1],
                            "served_replays_equal_eager": all(
                                np.array_equal(o, outs[0]) for o in outs)}
    finally:
        flags.reset_flag("layout")
    launches = flash_launches(fa)
    a, b = rows["nhwc"]["logits"], rows["off"]["logits"]
    l_err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
    worst = rel_worst(rows["nhwc"]["losses"][1:], rows["off"]["losses"][1:])
    first_err = rel_worst(rows["nhwc"]["losses"][:1],
                          rows["off"]["losses"][:1])
    grad_err = {n: float(np.abs(x - y).max()) / max(float(np.abs(y).max()),
                                                     1e-30)
                for n, x, y in zip(RESNET_GRADS, rows["nhwc"]["first_grads"],
                                   rows["off"]["first_grads"])}
    # each output within IMAGE_OP_TOL: rel_to_max of its own largest
    # element, plus cot_rel of the largest grad flowing into its op (a
    # batch norm's scale grad is a sum cancelling to rounding noise)
    op_worst, op_bad = {}, []
    for op_type, slot, d, peak, cot in op_errs:
        key = "%s %s" % (op_type, slot)
        op_worst[key] = max(op_worst.get(key, 0.0), d / (peak or 1.0))
        limit = (IMAGE_OP_TOL["rel_to_max"] * peak
                 + IMAGE_OP_TOL["cot_rel"] * cot)
        if d > limit:
            op_bad.append([key, d, peak, cot])
    emit({"phase": "layout_nhwc", "card": smi, "model": "resnet50",
          "batch": RESNET_BATCH,
          "transpose2_seams": plan.transpose_count,
          "seams": [list(s)[:2] for s in plan.seams],
          "nhwc_ops": plan.n_nhwc_ops, "filters_to_bake": len(plan.weights),
          "layouts": {k: {kk: vv for kk, vv in v.items()
                          if kk not in ("logits", "first_grads")}
                      for k, v in rows.items()},
          "ops_compared": len(op_errs), "ops_worst_rel_to_max": op_worst,
          "op_tol": IMAGE_OP_TOL, "ops_beyond_tol": op_bad[:5],
          "first_loss_rel": first_err,
          "end_to_end_first_grads_rel_to_max": grad_err,
          "later_loss_worst_rel": worst, "logits_rel_to_max": l_err,
          "tol": LAYOUT_TOL, "nhwc_step_layout_kernels": copies,
          "nhwc_step_layout_kernels_ms": sum(c["ms"] for c in
                                             copies.values()),
          "launches": launches,
          "phase_s": time.perf_counter() - t_phase})
    check(plan.n_nhwc_ops > 0 and plan.transpose_count > 0,
          "the layout plan rewrote nothing")
    check(rows["nhwc"]["weights_baked_in_scope"] >= len(plan.weights),
          "NHWC baked %d weights of %d" % (
              rows["nhwc"]["weights_baked_in_scope"], len(plan.weights)))
    for layout, row in rows.items():
        check([g[0] for g in row["graphs"] if g[0]] == [1],
              "%s: graphs %s" % (layout, row["graphs"]))
        check(row["served_replays_equal_eager"], "%s: served replays differ"
              % layout)
        check(all(np.isfinite(row["losses"])), "%s losses" % layout)
    convs = sum(op.type in ("conv2d", "depthwise_conv2d")
                for op in main.desc.block(0).ops)
    compared = sum(e[0] in ("conv2d", "depthwise_conv2d") for e in op_errs)
    check(compared == convs, "%d NHWC convolutions compared of %d"
          % (compared, convs))
    check(not op_bad, "NHWC ops off their NCHW lowerings beyond %s: %s"
          % (IMAGE_OP_TOL, op_bad[:5]))
    check(first_err <= LAYOUT_TOL["first_loss_rtol"],
          "NHWC first loss off NCHW's by %g" % first_err)
    check(worst <= LAYOUT_TOL["loss_rtol"], "NHWC losses %s against NCHW "
          "%s" % (rows["nhwc"]["losses"], rows["off"]["losses"]))
    check(l_err <= LAYOUT_TOL["logits_rel_to_max"], "NHWC served logits "
          "%g of their largest off NCHW's" % l_err)
    check(not any(launches.values()), "flash launches in layout_nhwc: %s"
          % launches)
    return launches


def lenet_int8_program():
    """tests/test_int8_accuracy.py's LeNet (two conv-pool blocks of 8 and
    16 filters, a softmax fc, Adam): (main, startup, its for_test clone,
    prediction, loss, accuracy)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import nets, unique_name

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        c1 = nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=8, pool_size=2,
            pool_stride=2, act="relu")
        c2 = nets.simple_img_conv_pool(
            input=c1, filter_size=5, num_filters=16, pool_size=2,
            pool_stride=2, act="relu")
        pred = fluid.layers.fc(input=c2, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        acc = fluid.layers.accuracy(input=pred, label=label)
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=INT8_LENET["lr"]).minimize(loss)
    main.random_seed = startup.random_seed = 2024
    return main, startup, test, pred, loss, acc


def mnist_feed(batch):
    imgs = np.stack([x.reshape(1, 28, 28) for x, _ in batch])
    return {"img": imgs.astype(np.float32),
            "label": np.array([[y] for _, y in batch], np.int64)}


def top1(exe, program, pred, batches):
    right = total = 0
    for b in batches:
        (p,) = exe.run(program, feed={"img": b["img"]}, fetch_list=[pred])
        right += int((p.argmax(-1) == b["label"].reshape(-1)).sum())
        total += len(p)
    return right / total


def float64_emulation(op_type, ins, attrs):
    """A quantized op's output from its int8 operands in float64 on the
    card (every partial sum an integer below 2**53, so exact), rounded to
    float32 and rescaled as the lowering rescales its int32 sums."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import quant_ops
    from paddle_tpu_torch.ops.common import flatten_to_2d

    if op_type == "quantized_matmul":
        x, y = ins["X"][0], ins["Y"][0]
        cols = int(attrs.get("x_num_col_dims", 1))
        acc = flatten_to_2d(x, cols).double() @ y.double() + 0.0
        s = quant_ops._scale_param(attrs, "scale_y", x.device)
        out = quant_ops._rescale(acc.float(), float(attrs.get("scale_x",
                                                              1.0)), s)
        return out.reshape(tuple(x.shape[:cols]) + (y.shape[-1],))
    x, w = ins["Input"][0], ins["Filter"][0]
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    xd, wd = x.double(), w.double()
    if nhwc:
        xd, wd = xd.permute(0, 3, 1, 2), wd.permute(3, 2, 0, 1)
    acc = F.conv2d(xd, wd, stride=tuple(attrs.get("strides", [1, 1])),
                   padding=tuple(attrs.get("paddings", [0, 0])),
                   dilation=tuple(attrs.get("dilations", [1, 1])),
                   groups=int(attrs.get("groups", 1)))
    # the int32 sums as the lowering rescales them: [N*OH*OW, O]; an
    # integer sum has no negative zero (a float sum of -0.0 products has)
    acc = acc.permute(0, 2, 3, 1) + 0.0
    n, oh, ow, o = acc.shape
    s = quant_ops._scale_param(attrs, "scale_w", x.device)
    out = quant_ops._rescale(acc.reshape(-1, o).float(),
                             float(attrs.get("scale_x", 1.0)), s)
    out = out.reshape(n, oh, ow, o)
    return out if nhwc else out.permute(0, 3, 1, 2).contiguous()


def phase_int8_serve(fa, smi):
    """LeNet trained on the card on the repo's MNIST reader, frozen,
    calibrated and quantized: INT8 top-1 within INT8_TOP1_POINTS of FP32
    on the test split. ResNet-50 saved and served through
    ``AnalysisConfig`` + ``enable_mkldnn()`` at batch 1, 8 and 32 (the
    first INT8_SERVE_CALIB requests calibrate): request ms float32
    (frozen) and INT8; the quantized ops' share of the INT8 request's
    device time; INT8-vs-float32 top-1 agreement on INT8_AGREE_IMAGES
    images; every quantized_conv2d / quantized_matmul of one batch
    bitwise equal to its float64 emulation. Then the frozen float32 model
    exported AOT and served by the predictor's AOT branch (AOT_TOL).
    Returns the flash launches (none)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import dataset, flags, inference
    from paddle_tpu_torch import reader as ptreader
    from paddle_tpu_torch.core.registry import OpRegistry
    from paddle_tpu_torch.inference import (
        calibrate_program, freeze_program, quantize_program,
    )

    t_phase = time.perf_counter()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    # -- LeNet: the INT8 accuracy discipline
    main, startup, test, pred, loss, _ = lenet_int8_program()
    real = os.path.exists(dataset.mnist._idx_paths("train")[0] or "")
    train_reader = ptreader.batch(
        ptreader.shuffle(dataset.mnist.train(), buf_size=512),
        batch_size=INT8_LENET["batch"], drop_last=True)
    test_batches = [mnist_feed(b) for b in
                    ptreader.batch(dataset.mnist.test(), batch_size=128)()]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    t0 = time.perf_counter()
    steps = 0
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(INT8_LENET["epochs"]):
            for b in train_reader():
                exe.run(main, feed=mnist_feed(b), fetch_list=[loss])
                steps += 1
        train_s = time.perf_counter() - t0
        calib = [{"img": mnist_feed(b)["img"]}
                 for b in list(train_reader())[:INT8_CALIB_BATCHES]]
        frozen, f_rep = freeze_program(test, ["img"], [pred.name],
                                       scope=scope)
        stats = calibrate_program(frozen, calib, scope=scope, executor=exe,
                                  max_batches=INT8_CALIB_BATCHES)
        int8, q_rep = quantize_program(frozen, stats, scope=scope)
        fp32_top1 = top1(exe, frozen, pred.name, test_batches)
        int8_top1 = top1(exe, int8, pred.name, test_batches)
    del exe, scope
    lenet = {"data": ("MNIST from %s" % flags.get_flag("data")) if real
             else "the reader's deterministic synthetic pseudo-MNIST "
             "(no MNIST files under PADDLE_GPU_DATA)",
             "train_steps": steps, "batch": INT8_LENET["batch"],
             "train_s": train_s, "test_images": sum(
                 len(b["label"]) for b in test_batches),
             "fp32_top1": fp32_top1, "int8_top1": int8_top1,
             "delta_points": 100.0 * (fp32_top1 - int8_top1),
             "quantized_ops": len(q_rep.quantized),
             "skipped_ops": len(q_rep.skipped),
             "tol_points": INT8_TOP1_POINTS}
    emit({"phase": "int8_serve", "card": smi, "part": "lenet", **lenet})
    check(q_rep.quantized and not q_rep.skipped,
          "LeNet quantized %d ops, skipped %s" % (len(q_rep.quantized),
                                                  q_rep.skipped))
    check(fp32_top1 > 0.9, "LeNet FP32 top-1 %.4f" % fp32_top1)
    check(abs(100.0 * (fp32_top1 - int8_top1)) <= INT8_TOP1_POINTS,
          "INT8 top-1 %.4f vs FP32 %.4f" % (int8_top1, fp32_top1))

    # -- ResNet-50 served INT8 through enable_mkldnn
    r_main, r_startup, r_handles = resnet_program(is_train=False)
    logits = r_handles["logits"]
    rng = np.random.RandomState(101)
    requests = {b: {"img": resnet_feed(b, rng)["img"]}
                for b in INT8_SERVE_BATCHES}
    calib_feeds = [{"img": resnet_feed(32, rng)["img"]}
                   for _ in range(INT8_SERVE_CALIB)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as d:
        model_dir = os.path.join(d, "model")
        aot_dir = os.path.join(d, "aot")
        exe, scope = fluid.Executor(), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(r_startup)
            fluid.io.save_inference_model(model_dir, ["img"], [logits], exe,
                                          main_program=r_main)
        del exe, scope
        # float32: the frozen program (BN folded), no INT8
        f_scope = fluid.Scope()
        f_exe = fluid.Executor(fluid.CUDAPlace(0))
        with fluid.scope_guard(f_scope):
            prog, feeds, fetches = fluid.io.load_inference_model(model_dir,
                                                                 f_exe)
            f_frozen, _ = freeze_program(prog, feeds, [logits.name],
                                         scope=f_scope)
        fp32 = inference.AnalysisPredictor.from_frozen(
            program=f_frozen, feed_names=feeds, fetch_names=[logits.name],
            scope=f_scope)
        config = inference.AnalysisConfig(model_dir)
        config.enable_mkldnn()
        flags.set_flags({"serving_calibration_batches": INT8_SERVE_CALIB})
        try:
            predictor = inference.create_paddle_predictor(config)
            for f in calib_feeds:
                predictor.run(f)
        finally:
            flags.reset_flag("serving_calibration_batches")
        q_report = predictor.quant_report
        int8_prog = predictor._program
        check(q_report.quantized, "enable_mkldnn quantized nothing")
        ms = {"float32": {}, "int8": {}}
        for b, feed in requests.items():
            for label, p in (("float32", fp32), ("int8", predictor)):
                for _ in range(3):  # eager, capture, replay
                    p.run(feed)
                ms[label][b] = timed_runs(lambda p=p, f=feed: p.run(f))
        graphs = [(c.captures, c.replays)
                  for c in captured(predictor._exe.engine)]
        # agreement of the INT8 and float32 top-1 on synthetic images
        agree = total = 0
        for i in range(INT8_AGREE_IMAGES // 32):
            f = {"img": resnet_feed(32, rng)["img"]}
            (a,) = fp32.run(f)
            (q,) = predictor.run(f)
            agree += int((a.data.argmax(-1) == q.data.argmax(-1)).sum())
            total += 32
        # every quantized op of one batch-32 request, recorded on an eager
        # executor, against its float64 emulation
        recorded = []

        def recorder(op_type, lower):
            def fn(ctx, ins, attrs):
                out = lower(ctx, ins, attrs)
                if ins[next(iter(ins))][0].is_cuda:
                    recorded.append((op_type, {k: [t.clone() for t in v]
                                               for k, v in ins.items()},
                                     dict(attrs),
                                     next(iter(out.values()))[0].clone()))
                return out
            return fn

        q_ops = ("quantized_conv2d", "quantized_matmul")
        saved = {t: OpRegistry.get(t).lower for t in q_ops}
        e_exe = fluid.Executor(fluid.CUDAPlace(0))
        e_exe.engine.cuda_graphs = False
        for t in q_ops:
            OpRegistry.get(t).lower = recorder(t, saved[t])
        try:
            with fluid.scope_guard(predictor._scope):
                e_exe.run(int8_prog, feed=requests[32],
                          fetch_list=[logits.name])
        finally:
            for t in q_ops:
                OpRegistry.get(t).lower = saved[t]
        torch.cuda.synchronize()
        unequal = []
        for i, (t, ins, attrs, out) in enumerate(recorded):
            want = float64_emulation(t, ins, attrs)
            if not torch.equal(out, want):
                unequal.append([i, t, float((out - want).abs().max())])
        # the quantized ops' device ms in one window, against the
        # request's device time
        calls = [((i, t), functools.partial(saved[t], None, ins, attrs))
                 for i, (t, ins, attrs, _) in enumerate(recorded)]
        op_ms = window_ms(calls, n=3)
        busy = profile_request(lambda: predictor.run(requests[32]),
                               ms["int8"][32]["median_ms"])
        by_type = {}
        for (i, t), v in op_ms.items():
            by_type[t] = by_type.get(t, 0.0) + v
        int8_row = {
            "model": "resnet50", "calibration_requests": INT8_SERVE_CALIB,
            "quantized_ops": len(q_report.quantized),
            "skipped_ops": len(q_report.skipped),
            "request_ms": ms, "graphs_captures_replays": graphs,
            "top1_agreement": agree / total, "agreement_images": total,
            "bitwise_checked_ops": len(recorded),
            "bitwise_unequal": unequal[:5],
            "quantized_ops_device_ms": by_type,
            "request_device_busy_ms": busy["device_busy_ms"],
            "quantized_share_of_device_time": sum(by_type.values())
            / busy["device_busy_ms"],
            "int8_request_profile": busy}
        emit({"phase": "int8_serve", "card": smi, "part": "resnet50",
              **int8_row})
        del e_exe, recorded, calls
        check(int8_row["bitwise_checked_ops"] >= len(q_report.quantized),
              "%d quantized ops recorded of %d" % (
                  int8_row["bitwise_checked_ops"], len(q_report.quantized)))
        check(not unequal, "quantized ops off their float64 emulation: %s"
              % unequal[:5])

        # -- AOT: the frozen float32 model exported and served
        x = {"img": requests[32]["img"][:AOT_BATCH]}
        t0 = time.perf_counter()
        with fluid.scope_guard(f_scope):
            fluid.io.save_inference_model(
                aot_dir, ["img"], [f_frozen.global_block().var(logits.name)],
                f_exe, main_program=f_frozen, export_format="aot",
                example_feeds=x)
        export_s = time.perf_counter() - t0
        aot = inference.create_paddle_predictor(
            inference.AnalysisConfig(aot_dir))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (got,) = aot.run(x)
        first_ms = (time.perf_counter() - t0) * 1e3
        (want,) = fp32.run(x)
        aot_ms = timed_runs(lambda: aot.run(x))
        a_err = float(np.abs(got.data - want.data).max())
        emit({"phase": "int8_serve", "card": smi, "part": "aot",
              "batch": AOT_BATCH, "aot_branch": aot._aot is not None,
              "export_s": export_s, "first_call_ms": first_ms,
              "request_ms": aot_ms, "max_abs_err": a_err,
              "max_abs_logit": float(np.abs(want.data).max()),
              "tol": AOT_TOL, "launches": flash_launches(fa),
              "phase_s": time.perf_counter() - t_phase})
        check(aot._aot is not None, "the predictor did not take the AOT "
              "branch")
        check(np.allclose(got.data, want.data, **AOT_TOL),
              "AOT answers off the predictor's by %g" % a_err)
        del predictor, fp32, aot, f_exe, f_scope
    release_memory()
    launches = flash_launches(fa)
    check(not any(launches.values()), "flash launches in int8_serve: %s"
          % launches)
    return launches


def mesh_bert_program(n_layers, dropout):
    """BERT-base's pre-training program at ``n_layers`` (the width of
    ``BERT``), as ``bert_train_program`` builds it."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import bert

    cfg = dict(BERT, n_layers=n_layers)
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        T = cfg["seq_len"]
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
            cfg["vocab_size"], max_position=cfg["max_position"],
            d_model=cfg["d_model"], n_layers=n_layers,
            n_heads=cfg["n_heads"], d_inner=cfg["d_inner"],
            dropout=dropout, is_train=True)
        loss, _, _ = bert.pretrain_heads(
            enc, mask_label, mask_weight, ns_label, cfg["vocab_size"],
            cfg["d_model"], is_train=True)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss


def mesh_sp_program():
    """The Transformer's attention block (``multi_head_attention``) with
    ``sequence_parallel``, a squared-mean loss and its grads."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import transformer

    c = MESH_SP
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[c["seq_len"], c["d_model"]],
                              dtype="float32")
        out = transformer.multi_head_attention(
            x, x, x, c["d_model"], c["n_heads"], dropout_rate=0.0,
            causal=True, is_train=True, sequence_parallel=True)
        loss = fluid.layers.mean(fluid.layers.square(out))
        fluid.append_backward(loss)
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss


def mesh_grad_names(main, k=4):
    """The grads a two-rank case holds against one rank: ``k`` params
    spread over the program, first to last."""
    params = [p.name for p in main.all_parameters()]
    pick = sorted({int(i) for i in np.linspace(0, len(params) - 1, k)})
    return [params[i] + "@GRAD" for i in pick]


def mesh_case_inputs():
    """Each two-rank case's state, feeds and fetches, host arrays made
    here from seeds: the startup programs run on the CPU, so every
    process that calls this gets the same."""
    import paddle_tpu_torch.fluid as fluid

    cases = {}
    main, startup, loss = mesh_bert_program(MESH_DP2_LAYERS, 0.0)
    feed = train_feed(8, np.random.RandomState(93))
    cases["dp2"] = (main, startup, loss, feed, MESH_DP2_STEPS)
    main, startup, loss = mesh_sp_program()
    rng = np.random.RandomState(94)
    feed = {"x": rng.randn(MESH_SP["batch"], MESH_SP["seq_len"],
                           MESH_SP["d_model"]).astype(np.float32)}
    cases["sp2"] = (main, startup, loss, feed, 1)
    out = {}
    for name, (main, startup, loss, feed, steps) in cases.items():
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            fluid.Executor(fluid.CPUPlace()).run(startup)
        state = {v.name: scope.get(v.name).numpy()
                 for v in main.list_vars() if v.persistable}
        out[name] = {"state": state, "feed": feed, "steps": steps,
                     "fetch": [loss.name] + mesh_grad_names(main)}
    return out


def mesh_run_case(name, inputs, place, mesh=None, spmd=None):
    """One case's steps from its state: (losses, the first step's grads,
    the parameters after the steps), all host arrays; over ``mesh`` when
    given. With ``spmd`` (a dict) the steps run with ``verify=True`` and
    ``spmd`` gets ``spmd_summary`` of the run."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.parallel.plan import gather

    main = (mesh_bert_program(MESH_DP2_LAYERS, 0.0)[0] if name == "dp2"
            else mesh_sp_program()[0])
    inp = inputs[name]
    scope = fluid.Scope()
    convert.load_numpy_state(scope, inp["state"], place.torch_device(),
                             program=main)
    exe = fluid.Executor(place)
    losses, grads = [], None
    kw = {"verify": True} if spmd is not None else {}
    with fluid.scope_guard(scope):
        for _ in range(inp["steps"]):
            out = exe.run(main, feed=inp["feed"], fetch_list=inp["fetch"],
                          mesh=mesh, **kw)
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
            grads = grads if grads is not None else out[1:]
    final = {p.name: gather(scope.get(p.name)).float().cpu().numpy()
             for p in main.all_parameters()}
    if spmd is not None:
        spmd.update(spmd_summary(exe, main, inp, mesh))
    return losses, grads, final


def spmd_summary(exe, main, inp, mesh):
    """The SPMD analysis of a mesh run (``spmd_predict`` and metrics on):
    the ``spmd_plan`` and ``spmd.prediction_delta`` events,
    ``engine.spmd_plan_ms``, the collectives the entry's first run issued
    by kind and source, the parameter-gradient reductions against the
    plan's parameter-gradient psums (var and bytes), and the verifier's
    findings by severity on the program over the mesh."""
    import collections

    from paddle_tpu_torch import analysis
    from paddle_tpu_torch import observability as obs

    (entry,) = [c for c in exe.engine._cache.values()
                if c.spmd_plan is not None]
    plan, record = entry.spmd_plan, entry.mesh_plan.record
    predicted = sorted((c.var, c.nbytes) for c in plan.collectives
                       if c.kind == "psum" and c.phase == "backward")
    reduced = sorted((c["var"], c["nbytes"]) for c in record
                     if c["source"] == "grad")
    events = {name: [dict(r.args or {}) for r in obs.spans()
                     if r.name == name]
              for name in ("spmd_plan", "spmd.prediction_delta")}
    timer = obs.snapshot()["histograms"].get("engine.spmd_plan_ms", {})
    report = analysis.verify_program(
        main, feed_names=sorted(inp["feed"]), fetch_names=inp["fetch"],
        mesh=mesh)
    return {
        "spmd_plan": events["spmd_plan"],
        "spmd_plan_ms": timer.get("max"),
        "prediction_delta": events["spmd.prediction_delta"],
        "measured_by_kind_and_source": sorted(
            [list(k) + [n] for k, n in collections.Counter(
                (c["kind"], c["source"]) for c in record).items()]),
        "param_grad_reductions": len(reduced),
        "param_grad_kinds": sorted({c["kind"] for c in record
                                    if c["source"] == "grad"}),
        "param_grad_bytes": sum(n for _, n in reduced),
        "predicted_param_grad_psums": len(predicted),
        "predicted_param_grad_bytes": sum(n for _, n in predicted),
        "param_grads_equal_prediction": reduced == predicted,
        "verify_findings": {
            "errors": len(report.errors),
            "warnings": sum(1 for f in report
                            if f.severity == analysis.Severity.WARNING),
            "spmd_info": [f.message for f in report
                          if f.pass_name == "spmd-collective-report"]}}


MESH_PROBE = r"""
import sys
import torch
import torch.distributed as dist

rank, path, name, backend, dev = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                  sys.argv[4], int(sys.argv[5]))
torch.cuda.set_device(dev)
dist.init_process_group(backend, init_method="file://" + path, rank=rank,
                        world_size=2)
x = torch.full((4,), float(rank + 1), device="cuda")
if name == "all_reduce":
    dist.all_reduce(x)
elif name == "all_gather_into_tensor":
    dist.all_gather_into_tensor(torch.empty(8, device="cuda"), x)
elif name == "reduce_scatter_tensor":
    dist.reduce_scatter_tensor(torch.empty(4, device="cuda"), x.repeat(2))
elif name == "batch_isend_irecv":
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, 1 - rank),
            dist.P2POp(dist.irecv, torch.empty_like(x), 1 - rank)]):
        w.wait()
torch.cuda.synchronize()
dist.destroy_process_group()
print("ok")
"""


def mesh_probe_start(backend, n_dev, tmpdir):
    """Start probing which collectives a two-rank ``backend`` group takes
    on CUDA tensors (rank r on card r, or both on card 0): each
    collective in a pair of processes of its own, all pairs at once,
    since gloo aborts its process on a tensor it cannot move. Returns
    the processes for ``mesh_probe_read``."""
    names = sorted({c for needs in MESH_CASES.values() for c in needs}
                   | {"reduce_scatter_tensor"})
    procs = {}
    for name in names:
        path = os.path.join(tmpdir, "probe_" + name)
        procs[name] = [subprocess.Popen(
            [sys.executable, "-c", MESH_PROBE, str(r), path, name, backend,
             str(r if n_dev >= 2 else 0)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
    return procs


def mesh_probe_read(procs):
    """{collective: "ok" or the error} of ``mesh_probe_start``'s pairs."""
    out = {}
    for name, pair in procs.items():
        errs = []
        for p in pair:
            try:
                so, se = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                so, se = p.communicate()
                se = (se or "") + "\ntimed out after 120 s"
            if p.returncode != 0 or "ok" not in so:
                lines = [ln for ln in se.splitlines() if ln.strip()]
                errs.append("exit %s: %s" % (
                    p.returncode, " | ".join(lines[-2:])[:300]))
        out[name] = "ok" if not errs else errs[0]
    return out


def _mesh_rank(rank, world, tmpdir, backend, run):
    """A rank of the two-rank cases (spawned): runs each case of ``run``
    over its mesh and writes its results."""
    import pickle

    import torch
    import torch.distributed as dist

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from paddle_tpu_torch import flags, parallel
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.platform import CUDAPlace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank if backend == "nccl" else 0
    torch.cuda.set_device(dev)
    parallel.init_distributed(
        num_processes=world, process_id=rank, backend=backend,
        init_method="file://" + os.path.join(tmpdir, "store"))
    inputs = mesh_case_inputs()
    res = {}
    # dp2 also runs the SPMD analysis: the verifier over the mesh, the
    # plan at the cache miss, the prediction held against the first run
    flags.set_flags({"metrics": True, "spmd_predict": True})
    for name in run:
        axes = {"dp": 2} if name == "dp2" else {"dp": 1, "sp": 2}
        mesh = parallel.make_mesh(axes, device_type="cuda")
        fa.launches = fa.launches_dq = fa.launches_dkv = 0
        obs.reset()
        t0 = time.perf_counter()
        spmd = {} if name == "dp2" else None
        losses, grads, final = mesh_run_case(name, inputs, CUDAPlace(dev),
                                             mesh, spmd=spmd)
        res[name] = {
            "ran": True, "losses": losses,
            "grads": grads if rank == 0 else None,
            "state": final if rank == 0 else None,
            "seconds": time.perf_counter() - t0,
            "launches": flash_launches(fa), "counters": mesh_counters(),
            "spmd": spmd}
    with open(os.path.join(tmpdir, "rank%d.pkl" % rank), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


MESH_COUNTERS = ("engine.captures", "engine.replays", "engine.eager_runs",
                  "engine.mesh_redistribute", "engine.mesh_op_replicated",
                  "engine.grad_buckets", "engine.state_resharded")


def mesh_counters():
    """The engine's mesh counters (the metrics flag on), and the ops the
    mesh path ran replicated for want of a sharding rule."""
    from paddle_tpu_torch import observability as obs

    out = {n: obs.counter_value(n) for n in MESH_COUNTERS}
    out["replicated_ops"] = sorted({
        (r.args or {}).get("op") for r in obs.spans()
        if r.name == "engine.mesh_op_replicated"})
    return out


def mesh_worst(got, want, names=None):
    """Worst |got - want| over max|want|, var by var: (worst, its var,
    its largest |got - want|)."""
    worst = (0.0, None, 0.0)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float64)
        g = np.asarray(g, np.float64)
        d = float(np.abs(g - w).max()) if w.size else 0.0
        rel = d / max(float(np.abs(w).max()) if w.size else 0.0, 1e-30)
        if rel > worst[0]:
            worst = (rel, names[i] if names else i, d)
    return worst


def phase_mesh_ring(fa):
    """The ring's step function (``ring_attention_blocks``) at every rank's
    offsets in this process, against one full-sequence kernel call:
    forward and the ring backward's three grads."""
    import torch

    from paddle_tpu_torch.parallel.ring_attention import (
        ring_attention_blocks)

    rows = []
    B, H, T, D = 2, 12, MESH_RING_T, 64
    for n in (2, 4):
        for dt in ("float32", "bfloat16"):
            for causal in (False, True):
                gen = torch.Generator(device="cuda").manual_seed(70 + n)
                q, k, v, g = (torch.randn((B, H, T, D), generator=gen,
                                          device="cuda").to(getattr(
                                              torch, dt))
                              for _ in range(4))
                out, lse = fa.flash_forward_cuda(q, k, v, None, None, 0,
                                                 causal)
                want = fa.flash_backward_cuda(q, k, v, out, lse, g, None,
                                              None, None, 0, causal)
                outs, _, grads = ring_attention_blocks(
                    q.chunk(n, 2), k.chunk(n, 2), v.chunk(n, 2), causal,
                    use_flash=True, grads=g.chunk(n, 2))
                got_out = torch.cat(outs, 2).float()
                tol = TOL[dt]
                diff = (got_out - out.float()).abs()
                allowed = (tol["out_rel"] * out.float().abs()
                           + tol["out_abs_of_max_v"]
                           * v.float().abs().max() + tol["out_abs"])
                row = {"sp": n, "dtype": dt, "causal": causal,
                       "max_abs_err_out": diff.max().item(),
                       "max_excess_out": (diff - allowed).max().item()}
                tb = TOL_BWD[dt]
                for gname, parts, w in zip(("dq", "dk", "dv"), grads, want):
                    a, b = torch.cat(parts, 2).float(), w.float()
                    d = (a - b).abs()
                    allowed = (tb["rel"] * b.abs() + tb["abs_of_max"]
                               * b.abs().max() + tb["abs"])
                    row["max_abs_err_" + gname] = d.max().item()
                    row["max_excess_" + gname] = (d - allowed).max().item()
                rows.append(row)
                check(all(np.isfinite(row[k]) and row[k] <= 0
                          for k in row if k.startswith("max_excess")),
                      "mesh ring sp=%d %s causal=%s beyond TOL: %s"
                      % (n, dt, causal, row))
    return rows


def phase_mesh(fa, smi):
    """The mesh path: BERT-base under a 1-rank NCCL mesh (bitwise against
    no mesh, captured), the two-rank cases on spawned ranks, the ring's
    kernels at every rank's offsets. Returns the flash launches of the
    1-rank mesh path. The two-rank transport's probe runs while the
    one-rank steps do; no process of it outlives the phase."""
    import torch

    n_dev = torch.cuda.device_count()
    # gloo on the one card (NCCL refuses two ranks on one device), NCCL
    # one card a rank when there are two
    backend = "nccl" if n_dev >= 2 else "gloo"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        probing = mesh_probe_start(backend, n_dev, d)
        try:
            return _phase_mesh(fa, smi, probing, d, backend, n_dev)
        finally:
            for pair in probing.values():
                for p in pair:
                    if p.poll() is None:
                        p.kill()
                        p.wait()


def _phase_mesh(fa, smi, probing, tmpdir, backend, n_dev):
    import pickle

    import torch
    import torch.multiprocessing as mp

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import flags, parallel
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.parallel.plan import gather

    t_phase = time.perf_counter()
    parallel.env.init_single_process("cuda")
    flags.set_flags({"metrics": True})
    main, startup, loss = bert_train_program(False)
    state0 = start_state(main, startup)
    feed8 = train_feed(8, np.random.RandomState(91))
    runs, finals = {}, {}
    for label in ("no_mesh", "mesh_dp1"):
        exe, scope = state_executor(main, state0)
        if label == "mesh_dp1":
            flags.set_flags({"mesh": "dp=1"})
        try:
            fa.launches = fa.launches_dq = fa.launches_dkv = 0
            obs.reset()
            with fluid.scope_guard(scope):
                losses = [float(exe.run(main, feed=feed8,
                                        fetch_list=[loss])[0].reshape(-1)[0])
                          for _ in range(MESH_STEPS)]
            counted = flash_launches(fa)
            counters = mesh_counters()
            # the state after the steps, on the card, before the timed
            # runs move it
            finals[label] = {n: gather(scope.get(n)).clone()
                             for n in sorted(state0)}
            graphs = [(c.captures, c.replays) for c in captured(exe.engine)]
            with fluid.scope_guard(scope):
                ms = timed_runs(lambda: exe.run(main, feed=feed8,
                                                fetch_list=[loss]))
            runs[label] = {"losses": losses, "launches": counted,
                           "graphs": graphs, "step_ms": ms,
                           "counters": counters}
        finally:
            flags.reset_flag("mesh")
        del exe, scope
        release_memory()
    unequal = [n for n in finals["no_mesh"]
               if not torch.equal(finals["no_mesh"][n],
                                  finals["mesh_dp1"][n])]
    del finals
    release_memory()
    one = runs["mesh_dp1"]
    per_step = {k: MESH_STEPS * BERT["n_layers"] for k in one["launches"]}
    emit({"phase": "mesh", "case": "dp1_nccl", "card": smi,
          "model": "bert_base", "batch": 8, "dropout": 0.1,
          "steps": MESH_STEPS, "runs": runs,
          "losses_bitwise_equal": one["losses"] == runs["no_mesh"]["losses"],
          "state_vars_unequal": unequal,
          "device_count": n_dev, "transport": "nccl (one rank)"})
    check(one["losses"] == runs["no_mesh"]["losses"],
          "mesh dp=1 losses must be bitwise the no-mesh losses: %s vs %s"
          % (one["losses"], runs["no_mesh"]["losses"]))
    check(not unequal, "mesh dp=1 state differs from no mesh: %s"
          % unequal[:5])
    check(one["launches"] == per_step,
          "mesh dp=1 flash launches %s, want %s" % (one["launches"],
                                                    per_step))
    check(one["graphs"] and all(c == 1 and r >= 1 for c, r in one["graphs"]),
          "mesh dp=1 step not captured: %s" % one["graphs"])

    # the two-rank cases the probe allows start; meanwhile this process
    # runs each case on one rank at the same global batch (its default
    # sp mesh of one rank for the ring op)
    t_spawn = time.perf_counter()
    probe = mesh_probe_read(probing)
    probe_wait_s = time.perf_counter() - t_spawn
    run = [n for n, needs in MESH_CASES.items()
           if all(probe[c] == "ok" for c in needs)]
    ranks = [{}, {}]
    spawned = (mp.start_processes(_mesh_rank, args=(2, tmpdir, backend, run),
                                  nprocs=2, join=False, start_method="spawn")
               if run else None)
    try:
        inputs = mesh_case_inputs()
        parallel.set_default_mesh(parallel.make_mesh({"sp": 1}))
        try:
            alone = {name: mesh_run_case(name, inputs, fluid.CUDAPlace(0))
                     for name in MESH_CASES}
        finally:
            parallel.set_default_mesh(None)
        release_memory()
        if spawned is not None:
            while not spawned.join():
                pass
    except BaseException:
        for proc in (spawned.processes if spawned is not None else ()):
            if proc.is_alive():
                proc.terminate()
        raise
    for r in range(2 if spawned is not None else 0):
        with open(os.path.join(tmpdir, "rank%d.pkl" % r), "rb") as f:
            ranks[r] = pickle.load(f)
    spawn_s = time.perf_counter() - t_spawn
    cases = {}
    for name, needs in MESH_CASES.items():
        if name not in run:
            cases[name] = {"ran": False, "transport": backend,
                           "kept_off_by": {c: probe[c] for c in needs
                                           if probe[c] != "ok"}}
            continue
        r0 = ranks[0][name]
        losses, grads, final = alone[name]
        row = {"ran": True, "transport": backend,
               "captured": backend == "nccl",
               "losses": r0["losses"], "losses_one_rank": losses,
               "loss_worst_rel": rel_worst(r0["losses"], losses),
               "grad_worst_rel_to_max": mesh_worst(
                   r0["grads"], grads, inputs[name]["fetch"][1:]),
               "state_worst_rel_to_max": mesh_worst(
                   [r0["state"][n] for n in sorted(final)],
                   [final[n] for n in sorted(final)], sorted(final)),
               "ranks_agree": all(ranks[r][name]["losses"] == r0["losses"]
                                  for r in range(2)),
               "seconds": r0["seconds"], "launches_rank0": r0["launches"],
               "counters_rank0": r0["counters"]}
        cases[name] = row
    emit({"phase": "mesh", "case": "two_ranks", "card": smi,
          "device_count": n_dev, "transport": backend,
          "probe": probe, "probe_wait_s": probe_wait_s, "cases": cases,
          "ran": run, "spawn_s": spawn_s, "tol": MESH_TOL})
    if "dp2" in run:
        spmd = ranks[0]["dp2"]["spmd"]
        emit(dict({"phase": "mesh", "case": "dp2_spmd", "card": smi,
                   "model": "bert_base", "n_layers": MESH_DP2_LAYERS,
                   "batch": 8, "mesh": {"dp": 2}}, **spmd))
        delta = spmd["prediction_delta"]
        check(len(spmd["spmd_plan"]) == 1 and len(delta) == 1,
              "mesh dp2: spmd_plan %d, spmd.prediction_delta %d events, "
              "want one each" % (len(spmd["spmd_plan"]), len(delta)))
        check(spmd["param_grads_equal_prediction"]
              and spmd["param_grad_kinds"] == ["all-reduce"]
              and spmd["param_grad_reductions"] > 0,
              "mesh dp2: parameter-gradient all-reduces %d (%d bytes, %s) "
              "against the predicted psums %d (%d bytes)" % (
                  spmd["param_grad_reductions"], spmd["param_grad_bytes"],
                  spmd["param_grad_kinds"],
                  spmd["predicted_param_grad_psums"],
                  spmd["predicted_param_grad_bytes"]))
        check(spmd["verify_findings"]["errors"] == 0,
              "mesh dp2: the verifier reports ERRORs over the mesh: %s"
              % spmd["verify_findings"])
    for name in run:
        row = cases[name]
        check(row["ranks_agree"], "mesh %s: ranks disagree" % name)
        check(row["loss_worst_rel"] <= MESH_TOL["loss_rtol"],
              "mesh %s loss %g beyond %g" % (name, row["loss_worst_rel"],
                                             MESH_TOL["loss_rtol"]))
        rel, var, _ = row["grad_worst_rel_to_max"]
        check(rel <= MESH_TOL["grad_rel_to_max"],
              "mesh %s grad %s %g beyond %g" % (name, var, rel,
                                                MESH_TOL["grad_rel_to_max"]))
        got, want = ranks[0][name]["state"], alone[name][2]
        for n, w in want.items():
            d = np.abs(got[n].astype(np.float64) - w).max()
            allowed = (MESH_TOL["state_rel_to_max"] * np.abs(w).max()
                       + MESH_TOL["state_abs"])
            check(d <= allowed, "mesh %s param %s off by %g > %g"
                  % (name, n, d, allowed))

    flags.reset_flag("metrics")
    obs.reset()
    ring = phase_mesh_ring(fa)
    emit({"phase": "mesh", "case": "ring_blocks", "T": MESH_RING_T,
          "rows": ring, "seconds": time.perf_counter() - t_phase})
    return one["launches"]


def pserver_server_state(prog, state):
    """The initial state of a pserver program: each persistable of its
    global block from the single-process ``state``, a table shard or a
    sliced block's rows cut out of the whole var (the listen_and_serv
    op's ``dist_tables`` and ``sliced_blocks``)."""
    lns = prog.desc.global_block().ops[-1]
    rows = {}
    for d in lns.attrs.get("dist_tables", []):
        for n in d["sliced"]:
            rows[n] = (n, d["start"], d["end"])
    for d in lns.attrs.get("sliced_blocks", []):
        for old, new in d["rename"].items():
            rows[new] = (old, d["rows"][0], d["rows"][1])
    out = {}
    for n, vd in prog.desc.global_block().vars.items():
        if not vd.persistable:
            continue
        src, r0, r1 = rows.get(n, (n, None, None))
        val = state[src]
        if r0 is not None and tuple(val.shape) != tuple(vd.shape):
            val = val[r0:r1]
        out[n] = np.ascontiguousarray(val)
    return out


def phase_pserver(fa, smi):
    """DeepFM at the ctr width on the parameter-server path (PSERVER_*),
    every server and trainer a thread of this process with its executor
    on the card, against the same steps in one process. Returns the flash
    launches of the cluster's steps (none)."""
    import threading

    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert, unique_name
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.models import deepfm

    t_phase = time.perf_counter()
    place = fluid.CUDAPlace(0)
    batch = CTR["batch_size"]
    half = batch // PSERVER_TRAINERS
    feeds = ctr_feeds(batch, PSERVER_STEPS, 97)
    parts = [[{k: v[i * half:(i + 1) * half] for k, v in f.items()}
              for i in range(PSERVER_TRAINERS)] for f in feeds]

    # one process: the startup's state, then the steps from it, each
    # step's loss on each trainer's half taken first by the for_test clone
    main, startup, handles = deepfm_program()
    loss = handles["loss"]
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    state = {v.name: scope.get(v.name).detach().cpu().clone().numpy()
             for v in main.list_vars() if v.persistable}
    test_prog = main.clone(for_test=True)
    local = {"loss": [], "half_losses": []}
    for f, halves in zip(feeds, parts):
        local["half_losses"].append([float(exe.run(
            test_prog, feed=h, fetch_list=[loss], scope=scope)[0])
            for h in halves])
        local["loss"].append(float(exe.run(main, feed=f, fetch_list=[loss],
                                           scope=scope)[0]))
    tables = {n: scope.get(n).cpu().numpy() for n in ("fm_v", "fm_w1")}
    dense = {p.name: scope.get(p.name).cpu().numpy()
             for p in main.all_parameters() if p.name not in tables}
    local_s = time.perf_counter() - t_phase
    del exe, scope
    release_memory()

    # the cluster: transpiled for 2 pservers, 2 trainers on free ports
    with unique_name.guard():
        dmain, dstartup, dh = deepfm.get_model(is_distributed=True, **CTR)
    ports = []
    for _ in range(PSERVER_SERVERS):
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        ports.append(sock)
    eps = ["127.0.0.1:%d" % p.getsockname()[1] for p in ports]
    for sock in ports:
        sock.close()
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=dmain, pservers=",".join(eps),
                trainers=PSERVER_TRAINERS, startup_program=dstartup)
    servers = []
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    t0 = time.perf_counter()
    try:
        for ep in eps:
            prog = t.get_pserver_program(ep)
            srv = ps.ParameterServer(prog, None, ep,
                                     fanin=PSERVER_TRAINERS, place=place)
            convert.load_numpy_state(srv.scope,
                                     pserver_server_state(prog, state),
                                     "cuda", program=prog)
            srv.start()
            servers.append(srv)
        trainer_prog = t.get_trainer_program()
        trainer_startup = t.get_trainer_startup_program()
        rows = [{"losses": [], "step_ms": [], "bytes_sent": [],
                 "bytes_received": []} for _ in range(PSERVER_TRAINERS)]
        errors = []

        def train(tid):
            try:
                tr = ps.DistTrainer(trainer_prog, t, place=place)
                tr.run_startup(trainer_startup)
                tr.pull_params()
                row = rows[tid]
                for step in range(PSERVER_STEPS):
                    sent, got = (tr.client.bytes_sent,
                                 tr.client.bytes_received)
                    (val,) = tr.run(parts[step][tid], [dh["loss"].name])
                    row["losses"].append(float(np.asarray(val)))
                    row["step_ms"].append(tr.step_ms)
                    row["bytes_sent"].append(tr.client.bytes_sent - sent)
                    row["bytes_received"].append(
                        tr.client.bytes_received - got)
                row["table_vars_held"] = sorted(
                    n for n in ("fm_v", "fm_w1")
                    if tr.scope.get(n) is not None)
                tr.close()
            except Exception as e:
                errors.append("trainer %d: %s: %s" % (
                    tid, type(e).__name__, e))

        threads = [threading.Thread(target=train, args=(i,))
                   for i in range(PSERVER_TRAINERS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        check(not errors and not any(th.is_alive() for th in threads),
              "pserver trainers failed: %s" % errors)
        got_tables = {n: np.concatenate([srv.scope.get(n).cpu().numpy()
                                         for srv in servers])
                      for n in tables}
        owner = {}
        for srv in servers:
            for n in srv._owned_persistables():
                if n in dense:
                    owner[n] = srv.scope.get(n).cpu().numpy()
        update_ms = [{"last": srv.update_ms, "updates": srv.updates,
                      "mean": srv.update_ms_total / max(srv.updates, 1)}
                     for srv in servers]
    finally:
        for srv in servers:
            srv.stop()
    cluster_s = time.perf_counter() - t0
    launches = flash_launches(fa)
    tol = PSERVER_TOL
    loss_err = [[abs(a - b) for a, b in zip(rows[i]["losses"],
                                            [h[i] for h in
                                             local["half_losses"]])]
                for i in range(PSERVER_TRAINERS)]
    mean_loss = [sum(r["losses"][s] for r in rows) / PSERVER_TRAINERS
                 for s in range(PSERVER_STEPS)]
    table_err = {n: float(np.abs(got_tables[n] - tables[n]).max())
                 for n in tables}
    table_ok = {n: bool(np.allclose(got_tables[n], tables[n],
                                    rtol=tol["table_rtol"],
                                    atol=tol["table_atol"]))
                for n in tables}
    dense_worst = mesh_worst([owner[n] for n in sorted(owner)],
                             [dense[n] for n in sorted(owner)],
                             sorted(owner))
    mean_ms = {k: statistics.mean(r["step_ms"][s][k] for r in rows
                                  for s in range(1, PSERVER_STEPS))
               for k in ("engine", "rpc", "copy")}
    emit({"phase": "pserver", "card": smi, "model": "deepfm",
          "config": CTR, "servers": PSERVER_SERVERS,
          "trainers": PSERVER_TRAINERS, "steps": PSERVER_STEPS,
          "batch_per_trainer": half, "transport": "tcp localhost",
          "losses_by_trainer": [r["losses"] for r in rows],
          "local_half_losses": local["half_losses"],
          "local_losses": local["loss"], "mean_losses": mean_loss,
          "loss_abs_err_by_trainer": loss_err,
          "table_max_abs_err": table_err, "tables_within_tol": table_ok,
          "dense_params_worst_rel_to_max": dense_worst,
          "step_ms_by_trainer": [r["step_ms"] for r in rows],
          "step_ms_mean_after_first": mean_ms,
          "bytes_sent_per_step": [r["bytes_sent"] for r in rows],
          "bytes_received_per_step": [r["bytes_received"] for r in rows],
          "server_update_ms": update_ms,
          "tables_on_trainers": [r["table_vars_held"] for r in rows],
          "flash_launches": launches, "local_s": local_s,
          "cluster_s": cluster_s,
          "seconds": time.perf_counter() - t_phase, "tol": tol})
    for i in range(PSERVER_TRAINERS):
        check(np.allclose(rows[i]["losses"],
                          [h[i] for h in local["half_losses"]],
                          rtol=tol["loss_rtol"], atol=tol["loss_atol"]),
              "pserver trainer %d losses %s, one process %s" % (
                  i, rows[i]["losses"],
                  [h[i] for h in local["half_losses"]]))
        check(not rows[i]["table_vars_held"],
              "pserver trainer %d holds a table: %s"
              % (i, rows[i]["table_vars_held"]))
    check(np.allclose(mean_loss, local["loss"], rtol=tol["loss_rtol"],
                      atol=tol["loss_atol"]),
          "pserver mean losses %s, one process %s" % (mean_loss,
                                                      local["loss"]))
    check(all(table_ok.values()), "pserver tables beyond tolerance: %s"
          % table_err)
    check(not any(launches.values()), "flash launches in pserver: %s"
          % launches)
    del servers
    release_memory()
    return launches


# release_memory's calls and their seconds, for the last times line
RELEASES = {"calls": 0, "seconds": 0.0}


def release_memory():
    """Free what no live object holds, CUDA graphs and their pools too,
    and return the cached blocks to the card."""
    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    RELEASES["calls"] += 1
    RELEASES["seconds"] += time.perf_counter() - t0


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
    # what is alive now (the modules, the kernels' libraries) lives to the
    # end: the collections of release_memory skip it
    import paddle_tpu_torch.fluid  # noqa: F401  (the port's modules)
    gc.freeze()
    # the op phases' CPU sides, made while the card's phases run
    global CASE_REFERENCES
    CASE_REFERENCES = CaseReferences(CASE_PHASES)
    CASE_REFERENCES.start()
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
    bwd_row, bwd_bf16_row, step_rows = phase_times_train(fa, {
        "eager": eager + (main_prog, loss),
        "captured": graph + (main_prog, loss),
        "captured_amp": (amp_exe, amp_scope, amp_prog, amp_loss)},
        main_prog, loss, train_feed8)
    opprof_launches = phase_opprof(fa, main_prog, state0, loss, eager,
                                   train_feed8, {
            name: ms / BERT["n_layers"] for name, ms in
            step_rows["captured"]["flash_kernels_ms"].items()}, smi)
    # BERT's executors, graphs and their memory go before ResNet-50's (an
    # engine and its cache entries refer to each other: a collection frees
    # them)
    del eager, graph, amp_exe, amp_scope
    release_memory()
    ckpt_launches = phase_checkpoint(fa, smi)
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
    r_reader_launches = phase_reader_pipeline(fa, smi)
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
    dense_launches["ctr_auc"] = phase_ctr_auc(fa, smi)  # releases memory

    # the sequence ops, beam-search decoding, the text-convolution
    # classifier and the CRF tagger
    seq_launches = {"sequence_ops": phase_sequence_ops(fa, smi)}
    seq_launches["nmt_beam"] = phase_nmt_beam(fa, smi)
    seq_launches["sentiment_conv"] = phase_sentiment_conv(fa, smi)
    seq_launches["srl_crf"] = phase_srl_crf(fa, smi)  # releases memory

    # the misc op family, the skip-gram trainer and C3D
    misc_launches = {"misc_ops": phase_misc_ops(fa, smi)}
    misc_launches["skipgram_nce"] = phase_skipgram_nce(fa, smi)
    misc_launches["c3d"] = phase_c3d(fa, smi)  # releases memory

    # SSD-MobileNet-v1 trained and served, and the detection and CTC op
    # families at their users' shapes
    det_launches = {"ssd": phase_ssd(fa, smi)}
    det_launches["detection_ops"] = phase_detection_ops(fa, smi)  # releases

    # the opt-level ladder (levels 2 and 3 on BERT-base), the NHWC layout
    # pass on ResNet-50, and the INT8 serving path with the AOT artifact
    opt_launches = phase_opt_levels(fa, smi)
    release_memory()
    opt_launches["layout_nhwc"] = phase_layout_nhwc(fa, smi)
    release_memory()
    opt_launches["int8_serve"] = phase_int8_serve(fa, smi)
    release_memory()
    # the mesh path on torch.distributed, then the parameter-server path
    opt_launches["mesh"] = phase_mesh(fa, smi)
    release_memory()
    opt_launches["pserver"] = phase_pserver(fa, smi)  # releases memory
    emit({"phase": "times", "partial_profiler_windows_rerun":
          len(PARTIAL_PROFILES), "partial_windows": PARTIAL_PROFILES,
          "event_timed": EVENT_TIMED,
          "case_references_s": CASE_REFERENCES.seconds,
          "release_memory": RELEASES})
    other_paths = {"opprof": opprof_launches,
                   "checkpoint": ckpt_launches,
                   "resnet50_serve": r_serve_launches,
                    "resnet50_train": r_launches,
                    "resnet50_train_amp": r_amp_launches,
                    "resnet50_pipelined": r_pipe_launches,
                    "reader_pipeline": r_reader_launches}
    other_paths.update(("bert_recipe_" + p, n)
                        for p, n in recipe_launches.items())
    other_paths["ctr"] = dict(zip(("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"), ctr_launches))
    other_paths.update(nmt_launches)
    other_paths["lstm"] = lstm_launches
    other_paths.update(image_launches)
    other_paths.update(fuse_launches)
    other_paths.update(dense_launches)
    other_paths.update(seq_launches)
    other_paths.update(misc_launches)
    other_paths.update(det_launches)
    other_paths.update(opt_launches)

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


def run():
    """``main``, then the case-preparing thread stopped, however main
    ended."""
    try:
        return main()
    finally:
        if CASE_REFERENCES is not None:
            CASE_REFERENCES.stop()


if __name__ == "__main__":
    sys.exit(run())
