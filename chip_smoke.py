#!/usr/bin/env python3
"""On-card smoke test of ``paddle_tpu_torch``, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It drives the port's two main paths, serving and training, and its
kernels on the card and prints one JSON line per phase:

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
   bfloat16) runs in at least one case.
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
   the float32 rate outside the tensor cores), and the predictor's
   per-request latency at batch 1 and 8.
8. train   — BERT-base pre-training at the same width,
   ``get_model(is_train=True)`` (append_backward + Adam), dropout 0.1,
   startup on the card, 5 steps on a repeated ragged batch of 8. Checks
   finite and falling loss, exactly 12 forward, 12 dQ and 12 dK/dV
   launches a step, and one step at batch 2 against the same step of the
   port on the CPU (loss and six parameter grads, from the same initial
   state via ``convert.load_numpy_state``).
9. times   — the backward kernels at the training shape (B=8 H=12 T=128
   D=64 float32, ragged lengths) and at T=512 float32 and bfloat16: each
   kernel's device time and bound, the plain backward's, and the backward
   of ``scaled_dot_product_attention``; the training step's median wall,
   device-busy share and top kernels.
10. kernels — one JSON object listing every ported kernel, with its
   design: all three run their products on the tensor cores (mma.sync
   bf16, 3xTF32 for float32) from a cp.async tile ring.

The last line is ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero; it exits non-zero without a result when
CUDA is unavailable or the port's package is not beside it.
"""

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
# how every kernel computes its products
DESIGN = "mma.sync bf16 / 3xTF32, cp.async ring"

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
# the served model against the CPU: float32 GEMMs (TF32 off) summed in
# another order by cuBLAS than by the CPU GEMM, over 12 layers
SERVE_TOL = {"rtol": 1e-3, "atol": 2e-3}
# a request answered in a bucket against the same request answered alone,
# both on the card: cuBLAS may take another algorithm for 32 rows than for
# 1, so the float32 sums may differ in their last bits over 12 layers
SERVE_BATCHED_TOL = {"rtol": 1e-4, "atol": 1e-4}
SERVE_CLIENTS = (1, 8, 32)
SERVE_REQUESTS = 200   # batch-1 requests at each client count
SERVE_POOL = 64        # distinct requests the clients cycle through

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


# profiler windows that dropped device activity and were run again: per
# window, the calls and up to four kernels whose count was off (none: the
# window held no device activity)
PARTIAL_PROFILES = []


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


def device_kernels(fn, n, attempts=3):
    """Run ``fn`` ``n`` times under torch.profiler; returns {kernel name:
    device ms per call} of the CUDA kernels it launched. ``fn`` launches
    the same kernels on every call, so each kernel's count in the window
    should be a multiple of ``n``. On the H100 a window can miss one launch
    of a kernel (seen in 28 of the 54 windows of one run, always one of
    torch's own kernels: 19 launches of 20, 39 of 40), so a kernel's time
    per call is its mean launch time times its launches per call, its
    count over ``n`` rounded.
    A window with a kernel further off, or with no device activity at all,
    dropped more (seen: a window of 20 calls with none, and one that held
    about a quarter of each kernel's launches); it is profiled again, up
    to ``attempts`` times, and recorded in PARTIAL_PROFILES. Returns the
    last window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels, odd = {}, []
        for e in prof.key_averages():
            if (e.device_type != DeviceType.CUDA
                    or e.self_device_time_total <= 0):
                continue
            per_call = round(e.count / n)
            if per_call == 0 or abs(e.count - per_call * n) > 1:
                odd.append([e.key[:60], e.count])
            kernels[e.key] = (e.self_device_time_total / e.count
                              * max(per_call, 1) / 1e3)
        if kernels and not odd:
            return kernels
        PARTIAL_PROFILES.append({"calls": n, "odd_counts": odd[:4]})
    return kernels


def device_ms(fn, name=None, n=20, warmup=3):
    """Device time per call (ms) of the kernels whose name contains
    ``name`` (all kernels when None), from the profiler; raises when the
    profiler recorded no such kernel."""
    for _ in range(warmup):
        fn()
    kernels = device_kernels(fn, n)
    total = sum(ms for key, ms in kernels.items()
                if name is None or name in key)
    check(total > 0, "the profiler recorded no device time of kernel %r "
          "(saw %s)" % (name, sorted(kernels)))
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


def phase_kernel(fa):
    """Kernel against plain version case by case; returns the worst out
    error over all cases."""
    import torch

    worst = 0.0
    for i, (name, B, H, Tq, Tk, D, dt, causal, lens, offs, rate) in \
            enumerate(KERNEL_CASES):
        q, k, v, lens_b = case_inputs(i, KERNEL_CASES[i])
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


def phase_kernel_bwd(fa):
    """The dQ and dK/dV kernels against ``attention_bwd_plain``, case by
    case: every forward case plus one with a nonzero lse cotangent. Both
    take the same (q, k, v), the forward kernel's (out, lse) and the same
    cotangents. Returns the worst error of each kernel over all cases:
    {"flash_bwd_dq": dq, "flash_bwd_dkv": max(dk, dv)}."""
    import torch

    cases = list(enumerate(KERNEL_CASES)) + [(len(KERNEL_CASES), (
        "lse_cotangent_causal_offsets", 8, 12, 64, 96, 64, "float32", True,
        LENS8, (0, 40), 0.0))]
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
    for b, feed in requests.items():
        before = fa.launches
        (out,) = predictor.run(feed)
        outs[b] = out.data
        per_request.append(fa.launches - before)
    torch.cuda.synchronize()
    launches = fa.launches  # ... and ends here
    for b, out in outs.items():
        check(out.shape == (b, BERT["seq_len"], BERT["d_model"]),
              "enc_out shape %s at batch %d" % (out.shape, b))
        check(np.isfinite(out).all(), "enc_out finite at batch %d" % b)
    check(per_request == [n_layers] * len(requests),
          "flash kernel launches per request %s, want %d each"
          % (per_request, n_layers))

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
          "launches": launches,
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
                   "launches": launches, "max_abs_err": err,
                   "tol": SERVE_BATCHED_TOL}
            emit(row)
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
          "launches": launches})
    return launches


def train_feed(batch, rng):
    from paddle_tpu_torch.models import bert

    return bert.make_fake_batch(batch, BERT["seq_len"], BERT["vocab_size"],
                                rng=rng, varlen=True)


def phase_train(fa):
    """BERT-base pre-training on the card: ``get_model(is_train=True)``
    (append_backward + Adam), startup on the card, TRAIN_STEPS steps on a
    repeated ragged batch of 8, each with 12 launches of every flash
    kernel; then one step at batch 2 on the card against the same step of
    the port on the CPU, from the same initial state. Returns (executor,
    scope, program, loss var, batch-8 feed, launches by kernel)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import convert, unique_name
    from paddle_tpu_torch.models import bert

    t0 = time.perf_counter()
    with unique_name.guard():
        main, startup, handles = bert.get_model(
            batch_size=8, dropout=0.1, is_train=True, **BERT)
    main.random_seed = startup.random_seed = 2024
    loss = handles["loss"]
    ops = [op.type for op in main.desc.global_block().ops]
    exe = fluid.Executor()  # CUDAPlace(0)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    persistable = sorted(v.name for v in main.list_vars() if v.persistable)
    state0 = {n: scope.get(n).cpu().numpy() for n in persistable}
    setup_s = time.perf_counter() - t0
    n_layers = BERT["n_layers"]

    feed8 = train_feed(8, np.random.RandomState(11))
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

    def counts():
        return (fa.launches, fa.launches_dq, fa.launches_dkv)

    losses, per_step = [], []
    torch.cuda.synchronize()
    fa.launches = fa.launches_dq = fa.launches_dkv = 0  # the path starts
    with fluid.scope_guard(scope):
        for _ in range(TRAIN_STEPS):
            before = counts()
            (out,) = exe.run(main, feed=feed8, fetch_list=[loss])
            losses.append(float(out.reshape(-1)[0]))
            per_step.append([a - b for a, b in zip(counts(), before)])
    torch.cuda.synchronize()
    launches = dict(zip(names, counts()))  # ... and ends here
    check(all(np.isfinite(losses)), "training losses %s" % losses)
    check(losses[-1] < losses[0], "loss did not fall: %s" % losses)
    check(per_step == [[n_layers] * 3] * TRAIN_STEPS,
          "fwd/dq/dkv launches per step %s, want %d each"
          % (per_step, n_layers))

    # one step at batch 2, on the card and on the CPU, from the same
    # initial state; fresh executors, so both engines run at the same run
    # counter and draw the same dropout seeds (startup advanced the first
    # executor's), and the hash masks are the same on both devices
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
    emit({"phase": "train", "model": "bert_base", "batch": 8,
          "seq_len": BERT["seq_len"], "dropout": 0.1, "ops": len(ops),
          "grad_ops": sum(t.endswith("_grad") for t in ops),
          "params": sum(int(np.prod(p.shape)) for p in main.all_parameters()),
          "seq_lens": feed8["seq_lens"].reshape(-1).tolist(),
          "setup_s": setup_s, "losses": losses,
          "launches_per_step": per_step, "launches": launches,
          "cpu_step": {"batch": 2, "loss_card": float(card[0].reshape(-1)[0]),
                       "loss_cpu": float(cpu[0].reshape(-1)[0]),
                       "loss_abs_err": loss_err, "grads": grad_errs},
          "tol": TRAIN_TOL})
    check(loss_err <= TRAIN_TOL["loss_rtol"] * abs(float(cpu[0].reshape(-1)[0])),
          "card vs CPU step loss error %g" % loss_err)
    for name, e in grad_errs.items():
        check(e["max_abs_err"] <= TRAIN_TOL["grad_rel_to_max"] * e["max_abs"],
              "card vs CPU %s@GRAD error %g (max |grad| %g)"
              % (name, e["max_abs_err"], e["max_abs"]))
    return exe, scope, main, loss, feed8, launches


def valid_keys(B, H, Tk, lens):
    """Keys below each sequence's length (clamped to [1, Tk]), summed over
    the batch and heads."""
    if lens is None:
        return B * H * Tk
    return sum(min(max(int(n), 1), Tk) for n in lens) * H


def key_mask(lens_t, B, T):
    """The boolean key-padding mask SDPA takes for int64 lengths, or None."""
    import torch

    if lens_t is None:
        return None
    return (torch.arange(T, device="cuda").reshape(1, 1, 1, T)
            < lens_t.clamp(min=1).reshape(B, 1, 1, 1))


def attention_work(B, H, Tq, Tk, D, itemsize, lens):
    """(bytes, flops) the function needs on these inputs: q and out whole,
    the k/v rows below each sequence's length, lse, the int64 lengths;
    QK^T and PV over the valid keys only."""
    keys = valid_keys(B, H, Tk, lens)
    nbytes = (2 * B * H * Tq * D * itemsize + 2 * keys * D * itemsize
              + B * H * Tq * 4 + (B * 8 if lens is not None else 0))
    flops = 4 * Tq * keys * D
    return nbytes, flops


def time_kernel(fa, B, H, T, D, dtype, lens):
    """Kernel, plain version and SDPA at one shape; returns a dict."""
    import torch
    import torch.nn.functional as F

    q, k, v = attention_inputs(B, H, T, T, D, dtype, 99)
    lens_t = None if lens is None else torch.as_tensor(
        lens, device="cuda").reshape(B)
    mask = key_mask(lens_t, B, T)
    calls = {
        "": (lambda: fa.flash_forward_cuda(q, k, v, lens_t), "flash_fwd"),
        "plain_": (lambda: fa.attention_lse_plain(q, k, v, lens_t), None),
        "library_": (lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=D ** -0.5), None),
    }
    dt = str(dtype).split(".")[-1]
    row = {"shape": [B, H, T, T, D], "dtype": dt,
           "seq_lens": None if lens is None else [int(n) for n in lens]}
    # device time per call of the call's kernels, from the profiler
    for prefix, (fn, kernel_name) in calls.items():
        row[prefix + "ms"] = device_ms(fn, kernel_name)
    nbytes, flops = attention_work(B, H, T, T, D, q.element_size(), lens)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_PER_S[dt] * 1e3
    row.update({"bytes": nbytes, "flops": flops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    if dt == "float32":
        row["bound_ffma_ms"] = max(t_bytes,
                                   flops / PEAK_FFMA_FLOPS_PER_S * 1e3)
    return row


def attention_bwd_work(kernel, B, H, Tq, Tk, D, itemsize, lens):
    """(bytes, flops) a backward kernel needs on these inputs, from its
    code. Both read q and dO whole, the k/v rows below each sequence's
    length, lse and delta (float32). flash_bwd_dq writes dq and does three
    products per (q row, valid key) pair over D: s = q.k, dp = dO.v,
    dq += ds.k. flash_bwd_dkv writes dk and dv (every key row) and does
    four: s, dp, dv += p.dO, dk += ds.q."""
    keys = valid_keys(B, H, Tk, lens)
    nbytes = (2 * B * H * Tq * D * itemsize + 2 * keys * D * itemsize
              + 2 * B * H * Tq * 4 + (B * 8 if lens is not None else 0))
    if kernel == "flash_bwd_dq":
        return nbytes + B * H * Tq * D * itemsize, 6 * Tq * keys * D
    return nbytes + 2 * B * H * Tk * D * itemsize, 8 * Tq * keys * D


def time_bwd_kernels(fa, B, H, T, D, dtype, lens):
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
    out, lse = fa.flash_forward_cuda(q, k, v, lens_t)

    def kernels():
        return fa.flash_backward_cuda(q, k, v, out, lse, g, None, lens_t)

    for _ in range(3):
        kernels()
    n = 20
    by_name = device_kernels(kernels, n)
    dt = str(dtype).split(".")[-1]
    row = {"shape": [B, H, T, T, D], "dtype": dt,
           "seq_lens": None if lens is None else [int(x) for x in lens]}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        ms = sum(t for key, t in by_name.items() if name + "_kernel" in key)
        check(ms > 0, "the profiler recorded no %s kernel (saw %s)"
              % (name, sorted(by_name)))
        nbytes, flops = attention_bwd_work(name, B, H, T, T, D,
                                           q.element_size(), lens)
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
        q, k, v, out, lse, g, None, lens_t))
    mask = key_mask(lens_t, B, T)
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


def time_train_step(exe, scope, main, loss, feed8):
    """Median wall of a BERT-base training step at batch 8 (host clock, 10
    steps after 2 warm-ups; each ends in the loss's copy to the host), the
    device time of 3 more steps by kernel from the profiler, and the host
    time of 3 more by kind of op."""
    import torch

    import paddle_tpu_torch.fluid as fluid

    def step():
        return exe.run(main, feed=feed8, fetch_list=[loss])

    with fluid.scope_guard(scope):
        for _ in range(2):
            step()
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t0) * 1e3)
        kernels = device_kernels(step, 3)
        host = host_ms_by_kind(step)
    wall = statistics.median(walls)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    flash = {name: sum(t for key, t in kernels.items()
                       if name + "_kernel" in key)
             for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    return {"median_ms": wall, "min_ms": min(walls), "max_ms": max(walls),
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall,
            "flash_kernels_ms": flash, "host_ms_by_kind": host,
            "kernel_names": len(kernels),
            "top_kernels_ms": [[name[:80], ms] for name, ms in top]}


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
    latency = {}
    for b, feed in ((1, {k: v[:1] for k, v in feed8.items()}), (8, feed8)):
        for _ in range(2):
            predictor.run(feed)
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictor.run(feed)  # ends in the fetch's copy to the host
            walls.append((time.perf_counter() - t0) * 1e3)
        latency[b] = {"median_ms": statistics.median(walls),
                      "min_ms": min(walls), "max_ms": max(walls)}
    emit({"phase": "times", "predictor_request_ms": latency,
          "model": "bert_base", "seq_len": BERT["seq_len"]})
    emit(dict({"phase": "times", "profile": "batch-8 request"},
              **profile_request(lambda: predictor.run(feed8),
                                latency[8]["median_ms"])))
    return rows["main_path"]


def phase_times_train(fa, exe, scope, main, loss, feed8):
    """The backward kernels at the training path's shape (B=8 H=12 T=128
    D=64 float32, the batch's ragged lengths) and at T=512 float32 and
    bfloat16, then the training step. Returns the main-path row."""
    import torch

    lens8 = feed8["seq_lens"].reshape(-1).tolist()
    rows = {
        "main_path": time_bwd_kernels(fa, 8, 12, 128, 64, torch.float32,
                                      lens8),
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
    emit(dict({"phase": "times", "profile": "batch-8 training step",
               "model": "bert_base", "seq_len": BERT["seq_len"]},
              **time_train_step(exe, scope, main, loss, feed8)))
    emit({"phase": "times", "partial_profiler_windows_rerun":
          len(PARTIAL_PROFILES), "partial_windows": PARTIAL_PROFILES})
    return rows["main_path"]


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

    worst = phase_kernel(fa)
    worst_bwd = phase_kernel_bwd(fa)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bert_") as model_dir:
        predictor, serve_launches, feed8 = phase_serve(fa, model_dir)
        batched_launches = phase_serve_batched(fa, predictor, smi)
        main_row = phase_times(fa, predictor, feed8)
    del predictor
    exe, scope, main_prog, loss, train_feed8, launches = phase_train(fa)
    bwd_row = phase_times_train(fa, exe, scope, main_prog, loss, train_feed8)

    # launches: the training path's (forward, dQ and dK/dV each 12 a
    # step); the forward's on the served paths are in launches_by_path
    kernels = [{
        "name": "flash_fwd", "route": "cuda", "design": DESIGN,
        "source": "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:110",
        "launches": launches["flash_fwd"],
        "launches_by_path": {"serve": serve_launches,
                             "serve_batched": batched_launches,
                             "train": launches["flash_fwd"]},
        "max_abs_err": worst,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]
    for name, line in (("flash_bwd_dq", 269), ("flash_bwd_dkv", 328)):
        kernels.append({
            "name": name, "route": "cuda", "design": DESIGN,
            "source": "paddle_tpu_torch/kernels/csrc/%s.cu" % name,
            "replaces": "paddle_tpu/kernels/flash_attention.py:%d" % line,
            "launches": launches[name], "max_abs_err": worst_bwd[name],
            "ms": bwd_row[name]["ms"], "plain_ms": bwd_row["plain_ms"],
            "bound_ms": bwd_row[name]["bound_ms"],
            "bound_by": bwd_row[name]["bound_by"],
            "library_ms": bwd_row["library_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
