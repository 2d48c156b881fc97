#!/usr/bin/env python3
"""On-card smoke test of ``paddle_tpu_torch``, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It drives the port's main path and its kernels on the card and prints one
JSON line per phase:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is turned off for matmul and cuDNN.
2. build   — builds every CUDA kernel of the port from the checkout's
   sources (one nvcc per source, started together) and times the build.
3. kernel  — the flash-attention forward kernel against its plain torch
   version on the same inputs, out and lse, case by case: BERT shapes
   (B=8, H=12, D=64) at T=128 and 512, float32 and bfloat16, causal or
   not, ragged seq_lens, a fully masked row under causal with offsets,
   Tq != Tk and T not a multiple of the tile, unaligned offsets, other
   head dims, and dropout rate 0.1 with the same seed (identical masks).
4. serve   — BERT-base (d 768, 12 layers, 12 heads, d_inner 3072, vocab
   30522, seq 128, fp32, random weights from the seed) built with
   ``models.bert.get_model``, initialised on the card by the startup
   program, saved with ``io.save_inference_model``, loaded by
   ``inference.create_paddle_predictor``, answering requests of batch 1, 4
   and 8 with ragged seq_lens. Checks shapes, finiteness, exactly 12 kernel
   launches per request, and one batch-1 answer against the same model
   directory served on the CPU (``config.disable_gpu()``).
5. times   — device times from torch.profiler for the kernel, its plain
   version and ``scaled_dot_product_attention`` (a yardstick the port never
   calls), the least time the card could take (bytes over 3.35 TB/s, or
   operations over the card's peak for the input type: 67 TFLOP/s float32
   outside the tensor cores, 989 TFLOP/s bfloat16 dense on the tensor
   cores), and the predictor's per-request latency at batch 1 and 8.
6. kernels — one JSON object listing every ported kernel.

The last line is ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero; it exits non-zero without a result when
CUDA is unavailable or the port's package is not beside it.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM, NVIDIA data sheet: HBM rate and the dense peak for each input
# type (TF32 is off, so float32 runs outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
PEAKS = ("3.35 TB/s HBM; 67 TFLOP/s float32 outside the tensor cores, "
         "989 TFLOP/s bfloat16 dense on the tensor cores")

# out, |kernel - plain| <= rel * |plain| + abs. float32: the two sum in
# different orders (tiles of 32 keys with a running max vs one
# reduction). bfloat16: both round a float32 result to bfloat16 at the
# end, and where the two float32 values straddle a rounding boundary they
# land one ulp apart, at most 2^-7 of the value. lse is float32 in both.
TOL = {"float32": {"out_rel": 0.0, "out_abs": 1e-4, "lse": 1e-4},
       "bfloat16": {"out_rel": 2.0 ** -7, "out_abs": 1e-5, "lse": 1e-4}}
# the served model against the CPU: float32 GEMMs (TF32 off) summed in
# another order by cuBLAS than by the CPU GEMM, over 12 layers
SERVE_TOL = {"rtol": 1e-3, "atol": 2e-3}

BERT = dict(vocab_size=30522, d_model=768, n_layers=12, n_heads=12,
            d_inner=3072, max_position=512, seq_len=128)


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


def device_kernels(fn, n):
    """Run ``fn`` ``n`` times under torch.profiler; returns {kernel name:
    device ms per call} of the CUDA kernels it launched (empty if the
    profiler recorded no device activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / n
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


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


def phase_kernel(fa):
    """Kernel against plain version case by case; returns the worst out
    error over all cases."""
    import torch

    lens8 = torch.tensor([128, 70, 1, 64, 127, 33, 100, 5], device="cuda")
    cases = [
        # name, B, H, Tq, Tk, D, dtype, causal, lens, offsets, rate
        ("bert_t128_f32", 8, 12, 128, 128, 64, "float32", False, None, None, 0.0),
        ("bert_t128_f32_causal", 8, 12, 128, 128, 64, "float32", True, None, None, 0.0),
        ("bert_t512_f32", 8, 12, 512, 512, 64, "float32", False, None, None, 0.0),
        ("bert_t512_f32_causal", 8, 12, 512, 512, 64, "float32", True, None, None, 0.0),
        ("bert_t128_bf16", 8, 12, 128, 128, 64, "bfloat16", False, None, None, 0.0),
        ("bert_t512_bf16_causal", 8, 12, 512, 512, 64, "bfloat16", True, None, None, 0.0),
        ("ragged_lens", 8, 12, 128, 128, 64, "float32", False, lens8, None, 0.0),
        ("ragged_lens_causal", 8, 12, 128, 128, 64, "float32", True, lens8, None, 0.0),
        ("masked_rows_causal_offsets", 8, 12, 64, 96, 64, "float32", True, lens8, (0, 40), 0.0),
        ("tq_ne_tk_ragged_tiles", 2, 3, 100, 77, 64, "float32", False, None, None, 0.0),
        ("tq_ne_tk_ragged_tiles_causal", 2, 3, 100, 77, 64, "float32", True, None, (50, 0), 0.0),
        ("unaligned_offsets", 8, 12, 128, 128, 64, "float32", True, None, (37, 5), 0.0),
        ("head_dim_128", 2, 4, 200, 200, 128, "float32", False, None, None, 0.0),
        ("head_dim_40_bf16", 2, 4, 90, 130, 40, "bfloat16", True, None, None, 0.0),
        ("dropout_0.1", 8, 12, 128, 128, 64, "float32", False, lens8, None, 0.1),
        ("dropout_0.1_causal_bf16", 8, 12, 128, 128, 64, "bfloat16", True, lens8, None, 0.1),
    ]
    worst = 0.0
    for i, (name, B, H, Tq, Tk, D, dt, causal, lens, offs, rate) in \
            enumerate(cases):
        dtype = getattr(torch, dt)
        q, k, v = attention_inputs(B, H, Tq, Tk, D, dtype, 100 + i)
        lens_b = None if lens is None else lens[:B]
        seed = 1234
        out_k, lse_k = fa.flash_forward_cuda(q, k, v, lens_b, offs, seed,
                                             causal, None, rate)
        out_p, lse_p = fa.attention_lse_plain(q, k, v, lens_b, offs, seed,
                                              causal, None, rate)
        torch.cuda.synchronize()
        tol = TOL[dt]
        diff = (out_k.float() - out_p.float()).abs()
        err_out = diff.max().item()
        # the largest excess over the allowed |d| <= rel * |plain| + abs
        excess = (diff - tol["out_rel"] * out_p.float().abs()
                  - tol["out_abs"]).max().item()
        err_lse = (lse_k - lse_p).abs().max().item()
        row = {"phase": "kernel", "case": name, "shape": [B, H, Tq, Tk, D],
               "dtype": dt, "causal": causal, "seq_lens": lens is not None,
               "offsets": offs, "rate": rate,
               "max_abs_err_out": err_out,
               "tol_out": {"rel": tol["out_rel"], "abs": tol["out_abs"]},
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


def attention_work(B, H, Tq, Tk, D, itemsize, lens):
    """(bytes, flops) the function needs on these inputs: q and out whole,
    the k/v rows below each sequence's length, lse; QK^T and PV over the
    valid keys only."""
    valid = [min(max(int(n), 1), Tk) for n in lens] if lens is not None \
        else [Tk] * B
    keys = sum(valid) * H
    nbytes = (2 * B * H * Tq * D * itemsize + 2 * keys * D * itemsize
              + B * H * Tq * 4 + (B * 4 if lens is not None else 0))
    flops = 4 * Tq * keys * D
    return nbytes, flops


def time_kernel(fa, B, H, T, D, dtype, lens):
    """Kernel, plain version and SDPA at one shape; returns a dict."""
    import torch
    import torch.nn.functional as F

    q, k, v = attention_inputs(B, H, T, T, D, dtype, 99)
    lens_t = None if lens is None else torch.as_tensor(
        lens, device="cuda").reshape(B)
    mask = None
    if lens_t is not None:
        mask = (torch.arange(T, device="cuda").reshape(1, 1, 1, T)
                < lens_t.clamp(min=1).reshape(B, 1, 1, 1))
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
    return row


def profile_request(predictor, feed, wall_ms):
    """Device time of one served request by kernel (profiler), against the
    request's unprofiled median wall ``wall_ms``."""
    kernels = device_kernels(lambda: predictor.run(feed), 3)
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
              **profile_request(predictor, feed8, latency[8]["median_ms"])))
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
    ptxas = [ln.strip() for name in build.SOURCES
             for ln in build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built, "ptxas": ptxas})

    worst = phase_kernel(fa)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bert_") as model_dir:
        predictor, launches, feed8 = phase_serve(fa, model_dir)
        main_row = phase_times(fa, predictor, feed8)

    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:110",
        "launches": launches, "max_abs_err": worst,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
