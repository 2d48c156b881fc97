#!/usr/bin/env python3
"""A/B timing of compile-time variants of the port's flash kernels on one
NVIDIA card.

Run from the root of a checkout on a machine with a card and nvcc:

    python3 tools/torch_flash_variants.py [variant ...]

Each variant is a copy of ``paddle_tpu_torch/kernels/csrc/`` with a few
string replacements (``VARIANTS`` below; "base" is the source as
committed), built with the port's own nvcc flags into a temporary
directory. For every variant, in turns (all variants, then all again in
reverse order, so drift on the card shows), it loads the variant's
``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` libraries into the
port's wrappers and prints one JSON line per shape: each kernel's device
time (torch.profiler, as chip_smoke.py times them) and the largest
difference of out, dq, dk and dv from the plain versions. Shapes: the
training path's (B=8 H=12 T=128 D=64 float32, ragged lengths), T=512
float32 and bfloat16, and T=512 float32 at head dim 128 (H=6, the same
width). The first line gives the card and its power limit, and each
build's registers and spills from ptxas.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> [(file, old, new)], each old string present once in the file
VARIANTS = {
    "base": [],
    # one TF32 product per float32 product, not three (fails the limits)
    "1xtf32": [("flash_mma.cuh",
                "  mma_tf32(c, a.small, b_big);\n"
                "  mma_tf32(c, a.big, b_small);\n", "")],
    # dK/dV with 64-row Q tiles in float32 too
    "dkv_f32_q64": [("flash_bwd_dkv.cu",
                     "kBlockQ = kBf16 && kD <= 64 ? 64 : 32;",
                     "kBlockQ = kD <= 64 ? 64 : 32;")],
    # dK/dV with 32-row Q tiles in bf16 too
    "dkv_bf16_q32": [("flash_bwd_dkv.cu",
                      "kBlockQ = kBf16 && kD <= 64 ? 64 : 32;",
                      "kBlockQ = 32;")],
    # forward with 32-key K/V tiles
    "fwd_k32": [("flash_fwd.cu", "constexpr int kBlockK = 64;",
                 "constexpr int kBlockK = 32;")],
    # exp2f (denormals kept) in place of ex2.approx.ftz
    "exp2f": [("flash_mma.cuh",
               '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n'
               "  return y;",
               "  y = exp2f(x);\n  return y;")],
    # dQ with 64-key K/V tiles in float32 too
    "dq_f32_k64": [("flash_bwd_dq.cu", "kBlockK = kBf16 ? 64 : 32;",
                    "kBlockK = 64;")],
    # dQ holding its bf16 Q and dO fragments in registers for the whole key
    # loop up to D = 64, where the source reads them from shared memory at
    # every tile
    "dq_bf16_frags_regs": [
        ("flash_bwd_dq.cu",
         "  const uint32_t seed_term = dropout_seed_term(seed, bh);\n",
         "  uint32_t qf[kDSteps][4], dof[kDSteps][4];\n"
         "  const uint32_t seed_term = dropout_seed_term(seed, bh);\n"),
        ("flash_bwd_dq.cu",
         "        frag(aq, q_s, c);\n        frag(ado, do_s, c);\n",
         "        if (kD > 64 || it == 0) {\n"
         "          frag(qf[c], q_s, c);\n"
         "          frag(dof[c], do_s, c);\n"
         "        }\n"
         "        for (int i = 0; i < 4; ++i) {\n"
         "          aq[i] = qf[c][i];\n"
         "          ado[i] = dof[c][i];\n"
         "        }\n")],
    # dQ with 2 warps (32 q rows) a block in float32 at head dim 128
    "dq_f32_d128_q32": [("flash_bwd_dq.cu", "kWarps = 4;",
                         "kWarps = !kBf16 && kD == 128 ? 2 : 4;")],
}
LIBS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def build_variant(build, name, out_dir):
    """Patch a copy of csrc/ and start one nvcc per library; returns the
    processes."""
    src = os.path.join(os.path.dirname(build.__file__), "csrc")
    d = os.path.join(out_dir, name)
    os.makedirs(d)
    for f in os.listdir(src):
        with open(os.path.join(src, f)) as fh:
            text = fh.read()
        for fname, old, new in VARIANTS[name]:
            if fname == f:
                if text.count(old) != 1:
                    raise RuntimeError("%s: %r not found once in %s"
                                       % (name, old, f))
                text = text.replace(old, new)
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    return {lib: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o",
         os.path.join(d, lib + ".so"), os.path.join(d, lib + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for lib in LIBS}


def use_variant(fa, out_dir, name):
    """Point the port's wrappers at variant ``name``'s libraries."""
    for lib in LIBS:
        handle = ctypes.CDLL(os.path.join(out_dir, name, lib + ".so"))
        fn = getattr(handle, lib)
        fn.argtypes = ([ctypes.c_void_p] * fa._N_POINTERS[lib]
                       + fa._TAIL_ARGS)
        fn.restype = ctypes.c_int
        err = getattr(handle, lib + "_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fa._libs[lib] = handle


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import paddle_tpu_torch.kernels.flash_attention as fa
    from paddle_tpu_torch.kernels import build

    names = argv or list(VARIANTS)
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = tempfile.mkdtemp(prefix="flash_variants_")
    try:
        run(cs, fa, build, names, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return 0


def run(cs, fa, build, names, out_dir):
    import torch

    procs = {name: build_variant(build, name, out_dir) for name in names}
    ptxas = {}
    for name, libs in procs.items():
        for lib, proc in libs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("%s %s: nvcc failed:\n%s"
                                   % (name, lib, log))
            ptxas[name] = dict(ptxas.get(name, {}), **cs.ptxas_summary(log))
    cs.emit({"nvidia_smi": cs.nvidia_smi(), "ptxas": ptxas})

    shapes = (("main_path", 12, 128, 64, torch.float32, cs.LENS8),
              ("t512_f32", 12, 512, 64, torch.float32, None),
              ("t512_bf16", 12, 512, 64, torch.bfloat16, None),
              ("t512_f32_d128", 6, 512, 128, torch.float32, None))
    for name in names + names[::-1]:
        use_variant(fa, out_dir, name)
        for shape, H, T, D, dtype, lens in shapes:
            q, k, v = cs.attention_inputs(8, H, T, T, D, dtype, 99)
            gen = torch.Generator(device="cuda").manual_seed(97)
            g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
            lens_t = None if lens is None else torch.tensor(lens,
                                                            device="cuda")
            out, lse = fa.flash_forward_cuda(q, k, v, lens_t)
            grads = fa.flash_backward_cuda(q, k, v, out, lse, g, None,
                                           lens_t)
            want_out, _ = fa.attention_lse_plain(q, k, v, lens_t)
            want = fa.attention_bwd_plain(q, k, v, out, lse, g, None, lens_t)
            pairs = [("out", out, want_out)] + list(
                zip(("dq", "dk", "dv"), grads, want))
            err = {n: (a.float() - b.float()).abs().max().item()
                   for n, a, b in pairs}
            row = {"variant": name, "shape": shape,
                   "flash_fwd_ms": cs.device_ms(
                       lambda: fa.flash_forward_cuda(q, k, v, lens_t),
                       "flash_fwd")}
            # one profile of the backward times both of its kernels

            def backward():
                fa.flash_backward_cuda(q, k, v, out, lse, g, None, lens_t)

            for _ in range(3):
                backward()
            bwd = cs.device_kernels(backward, 20)
            for lib in ("flash_bwd_dq", "flash_bwd_dkv"):
                row[lib + "_ms"] = sum(t for key, t in bwd.items()
                                       if lib + "_kernel" in key)
                cs.check(row[lib + "_ms"] > 0, "the profiler recorded no "
                         "%s kernel (saw %s)" % (lib, sorted(bwd)))
            row["max_abs_err"] = err
            cs.emit(row)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
