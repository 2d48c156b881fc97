#!/usr/bin/env python3
"""Which kernel launches a torch.profiler window misses on one NVIDIA card.

Run from the root of a checkout on a machine with a card and nvcc:

    python3 tools/torch_profiler_drops.py [--model nmt|bert]
                                          [--windows 24] [--calls 1]

It builds one training step as ``chip_smoke.py`` builds it (``nmt``:
Transformer-base at batch 32 and seq 256, float32, dropout 0.1; ``bert``:
BERT-base at batch 8 and seq 128), captures it as one CUDA graph, and
profiles ``--windows`` windows of ``--calls`` replays each. A replay
launches the same kernels in the same order every time, so every window
should hold the same sequence of kernel names, and the launch counters
of the flash kernels say how many of them each replay launched.

Each window prints one JSON line: its launches, the flash kernels'
launches by the profiler and by the counters, and, where it holds fewer
launches than the longest window, each launch it lacks: the launch's
index in the longest window's sequence (kernels ordered by their start
on the card), the kernel's name, and the distance in launches to the
window's first and last launch. The first line gives the card and its
power limit, the last a summary over the windows.
"""

import argparse
import collections
import difflib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def step(model):
    """(run one step, its captured executor's engine) for ``model``."""
    import numpy as np

    import chip_smoke as cs
    import paddle_tpu_torch.fluid as fluid

    if model == "nmt":
        main, startup, h = cs.nmt_program()
        loss = h["loss"]
        feed = cs.nmt_feed(cs.NMT["batch_size"], cs.NMT_FEED_SEED)
    else:
        main, startup, loss = cs.bert_train_program(amp=False)
        feed = cs.train_feed(8, np.random.RandomState(11))
    exe, scope = cs.fresh(startup)

    def run():
        with fluid.scope_guard(scope):
            exe.run(main, feed=feed, fetch_list=[loss])

    return run


def window(run, calls, fa):
    """The names of the kernels of ``calls`` runs in the order they
    started on the card, and the flash counters' launches in them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = [getattr(fa, c) for c in fa.COUNTERS]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    counted = [getattr(fa, c) - b for c, b in zip(fa.COUNTERS, before)]
    kernels = sorted((e.time_range.start, e.name) for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    return [name for _, name in kernels], dict(zip(FLASH, counted))


def flash_counts(names):
    return {k: sum(k + "_kernel" in n for n in names) for k in FLASH}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("nmt", "bert"), default="nmt")
    ap.add_argument("--windows", type=int, default=24)
    ap.add_argument("--calls", type=int, default=1)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profiler_drops: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import paddle_tpu_torch.kernels.flash_attention as fa
    from paddle_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"card": cs.nvidia_smi(), "model": args.model,
                      "windows": args.windows, "calls": args.calls}),
          flush=True)
    build.build_all()
    run = step(args.model)
    for _ in range(3):  # eager, capture, one replay
        run()
    seqs = [window(run, args.calls, fa) for _ in range(args.windows)]
    full = max((names for names, _ in seqs), key=len)
    missing_names = collections.Counter()
    short = 0
    for i, (names, counted) in enumerate(seqs):
        row = {"window": i, "launches": len(names),
               "flash_profiled": flash_counts(names),
               "flash_counted": counted}
        if len(names) < len(full):
            short += 1
            lacks = []
            for tag, a0, a1, b0, _ in difflib.SequenceMatcher(
                    None, full, names, autojunk=False).get_opcodes():
                if tag in ("delete", "replace"):
                    lacks += [{"index": j, "kernel": full[j][:90],
                               "from_first": b0, "to_last": len(names) - b0}
                              for j in range(a0, a1)]
            row["lacks"] = lacks
            missing_names.update(x["kernel"] for x in lacks)
        print(json.dumps(row), flush=True)
    print(json.dumps({"summary": {
        "windows": args.windows, "windows_short": short,
        "launches_full": len(full),
        "flash_full": flash_counts(full),
        "missing_by_kernel": missing_names.most_common(10)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
