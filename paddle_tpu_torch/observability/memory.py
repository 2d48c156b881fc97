"""Device-memory accounting — port of ``device_memory_limit`` from
``paddle_tpu/observability/memory.py`` (:75), which the opt-level-3
memory planner (``analysis/memory.py`` ``hbm_budget_bytes``) budgets
against. The rest of the reference's module (the live-buffer census,
the allocator gauges, the compile-time peak estimates and the
memory-pressure event, on ``torch.cuda.memory_stats``) is ROADMAP
Queue 1 item 11.
"""

import torch

from paddle_tpu_torch import flags

__all__ = ["device_memory_limit"]


def device_memory_limit(device=None):
    """Device memory capacity in bytes, or None when unknowable: the
    ``PADDLE_GPU_DEVICE_MEMORY_BYTES`` override wins, else the card's
    total memory (``torch.cuda.get_device_properties``) for a CUDA
    ``device`` (default: the current card when CUDA is available), and
    None on the CPU."""
    override = int(flags.get_flag("device_memory_bytes"))
    if override > 0:
        return override
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)
