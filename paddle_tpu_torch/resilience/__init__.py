"""paddle_tpu_torch.resilience — port of ``paddle_tpu/resilience/``, as
far as the checkpoint slice needs it (ROADMAP Queue 1 item 7c):

* ``retrying``    — one shared backoff/deadline/jitter policy (the
  checkpoint writer's retries);
* ``faultinject`` — deterministic named fault points at the engine
  seams, scheduled by ``PADDLE_GPU_FAULT_SPEC`` so every recovery path
  runs in CPU-only tests.

The rollback-on-fault step loop, ``elastic`` (the lost-device registry
and the ``FleetRouter``) and the SDC ``sentinel`` are ROADMAP Queue 1
item 11; until then a ``bitflip`` entry that fires at the engine seam
raises ``NotImplementedError``.
"""

from paddle_tpu_torch.resilience import faultinject, retrying  # noqa: F401
from paddle_tpu_torch.resilience.faultinject import (  # noqa: F401
    LOST_EXIT_CODE,
    PREEMPT_EXIT_CODE,
    InjectedFault,
    fault_point,
)
from paddle_tpu_torch.resilience.retrying import (  # noqa: F401
    Backoff,
    DeadlineExceeded,
    RetriesExhausted,
    retry_call,
)

__all__ = [
    "Backoff", "DeadlineExceeded", "InjectedFault", "LOST_EXIT_CODE",
    "PREEMPT_EXIT_CODE", "RetriesExhausted", "fault_point", "faultinject",
    "retry_call", "retrying",
]
