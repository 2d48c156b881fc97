"""Distributed training over a parameter server — port of
``paddle_tpu/distributed/`` (reference: python/paddle/fluid/transpiler/
and operators/distributed/): the transport of the DistributeTranspiler's
pserver mode (``ps.py``). A collective world is joined through
``parallel.env.init_distributed``; the multi-process launcher
(``launch_processes``) is ROADMAP Queue 1 item 11."""

from paddle_tpu_torch.distributed.ps import (  # noqa: F401
    DistTrainer,
    ParameterServer,
    PSClient,
    RpcDeadlineError,
    RpcError,
    RpcPeerClosedError,
    rpc_deadline_seconds,
)
