"""Multi-process bootstrap — port of ``paddle_tpu/parallel/env.py``.

The reference's rendezvous (rank 0 makes an ncclUniqueId and broadcasts
it, operators/distributed_ops/gen_nccl_id_op.cc) is
``torch.distributed.init_process_group`` here: one process a rank, the
backend following the place (NCCL for the card, gloo for the CPU).
"""

import os

import torch.distributed as dist


def get_world_info():
    """Rank and world size from the launcher's environment (the variables
    the reference's launcher sets, python/paddle/distributed/launch.py:
    24-53, or torch's ``RANK``/``WORLD_SIZE``)."""
    rank = int(os.environ.get("PADDLE_TRAINER_ID", os.environ.get("RANK", 0)))
    world = int(os.environ.get(
        "PADDLE_TRAINERS_NUM", os.environ.get("WORLD_SIZE", 1)))
    endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
    ends = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return {
        "rank": rank,
        "world_size": world,
        "endpoint": endpoint,
        "endpoints": [e for e in ends.split(",") if e],
    }


def backend_for(device_type):
    """The process group backend of a device type: NCCL for ``cuda``,
    gloo for ``cpu``."""
    return "nccl" if device_type == "cuda" else "gloo"


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device_type="cuda", backend=None,
                     init_method=None):
    """Join this process to the world's process group (the counterpart of
    the reference's distributed runtime initialization). A no-op for one
    process with no ``init_method``, and when the group already exists;
    returns the world info with the rank and size in use.

    ``coordinator_address`` (``host:port``; default the first of
    ``PADDLE_TRAINER_ENDPOINTS``, else ``127.0.0.1:12355``) becomes a
    ``tcp://`` rendezvous; ``init_method`` (a ``file://`` or ``tcp://``
    URL) replaces it. ``backend`` defaults to ``backend_for(device_type)``.
    """
    info = get_world_info()
    if dist.is_initialized():
        return {**info, "world_size": dist.get_world_size(),
                "rank": dist.get_rank()}
    num_processes = num_processes or info["world_size"]
    process_id = process_id if process_id is not None else info["rank"]
    if num_processes <= 1 and init_method is None:
        return info
    if init_method is None:
        if coordinator_address is None:
            eps = info["endpoints"]
            coordinator_address = eps[0] if eps else "127.0.0.1:12355"
        init_method = "tcp://" + coordinator_address
    dist.init_process_group(backend or backend_for(device_type),
                            init_method=init_method,
                            world_size=num_processes, rank=process_id)
    _retag_telemetry_sink(process_id)
    return {**info, "world_size": num_processes, "rank": process_id}


def init_single_process(device_type="cuda", backend=None):
    """A one-rank process group held in memory (no rendezvous, no
    network), so that a 1-rank mesh runs the same code as a larger one.
    A no-op when a group exists."""
    if not dist.is_initialized():
        dist.init_process_group(backend or backend_for(device_type),
                                store=dist.HashStore(), rank=0,
                                world_size=1)


def _retag_telemetry_sink(rank):
    """Re-attach this worker's streaming telemetry sink under its
    host-tagged path once the true rank is known: a worker launched
    without ``PADDLE_TRAINER_ID`` would otherwise stream to the shared
    untagged path. No-op when no sink is configured."""
    from paddle_tpu_torch import flags, observability

    if not flags.get_flag("metrics_sink"):
        return
    try:
        observability.attach_sink(host=rank)
    except Exception:
        pass
