"""Legacy ParallelExecutor facade — port of
``paddle_tpu/parallel_executor.py`` (reference:
python/paddle/fluid/parallel_executor.py:41) over the SPMD
``CompiledProgram`` path (``compiler.py``)."""

import torch

from paddle_tpu_torch.compiler import (  # noqa: F401
    BuildStrategy, CompiledProgram, ExecutionStrategy,
)
from paddle_tpu_torch.executor import Executor, global_scope
from paddle_tpu_torch.framework import default_main_program
from paddle_tpu_torch.platform import CPUPlace, CUDAPlace


def _place(use_cuda):
    """The card of this rank (ranks share the cards in turn), or the CPU
    when ``use_cuda`` is off."""
    if not use_cuda:
        return CPUPlace()
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    return CUDAPlace(rank % max(1, torch.cuda.device_count()))


class ParallelExecutor:
    """``dist_strategy`` selects the transport (default: the
    ``PADDLE_GPU_DIST_STRATEGY`` flag, else plain data parallelism):

    * ``""`` / ``"dp"`` — SPMD data parallelism over every rank of the
      world (a 1-axis dp mesh, parameters replicated).
    * ``"mesh"`` — SPMD over an explicit ``mesh`` (or the
      ``PADDLE_GPU_MESH`` flag's) with ``shard_rules`` laying out
      parameters and optimizer state.
    * anything else (``"pserver"``, ``"nccl2"``) raises ``ValueError``,
      as in the reference: those transports go through
      ``DistributeTranspiler`` (``distributed/ps.py`` for pserver).
    """

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None, build_strategy=None,
                 num_trainers=1, trainer_id=0, scope=None, dist_strategy=None,
                 mesh=None, shard_rules=None, data_axes=("dp",)):
        from paddle_tpu_torch import flags

        if dist_strategy is None:
            dist_strategy = flags.get_flag("dist_strategy")
        if dist_strategy not in ("", "dp", "mesh"):
            raise ValueError(
                "unknown dist_strategy %r; want '', 'dp', or 'mesh' "
                "(pserver/nccl2 go through DistributeTranspiler)"
                % dist_strategy)
        self._program = main_program or default_main_program()
        self._scope = scope or global_scope()
        self._executor = Executor(_place(use_cuda))
        device_type = self._executor.engine.device.type
        if dist_strategy == "mesh":
            from paddle_tpu_torch.parallel.mesh import (get_default_mesh,
                                                        mesh_from_flag)

            if mesh is None:
                mesh = (mesh_from_flag(device_type)
                        or get_default_mesh(device_type))
            self._compiled = CompiledProgram(self._program).with_spmd(
                mesh=mesh, shard_rules=shard_rules, data_axes=data_axes,
                loss_name=loss_name)
        else:
            self._compiled = CompiledProgram(self._program).with_data_parallel(
                loss_name=loss_name,
                build_strategy=build_strategy,
                exec_strategy=exec_strategy,
                share_vars_from=getattr(share_vars_from, "_compiled", None),
            )

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._compiled._run(
            self._executor, feed, fetch_list, self._scope, return_numpy
        )
