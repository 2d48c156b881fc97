"""CompiledProgram — SPMD data parallelism. Port of
``paddle_tpu/compiler.py``.

The reference's ParallelExecutor stack (reference:
python/paddle/fluid/compiler.py:77 with_data_parallel -> the SSA-graph
scheduler's op cloning and NCCL all-reduce handles) becomes the engine's
mesh path: the same block runs on every rank of a ``torch.distributed``
world over a ``DeviceMesh``, the batch split over the 'dp' axis and the
parameters replicated, and each gradient is reduced to its parameter's
placement (``parallel/plan.py``). No host-side scheduler, no per-grad
handles.
"""


class BuildStrategy:
    """Knob bag kept for API compatibility
    (reference: details/build_strategy.h)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = (
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        )
        self.memory_optimize = False
        self.enable_inplace = False
        self.fuse_elewise_add_act_ops = False
        self.fuse_all_reduce_ops = True
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """(reference: details/execution_strategy.h:22-34)."""

    def __init__(self):
        self.num_threads = 0
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 1


class CompiledProgram:
    def __init__(self, program):
        self._program = program
        self._is_data_parallel = False
        self._places = None
        self._loss_name = None
        self._build_strategy = None
        self._exec_strategy = None
        self._share_vars_from = None
        self._mesh = None
        self._shard_rules = None
        self._data_axes = ("dp",)

    def with_inference_optimize(self, config):
        """(reference: compiler.py with_inference_optimize) — marks the
        program for inference: its test clone runs; the inference
        passes run in the predictor (inference/predictor.py)."""
        self._program = self._program.clone(for_test=True)
        self._is_inference = True
        return self

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        self._is_data_parallel = True
        self._loss_name = loss_name
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._share_vars_from = share_vars_from
        self._places = places
        return self

    def with_spmd(self, mesh=None, mesh_axes=None, shard_rules=None,
                  data_axes=("dp",), loss_name=None, device_type="cuda"):
        """General SPMD strategy: any mesh (dp/tp/sp axes) plus
        name-pattern -> PartitionSpec rules for parameters and optimizer
        state. ``with_data_parallel`` is the special case of a 1-axis dp
        mesh with no rules. See paddle_tpu_torch.parallel (ShardingRules,
        make_mesh); ``mesh_axes`` makes the mesh on ``device_type``."""
        from paddle_tpu_torch.parallel.mesh import make_mesh
        from paddle_tpu_torch.parallel.sharding import ShardingRules

        self._is_data_parallel = True
        self._loss_name = loss_name
        if mesh is None:
            if mesh_axes is None:
                raise ValueError("with_spmd needs mesh or mesh_axes")
            mesh = make_mesh(mesh_axes, device_type=device_type)
        self._mesh = mesh
        if shard_rules is not None and not isinstance(shard_rules,
                                                      ShardingRules):
            shard_rules = ShardingRules(shard_rules)
        self._shard_rules = shard_rules
        self._data_axes = tuple(data_axes)
        return self

    # -- internals ---------------------------------------------------------
    def _get_mesh(self, device_type):
        """The mesh of the run: the one given, else a 'dp' mesh over every
        rank of the world on the executor's device type."""
        if self._mesh is None:
            from paddle_tpu_torch.parallel.mesh import get_default_mesh

            self._mesh = get_default_mesh(device_type)
        return self._mesh

    def _run(self, executor, feed, fetch_list, scope, return_numpy,
             verify=None, opt_level=None):
        from paddle_tpu_torch import observability as obs

        with obs.span("compiled_program.run",
                      spmd=bool(self._is_data_parallel)):
            return self._run_dispatch(executor, feed, fetch_list, scope,
                                      return_numpy, verify, opt_level)

    def _run_dispatch(self, executor, feed, fetch_list, scope, return_numpy,
                      verify=None, opt_level=None):
        from paddle_tpu_torch.executor import _as_feed_dict

        kwargs = {}
        if self._is_data_parallel:
            # no cache_key_extra: the engine keys on the mesh's signature,
            # the rule table's and the data axes, so equal tables share an
            # entry and different meshes never do
            kwargs = dict(mesh=self._get_mesh(executor.engine.device.type),
                          shard_rules=self._shard_rules,
                          data_axes=self._data_axes)
        return executor.engine.run_block(
            self._program.desc, 0, scope,
            feed=_as_feed_dict(feed),
            fetch_list=[f.name if hasattr(f, "name") else str(f)
                        for f in (fetch_list or [])],
            is_test=getattr(self._program, "_is_test", False),
            return_numpy=return_numpy,
            seed=getattr(self._program, "random_seed", 0) or 0,
            amp=getattr(self._program, "_amp", False),
            verify=verify,
            opt_level=opt_level,
            **kwargs)
