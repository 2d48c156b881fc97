"""Executor — the user-facing run loop (reference:
python/paddle/fluid/executor.py — Executor:262, run:451). Port of
``paddle_tpu/executor.py``: ``Executor`` (``run``, ``sync``, ``close``),
``global_scope``, ``scope_guard`` and ``EOFException``. ``Executor()``
runs on ``CUDAPlace(0)`` and raises when CUDA is missing; a caller asks
for the CPU with ``Executor(CPUPlace())``. A program marked for AMP
(``contrib.mixed_precision``) runs in bfloat16; on CUDA each (program,
feed signature, fetches, lowering) runs once eagerly and is then replayed
as a captured CUDA graph (``engine/executor.py``).
"""

import contextlib

import numpy as np
import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.engine.executor import Engine
from paddle_tpu_torch.framework import default_main_program
from paddle_tpu_torch.observability import goodput
from paddle_tpu_torch.platform import default_place

_global_scope = Scope()


class EOFException(Exception):
    """Raised by ``Executor.run`` when a program fed by a ``py_reader``
    has exhausted its epoch (reference: fluid.core.EOFException from the
    C++ reader ops); ``reader.start()`` begins the next one."""


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


def _as_feed_dict(feed):
    if feed is None:
        return {}
    if isinstance(feed, dict):
        return {
            k: v if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in feed.items()
        }
    raise TypeError("feed must be a dict of name -> ndarray")


class Executor:
    def __init__(self, place=None):
        self.place = place if place is not None else default_place()
        self.engine = Engine(self.place)

    @property
    def device(self):
        return self.engine.device

    def close(self):
        """Graceful shutdown (reference: executor.py close): the in-flight
        dispatch window is dropped unread (nothing will read its
        placeholders), and the engine's cached blocks and their CUDA
        graphs go."""
        self.engine.close()

    def sync(self):
        """Barrier for multi-step dispatch (``run(..., dispatch_steps=N)``):
        retires every in-flight step, resolving the outstanding
        ``DeferredFetch`` placeholders. Deferred ``check_nan_inf`` verdicts
        raise here, oldest step first, each naming its ORIGINAL step. A
        no-op when nothing is in flight."""
        self.engine.sync()

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, accumulate_steps=1, remat_segments=0,
            opt_level=None, dispatch_steps=None, verify=None, mesh=None,
            shard_rules=None, data_axes=("dp",)):
        """Run block 0 of ``program`` (default: the default main program)
        with ``feed`` {name: array, or a tensor on the executor's device},
        returning the ``fetch_list`` values (numpy arrays, or device
        tensors with ``return_numpy=False``).

        ``accumulate_steps=k`` runs the feed as k micro-batches with one
        optimizer update on the averaged gradients, the batch-merge
        capability (reference: framework/ir/multi_batch_merge_pass.cc; see
        engine/lowering.py ``lower_block_accumulated``). The batch must be
        divisible by k.

        ``remat_segments=s`` runs the training step with its forward
        partitioned into ``s`` ``torch.utils.checkpoint`` segments and the
        gradients taken through them: only segment-boundary activations
        survive to the backward pass, trading recompute for the activation
        memory that bounds long sequences and large batches (see
        engine/lowering.py ``lower_block_remat``). It cannot combine with
        ``accumulate_steps``.

        ``dispatch_steps=N`` (default: the ``PADDLE_GPU_DISPATCH_STEPS``
        flag) enqueues up to N steps on the card without waiting for
        their results: each run returns ``DeferredFetch`` placeholders at
        once (shape and dtype readable without waiting; any host use,
        ``np.asarray`` or ``float()``, resolves them), the only host wait
        in steady state is the retire of the OLDEST in-flight step, and
        ``Executor.sync()`` drains the window. Bit-exact with
        ``dispatch_steps=1``: the same steps run with the same run
        counters; only when their results are read changes. With
        ``check_nan_inf`` the verdict is deferred to retire time and
        names the original step.

        ``opt_level`` (default: the ``PADDLE_GPU_OPT_LEVEL`` flag, 1)
        picks the desc-level transforms applied once per cache entry
        (``analysis.optimize_program``): 0 runs the desc as given, 1
        rewrites an unfused attention composition into the fused op,
        which runs the flash kernels, 2 adds the elementwise fusion,
        constant folding and CSE, 3 the memory plan (auto-remat under
        the ``hbm_budget_frac`` budget), 4 the NHWC layout pass (also
        on at any level with ``layout=nhwc``). ``verify=True``
        (default: the ``PADDLE_GPU_VERIFY`` flag) runs the static
        verifier on the desc that runs, once per cache entry, and raises
        ``analysis.VerificationError`` on ERROR findings.

        ``mesh``/``shard_rules``/``data_axes`` run the step over a mesh of
        this process's world (``parallel.make_mesh``; one process a
        rank, NCCL on the card, gloo on the CPU): every rank feeds the
        same global batch and keeps its shard of the batch dim over
        ``data_axes``, the state is laid out by the
        ``parallel.ShardingRules`` table (replicated where no rule
        matches), each op that reduces over the batch computes the
        global batch's value, and each gradient is reduced to its
        parameter's placement; the fetches are the global values on
        every rank. Default: the ``PADDLE_GPU_MESH`` flag's mesh when
        set, else no mesh. A 1-rank mesh is bit-identical to no mesh.
        ``program`` may be a ``CompiledProgram`` (``compiler.py``).

        With no ``feed`` a program that has ``py_reader``s takes the next
        batch of each (``layers.py_reader``), and raises
        ``EOFException`` at the end of the epoch."""
        from paddle_tpu_torch.compiler import CompiledProgram

        scope = scope if scope is not None else global_scope()
        if isinstance(program, CompiledProgram):
            if remat_segments or accumulate_steps > 1:
                raise NotImplementedError(
                    "accumulate_steps and remat_segments are not supported "
                    "on the CompiledProgram (SPMD) path; pass the plain "
                    "Program")
            if dispatch_steps is not None and int(dispatch_steps) > 1:
                raise NotImplementedError(
                    "dispatch_steps>1 is not supported on the "
                    "CompiledProgram path; use the plain Program with "
                    "mesh= or PADDLE_GPU_MESH")
            try:
                return program._run(self, feed, fetch_list, scope,
                                    return_numpy, verify=verify,
                                    opt_level=opt_level)
            finally:
                goodput.step_boundary()
        if program is None:
            program = default_main_program()
        if feed is None and getattr(program, "_py_readers", None):
            feed = {}
            for rdr in program._py_readers:
                nxt = rdr.next_feed()
                if nxt is None:
                    raise EOFException(
                        "py_reader epoch exhausted; call reader.start() "
                        "for the next epoch")
                feed.update(nxt)
        fetch_names = [
            f.name if hasattr(f, "name") else str(f)
            for f in (fetch_list or [])
        ]
        if dispatch_steps is None:
            # the flag turns an existing training loop into a windowed
            # one without a code change
            dispatch_steps = int(flags.get_flag("dispatch_steps"))
        if mesh is None:
            # like the dispatch window, the flag puts every plain run
            # (startup programs included) on the mesh
            from paddle_tpu_torch.parallel.mesh import mesh_from_flag

            mesh = mesh_from_flag(self.engine.device.type)
        try:
            return self.engine.run_block(
                program.desc, 0, scope,
                feed=_as_feed_dict(feed),
                fetch_list=fetch_names,
                is_test=getattr(program, "_is_test", False),
                return_numpy=return_numpy,
                seed=getattr(program, "random_seed", 0) or 0,
                opt_level=opt_level,
                verify=verify,
                amp=getattr(program, "_amp", False),
                accumulate_steps=accumulate_steps,
                remat_segments=remat_segments,
                dispatch_steps=max(1, int(dispatch_steps)),
                mesh=mesh, shard_rules=shard_rules,
                data_axes=tuple(data_axes),
            )
        finally:
            # goodput step boundary: everything since the last seam mark
            # was forward progress; charge it as compute and refresh the
            # goodput.* and mfu.* gauges
            goodput.step_boundary()
