"""How the engine runs one block over a mesh (the reference's mesh compile,
``paddle_tpu/engine/executor.py:1096-1140`` and ``lower_block``'s
``grad_shardings``, ``paddle_tpu/engine/lowering.py:153-238``).

The reference compiles the block once under a device mesh and XLA's
partitioner inserts every collective. Here each rank runs the block on
``DTensor``s over a ``DeviceMesh``: the feeds split on their batch dim
over the data axes, the state at the placements the sharding rules give
(replicated without a rule). Torch's sharding propagation then computes
the global batch's value of every op that reduces over the batch (a loss
``mean``, batch norm's statistics, ``accuracy``) with its own collective,
as GSPMD does, and leaves each parameter's gradient a partial sum. The
plan reduces each gradient where the backward writes it, to its
parameter's placement: an all-reduce, or under ZeRO-1 a reduce-scatter
to the owner's shard, with ``grad_bucket_mb`` one
``reduce_scatter_tensor`` a bucket of gradients.

``MeshPlan`` is made once a cache entry; ``hooks()`` gives the per-run
callbacks ``lower_block`` calls around each op. The entry's first run
records every collective it issues (``MeshPlan.record``): the gradient
reductions above, the ZeRO-1 and fetch gathers, and the redistributions
torch's sharding propagation adds inside the op lowerings, each with the
bytes it carries from this rank. The engine holds the static SPMD
analysis (``analysis/spmd.py``) against that record.
"""

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.parallel.mesh import axis_sizes
from paddle_tpu_torch.parallel.sharding import (
    PartitionSpec, batch_sharding, placements, zero1_plan,
)


def local_chunk(value, mesh, places):
    """This rank's piece of a global tensor (the same value on every rank)
    laid out by ``places``: split locally, no collective. Several mesh
    axes splitting one dim split it in mesh order, as DTensor does."""
    for mdim, pl in enumerate(places):
        if isinstance(pl, Shard):
            n = mesh.mesh.shape[mdim]
            if n > 1:
                value = value.chunk(n, dim=pl.dim)[
                    mesh.get_local_rank(mdim)]
    return value


def from_shard(local, mesh, places, shape=None):
    """This rank's shard ``local`` (contiguous) as a DTensor at
    ``places``, no collective: the global shape is ``shape``, or the
    local one with each split dim times its axis' size (equal shards),
    and the global stride the contiguous one."""
    if shape is None:
        shape = list(local.shape)
        for mdim, pl in enumerate(places):
            if isinstance(pl, Shard):
                shape[pl.dim] *= int(mesh.mesh.shape[mdim])
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return DTensor.from_local(local, mesh, tuple(places), run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def place(value, mesh, places):
    """A value as a DTensor on ``mesh`` with ``places``: a plain tensor
    (the same global value on every rank) is split locally; a DTensor on
    the mesh is redistributed. Returns (DTensor, whether a DTensor moved).
    """
    if isinstance(value, DTensor):
        if value.device_mesh == mesh:
            src = tuple(value.placements)
            if src == tuple(places):
                return value, False
            if all(mesh.mesh.shape[i] == 1 for i in range(len(src))
                   if src[i] != places[i]):
                # over an axis of one rank every placement holds the
                # same local tensor: no collective
                return DTensor.from_local(
                    value.to_local(), mesh, places, run_check=False,
                    shape=value.shape, stride=value.stride()), True
            return value.redistribute(mesh, places), True
        value = value.full_tensor()
        moved = True
    else:
        moved = False
    return from_shard(local_chunk(value, mesh, places).contiguous(), mesh,
                      places, value.shape), moved


def gather(value):
    """A fetch's global value on every rank: a DTensor's full tensor, a
    plain value as it is."""
    if isinstance(value, DTensor):
        mesh = value.device_mesh
        if all(mesh.mesh.shape[i] == 1 or isinstance(p, Replicate)
               for i, p in enumerate(value.placements)):
            return value.to_local()  # no collective over one rank
        return value.full_tensor()
    return value


# torch's functional collectives (what DTensor issues), by the kind of
# collective the record names them
_FUNCOL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}


def _operand_bytes(x):
    if isinstance(x, torch.Tensor):
        return 1, x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        ts = [t for t in x if isinstance(t, torch.Tensor)]
        return len(ts), sum(t.numel() * t.element_size() for t in ts)
    return 1, 0


class _CollectiveLog(TorchDispatchMode):
    """Appends to ``log`` each functional collective issued under it, with
    its operand's bytes on this rank (a DTensor op runs first, so the
    collectives it desugars into are seen on plain tensors)."""

    def __init__(self, log, source, var=None):
        super().__init__()
        self.log, self.source, self.var = log, source, var

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kind = None
        if not isinstance(func, torch._ops.HigherOrderOperator):
            packet = func._overloadpacket
            if getattr(packet, "_qualified_op_name", "").split("::")[0] in (
                    "_c10d_functional", "c10d_functional"):
                kind = _FUNCOL_KINDS.get(packet.__name__)
        if kind is not None and args:
            n, nbytes = _operand_bytes(args[0])
            self.log.append({"kind": kind, "source": self.source,
                             "var": self.var, "nbytes": int(nbytes),
                             "n_operands": n})
        return func(*args, **(kwargs or {}))


class MeshPlan:
    """The placements of one cache entry's feeds, state and gradients over
    ``mesh``, and the ZeRO-1 plan (``zero``, training steps only)."""

    def __init__(self, block, mesh, shard_rules=None, data_axes=("dp",),
                 zero=False, grad_bucket_mb=0.0, is_test=False):
        from paddle_tpu_torch.framework import OpRole

        self.block = block
        self.mesh = mesh
        self.rules = shard_rules
        self.sizes = axis_sizes(mesh)
        self.data_axes = tuple(a for a in data_axes if a in self.sizes)
        self.zplan = None
        if zero and not is_test:
            zplan = zero1_plan(block, self.sizes, self.data_axes,
                               shard_rules)
            if zplan.param_specs:
                self.zplan = zplan
                if obs.enabled():
                    obs.event("zero1_plan", params=len(zplan.param_specs),
                              slots=len(zplan.slot_specs),
                              bucket_mb=float(grad_bucket_mb))
        # param -> placements of its update (ZeRO-1), grad -> placements
        # the backward's partial sum is reduced to
        self.update_places = {}
        self.grad_places = {}
        for op in block.ops:
            if not (int(op.attrs.get("op_role", 0)) & OpRole.Optimize):
                continue
            pnames = op.inputs.get("Param") or ()
            gnames = op.inputs.get("Grad") or ()
            if not pnames or not gnames:
                continue
            p, g = pnames[0], gnames[0]
            if self.zplan is not None and p in self.zplan.param_specs:
                self.update_places[p] = placements(
                    mesh, self.zplan.param_specs[p])
                self.grad_places[g] = placements(
                    mesh, self.zplan.grad_specs[g])
            else:
                self.grad_places[g] = self.state_placements(p)
        live = [a for a in self.data_axes if self.sizes[a] > 1]
        # buckets need one data axis to reduce-scatter over
        self.bucket_bytes = (int(float(grad_bucket_mb) * 2 ** 20)
                             if self.zplan is not None and len(live) == 1
                             else 0)
        self.bucket_dim = (list(self.sizes).index(live[0])
                           if self.bucket_bytes else None)
        # the collectives the op lowerings issue in one run (torch's
        # sharding propagation redistributing an input), counted on the
        # entry's first run: every later run repeats them
        self.unplanned = None
        # every collective of the entry's first run, in order: {kind,
        # source ('grad', 'redistribute', 'state', 'fetch'), var, nbytes
        # (the operand's bytes on this rank), n_operands}; None until
        # that run ends
        self.record = None
        self._log = None
        # state name -> the DTensor last placed for it (the engine reads
        # the scope's value again only when the scope holds another)
        self.placed = {}

    # -- placements --------------------------------------------------------
    def state_placements(self, name):
        """A state var's placements (reference: ``state_sharding``): a
        ZeRO-1 slot's extended spec, else its rule's spec (a trainable
        param that no rule matches is counted and warned once), else
        replicated; a rule of higher rank than the var replicates it."""
        if self.zplan is not None and name in self.zplan.slot_specs:
            return placements(self.mesh, self.zplan.slot_specs[name])
        if self.rules is None:
            return placements(self.mesh, PartitionSpec())
        vd = self.block.find_var_recursive(name)
        spec = self.rules.spec_for(
            name, warn_unmatched=bool(vd is not None and getattr(
                vd, "is_parameter", False)))
        ndim = (len(vd.shape) if vd is not None and vd.shape is not None
                else None)
        if not len(spec) or ndim is None or len(spec) > ndim:
            return placements(self.mesh, PartitionSpec())
        return placements(self.mesh, spec)

    def feed_placements(self, value):
        return batch_sharding(self.mesh, value, self.data_axes)

    def hooks(self):
        """The callbacks of one run (``lower_block``'s ``hooks``)."""
        return _RunHooks(self)

    # -- the first run's record --------------------------------------------
    def begin_run(self):
        """Start recording, on the entry's first run only."""
        if self.record is None:
            self._log = []

    def logged(self, source, var=None):
        """Around code that may issue collectives: records them while the
        first run records, else nothing."""
        if self._log is None:
            return contextlib.nullcontext()
        return _CollectiveLog(self._log, source, var)

    def log(self, kind, source, nbytes, n_operands=1, var=None):
        """Record a collective issued through ``torch.distributed``
        directly (no functional collective for the log to see)."""
        if self._log is not None:
            self._log.append({"kind": kind, "source": source, "var": var,
                              "nbytes": int(nbytes),
                              "n_operands": int(n_operands)})

    def end_run(self):
        """Keep the first run's record; count its redistributions."""
        if self._log is not None:
            self.record, self._log = self._log, None
            self.unplanned = sum(1 for c in self.record
                                 if c["source"] == "redistribute")


class _RunHooks:
    """Per-run state: the bucket of gradients waiting for their
    reduce-scatter."""

    def __init__(self, plan):
        self.plan = plan
        self.pending = []  # (name, partial DTensor, target placements)
        self.pending_bytes = 0

    def op_scope(self):
        """Around one op's lowering: on the entry's first run, record the
        collectives torch's sharding propagation issues in it."""
        return self.plan.logged("redistribute")

    def before(self, op, env):
        """Flush the bucket before an op that reads a gradient in it; take
        the shard of a ZeRO-1 parameter before its update op (a local
        slice of the replicated value)."""
        if self.pending:
            reads = set(op.input_arg_names())
            if any(n in reads for n, _, _ in self.pending):
                self.flush(env)
        for p in op.inputs.get("Param") or ():
            target = self.plan.update_places.get(p)
            if target is not None and p in env:
                env[p], _ = place(env[p], self.plan.mesh, target)

    def after(self, op, env):
        """Reduce each planned gradient ``op`` wrote to its placement, or
        put it in the bucket."""
        from paddle_tpu_torch.core.selected_rows import SelectedRows

        plan = self.plan
        for n in op.output_arg_names():
            target = plan.grad_places.get(n)
            val = env.get(n)
            if target is None or val is None \
                    or isinstance(val, SelectedRows):
                continue
            if plan.bucket_bytes and self._bucketable(val, target):
                if self.pending and self.pending[0][1].dtype != val.dtype:
                    self.flush(env)  # a bucket holds one dtype
                self.pending.append((n, val, target))
                self.pending_bytes += val.to_local().numel() * \
                    val.element_size()
                if self.pending_bytes >= plan.bucket_bytes:
                    self.flush(env)
                continue
            with plan.logged("grad", n):
                env[n], _ = place(val, plan.mesh, target)

    def finish(self, env):
        self.flush(env)

    def _bucketable(self, val, target):
        d = self.plan.bucket_dim
        if not isinstance(val, DTensor) or val.device_mesh != self.plan.mesh:
            return False
        src = tuple(val.placements)
        if not (isinstance(src[d], Partial) and src[d].reduce_op == "sum"
                and isinstance(target[d], Shard)):
            return False
        return all(src[i] == target[i] for i in range(len(src)) if i != d)

    def flush(self, env):
        """One ``reduce_scatter_tensor`` for the whole bucket: each rank's
        row holds its chunk of every gradient, so it receives the same
        shards as one reduce-scatter a gradient would give it."""
        if not self.pending:
            return
        plan = self.plan
        mesh, d = plan.mesh, plan.bucket_dim
        n = mesh.mesh.shape[d]
        locals_ = [v.to_local() for _, v, _ in self.pending]
        pieces = [loc.chunk(n, dim=t[d].dim)
                  for loc, (_, _, t) in zip(locals_, self.pending)]
        flat = torch.cat([torch.cat([p[r].reshape(-1) for p in pieces])
                          for r in range(n)])
        out = torch.empty(flat.numel() // n, dtype=flat.dtype,
                          device=flat.device)
        dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM,
                                   group=mesh.get_group(d))
        plan.log("reduce-scatter", "grad",
                 flat.numel() * flat.element_size(),
                 n_operands=len(self.pending),
                 var=",".join(n for n, _, _ in self.pending))
        obs.inc("engine.grad_buckets")
        start = 0
        for (name, v, target), p in zip(self.pending, pieces):
            size = p[0].numel()
            shard = out[start:start + size].reshape(p[0].shape)
            start += size
            env[name] = from_shard(shard, mesh, target, v.shape)
        self.pending = []
        self.pending_bytes = 0

