"""Block -> eager op-by-op execution.

Port of ``paddle_tpu/engine/lowering.py`` (``BlockProgram`` :40,
``clean_attrs`` :36, ``lower_block`` :152, ``run_op`` :248,
``_bind_outputs`` :300, ``_lower_grad_op`` :308). Where the JAX package
traces the block into one XLA executable, the port runs each op's torch
lowering eagerly on the executor's device, in the block's order, after the
same dead-code elimination.

A ``*_grad`` op with a lowering of its own (``mul_grad``,
``fused_attention_grad``...) runs it; any other is derived generically as
``torch.func.vjp`` of the forward op's lowering, as the reference derives
it with its own vjp. That re-runs the forward op inside its grad op on
every step (the reference's compiler shares the two; an eager engine
cannot).

``lower_block(..., amp=True)`` runs the ops under ``amp_scope``
(lowering.py:222). ``BlockProgram`` lists the block's RNG slots, one per
RNG stream id of an op that draws a dropout seed under its attrs
(``OpInfo.seed_range``: not a test op, a nonzero rate); a grad op finds its
forward's slot by the same id, so it re-derives the same mask. It also
says whether a CUDA graph may hold the block: every op's lowering is
capturable (``OpInfo.capturable``), decided from the desc alone.

An op that runs a sub-block (``while``, ``conditional_block``,
``recurrent``: ``ops/controlflow_ops.py``) runs its ops through
``run_sub_block``, the counterpart of ``_run_sub_block``
(``paddle_tpu/ops/controlflow_ops.py:71``): op by op into an env, each
with RNG stream id ``10_000 + i`` as in the JAX package. Such an op has
one slot in the seed table when an op of its sub-block (nested ones
included) draws a seed; the seed of sub-block op ``i`` at step ``t`` is
that slot's seed folded with ``i`` and ``t`` on the device
(``fold_seed``), so a CUDA graph holds it, and a generic grad of the op
(``recurrent_grad``) re-draws the forward's masks. The block is
capturable when every op of it and of its sub-blocks is. A tensor array
(``{"buf", "len"}``) lives only inside one run, like a sparse grad: a
fetch or state write of one raises.

Op-level provenance (``observability/opprof.py``): each lowering
collects ``tag -> OpDesc`` into its ``prov`` dict when it is built, with
the reference's tags (``provenance_tag(type, block.idx, i)``; the
accumulated lowering numbers its once ops from 100_000, as the
reference does), and ``run_op`` enters ``record_function(tag)`` around
the op only while a profiler session tags (``opprof.tagging()``): one
bool check an op otherwise. Sub-block ops carry no tag of their own;
their work is their parent op's, as the reference's outermost scope is.

A sparse grad (``core/selected_rows.py``) lives only inside one run of a
block: each lowering densifies whatever leaves it, a fetch or a state
write-back (lowering.py:230-237), like the reference's GetFetchVariable
materializing a SelectedRows; under accumulation the micro-batches'
sparse grads concatenate their rows, scaled by 1/k (``_mean_stacked``,
:654).
"""

import torch

from paddle_tpu_torch import ops as _ops  # noqa: F401  (registers lowerings)
from paddle_tpu_torch.core.registry import (
    OpRegistry, LowerContext, amp_scope, draw_seed,
)
from paddle_tpu_torch.core.selected_rows import SelectedRows, densify
from paddle_tpu_torch.observability import opprof as _opprof
from paddle_tpu_torch.ops.common import M32, hash_mix_bits, seed32

# Ops that are pure host-side markers and skipped during execution.
_SKIP_OPS = frozenset({"feed", "fetch"})

# Attrs that are engine-internal plumbing, stripped before calling lowerings.
_INTERNAL_ATTR_PREFIX = "__"

# Positional placeholder for absent gradient inputs (see backward.py).
EMPTY_VAR_NAME = "@EMPTY@"

# RNG stream id of sub-block op i: SUB_BLOCK_RNG_BASE + i (the JAX
# package's, controlflow_ops.py:80)
SUB_BLOCK_RNG_BASE = 10_000
# the range of the seed an op running a sub-block draws, and of the seeds
# folded from it: below every op's own seed range (dropout 2**32, the
# flash kernels 2**31 - 1)
SUB_BLOCK_SEED_HIGH = 2 ** 32
FOLDED_SEED_MOD = 2 ** 31 - 1
# provenance index of the accumulated lowering's once ops: 100_000 + their
# position (the reference's, lowering.py:703)
ONCE_TAG_BASE = 100_000


def clean_attrs(attrs):
    return {k: v for k, v in attrs.items() if not k.startswith(_INTERNAL_ATTR_PREFIX)}


class BlockProgram:
    """Analyzed form of one block: which vars are inputs (feeds + state read),
    which are outputs (fetches + state written)."""

    def __init__(self, block, feed_names, fetch_names, extra_live_vars=()):
        self.block = block
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)

        all_ops = [op for op in block.ops if op.type not in _SKIP_OPS]

        # Dead-code elimination over the block's dataflow (reference:
        # framework/prune.cc): an op is live iff it feeds a fetch target,
        # writes a persistable var, or has no outputs at all.
        def _is_persistable(name):
            vd = block.find_var_recursive(name)
            return vd is not None and vd.persistable

        # extra_live_vars: liveness-only roots; the remat lowering keeps
        # the loss-computing ops alive with them even when no op of the
        # explicit grad chain reads the loss
        live_vars = set(self.fetch_names) | set(extra_live_vars)
        live_flags = [False] * len(all_ops)
        for i in range(len(all_ops) - 1, -1, -1):
            op = all_ops[i]
            outs = [n for n in op.output_arg_names() if n != EMPTY_VAR_NAME]
            live = (
                not outs
                or any(n in live_vars for n in outs)
                or any(_is_persistable(n) for n in outs)
            )
            if live:
                live_flags[i] = True
                for n in op.input_arg_names():
                    if n != EMPTY_VAR_NAME:
                        live_vars.add(n)
        self.ops = [op for i, op in enumerate(all_ops) if live_flags[i]]

        feed_set = set(self.feed_names)
        written = set()
        state_in = []  # vars read before written, provided by scope
        state_in_set = set()
        for op in self.ops:
            for name in op.input_arg_names():
                if (
                    name != EMPTY_VAR_NAME
                    and name not in written
                    and name not in feed_set
                    and name not in state_in_set
                ):
                    state_in.append(name)
                    state_in_set.add(name)
            for name in op.output_arg_names():
                written.add(name)

        # A fetch of a var no live op writes (e.g. a parameter) is served
        # from the scope like other state.
        for name in self.fetch_names:
            if (
                name not in written
                and name not in feed_set
                and name not in state_in_set
            ):
                state_in.append(name)
                state_in_set.add(name)

        # Outputs: every persistable var written.
        state_out = []
        seen = set()
        for op in self.ops:
            for name in op.output_arg_names():
                if name in seen:
                    continue
                vd = block.find_var_recursive(name)
                if vd is not None and vd.persistable:
                    state_out.append(name)
                    seen.add(name)

        self.state_in_names = state_in
        self.state_out_names = state_out

        # the seed table's slots, (rng id, seed range), and the ops a CUDA
        # graph cannot hold, sub-blocks' included; an unregistered op
        # raises when it runs
        highs = {}
        self.uncapturable_ops = []
        for op_index, op in enumerate(self.ops):
            self.uncapturable_ops += _uncapturable(op, block)
            high = _seed_high(op, block)
            if high is None:
                continue
            rng_id = _rng_id(op, 0 if _is_generic_grad(op) else op_index)
            if highs.setdefault(rng_id, high) != high:
                raise ValueError(
                    "ops of RNG stream %d draw seeds in ranges %d and %d"
                    % (rng_id, highs[rng_id], high))
        self.rng_slots = list(highs.items())
        self.capturable = not self.uncapturable_ops

    def seed_values(self, seed, run_counter, micro=None):
        """The run's seed table: each slot's seed as its ops' RNG stream
        draws it (``draw_seed``), in micro-batch ``micro`` of an
        accumulated step."""
        return [draw_seed(seed, run_counter, rng_id, high, micro)
                for rng_id, high in self.rng_slots]


def _is_generic_grad(op):
    return op.type.endswith("_grad") and not OpRegistry.has(op.type)


def _op_info(op):
    """The registry entry that lowers ``op`` (the forward's for a generic
    grad op), or None when the op is not ported."""
    fwd = op.type[: -len("_grad")] if _is_generic_grad(op) else op.type
    return OpRegistry._ops.get(fwd)


def _sub_block(op, block):
    """The block ``op`` runs (its ``sub_block`` attr), or None."""
    if "sub_block" not in op.attrs:
        return None
    return block.program.block(int(op.attrs["sub_block"]))


def _seed_high(op, block):
    """The range of the seed ``op`` draws from the run's seed table, or
    None when it draws none. An op that runs a sub-block draws one where
    any op of the sub-block does."""
    info = _op_info(op)
    if info is None:
        return None
    sub = _sub_block(op, block)
    if sub is not None:
        draws = any(_seed_high(o, sub) is not None for o in sub.ops)
        return SUB_BLOCK_SEED_HIGH if draws else None
    if info.needs_rng and info.seed_range:
        return info.seed_range(op.attrs)
    return None


def _uncapturable(op, block):
    """The types of the ops a CUDA graph cannot hold among ``op`` and the
    ops of its sub-blocks."""
    info = _op_info(op)
    if info is None:
        return []
    capturable = (info.capturable(op) if callable(info.capturable)
                  else info.capturable)
    out = [] if capturable else [op.type]
    sub = _sub_block(op, block)
    if sub is not None:
        for o in sub.ops:
            out += _uncapturable(o, sub)
    return out


def fold_seed(base, rng_id, step):
    """The seed of sub-block op ``rng_id`` at step ``step`` of a run whose
    sub-block seed is ``base`` (a 0-d int64 tensor): two rounds of the
    dropout hash's mixer on the device, in [0, FOLDED_SEED_MOD)."""
    h = hash_mix_bits(seed32(base) ^ ((int(rng_id) * 0x9E3779B9) & M32))
    h = hash_mix_bits(h ^ (((int(step) + 1) * 0x85EBCA6B) & M32))
    return h % FOLDED_SEED_MOD


class SubBlockSeeds:
    """The seeds of the ops of a sub-block that ``ctx``'s op runs:
    ``at(step)`` is the seed table of one step, indexed by a sub-block
    op's RNG stream id as ``LowerContext.seed`` indexes the run's table.
    The base seed is the running op's own (``ctx.seed``), read on first
    use, so an op whose sub-block draws nothing (or runs as a test) reads
    no slot."""

    def __init__(self, ctx):
        self._ctx = ctx
        self._base = None

    def base(self):
        if self._base is None:
            base = self._ctx.seed(SUB_BLOCK_SEED_HIGH)
            if not isinstance(base, torch.Tensor):
                base = torch.tensor(base, dtype=torch.int64,
                                    device=self._ctx.device)
            self._base = base
        return self._base

    def at(self, step):
        return _StepSeeds(self, step)


class _StepSeeds:
    def __init__(self, seeds, step):
        self._seeds = seeds
        self._step = step

    def __getitem__(self, rng_id):
        return fold_seed(self._seeds.base(), rng_id, self._step)


def run_sub_block(ctx, sub_block, env, seeds=None, step=0):
    """Run every op of ``sub_block`` into ``env`` (name -> value), the
    counterpart of ``_run_sub_block`` (``controlflow_ops.py:71``): on
    ``ctx``'s device, test flag and RNG pair, op ``i`` with RNG stream id
    ``SUB_BLOCK_RNG_BASE + i`` and its seed from ``seeds`` (a
    ``SubBlockSeeds`` of the running op) at ``step``."""
    seeds = SubBlockSeeds(ctx) if seeds is None else seeds
    table = seeds.at(step)
    for i, op in enumerate(sub_block.ops):
        if op.type in _SKIP_OPS:
            continue
        run_op(op, sub_block, env, ctx.device, ctx._rng_seed,
               SUB_BLOCK_RNG_BASE + i, ctx.is_test, ctx.executor, table)
    return env


def _tags(block, indexed_ops, prov):
    """The provenance tags of ``indexed_ops`` ([(index, op)]), recorded
    into ``prov`` (a dict, or None: tags only)."""
    idx = getattr(block, "idx", 0)
    tags = [_opprof.provenance_tag(op.type, idx, i)
            for i, op in indexed_ops]
    if prov is not None:
        prov.update(zip(tags, (op for _, op in indexed_ops)))
    return tags


def lower_block(block_program, device, is_test=False, executor=None,
                amp=False, mesh_plan=None, prov=None):
    """Returns fn(feeds: list, state_in: list, rng_seed, seeds=None) ->
    (fetches: list, state_out: list), running the block's live ops
    eagerly on ``device``, under ``amp_scope(amp)``. ``rng_seed`` is the
    (seed, run_counter) pair; ``seeds`` maps each RNG slot's id to its
    entry of the run's seed table (0-d int64 tensors on ``device``).

    With a ``mesh_plan`` (``parallel/plan.py``, a block run over a mesh)
    its run hooks see every op: before it (a ZeRO-1 parameter's shard, a
    bucket flushed before its reader) and after it (each gradient reduced
    to its placement where the backward writes it, the counterpart of
    the reference's ``grad_shardings`` constraints, lowering.py:153).
    ``prov`` (a dict) receives the ops' provenance tags."""
    block = block_program.block
    tags = _tags(block, list(enumerate(block_program.ops)), prov)

    def fn(feed_values, state_values, rng_seed, seeds=None):
        env = dict(zip(block_program.feed_names, feed_values))
        env.update(zip(block_program.state_in_names, state_values))
        hooks = mesh_plan.hooks() if mesh_plan is not None else None
        with amp_scope(amp):
            for op_index, op in enumerate(block_program.ops):
                if hooks is None:
                    run_op(op, block, env, device, rng_seed, op_index,
                           is_test, executor, seeds, tags[op_index])
                    continue
                hooks.before(op, env)
                with hooks.op_scope():
                    run_op(op, block, env, device, rng_seed, op_index,
                           is_test, executor, seeds, tags[op_index])
                hooks.after(op, env)
            if hooks is not None:
                hooks.finish(env)
        return _block_outputs(block_program, env)

    return fn


def _block_outputs(block_program, env):
    """(fetches, state outputs) of a run's env, sparse grads densified."""
    return ([leave_run(n, env[n]) for n in block_program.fetch_names],
            [leave_run(n, env[n]) for n in block_program.state_out_names])


def leave_run(name, value):
    """A value as it leaves a run (a fetch, a state write): a sparse grad
    densified; a tensor array refused, since only its ops read one."""
    if isinstance(value, dict):
        raise TypeError(
            "var %r is a tensor array; a fetch or a state write takes a "
            "tensor: read an element with array_read (read_from_array) "
            "or its length with array_length" % name)
    return densify(value)


def _mean_micro(vals, k):
    """The average of one grad over ``k`` micro-batches; sparse grads
    concatenate their rows, each value scaled by 1/k."""
    if isinstance(vals[0], SelectedRows):
        return SelectedRows(torch.cat([s.rows for s in vals]),
                            torch.cat([s.values / k for s in vals]),
                            vals[0].height)
    return torch.stack(vals).mean(0)


def run_op(op, block, env, device, rng_seed, op_index, is_test,
           executor=None, seeds=None, tag=None):
    """Execute one op desc into env; inside ``record_function(tag)``
    while a profiler session tags (``opprof.tagging()``)."""
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n == EMPTY_VAR_NAME:
                vals.append(None)
            elif n in env:
                vals.append(env[n])
            else:
                raise KeyError(
                    "Op %s input %s[%d] references uninitialized variable "
                    "%r (reference semantics: PADDLE_ENFORCE input var "
                    "holder)" % (op.type, slot, len(vals), n)
                )
        ins[slot] = vals
    def lower(ins):
        if op.type.endswith("_grad") and not OpRegistry.has(op.type):
            return _lower_grad_op(op, block, ins, device, rng_seed, is_test,
                                  seeds)
        info = OpRegistry.get(op.type)
        ctx = LowerContext(op, block, device, rng_seed=rng_seed,
                           op_index=_rng_id(op, op_index), is_test=is_test,
                           executor=executor, seeds=seeds)
        return info.lower(ctx, ins, clean_attrs(op.attrs))

    if tag is not None and _opprof.tagging():
        with torch.profiler.record_function(tag):
            outs = _lower_op(op, ins, lower)
    else:
        outs = _lower_op(op, ins, lower)
    _bind_outputs(op, outs, env)


def _lower_op(op, ins, lower):
    if _current_mesh_run() is None:
        return lower(ins)
    return _lower_over_mesh(op, ins, lower)


# Ops whose rows are independent of each other (they normalize over their
# trailing dims): over a mesh each rank runs them on its own rows as they
# are, which is exact, instead of through torch's sharding propagation
# (which has no rule for some of their torch ops, as ``var_mean``).
ROW_LOCAL_OPS = frozenset({"layer_norm"})


def _current_mesh_run():
    from paddle_tpu_torch.parallel.mesh import current_spmd

    return current_spmd()


def _lower_over_mesh(op, ins, lower):
    """An op of a block run over a mesh (DTensor values). A row-local op
    whose inputs split only their rows runs on each rank's rows; any
    other runs through torch's sharding propagation, and where that has
    no rule for one of its torch ops, on the whole (gathered) inputs on
    every rank, as XLA's partitioner replicates an op it cannot
    partition: exact, at the cost of the gather and the repeated work,
    counted in ``engine.mesh_op_replicated`` with the op in the event."""
    from torch.distributed.tensor import DTensor

    from paddle_tpu_torch import observability as obs

    base = op.type[: -len("_grad")] if op.type.endswith("_grad") else op.type
    if base in ROW_LOCAL_OPS:
        out = _lower_rows_local(op, ins, lower)
        if out is not None:
            return out
    try:
        return lower(ins)
    except NotImplementedError as e:
        if "sharding strategy" not in str(e):
            raise
        mesh = next((v.device_mesh for vs in ins.values() for v in vs
                     if isinstance(v, DTensor)), None)
        if mesh is None:
            raise
        obs.inc("engine.mesh_op_replicated")
        obs.event("engine.mesh_op_replicated", op=op.type,
                  reason=str(e).splitlines()[0][:200])
        whole = {s: [v.full_tensor() if isinstance(v, DTensor) else v
                     for v in vs] for s, vs in ins.items()}
        outs = lower(whole)
        return {s: [_replicated(v, mesh) for v in vs]
                for s, vs in outs.items()}


def _placed(v, mesh, places):
    from paddle_tpu_torch.parallel.plan import place

    return place(v, mesh, places)[0]


def _replicated(v, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(v, torch.Tensor) or isinstance(v, DTensor):
        return v
    return DTensor.from_local(v, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def _lower_rows_local(op, ins, lower):
    """``lower`` on each rank's local rows, when every DTensor input is
    either laid out as the op's ``X`` (its rows split over some mesh
    axes, nothing else split) or replicated; None otherwise. Forward
    outputs take the rows' placements; the grad of a replicated input is
    a partial sum over the axes that split the rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from paddle_tpu_torch.parallel.plan import from_shard

    first = (ins.get("X") or [None])[0]
    if not isinstance(first, DTensor):
        return None
    mesh, rows = first.device_mesh, tuple(first.placements)
    if any(not isinstance(p, (Shard, Replicate))
           or (isinstance(p, Shard) and p.dim != 0) for p in rows):
        return None
    replicated = (Replicate(),) * mesh.ndim
    kind, local = {}, {}
    for s, vs in ins.items():
        local[s] = []
        for v in vs:
            if isinstance(v, DTensor):
                if v.device_mesh != mesh:
                    return None
                # a tensor of the rows' length takes their placements, any
                # other is replicated (a partial sum is reduced here)
                is_rows = v.ndim >= 1 and v.shape[:1] == first.shape[:1]
                kind[id(v)] = "rows" if is_rows else "replicated"
                v = _placed(v, mesh, rows if is_rows else replicated)
                v = v.to_local()
            local[s].append(v)
    outs = lower(local)
    grad_of = {}
    for s, vs in ins.items():
        for i, v in enumerate(vs):
            grad_of[(s + "@GRAD", i)] = kind.get(id(v), "replicated")
    partial = tuple(Partial() if isinstance(p, Shard) else Replicate()
                    for p in rows)

    def wrap(slot, i, t):
        if not isinstance(t, torch.Tensor):
            return t
        which = grad_of.get((slot, i), "rows")
        return from_shard(t.contiguous(), mesh,
                          rows if which == "rows" else partial)

    return {s: [wrap(s, i, t) for i, t in enumerate(ts)]
            for s, ts in outs.items()}


def _rng_id(op, op_index):
    # Stable per-op RNG stream id so a *_grad op re-derives the same mask
    # the forward op used.
    return int(op.attrs.get("__rng_id__", op_index))


def _bind_outputs(op, outs, env):
    for slot, names in op.outputs.items():
        vals = outs.get(slot, [])
        for i, name in enumerate(names):
            if i < len(vals) and vals[i] is not None:
                env[name] = vals[i]


def _lower_grad_op(op, block, ins, device, rng_seed, is_test, seeds=None):
    """Generic gradient lowering: ``torch.func.vjp`` of the forward
    lowering, with the forward op's RNG stream (``__rng_id__``) and seed,
    so a dropout grad re-draws the forward's mask. Only floating-point inputs
    are primals (vjp refuses integer ones); integer and absent inputs are
    closed over and get a None grad, as float0 does in the reference. An
    absent output cotangent (``@EMPTY@``, or no grad slot) is zeros."""
    info = OpRegistry.get(op.type[: -len("_grad")])
    fwd_input_slots = op.attrs.get("__fwd_inputs__")
    fwd_output_slots = op.attrs.get("__fwd_outputs__")
    if fwd_input_slots is None or fwd_output_slots is None:
        raise RuntimeError(
            "grad op %s missing forward slot metadata" % op.type)
    attrs = clean_attrs(op.attrs)
    fwd_ins = {s: list(ins.get(s, [])) for s in fwd_input_slots}
    diff = [(s, i) for s in fwd_input_slots
            for i, v in enumerate(fwd_ins[s])
            if isinstance(v, torch.Tensor) and v.is_floating_point()]
    outs = {s + "@GRAD": [None] * len(fwd_ins[s]) for s in fwd_input_slots}
    if not diff:
        return outs
    out_keys = []  # (slot, index) of each floating-point output, in order

    def forward(*primals):
        fin = {s: list(vs) for s, vs in fwd_ins.items()}
        for (s, i), p in zip(diff, primals):
            fin[s][i] = p
        ctx = LowerContext(op, block, device, rng_seed=rng_seed,
                           op_index=_rng_id(op, 0), is_test=is_test,
                           seeds=seeds)
        out = info.lower(ctx, fin, attrs)
        vals = []
        for s in fwd_output_slots:
            for i, v in enumerate(out.get(s, [])):
                if isinstance(v, torch.Tensor) and v.is_floating_point():
                    out_keys.append((s, i))
                    vals.append(v)
        return tuple(vals)

    primals, vjp_fn = torch.func.vjp(
        forward, *[fwd_ins[s][i] for s, i in diff])
    cotangents = []
    for (s, i), p in zip(out_keys, primals):
        grads = ins.get(s + "@GRAD", [])
        g = grads[i] if i < len(grads) else None
        cotangents.append(torch.zeros_like(p) if g is None
                          else g.to(p.dtype).reshape(p.shape))
    in_grads = vjp_fn(tuple(cotangents))
    for (s, i), g in zip(diff, in_grads):
        outs[s + "@GRAD"][i] = g
    return outs


def lower_block_accumulated(block_program, k, device, is_test=False,
                            executor=None, amp=False, prov=None):
    """Gradient-accumulation lowering (reference: ``lower_block_accumulated``,
    lowering.py:592, the reference's batch-merge capability,
    framework/ir/multi_batch_merge_pass.cc): the forward/backward ops run
    in a Python loop over ``k`` micro-batches (each feed split [k, B/k,
    ...] along its batch dim), where the JAX package runs a ``lax.scan``;
    the grads that cross into the Optimize/LRSched ops are averaged, and
    those ops run once, on the averages.

    Persistable state the loop both reads and writes (batch norm's running
    statistics) carries from one micro-batch to the next, like ``k`` real
    steps; a persistable var the loop writes but never reads takes the
    last micro-batch's value. A fetch written in the loop is concatenated
    back to [k*b, ...] when its leading dim is the micro-batch size, and
    averaged otherwise (the loss, metrics), exactly as the reference
    does (:690-706). Mean-reduced losses make ``k`` micro-batches equal to
    one k*B batch, global-norm clipping included (it sees the averages).

    Returns fn(feeds, state_in, rng_seed, seeds) like ``lower_block``;
    ``seeds`` is a list of k + 1 seed dicts: micro-batch t's, then the
    step's own for the ops that run once. The provenance tags number the
    loop's ops by their place in the loop and the once ops from
    ``ONCE_TAG_BASE``, as the reference's scan does; ``prov`` (a dict)
    receives them."""
    from paddle_tpu_torch.framework import OpRole

    block = block_program.block
    feed_names = block_program.feed_names
    state_in_names = block_program.state_in_names

    once_roles = OpRole.Optimize | OpRole.RPC | OpRole.LRSched
    loop_ops, once_ops = [], []
    for i, op in enumerate(block_program.ops):
        role = int(op.attrs.get("op_role", 0))
        (once_ops if role & once_roles else loop_ops).append((i, op))
    loop_tags = _tags(block, [(j, op) for j, (_, op) in enumerate(loop_ops)],
                      prov)
    once_tags = _tags(block, [(ONCE_TAG_BASE + j, op)
                              for j, (_, op) in enumerate(once_ops)], prov)

    def _is_persistable(name):
        vd = block.find_var_recursive(name)
        return vd is not None and vd.persistable

    written_loop = []
    for _, op in loop_ops:
        for n in op.output_arg_names():
            if n != EMPTY_VAR_NAME and n not in written_loop:
                written_loop.append(n)
    written_loop_set = set(written_loop)
    read_once = set()
    for _, op in once_ops:
        read_once.update(
            n for n in op.input_arg_names() if n != EMPTY_VAR_NAME)

    state_in_set = set(state_in_names)
    # carried: persistable vars the loop reads and writes (running stats)
    carry_names = [n for n in written_loop
                   if _is_persistable(n) and n in state_in_set]
    # last value: persistable writes never read
    last_names = [n for n in written_loop
                  if _is_persistable(n) and n not in state_in_set]
    # averaged: what the once-ops read from the loop (the grads)
    cross_names = sorted(
        (read_once & written_loop_set) - set(carry_names) - set(last_names))
    fetch_loop = [n for n in block_program.fetch_names
                  if n in written_loop_set]

    def fn(feed_values, state_values, rng_seed, seeds=None):
        base = dict(zip(state_in_names, state_values))
        micro_feeds = []
        for name, v in zip(feed_names, feed_values):
            if v.shape[0] % k != 0:
                raise ValueError(
                    "accumulate_steps=%d does not divide feed %r batch "
                    "dim %d" % (k, name, v.shape[0]))
            micro_feeds.append(
                v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:])))
        carry = [base[n] for n in carry_names]
        cross = [[] for _ in cross_names]
        fetched = [[] for _ in fetch_loop]
        env = base
        for t in range(k):
            env = dict(base)
            env.update(zip(carry_names, carry))
            env.update(zip(feed_names, (f[t] for f in micro_feeds)))
            with amp_scope(amp):
                for (i, op), tag in zip(loop_ops, loop_tags):
                    run_op(op, block, env, device, rng_seed, i, is_test,
                           executor, None if seeds is None else seeds[t],
                           tag)
            carry = [env[n] for n in carry_names]
            for acc, n in zip(cross, cross_names):
                acc.append(env[n])
            for acc, n in zip(fetched, fetch_loop):
                acc.append(leave_run(n, env[n]))
        last = {n: env[n] for n in last_names}

        env = dict(base)
        env.update(zip(carry_names, carry))
        env.update(last)
        for n, vals in zip(cross_names, cross):
            env[n] = _mean_micro(vals, k)
        with amp_scope(amp):
            for (i, op), tag in zip(once_ops, once_tags):
                run_op(op, block, env, device, rng_seed, i, is_test,
                       executor, None if seeds is None else seeds[k], tag)

        micro_b = micro_feeds[0].shape[1] if micro_feeds else None
        fetch_map = dict(zip(fetch_loop, fetched))
        fetches = []
        for n in block_program.fetch_names:
            if n not in fetch_map:
                fetches.append(leave_run(n, env[n]))
                continue
            s = torch.stack(fetch_map[n])
            # per-example fetches (leading dim == the micro-batch size)
            # concatenate back to [k*b, ...]; the rest (loss, metrics)
            # average: the k*B batch's equivalents
            if micro_b is not None and s.ndim >= 2 and s.shape[1] == micro_b:
                fetches.append(s.reshape((-1,) + tuple(s.shape[2:])))
            else:
                fetches.append((s if s.is_floating_point()
                                else s.float()).mean(0))
        state_out = [leave_run(n, env[n])
                     for n in block_program.state_out_names]
        return fetches, state_out

    return fn


def remat_live_vars(block):
    """The losses of a training block, from its ``__is_loss_grad__`` seed
    ops: the liveness roots that keep the loss-computing ops alive under
    remat, which differentiates the loss value the explicit chain never
    reads (reference: engine/executor.py:936-945)."""
    return tuple(
        n[: -len("@GRAD")]
        for op in block.ops
        if op.attrs.get("__is_loss_grad__")
        for n in op.output_arg_names() if n.endswith("@GRAD"))


def lower_block_remat(block_program, n_segments, device, is_test=False,
                      executor=None, amp=False, prov=None):
    """Rematerialized training step (reference: ``lower_block_remat``,
    lowering.py:366): the forward ops run as ``s`` contiguous segments,
    each under ``torch.utils.checkpoint(use_reentrant=False)``, and the
    parameter grads come from ``torch.autograd.grad`` of the losses that
    the ``__is_loss_grad__`` seed ops name, instead of the program's
    explicit ``*_grad`` ops. Only the segments' boundary values live from
    forward to backward; what lies inside a segment is recomputed in the
    backward. The Optimize-role tail then runs unchanged on the bound
    ``p@GRAD`` vars.

    Every forward lowering is differentiable by torch autograd, and each
    registered grad lowering is the analytic derivative of its forward,
    so the grads are the explicit chain's up to float rounding (the
    parity tests hold them). The flash kernels differentiate through
    ``flash_attention_lse``'s autograd function (the backward kernels),
    the embedding through ``lookup_table_grad``'s deterministic scatter.
    The dropout masks are pure functions of the run's seed table, so a
    recomputed segment draws the forward's masks; RNG state is not saved
    (``preserve_rng_state=False``), which also keeps the step capturable.

    Refused (``NotImplementedError``, with the reference's messages): a
    program with no Backward-role op, one with no ``@GRAD`` seed op,
    backward ops writing persistable vars, an optimizer or fetch reading
    a backward var that is not a gradient, and a gradient of an
    intermediate (not feed, not state) var.

    ``prov`` (a dict) receives the provenance tags of the forward and
    tail ops (the reference's, by their index in the block); the
    backward, which autograd derives, launches under no tag."""
    from torch.utils.checkpoint import checkpoint

    from paddle_tpu_torch.framework import OpRole

    block = block_program.block
    feed_names = block_program.feed_names
    state_in_names = block_program.state_in_names

    tail_roles = OpRole.Optimize | OpRole.RPC | OpRole.Dist | OpRole.LRSched
    fwd_ops, bwd_ops, tail_ops = [], [], []
    for i, op in enumerate(block_program.ops):
        role = int(op.attrs.get("op_role", 0))
        if role & OpRole.Backward:
            bwd_ops.append((i, op))
        elif role & tail_roles:
            tail_ops.append((i, op))
        else:
            fwd_ops.append((i, op))
    if not bwd_ops:
        raise NotImplementedError(
            "remat lowering requires a training program (no Backward-role "
            "ops found); run test/inference programs without remat")

    # the losses: append_backward marks each chain seed
    losses, bwd_real = [], []
    for i, op in bwd_ops:
        if op.attrs.get("__is_loss_grad__"):
            gname = next(n for n in op.output_arg_names()
                         if n != EMPTY_VAR_NAME)
            losses.append((gname[: -len("@GRAD")],
                           float(op.attrs.get("value", 1.0))))
        else:
            bwd_real.append((i, op))
    if not losses:
        raise NotImplementedError(
            "remat lowering found no @GRAD seed op (calc_gradient-style "
            "programs are not supported)")

    bwd_written = set()
    for _, op in bwd_real:
        bwd_written.update(
            n for n in op.output_arg_names() if n != EMPTY_VAR_NAME)
    tail_read = set()
    for _, op in tail_ops:
        tail_read.update(
            n for n in op.input_arg_names() if n != EMPTY_VAR_NAME)
    fetch_set = set(block_program.fetch_names)

    # persistable side effects inside the (skipped) backward segment have
    # no remat equivalent: refuse rather than serve stale state
    bwd_persist = sorted(set(block_program.state_out_names) & bwd_written)
    if bwd_persist:
        raise NotImplementedError(
            "remat: backward-role ops write persistable vars %s; the "
            "remat lowering replaces the explicit backward chain and "
            "cannot replay those side effects" % bwd_persist)

    needed_grads = sorted((tail_read | fetch_set) & bwd_written)
    feed_set, state_set = set(feed_names), set(state_in_names)
    diff_names = []
    for g in needed_grads:
        if not g.endswith("@GRAD"):
            raise NotImplementedError(
                "remat: optimizer/fetch consumes backward var %r that is "
                "not a gradient" % g)
        p = g[: -len("@GRAD")]
        if p not in feed_set and p not in state_set:
            raise NotImplementedError(
                "remat: gradient of intermediate var %r requested; only "
                "parameter/feed gradients survive the remat lowering" % p)
        diff_names.append(p)

    fwd_written = set()
    for _, op in fwd_ops:
        fwd_written.update(
            n for n in op.output_arg_names() if n != EMPTY_VAR_NAME)
    state_out_set = set(block_program.state_out_names)
    aux_names = sorted(
        (tail_read | fetch_set | state_out_set | {n for n, _ in losses})
        & fwd_written)

    tag_of = dict(zip((i for i, _ in fwd_ops + tail_ops),
                      _tags(block, fwd_ops + tail_ops, prov)))

    # contiguous segments; a segment's inputs are what it reads from
    # outside, its outputs what later segments or the aux set read
    nseg = max(1, min(int(n_segments), len(fwd_ops)))
    bounds = [len(fwd_ops) * s // nseg for s in range(nseg + 1)]
    segments = [fwd_ops[bounds[s]: bounds[s + 1]] for s in range(nseg)]
    seg_descs = []  # (ops, in_names, out_names)
    produced_before = feed_set | state_set
    for s, seg in enumerate(segments):
        writes, reads = [], []
        wset, rset = set(), set()
        for _, op in seg:
            for n in op.input_arg_names():
                if (n != EMPTY_VAR_NAME and n not in wset
                        and n not in rset and n in produced_before):
                    reads.append(n)
                    rset.add(n)
            for n in op.output_arg_names():
                if n != EMPTY_VAR_NAME and n not in wset:
                    writes.append(n)
                    wset.add(n)
        later_reads = set()
        for later in segments[s + 1:]:
            for _, op in later:
                later_reads.update(op.input_arg_names())
        outs = [n for n in writes if n in later_reads or n in aux_names]
        seg_descs.append((seg, reads, outs))
        produced_before |= wset

    # stop_gradient vars: a marked var passes no gradient to any of its
    # consumers (append_backward's pruning), so the barrier applies right
    # where the op binds it
    sg_names = set()
    for _, op in fwd_ops:
        for n in op.output_arg_names():
            if n == EMPTY_VAR_NAME:
                continue
            vd = block.find_var_recursive(n)
            if vd is not None and vd.stop_gradient and not vd.is_parameter:
                sg_names.add(n)

    def fn(feed_values, state_values, rng_seed, seeds=None):
        base = dict(zip(feed_names, feed_values))
        base.update(zip(state_in_names, state_values))
        diff_set = set(diff_names)
        others = {n: v for n, v in base.items() if n not in diff_set}

        def seg_callable(seg, in_names, out_names):
            def run_seg(*in_vals):
                env = dict(others)
                env.update(zip(in_names, in_vals))
                with amp_scope(amp):
                    for j, op in seg:
                        run_op(op, block, env, device, rng_seed, j,
                               is_test, executor, seeds, tag_of[j])
                        for n in op.output_arg_names():
                            v = env.get(n)
                            if (n in sg_names and isinstance(v, torch.Tensor)
                                    and v.is_floating_point()):
                                env[n] = v.detach()
                return tuple(env[n] for n in out_names)
            return run_seg

        with torch.enable_grad():
            leaves = [base[p].detach().requires_grad_(True)
                      for p in diff_names]
            env = dict(others)
            env.update(zip(diff_names, leaves))
            for seg, in_names, out_names in seg_descs:
                outs = checkpoint(seg_callable(seg, in_names, out_names),
                                  *[env[n] for n in in_names],
                                  use_reentrant=False,
                                  preserve_rng_state=False)
                env.update(zip(out_names, outs))
            total = None
            for lname, seed in losses:
                term = env[lname].float().sum() * seed
                total = term if total is None else total + term
            grads = (torch.autograd.grad(total, leaves, allow_unused=True)
                     if total.requires_grad else [None] * len(leaves))

        out = dict(base)
        out.update((n, env[n].detach()) for n in aux_names)
        for p, g in zip(diff_names, grads):
            g = torch.zeros_like(base[p]) if g is None else g
            out[p + "@GRAD"] = g.to(base[p].dtype)
        # the seed vars the fill ops would have bound (a fetch of
        # loss@GRAD serves the explicit chain's constant)
        for lname, seed in losses:
            out[lname + "@GRAD"] = torch.full_like(out[lname], seed)
        with amp_scope(amp):
            for j, op in tail_ops:
                run_op(op, block, out, device, rng_seed, j, is_test,
                       executor, seeds, tag_of[j])
        return _block_outputs(block_program, out)

    return fn
