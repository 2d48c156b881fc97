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
"""

import torch

from paddle_tpu_torch import ops as _ops  # noqa: F401  (registers lowerings)
from paddle_tpu_torch.core.registry import OpRegistry, LowerContext

# Ops that are pure host-side markers and skipped during execution.
_SKIP_OPS = frozenset({"feed", "fetch"})

# Attrs that are engine-internal plumbing, stripped before calling lowerings.
_INTERNAL_ATTR_PREFIX = "__"

# Positional placeholder for absent gradient inputs (see backward.py).
EMPTY_VAR_NAME = "@EMPTY@"


def clean_attrs(attrs):
    return {k: v for k, v in attrs.items() if not k.startswith(_INTERNAL_ATTR_PREFIX)}


class BlockProgram:
    """Analyzed form of one block: which vars are inputs (feeds + state read),
    which are outputs (fetches + state written)."""

    def __init__(self, block, feed_names, fetch_names):
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

        live_vars = set(self.fetch_names)
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


def lower_block(block_program, device, is_test=False, executor=None):
    """Returns fn(feeds: list, state_in: list, rng_seed) ->
    (fetches: list, state_out: list), running the block's live ops
    eagerly on ``device``. ``rng_seed`` is the (seed, run_counter) pair."""
    block = block_program.block

    def fn(feed_values, state_values, rng_seed):
        env = dict(zip(block_program.feed_names, feed_values))
        env.update(zip(block_program.state_in_names, state_values))
        for op_index, op in enumerate(block_program.ops):
            run_op(op, block, env, device, rng_seed, op_index, is_test,
                   executor)
        fetches = [env[n] for n in block_program.fetch_names]
        state_out = [env[n] for n in block_program.state_out_names]
        return fetches, state_out

    return fn


def run_op(op, block, env, device, rng_seed, op_index, is_test,
           executor=None):
    """Execute one op desc into env."""
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
    if op.type.endswith("_grad") and not OpRegistry.has(op.type):
        outs = _lower_grad_op(op, block, ins, device, rng_seed, is_test)
    else:
        info = OpRegistry.get(op.type)
        ctx = LowerContext(op, block, device, rng_seed=rng_seed,
                           op_index=_rng_id(op, op_index), is_test=is_test,
                           executor=executor)
        outs = info.lower(ctx, ins, clean_attrs(op.attrs))
    _bind_outputs(op, outs, env)


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


def _lower_grad_op(op, block, ins, device, rng_seed, is_test):
    """Generic gradient lowering: ``torch.func.vjp`` of the forward
    lowering, with the forward op's RNG stream (``__rng_id__``), so a
    dropout grad re-draws the forward's mask. Only floating-point inputs
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
                           op_index=_rng_id(op, 0), is_test=is_test)
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
