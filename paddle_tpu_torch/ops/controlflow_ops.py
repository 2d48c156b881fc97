"""Compare/logical ops and structured control flow — port of
``paddle_tpu/ops/controlflow_ops.py``: the compare ops (:34-39), the
logical ops (:53-56), ``where`` (:59), ``while`` (:93),
``conditional_block`` (:146), ``recurrent`` (:188) and the tensor-array
ops ``create_array`` (:281), ``write_to_array`` (:288),
``read_from_array`` (:305) and ``lod_array_length`` (:312).

Where the JAX package traces a sub-block into ``lax.while_loop``,
``lax.scan`` or a branch select, the port runs it op by op through the
engine's ``run_sub_block``:

- ``while`` reads its condition on the host before every iteration, so
  a CUDA graph cannot hold it (``capturable=False``): a block holding one
  runs eagerly (``engine.eager_runs``);
- ``conditional_block`` runs its block and selects each output leaf by
  leaf with ``torch.where`` on the device, as the JAX package does, so it
  is captured like any op;
- ``recurrent`` (StaticRNN, DynamicRNN) is a Python loop over the time
  steps with the JAX lowering's time-major/batch-major handling,
  ``reverse`` and ``SeqLen`` freezing. Its grad is ``torch.func.vjp`` of
  this lowering (the engine's generic grad), which runs the loop again,
  as the JAX package's is the vjp of ``lax.scan``. On ``meta`` tensors
  (build-time shape inference) it runs one step: every step has the
  shapes of the first.

A tensor array is ``{"buf": [capacity, ...], "len": int32}``, as in the
JAX package: a fixed-capacity stacked buffer written by an indexed copy
on the device, never grown on the host. Indices are clamped into the
buffer, as ``lax.dynamic_update_index_in_dim`` clamps them.
"""

import torch

from paddle_tpu_torch.core.registry import register_op, register_no_grad_op
from paddle_tpu_torch.ops.common import single


def _cmp(fn):
    def lower(ctx, ins, attrs):
        return {"Out": [fn(single(ins, "X"), single(ins, "Y"))]}

    return lower


register_no_grad_op("equal")(_cmp(torch.eq))
register_no_grad_op("not_equal")(_cmp(torch.ne))
register_no_grad_op("less_than")(_cmp(torch.lt))
register_no_grad_op("less_equal")(_cmp(torch.le))
register_no_grad_op("greater_than")(_cmp(torch.gt))
register_no_grad_op("greater_equal")(_cmp(torch.ge))


def _logical(fn):
    def lower(ctx, ins, attrs):
        x = single(ins, "X")
        y = single(ins, "Y")
        if y is None:
            return {"Out": [fn(x)]}
        return {"Out": [fn(x, y)]}

    return lower


register_no_grad_op("logical_and")(_logical(torch.logical_and))
register_no_grad_op("logical_or")(_logical(torch.logical_or))
register_no_grad_op("logical_xor")(_logical(torch.logical_xor))
register_no_grad_op("logical_not")(_logical(torch.logical_not))


@register_op("where", no_grad_inputs=("Condition",))
def where_op(ctx, ins, attrs):
    cond = single(ins, "Condition")
    return {"Out": [torch.where(cond.bool(), single(ins, "X"),
                                single(ins, "Y"))]}


def _sub_block_of(ctx, attrs):
    return ctx.block.program.block(int(attrs["sub_block"]))


def _flag(cond):
    """A [1] (or 0-d) condition as a 0-d bool tensor."""
    return cond.reshape(()).bool()


# ---------------------------------------------------------------------------
# while (reference: controlflow/while_op.cc). Forward-only, like the JAX
# package's; training-time recurrence is the `recurrent` op.
# ---------------------------------------------------------------------------

@register_no_grad_op("while", capturable=False)
def while_op(ctx, ins, attrs):
    from paddle_tpu_torch.engine.lowering import SubBlockSeeds, run_sub_block

    sub = _sub_block_of(ctx, attrs)
    x_names = list(ctx.op.inputs.get("X", []))
    cond_name = ctx.op.inputs["Condition"][0]
    cond = single(ins, "Condition")
    out_names = list(ctx.op.outputs.get("Out", []))

    base_env = dict(zip(x_names, ins.get("X", [])))
    base_env[cond_name] = cond
    missing = [n for n in out_names if n not in base_env]
    if missing:
        raise RuntimeError(
            "while op: loop-carried vars %r have no initial value; "
            "initialize them before the loop (reference semantics: "
            "while_op.cc reads outside vars from the parent scope)" % missing
        )
    carry = [base_env[n] for n in out_names]
    meta = ctx.device.type == "meta"
    seeds = SubBlockSeeds(ctx)
    step = 0
    # the host reads the condition; shape inference runs the body once
    while (step == 0) if meta else bool(_flag(cond)):
        env = dict(base_env)
        env.update(zip(out_names, carry))
        env[cond_name] = cond
        run_sub_block(ctx, sub, env, seeds, step)
        cond = env[cond_name]
        if meta:
            _same_types("while", carry, [env[n] for n in out_names])
        else:
            carry = [env[n] for n in out_names]
        step += 1
    return {"Out": carry, "StepScopes": []}


def _same_types(op_type, before, after):
    """Shape inference of a loop: a carried value keeps its shape and
    dtype, or the op's outputs keep the shapes they have, as
    the JAX package's loops refuse a carry that changes."""
    for a, b in zip(before, after):
        if isinstance(a, torch.Tensor) and (
                a.shape != b.shape or a.dtype != b.dtype):
            raise TypeError("%s: a carried value changes from %s %s to %s %s"
                            % (op_type, tuple(a.shape), a.dtype,
                               tuple(b.shape), b.dtype))


# ---------------------------------------------------------------------------
# conditional_block: the block runs, each output is selected leaf by leaf
# (reference: controlflow/conditional_block_op.cc runs the block only when
# the condition holds)
# ---------------------------------------------------------------------------

def _select(flag, new, old):
    """``new`` where ``flag``, else ``old``: tensors, or tensor arrays
    leaf by leaf."""
    if isinstance(old, dict):
        return {k: _select(flag, new[k], old[k]) for k in old}
    return torch.where(flag, new.to(old.dtype), old)


@register_op("conditional_block")
def conditional_block(ctx, ins, attrs):
    from paddle_tpu_torch.engine.lowering import run_sub_block

    sub = _sub_block_of(ctx, attrs)
    x_names = list(ctx.op.inputs.get("Input", []))
    out_names = list(ctx.op.outputs.get("Out", []))

    env = dict(zip(x_names, ins.get("Input", [])))
    init = {}
    for n in out_names:
        if n not in env:
            raise RuntimeError(
                "conditional_block output %r must be initialized before the "
                "block (its value when the condition is false)" % n
            )
        init[n] = env[n]
    run_sub_block(ctx, sub, env)
    flag = _flag(single(ins, "Cond"))
    return {"Out": [_select(flag, env[n], init[n]) for n in out_names],
            "Scope": []}


# ---------------------------------------------------------------------------
# recurrent: a loop over the time-major axis; its grad is the vjp of the
# loop (reference: operators/recurrent_op.cc and its gradient)
# ---------------------------------------------------------------------------

def _row_mask(valid, ref):
    return valid.reshape((-1,) + (1,) * (ref.ndim - 1))


@register_op("recurrent", no_grad_inputs=("SeqLen",))
def recurrent(ctx, ins, attrs):
    from paddle_tpu_torch.engine.lowering import SubBlockSeeds, run_sub_block

    sub = _sub_block_of(ctx, attrs)
    input_vars = list(attrs.get("input_vars", []))      # sub-block x[t]
    ex_state_vars = list(attrs.get("ex_state_vars", []))  # state at t-1
    state_vars = list(attrs.get("state_vars", []))        # state at t
    output_vars = list(attrs.get("output_vars", []))      # step outputs
    param_names = list(ctx.op.inputs.get("Params", []))
    reverse = bool(attrs.get("reverse", False))
    # batch-major (DynamicRNN): inputs and outputs are [B, T, ...]; the
    # loop still runs over time
    time_major = bool(attrs.get("time_major", True))

    xs = list(ins.get("Inputs", []))
    states = list(ins.get("InitStates", []))
    base_env = dict(zip(param_names, ins.get("Params", [])))

    # ragged batches (DynamicRNN): row b's states freeze once t >= its
    # length and its outputs are zero there
    seq_len = single(ins, "SeqLen")
    if seq_len is not None:
        seq_len = seq_len.reshape(-1).to(torch.int32)

    if not time_major:
        xs = [x.movedim(1, 0) for x in xs]
    if reverse:
        if seq_len is not None:
            raise NotImplementedError(
                "recurrent: reverse with SeqLen — apply sequence_reverse "
                "(which is length-aware) to the input instead")
        xs = [x.flip(0) for x in xs]

    T = xs[0].shape[0] if xs else int(attrs.get("max_len", 1))
    meta = ctx.device.type == "meta"
    seeds = SubBlockSeeds(ctx)
    steps = []
    for t in range(1 if meta else T):
        env = dict(base_env)
        env.update(zip(input_vars, (x[t] for x in xs)))
        env.update(zip(ex_state_vars, states))
        run_sub_block(ctx, sub, env, seeds, t)
        new_states = [env[n] for n in state_vars]
        outs = [env[n] for n in output_vars]
        if meta:
            _same_types("recurrent", states, new_states)
        if seq_len is not None:
            valid = t < seq_len
            new_states = [torch.where(_row_mask(valid, new), new, old)
                          for new, old in zip(new_states, states)]
            outs = [torch.where(_row_mask(valid, o), o, torch.zeros_like(o))
                    for o in outs]
        states = new_states
        steps.append(outs)
    if meta:
        stacked = [torch.empty((T,) + tuple(o.shape), dtype=o.dtype,
                               device=o.device) for o in steps[0]]
    else:
        stacked = [torch.stack([s[k] for s in steps])
                   for k in range(len(output_vars))]
    if reverse:
        stacked = [o.flip(0) for o in stacked]
    if not time_major:
        stacked = [o.movedim(0, 1) for o in stacked]
    return {"Outputs": stacked, "FinalStates": states}


# ---------------------------------------------------------------------------
# LoDTensorArray: a fixed-capacity stacked buffer and its live length
# (reference: operators/controlflow/tensor_array_read_write_op.cc,
# framework/lod_tensor_array.h)
# ---------------------------------------------------------------------------

DEFAULT_ARRAY_CAPACITY = 256


def _index(i, capacity):
    """An array index as a [1] int64 tensor, clamped into the buffer."""
    return i.reshape(1).to(torch.int64).clamp(0, capacity - 1)


@register_no_grad_op("create_array")
def create_array_op(ctx, ins, attrs):
    # length only; the first write makes the buffer (the element shape is
    # unknown until then)
    return {"Out": [{"len": torch.zeros((), dtype=torch.int32,
                                        device=ctx.device)}]}


@register_no_grad_op("write_to_array")
def write_to_array(ctx, ins, attrs):
    x = single(ins, "X")
    i = single(ins, "I").reshape(()).to(torch.int32)
    arr = single(ins, "Array")
    cap = int(attrs.get("capacity", DEFAULT_ARRAY_CAPACITY))
    if arr is None or "buf" not in arr:
        buf = torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        length = torch.zeros((), dtype=torch.int32, device=x.device)
    else:
        buf, length = arr["buf"], arr["len"]
    buf = buf.index_copy(0, _index(i, buf.shape[0]),
                         x.to(buf.dtype).unsqueeze(0))
    return {"Out": [{"buf": buf, "len": torch.maximum(length, i + 1)}]}


@register_no_grad_op("read_from_array")
def read_from_array(ctx, ins, attrs):
    buf = single(ins, "X")["buf"]
    i = _index(single(ins, "I"), buf.shape[0])
    return {"Out": [buf.index_select(0, i).squeeze(0)]}


@register_no_grad_op("lod_array_length")
def lod_array_length(ctx, ins, attrs):
    arr = single(ins, "X")
    return {"Out": [arr["len"].reshape(1).to(torch.int64)]}
