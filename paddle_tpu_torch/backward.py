"""Program-level autodiff: ``append_backward`` and ``calc_gradient``.

Port of ``paddle_tpu/backward.py``, unchanged but for its imports, so the
two packages append the same grad ops under the same names (reference:
python/paddle/fluid/backward.py:394 append_backward — find op path :573,
per-op grad descs :252, dedup of repeated grads with ``sum`` ops :135,
no-grad pruning :204). A grad op carries its forward op's slot names
(``__fwd_inputs__``/``__fwd_outputs__``) and RNG stream id (``__rng_id__``),
so the engine derives a grad op that has no lowering of its own as
``torch.func.vjp`` of the forward lowering (``engine/lowering.py``
``_lower_grad_op``), with the forward's dropout masks.
"""

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.core.registry import OpRegistry
from paddle_tpu_torch.core.types import VarType
from paddle_tpu_torch.engine.lowering import EMPTY_VAR_NAME
from paddle_tpu_torch.framework import OpRole, grad_var_name


def _find_op_path(block, target_name, no_grad_set):
    """Indices of ops that (transitively) produce ``target_name``, pruned of
    subtrees behind stop_gradient vars (reference: backward.py:573)."""
    relevant = [False] * len(block.desc.ops)
    needed = {target_name}
    for i in range(len(block.desc.ops) - 1, -1, -1):
        op = block.desc.ops[i]
        if any(n in needed for n in op.output_arg_names()):
            relevant[i] = True
            for n in op.input_arg_names():
                if n not in no_grad_set:
                    needed.add(n)
    return [i for i, r in enumerate(relevant) if r]


def _collect_no_grad(block, extra=None):
    s = set(extra or ())
    for name, vd in block.desc.vars.items():
        if vd.stop_gradient:
            s.add(name)
    return s


def _op_is_differentiable(op):
    if not OpRegistry.has(op.type):
        return False
    return OpRegistry.get(op.type).grad_maker is not None


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Append gradient ops for ``loss``; returns [(param, grad_var)]
    (reference: backward.py:394). Every op appended is stamped Backward,
    so ``clone(for_test=True)`` prunes it."""
    block = loss.block
    program = block.program
    with program._op_role_guard(OpRole.Backward):
        return _append_backward_impl(
            loss, block, program, parameter_list, no_grad_set, callbacks
        )


def _append_backward_impl(loss, block, program, parameter_list, no_grad_set,
                          callbacks):
    no_grad = _collect_no_grad(block, no_grad_set)

    path = _find_op_path(block, loss.name, no_grad)

    # Vars whose gradient is needed: inputs/outputs of path ops not in no_grad
    grad_needed = set()
    for i in path:
        op = block.desc.ops[i]
        for n in op.input_arg_names() + op.output_arg_names():
            if n not in no_grad:
                grad_needed.add(n)

    # fill loss@GRAD = 1; a scalar loss (shape ()) keeps its scalar shape
    loss_grad_name = grad_var_name(loss.name)
    seed_shape = list(loss.shape) if loss.shape is not None else [1]
    block.create_var(
        name=loss_grad_name,
        shape=seed_shape,
        dtype=loss.dtype,
        stop_gradient=True,
    )
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_grad_name]},
        attrs={
            "shape": seed_shape,
            "dtype": int(loss.dtype),
            "value": 1.0,
            "__is_loss_grad__": True,
        },
    )

    # grad accumulation bookkeeping: var -> list of produced grad names
    contributions = {loss.name: [loss_grad_name]}

    def _materialize_grad(var_name):
        """Emit a sum op if var has multiple grad contributions; returns the
        final grad name or None (reference: _addup_repetitive_outputs_)."""
        contribs = contributions.get(var_name)
        if not contribs:
            return None
        gname = grad_var_name(var_name)
        if len(contribs) == 1:
            # the first contribution is always named gname (see
            # _new_contribution_name), so no rename is needed
            return contribs[0]
        _ensure_grad_var(var_name, gname)
        block.append_op(
            type="sum", inputs={"X": list(contribs)}, outputs={"Out": [gname]}
        )
        contributions[var_name] = [gname]
        return gname

    def _ensure_grad_var(fwd_name, gname):
        if gname in block.desc.vars:
            return
        fv = block.desc.find_var_recursive(fwd_name)
        block.create_var(
            name=gname,
            shape=list(fv.shape) if fv is not None and fv.shape is not None else None,
            dtype=fv.dtype if fv is not None else "float32",
            stop_gradient=True,
        )

    def _new_contribution_name(var_name):
        contribs = contributions.setdefault(var_name, [])
        gname = grad_var_name(var_name)
        if not contribs:
            name = gname
        else:
            name = unique_name.generate(gname + "@RENAME")
        contribs.append(name)
        _ensure_grad_var(var_name, name)
        return name

    # reverse sweep
    for i in reversed(path):
        op = block.desc.ops[i]
        if not _op_is_differentiable(op):
            continue
        info = OpRegistry.get(op.type)

        # output grads this op can receive
        out_grad_inputs = {}
        has_any = False
        for slot, names in op.outputs.items():
            gnames = []
            for n in names:
                g = _materialize_grad(n) if n in contributions else None
                gnames.append(g)
            if any(g is not None for g in gnames):
                has_any = True
            out_grad_inputs[slot] = gnames
        if not has_any:
            continue

        # which inputs need grads
        grad_outputs = {}
        wants = False
        for slot, names in op.inputs.items():
            if slot in info.no_grad_inputs:
                continue
            gnames = []
            for n in names:
                vd = block.desc.find_var_recursive(n)
                if n in no_grad or (vd is not None and vd.stop_gradient
                                    and not _is_param(block, n)):
                    gnames.append(None)
                elif vd is not None and vd.dtype is not None \
                        and _is_int_dtype(vd.dtype):
                    gnames.append(None)
                elif n in grad_needed or _is_param(block, n):
                    gnames.append(_new_contribution_name(n))
                    wants = True
                else:
                    gnames.append(None)
            if any(g is not None for g in gnames):
                grad_outputs[slot + "@GRAD"] = [
                    g if g is not None else _dummy_sink(block, n)
                    for g, n in zip(gnames, names)
                ]
        if not wants:
            continue

        grad_inputs = {}
        for slot, names in op.inputs.items():
            grad_inputs[slot] = list(names)
        # forward outputs the grad lowering consumes (saved statistics,
        # fused_attention's Out and Lse)
        for slot in info.grad_needs_outputs:
            if slot in op.output_names() and slot not in grad_inputs:
                grad_inputs[slot] = list(op.output(slot))
        for slot, gnames in out_grad_inputs.items():
            if any(g is not None for g in gnames):
                # Keep positions aligned with the forward op's output list;
                # absent grads become the engine's EMPTY placeholder so the
                # vjp cotangent for output i is never mispaired with output j.
                grad_inputs[slot + "@GRAD"] = [
                    g if g is not None else EMPTY_VAR_NAME for g in gnames
                ]

        attrs = dict(op.attrs)
        attrs["op_role"] = OpRole.Backward
        attrs["__fwd_inputs__"] = sorted(op.inputs.keys())
        attrs["__fwd_outputs__"] = sorted(op.outputs.keys())
        if "__rng_id__" not in attrs:
            attrs["__rng_id__"] = i
            op.attrs["__rng_id__"] = i

        block.append_op(
            type=op.type + "_grad",
            inputs=grad_inputs,
            outputs=grad_outputs,
            attrs=attrs,
        )

    # finalize remaining multi-contribution grads (params and leaf inputs
    # alike) — their consumers are outside the block (optimizer ops, user
    # fetches), so the sum op goes at the end of the sweep
    for var_name in list(contributions):
        _materialize_grad(var_name)

    # finalize param grads
    if parameter_list is not None:
        params = [
            block.program.global_block().var(p) if isinstance(p, str) else p
            for p in parameter_list
        ]
    else:
        params = [p for p in program.all_parameters() if p.trainable]

    params_and_grads = []
    for p in params:
        g = _materialize_grad(p.name)
        if g is None:
            continue
        gvar = block.var(g) if g in block.vars else block.create_var(
            name=g, shape=list(p.shape), dtype=p.dtype, stop_gradient=True
        )
        params_and_grads.append((p, gvar))
    return params_and_grads


def _is_param(block, name):
    vd = block.desc.find_var_recursive(name)
    return vd is not None and vd.is_parameter


def _is_int_dtype(dtype):
    return dtype in (
        VarType.INT8,
        VarType.INT16,
        VarType.INT32,
        VarType.INT64,
        VarType.UINT8,
        VarType.BOOL,
    )


def _dummy_sink(block, fwd_name):
    name = unique_name.generate(fwd_name + "@GRAD@UNUSED")
    fv = block.desc.find_var_recursive(fwd_name)
    block.create_var(
        name=name,
        shape=list(fv.shape) if fv is not None and fv.shape is not None else None,
        dtype=fv.dtype if fv is not None else "float32",
        stop_gradient=True,
    )
    return name


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of targets w.r.t. inputs (reference: backward.py:613)."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    assert len(targets) == 1, "calc_gradient currently supports one target"
    if target_gradients is not None:
        raise NotImplementedError(
            "calc_gradient with explicit target_gradients is not supported "
            "yet; gradients are seeded with ones"
        )
    append_backward(
        targets[0],
        parameter_list=None,
        no_grad_set=no_grad_set,
    )
    block = targets[0].block
    outs = []
    for iv in inputs:
        gname = grad_var_name(iv.name)
        outs.append(block.var(gname) if block.has_var(gname) else None)
    return outs
