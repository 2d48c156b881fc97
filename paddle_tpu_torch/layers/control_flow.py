"""Structured control-flow layers — port of
``paddle_tpu/layers/control_flow.py``: ``_analyze_sub_block``,
``While``, ``StaticRNN``, ``Switch``, the tensor-array layers
(``create_array``, ``array_write``, ``array_read``, ``array_length``),
``increment``, ``DynamicRNN`` and ``IfElse``, with the JAX package's
builder API and descs (reference: python/paddle/fluid/layers/
control_flow.py). How the port runs the ops they append is in
``paddle_tpu_torch/ops/controlflow_ops.py``: ``while`` on the host,
``conditional_block`` as a select on the device, ``recurrent`` as a loop
over the time steps.
"""

import contextlib

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.layer_helper import LayerHelper


def _resolvable_in_ancestors(program, sub_block, name):
    """True if ``name`` resolves in a block strictly above ``sub_block``."""
    b = sub_block
    while b.parent_idx != -1:
        b = program.block(b.parent_idx)
        if name in b.vars:
            return True
    return False


def _analyze_sub_block(program, sub_block):
    """Ordered external reads and external writes of a sub-block.

    External = resolved from an ancestor block (parameters, loop state,
    arrays), not created locally in the sub-block.
    """
    reads, writes = [], []
    read_set, write_set = set(), set()
    written = set()
    for op in sub_block.desc.ops:
        for n in op.input_arg_names():
            if (
                n
                and n not in written
                and n not in sub_block.vars
                and n not in read_set
                and _resolvable_in_ancestors(program, sub_block, n)
            ):
                reads.append(n)
                read_set.add(n)
        for n in op.output_arg_names():
            written.add(n)
            if (
                n
                and n not in sub_block.vars
                and n not in write_set
                and _resolvable_in_ancestors(program, sub_block, n)
            ):
                writes.append(n)
                write_set.add(n)
    return reads, writes


class While:
    """``with While(cond).block():`` — loop while ``cond`` (bool [1]) is true.

    Everything written to an ancestor-block var inside the block is loop-
    carried; such vars (including ``cond``) must be initialized before the
    loop (reference: layers/control_flow.py:687).
    """

    def __init__(self, cond, is_test=False, name=None):
        if not isinstance(cond, Variable):
            raise TypeError("While cond must be a Variable")
        self.cond_var = cond
        self.helper = LayerHelper("while", name=name)

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        sub_block = program.create_block()
        try:
            yield
        finally:
            program.rollback()

        reads, writes = _analyze_sub_block(program, sub_block)
        out_names = [n for n in writes if n != self.cond_var.name]
        # every loop-carried output needs its initial value in X, plus all
        # read-only externals
        x_names = list(dict.fromkeys(reads + out_names))

        step_scopes = parent_block.create_var(
            name=unique_name.generate("while_step_scopes"))
        parent_block.append_op(
            type="while",
            inputs={"X": x_names, "Condition": [self.cond_var.name]},
            outputs={"Out": out_names + [self.cond_var.name],
                     "StepScopes": [step_scopes.name]},
            attrs={"sub_block": sub_block.desc.idx, "is_test": False},
        )


class StaticRNN:
    """Time-major recurrence builder lowered to one ``recurrent`` op, a
    loop over the time steps differentiated as a whole (reference:
    layers/control_flow.py StaticRNN:317 → operators/recurrent_op.cc).

    Inputs fed via ``step_input`` must be [T, ...] (time-major)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._inputs = []      # (parent_var, sub_var)
        self._memories = []    # (init_parent_var, mem_sub_var)
        self._mem_updates = {}  # mem sub name -> updated var name
        self._step_outputs = []  # sub-block vars
        self._outputs = []       # parent stacked vars
        self._sub_block = None
        self._parent_block = None
        self._complete = False
        self._seq_len = None

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self._parent_block = program.current_block()
        self._sub_block = program.create_block()
        try:
            yield
        finally:
            program.rollback()
            self._complete_op()

    def step_input(self, x):
        if x.shape is None or len(x.shape) < 1:
            raise ValueError("step_input must have a time-major shape [T,...]")
        if self._seq_len is None:
            self._seq_len = x.shape[0]
        sub = self.helper.main_program.current_block()
        ipt = sub.create_var(
            name=unique_name.generate("rnn_input"),
            shape=list(x.shape[1:]),
            dtype=x.dtype,
        )
        self._inputs.append((x, ipt))
        return ipt

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1, dtype="float32"):
        # the batch-dim indices parameterize which axes carry the batch in
        # init vs batch_ref (reference: layers/control_flow.py
        # StaticRNN.memory); the padded batch-major representation fixes
        # both at 0/1's defaults, so other values are rejected
        if (init_batch_dim_idx, ref_batch_dim_idx) != (0, 1):
            raise NotImplementedError(
                "StaticRNN.memory: only init_batch_dim_idx=0, "
                "ref_batch_dim_idx=1 (batch-major padded form)")
        from paddle_tpu_torch.layers import tensor as tensor_layers

        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError(
                    "memory needs either init= or (shape= and batch_ref=)")
            # build the init var in the PARENT block
            prog = self.helper.main_program
            cur = prog.current_block_idx
            prog.current_block_idx = self._parent_block.idx
            try:
                init = tensor_layers.fill_constant_batch_size_like(
                    input=batch_ref, shape=[-1] + list(shape),
                    dtype=dtype, value=init_value)
            finally:
                prog.current_block_idx = cur
        sub = self.helper.main_program.current_block()
        mem = sub.create_var(
            name=unique_name.generate("rnn_memory"),
            shape=list(init.shape) if init.shape else None,
            dtype=init.dtype,
        )
        self._memories.append((init, mem))
        return mem

    def update_memory(self, mem, var):
        self._mem_updates[mem.name] = var.name

    def step_output(self, o):
        self._step_outputs.append(o)
        out = self._parent_block.create_var(
            name=unique_name.generate("rnn_output"),
            shape=([self._seq_len] + list(o.shape)) if o.shape is not None
            else None,
            dtype=o.dtype,
        )
        self._outputs.append(out)
        return out

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete_op(self):
        if self._complete:
            return
        self._complete = True
        program = self.helper.main_program
        sub = self._sub_block
        parent = self._parent_block

        reads, _ = _analyze_sub_block(program, sub)
        input_names = {i.name for _, i in self._inputs}
        mem_names = {m.name for _, m in self._memories}
        params = [
            n for n in reads
            if n not in input_names and n not in mem_names
            and n not in {x.name for x, _ in self._inputs}
            and n not in {iv.name for iv, _ in self._memories}
        ]

        finals = [
            parent.create_var(
                name=unique_name.generate("rnn_final_state"),
                shape=list(iv.shape) if iv.shape else None, dtype=iv.dtype)
            for iv, _ in self._memories
        ]
        for m, _ in zip((m for _, m in self._memories), finals):
            if m.name not in self._mem_updates:
                raise RuntimeError(
                    "StaticRNN memory %r was never update_memory()'d" % m.name)

        parent.append_op(
            type="recurrent",
            inputs={
                "Inputs": [x.name for x, _ in self._inputs],
                "InitStates": [iv.name for iv, _ in self._memories],
                "Params": params,
            },
            outputs={
                "Outputs": [o.name for o in self._outputs],
                "FinalStates": [f.name for f in finals],
            },
            attrs={
                "sub_block": sub.desc.idx,
                "input_vars": [i.name for _, i in self._inputs],
                "ex_state_vars": [m.name for _, m in self._memories],
                "state_vars": [
                    self._mem_updates[m.name] for _, m in self._memories
                ],
                "output_vars": [o.name for o in self._step_outputs],
            },
        )

    def __call__(self):
        if len(self._outputs) == 1:
            return self._outputs[0]
        return list(self._outputs)


class Switch:
    """``with switch.case(cond):`` cascade; each case body's writes take
    effect only when its condition is the first true one (reference:
    layers/control_flow.py Switch:1108, used by LR schedulers). Written vars
    must be pre-initialized (their value when no case matches)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._prev_conds = []

    # ``with layers.Switch() as switch:`` form (reference usage in LR
    # schedulers and the contrib decoder)
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return False

    @contextlib.contextmanager
    def _guarded_block(self, cond_var):
        program = self.helper.main_program
        parent_block = program.current_block()
        sub_block = program.create_block()
        try:
            yield
        finally:
            program.rollback()
        reads, writes = _analyze_sub_block(program, sub_block)
        x_names = list(dict.fromkeys(reads + writes))
        scope_var = parent_block.create_var(
            name=unique_name.generate("cond_scope"))
        parent_block.append_op(
            type="conditional_block",
            inputs={"Cond": [cond_var.name], "Input": x_names},
            outputs={"Out": writes, "Scope": [scope_var.name]},
            attrs={"sub_block": sub_block.desc.idx},
        )

    def case(self, condition):
        from paddle_tpu_torch.layers import nn as nn_layers

        not_prev = None
        for c in self._prev_conds:
            nc = nn_layers.logical_not(c)
            not_prev = nc if not_prev is None else nn_layers.logical_and(
                not_prev, nc)
        self._prev_conds.append(condition)
        eff = condition if not_prev is None else nn_layers.logical_and(
            condition, not_prev)
        return self._guarded_block(eff)

    def default(self):
        from paddle_tpu_torch.layers import nn as nn_layers

        assert self._prev_conds, "default() requires at least one case"
        not_prev = None
        for c in self._prev_conds:
            nc = nn_layers.logical_not(c)
            not_prev = nc if not_prev is None else nn_layers.logical_and(
                not_prev, nc)
        return self._guarded_block(not_prev)


# -- tensor array + loop utility layers ------------------------------------

def create_array(dtype="float32", capacity=None):
    """LoDTensorArray-equivalent: fixed-capacity stacked buffer
    (reference: layers/control_flow.py create_array)."""
    helper = LayerHelper("create_array")
    arr = helper.block.create_var(
        name=unique_name.generate("array"), dtype=dtype)
    attrs = {}
    if capacity is not None:
        attrs["capacity"] = int(capacity)
    helper.append_op(
        type="create_array", inputs={}, outputs={"Out": [arr.name]},
        attrs=attrs)
    arr._array_capacity = capacity
    return arr


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(dtype=x.dtype)
    attrs = {}
    cap = getattr(array, "_array_capacity", None)
    if cap is not None:
        attrs["capacity"] = int(cap)
    helper.append_op(
        type="write_to_array",
        inputs={"X": [x.name], "I": [i.name], "Array": [array.name]},
        outputs={"Out": [array.name]},
        attrs=attrs,
    )
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.block.create_var(
        name=unique_name.generate("array_read"), dtype=array.dtype)
    helper.append_op(
        type="read_from_array",
        inputs={"X": [array.name], "I": [i.name]},
        outputs={"Out": [out.name]},
    )
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.block.create_var(
        name=unique_name.generate("array_len"), shape=[1], dtype="int64")
    helper.append_op(
        type="lod_array_length",
        inputs={"X": [array.name]},
        outputs={"Out": [out.name]},
    )
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.block.create_var(
            name=unique_name.generate("increment"),
            shape=list(x.shape) if x.shape else None, dtype=x.dtype)
    helper.append_op(
        type="increment",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"step": float(value)},
    )
    return out


class DynamicRNN:
    """Variable-length recurrence (reference: layers/control_flow.py
    DynamicRNN → lod_rank_table + shrink-memory machinery). As in the JAX
    package, inputs are the padded batch-major [B, T, D] + a [B] length
    tensor, and the whole RNN lowers to ONE masked ``recurrent`` op — rows
    freeze their
    state and emit zeros once t >= length, which is numerically identical
    to the reference's shrinking-batch reordering without any data-
    dependent shapes.

    Divergence from the reference API: the sequence length is passed
    explicitly to ``step_input`` (the reference reads it from the
    LoDTensor's metadata, which does not exist device-side here).
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._inputs = []
        self._memories = []
        self._mem_updates = {}
        self._step_outputs = []
        self._outputs = []
        self._sub_block = None
        self._parent_block = None
        self._max_len = None
        self._length_var = None
        self._complete = False

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        self._parent_block = program.current_block()
        self._sub_block = program.create_block()
        try:
            yield
        finally:
            program.rollback()
            self._complete_op()

    def step_input(self, x, length=None, level=0):
        """x: padded [B, T, ...]; length: [B] int lengths (required on the
        first step_input)."""
        if x.shape is None or len(x.shape) < 2:
            raise ValueError("DynamicRNN step_input needs [B, T, ...]")
        if self._max_len is None:
            self._max_len = x.shape[1]
        if length is not None:
            self._length_var = length
        if self._length_var is None:
            raise ValueError(
                "DynamicRNN needs the sequence lengths: pass length= on "
                "the first step_input (the padded-batch LoD equivalent)")
        sub = self.helper.main_program.current_block()
        ipt = sub.create_var(
            name=unique_name.generate("drnn_input"),
            shape=[x.shape[0]] + list(x.shape[2:]),
            dtype=x.dtype,
        )
        self._inputs.append((x, ipt))
        return ipt

    def static_input(self, x):
        """Per-sequence constant visible at every step (reference:
        DynamicRNN.static_input). Ancestor-block reads are captured as
        scan-invariant params automatically, so the var is used as-is."""
        return x

    def memory(self, init=None, shape=None, value=0.0, dtype="float32",
               need_reorder=False):
        from paddle_tpu_torch.layers import tensor as tensor_layers

        if init is None:
            if shape is None or not self._inputs:
                raise ValueError(
                    "memory needs init= or shape= after a step_input")
            prog = self.helper.main_program
            cur = prog.current_block_idx
            prog.current_block_idx = self._parent_block.idx
            try:
                init = tensor_layers.fill_constant_batch_size_like(
                    input=self._inputs[0][0], shape=[-1] + list(shape),
                    dtype=dtype, value=value)
            finally:
                prog.current_block_idx = cur
        sub = self.helper.main_program.current_block()
        mem = sub.create_var(
            name=unique_name.generate("drnn_memory"),
            shape=list(init.shape) if init.shape else None,
            dtype=init.dtype,
        )
        self._memories.append((init, mem))
        return mem

    def update_memory(self, ex_mem, new_mem):
        self._mem_updates[ex_mem.name] = new_mem.name

    def output(self, *outputs):
        for o in outputs:
            self._step_outputs.append(o)
            out = self._parent_block.create_var(
                name=unique_name.generate("drnn_output"),
                shape=([o.shape[0], self._max_len] + list(o.shape[1:]))
                if o.shape is not None else None,
                dtype=o.dtype,
            )
            self._outputs.append(out)

    def _complete_op(self):
        if self._complete:
            return
        self._complete = True
        program = self.helper.main_program
        sub = self._sub_block
        parent = self._parent_block

        reads, _ = _analyze_sub_block(program, sub)
        input_names = {i.name for _, i in self._inputs}
        mem_names = {m.name for _, m in self._memories}
        params = [
            n for n in reads
            if n not in input_names and n not in mem_names
            and n not in {x.name for x, _ in self._inputs}
            and n not in {iv.name for iv, _ in self._memories}
        ]
        finals = [
            parent.create_var(
                name=unique_name.generate("drnn_final_state"),
                shape=list(iv.shape) if iv.shape else None, dtype=iv.dtype)
            for iv, _ in self._memories
        ]
        for _, m in self._memories:
            if m.name not in self._mem_updates:
                raise RuntimeError(
                    "DynamicRNN memory %r was never update_memory()'d"
                    % m.name)
        parent.append_op(
            type="recurrent",
            inputs={
                "Inputs": [x.name for x, _ in self._inputs],
                "InitStates": [iv.name for iv, _ in self._memories],
                "Params": params,
                "SeqLen": [self._length_var.name],
            },
            outputs={
                "Outputs": [o.name for o in self._outputs],
                "FinalStates": [f.name for f in finals],
            },
            attrs={
                "sub_block": sub.desc.idx,
                "time_major": False,
                "input_vars": [i.name for _, i in self._inputs],
                "ex_state_vars": [m.name for _, m in self._memories],
                "state_vars": [
                    self._mem_updates[m.name] for _, m in self._memories
                ],
                "output_vars": [o.name for o in self._step_outputs],
            },
        )

    def __call__(self):
        if len(self._outputs) == 1:
            return self._outputs[0]
        return list(self._outputs)


class IfElse:
    """Per-row branching (reference: layers/control_flow.py IfElse:1490 →
    conditional_block pairs with split/merge by a [B, 1] bool mask).

    As in the JAX package, both branches run over the FULL batch and each
    output pair merges with a row-wise select (``where``) in place of the
    reference's split_lod_tensor/merge_lod_tensor, so a CUDA graph holds
    it. Identical results for
    the per-row computations IfElse exists for; a batch-global reduction
    inside a branch would see all rows (the reference sees only its
    subset) — compute such reductions outside the branch.
    """

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self._outputs = {True: [], False: []}
        self._in_branch = None

    @contextlib.contextmanager
    def true_block(self):
        self._in_branch = True
        try:
            yield
        finally:
            self._in_branch = None

    @contextlib.contextmanager
    def false_block(self):
        self._in_branch = False
        try:
            yield
        finally:
            self._in_branch = None

    def input(self, x):
        assert self._in_branch is not None, "input() only inside a block"
        return x

    def output(self, *outs):
        assert self._in_branch is not None, "output() only inside a block"
        self._outputs[self._in_branch].extend(outs)

    def __call__(self):
        t_outs, f_outs = self._outputs[True], self._outputs[False]
        if len(t_outs) != len(f_outs):
            raise ValueError(
                "IfElse branches declared different output counts: "
                "%d vs %d" % (len(t_outs), len(f_outs)))
        merged = []
        block = self.helper.block
        for tv, fv in zip(t_outs, f_outs):
            out = block.create_var(
                name=unique_name.generate("ifelse_out"),
                shape=list(tv.shape) if tv.shape else None,
                dtype=tv.dtype)
            self.helper.append_op(
                type="where",
                inputs={"Condition": [self.cond.name], "X": [tv.name],
                        "Y": [fv.name]},
                outputs={"Out": [out.name]})
            merged.append(out)
        return merged
