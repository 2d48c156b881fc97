"""Program/Block/Operator/Variable — the user-facing graph-building API.

Port of ``paddle_tpu/framework.py`` (reference: python/paddle/fluid/
framework.py — Variable:242, Operator:565, Block:1014, Program:1880) over
the port's descriptor model. The one backend seam is build-time shape
inference, ``infer_shapes_for_op``: where the JAX package abstractly
evaluates each op's lowering, the port runs its torch lowering on
``meta`` tensors, with the same ``_BATCH_SENTINEL`` standing in for the
-1 batch dim.
"""

import contextlib

import torch

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.core.desc import ProgramDescData
from paddle_tpu_torch.core.registry import OpRegistry, LowerContext
from paddle_tpu_torch.core.types import (
    VarType,
    convert_np_dtype_to_dtype_,
    convert_dtype_to_np,
    convert_dtype_to_torch,
)
from paddle_tpu_torch.engine.lowering import clean_attrs

# Dummy size substituted for the -1 batch dim during abstract shape
# inference; outputs carrying it are mapped back to -1.
_BATCH_SENTINEL = 1223

# The desc records computed vars in the reference's 32-bit default types
# (its lowerings run with 64-bit types off): an int64 reshape of a label
# feed is INT32 in a desc the JAX package builds. The port writes the same
# so the two front ends build identical descs; run-time tensors keep
# torch's own dtypes.
_DESC_DTYPE = {torch.int64: VarType.INT32, torch.float64: VarType.FP32}


class Variable:
    """Symbolic variable in a block (reference: framework.py:242)."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 type=VarType.LOD_TENSOR, persistable=False,
                 stop_gradient=False, lod_level=0, is_parameter=False,
                 **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        desc = block.desc.create_var(
            name,
            shape=shape,
            dtype=convert_np_dtype_to_dtype_(dtype) if dtype is not None else None,
            type=type,
            persistable=persistable,
            stop_gradient=stop_gradient,
            lod_level=lod_level,
            is_parameter=is_parameter,
        )
        self.desc = desc

    @property
    def name(self):
        return self.desc.name

    @property
    def shape(self):
        return tuple(self.desc.shape) if self.desc.shape is not None else None

    @property
    def dtype(self):
        return self.desc.dtype

    @property
    def persistable(self):
        return self.desc.persistable

    @persistable.setter
    def persistable(self, v):
        self.desc.persistable = v

    @property
    def stop_gradient(self):
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v):
        self.desc.stop_gradient = v

    @property
    def lod_level(self):
        return self.desc.lod_level

    @property
    def type(self):
        return self.desc.type

    def numpy_dtype(self):
        return convert_dtype_to_np(self.desc.dtype)

    def __repr__(self):
        return "Variable(%s, shape=%s, dtype=%s)" % (
            self.name,
            self.shape,
            getattr(self.dtype, "name", self.dtype),
        )

    __str__ = __repr__


class Parameter(Variable):
    def __init__(self, block, shape, dtype, **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        super().__init__(
            block,
            shape=shape,
            dtype=dtype,
            persistable=True,
            is_parameter=True,
            **kwargs,
        )


class Operator:
    """Wraps an OpDesc; runs shape inference on creation
    (reference: framework.py:565 Operator.__init__ calling C++ InferShape)."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        in_names = {
            slot: [v.name if isinstance(v, Variable) else v for v in _as_list(vs)]
            for slot, vs in (inputs or {}).items()
        }
        out_names = {
            slot: [v.name if isinstance(v, Variable) else v for v in _as_list(vs)]
            for slot, vs in (outputs or {}).items()
        }
        self.desc = block.desc.append_op(type, in_names, out_names, attrs or {})
        block.program._bump_version()
        if type.endswith("_grad") and OpRegistry.has(type[: -len("_grad")]):
            infer_grad_shapes(self.desc, block.desc)
        elif OpRegistry.has(type):
            infer_shapes_for_op(self.desc, block.desc)

    @property
    def type(self):
        return self.desc.type

    def attr(self, name):
        return self.desc.attrs.get(name)

    def input_names(self):
        return self.desc.input_names()

    def output_names(self):
        return self.desc.output_names()

    def input(self, slot):
        return self.desc.input(slot)

    def output(self, slot):
        return self.desc.output(slot)

    def input_arg_names(self):
        return self.desc.input_arg_names()

    def output_arg_names(self):
        return self.desc.output_arg_names()


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _abstract_value(var_desc):
    shape = [
        _BATCH_SENTINEL if d in (-1, None) else d for d in (var_desc.shape or [])
    ]
    dtype = convert_dtype_to_torch(var_desc.dtype or VarType.FP32)
    return torch.empty(shape, dtype=dtype, device="meta")


def infer_shapes_for_op(op_desc, block_desc):
    """Propagate shapes/dtypes through ``op_desc`` by running its torch
    lowering on ``meta`` tensors (no data, no kernel launch)."""
    info = OpRegistry.get(op_desc.type)
    ins = {}
    for slot, names in op_desc.inputs.items():
        vals = []
        for n in names:
            vd = block_desc.find_var_recursive(n)
            if vd is None or vd.shape is None:
                return  # can't infer
            vals.append(_abstract_value(vd))
        ins[slot] = vals

    ctx = LowerContext(op_desc, block_desc, "meta", rng_seed=(0, 0))
    outs = info.lower(ctx, ins, clean_attrs(op_desc.attrs))

    for slot, names in op_desc.outputs.items():
        vals = outs.get(slot, [])
        for i, n in enumerate(names):
            if i >= len(vals) or vals[i] is None:
                continue
            vd = block_desc.find_var_recursive(n)
            if vd is None:
                continue
            vd.shape = [(-1 if d == _BATCH_SENTINEL else int(d))
                        for d in vals[i].shape]
            vd.dtype = _DESC_DTYPE.get(
                vals[i].dtype, convert_np_dtype_to_dtype_(vals[i].dtype))


def infer_grad_shapes(op_desc, block_desc):
    """A ``*_grad`` op's ``X@GRAD`` outputs take the shape and dtype of
    the forward input ``X`` they pair with; its lowering is not run (as
    ``paddle_tpu/framework.py:305-318``)."""
    for slot, names in op_desc.outputs.items():
        if not slot.endswith("@GRAD"):
            continue
        fwd_names = op_desc.input(slot[: -len("@GRAD")])
        for gname, fname in zip(names, fwd_names):
            fv = block_desc.find_var_recursive(fname)
            gv = block_desc.find_var_recursive(gname)
            if fv is not None and gv is not None:
                gv.shape = list(fv.shape) if fv.shape is not None else None
                gv.dtype = fv.dtype


class Block:
    def __init__(self, program, idx):
        self.program = program
        self.desc = program.desc.block(idx)
        self.idx = idx
        self.vars = {}  # name -> Variable wrapper
        self.ops = []

    @property
    def parent_idx(self):
        return self.desc.parent_idx

    def var(self, name):
        v = self.vars.get(name)
        if v is not None:
            return v
        b = self
        while True:
            if name in b.vars:
                return b.vars[name]
            if b.desc.parent_idx < 0:
                break
            b = self.program.blocks[b.desc.parent_idx]
        raise ValueError("var %r not in this block" % name)

    def has_var(self, name):
        try:
            self.var(name)
            return True
        except ValueError:
            return False

    def create_var(self, name=None, **kwargs):
        v = Variable(self, name=name, **kwargs)
        self.vars[v.name] = v
        return v

    def create_parameter(self, name=None, shape=None, dtype="float32", **kwargs):
        if name is None:
            name = unique_name.generate("param")
        p = Parameter(self, shape, dtype, name=name, **kwargs)
        self.vars[name] = p
        self.program._parameters.setdefault(name, p)
        return p

    def append_op(self, type=None, inputs=None, outputs=None, attrs=None):
        attrs = dict(attrs or {})
        if OP_ROLE_KEY not in attrs:
            attrs[OP_ROLE_KEY] = self.program._current_role
        if self.program._op_role_var and OP_ROLE_VAR_KEY not in attrs:
            attrs[OP_ROLE_VAR_KEY] = list(self.program._op_role_var)
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        return op

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]


class OpRole:
    """Op role bitmask stamped on every op (reference:
    paddle/fluid/framework/op_proto_maker.h OpRole enum)."""

    Forward = 0x0000
    Backward = 0x0001
    Optimize = 0x0002
    RPC = 0x0004
    Dist = 0x0008
    LRSched = 0x0010
    Loss = 0x0100


OP_ROLE_KEY = "op_role"
OP_ROLE_VAR_KEY = "op_role_var"


class Program:
    """A whole program (reference: framework.py:1880)."""

    def __init__(self):
        self.desc = ProgramDescData()
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._parameters = {}
        self._version = 0
        self._is_test = False
        self._current_role = OpRole.Forward
        self._op_role_var = []
        self.desc._version_token = 0

    @contextlib.contextmanager
    def _op_role_guard(self, role):
        """Ops appended inside carry ``op_role`` = role (Backward ops from
        ``append_backward``, Optimize ops from the optimizers), which
        ``clone(for_test=True)`` prunes by."""
        prev = self._current_role
        self._current_role = role
        try:
            yield
        finally:
            self._current_role = prev

    @contextlib.contextmanager
    def _optimized_guard(self, param_and_grad):
        """Optimize-role ops naming the (param, grad) they update in
        ``op_role_var`` (reference: framework.py Program._optimized_guard)."""
        prev_role = self._current_role
        prev_var = self._op_role_var
        self._current_role = OpRole.Optimize
        self._op_role_var = [
            v.name if hasattr(v, "name") else v
            for v in param_and_grad if v is not None
        ]
        try:
            yield
        finally:
            self._current_role = prev_role
            self._op_role_var = prev_var

    def _bump_version(self):
        self._version += 1
        self.desc._version_token = self._version

    @staticmethod
    def parse_from_string(binary_str):
        """Rebuild a Program from serialized desc bytes (the native format;
        the reference's framework.proto importer is a later slice)."""
        return program_from_desc(ProgramDescData.parse_from_string(binary_str))

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def global_block(self):
        return self.blocks[0]

    def block(self, index):
        return self.blocks[index]

    def all_parameters(self):
        return list(self._parameters.values())

    def list_vars(self):
        for b in self.blocks:
            for v in b.vars.values():
                yield v

    def clone(self, for_test=False):
        import copy

        new = Program()
        new.desc = self.desc.clone()
        new.desc._version_token = 0
        new.blocks = [Block.__new__(Block) for _ in self.desc.blocks]
        for i, b in enumerate(new.blocks):
            b.program = new
            b.desc = new.desc.block(i)
            b.idx = i
            b.ops = []
            b.vars = {}
            old_block = self.blocks[i] if i < len(self.blocks) else None
            if old_block:
                for name, v in old_block.vars.items():
                    nv = copy.copy(v)
                    nv.block = b
                    nv.desc = b.desc.vars.get(name, v.desc)
                    b.vars[name] = nv
        new.current_block_idx = 0
        new.random_seed = self.random_seed
        new._amp = getattr(self, "_amp", False)
        new._parameters = {
            k: new.global_block().vars.get(k, v)
            for k, v in self._parameters.items()
        }
        new._bump_version()
        if for_test:
            new._is_test = True
            # Drop backward + optimize ops (reference: framework.py
            # Program.clone(for_test=True) pruning by op_role).
            for bd in new.desc.blocks:
                bd.ops = [
                    op for op in bd.ops
                    if not (
                        int(op.attrs.get(OP_ROLE_KEY, 0))
                        & (OpRole.Backward | OpRole.Optimize)
                    )
                ]
            _flip_is_test(new.desc)
        return new

    def to_string(self, throw_on_error=False, with_details=False):
        lines = []
        for b in self.desc.blocks:
            lines.append("-- block %d --" % b.idx)
            for name, v in sorted(b.vars.items()):
                lines.append("  var %s" % v)
            for op in b.ops:
                lines.append("  %s" % op)
        return "\n".join(lines)

    __str__ = to_string


def _flip_is_test(program_desc):
    for b in program_desc.blocks:
        for op in b.ops:
            if "is_test" in op.attrs or op.type in ("dropout", "batch_norm", "lrn"):
                op.attrs["is_test"] = True


def program_from_desc(desc):
    """Wrap a ProgramDescData in a fresh Program: Block/Variable wrappers
    rebuilt over the existing VarDescData objects (the desc is adopted,
    not copied)."""
    program = Program()
    program.desc = desc
    desc._version_token = 1
    program.blocks = [Block(program, i) for i in range(desc.num_blocks())]
    for b in program.blocks:
        for name, vd in b.desc.vars.items():
            v = Variable.__new__(Variable)
            v.block = b
            v.desc = vd
            b.vars[name] = v
    program._bump_version()
    return program


# -- default program singletons (reference: framework.py:2597-2665) --------
_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program):
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


class program_guard:
    def __init__(self, main_program, startup_program=None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        self.old_main = switch_main_program(self.main)
        if self.startup is not None:
            self.old_startup = switch_startup_program(self.startup)
        return self

    def __exit__(self, *args):
        switch_main_program(self.old_main)
        if self.startup is not None:
            switch_startup_program(self.old_startup)
        return False


def grad_var_name(name):
    return name + "@GRAD"


@contextlib.contextmanager
def name_scope(prefix=None):
    """Debug name scoping for operators (reference: framework.py
    name_scope — purely cosmetic grouping)."""
    yield
