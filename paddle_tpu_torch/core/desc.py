"""Program intermediate representation: Var/Op/Block/Program descriptors.

Port of ``paddle_tpu/core/desc.py``, unchanged but for its imports and
``ProgramDescData.clone``, which copies field by field where the
reference calls ``copy.deepcopy`` (the same copy, without the generic
walk's memo): plain Python objects with JSON serialization.
``serialize_to_string`` and ``parse_from_string`` stay byte-compatible
with the JAX package, so a model directory either package saves loads in
the other.
"""

import copy
import json

import numpy as np

from paddle_tpu_torch.core.types import VarType, convert_np_dtype_to_dtype_


# values a deep copy may share: immutable (VarType and the other enums
# are ints)
_IMMUTABLE = (int, float, complex, str, bytes, bool, type(None),
              np.generic)


def _copy_value(v):
    """``copy.deepcopy(v)`` for a desc's field or attr value: lists,
    tuples and dicts copied element by element, immutable values shared,
    anything else deep-copied."""
    if isinstance(v, _IMMUTABLE):
        return v
    if type(v) is list:
        return [_copy_value(x) for x in v]
    if type(v) is dict:
        return {k: _copy_value(x) for k, x in v.items()}
    if type(v) is tuple:
        return tuple(_copy_value(x) for x in v)
    return copy.deepcopy(v)


def _copy_object(obj):
    """A copy of a VarDescData or an OpDesc with every instance field
    copied by ``_copy_value``: what ``copy.deepcopy(obj)`` gives."""
    new = obj.__class__.__new__(obj.__class__)
    new.__dict__ = {k: _copy_value(v) for k, v in obj.__dict__.items()}
    return new


class VarDescData:
    """One variable's metadata inside a block."""

    def __init__(
        self,
        name,
        shape=None,
        dtype=VarType.FP32,
        type=VarType.LOD_TENSOR,
        persistable=False,
        stop_gradient=False,
        lod_level=0,
        is_parameter=False,
    ):
        self.name = name
        self.shape = list(shape) if shape is not None else None
        self.dtype = convert_np_dtype_to_dtype_(dtype) if dtype is not None else None
        self.type = type
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.lod_level = lod_level
        self.is_parameter = is_parameter
        # Arbitrary extras (initializer info, trainable, etc.)
        self.attrs = {}

    def to_dict(self):
        return {
            "name": self.name,
            "shape": self.shape,
            "dtype": int(self.dtype) if self.dtype is not None else None,
            "type": int(self.type),
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "lod_level": self.lod_level,
            "is_parameter": self.is_parameter,
            "attrs": self.attrs,
        }

    @classmethod
    def from_dict(cls, d):
        v = cls(
            d["name"],
            shape=d["shape"],
            dtype=VarType(d["dtype"]) if d["dtype"] is not None else None,
            type=VarType(d["type"]),
            persistable=d["persistable"],
            stop_gradient=d["stop_gradient"],
            lod_level=d["lod_level"],
            is_parameter=d["is_parameter"],
        )
        v.attrs = dict(d.get("attrs", {}))
        return v

    def __repr__(self):
        return "VarDesc(%s, shape=%s, dtype=%s%s)" % (
            self.name,
            self.shape,
            getattr(self.dtype, "name", self.dtype),
            ", persistable" if self.persistable else "",
        )


class OpDesc:
    """One operator: type, named input/output slots (each a list of var
    names), and an attribute dict (reference: framework.proto OpDesc:43)."""

    def __init__(self, type, inputs=None, outputs=None, attrs=None):
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def input_names(self):
        """Input slot names, in declaration order."""
        return list(self.inputs)

    def output_names(self):
        """Output slot names, in declaration order."""
        return list(self.outputs)

    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def to_dict(self):
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": _jsonable_attrs(self.attrs),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(d["type"], d["inputs"], d["outputs"], d["attrs"])

    def __repr__(self):
        return "Op(%s, in=%s, out=%s)" % (self.type, self.inputs, self.outputs)


def _jsonable_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, VarType):
            v = int(v)
        elif isinstance(v, (list, tuple)):
            v = [int(x) if isinstance(x, VarType) else x for x in v]
        out[k] = v
    return out


class BlockDescData:
    """Ordered op list + var table; blocks nest via parent_idx for control
    flow (reference: framework.proto BlockDesc:168)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}  # name -> VarDescData
        self.ops = []  # list[OpDesc]
        # forward-block index this block serves as gradient block for, if any
        self.forward_block_idx = -1

    # -- var table ---------------------------------------------------------
    def var(self, name):
        if name not in self.vars:
            raise KeyError("Variable %r not found in block %d" % (name, self.idx))
        return self.vars[name]

    def has_var(self, name):
        return name in self.vars

    def find_var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = self.program.blocks[b.parent_idx] if b.parent_idx >= 0 else None
        return None

    def create_var(self, name, **kwargs):
        if name in self.vars:
            return self.vars[name]
        v = VarDescData(name, **kwargs)
        self.vars[name] = v
        return v

    # -- op list -----------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = OpDesc(type, inputs, outputs, attrs)
        self.ops.append(op)
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = OpDesc(type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        return op

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = OpDesc(type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        return op

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": {k: v.to_dict() for k, v in self.vars.items()},
            "ops": [op.to_dict() for op in self.ops],
        }


class ProgramDescData:
    """Whole program: list of blocks, block 0 is global
    (reference: framework.proto ProgramDesc:184)."""

    def __init__(self):
        self.blocks = [BlockDescData(self, 0)]
        self.version = 1

    def block(self, idx):
        return self.blocks[idx]

    def global_block(self):
        return self.blocks[0]

    def append_block(self, parent_idx):
        b = BlockDescData(self, len(self.blocks), parent_idx)
        self.blocks.append(b)
        return b

    def num_blocks(self):
        return len(self.blocks)

    def clone(self):
        """A deep copy: every var and op of every block copied (the
        transform pipeline clones a program once per pass, at each cache
        miss, so this avoids ``copy.deepcopy``'s generic walk:
        ``_copy_value``)."""
        new = ProgramDescData.__new__(ProgramDescData)
        new.version = self.version
        new.blocks = []
        for b in self.blocks:
            nb = BlockDescData(new, b.idx, b.parent_idx)
            nb.forward_block_idx = b.forward_block_idx
            nb.vars = {k: _copy_object(v) for k, v in b.vars.items()}
            nb.ops = [_copy_object(op) for op in b.ops]
            new.blocks.append(nb)
        return new

    # -- serialization (save/load_inference_model, checkpoints) ------------
    def to_dict(self):
        return {
            "version": self.version,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    def serialize_to_string(self):
        return json.dumps(self.to_dict()).encode("utf-8")

    @classmethod
    def parse_from_string(cls, data):
        d = json.loads(data.decode("utf-8") if isinstance(data, bytes) else data)
        prog = cls.__new__(cls)
        prog.version = d["version"]
        prog.blocks = []
        for bd in d["blocks"]:
            b = BlockDescData(prog, bd["idx"], bd["parent_idx"])
            b.forward_block_idx = bd.get("forward_block_idx", -1)
            b.vars = {k: VarDescData.from_dict(v) for k, v in bd["vars"].items()}
            b.ops = [OpDesc.from_dict(od) for od in bd["ops"]]
            prog.blocks.append(b)
        return prog

    def fingerprint(self):
        """Stable content hash used as part of the executable-cache key."""
        import hashlib

        return hashlib.sha1(self.serialize_to_string()).hexdigest()

    def cached_fingerprint(self):
        """Fingerprint memoized on the framework-maintained version token —
        content-addressed so an id()-reused desc can never alias a stale
        compiled executable."""
        tok = getattr(self, "_version_token", None)
        if tok is None or getattr(self, "_fp_token", None) != tok:
            self._fp = self.fingerprint()
            self._fp_token = tok
        return self._fp
