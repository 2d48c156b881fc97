"""Def-use graph over the Program/Block/Operator IR — port of
``paddle_tpu/analysis/graph.py``, unchanged but for its imports.

The analog of the reference's ``ir::Graph`` built from a ProgramDesc
(reference: paddle/fluid/framework/ir/graph.cc:25 — one node per op, one
per var, edges for every read/write): an SSA-ish per-block view where each
``VarNode`` records its ordered writer and reader ops, plus the two
cross-block edge kinds this IR actually has — control flow (an op's
``sub_block`` attr naming the block it executes) and forward/backward
pairing (``X@GRAD`` var nodes linking back to ``X``).

Passes (see passes.py) consume only this graph; they never re-derive
dataflow from descs.
"""

from paddle_tpu_torch.core.desc import OpDesc  # noqa: F401  (public node payload)

# Positional placeholder used by append_backward for absent gradients —
# never a real variable (see engine/lowering.py EMPTY_VAR_NAME).
EMPTY_VAR_NAME = "@EMPTY@"

# Host-side marker ops with no dataflow (engine skips them too).
SKIP_OPS = frozenset({"feed", "fetch"})

GRAD_SUFFIX = "@GRAD"


class OpNode:
    """One operator occurrence: (block_idx, op_idx) plus resolved var
    nodes per slot."""

    def __init__(self, block_idx, op_idx, desc, order):
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.desc = desc
        self.order = order  # global program order (execution-ish)
        self.in_edges = []   # ordered [(slot, VarNode)]
        self.out_edges = []  # ordered [(slot, VarNode)]
        self.sub_block_idx = None  # control-flow edge, if any

    @property
    def type(self):
        return self.desc.type

    def input_vars(self):
        return [v for _, v in self.in_edges]

    def output_vars(self):
        return [v for _, v in self.out_edges]

    def role(self):
        return int(self.desc.attrs.get("op_role", 0))

    def __repr__(self):
        return "OpNode(b%d/op%d %s)" % (self.block_idx, self.op_idx,
                                        self.type)


class VarNode:
    """One variable: the VarDesc it resolves to (or None if the name is
    dangling) plus ordered writers/readers across the whole program."""

    def __init__(self, key, name, desc, def_block_idx):
        self.key = key
        self.name = name
        self.desc = desc  # VarDescData or None (undeclared name)
        self.def_block_idx = def_block_idx  # block whose var table holds it
        self.writers = []  # [OpNode] in program order
        self.readers = []  # [OpNode] in program order
        self.forward_var = None  # VarNode of X for an X@GRAD node

    @property
    def declared(self):
        return self.desc is not None

    @property
    def persistable(self):
        return self.desc is not None and self.desc.persistable

    @property
    def is_grad(self):
        return self.name.endswith(GRAD_SUFFIX)

    def __repr__(self):
        return "VarNode(%s%s)" % (self.name,
                                  "" if self.declared else ", undeclared")


class Graph:
    def __init__(self, program_desc):
        self.program_desc = program_desc
        self.op_nodes = []              # all ops, program order
        self.ops_by_block = {}          # block_idx -> [OpNode]
        self.var_nodes = {}             # key -> VarNode
        self._build()

    # -- construction ------------------------------------------------------
    def _var_key(self, block_idx, name):
        """Resolve ``name`` from ``block_idx`` through parent blocks the
        way execution does (find_var_recursive); undeclared names key to
        the referencing block."""
        b = self.program_desc.block(block_idx)
        while b is not None:
            if name in b.vars:
                return (b.idx, name)
            b = (self.program_desc.block(b.parent_idx)
                 if b.parent_idx >= 0 else None)
        return (block_idx, name)

    def _var_node(self, block_idx, name):
        key = self._var_key(block_idx, name)
        node = self.var_nodes.get(key)
        if node is None:
            bd = self.program_desc.block(key[0])
            node = VarNode(key, name, bd.vars.get(name), key[0])
            self.var_nodes[key] = node
        return node

    def _build(self):
        order = 0
        for bd in self.program_desc.blocks:
            block_ops = []
            for op_idx, op in enumerate(bd.ops):
                node = OpNode(bd.idx, op_idx, op, order)
                order += 1
                if op.type not in SKIP_OPS:
                    for slot in op.input_names():
                        for name in op.input(slot):
                            if name == EMPTY_VAR_NAME:
                                continue
                            v = self._var_node(bd.idx, name)
                            node.in_edges.append((slot, v))
                            v.readers.append(node)
                    for slot in op.output_names():
                        for name in op.output(slot):
                            if name == EMPTY_VAR_NAME:
                                continue
                            v = self._var_node(bd.idx, name)
                            node.out_edges.append((slot, v))
                            v.writers.append(node)
                sub = op.attrs.get("sub_block")
                if isinstance(sub, int) and 0 <= sub < len(
                        self.program_desc.blocks):
                    node.sub_block_idx = sub
                block_ops.append(node)
                self.op_nodes.append(node)
            self.ops_by_block[bd.idx] = block_ops

        # declared-but-never-referenced vars still get nodes so passes can
        # see the whole var table (e.g. sharding rules matching nothing)
        for bd in self.program_desc.blocks:
            for name in bd.vars:
                self._var_node(bd.idx, name)

        # grad pairing edges: X@GRAD -> X (same resolution scope)
        for node in list(self.var_nodes.values()):
            if node.is_grad:
                fwd_name = node.name[: -len(GRAD_SUFFIX)]
                fwd_key = self._var_key(node.def_block_idx, fwd_name)
                fwd = self.var_nodes.get(fwd_key)
                if fwd is None:
                    bd = self.program_desc.block(fwd_key[0])
                    if fwd_name in bd.vars:
                        fwd = self._var_node(fwd_key[0], fwd_name)
                node.forward_var = fwd

    # -- queries -----------------------------------------------------------
    def block_ops(self, block_idx):
        return self.ops_by_block.get(block_idx, [])

    def var(self, block_idx, name):
        return self.var_nodes.get(self._var_key(block_idx, name))

    def all_vars(self):
        return self.var_nodes.values()

    def writers_before(self, var_node, op_node):
        """Writers of ``var_node`` strictly before ``op_node`` in program
        order."""
        return [w for w in var_node.writers if w.order < op_node.order]


def build_graph(program_or_desc):
    """Build a Graph from a Program (framework.py) or a raw
    ProgramDescData."""
    desc = getattr(program_or_desc, "desc", program_or_desc)
    return Graph(desc)
