"""Sharding rules — port of ``paddle_tpu/parallel/sharding.py``: a
name-pattern -> ``PartitionSpec`` table applied to a program's state when
a block runs over a mesh.

A ``PartitionSpec`` names, for each dim of a tensor, the mesh axes that
split it (the reference's PartitionSpec; the port keeps its own, a
tuple). ``placements`` turns a spec into the ``DTensor``
placements of one mesh: ``Shard(i)`` on every mesh axis that splits dim
``i``, ``Replicate()`` on the rest. Instead of choosing how to reduce
each gradient (the reference's multi_devices_graph_pass.cc builders),
one declares how each parameter is laid out, and the engine reduces each
gradient to its parameter's placement.
"""

import collections
import re
import warnings

from torch.distributed.tensor import Replicate, Shard


class PartitionSpec(tuple):
    """``PartitionSpec(None, 'tp')``: per tensor dim, None (not split), a
    mesh axis name, or a tuple of names (split over their product, major
    first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


P = PartitionSpec

Coverage = collections.namedtuple(
    "Coverage", ["matched", "unmatched", "rules_unused"])
Coverage.__doc__ = """Rule-table coverage of a program's trainable
parameters: ``matched`` {param: pattern}, ``unmatched`` [param],
``rules_unused`` [pattern]."""


def _entry_axes(entry):
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(str(a) for a in entry)
    return (str(entry),)


def placements(mesh, spec):
    """The DTensor placements over ``mesh`` of a tensor laid out by
    ``spec``: one per mesh axis, ``Shard(dim)`` where the axis splits a
    dim, ``Replicate()`` elsewhere."""
    out = []
    for name in mesh.mesh_dim_names:
        dim = None
        for i, entry in enumerate(tuple(spec or ())):
            if str(name) in _entry_axes(entry):
                dim = i
                break
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


class ShardingRules:
    """Ordered (regex, PartitionSpec) rules; **first match wins**.

    Rules are tried strictly in insertion order and the FIRST pattern
    whose ``re.search`` hits decides the spec; order overlapping rules
    narrow-to-broad::

        rules = ShardingRules([
            (r"layer_0\\.fc\\.w", P("tp", None)),   # row-parallel
            (r".*fc.*\\.w.*", P(None, "tp")),       # column-parallel
        ])

    Unmatched state is replicated; with ``warn_unmatched=True`` (the
    engine passes it for trainable parameters) that is counted in
    ``sharding.unmatched_param`` and warned once a name.
    """

    def __init__(self, rules=()):
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]
        self._warned = set()

    def add(self, pattern, spec):
        self._rules.append((re.compile(pattern), spec))
        return self

    def rules(self):
        """The ordered (compiled_pattern, spec) pairs."""
        return list(self._rules)

    def signature(self):
        """Hashable identity of the rule table (pattern, spec entries) in
        order, for the engine's cache key: two tables with the same
        patterns and specs share an entry."""
        return tuple(
            (pat.pattern, tuple(str(e) for e in spec))
            for pat, spec in self._rules)

    def match(self, name):
        """First-match-wins lookup: the (compiled_pattern, spec) pair that
        decides ``name``, or None when unmatched (replicated)."""
        for pat, spec in self._rules:
            if pat.search(name):
                return pat, spec
        return None

    def spec_for(self, name, ndim=None, warn_unmatched=False):
        hit = self.match(name)
        if hit is not None:
            pat, spec = hit
            if ndim is not None and len(spec) > ndim:
                raise ValueError(
                    "sharding rule %r has rank %d > var %r rank %d"
                    % (pat.pattern, len(spec), name, ndim))
            return spec
        if warn_unmatched and self._rules and name not in self._warned:
            self._warned.add(name)
            from paddle_tpu_torch import observability as obs

            obs.inc("sharding.unmatched_param")
            obs.event("sharding.unmatched_param", param=name)
            warnings.warn(
                "sharding: trainable param %r matches no rule and will "
                "be replicated on every device" % name, RuntimeWarning,
                stacklevel=2)
        return PartitionSpec()

    def coverage(self, program_or_desc):
        """Audit the rule table against a program's trainable parameters:
        which rule decides each, which fall through to replication, and
        which rules never fire. Takes a Program or a ProgramDesc."""
        desc = getattr(program_or_desc, "desc", program_or_desc)
        matched, unmatched = {}, []
        used = set()
        for bd in desc.blocks:
            for vd in bd.vars.values():
                if not getattr(vd, "is_parameter", False):
                    continue
                hit = self.match(vd.name)
                if hit is None:
                    unmatched.append(vd.name)
                else:
                    matched[vd.name] = hit[0].pattern
                    used.add(hit[0].pattern)
        rules_unused = [pat.pattern for pat, _ in self._rules
                        if pat.pattern not in used]
        return Coverage(matched, sorted(set(unmatched)), rules_unused)

    def sharding_for(self, mesh, name, value=None):
        """The placements over ``mesh`` of the var ``name``."""
        ndim = getattr(value, "ndim", None)
        return placements(mesh, self.spec_for(name, ndim))


# Grad producers whose outputs are NOT reduce-scattered under ZeRO-1:
# an embedding's grad stays replicated (all-reduced), and its param still
# joins the sharded update, which slices the full grad locally.
ZERO1_REPLICATED_GRAD_OPS = frozenset({
    "lookup_table_grad", "lookup_table_v2_grad",
})

# Param groups left off the sharded update: batch norm's scale and bias
# (about 1 % of the optimizer state) stay replicated, as in the reference.
ZERO1_EXCLUDED_GRAD_OPS = frozenset({
    "batch_norm_grad", "sync_batch_norm_grad",
})

Zero1Plan = collections.namedtuple(
    "Zero1Plan", ["param_specs", "slot_specs", "grad_specs"])
Zero1Plan.__doc__ = """ZeRO-1 weight-update sharding plan over a block's
Optimize-role ops: ``param_specs`` {param: extended spec}, the shard each
rank updates (the param itself stays at its own placement in the scope;
the update's result is all-gathered back); ``slot_specs`` {slot var:
spec}, the optimizer state that lives partitioned; ``grad_specs`` {grad
name: spec}, where each grad is reduce-scattered to its owning shard."""


def zero1_extend_spec(spec, shape, data_axes, mesh_axes):
    """The ZeRO-1 placement rule: extend a var's spec with the data axes
    on the FIRST dim that carries no axes yet and whose size the
    data-axis product divides. Returns the extended spec, or None when no
    dim qualifies (scalars, beta-pow accumulators, odd shapes: those vars
    keep the replicated path) or the data axes are already in use."""
    axes = [a for a in data_axes if int(mesh_axes.get(a, 1)) > 1]
    if not axes or shape is None:
        return None
    n_data = 1
    for a in axes:
        n_data *= int(mesh_axes[a])
    entries = list(tuple(spec))
    while len(entries) < len(shape):
        entries.append(None)
    used = set()
    for e in entries:
        used.update(_entry_axes(e))
    if any(a in used for a in axes):
        return None
    for i, d in enumerate(tuple(shape)):
        if entries[i] is None and int(d) > 0 and int(d) % n_data == 0:
            entries[i] = tuple(axes) if len(axes) > 1 else axes[0]
            return PartitionSpec(*entries)
    return None


def _base_spec(shard_rules, name, ndim):
    """The spec the engine lays a var out with: the first-match rule,
    replicated on no match or a rank mismatch."""
    if shard_rules is None:
        return PartitionSpec()
    try:
        spec = shard_rules.spec_for(name)
    except ValueError:
        return PartitionSpec()
    if ndim is not None and len(tuple(spec)) > ndim:
        return PartitionSpec()
    return spec


def zero1_plan(block, mesh_axes, data_axes=("dp",), shard_rules=None):
    """Walk a block's Optimize-role ops (one update op per parameter with
    Param/Grad inputs and slot-state side inputs) into a ``Zero1Plan``.
    ``mesh_axes`` is a {axis: size} dict. Param groups whose gradient is
    a SelectedRows var, whose grad a batch norm writes, or whose param no
    data-axis dim divides stay on the replicated path."""
    from paddle_tpu_torch.core.types import VarType
    from paddle_tpu_torch.framework import OpRole

    mesh_axes = {str(k): int(v) for k, v in dict(mesh_axes).items()}
    param_specs, slot_specs, grad_specs = {}, {}, {}
    writer_types = {}
    for op in block.ops:
        for n in op.output_arg_names():
            writer_types.setdefault(n, set()).add(op.type)
    for op in block.ops:
        if not (int(op.attrs.get("op_role", 0)) & OpRole.Optimize):
            continue
        pnames = op.inputs.get("Param") or ()
        gnames = op.inputs.get("Grad") or ()
        if not pnames or not gnames:
            continue
        pvd = block.find_var_recursive(pnames[0])
        gvd = block.find_var_recursive(gnames[0])
        if pvd is None or pvd.shape is None:
            continue
        if (gvd is not None and gvd.type is not None
                and int(gvd.type) == int(VarType.SELECTED_ROWS)):
            continue  # a sparse grad keeps the replicated path
        if writer_types.get(gnames[0], set()) & ZERO1_EXCLUDED_GRAD_OPS:
            continue  # batch-norm updates stay replicated
        shape = tuple(pvd.shape)
        zspec = zero1_extend_spec(
            _base_spec(shard_rules, pnames[0], len(shape)), shape,
            data_axes, mesh_axes)
        if zspec is None:
            continue
        param_specs[pnames[0]] = zspec
        grad_specs[gnames[0]] = (
            PartitionSpec()
            if writer_types.get(gnames[0], set()) & ZERO1_REPLICATED_GRAD_OPS
            else zspec)
        for slot, names in op.inputs.items():
            if slot in ("Param", "Grad"):
                continue
            for n in names:
                vd = block.find_var_recursive(n)
                if (vd is None or not vd.persistable
                        or getattr(vd, "is_parameter", False)
                        or vd.shape is None or n in slot_specs):
                    continue
                sspec = zero1_extend_spec(
                    _base_spec(shard_rules, n, len(vd.shape)),
                    tuple(vd.shape), data_axes, mesh_axes)
                if sspec is not None:
                    slot_specs[n] = sspec
    return Zero1Plan(param_specs, slot_specs, grad_specs)


def batch_sharding(mesh, value, data_axes=("dp",)):
    """The placements of a feed: its leading (batch) dim split over the
    data axes when their product divides it, else replicated (a ragged
    last batch runs whole on every rank, the counterpart of the
    reference's DataBalanceOpHandle)."""
    from paddle_tpu_torch.parallel.mesh import axis_sizes

    sizes = axis_sizes(mesh)
    axes = [a for a in data_axes if a in sizes]
    total = 1
    for a in axes:
        total *= sizes[a]
    shape = tuple(getattr(value, "shape", ()))
    if axes and len(shape) >= 1 and shape[0] > 0 and shape[0] % total == 0:
        return placements(mesh, PartitionSpec(
            tuple(axes) if len(axes) > 1 else axes[0]))
    return placements(mesh, PartitionSpec())
