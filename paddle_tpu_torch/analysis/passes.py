"""Analysis passes: a small registry plus the concrete checkers — port
of ``paddle_tpu/analysis/passes.py``. The checkers, their severities and
their messages are the reference's, so both packages give the same
findings on the same program; shape inference is the port's own
(``framework.infer_shapes_for_op``, on ``meta`` tensors).

The analog of the reference's pass framework (reference:
paddle/fluid/framework/ir/pass.h:40 Pass::Apply + pass_registry) over the
def-use graph in graph.py. Each pass is read-only: it inspects the graph
and returns ``Finding`` records (diagnostics.py); the registry is the
landing point for future transform passes (fusion, memory planning) that
will mutate a cloned desc instead.

Checker severities are deliberately conservative: ERROR is reserved for
programs that cannot execute correctly (dangling reads, dtype clashes the
lowering would silently promote, orphan gradients, sharding rules naming
axes the mesh does not have); everything heuristic is WARNING/INFO so an
opt-in ``PADDLE_GPU_VERIFY=1`` run never rejects a working program.
"""

from paddle_tpu_torch.analysis.diagnostics import (
    DiagnosticReport,
    Finding,
    Severity,
)
from paddle_tpu_torch.analysis.graph import (
    EMPTY_VAR_NAME,
    GRAD_SUFFIX,
    SKIP_OPS,
    build_graph,
)
from paddle_tpu_torch.core.types import VarType

# Variable kinds that never hold a dense tensor at run time — excluded
# from tensor-oriented checks (initialization, dtype, sharding).
_NON_TENSOR_TYPES = frozenset({
    VarType.READER, VarType.RAW, VarType.STEP_SCOPES,
    VarType.LOD_RANK_TABLE, VarType.PLACE_LIST, VarType.FEED_MINIBATCH,
    VarType.FETCH_LIST, VarType.TUPLE,
})

_FLOAT_TYPES = frozenset({
    VarType.FP16, VarType.FP32, VarType.FP64, VarType.BF16,
})

# Binary arithmetic ops whose X/Y operands must agree on dtype — the
# lowering would silently promote (float+int) or quietly down/up-cast
# (bf16+f32), producing an output dtype the declared IR does not carry.
_BINARY_DTYPE_OPS = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_pow", "elementwise_max",
    "elementwise_min", "elementwise_mod", "mul", "matmul",
})


class AnalysisContext:
    """Optional run-site facts the passes may use: the feed/fetch lists a
    concrete ``Executor.run`` will use, and the SPMD mesh + sharding rules
    a CompiledProgram carries."""

    def __init__(self, feed_names=None, fetch_names=None, mesh=None,
                 shard_rules=None, data_axes=("dp",)):
        self.feed_names = (None if feed_names is None
                           else frozenset(feed_names))
        self.fetch_names = (None if fetch_names is None
                            else tuple(fetch_names))
        self.mesh = mesh
        self.shard_rules = shard_rules
        self.data_axes = tuple(data_axes)


class Pass:
    """Base checker: ``check(graph, ctx) -> list[Finding]``."""

    name = "pass"
    # "checker" (read-only, returns Findings) or "transform" (mutates a
    # cloned desc — see transforms.py TransformPass).
    kind = "checker"

    def check(self, graph, ctx):
        raise NotImplementedError

    def finding(self, severity, message, op=None, var_names=(), hint=None):
        return Finding(
            severity, self.name, message,
            block_idx=op.block_idx if op is not None else None,
            op_idx=op.op_idx if op is not None else None,
            op_type=op.type if op is not None else None,
            var_names=var_names, hint=hint)


PASS_REGISTRY = {}

# Execution order of the default pipeline (dataflow checks first so later
# passes can assume a structurally sane graph).
DEFAULT_PASSES = (
    "use-before-def",
    "shape-dtype",
    "waw-hazard",
    "grad-pairing",
    "dead-op",
    "sharding",
    # The reference's pipeline goes on with its three SPMD checkers
    # (analysis/spmd.py), which find nothing without a mesh; they come
    # with the multi-GPU path (ROADMAP item 10).
)


def register_pass(name):
    def deco(cls):
        cls.name = name
        PASS_REGISTRY[name] = cls
        return cls
    return deco


def default_passes():
    return [PASS_REGISTRY[n]() for n in DEFAULT_PASSES]


def run_passes(graph, ctx=None, passes=None):
    """Run ``passes`` (default: all registered, in DEFAULT_PASSES order)
    over the graph; a crashing checker becomes a WARNING finding instead
    of taking down the run it was guarding."""
    ctx = ctx or AnalysisContext()
    report = DiagnosticReport()
    # Lazy import keeps the analysis package importable standalone;
    # per-checker wall time lands in the telemetry registry.
    from paddle_tpu_torch import observability as obs

    for p in (passes if passes is not None else default_passes()):
        try:
            with obs.time_block("analysis.%s.ms" % p.name):
                report.extend(p.check(graph, ctx))
        except Exception as e:  # pragma: no cover - checker bug guard
            report.add(Finding(
                Severity.WARNING, p.name,
                "checker crashed: %s: %s" % (type(e).__name__, e),
                hint="this is a verifier bug, not a program bug; report it"))
    return report


@register_pass("use-before-def")
class UseBeforeDefPass(Pass):
    """Every op input must be initialized when the op runs: written by an
    earlier op, persistable (scope state), or fed. A name with no VarDesc
    anywhere and no prior writer can never be bound — ERROR. A declared
    but never-written non-persistable var that is not in the (known) feed
    list will raise at run time — WARNING (the scope may be hand-seeded).
    """

    def check(self, graph, ctx):
        findings = []
        written = set()
        self._walk(graph, ctx, 0, written, findings)
        return findings

    def _walk(self, graph, ctx, block_idx, written, findings):
        top_level = block_idx == 0
        for op in graph.block_ops(block_idx):
            if op.type in SKIP_OPS:
                continue
            for slot, v in op.in_edges:
                if v.key in written:
                    continue
                if not v.declared:
                    findings.append(self.finding(
                        Severity.ERROR,
                        "input %s references %r, which has no VarDesc in "
                        "any enclosing block and no prior writer"
                        % (slot, v.name),
                        op=op, var_names=[v.name],
                        hint="declare the variable with block.create_var "
                             "(or fix the name) before this op"))
                    continue
                if v.persistable or v.desc.type in _NON_TENSOR_TYPES:
                    continue
                if (top_level and ctx.feed_names is not None
                        and v.name not in ctx.feed_names):
                    findings.append(self.finding(
                        Severity.WARNING,
                        "input %s reads %r before any op writes it; it is "
                        "not persistable and not in the feed list, so the "
                        "executor will raise unless the scope was seeded "
                        "by hand" % (slot, v.name),
                        op=op, var_names=[v.name],
                        hint="feed it, mark it persistable, or produce it "
                             "with an earlier op"))
            if op.sub_block_idx is not None:
                self._walk(graph, ctx, op.sub_block_idx, written, findings)
            for slot, v in op.out_edges:
                written.add(v.key)


@register_pass("shape-dtype")
class ShapeDtypePass(Pass):
    """Two layers of consistency: (1) binary arithmetic operands must
    agree on dtype — the lowering would silently promote and the declared
    output dtype becomes a lie; (2) re-run abstract shape inference
    (framework.infer_shapes_for_op, and infer_grad_shapes for a grad op,
    whose outputs take their forward vars' shapes as in the reference)
    on a cloned desc and diff the result
    against the declared shapes/dtypes — a mismatch means the program was
    hand-edited or deserialized with stale metadata."""

    def check(self, graph, ctx):
        findings = []
        self._check_binary_dtypes(graph, findings)
        self._recheck_inference(graph, findings)
        return findings

    def _check_binary_dtypes(self, graph, findings):
        for op in graph.op_nodes:
            if op.type not in _BINARY_DTYPE_OPS:
                continue
            slots = {}
            for slot, v in op.in_edges:
                if slot in ("X", "Y") and v.declared \
                        and v.desc.dtype is not None:
                    slots.setdefault(slot, v)
            if len(slots) < 2:
                continue
            x, y = slots["X"], slots["Y"]
            if x.desc.dtype == y.desc.dtype:
                continue
            x_f = x.desc.dtype in _FLOAT_TYPES
            y_f = y.desc.dtype in _FLOAT_TYPES
            sev = Severity.ERROR if (x_f or y_f) else Severity.WARNING
            findings.append(self.finding(
                sev,
                "operand dtype clash: X=%r is %s, Y=%r is %s"
                % (x.name, x.desc.dtype.name, y.name, y.desc.dtype.name),
                op=op, var_names=[x.name, y.name],
                hint="insert an explicit cast op; implicit promotion "
                     "changes the output dtype the program declares"))

    def _recheck_inference(self, graph, findings):
        from paddle_tpu_torch.core.registry import OpRegistry
        from paddle_tpu_torch.framework import (
            infer_grad_shapes, infer_shapes_for_op,
        )

        clone = graph.program_desc.clone()
        for bd in clone.blocks:
            orig_bd = graph.program_desc.block(bd.idx)
            for op_idx, op in enumerate(bd.ops):
                base = (op.type[: -len("_grad")]
                        if op.type.endswith("_grad") else op.type)
                if not OpRegistry.has(base):
                    continue
                node = graph.block_ops(bd.idx)[op_idx]
                try:
                    if op.type.endswith("_grad"):
                        infer_grad_shapes(op, bd)
                    else:
                        infer_shapes_for_op(op, bd)
                except Exception as e:
                    findings.append(self.finding(
                        Severity.WARNING,
                        "abstract shape inference failed: %s: %s"
                        % (type(e).__name__, str(e).split("\n")[0][:200]),
                        op=node,
                        hint="the lowering rejects the declared "
                             "shapes/dtypes (or the op is data-dependent); "
                             "this op will fail the same way at compile "
                             "time"))
                    continue
                for slot in op.output_names():
                    for name in op.output(slot):
                        if name == EMPTY_VAR_NAME:
                            continue
                        inferred = bd.find_var_recursive(name)
                        declared = orig_bd.find_var_recursive(name)
                        if inferred is None or declared is None:
                            continue
                        if (declared.dtype is not None
                                and inferred.dtype is not None
                                and declared.dtype != inferred.dtype):
                            findings.append(self.finding(
                                Severity.WARNING,
                                "declared dtype of %r is %s but the op "
                                "infers %s" % (
                                    name,
                                    getattr(declared.dtype, "name",
                                            declared.dtype),
                                    getattr(inferred.dtype, "name",
                                            inferred.dtype)),
                                op=node, var_names=[name],
                                hint="fix the var declaration (or the "
                                     "op's attrs) so the IR matches what "
                                     "executes"))
                        if not _shapes_agree(declared.shape,
                                             inferred.shape):
                            findings.append(self.finding(
                                Severity.WARNING,
                                "declared shape of %r is %s but the op "
                                "infers %s" % (name, declared.shape,
                                               inferred.shape),
                                op=node, var_names=[name],
                                hint="fix the var declaration so "
                                     "downstream shape checks see the "
                                     "real shape"))


def _shapes_agree(a, b):
    if a is None or b is None:
        return True
    if len(a) != len(b):
        return False
    return all(
        da == db or da in (-1, None) or db in (-1, None)
        for da, db in zip(a, b))


@register_pass("waw-hazard")
class WriteAfterWritePass(Pass):
    """Two ops writing the same var with no intervening read and no
    read-modify-write dependency: under sequential execution the first
    write is dead; under the parallel executor the two writes race.
    (reference: the conflict class details/ssa_graph_checker.cc exists to
    catch)."""

    def check(self, graph, ctx):
        findings = []
        for v in graph.all_vars():
            if len(v.writers) < 2:
                continue
            for w1, w2 in zip(v.writers, v.writers[1:]):
                if w1.block_idx != w2.block_idx:
                    continue  # cross-block rewrites are loop semantics
                if any(r is w2 or w1.order < r.order < w2.order
                       for r in v.readers):
                    continue  # consumed in between / read-modify-write
                findings.append(self.finding(
                    Severity.WARNING,
                    "%r is written by op %d then overwritten by op %d "
                    "with no read in between: the first write is dead "
                    "sequentially and a race under parallel execution"
                    % (v.name, w1.op_idx, w2.op_idx),
                    op=w2, var_names=[v.name],
                    hint="drop the dead writer or give the second write "
                         "its own output var"))
        return findings


@register_pass("grad-pairing")
class GradPairingPass(Pass):
    """append_backward's contract: every ``X@GRAD`` a backward-role op
    writes corresponds to a forward var ``X`` (same resolution scope) and
    matches its dtype/shape. An orphan gradient means the backward pass
    was built against a different program than the forward."""

    def check(self, graph, ctx):
        from paddle_tpu_torch.core.registry import OpRegistry
        from paddle_tpu_torch.framework import OpRole

        findings = []
        for op in graph.op_nodes:
            is_grad_op = op.type.endswith("_grad")
            if not is_grad_op and not (op.role() & OpRole.Backward):
                continue
            if is_grad_op:
                base = op.type[: -len("_grad")]
                if not OpRegistry.has(base) and not OpRegistry.has(op.type):
                    findings.append(self.finding(
                        Severity.WARNING,
                        "no forward op %r registered to derive this grad "
                        "op's lowering from" % base, op=op,
                        hint="register the forward lowering or a custom "
                             "grad lowering"))
            for slot, v in op.out_edges:
                if not v.is_grad:
                    continue
                fwd = v.forward_var
                if fwd is None or not fwd.declared:
                    findings.append(self.finding(
                        Severity.ERROR,
                        "orphan gradient: %r is written but forward var "
                        "%r does not exist in any enclosing block"
                        % (v.name, v.name[: -len(GRAD_SUFFIX)]),
                        op=op, var_names=[v.name],
                        hint="the backward pass was appended against a "
                             "different program; rebuild it after the "
                             "forward graph is final"))
                    continue
                if (v.declared and v.desc.dtype is not None
                        and fwd.desc.dtype is not None
                        and v.desc.dtype != fwd.desc.dtype):
                    findings.append(self.finding(
                        Severity.WARNING,
                        "gradient %r is %s but forward var %r is %s"
                        % (v.name, v.desc.dtype.name, fwd.name,
                           fwd.desc.dtype.name),
                        op=op, var_names=[v.name, fwd.name],
                        hint="a gradient always carries its forward "
                             "var's dtype"))
                elif (v.declared and not _shapes_agree(
                        v.desc.shape, fwd.desc.shape)):
                    findings.append(self.finding(
                        Severity.WARNING,
                        "gradient %r has shape %s but forward var %r has "
                        "shape %s" % (v.name, v.desc.shape, fwd.name,
                                      fwd.desc.shape),
                        op=op, var_names=[v.name, fwd.name],
                        hint="a gradient always carries its forward "
                             "var's shape"))
        return findings


@register_pass("dead-op")
class DeadOpPass(Pass):
    """Mirror of the engine's dead-code elimination (engine/lowering.py
    BlockProgram): given the fetch list, an op is live iff it transitively
    feeds a fetch target, writes a persistable var, or has no outputs.
    Dead ops are silently dropped by the engine — surfacing them catches
    'why is my metric constant' bugs (the op computing it was dead).
    Needs ``fetch_names``; without them every terminal op is a potential
    fetch and the pass stays quiet."""

    def check(self, graph, ctx):
        if ctx.fetch_names is None:
            return []
        findings = []
        ops = [op for op in graph.block_ops(0) if op.type not in SKIP_OPS]
        live_vars = set(ctx.fetch_names)
        live = [False] * len(ops)
        for i in range(len(ops) - 1, -1, -1):
            op = ops[i]
            out_names = [v.name for _, v in op.out_edges]
            is_live = (
                not out_names
                or any(n in live_vars for n in out_names)
                or any(v.persistable for _, v in op.out_edges)
            )
            if is_live:
                live[i] = True
                live_vars.update(v.name for _, v in op.in_edges)
        for i, op in enumerate(ops):
            if not live[i]:
                findings.append(self.finding(
                    Severity.WARNING,
                    "dead op: no path from its outputs to a fetch target "
                    "or persistable var; the engine will not execute it",
                    op=op,
                    var_names=[v.name for _, v in op.out_edges],
                    hint="fetch one of its outputs or remove the op"))
            else:
                for slot, v in op.out_edges:
                    if (v.persistable or v.readers
                            or v.name in live_vars
                            or "@UNUSED" in v.name
                            or v.name in (ctx.fetch_names or ())):
                        continue
                    findings.append(self.finding(
                        Severity.INFO,
                        "unreachable output: %s=%r is never read and "
                        "never fetched" % (slot, v.name),
                        op=op, var_names=[v.name]))
        return findings


@register_pass("sharding")
class ShardingConsistencyPass(Pass):
    """SPMD annotation audit: every axis a sharding rule names must exist
    in the mesh, every rule should match at least one program var, and a
    matched var's rank/dims must be partitionable as declared
    (parallel/sharding.py falls back to replicated on rank mismatch —
    usually a typo'd rule, so it is surfaced here)."""

    def check(self, graph, ctx):
        rules = ctx.shard_rules
        if rules is None:
            return []
        findings = []
        mesh_axes = (set(ctx.mesh.axis_names)
                     if ctx.mesh is not None else None)
        if mesh_axes is not None:
            for ax in ctx.data_axes:
                if ax not in mesh_axes:
                    findings.append(self.finding(
                        Severity.WARNING,
                        "data axis %r is not a mesh axis %s; feeds will "
                        "be replicated, not batch-sharded"
                        % (ax, sorted(mesh_axes)),
                        hint="pass data_axes naming real mesh axes"))
        var_descs = {}
        for v in graph.all_vars():
            if v.declared and v.desc.type not in _NON_TENSOR_TYPES:
                var_descs.setdefault(v.name, v.desc)
        for pattern, spec in rules.rules():
            axes = _spec_axes(spec)
            if mesh_axes is not None:
                for ax in axes:
                    if ax not in mesh_axes:
                        findings.append(self.finding(
                            Severity.ERROR,
                            "sharding rule %r names axis %r, but the mesh "
                            "only has axes %s"
                            % (pattern, ax, sorted(mesh_axes)),
                            hint="fix the rule or add the axis to "
                                 "make_mesh"))
            matched = [n for n in var_descs if pattern.search(n)]
            if not matched:
                findings.append(self.finding(
                    Severity.INFO,
                    "sharding rule %r matches no program variable"
                    % _pat_str(pattern)))
                continue
            for name in matched:
                vd = var_descs[name]
                if vd.shape is None:
                    continue
                if len(spec) > len(vd.shape):
                    findings.append(self.finding(
                        Severity.WARNING,
                        "rule %r has rank %d but matched var %r has rank "
                        "%d; the engine falls back to replicating it"
                        % (_pat_str(pattern), len(spec), name,
                           len(vd.shape)),
                        var_names=[name],
                        hint="write the rule against the var's real rank"))
                    continue
                if ctx.mesh is None:
                    continue
                for dim, entry in zip(vd.shape, tuple(spec)):
                    if entry is None or dim in (-1, None):
                        continue
                    size = 1
                    for ax in (entry if isinstance(entry, tuple)
                               else (entry,)):
                        size *= ctx.mesh.shape.get(ax, 1)
                    if size > 1 and dim % size != 0:
                        # the reference's message, word for word
                        findings.append(self.finding(
                            Severity.WARNING,
                            "var %r dim %d is not divisible by the %s "
                            "axis size %d; XLA will pad the shards"
                            % (name, dim, entry, size),
                            var_names=[name]))
        return findings


def _spec_axes(spec):
    axes = []
    for entry in tuple(spec):
        if entry is None:
            continue
        if isinstance(entry, tuple):
            axes.extend(entry)
        else:
            axes.append(entry)
    return axes


def _pat_str(pattern):
    return getattr(pattern, "pattern", pattern)


def verify_graph(graph, ctx=None, passes=None, raise_on_error=False):
    report = run_passes(graph, ctx, passes)
    if raise_on_error:
        report.raise_on_errors()
    return report


def verify_program(program, feed_names=None, fetch_names=None, mesh=None,
                   shard_rules=None, data_axes=("dp",), passes=None,
                   raise_on_error=False):
    """Lint a Program (or raw ProgramDescData): build the def-use graph,
    run the default pass pipeline, return the DiagnosticReport. With
    ``raise_on_error`` ERROR-severity findings raise VerificationError —
    the ``PADDLE_GPU_VERIFY=1`` executor hook (see engine/executor.py)."""
    ctx = AnalysisContext(feed_names=feed_names, fetch_names=fetch_names,
                          mesh=mesh, shard_rules=shard_rules,
                          data_axes=data_axes)
    return verify_graph(build_graph(program), ctx, passes,
                        raise_on_error=raise_on_error)
