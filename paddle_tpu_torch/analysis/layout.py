"""Layout assignment: whole-program NHWC rewrite as a transform pass —
port of ``paddle_tpu/analysis/layout.py``. The plan, the rewritten desc
and the baked weights are the reference's; on the card the NHWC ops run
cuDNN's channels_last kernels (ops/nn_ops.py).

The classic whole-graph layout decision of declarative frameworks
(reference: paddle/fluid/framework/data_layout_transform.cc + the
data_transform pass, and TensorFlow's layout optimizer): assign the
accelerator-preferred layout (NHWC) to every layout-sensitive op —
conv2d / depthwise_conv2d / quantized_conv2d, pool2d, batch_norm, and
their appended-gradient twins — propagate the decision forward and
backward through layout-agnostic ops (elementwise, activations,
dropout, casts, the fused ops), and cut the graph with the minimal
number of ``transpose2`` seams where propagation cannot continue
(feeds, fetches, matmul flatten points, reshapes).

The partition is an agree-or-cut coloring over the def-use graph:

1. every op is an ANCHOR (wants NHWC), AGNOSTIC (runs in whatever
   layout its operands share), or a BARRIER (defines NCHW semantics:
   feeds, fetches, matmul/mul, reshape, softmax, everything else);
2. agnostic ops union their rank-4 operands into components
   (union-find), and ``X``/``X@GRAD`` pairs are tied so the verifier's
   grad-pairing contract survives;
3. components reachable from an anchor's data operands are colored
   NHWC; a var is STORED NHWC when its component is colored, it is not
   a feed/fetch/persistable, and every writer agreed to produce NHWC;
4. every remaining disagreement is one shared ``transpose2`` seam —
   one per (var, direction), inserted before the first mismatched
   consumer (or straight after a producer whose output must stay NCHW).

Weights are not transposed at runtime: conv filters (and their
optimizer twins — momentum velocity, Adam moments, anything persistable
with the filter's shape touched by the filter's optimizer op) are baked
OIHW→HWIO **in place in the scope** under the same name, mirroring the
INT8 weight baking of inference/quantize.py. Baking is idempotent: a
re-compile (test-program clone, a rebuilt cache entry, checkpoint restore)
reconciles the scope value's shape against the declared OIHW shape and
skips values already in HWIO. Because the scope's stored layout
changes, the engine keys its executable cache on (layout mode, scope)
and a checkpoint written under ``PADDLE_GPU_LAYOUT=nhwc`` must be
restored under the same setting. One documented blind spot: a filter
whose OIHW and HWIO shapes coincide (all four dims equal) restored from
a checkpoint into a fresh scope cannot be shape-reconciled; within a
process a scope-attached marker disambiguates.

The pass mutates the CLONE the transform pipeline hands it and
re-verifies the result (``verify_program(raise_on_error=True)``): any
ERROR finding raises, the pipeline's crash isolation discards the
clone, freshly-baked weights are restored to OIHW, and the program runs
NCHW — a layout bug degrades to the old layout, never a corrupt
program.

Gating: the ``PADDLE_GPU_LAYOUT`` flag — ``auto`` (default) enables the
pass at ``PADDLE_GPU_OPT_LEVEL>=4``, ``nhwc`` enables it whenever the
transform pipeline runs, ``off`` never.
"""

import numpy as np

from paddle_tpu_torch.analysis.passes import register_pass
from paddle_tpu_torch.analysis.transforms import TransformPass
from paddle_tpu_torch.core.desc import OpDesc
from paddle_tpu_torch.core.types import VarType

__all__ = [
    "LayoutPlan", "LayoutAssignPass", "plan_layout", "apply_layout",
    "resolved_layout_mode", "NCHW_TO_NHWC", "NHWC_TO_NCHW",
    "OIHW_TO_HWIO",
]

NCHW_TO_NHWC = (0, 2, 3, 1)
NHWC_TO_NCHW = (0, 3, 1, 2)
OIHW_TO_HWIO = (2, 3, 1, 0)
HWIO_TO_OIHW = (3, 2, 0, 1)  # inverse of OIHW_TO_HWIO

_OP_ROLE_KEY = "op_role"
_ROLE_OPTIMIZE = 0x0002
_GRAD = "@GRAD"

# Layout-sensitive ops: the attr that declares their layout and the
# slots that carry NCHW activations (grad twins derive from these: the
# fwd slots appear as grad-op inputs, the "@GRAD" variants on either
# side). Filter slots are weights — handled by baking, never by seams.
_LAYOUT_ATTR = {
    "conv2d": "data_format",
    "depthwise_conv2d": "data_format",
    "quantized_conv2d": "data_format",
    "pool2d": "data_format",
    "batch_norm": "data_layout",
}
_DATA_SLOTS = {
    "conv2d": ("Input", "Output"),
    "depthwise_conv2d": ("Input", "Output"),
    "quantized_conv2d": ("Input", "Output"),
    "pool2d": ("X", "Out"),
    "batch_norm": ("X", "Y"),
}
_FILTER_OPS = ("conv2d", "depthwise_conv2d", "quantized_conv2d")

# Layout-agnostic ops: elementwise over their rank-4 operands, so they
# run NHWC for free once their operands do. Everything not listed here
# or in _LAYOUT_ATTR is a barrier (mul/matmul flatten points, reshapes,
# losses, optimizers, feeds/fetches).
_AGNOSTIC = frozenset({
    "relu", "relu6", "leaky_relu", "sigmoid", "tanh", "gelu", "swish",
    "hard_swish", "elu", "sqrt", "square", "abs", "exp", "log", "pow",
    "clip", "scale", "cast", "dropout", "sum",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "fused_elemwise_activation",
    "quantize", "dequantize", "fake_quantize_abs_max",
    "fake_quantize_moving_average_abs_max", "fake_dequantize_max_abs",
})

# int8 rides along so the frozen INT8 path (quantize -> quantized_conv2d
# -> dequantize) keeps its activations NHWC end to end.
_REWRITABLE_DTYPES = frozenset({
    VarType.FP16, VarType.FP32, VarType.FP64, VarType.BF16, VarType.INT8,
})


def resolved_layout_mode(level=None):
    """The active layout target ("nhwc") or None, resolving the
    PADDLE_GPU_LAYOUT flag against the opt level ("auto" = on at level
    >= 4). The engine keys its executable cache on this value."""
    from paddle_tpu_torch import flags

    mode = str(flags.get_flag("layout") or "auto").strip().lower()
    if mode in ("off", "0", "false", "none"):
        return None
    if mode == "nhwc":
        return "nhwc"
    if mode in ("auto", ""):
        if level is None:
            level = int(flags.get_flag("opt_level"))
        return "nhwc" if int(level) >= 4 else None
    return None  # unknown spelling fails closed


class LayoutPlan:
    """What the pass decided: per-op colors, NHWC-stored vars, weights
    to bake (name -> declared OIHW shape), transpose seams
    (var, direction, at-op-type, op index), demotions, and — when the
    whole program was declined — the reason in ``skipped``."""

    def __init__(self):
        self.colors = []
        self.nhwc_vars = set()
        self.weights = {}
        self.baked_now = []  # names whose scope values THIS apply transposed
        self.demoted = {}    # op index -> reason
        self.seams = []      # (var, "nchw->nhwc"|"nhwc->nchw", op type, idx)
        self.skipped = None

    @property
    def n_nhwc_ops(self):
        return sum(1 for c in self.colors if c == "nhwc")

    @property
    def transpose_count(self):
        return len(self.seams)

    def render(self):
        if self.skipped:
            return "layout: skipped (%s)" % self.skipped
        lines = ["layout: %d op(s) NHWC, %d transpose seam(s), "
                 "%d weight(s) OIHW->HWIO"
                 % (self.n_nhwc_ops, self.transpose_count,
                    len(self.weights))]
        for var, direction, at_type, idx in self.seams:
            lines.append("  seam %-12s %-40s at op %d (%s)"
                         % (direction, var, idx, at_type))
        for name in sorted(self.weights):
            lines.append("  weight %-38s %s -> HWIO"
                         % (name, list(self.weights[name])))
        for idx, reason in sorted(self.demoted.items()):
            lines.append("  demoted op %d: %s" % (idx, reason))
        return "\n".join(lines)


def _base(op_type):
    return op_type[:-len("_grad")] if op_type.endswith("_grad") else op_type


def _first(names):
    return names[0] if names else None


def _find(parent, x):
    root = x
    while parent.get(root, root) != root:
        root = parent[root]
    while parent.get(x, x) != x:
        parent[x], x = root, parent[x]
    return root


def _union(parent, a, b):
    ra, rb = _find(parent, a), _find(parent, b)
    if ra != rb:
        parent[rb] = ra


def _rewritable(block, name, cache):
    got = cache.get(name)
    if got is None:
        vd = block.find_var_recursive(name)
        got = bool(
            vd is not None and vd.shape is not None and len(vd.shape) == 4
            and vd.dtype in _REWRITABLE_DTYPES
            and vd.type == VarType.LOD_TENSOR)
        cache[name] = got
    return got


def _agnostic_ok(op, block):
    """An elementwise op propagates NHWC only when its broadcast is
    layout-safe: same-rank Y, scalar Y, or the conv-bias pattern
    (rank-1 Y at axis 1, which the rewrite moves to axis 3). A rank-1 Y
    aligned to the LAST axis (axis -1 means W under NCHW but C under
    NHWC) or a mid-rank Y changes meaning — barrier."""
    if not (_base(op.type).startswith("elementwise")
            or _base(op.type) == "fused_elemwise_activation"):
        return True
    x = block.find_var_recursive(_first(op.input("X")) or "")
    y = block.find_var_recursive(_first(op.input("Y")) or "")
    if x is None or y is None or x.shape is None or y.shape is None:
        return False
    if len(x.shape) != 4:
        return True  # operands are not rank-4: never unioned anyway
    if len(y.shape) == 4:
        return True
    numel = 1
    for d in y.shape:
        numel *= d if d > 0 else 1
    if numel == 1:
        return True  # scalar broadcasts under any layout
    return len(y.shape) == 1 and int(op.attrs.get("axis", -1)) == 1


def _bake_state(scope, name, declared_oihw):
    """How the scope holds ``name`` relative to its declared OIHW shape:
    "oihw" (needs the transpose), "hwio" (already baked — re-compile or
    checkpoint restore), or None (missing/unreconcilable)."""
    val = scope.get(name)
    if val is None:
        return None
    shape = tuple(getattr(val, "shape", ()))
    oihw = tuple(int(d) for d in declared_oihw)
    hwio = tuple(oihw[i] for i in OIHW_TO_HWIO)
    if shape == oihw == hwio:
        baked = getattr(scope, "_layout_hwio", set())
        return "hwio" if name in baked else "oihw"
    if shape == oihw:
        return "oihw"
    if shape == hwio:
        return "hwio"
    return None


def _analyze(desc, feed_names, fetch_names, scope):
    """Phases 1-3 of the partition: classify, union, mark, decide
    storage. Pure analysis — no desc or scope mutation."""
    plan = LayoutPlan()
    feed_names = tuple(feed_names or ())
    fetch_names = tuple(fetch_names or ())
    if desc.num_blocks() > 1:
        plan.skipped = "control-flow sub-blocks present"
        return plan, None
    block = block0 = desc.block(0)
    ops = block.ops
    rew = {}

    if not any(_base(op.type) in _LAYOUT_ATTR for op in ops):
        plan.skipped = "no layout-sensitive ops"
        return plan, None

    # -- weights: conv filters + optimizer twins -------------------------
    filters = {}  # filter name -> declared OIHW shape
    bad_filters = {}  # filter name -> reason
    for op in ops:
        if _base(op.type) not in _FILTER_OPS:
            continue
        w = _first(op.input("Filter"))
        if w is None or w in filters or w in bad_filters:
            continue
        vd = block.find_var_recursive(w)
        if vd is None or vd.shape is None or len(vd.shape) != 4:
            bad_filters[w] = "filter has no rank-4 VarDesc"
            continue
        if not vd.persistable:
            bad_filters[w] = "filter is not persistable (cannot bake)"
            continue
        if w in feed_names or w in fetch_names:
            # fetching a filter would expose the HWIO storage mid-list;
            # keep that conv NCHW instead of surprising the caller
            bad_filters[w] = "filter appears in the feed/fetch list"
            continue
        filters[w] = tuple(vd.shape)

    twins = {}  # twin name -> declared shape (== its filter's)
    for op in ops:
        role = int(op.attrs.get(_OP_ROLE_KEY, 0) or 0)
        if not role & _ROLE_OPTIMIZE:
            continue
        touched = [w for w in op.input_arg_names() if w in filters]
        for w in touched:
            shape = filters[w]
            for name in op.input_arg_names() + op.output_arg_names():
                if name == w or name in filters or name in twins:
                    continue
                vd = block.find_var_recursive(name)
                if (vd is not None and vd.persistable
                        and vd.shape is not None
                        and tuple(vd.shape) == shape):
                    twins[name] = shape

    if scope is not None:
        for name, shape in list(filters.items()) + list(twins.items()):
            if _bake_state(scope, name, shape) is None:
                if scope.get(name) is None:
                    # a compile before the startup run (cost_analysis on
                    # a cold scope): decline the whole program rather
                    # than bake half a parameter set
                    plan.skipped = ("weight %r has no scope value yet "
                                    "(startup not run?)" % name)
                    return plan, None
                bad = [w for w in filters
                       if name == w or tuple(filters[w]) == tuple(shape)]
                for w in bad:
                    bad_filters[w] = ("weight %r shape is neither OIHW "
                                      "nor HWIO of the declared shape"
                                      % name)
                    filters.pop(w, None)

    plan.weights = dict(filters)
    plan.weights.update(
        {n: s for n, s in twins.items()
         if any(tuple(s) == tuple(filters[w]) for w in filters)})
    weight_names = set(plan.weights)

    def weighty(name):
        if name in weight_names:
            return True
        if _GRAD in name and name.split(_GRAD)[0] in weight_names:
            return True
        return False

    # -- classification --------------------------------------------------
    kinds = []
    for i, op in enumerate(ops):
        base = _base(op.type)
        if op.type in ("feed", "fetch"):
            kinds.append("barrier")
            continue
        if base in _LAYOUT_ATTR:
            main = _first(op.input(_DATA_SLOTS[base][0]))
            if main is None or not _rewritable(block, main, rew):
                plan.demoted[i] = ("main input %r is not a rank-4 "
                                   "float tensor" % main)
                kinds.append("barrier")
            elif base in _FILTER_OPS and \
                    _first(op.input("Filter")) not in filters:
                plan.demoted[i] = bad_filters.get(
                    _first(op.input("Filter")), "filter not bakeable")
                kinds.append("barrier")
            else:
                kinds.append("anchor")
        elif base in _AGNOSTIC and _agnostic_ok(op, block):
            kinds.append("agnostic")
        else:
            kinds.append("barrier")

    # -- union-find over agnostic operands + grad ties -------------------
    parent = {}
    for i, op in enumerate(ops):
        if kinds[i] != "agnostic":
            continue
        operands = [n for n in op.input_arg_names() + op.output_arg_names()
                    if _rewritable(block, n, rew) and not weighty(n)]
        for n in operands[1:]:
            _union(parent, operands[0], n)
    for name in list(block0.vars):
        g = name + _GRAD
        if (g in block0.vars and not weighty(name)
                and _rewritable(block, name, rew)
                and _rewritable(block, g, rew)):
            _union(parent, name, g)

    # -- marking from anchors --------------------------------------------
    marked = set()
    for i, op in enumerate(ops):
        if kinds[i] != "anchor":
            continue
        base = _base(op.type)
        for s in _DATA_SLOTS[base]:
            for sl in (s, s + _GRAD):
                for n in op.input(sl) + op.output(sl):
                    if _rewritable(block, n, rew) and not weighty(n):
                        marked.add(_find(parent, n))

    # -- op coloring ------------------------------------------------------
    for i, op in enumerate(ops):
        if kinds[i] == "anchor":
            plan.colors.append("nhwc")
        elif kinds[i] == "agnostic" and any(
                _find(parent, n) in marked
                for n in op.input_arg_names() + op.output_arg_names()
                if _rewritable(block, n, rew) and not weighty(n)):
            plan.colors.append("nhwc")
        else:
            plan.colors.append("nchw")

    # -- var storage ------------------------------------------------------
    protected = set(feed_names) | set(fetch_names)
    for name in list(protected):
        # keep grad pairs in one layout so X@GRAD always matches X
        protected.add(name + _GRAD)
        if name.endswith(_GRAD):
            protected.add(name[:-len(_GRAD)])
    writer_colors = {}
    for i, op in enumerate(ops):
        if op.type in ("feed", "fetch"):
            continue
        for n in op.output_arg_names():
            writer_colors.setdefault(n, []).append(plan.colors[i])
    for name, colors in writer_colors.items():
        if (name not in protected and not weighty(name)
                and _rewritable(block, name, rew)
                and not block.find_var_recursive(name).persistable
                and _find(parent, name) in marked
                and all(c == "nhwc" for c in colors)):
            plan.nhwc_vars.add(name)

    meta = {
        "block": block,
        "rew": rew,
        "weighty": weighty,
        "writer_count": {n: len(c) for n, c in writer_colors.items()},
    }
    return plan, meta


def _rewrite(desc, plan, meta, mutate):
    """Phase 4: walk the op list once, rewriting attrs, renaming
    operands, and inserting shared transpose2 seams. With
    ``mutate=False`` only the seam records are produced (the lint
    report path) — the desc is untouched."""
    block = meta["block"]
    rew = meta["rew"]
    weighty = meta["weighty"]
    writer_count = meta["writer_count"]
    n_attr = 0

    if mutate:
        # weights first (desc metadata only; scope values are baked by
        # the caller after the whole rewrite succeeded)
        for name, shape in plan.weights.items():
            vd = block.find_var_recursive(name)
            vd.shape = [int(shape[i]) for i in OIHW_TO_HWIO]

    new_ops = []
    nhwc_of = {}  # var -> seam var holding its NHWC copy (shared)
    nchw_of = {}  # var -> seam var holding its NCHW copy (shared)

    def _seam_var(name, perm, suffix):
        seam = name + suffix
        if mutate and not block.has_var(seam):
            src = block.find_var_recursive(name)
            block.create_var(
                seam,
                shape=[src.shape[i] for i in perm]
                if src.shape is not None else None,
                dtype=src.dtype, stop_gradient=True)
        return seam

    for idx, op in enumerate(block.ops):
        color = plan.colors[idx]
        role = int(op.attrs.get(_OP_ROLE_KEY, 0) or 0)
        base = _base(op.type)
        post = []

        if color == "nchw":
            # NHWC-stored inputs must arrive NCHW: one shared seam per var
            for slot in list(op.inputs):
                names = op.inputs[slot]
                for j, name in enumerate(names):
                    if name not in plan.nhwc_vars:
                        continue
                    seam = nchw_of.get(name)
                    if seam is None:
                        seam = _seam_var(name, NCHW_TO_NHWC,
                                         "@layout.nchw")
                        plan.seams.append(
                            (name, "nhwc->nchw", op.type, idx))
                        if mutate:
                            new_ops.append(OpDesc(
                                "transpose2", {"X": [name]},
                                {"Out": [seam]},
                                {"axis": list(NHWC_TO_NCHW),
                                 _OP_ROLE_KEY: role,
                                 "__layout_seam__": "nhwc->nchw"}))
                        if writer_count.get(name, 0) <= 1:
                            nchw_of[name] = seam
                    if mutate:
                        names[j] = seam
            new_ops.append(op)
            continue

        # -- NHWC-colored op ---------------------------------------------
        if mutate:
            if base in _LAYOUT_ATTR:
                op.attrs[_LAYOUT_ATTR[base]] = "NHWC"
                # opprof provenance: mark the rewrite so the attribution
                # table shows this op was layout-transformed from NCHW
                op.attrs.setdefault("__src_ops__", [base + "@nchw"])
                n_attr += 1
            elif (base.startswith("elementwise")
                  or base == "fused_elemwise_activation"):
                y = block.find_var_recursive(_first(op.input("Y")) or "")
                if (int(op.attrs.get("axis", -1)) == 1 and y is not None
                        and y.shape is not None and len(y.shape) == 1):
                    op.attrs["axis"] = 3  # conv-bias: channel moved last
                    n_attr += 1
        elif base in _LAYOUT_ATTR:
            n_attr += 1

        for slot in list(op.inputs):
            names = op.inputs[slot]
            for j, name in enumerate(names):
                if (name in plan.nhwc_vars or weighty(name)
                        or not _rewritable(block, name, rew)):
                    continue
                # NCHW-held rank-4 input (feed or barrier product)
                seam = nhwc_of.get(name)
                if seam is None:
                    seam = _seam_var(name, NCHW_TO_NHWC, "@layout.nhwc")
                    plan.seams.append((name, "nchw->nhwc", op.type, idx))
                    if mutate:
                        new_ops.append(OpDesc(
                            "transpose2", {"X": [name]}, {"Out": [seam]},
                            {"axis": list(NCHW_TO_NHWC),
                             _OP_ROLE_KEY: role,
                             "__layout_seam__": "nchw->nhwc"}))
                    if writer_count.get(name, 0) <= 1:
                        nhwc_of[name] = seam
                if mutate:
                    names[j] = seam

        for slot in list(op.outputs):
            names = op.outputs[slot]
            for j, name in enumerate(names):
                if (name in plan.nhwc_vars or weighty(name)
                        or not _rewritable(block, name, rew)):
                    continue
                # this op computes NHWC but the var must stay NCHW
                # (fetched, protected, or mixed writers): write a fresh
                # NHWC var and transpose back under the original name
                tmp = name + "@layout.pre%d" % idx
                plan.seams.append((name, "nhwc->nchw", op.type, idx))
                if mutate:
                    src = block.find_var_recursive(name)
                    block.create_var(
                        tmp,
                        shape=[src.shape[i] for i in NCHW_TO_NHWC]
                        if src.shape is not None else None,
                        dtype=src.dtype, stop_gradient=True)
                    names[j] = tmp
                    post.append(OpDesc(
                        "transpose2", {"X": [tmp]}, {"Out": [name]},
                        {"axis": list(NHWC_TO_NCHW), _OP_ROLE_KEY: role,
                         "__layout_seam__": "nhwc->nchw"}))
        new_ops.append(op)
        new_ops.extend(post)

    if mutate:
        block.ops = new_ops
        # reconcile every declared shape with what the NHWC lowerings
        # will actually produce — the same abstract evaluation the
        # shape-dtype checker trusts (framework.infer_shapes_for_op),
        # swept in program order so grads inherit permuted fwd shapes
        from paddle_tpu_torch.core.registry import OpRegistry
        from paddle_tpu_torch.framework import (
            infer_grad_shapes, infer_shapes_for_op,
        )

        for op in block.ops:
            # the reference's rule (framework.infer_shapes_for_op): a
            # *_grad op of a registered op gives X@GRAD the shape of X
            base = (op.type[: -len("_grad")] if op.type.endswith("_grad")
                    else op.type)
            if not OpRegistry.has(base):
                continue
            try:
                if op.type.endswith("_grad"):
                    infer_grad_shapes(op, block)
                else:
                    infer_shapes_for_op(op, block)
            except Exception:
                pass  # unknown/partial ops keep their declared metadata
    return n_attr


def _permuted(val, perm):
    """``val`` transposed by ``perm`` as a NEW contiguous value of the
    same kind and device (a torch tensor stays on its device; a host
    array stays numpy). The scope gets another tensor under the name, so
    a CUDA graph captured against the old one can not replay: the
    engine's cache key (layout mode, scope) and its recapture on a
    changed scope tensor keep them apart."""
    import torch

    if isinstance(val, torch.Tensor):
        return val.permute(*perm).contiguous()
    return np.ascontiguousarray(np.transpose(np.asarray(val), perm))


def _bake_scope(scope, plan):
    """Transpose the planned weights OIHW->HWIO in place in the scope.
    Validate-then-mutate: every value's state is resolved before the
    first write, so a surprise never leaves a half-baked parameter
    set."""
    states = {}
    for name, shape in plan.weights.items():
        state = _bake_state(scope, name, shape)
        if state is None:  # _analyze vetted these; re-check anyway
            raise RuntimeError(
                "layout: weight %r changed shape between planning and "
                "baking" % name)
        states[name] = state
    baked = getattr(scope, "_layout_hwio", None)
    if baked is None:
        baked = scope._layout_hwio = set()
    for name, state in states.items():
        if state == "oihw":
            scope.set(name, _permuted(scope.get(name), OIHW_TO_HWIO))
            plan.baked_now.append(name)
        baked.add(name)


def _unbake_scope(scope, plan):
    """Crash path: restore the weights THIS apply transposed."""
    baked = getattr(scope, "_layout_hwio", set())
    for name in plan.baked_now:
        val = scope.get(name)
        if val is not None:
            scope.set(name, _permuted(val, HWIO_TO_OIHW))
        baked.discard(name)
    plan.baked_now = []


def plan_layout(desc_or_program, feed_names=(), fetch_names=(),
                scope=None):
    """Dry-run the partition: the full LayoutPlan (colors, NHWC vars,
    seams, weights) without touching the desc or the scope — the
    ``tools/lint_program.py --layout`` report path."""
    desc = getattr(desc_or_program, "desc", desc_or_program)
    plan, meta = _analyze(desc, feed_names, fetch_names, scope)
    if meta is not None:
        _rewrite(desc, plan, meta, mutate=False)
    return plan


def apply_layout(desc_or_program, feed_names=(), fetch_names=(),
                 scope=None):
    """Execute the rewrite on ``desc`` (callers pass a clone — the
    transform pipeline always does) and bake weights into ``scope``.
    Returns ``(n_rewrites, plan)``; 0 rewrites means the program was
    declined (see ``plan.skipped``)."""
    desc = getattr(desc_or_program, "desc", desc_or_program)
    if scope is None:
        raise ValueError("apply_layout needs the scope holding the "
                         "weights (use plan_layout for a dry run)")
    plan, meta = _analyze(desc, feed_names, fetch_names, scope)
    if meta is None or plan.n_nhwc_ops == 0:
        if plan.skipped is None:
            plan.skipped = "no op accepted the NHWC assignment"
        return 0, plan
    n_attr = _rewrite(desc, plan, meta, mutate=True)
    _bake_scope(scope, plan)
    return plan.n_nhwc_ops + len(plan.seams) + n_attr, plan


@register_pass("layout-assign")
class LayoutAssignPass(TransformPass):
    """The registered transform (see module docstring). min_level 1 so
    the PADDLE_GPU_LAYOUT=nhwc spelling works at the default opt level;
    the real gate is ``resolved_layout_mode`` (flag x opt level)."""

    min_level = 1

    def apply(self, desc, ctx):
        if resolved_layout_mode(ctx.level) != "nhwc":
            return 0
        from paddle_tpu_torch import observability as obs

        scope = getattr(ctx, "scope", None)
        if scope is None:
            # nothing to bake weights into: a desc-only rewrite would
            # compile against OIHW values it just declared HWIO
            obs.inc("layout.skipped_no_scope")
            return 0
        n, plan = apply_layout(desc, feed_names=ctx.feed_names,
                               fetch_names=ctx.fetch_names, scope=scope)
        self.last_plan = plan
        if not n:
            obs.inc("layout.skipped")
            return 0
        try:
            # self-verify at the seam: an ERROR finding raises, the
            # pipeline's crash isolation discards this clone, and the
            # weights baked above go back to OIHW
            from paddle_tpu_torch.analysis.passes import verify_program

            verify_program(desc, feed_names=ctx.feed_names,
                           fetch_names=ctx.fetch_names,
                           raise_on_error=True)
        except Exception:
            _unbake_scope(scope, plan)
            raise
        obs.inc("layout.nhwc_ops", plan.n_nhwc_ops)
        obs.inc("layout.transpose_seams", plan.transpose_count)
        obs.inc("layout.weights_baked", len(plan.weights))
        return n
