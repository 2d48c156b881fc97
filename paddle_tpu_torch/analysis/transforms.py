"""Transform passes: desc-level rewrites on a cloned Program IR — port of
``paddle_tpu/analysis/transforms.py`` for the framework and pass 1.

The mutating half of the pass framework (reference:
paddle/fluid/framework/ir/ Pass::Apply + the fuse_pass family): where
passes.py checkers only *read* the def-use graph, a ``TransformPass``
rewrites a **clone** of the ProgramDesc before lowering. The pipeline
runs once per cache entry at the engine's cache-miss seam
(engine/executor.py ``Engine.get_compiled``), the same place
verification runs, gated by ``opt_level`` (``PADDLE_GPU_OPT_LEVEL``,
default 1, the reference's):

  level 0   off (the desc is handed to the engine untouched)
  level 1   fuse-attention: rewrite the matmul->[scale]->[+mask]->
            softmax->[dropout]->matmul composition that layers.nn
            attention emits into the single ``fused_attention`` op (and
            its backward chain into ``fused_attention_grad``), which
            launch the hand-written CUDA flash kernels on the card
  level 2   + fuse-elemwise-act, fold-constants, cse: op-count
            shrinkers (an activation fused into the add before it, a
            uniform constant computed once, a duplicate op dropped)
  level 3   + memory planning (analysis/memory.py, run by the engine
            after this pipeline: donation and auto-remat against the
            card's memory budget)
  level 4   + layout-assign (analysis/layout.py): the whole-program
            NHWC rewrite, on at level 4 or wherever the ``layout`` flag
            says ``nhwc``

Every pass clones its input and applies to the clone; a crashing pass is
recorded in the report and its half-mutated clone discarded, so the
pipeline can never corrupt the program it was asked to speed up. The
original desc is returned untouched when nothing rewrites. Transformed
descs pass the verifier (passes.py); the executor verifies the
*post-transform* desc when both are on. The rewrites, their attrs and
the names they create are the reference's, so both packages produce the
same transformed desc byte for byte.
"""

from paddle_tpu_torch.analysis.passes import PASS_REGISTRY, Pass, register_pass
from paddle_tpu_torch.core.desc import OpDesc

# Attr keys that never change semantics — ignored when comparing ops for
# CSE and stripped from nothing else (rewrites carry attrs verbatim).
_NONSEMANTIC_ATTRS = frozenset({
    "op_role", "op_role_var", "op_namescope", "op_callstack",
})

# Execution order of the reference's transform pipeline. Substitution
# first (the attention rewrite wants the raw composition, before fusion
# renames intermediates), then local fusion, then the global cleanups.
TRANSFORM_PIPELINE = (
    "fuse-attention",
    "fuse-elemwise-act",
    "fold-constants",
    "cse",
    # last: the whole-program NHWC rewrite (analysis/layout.py) wants the
    # final op set — fusions done, dead constants folded — before it
    # partitions the def-use graph and bakes weight layouts
    "layout-assign",
)


class TransformContext:
    """Run-site facts a rewrite may use: the feed/fetch lists the compiled
    executable will run with, the requested opt level, and (for passes
    that bake weights, e.g. the freeze pipeline's BN fold) the scope
    holding the trained parameter values."""

    def __init__(self, feed_names=None, fetch_names=None, level=1,
                 scope=None):
        self.feed_names = tuple(feed_names or ())
        self.fetch_names = tuple(fetch_names or ())
        self.level = int(level)
        self.scope = scope


class TransformPass(Pass):
    """Base transform: ``apply(desc, ctx) -> int`` mutates ``desc`` in
    place and returns the number of rewrites performed. ``check`` is
    inert so a transform accidentally handed to the checker pipeline is
    a no-op rather than a crash."""

    kind = "transform"
    min_level = 2

    def apply(self, desc, ctx):
        raise NotImplementedError

    def check(self, graph, ctx):
        return []


class TransformReport:
    """What the pipeline did: per-pass rewrite counts, per-pass crashes
    (pass name -> error string; the crashed pass's mutations were
    discarded), and the number of dead ops pruned afterwards."""

    def __init__(self, level):
        self.level = int(level)
        self.rewrites = {}
        self.crashed = {}
        self.pruned = 0

    @property
    def total(self):
        return sum(self.rewrites.values())

    def render(self):
        lines = ["optimize_program(level=%d): %d rewrite(s)"
                 % (self.level, self.total)]
        for name, n in self.rewrites.items():
            lines.append("  %-20s %d" % (name, n))
        for name, err in self.crashed.items():
            lines.append("  %-20s CRASHED (discarded): %s" % (name, err))
        if self.pruned:
            lines.append("  pruned %d dead op(s)" % self.pruned)
        return "\n".join(lines)

    def __repr__(self):
        return "TransformReport(level=%d, rewrites=%r, crashed=%r)" % (
            self.level, self.rewrites, sorted(self.crashed))


def transform_passes(level):
    """Instances of the registered transform passes active at ``level``,
    in TRANSFORM_PIPELINE order."""
    out = []
    for name in TRANSFORM_PIPELINE:
        cls = PASS_REGISTRY.get(name)
        if cls is not None and getattr(cls, "min_level", 2) <= level:
            out.append(cls())
    return out


def optimize_program(program_or_desc, level=None, feed_names=None,
                     fetch_names=None, passes=None, scope=None):
    """Run the transform pipeline over a clone of the program.

    Returns ``(desc, report)``. ``desc`` is the ORIGINAL desc object
    (untouched) when the level disables every pass or nothing rewrote;
    otherwise a transformed clone. The caller (engine cache-miss seam)
    compiles whatever comes back and keys its cache on the original, so
    a rewrite can never alias a differently-optimized executable.
    """
    desc = getattr(program_or_desc, "desc", program_or_desc)
    if level is None:
        from paddle_tpu_torch import flags
        level = int(flags.get_flag("opt_level"))
    level = int(level)
    selected = transform_passes(level) if passes is None else list(passes)
    report = TransformReport(level)
    if level <= 0 or not selected:
        return desc, report
    # Lazy import: analysis stays importable without the full package
    # chain; observability pulls the flags.
    from paddle_tpu_torch import observability as obs

    ctx = TransformContext(feed_names=feed_names, fetch_names=fetch_names,
                           level=level, scope=scope)
    with obs.span("transform", level=level), \
            obs.time_block("transform.pipeline_ms"):
        good = desc.clone()
        for p in selected:
            work = good.clone()
            try:
                with obs.span("transform:%s" % p.name), \
                        obs.time_block("transform.%s.ms" % p.name):
                    n = int(p.apply(work, ctx) or 0)
            except Exception as e:  # discard the half-mutated clone
                report.crashed[p.name] = "%s: %s" % (type(e).__name__, e)
                obs.inc("transform.%s.crashes" % p.name)
                continue
            if n:
                good = work
                report.rewrites[p.name] = report.rewrites.get(p.name, 0) + n
                obs.inc("transform.%s.rewrites" % p.name, n)
                obs.inc("transform.rewrites", n)
        if not report.total:
            return desc, report
        if ctx.fetch_names:
            report.pruned = _prune_dead_ops(good, ctx.fetch_names)
            obs.inc("transform.pruned_ops", report.pruned)
    return good, report


# -- shared desc utilities ----------------------------------------------


def _single(names):
    """The sole name of a slot, or None if the slot is empty/multi."""
    return names[0] if len(names) == 1 else None


def _is_grad_op(op):
    from paddle_tpu_torch.framework import OpRole
    return (op.type.endswith("_grad")
            or bool(int(op.attrs.get("op_role", 0)) & OpRole.Backward))


def _protected_names(desc, ctx):
    """Names a rewrite must not remove or rename: feeds, fetches, and
    anything persistable/parameter (scope state observable outside the
    program)."""
    names = set(ctx.feed_names) | set(ctx.fetch_names)
    for b in desc.blocks:
        for name, vd in b.vars.items():
            if vd.persistable or vd.is_parameter:
                names.add(name)
    return names


def _reader_map(desc):
    """name -> [(block_idx, op)] over the whole program, program order."""
    readers = {}
    for b in desc.blocks:
        for op in b.ops:
            if op.type in ("feed", "fetch"):
                continue
            for n in op.input_arg_names():
                readers.setdefault(n, []).append((b.idx, op))
    return readers


def _writer_map(desc):
    """name -> [(block_idx, op)] over the whole program, program order."""
    writers = {}
    for b in desc.blocks:
        for op in b.ops:
            if op.type in ("feed", "fetch"):
                continue
            for n in op.output_arg_names():
                writers.setdefault(n, []).append((b.idx, op))
    return writers


def _is_float_tensor(vd, rank=None):
    from paddle_tpu_torch.analysis.passes import _FLOAT_TYPES
    if vd is None or vd.dtype not in _FLOAT_TYPES:
        return False
    if rank is not None:
        return vd.shape is not None and len(vd.shape) == rank
    return True


def _prune_dead_ops(desc, fetch_names):
    """Block-0 mirror of the engine's DCE (engine/lowering.py
    BlockProgram): after a rewrite disconnects ops, drop everything with
    no path to a fetch target or persistable var so the residue never
    reaches shape inference or the verifier. Vars read by sub-blocks stay
    live; feed/fetch marker ops always stay."""
    block = desc.block(0)
    live_vars = set(fetch_names)
    for b in desc.blocks[1:]:
        for op in b.ops:
            live_vars.update(op.input_arg_names())
    keep = [False] * len(block.ops)
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if op.type in ("feed", "fetch"):
            keep[i] = True
            continue
        outs = op.output_arg_names()
        live = (not outs or any(n in live_vars for n in outs)
                or any(getattr(block.find_var_recursive(n), "persistable",
                               False) for n in outs))
        if live:
            keep[i] = True
            live_vars.update(op.input_arg_names())
    removed = len(block.ops) - sum(keep)
    if removed:
        block.ops = [op for i, op in enumerate(block.ops) if keep[i]]
    return removed


# -- pass 1: attention-pattern rewrite -----------------------------------


class _AttnMatch:
    """One matched attention subgraph: the forward chain
    matmul(QK^T)→[scale]→[elementwise_add mask]→softmax→[dropout]→matmul
    plus (in a training program) its mirrored backward chain."""

    def __init__(self):
        self.fwd_ops = []      # matched forward OpDescs, program order
        self.bwd_ops = []      # matched grad OpDescs, program order
        self.q = self.k = self.v = self.out = None
        self.lens = None       # SeqLens var behind a recognized mask chain
        self.scale = 1.0
        self.dropout_rate = 0.0
        self.is_test = False
        self.rng_id = None
        self.g_out = None      # Out@GRAD fed to the matched backward
        self.g_q = self.g_k = self.g_v = None
        self.fwd_anchor = None  # final matmul: fused op takes its slot
        self.bwd_anchor = None  # first grad op: fused grad takes its slot


@register_pass("fuse-attention")
class AttentionFusePass(TransformPass):
    """Rewrite the unfused attention composition to ``fused_attention``
    (+ ``fused_attention_grad`` when a backward chain is attached),
    so that programs that spell attention out op by op run the
    hand-written flash kernels.

    Matched forward shape (optional steps bracketed)::

        scores = matmul(Q, K, transpose_Y=True, alpha=a)
        [scores = scale(scores, scale=s, bias=0)]          # a *= s
        [scores = elementwise_add(scores, mask)]           # lens mask only
        weights = softmax(scores, axis=-1)
        [weights = dropout(weights, upscale_in_train)]
        out = matmul(weights, V)

    The mask arm is accepted only when it traces back to the
    ``sequence_mask → scale(BIG, -BIG) → reshape2`` chain layers.nn emits
    from ``seq_lens`` (see ``attention_bias_from_lens``); the lengths var
    becomes the fused op's SeqLens input, an exact semantic match for the
    kernel's key-padding mask. Arbitrary masks do NOT match — correctness
    over coverage. Every intermediate must be single-writer and consumed
    only inside the pattern (+ its own backward), so deleting the ops can
    not starve an outside reader. The backward chain, when present, is
    matched op for op (matmul_grad→[dropout_grad]→softmax_grad→
    [elementwise_add_grad]→[scale_grad]→matmul_grad) and replaced by one
    ``fused_attention_grad`` writing the SAME grad var names, so the
    surrounding accumulation/optimizer ops never notice. The dropout op's
    ``__rng_id__`` is carried onto both fused ops — forward and backward
    derive the same in-kernel dropout mask."""

    min_level = 1

    def apply(self, desc, ctx):
        block = desc.block(0)
        protected = _protected_names(desc, ctx)
        total = 0
        while True:
            m = self._find(desc, block, protected)
            if m is None:
                break
            self._rewrite(block, m)
            total += 1
        return total

    # -- matching --------------------------------------------------------

    def _find(self, desc, block, protected):
        readers = _reader_map(desc)
        writers = _writer_map(desc)
        for op in block.ops:
            m = self._match(block, op, readers, writers, protected)
            if m is not None:
                return m
        return None

    def _sole_fwd_reader(self, name, readers, protected):
        """The unique forward (non-grad) block-0 reader of ``name``, or
        None when the var escapes the pattern (other blocks, fetches,
        multiple forward readers)."""
        if name in protected:
            return None
        rs = readers.get(name, [])
        if any(b != 0 for b, _ in rs):
            return None
        fwd = [op for _, op in rs if not _is_grad_op(op)]
        return fwd[0] if len(fwd) == 1 else None

    def _match(self, block, opA, readers, writers, protected):
        # anchor: scores = matmul(Q, K^T)
        if opA.type != "matmul":
            return None
        if opA.attrs.get("transpose_X", False) \
                or not opA.attrs.get("transpose_Y", False):
            return None
        q, k = _single(opA.input("X")), _single(opA.input("Y"))
        cur = _single(opA.output("Out"))
        if q is None or k is None or cur is None:
            return None
        if not _is_float_tensor(block.find_var_recursive(q), rank=4) \
                or not _is_float_tensor(block.find_var_recursive(k), rank=4):
            return None

        m = _AttnMatch()
        m.q, m.k = q, k
        m.scale = float(opA.attrs.get("alpha", 1.0))
        m.fwd_ops.append(opA)
        inter = [cur]  # pattern-internal vars, must be single-writer

        nxt = self._sole_fwd_reader(cur, readers, protected)
        if nxt is None:
            return None
        if nxt.type == "scale":
            if float(nxt.attrs.get("bias", 0.0)) != 0.0 \
                    or not nxt.attrs.get("bias_after_scale", True):
                return None
            m.scale *= float(nxt.attrs.get("scale", 1.0))
            m.fwd_ops.append(nxt)
            cur = _single(nxt.output("Out"))
            if cur is None:
                return None
            inter.append(cur)
            nxt = self._sole_fwd_reader(cur, readers, protected)
            if nxt is None:
                return None
        if nxt.type == "elementwise_add":
            if _single(nxt.input("X")) != cur:
                return None
            m.lens = self._match_lens_mask(
                block, _single(nxt.input("Y")), writers)
            if m.lens is None:
                return None  # an additive mask we cannot prove is padding
            m.fwd_ops.append(nxt)
            cur = _single(nxt.output("Out"))
            if cur is None:
                return None
            inter.append(cur)
            nxt = self._sole_fwd_reader(cur, readers, protected)
            if nxt is None:
                return None
        if nxt.type != "softmax":
            return None
        if nxt.attrs.get("axis", -1) not in (-1, 3):
            return None
        if _single(nxt.input("X")) != cur:
            return None
        m.fwd_ops.append(nxt)
        cur = _single(nxt.output("Out"))
        if cur is None:
            return None
        inter.append(cur)
        nxt = self._sole_fwd_reader(cur, readers, protected)
        if nxt is None:
            return None
        if nxt.type == "dropout":
            impl = nxt.attrs.get("dropout_implementation",
                                 "downgrade_in_infer")
            if impl != "upscale_in_train":
                return None  # fused kernel dropout is inverted dropout
            mask_out = _single(nxt.output("Mask"))
            if mask_out is not None and (mask_out in protected
                                         or readers.get(mask_out)):
                return None  # someone consumes the mask: not rewritable
            m.dropout_rate = float(nxt.attrs.get("dropout_prob", 0.0))
            m.is_test = bool(nxt.attrs.get("is_test", False))
            m.rng_id = nxt.attrs.get("__rng_id__")
            m.fwd_ops.append(nxt)
            cur = _single(nxt.output("Out"))
            if cur is None:
                return None
            inter.append(cur)
            nxt = self._sole_fwd_reader(cur, readers, protected)
            if nxt is None:
                return None
        # closing matmul: out = weights @ V
        if nxt.type != "matmul":
            return None
        if nxt.attrs.get("transpose_X", False) \
                or nxt.attrs.get("transpose_Y", False) \
                or float(nxt.attrs.get("alpha", 1.0)) != 1.0:
            return None
        w_last = inter[-1]
        if _single(nxt.input("X")) != w_last:
            return None
        v = _single(nxt.input("Y"))
        if v is None or not _is_float_tensor(
                block.find_var_recursive(v), rank=4):
            return None
        m.v = v
        m.out = _single(nxt.output("Out"))
        if m.out is None:
            return None
        m.fwd_ops.append(nxt)
        m.fwd_anchor = nxt

        # every intermediate: exactly one writer (SSA discipline)
        for n in inter:
            if len(writers.get(n, [])) != 1:
                return None

        if not self._match_backward(m, inter, readers, protected):
            return None
        return m

    def _match_lens_mask(self, block, y, writers):
        """Recognize the additive key-padding mask layers.nn builds from a
        lengths vector (``attention_bias_from_lens``)::

            m   = sequence_mask(lens, maxlen=T)      # [B, T] of 0/1
            b   = scale(m, scale=BIG, bias=-BIG)     # 0 -> -BIG, 1 -> 0
            y   = reshape2(b, [-1, 1, 1, T])         # broadcast over H, Tq

        Returns the lengths var name, or None. The mask may be shared by
        every layer — reader counts are not checked, only the producing
        chain's shape."""
        if y is None:
            return None

        def sole_block0_writer(name, want_type):
            ws = writers.get(name, [])
            if len(ws) != 1 or ws[0][0] != 0:
                return None
            op = ws[0][1]
            return op if op.type == want_type else None

        reshape = sole_block0_writer(y, "reshape2")
        if reshape is None:
            return None
        shape = list(reshape.attrs.get("shape", []))
        if len(shape) != 4 or shape[1] != 1 or shape[2] != 1:
            return None
        bias_op = sole_block0_writer(_single(reshape.input("X")) or "",
                                     "scale")
        if bias_op is None:
            return None
        s = float(bias_op.attrs.get("scale", 1.0))
        b = float(bias_op.attrs.get("bias", 0.0))
        if not (s >= 1e6 and b == -s):
            return None
        mask_op = sole_block0_writer(_single(bias_op.input("X")) or "",
                                     "sequence_mask")
        if mask_op is None:
            return None
        return _single(mask_op.input("X"))

    def _match_backward(self, m, inter, readers, protected):
        """Walk the grad chain mirror-order from the closing matmul's
        grad back to the anchor's. Inference programs (no grad readers at
        all) match with an empty chain; anything partially differentiated
        or shared does not match."""
        fwd_set = {id(op) for op in m.fwd_ops}

        def outside_readers(name):
            return [op for b, op in readers.get(name, [])
                    if b == 0 and id(op) not in fwd_set]

        w_last = _single(m.fwd_anchor.input("X"))
        first = outside_readers(w_last)
        if not first:
            # forward-only program: no intermediate may leak to a grad op
            return not any(outside_readers(n) for n in inter)

        # grad of the closing matmul
        if len(first) != 1:
            return False
        gop = first[0]
        if gop.type != "matmul_grad" or gop.input("X") != [w_last] \
                or gop.input("Y") != [m.v]:
            return False
        m.g_out = _single(gop.input("Out@GRAD"))
        if m.g_out is None:
            return False
        m.g_v = _single(gop.output("Y@GRAD"))
        gcur = _single(gop.output("X@GRAD"))
        if gcur is None:
            return False
        m.bwd_ops.append(gop)
        m.bwd_anchor = gop

        def sole_grad_consumer(gname, want_type, x_name):
            """``gname`` must feed exactly one op: ``want_type`` with
            forward input ``x_name`` and Out@GRAD == gname."""
            if gname in protected:
                return None
            rs = readers.get(gname, [])
            if len(rs) != 1 or rs[0][0] != 0:
                return None
            op = rs[0][1]
            if op.type != want_type or op.input("X") != [x_name] \
                    or op.input("Out@GRAD") != [gname]:
                return None
            return op

        # mirror the optional forward steps in reverse
        steps = []
        for op in reversed(m.fwd_ops[:-1]):
            steps.append((op.type + "_grad", _single(op.input("X"))))
        for want_type, x_name in steps:
            gop = sole_grad_consumer(gcur, want_type, x_name)
            if gop is None:
                return False
            m.bwd_ops.append(gop)
            gcur = _single(gop.output("X@GRAD"))
            if gcur is None:
                return False
            if gop.type == "matmul_grad":  # the anchor's grad: last step
                m.g_q = _single(gop.output("X@GRAD"))
                m.g_k = _single(gop.output("Y@GRAD"))
                if gop.input("Y") != [m.k]:
                    return False
                return True
        return False

    # -- rewriting -------------------------------------------------------

    def _rewrite(self, block, m):
        lse = m.out + "@LSE"
        while block.has_var(lse):
            lse += "_"
        # shape deliberately undeclared, as in the reference: nothing
        # that runs the desc reads it, and the desc stays the reference's
        block.create_var(name=lse, shape=None, dtype="float32",
                         stop_gradient=True)
        attrs = {
            "causal": False,
            "scale": m.scale,
            "dropout_rate": m.dropout_rate,
            "op_role": int(m.fwd_anchor.attrs.get("op_role", 0)),
            # provenance: the source-op list this fusion replaced, which
            # the reference's op profiler expands the fused op back to
            # (engine-internal __ attr, stripped before the lowering
            # sees it)
            "__src_ops__": [o.type for o in m.fwd_ops],
        }
        if m.is_test:
            attrs["is_test"] = True
        if m.rng_id is not None:
            attrs["__rng_id__"] = int(m.rng_id)
        inputs = {"Q": [m.q], "K": [m.k], "V": [m.v]}
        if m.lens is not None:
            inputs["SeqLens"] = [m.lens]
        fwd_op = OpDesc("fused_attention", inputs,
                        {"Out": [m.out], "Lse": [lse]}, attrs)

        bwd_op = None
        if m.bwd_ops:
            from paddle_tpu_torch.framework import OpRole
            gattrs = dict(attrs)
            gattrs["op_role"] = int(OpRole.Backward)
            gattrs["__fwd_inputs__"] = sorted(inputs)
            gattrs["__fwd_outputs__"] = ["Lse", "Out"]
            gattrs["__src_ops__"] = [o.type for o in m.bwd_ops]
            ginputs = {s: list(ns) for s, ns in inputs.items()}
            ginputs["Out"] = [m.out]
            ginputs["Lse"] = [lse]
            ginputs["Out@GRAD"] = [m.g_out]
            goutputs = {}
            for slot, name in (("Q@GRAD", m.g_q), ("K@GRAD", m.g_k),
                               ("V@GRAD", m.g_v)):
                if name is not None:
                    goutputs[slot] = [name]
            bwd_op = OpDesc("fused_attention_grad", ginputs, goutputs,
                            gattrs)

        drop = {id(op) for op in m.fwd_ops} | {id(op) for op in m.bwd_ops}
        new_ops = []
        for op in block.ops:
            if op is m.fwd_anchor:
                new_ops.append(fwd_op)
                continue
            if bwd_op is not None and op is m.bwd_anchor:
                new_ops.append(bwd_op)
                continue
            if id(op) in drop:
                continue
            new_ops.append(op)
        block.ops = new_ops


# -- pass 2: elementwise_add + activation fusion -------------------------


_FUSABLE_ACTS = frozenset({"relu", "gelu", "tanh", "sigmoid"})


@register_pass("fuse-elemwise-act")
class ElemwiseActFusePass(TransformPass):
    """``elementwise_add`` whose sole consumer is an activation becomes
    one ``fused_elemwise_activation`` op (reference:
    operators/fused/fused_elemwise_activation_op.cc; the ir-pass analog
    is fuse_elewise_add_act_pass.cc). Halves the bias+act op count: one
    lowering call (and on the card one fewer elementwise launch) where
    there were two.

    Training programs self-block: the activation's grad op reads the
    intermediate sum (or the act output), so the single-reader rule
    leaves those sites alone. This pass therefore fires on inference /
    forward-only programs."""

    min_level = 2

    def apply(self, desc, ctx):
        block = desc.block(0)
        readers = _reader_map(desc)
        writers = _writer_map(desc)
        protected = _protected_names(desc, ctx)
        replace = {}  # id(act op) -> fused OpDesc
        drop = set()  # id(add op)
        for op in block.ops:
            if op.type != "elementwise_add" or _is_grad_op(op):
                continue
            x, y = _single(op.input("X")), _single(op.input("Y"))
            s = _single(op.output("Out"))
            if None in (x, y, s) or s in protected:
                continue
            if len(writers.get(s, [])) != 1:
                continue
            rs = readers.get(s, [])
            if len(rs) != 1 or rs[0][0] != 0:
                continue
            act = rs[0][1]
            if act.type not in _FUSABLE_ACTS or act.input("X") != [s] \
                    or id(act) in replace:
                continue
            out = _single(act.output("Out"))
            if out is None:
                continue
            attrs = {
                "functor_list": ["elementwise_add", act.type],
                "axis": op.attrs.get("axis", -1),
                "op_role": int(act.attrs.get("op_role", 0)),
                # opprof provenance: fused ops keep their source-op list
                "__src_ops__": ["elementwise_add", act.type],
            }
            # activation attrs ride along (e.g. gelu's `approximate`)
            for name, val in act.attrs.items():
                if name not in attrs and not name.startswith("__") \
                        and name not in _NONSEMANTIC_ATTRS:
                    attrs[name] = val
            replace[id(act)] = OpDesc(
                "fused_elemwise_activation",
                {"X": [x], "Y": [y]}, {"Out": [out]}, attrs)
            drop.add(id(op))
        if not replace:
            return 0
        block.ops = [
            replace.get(id(op), op) for op in block.ops
            if id(op) not in drop
        ]
        return len(replace)


# -- pass 3: constant folding --------------------------------------------


@register_pass("fold-constants")
class ConstantFoldPass(TransformPass):
    """Evaluate ops whose inputs are all ``fill_constant`` outputs and
    replace them with a single ``fill_constant`` when the result is
    uniform (reference: framework/ir/constant_folding_pass.cc). The op is
    executed through its REGISTERED lowering — the fold can not disagree
    with what the engine would have computed (here: on the CPU, the
    port's lowering of the op). Results above ``MAX_ELEMENTS`` or
    non-uniform stay unfolded: the desc only carries scalar attr values,
    and burning big dense literals into the program trades op count for
    program size. The fill's ``dtype`` attr follows the desc rule
    (``framework._DESC_DTYPE``: an int64 result is written INT32, a
    float64 one FP32, as the reference's 32-bit JAX computes them), so
    the transformed desc is the reference's byte for byte; the value the
    fill makes at run time keeps the dtype the port's lowering gave the
    result (``OpDesc.runtime_dtype``, which no serialization carries and
    ``fill_constant``'s lowering reads), so the folded program fetches
    what the unfolded one does."""

    min_level = 2
    MAX_ELEMENTS = 1 << 16

    def apply(self, desc, ctx):
        import numpy as np

        import torch

        from paddle_tpu_torch.core.registry import LowerContext, OpRegistry
        from paddle_tpu_torch.core.types import convert_np_dtype_to_dtype_
        from paddle_tpu_torch.engine.lowering import clean_attrs
        from paddle_tpu_torch.framework import _DESC_DTYPE

        block = desc.block(0)
        readers = _reader_map(desc)
        writers = _writer_map(desc)
        protected = _protected_names(desc, ctx)
        consts = {}  # var name -> producing fill_constant OpDesc
        folded = 0
        for i, op in enumerate(list(block.ops)):
            if op.type == "fill_constant" and not op.inputs:
                out = _single(op.output("Out"))
                if out is not None and len(writers.get(out, [])) == 1:
                    consts[out] = op
                continue
            out = self._foldable_output(op, readers, writers, block)
            if out is None:
                continue
            in_names = op.input_arg_names()
            if not in_names or any(n not in consts for n in in_names):
                continue
            try:
                val = self._evaluate(op, block, consts, np, OpRegistry,
                                     LowerContext, clean_attrs)
            except Exception:
                continue  # data-dependent / lowering rejected: skip
            if val is None or val.size == 0 or val.size > self.MAX_ELEMENTS:
                continue
            flat = val.reshape(-1)
            if not bool(np.all(flat == flat[0])):
                continue
            runtime = torch.from_numpy(flat[:1]).dtype
            fill = OpDesc(
                "fill_constant", {}, {"Out": [out]},
                {"shape": [int(d) for d in val.shape],
                 "dtype": int(_DESC_DTYPE.get(
                     runtime, convert_np_dtype_to_dtype_(val.dtype))),
                 "value": flat[0].item(),
                 "op_role": int(op.attrs.get("op_role", 0))})
            if runtime in _DESC_DTYPE:
                fill.runtime_dtype = runtime
            block.ops[i] = fill
            consts[out] = fill
            folded += 1
        return folded

    def _foldable_output(self, op, readers, writers, block):
        """The op's single output name if the op is safely replaceable by
        a constant, else None."""
        from paddle_tpu_torch.core.registry import OpRegistry
        if _is_grad_op(op) or op.type in ("feed", "fetch"):
            return None
        if not OpRegistry.has(op.type):
            return None
        if OpRegistry.get(op.type).needs_rng or "sub_block" in op.attrs:
            return None
        if len(op.outputs) != 1:
            return None
        out = _single(op.output(list(op.outputs)[0]))
        if out is None or out.endswith("@GRAD"):
            return None
        # a fetched output may fold (the fill writes the same name);
        # persistable state must keep its real writer
        vd = block.find_var_recursive(out)
        if vd is not None and (vd.persistable or vd.is_parameter):
            return None
        if len(writers.get(out, [])) != 1:
            return None
        # never fold what the backward pass observes
        if block.has_var(out + "@GRAD"):
            return None
        if any(_is_grad_op(r) for _, r in readers.get(out, [])):
            return None
        return out

    def _evaluate(self, op, block, consts, np, OpRegistry, LowerContext,
                  clean_attrs):
        from paddle_tpu_torch.core.types import VarType, convert_dtype_to_np

        def materialize(fill):
            attrs = fill.attrs
            np_dtype = convert_dtype_to_np(VarType(int(attrs["dtype"])))
            return np.full([int(d) for d in attrs.get("shape", [])],
                           attrs.get("value", 0.0), dtype=np_dtype)

        import torch

        ins = {slot: [torch.from_numpy(materialize(consts[n]))
                      for n in names]
               for slot, names in op.inputs.items()}
        lctx = LowerContext(op, block, "cpu", rng_seed=None, op_index=0,
                            is_test=True)
        with torch.no_grad():
            outs = OpRegistry.get(op.type).lower(lctx, ins,
                                                 clean_attrs(op.attrs))
        slot = list(op.outputs)[0]
        vals = outs.get(slot, [])
        if (len(vals) != 1 or not isinstance(vals[0], torch.Tensor)
                or vals[0].dtype == torch.bfloat16):
            return None
        return vals[0].detach().cpu().numpy()


# -- pass 4: common-subexpression elimination ----------------------------


@register_pass("cse")
class CSEPass(TransformPass):
    """Value-number block-0 ops over the def-use graph
    (analysis/graph.py): two ops with the same type, same (canonicalized)
    inputs, and same semantic attrs compute the same value — the second
    is dropped and its outputs renamed to the first's program-wide.

    Gradient safety is the sharp edge: renaming a var that a grad op
    reads does NOT rename that grad op's OUTPUT names, so gradient
    contributions would land in the wrong accumulators. An op is
    therefore eligible only when nothing on the backward side can see the
    rename: no grad op reads its outputs, no ``<out>@GRAD`` var exists,
    and its inputs are single-writer (pure SSA values, not mutated
    state)."""

    min_level = 2

    def apply(self, desc, ctx):
        from paddle_tpu_torch.analysis.graph import build_graph

        graph = build_graph(desc)
        n_writers = {}
        grad_read = set()
        for v in graph.all_vars():
            n_writers[v.name] = max(n_writers.get(v.name, 0),
                                    len(v.writers))
            if any(_is_grad_op(r.desc) for r in v.readers):
                grad_read.add(v.name)

        block = desc.block(0)
        protected = _protected_names(desc, ctx)
        rename = {}  # dup output name -> canonical output name
        seen = {}    # value-number key -> canonical OpDesc
        drop = set()
        for node in graph.block_ops(0):
            op = node.desc
            if not self._eligible(op, block, protected, n_writers,
                                  grad_read):
                continue
            key = self._value_key(op, rename)
            canon = seen.get(key)
            if canon is None:
                seen[key] = op
                continue
            for slot in op.outputs:
                for a, b in zip(canon.output(slot), op.output(slot)):
                    if a != b:
                        rename[b] = a
            drop.add(id(op))
        if not drop:
            return 0
        for b in desc.blocks:
            for op in b.ops:
                if id(op) in drop:
                    continue
                op.inputs = {
                    slot: [rename.get(n, n) for n in names]
                    for slot, names in op.inputs.items()
                }
        block.ops = [op for op in block.ops if id(op) not in drop]
        return len(drop)

    def _eligible(self, op, block, protected, n_writers, grad_read):
        from paddle_tpu_torch.core.registry import OpRegistry
        if op.type in ("feed", "fetch") or _is_grad_op(op):
            return False
        if not OpRegistry.has(op.type):
            return False
        if OpRegistry.get(op.type).needs_rng or "sub_block" in op.attrs:
            return False
        if not op.outputs:
            return False  # side-effect op: nothing to merge on
        for n in op.output_arg_names():
            if (n in protected or n.endswith("@GRAD")
                    or n_writers.get(n, 0) != 1 or n in grad_read
                    or block.has_var(n + "@GRAD")):
                return False
        for n in op.input_arg_names():
            if n_writers.get(n, 0) > 1:
                return False  # reads mutated state, not an SSA value
        return True

    def _value_key(self, op, rename):
        return (
            op.type,
            tuple(sorted(
                (slot, tuple(rename.get(n, n) for n in names))
                for slot, names in op.inputs.items())),
            tuple(sorted(
                (slot, len(names)) for slot, names in op.outputs.items())),
            tuple(sorted(
                (k, repr(v)) for k, v in op.attrs.items()
                if k not in _NONSEMANTIC_ATTRS and not k.startswith("__"))),
            str(getattr(op, "runtime_dtype", "")),
        )


# Imported last so the layout pass can subclass TransformPass; the import
# itself is what registers "layout-assign" in PASS_REGISTRY.
from paddle_tpu_torch.analysis import layout as _layout  # noqa: E402,F401
