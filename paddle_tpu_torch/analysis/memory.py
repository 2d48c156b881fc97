"""Memory-planning passes: liveness, donation hints, auto-remat — port
of ``paddle_tpu/analysis/memory.py``; every plan is the reference's on
the same desc.

The desc-level mirror of the reference's ``memory_optimize``/inplace
passes and scope garbage collector (reference:
paddle/fluid/framework/details/memory_optimize_pass.cc and
transpiler/memory_optimization_transpiler.py, which reuse buffers by
lifetime analysis; framework/executor.cc's GC frees a var after its last
reader). On the card torch's caching allocator reuses the buffers, so
the levers that remain at the engine seam are:

* **Liveness analysis** (``analyze_liveness``): per-var live intervals
  over the def-use graph's global program order, a peak-bytes estimate
  from an event sweep, and the top contributors live at the peak — the
  report every other plan consumes.
* **Donation planning** (``plan_donation``): which mutated state vars
  (optimizer moments, BN stats, params under update) are safe to update
  in place. Safe = re-emitted by the step AND never fetched (a donated
  buffer may be reused for any output, so a fetch of the same name must
  pin it), declared as a dense tensor, and not read by a sub-block op.
* **Automatic rematerialization** (``plan_remat``): choose the
  checkpoint segment count of ``engine/lowering.py``
  ``lower_block_remat`` from the liveness profile instead of the
  hand-set ``remat_segments`` knob — remat fires only when the
  estimated peak exceeds the memory budget
  (``device_memory_limit() * PADDLE_GPU_HBM_BUDGET_FRAC``), and the
  segment count is the smallest power of two whose estimated peak fits.

``plan_memory`` composes the three into a ``MemoryPlan`` the engine runs
at its cache-miss seam at ``opt_level`` 3 and up (see
engine/executor.py); on the card a plan's predicted peak is compared
with the measured one, ``torch.cuda.max_memory_allocated`` around the
entry's eager first run (the ``memory_plan_delta`` event), and
``replan_segments`` corrects the segment count from it.
"""

import numpy as np

from paddle_tpu_torch.analysis.graph import GRAD_SUFFIX, build_graph
from paddle_tpu_torch.core.types import VarType, convert_dtype_to_np

__all__ = [
    "LiveInterval", "LivenessReport", "DonationPlan", "RematPlan",
    "MemoryPlan", "analyze_liveness", "plan_donation", "plan_remat",
    "replan_segments", "plan_memory", "hbm_budget_bytes",
]

# Mirrors framework.OpRole (reference: op_proto_maker.h) without the
# import cycle: analysis must stay importable standalone.
_ROLE_BACKWARD = 0x0001
_ROLE_OPTIMIZE = 0x0002
_ROLE_TAIL = 0x0002 | 0x0004 | 0x0008 | 0x0010  # Optimize|RPC|Dist|LRSched

# Var kinds that never hold a dense tensor at run time (passes.py keeps
# the authoritative set; this is the subset relevant to byte accounting).
_NON_TENSOR_TYPES = frozenset({
    VarType.READER, VarType.RAW, VarType.STEP_SCOPES,
    VarType.LOD_RANK_TABLE, VarType.PLACE_LIST, VarType.FEED_MINIBATCH,
    VarType.FETCH_LIST, VarType.TUPLE,
})

# Producers whose recompute is bandwidth-ish rather than FLOP-heavy —
# ranked first in the remat report (policy: remat cheap-to-recompute,
# large-footprint producers first; the matmul/conv outputs are the
# expensive tail a segment boundary should try to keep).
_CHEAP_RECOMPUTE_OPS = frozenset({
    "relu", "gelu", "sigmoid", "tanh", "softmax", "scale", "dropout",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "layer_norm", "batch_norm", "reshape", "reshape2", "transpose",
    "transpose2", "concat", "split", "slice", "cast", "clip",
    "fused_elementwise_activation", "square", "sqrt", "mean",
    "reduce_mean", "reduce_sum", "fill_constant", "one_hot", "stack",
    "unsqueeze", "squeeze", "lookup_table",
})


def _var_nbytes(var_node, dim_hints, default_dim=1):
    """Static byte size of a var from its VarDesc, or 0 when unknowable
    (undeclared, non-tensor, shapeless). Dynamic ``-1`` dims resolve from
    ``dim_hints`` (name -> concrete shape, usually the feed shapes) or
    fall back to ``default_dim`` — the estimate stays a lower bound
    rather than guessing a batch."""
    vd = var_node.desc
    if vd is None or vd.type in _NON_TENSOR_TYPES:
        return 0
    shape = vd.shape
    if shape is None:
        return 0
    hint = dim_hints.get(var_node.name)
    n = 1
    for i, d in enumerate(shape):
        d = int(d) if d is not None else -1
        if d < 0:
            if hint is not None and i < len(hint):
                d = int(hint[i])
            else:
                d = default_dim
        n *= max(d, 0)
    try:
        itemsize = np.dtype(convert_dtype_to_np(vd.dtype)).itemsize
    except Exception:
        itemsize = 4
    return n * itemsize


class LiveInterval:
    """One var's lifetime in global program order: ``[start, end]``
    inclusive, both op orders; persistable state is pinned for the whole
    program (the scope holds it across steps)."""

    __slots__ = ("name", "start", "end", "nbytes", "persistable")

    def __init__(self, name, start, end, nbytes, persistable):
        self.name = name
        self.start = start
        self.end = end
        self.nbytes = nbytes
        self.persistable = persistable

    def __repr__(self):
        return "LiveInterval(%s [%d,%d] %dB%s)" % (
            self.name, self.start, self.end, self.nbytes,
            " persistable" if self.persistable else "")


class LivenessReport:
    def __init__(self, intervals, peak_bytes, peak_order, n_orders):
        self.intervals = intervals  # name -> LiveInterval
        self.peak_bytes = peak_bytes
        self.peak_order = peak_order
        self.n_orders = n_orders

    def live_at(self, order):
        return [iv for iv in self.intervals.values()
                if iv.start <= order <= iv.end and iv.nbytes > 0]

    def top_contributors(self, n=10):
        """The vars live at the peak, largest first — the report line
        that tells you WHAT to remat/donate/shrink."""
        at_peak = self.live_at(self.peak_order)
        at_peak.sort(key=lambda iv: (-iv.nbytes, iv.name))
        return at_peak[:n]

    def render(self, top=10):
        lines = ["liveness: %d vars tracked over %d ops, peak %s at op "
                 "order %d" % (len(self.intervals), self.n_orders,
                               _fmt_bytes(self.peak_bytes),
                               self.peak_order)]
        for iv in self.top_contributors(top):
            lines.append("  %-12s %-40s live [%d, %d]%s" % (
                _fmt_bytes(iv.nbytes), iv.name, iv.start, iv.end,
                "  (persistable)" if iv.persistable else ""))
        return "\n".join(lines)


def analyze_liveness(graph_or_program, feed_shapes=None, default_dim=None):
    """Liveness over the def-use graph: each tracked var is born at its
    first writer (order 0 for feeds/persistables/scope state — they
    arrive materialized) and dies after its last reader/writer
    (program end for persistables and grads of persistables' updates
    written back to the scope). Peak bytes come from an event sweep over
    the interval set."""
    graph = (graph_or_program if hasattr(graph_or_program, "op_nodes")
             else build_graph(graph_or_program))
    feed_shapes = feed_shapes or {}
    if default_dim is None:
        # dynamic -1 dims on activations are the batch the data layers
        # declare; the largest leading feed dim is that batch
        default_dim = max((int(s[0]) for s in feed_shapes.values()
                           if len(s) and int(s[0]) > 0), default=1)
    max_order = max((op.order for op in graph.op_nodes), default=0)

    intervals = {}
    for v in graph.all_vars():
        if not v.writers and not v.readers:
            continue  # declared but unreferenced — never materialized
        nbytes = _var_nbytes(v, feed_shapes, default_dim=default_dim)
        persistable = v.persistable
        if persistable or not v.writers or v.name in feed_shapes:
            start = 0
        else:
            start = min(w.order for w in v.writers)
        accesses = [o.order for o in v.writers] + [o.order for o in v.readers]
        end = max_order if persistable else max(accesses)
        # last-writer-only vars (unfetched state_out) still occupy their
        # buffer until the write happens; interval is [start, end] as-is
        if v.name in intervals:
            # same name in two blocks: merge conservatively
            old = intervals[v.name]
            intervals[v.name] = LiveInterval(
                v.name, min(old.start, start), max(old.end, end),
                max(old.nbytes, nbytes), old.persistable or persistable)
        else:
            intervals[v.name] = LiveInterval(v.name, start, end, nbytes,
                                             persistable)

    # event sweep: +bytes at start, -bytes after end
    births, deaths = {}, {}
    for iv in intervals.values():
        if iv.nbytes <= 0:
            continue
        births[iv.start] = births.get(iv.start, 0) + iv.nbytes
        deaths[iv.end + 1] = deaths.get(iv.end + 1, 0) + iv.nbytes
    peak, peak_order, running = 0, 0, 0
    for order in range(0, max_order + 2):
        running += births.get(order, 0) - deaths.get(order, 0)
        if running > peak:
            peak, peak_order = running, order
    return LivenessReport(intervals, peak, peak_order, max_order + 1)


class DonationPlan:
    """``donate``: state vars safe to pass as donated buffers (their last
    use is the in-place-safe re-emit of the same name). ``held``: mutated
    vars kept undonated, name -> one-line reason."""

    def __init__(self, donate, held):
        self.donate = frozenset(donate)
        self.held = dict(held)

    def render(self):
        lines = ["donation: %d donated, %d held"
                 % (len(self.donate), len(self.held))]
        for n in sorted(self.donate):
            lines.append("  donate %s" % n)
        for n, why in sorted(self.held.items()):
            lines.append("  hold   %s (%s)" % (n, why))
        return "\n".join(lines)


def plan_donation(graph, state_in_names, state_out_names, fetch_names):
    """Split the mutated state (read AND re-emitted) into donate vs held.
    The safety property the tests pin: a donated buffer never aliases a
    live fetch — any name in the fetch list is held, so user-visible
    results never share storage with an in-place update."""
    out_set = set(state_out_names)
    fetch_set = set(fetch_names or ())
    donate, held = [], {}
    for name in state_in_names:
        if name not in out_set:
            continue  # read-only state is never donated anyway
        if name in fetch_set:
            held[name] = "fetched: donated buffer may alias any output"
            continue
        v = graph.var(0, name)
        if v is None or v.desc is None:
            held[name] = "no VarDesc: cannot prove dense-tensor storage"
            continue
        if v.desc.type in _NON_TENSOR_TYPES:
            held[name] = "non-tensor var kind %s" % getattr(
                v.desc.type, "name", v.desc.type)
            continue
        if any(r.block_idx != 0 for r in v.readers):
            held[name] = "read inside a sub-block"
            continue
        donate.append(name)
    return DonationPlan(donate, held)


class RematPlan:
    def __init__(self, n_segments, activation_bytes, est_peak_bytes,
                 candidates, reason):
        self.n_segments = n_segments
        self.activation_bytes = activation_bytes
        self.est_peak_bytes = est_peak_bytes
        # [(name, nbytes, producer_op_type, cheap_recompute)]
        self.candidates = candidates
        self.reason = reason

    def render(self, top=10):
        lines = ["remat: %s (%s); backward-activation footprint %s, "
                 "est peak %s"
                 % (("%d segments" % self.n_segments) if self.n_segments
                    else "off", self.reason,
                    _fmt_bytes(self.activation_bytes),
                    _fmt_bytes(self.est_peak_bytes))]
        for name, nb, prod, cheap in self.candidates[:top]:
            lines.append("  %-12s %-40s <- %s%s" % (
                _fmt_bytes(nb), name, prod,
                "  (cheap recompute)" if cheap else ""))
        return "\n".join(lines)


def plan_remat(graph, liveness, budget_bytes, max_segments=32):
    """Choose the checkpoint segment count from the liveness profile.

    The cost model matches what ``lower_block_remat`` actually builds —
    ``n`` contiguous checkpointed segments over the forward, so of
    the backward-activation footprint ``A`` only the segment boundaries
    (~``A/n``) survive to the backward plus one segment's internals
    (~``A/n``) are live during its recompute: ``est(n) = peak - A +
    2A/n``. The chosen ``n`` is the smallest power of two whose estimate
    fits the budget (fewer segments = less recompute), clamped to
    ``max_segments`` when nothing fits."""
    bwd_ops = [op for op in graph.op_nodes
               if op.role() & _ROLE_BACKWARD]
    if not bwd_ops:
        return RematPlan(0, 0, liveness.peak_bytes, [],
                         "no Backward-role ops (inference program)")

    # backward activations: non-persistable forward products a Backward
    # op re-reads — exactly what a checkpointed segment drops and recomputes
    candidates = []
    activation_bytes = 0
    for v in graph.all_vars():
        if v.persistable or v.name.endswith(GRAD_SUFFIX):
            continue
        if not v.writers or not any(r.role() & _ROLE_BACKWARD
                                    for r in v.readers):
            continue
        writer = v.writers[0]
        if writer.role() & (_ROLE_BACKWARD | _ROLE_TAIL):
            continue
        iv = liveness.intervals.get(v.name)
        nb = iv.nbytes if iv is not None else 0
        if nb <= 0:
            continue
        activation_bytes += nb
        candidates.append((v.name, nb, writer.type,
                           writer.type in _CHEAP_RECOMPUTE_OPS))
    # policy order: cheap-to-recompute, large-footprint first
    candidates.sort(key=lambda c: (not c[3], -c[1], c[0]))

    if budget_bytes is None or budget_bytes <= 0:
        return RematPlan(0, activation_bytes, liveness.peak_bytes,
                         candidates, "no HBM budget (device limit unknown)")
    if activation_bytes <= 0:
        return RematPlan(0, 0, liveness.peak_bytes, [],
                         "no rematerializable backward activations")
    if liveness.peak_bytes <= budget_bytes:
        return RematPlan(0, activation_bytes, liveness.peak_bytes,
                         candidates,
                         "estimated peak fits the budget (%s <= %s)"
                         % (_fmt_bytes(liveness.peak_bytes),
                            _fmt_bytes(budget_bytes)))

    base = liveness.peak_bytes - activation_bytes

    def est(n):
        return base + (2 * activation_bytes + n - 1) // n

    # degenerate case: a peak dominated by persistables (params/moments)
    # that even max segmentation cannot bring under budget, with an
    # activation footprint too small to matter — checkpointing would add
    # recompute and fusion barriers for <1% relief, so stay off
    if (est(max_segments) > budget_bytes
            and activation_bytes * 100 < liveness.peak_bytes):
        return RematPlan(
            0, activation_bytes, liveness.peak_bytes, candidates,
            "budget unreachable: activation footprint %s is <1%% of the "
            "%s peak (persistable-dominated)"
            % (_fmt_bytes(activation_bytes),
               _fmt_bytes(liveness.peak_bytes)))

    n = 2
    while n < max_segments and est(n) > budget_bytes:
        n *= 2
    n = min(n, max_segments)
    fits = est(n) <= budget_bytes
    return RematPlan(
        n, activation_bytes, est(n), candidates,
        "peak %s over budget %s -> %d segments (est %s%s)"
        % (_fmt_bytes(liveness.peak_bytes), _fmt_bytes(budget_bytes), n,
           _fmt_bytes(est(n)), "" if fits else ", still over — clamped"))


def replan_segments(plan, measured_bytes, budget_bytes, max_segments=32):
    """Re-run the remat segment search with the cost model rescaled by
    the REALIZED peak (the engine's ``memory_plan_delta`` measurement).

    The static model under- or over-counts by whatever the allocator and
    scheduling actually did; the simplest measurement-driven correction
    is a multiplicative one: scale every term of ``est(n) = base + 2A/n``
    by ``ratio = measured / predicted`` so the model reproduces the
    observation at the current segment count, then re-run the same
    power-of-two search against the unchanged budget. Returns a
    ``RematPlan`` whose ``est_peak_bytes`` is in MEASURED units; its
    ``n_segments`` may be 0 (the realized peak fits without remat), equal
    to the old count (measurement confirms the plan — caller should skip
    the rebuild), or a different power of two."""
    remat = plan.remat if isinstance(plan, MemoryPlan) else plan
    predicted = (plan.predicted_peak_bytes
                 if isinstance(plan, MemoryPlan)
                 else remat.est_peak_bytes)
    measured = int(measured_bytes)
    if measured <= 0 or predicted <= 0:
        return RematPlan(remat.n_segments, remat.activation_bytes,
                         predicted, remat.candidates,
                         "replan skipped: no usable measurement")
    if budget_bytes is None or budget_bytes <= 0:
        return RematPlan(remat.n_segments, remat.activation_bytes,
                         predicted, remat.candidates,
                         "replan skipped: no HBM budget")
    ratio = float(measured) / float(predicted)
    A = remat.activation_bytes
    if A <= 0:
        return RematPlan(0, 0, measured, remat.candidates,
                         "replan: no rematerializable activations "
                         "(measured %s)" % _fmt_bytes(measured))
    # invert the current estimate back to the model's unsegmented peak,
    # then rescale: est'(n) = ratio * (base + ceil(2A/n))
    n_now = remat.n_segments
    base = predicted - ((2 * A + n_now - 1) // n_now if n_now else A)
    unsegmented = ratio * (base + A)

    def est(n):
        return int(ratio * (base + (2 * A + n - 1) // n))

    if unsegmented <= budget_bytes:
        return RematPlan(
            0, A, int(unsegmented), remat.candidates,
            "replan: measured %s (x%.2f of predicted) -> unsegmented "
            "peak %s fits budget %s"
            % (_fmt_bytes(measured), ratio, _fmt_bytes(int(unsegmented)),
               _fmt_bytes(budget_bytes)))
    n = 2
    while n < max_segments and est(n) > budget_bytes:
        n *= 2
    n = min(n, max_segments)
    fits = est(n) <= budget_bytes
    return RematPlan(
        n, A, est(n), remat.candidates,
        "replan: measured %s vs predicted %s (x%.2f) -> %d segments "
        "(est %s%s)"
        % (_fmt_bytes(measured), _fmt_bytes(predicted), ratio, n,
           _fmt_bytes(est(n)), "" if fits else ", still over — clamped"))


class MemoryPlan:
    """The composed plan the engine consumes at its cache-miss seam."""

    def __init__(self, liveness, donation, remat):
        self.liveness = liveness
        self.donation = donation
        self.remat = remat

    @property
    def predicted_peak_bytes(self):
        if self.remat is not None and self.remat.n_segments:
            return self.remat.est_peak_bytes
        return self.liveness.peak_bytes

    def render(self, top=10):
        parts = [self.liveness.render(top=top)]
        if self.donation is not None:
            parts.append(self.donation.render())
        if self.remat is not None:
            parts.append(self.remat.render(top=top))
        parts.append("predicted peak: %s"
                     % _fmt_bytes(self.predicted_peak_bytes))
        return "\n".join(parts)


def _derive_state_names(graph, feed_names):
    """BlockProgram's state derivation re-read off the graph (block 0,
    program order): state_in = read before written and not fed;
    state_out = persistable vars written."""
    feed_set = set(feed_names or ())
    written = set()
    state_in, state_out = [], []
    seen_out = set()
    for op in graph.block_ops(0):
        for _, v in op.in_edges:
            if (v.name not in written and v.name not in feed_set
                    and v.name not in state_in):
                state_in.append(v.name)
        for _, v in op.out_edges:
            written.add(v.name)
            if v.persistable and v.name not in seen_out:
                state_out.append(v.name)
                seen_out.add(v.name)
    return state_in, state_out


def hbm_budget_bytes():
    """The auto-remat byte budget: ``device_memory_limit() *
    PADDLE_GPU_HBM_BUDGET_FRAC``, or None when the device limit is
    unknowable (no budget -> auto-remat stays off; the
    PADDLE_GPU_DEVICE_MEMORY_BYTES override makes it deterministic on
    backends that report nothing, e.g. the CPU test mesh)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.observability.memory import device_memory_limit

    limit = device_memory_limit()
    if not limit:
        return None
    frac = float(flags.get_flag("hbm_budget_frac"))
    if frac <= 0:
        return None
    return int(limit * frac)


def plan_memory(program_or_desc, feed_shapes=None, fetch_names=None,
                budget_bytes=None, max_segments=32, default_dim=None,
                state_in_names=None, state_out_names=None):
    """One-call planner: liveness -> donation -> remat -> MemoryPlan.
    ``state_in_names``/``state_out_names`` default to the graph-derived
    sets (what BlockProgram will compute at lowering time);
    ``default_dim`` (the resolution for dynamic ``-1`` dims on
    activations) defaults to the largest leading feed dim — the batch
    every data-layer var carries."""
    graph = build_graph(program_or_desc)
    liveness = analyze_liveness(graph, feed_shapes=feed_shapes,
                                default_dim=default_dim)
    if state_in_names is None or state_out_names is None:
        d_in, d_out = _derive_state_names(graph, feed_shapes or {})
        state_in_names = d_in if state_in_names is None else state_in_names
        state_out_names = (d_out if state_out_names is None
                           else state_out_names)
    donation = plan_donation(graph, state_in_names, state_out_names,
                             fetch_names or ())
    remat = plan_remat(graph, liveness, budget_bytes,
                       max_segments=max_segments)
    return MemoryPlan(liveness, donation, remat)


def _fmt_bytes(n):
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return "%dB" % int(n) if unit == "B" else "%.2f%s" % (n, unit)
        n /= 1024.0


# -- registry checker -------------------------------------------------------
# Registered (so lint/verify tooling can opt in) but NOT in
# DEFAULT_PASSES: it reports facts, not defects.
from paddle_tpu_torch.analysis.passes import Pass, register_pass
from paddle_tpu_torch.analysis.diagnostics import Severity


@register_pass("memory-liveness")
class MemoryLivenessPass(Pass):
    """INFO-only reporter: peak-bytes estimate + the top contributor, so
    a ``--verify`` or lint run surfaces the memory profile next to the
    correctness findings."""

    def check(self, graph, ctx):
        feed_shapes = {}
        rep = analyze_liveness(graph, feed_shapes=feed_shapes)
        findings = [self.finding(
            Severity.INFO,
            "estimated peak %s at op order %d (%d tracked vars)"
            % (_fmt_bytes(rep.peak_bytes), rep.peak_order,
               len(rep.intervals)),
            hint="tools/lint_program.py --memory prints the full report")]
        top = rep.top_contributors(1)
        if top:
            findings.append(self.finding(
                Severity.INFO,
                "largest live buffer at peak: %s (%s)"
                % (top[0].name, _fmt_bytes(top[0].nbytes)),
                var_names=[top[0].name]))
        return findings
