"""Program freezing: trained ProgramDesc -> verified inference-only desc
(port of ``paddle_tpu/inference/freeze.py``; the frozen desc and the
folded weights are the reference's, byte for byte and bit for bit).

Two transform passes on the analysis.transforms registry, driven through
the crash-isolated ``optimize_program`` pipeline (a pass that blows up
discards its half-mutated clone instead of corrupting the program):

* ``strip-training`` — drops every op whose role marks it
  backward/optimizer/lr-schedule (the desc-level analog of
  ``Program.clone(for_test=True)``, but usable on a deserialized desc
  with no Python wrapper state) and flips every ``is_test``-aware op
  into test mode.
* ``fold-batch-norm`` — folds inference-mode batch_norm into the
  preceding conv/fc weights: ``W'_o = W_o * gamma_o / sqrt(var_o + eps)``
  and the BN op collapses to one bias ``elementwise_add`` with
  ``b'_o = beta_o - mean_o * gamma_o / sqrt(var_o + eps)``. Needs the
  trained parameter values, so it only fires when the TransformContext
  carries a scope; the folded tensors are baked into that scope as new
  persistable vars (the originals survive untouched for the training
  program).

``freeze_program`` runs both (plus the standard fuse/fold/cse pipeline
at ``level >= 2``), prunes to the fetch cone, garbage-collects orphaned
VarDescs, re-verifies the result with the analysis checkers, and returns
an inference-only Program (reference: the fork's freeze +
inference_transpiler conv_bn fuse; TF freeze_graph per arXiv:1605.08695's
train-graph/serve-graph split).
"""

import numpy as np

from paddle_tpu_torch.analysis.passes import register_pass
from paddle_tpu_torch.analysis.transforms import (
    TransformPass,
    _prune_dead_ops,
    _reader_map,
    _single,
    _writer_map,
    optimize_program,
    transform_passes,
)
from paddle_tpu_torch.core.desc import OpDesc
from paddle_tpu_torch.core.types import VarType
from paddle_tpu_torch.framework import OP_ROLE_KEY, OpRole, program_from_desc

def host_array(value, dtype=None):
    """A scope or feed value as a numpy array (a torch tensor, on any
    device, is copied to the host; a bfloat16 one comes back float32)."""
    import torch

    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        value = value.cpu().numpy()
    return np.asarray(value, dtype)


_TRAIN_ROLES = int(OpRole.Backward) | int(OpRole.Optimize) \
    | int(OpRole.LRSched)

# producer op type -> the input slot holding the foldable weight
_FOLDABLE = {"conv2d": "Filter", "depthwise_conv2d": "Filter", "mul": "Y"}

# batch_norm output slots that must be dead for the fold to be legal
_BN_SIDE_OUTPUTS = ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance")


@register_pass("strip-training")
class StripTrainingPass(TransformPass):
    """Drop backward/optimizer/lr-sched ops by role and force test mode.

    Counts removed ops + flipped attrs as rewrites so the pipeline's
    fetch-cone prune runs afterwards (pruning is what actually removes
    the loss/metric subgraph a serving fetch list does not need)."""

    min_level = 1

    def apply(self, desc, ctx):
        n = 0
        for b in desc.blocks:
            kept = []
            for op in b.ops:
                role = int(op.attrs.get(OP_ROLE_KEY, 0) or 0)
                if role & _TRAIN_ROLES or op.type.endswith("_grad"):
                    n += 1
                    continue
                kept.append(op)
            if len(kept) != len(b.ops):
                b.ops = kept
        for b in desc.blocks:
            for op in b.ops:
                aware = "is_test" in op.attrs or op.type in (
                    "dropout", "batch_norm", "lrn")
                if aware and not op.attrs.get("is_test"):
                    op.attrs["is_test"] = True
                    n += 1
        return n


@register_pass("fold-batch-norm")
class FoldBatchNormPass(TransformPass):
    """Fold inference-mode batch_norm into the producing conv/fc weight.

    Fires only when ``ctx.scope`` holds the trained values, the BN's
    input is produced by exactly one conv2d/depthwise_conv2d/mul and
    read by nothing else (scaling the producer's weight changes that
    var's value for every reader), and the BN's statistics outputs are
    dead. Folded weight/bias land in the scope under ``<name>.bnfold``
    names; the BN op is replaced by one channel-wise elementwise_add."""

    min_level = 1

    def apply(self, desc, ctx):
        scope = getattr(ctx, "scope", None)
        if scope is None:
            return 0
        readers = _reader_map(desc)
        writers = _writer_map(desc)
        protected = set(ctx.feed_names) | set(ctx.fetch_names)
        n = 0
        for b in desc.blocks:
            for i, op in enumerate(list(b.ops)):
                if op.type != "batch_norm":
                    continue
                if not (op.attrs.get("is_test")
                        or op.attrs.get("use_global_stats")):
                    continue
                folded = self._try_fold(desc, b, i, op, scope, readers,
                                        writers, protected)
                if folded:
                    n += 1
        return n

    def _try_fold(self, desc, block, op_idx, op, scope, readers, writers,
                  protected):
        x = _single(op.input("X"))
        y = _single(op.output("Y"))
        if x is None or y is None or x in protected:
            return False
        wrote = writers.get(x, ())
        if len(wrote) != 1:
            return False
        _, producer = wrote[0]
        w_slot = _FOLDABLE.get(producer.type)
        if w_slot is None or producer not in block.ops:
            return False
        # folding rescales the producer's output: every read of x must
        # be this BN (replaced below by the bias add, which is fine)
        if any(rop is not op for _, rop in readers.get(x, ())):
            return False
        # the BN statistics outputs must be dead (true for any is_test
        # graph; a fetch of SavedMean would silently change otherwise)
        for slot in _BN_SIDE_OUTPUTS:
            for name in op.output(slot):
                if any(rop is not op for _, rop in readers.get(name, ())):
                    return False
        w_name = _single(producer.input(w_slot))
        vals = {}
        for slot in ("Scale", "Bias", "Mean", "Variance"):
            v = scope.get(_single(op.input(slot)))
            if v is None:
                return False
            vals[slot] = host_array(v, np.float32)
        w = scope.get(w_name)
        if w is None:
            return False
        w = host_array(w, np.float32)
        eps = float(op.attrs.get("epsilon", 1e-5))
        alpha = vals["Scale"] / np.sqrt(vals["Variance"] + eps)
        if w.ndim == 4:            # conv OIHW: scale per output channel O
            # a layout-enabled compile (analysis/layout.py) may have
            # baked this filter HWIO in the scope; fold in OIHW and let
            # the layout pass re-bake the .bnfold weight on its own
            # terms when the frozen program compiles with layout on
            w_vd0 = block.find_var_recursive(w_name)
            declared = tuple(w_vd0.shape) \
                if w_vd0 is not None and w_vd0.shape else tuple(w.shape)
            hwio = tuple(declared[i] for i in (2, 3, 1, 0))
            if (w_name in getattr(scope, "_layout_hwio", ())
                    or (tuple(w.shape) == hwio
                        and tuple(w.shape) != declared)):
                w = np.transpose(w, (3, 2, 0, 1))  # HWIO -> OIHW
            if alpha.shape[0] != w.shape[0]:
                return False
            w_f = w * alpha.reshape(-1, 1, 1, 1)
        elif w.ndim == 2:          # fc [K, N]: scale per output column N
            if alpha.shape[0] != w.shape[1]:
                return False
            w_f = w * alpha.reshape(1, -1)
        else:
            return False
        beta = (vals["Bias"] - vals["Mean"] * alpha).astype(np.float32)

        wf_name = _fresh_name(block, w_name + ".bnfold")
        b_name = _fresh_name(block, y + ".bnfold_bias")
        w_vd = block.find_var_recursive(w_name)
        block.create_var(
            wf_name, shape=list(w_f.shape),
            dtype=w_vd.dtype if w_vd is not None else VarType.FP32,
            persistable=True, stop_gradient=True)
        block.create_var(b_name, shape=[int(beta.shape[0])],
                         dtype=VarType.FP32, persistable=True,
                         stop_gradient=True)
        scope.set(wf_name, w_f.astype(np.float32))
        scope.set(b_name, beta)
        producer.inputs[w_slot] = [wf_name]
        # opprof provenance: the producer now carries the folded BN's
        # scale, and the replacement bias add IS the folded BN — both
        # record it in their source-op list for the attribution table
        producer.attrs["__src_ops__"] = list(
            producer.attrs.get("__src_ops__") or [producer.type]
        ) + ["batch_norm"]
        role = int(op.attrs.get(OP_ROLE_KEY, 0) or 0)
        block.ops[op_idx] = OpDesc(
            "elementwise_add",
            inputs={"X": [x], "Y": [b_name]},
            outputs={"Out": [y]},
            attrs={"axis": 1, OP_ROLE_KEY: role,
                   "__src_ops__": ["batch_norm"]},
        )
        return True


def _fresh_name(block, base):
    name, k = base, 0
    while block.find_var_recursive(name) is not None:
        k += 1
        name = "%s_%d" % (base, k)
    return name


def _gc_dead_vars(desc, keep):
    """Drop VarDescs no op references (stripped gradients, pre-fold
    weights, BN statistics): the frozen artifact should not ship tensors
    the serving graph never reads."""
    referenced = set(keep)
    for b in desc.blocks:
        for op in b.ops:
            for names in list(op.inputs.values()) + list(op.outputs.values()):
                referenced.update(names)
    removed = 0
    for b in desc.blocks:
        for name in list(b.vars):
            if name not in referenced:
                del b.vars[name]
                removed += 1
    return removed


class FreezeReport:
    """What freezing did: op/var counts before and after, BN folds,
    plus the underlying TransformReport (per-pass rewrites/crashes and
    the fetch-cone prune count)."""

    def __init__(self, transform_report, before_ops, before_vars,
                 after_ops, after_vars, bn_folds, gc_vars):
        self.transform_report = transform_report
        self.before_ops = before_ops
        self.before_vars = before_vars
        self.after_ops = after_ops
        self.after_vars = after_vars
        self.bn_folds = bn_folds
        self.gc_vars = gc_vars

    def render(self):
        lines = [
            "freeze: ops %d -> %d, vars %d -> %d, %d batch-norm fold(s), "
            "%d orphaned var(s) collected"
            % (self.before_ops, self.after_ops, self.before_vars,
               self.after_vars, self.bn_folds, self.gc_vars),
            self.transform_report.render(),
        ]
        return "\n".join(lines)


def _counts(desc):
    return (sum(len(b.ops) for b in desc.blocks),
            sum(len(b.vars) for b in desc.blocks))


def freeze_program(program, feed_names, fetch_names, scope=None,
                   fold_batch_norm=True, verify=True, level=None):
    """Freeze a trained program for serving.

    Returns ``(frozen_program, FreezeReport)``. ``frozen_program`` is a
    new inference-only Program (``_is_test`` set, training ops stripped,
    pruned to the cone of ``fetch_names``, BN folded when ``scope``
    holds the trained parameters). The input program/scope are never
    mutated — folded weights are ADDED to the scope under new names.

    ``level`` >= 2 additionally runs the standard transform pipeline
    (fusion / constant folding / cse) on the frozen desc. ``verify``
    re-runs the analysis checkers on the result and raises
    ``VerificationError`` on any ERROR finding.
    """
    desc = getattr(program, "desc", program)
    if scope is None:
        from paddle_tpu_torch.executor import global_scope

        scope = global_scope()
    before_ops, before_vars = _counts(desc)
    lvl = 1 if level is None else int(level)
    passes = [StripTrainingPass()]
    if fold_batch_norm:
        passes.append(FoldBatchNormPass())
    if lvl >= 2:
        passes.extend(transform_passes(lvl))
    out_desc, report = optimize_program(
        desc, level=max(lvl, 1), feed_names=feed_names,
        fetch_names=fetch_names, passes=passes, scope=scope)
    bn_folds = report.rewrites.get("fold-batch-norm", 0)
    if out_desc is desc:
        # nothing rewrote (already-frozen input): still prune + gc a clone
        out_desc = desc.clone()
        if fetch_names:
            report.pruned += _prune_dead_ops(out_desc, set(fetch_names))
    gc_vars = _gc_dead_vars(out_desc,
                            set(feed_names or ()) | set(fetch_names or ()))
    after_ops, after_vars = _counts(out_desc)
    freeze_report = FreezeReport(report, before_ops, before_vars,
                                 after_ops, after_vars, bn_folds, gc_vars)
    if verify:
        from paddle_tpu_torch.analysis import verify_program

        verify_program(out_desc, feed_names=feed_names,
                       fetch_names=fetch_names, raise_on_error=True)
    frozen = program_from_desc(out_desc)
    frozen._is_test = True
    return frozen, freeze_report
