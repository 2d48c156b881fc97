"""Post-training INT8 quantization over a frozen program — port of
``paddle_tpu/inference/quantize.py``; the quantized desc and the int8
weights are the reference's, byte for byte and bit for bit.

Two stages (reference: the xiaolil1 fork's calibration + ComputeINT8
MKL-DNN path, PAPER.md §2.8; here the int8 contraction is
``torch._int_mm`` with int8 inputs and int32 accumulation on the card —
see ops/quant_ops.py, which emulates in exact fp32 on the CPU):

* ``calibrate_program`` runs N representative batches through the
  frozen fp32 program and collects per-tensor abs-max ranges for every
  activation feeding a quantizable op. Ranges accumulate in a dedicated
  observability ``MetricsRegistry`` (one ``calib.<var>`` histogram per
  tensor — batch-to-batch range drift is visible in the tail, not just
  the max), and the final ranges mirror into the process registry as
  ``calib.<var>.abs_max`` gauges when metrics are enabled.

* ``quantize_program`` rewrites every calibrated conv2d /
  depthwise_conv2d / mul / matmul to
  ``quantize -> quantized_conv2d|quantized_matmul`` with the activation
  scale baked into the op attrs, per-output-channel weight scales, and
  int8 weights baked into the scope. Ops whose output feeds a
  range-sensitive consumer (softmax, layer_norm) are skipped and keep
  the fp32 path, as are matmuls with transpose/alpha attrs the frozen
  kernel does not model.
"""

import numpy as np

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.core.desc import OpDesc
from paddle_tpu_torch.core.types import VarType
from paddle_tpu_torch.framework import OP_ROLE_KEY, program_from_desc
from paddle_tpu_torch.inference.freeze import host_array

# op type -> (activation input slot, weight input slot)
QUANTIZABLE_OPS = {
    "conv2d": ("Input", "Filter"),
    "depthwise_conv2d": ("Input", "Filter"),
    "mul": ("X", "Y"),
    "matmul": ("X", "Y"),
}

# consumers whose numerics are range-sensitive: an op feeding one of
# these directly keeps the fp32 path (quantization error in logits
# shifts softmax mass; layer_norm re-centers and amplifies it)
RANGE_SENSITIVE_OPS = ("softmax", "layer_norm")

_QMAX = 127.0


class CalibrationStats:
    """Per-tensor activation ranges from a calibration run, backed by a
    private MetricsRegistry: one ``calib.<var>`` histogram per tensor,
    one sample per batch."""

    def __init__(self):
        from paddle_tpu_torch.observability import MetricsRegistry

        self.registry = MetricsRegistry()
        self.batches = 0

    def update(self, name, batch_abs_max):
        self.registry.observe("calib." + name, float(batch_abs_max))

    def range(self, name):
        h = self.registry.histogram("calib." + name)
        return float(h.max) if h is not None and h.count else 0.0

    def ranges(self):
        snap = self.registry.snapshot()["histograms"]
        return {k[len("calib."):]: float(h["max"] or 0.0)
                for k, h in snap.items() if k.startswith("calib.")}

    def describe(self, name):
        h = self.registry.histogram("calib." + name)
        return h.describe() if h is not None else None


def _quantizable_sites(desc):
    """(block, op) pairs for every quantizable op in the program."""
    for b in desc.blocks:
        for op in b.ops:
            if op.type in QUANTIZABLE_OPS:
                yield b, op


def activation_targets(program_or_desc, scope=None):
    """Activation input vars of quantizable ops — the tensors calibration
    must observe. Persistable inputs (weights used as activations in odd
    graphs) are excluded; they are read from the scope directly."""
    desc = getattr(program_or_desc, "desc", program_or_desc)
    seen, out = set(), []
    for b, op in _quantizable_sites(desc):
        a_slot, _ = QUANTIZABLE_OPS[op.type]
        names = op.input(a_slot)
        if not names:
            continue
        name = names[0]
        vd = b.find_var_recursive(name)
        if vd is not None and vd.persistable:
            continue
        if name not in seen:
            seen.add(name)
            out.append(name)
    return out


def calibrate_program(program, batches, scope=None, executor=None,
                      max_batches=None):
    """Run representative ``batches`` (iterable of feed dicts) through
    the program, collecting per-tensor abs-max ranges for every
    quantizable activation. Returns CalibrationStats.

    ``max_batches`` defaults to the ``serving_calibration_batches``
    flag; fed variables are ranged host-side from the feed itself
    (no round-trip through the executor for data the caller already
    has)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.executor import Executor, global_scope, scope_guard

    if max_batches is None:
        max_batches = int(flags.get_flag("serving_calibration_batches"))
    exe = executor or Executor()
    scope = scope or global_scope()
    targets = activation_targets(program)
    stats = CalibrationStats()
    if not targets:
        return stats
    with scope_guard(scope):
        for feed in batches:
            if stats.batches >= max_batches:
                break
            fed = [t for t in targets if t in feed]
            fetched = [t for t in targets if t not in feed]
            if fetched:
                with obs.span("calibrate.batch", batch=stats.batches):
                    vals = exe.run(program, feed=feed, fetch_list=fetched)
            else:
                vals = []
            for name in fed:
                stats.update(name, np.abs(host_array(feed[name])).max())
            for name, v in zip(fetched, vals):
                stats.update(name, np.abs(host_array(v)).max())
            stats.batches += 1
    for name in targets:
        obs.set_gauge("calib.%s.abs_max" % name, stats.range(name))
    obs.inc("calib.batches", stats.batches)
    return stats


class QuantReport:
    """Quantized-vs-skipped decision record, one row per quantizable op
    site (tools/lint_program.py --freeze prints it)."""

    def __init__(self):
        self.quantized = []   # dicts: op/activation/weight/scales/ranges
        self.skipped = []     # dicts: op/activation/reason

    def render(self):
        lines = ["quantize: %d op(s) -> int8, %d skipped"
                 % (len(self.quantized), len(self.skipped))]
        if self.quantized or self.skipped:
            lines.append("  %-18s %-28s %-12s %s"
                         % ("op", "activation", "act range", "weight scale"))
        for q in self.quantized:
            wlo, whi = q["w_scale_range"]
            lines.append("  %-18s %-28s %-12.5g %s"
                         % (q["op"], q["activation"][:28], q["act_abs_max"],
                            ("per-channel [%.3g, %.3g]" % (wlo, whi))
                            if q["per_channel"] else "%.3g" % whi))
        for s in self.skipped:
            lines.append("  %-18s %-28s skipped: %s"
                         % (s["op"], (s["activation"] or "-")[:28],
                            s["reason"]))
        return "\n".join(lines)


def _reader_types(desc):
    """var name -> [op types reading it] (skip-list adjacency check)."""
    readers = {}
    for b in desc.blocks:
        for op in b.ops:
            for names in op.inputs.values():
                for n in names:
                    readers.setdefault(n, []).append(op.type)
    return readers


def _weight_scales(op_type, w, per_channel):
    """(scale vector or scalar, quantized int8 weight). Per-channel is
    over the output channels: conv OIHW axis 0, fc/matmul [K, N] axis 1
    (reduce over everything else)."""
    if per_channel:
        if w.ndim == 4:
            absmax = np.abs(w).max(axis=(1, 2, 3))
            scale = _QMAX / np.maximum(absmax, 1e-8)
            w_q = w * scale.reshape(-1, 1, 1, 1)
        else:
            absmax = np.abs(w).max(axis=0)
            scale = _QMAX / np.maximum(absmax, 1e-8)
            w_q = w * scale.reshape(1, -1)
        scale_attr = [float(s) for s in scale]
    else:
        absmax = float(np.abs(w).max())
        scale = _QMAX / max(absmax, 1e-8)
        w_q = w * scale
        scale_attr = float(scale)
    w_int8 = np.clip(np.round(w_q), -_QMAX, _QMAX).astype(np.int8)
    return scale_attr, w_int8


def quantize_desc(desc, scope, ranges, per_channel=True, skip_vars=()):
    """Rewrite quantizable ops of ``desc`` IN PLACE. Returns QuantReport.
    ``ranges``: var name -> calibrated abs-max (CalibrationStats.ranges()
    or any dict). int8 weights are baked into ``scope``."""
    report = QuantReport()
    skip_vars = set(skip_vars)
    reader_types = _reader_types(desc)
    for b in desc.blocks:
        quant_cache = {}  # activation name -> (quantized name, scale_x)
        i = 0
        while i < len(b.ops):
            op = b.ops[i]
            slots = QUANTIZABLE_OPS.get(op.type)
            if slots is None:
                i += 1
                continue
            a_slot, w_slot = slots
            a_names, w_names = op.input(a_slot), op.input(w_slot)
            a_name = a_names[0] if a_names else None
            w_name = w_names[0] if w_names else None
            out_names = op.output_arg_names()

            def _skip(reason):
                report.skipped.append(
                    {"op": op.type, "activation": a_name, "reason": reason})

            if a_name is None or w_name is None:
                _skip("missing input slot")
                i += 1
                continue
            if a_name in skip_vars or w_name in skip_vars:
                _skip("user skip-list")
                i += 1
                continue
            if any(rt in RANGE_SENSITIVE_OPS
                   for out in out_names
                   for rt in reader_types.get(out, ())):
                _skip("feeds range-sensitive op (%s)"
                      % "/".join(RANGE_SENSITIVE_OPS))
                i += 1
                continue
            if op.type == "matmul" and (
                    op.attrs.get("transpose_X") or op.attrs.get("transpose_Y")
                    or float(op.attrs.get("alpha", 1.0)) != 1.0):
                _skip("matmul transpose/alpha attrs")
                i += 1
                continue
            w_val = scope.get(w_name)
            if w_val is None:
                _skip("weight %r not in scope" % w_name)
                i += 1
                continue
            w = host_array(w_val, np.float32)
            if w.ndim == 4:
                # a layout-enabled compile may have baked this filter
                # HWIO in the scope (analysis/layout.py); quantize in
                # OIHW — the layout pass re-bakes the .int8 weight when
                # the quantized program compiles with layout on
                w_vd = b.find_var_recursive(w_name)
                declared = tuple(w_vd.shape) \
                    if w_vd is not None and w_vd.shape else tuple(w.shape)
                hwio = tuple(declared[i] for i in (2, 3, 1, 0))
                if (w_name in getattr(scope, "_layout_hwio", ())
                        or (tuple(w.shape) == hwio
                            and tuple(w.shape) != declared)):
                    w = np.transpose(w, (3, 2, 0, 1))
            if w.ndim not in (2, 4) or (
                    w.ndim != 4) == (op.type in ("conv2d",
                                                 "depthwise_conv2d")):
                _skip("weight rank %d unsupported" % w.ndim)
                i += 1
                continue
            a_range = float(ranges.get(a_name, 0.0) or 0.0)
            if a_range <= 0.0:
                _skip("no calibrated range for %r" % a_name)
                i += 1
                continue

            scale_x = _QMAX / max(a_range, 1e-8)
            scale_w, w_int8 = _weight_scales(op.type, w, per_channel)
            w8_name = unique_name.generate(w_name + ".int8")
            b.create_var(w8_name, shape=list(w_int8.shape),
                         dtype=VarType.INT8, persistable=True,
                         stop_gradient=True)
            scope.set(w8_name, w_int8)

            cached = quant_cache.get(a_name)
            if cached is not None and cached[1] == scale_x:
                q_name = cached[0]
            else:
                q_name = unique_name.generate(a_name + ".q8")
                a_vd = b.find_var_recursive(a_name)
                b.create_var(
                    q_name,
                    shape=(list(a_vd.shape)
                           if a_vd is not None and a_vd.shape else None),
                    dtype=VarType.INT8)
                b.ops.insert(i, OpDesc(
                    "quantize",
                    inputs={"Input": [a_name]},
                    outputs={"Output": [q_name]},
                    attrs={"Scale": scale_x, OP_ROLE_KEY: 0},
                ))
                quant_cache[a_name] = (q_name, scale_x)
                i += 1  # the compute op moved one slot down

            sw = (np.asarray(scale_w) if isinstance(scale_w, list)
                  else scale_w)
            if op.type in ("conv2d", "depthwise_conv2d"):
                op.type = "quantized_conv2d"
                op.inputs["Input"] = [q_name]
                op.inputs["Filter"] = [w8_name]
                op.attrs["scale_x"] = scale_x
                op.attrs["scale_w"] = scale_w
            else:
                a_vd = b.find_var_recursive(a_name)
                x_cols = int(op.attrs.get(
                    "x_num_col_dims",
                    (len(a_vd.shape) - 1)
                    if op.type == "matmul" and a_vd is not None
                    and a_vd.shape else 1))
                op.type = "quantized_matmul"
                op.inputs["X"] = [q_name]
                op.inputs["Y"] = [w8_name]
                op.attrs["scale_x"] = scale_x
                op.attrs["scale_y"] = scale_w
                op.attrs["x_num_col_dims"] = x_cols
            report.quantized.append({
                "op": op.type, "activation": a_name, "weight": w_name,
                "act_abs_max": a_range, "scale_x": scale_x,
                "per_channel": isinstance(scale_w, list),
                "w_scale_range": (
                    (float(np.min(sw)), float(np.max(sw)))
                    if isinstance(scale_w, list)
                    else (float(scale_w), float(scale_w))),
            })
            i += 1
    return report


def quantize_program(program, stats_or_ranges, scope=None,
                     per_channel=True, skip_vars=(), verify=True):
    """Quantize a frozen Program. Returns ``(int8_program, QuantReport)``
    — a NEW Program over a rewritten desc clone; the input program is
    untouched. int8 weights are baked into ``scope`` (default: the
    current global scope)."""
    from paddle_tpu_torch import observability as obs

    if scope is None:
        from paddle_tpu_torch.executor import global_scope

        scope = global_scope()
    ranges = (stats_or_ranges.ranges()
              if isinstance(stats_or_ranges, CalibrationStats)
              else dict(stats_or_ranges))
    desc = getattr(program, "desc", program)
    work = desc.clone()
    report = quantize_desc(work, scope, ranges, per_channel=per_channel,
                           skip_vars=skip_vars)
    obs.inc("quantize.ops", len(report.quantized))
    obs.inc("quantize.skipped", len(report.skipped))
    if verify and report.quantized:
        from paddle_tpu_torch.analysis import verify_program

        verify_program(work, raise_on_error=True)
    out = program_from_desc(work)
    out._is_test = getattr(program, "_is_test", True)
    return out, report


def post_training_quantize(program, batches, feed_names=None,
                           fetch_names=None, scope=None, executor=None,
                           freeze_first=False, per_channel=True,
                           skip_vars=(), max_batches=None):
    """One-call PTQ: (optionally freeze, then) calibrate over ``batches``
    and quantize. Returns ``(int8_program, CalibrationStats,
    QuantReport)``."""
    if scope is None:
        from paddle_tpu_torch.executor import global_scope

        scope = global_scope()
    if freeze_first:
        from paddle_tpu_torch.inference.freeze import freeze_program

        program, _ = freeze_program(program, feed_names or [],
                                    fetch_names or [], scope=scope)
    stats = calibrate_program(program, batches, scope=scope,
                              executor=executor, max_batches=max_batches)
    int8_prog, report = quantize_program(program, stats, scope=scope,
                                         per_channel=per_channel,
                                         skip_vars=skip_vars)
    return int8_prog, stats, report
