"""Quantization program passes.

Reference: python/paddle/fluid/contrib/slim/quantization/
quantization_pass.py — QuantizationTransformPass inserts fake-quant ops on
the inputs of quantizable ops for QAT; QuantizationFreezePass converts a
trained QAT program into the int8 inference form. Port of
``paddle_tpu/contrib/slim/quantization/quantization_pass.py``: the
ProgramDesc is rewritten directly (the pass-over-IrGraph machinery
collapses to program-to-program rewriting), and the int8 ops run on the
card's int8 tensor cores (ops/quant_ops.py).
"""

import numpy as np

from paddle_tpu_torch.inference.freeze import host_array

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.core.desc import OpDesc, VarDescData

QUANTIZABLE_OPS = ("conv2d", "depthwise_conv2d", "mul", "matmul")

# (input slot carrying activations, input slot carrying weights) per op
_SLOTS = {
    "conv2d": ("Input", "Filter"),
    "depthwise_conv2d": ("Input", "Filter"),
    "mul": ("X", "Y"),
    "matmul": ("X", "Y"),
}


class QuantizationTransformPass:
    """Insert fake-quant ops ahead of every quantizable op (QAT).

    Activations get moving-average abs-max observers (persistable scale
    state updated in training, frozen in test mode); weights get per-tensor
    abs-max. Gradients pass straight through (STE in the op lowering)."""

    def __init__(self, scope=None, place=None, weight_bits=8,
                 activation_bits=8, moving_rate=0.9,
                 quantizable_op_type=QUANTIZABLE_OPS):
        self._scope = scope
        self._weight_bits = weight_bits
        self._activation_bits = activation_bits
        self._moving_rate = moving_rate
        self._op_types = tuple(quantizable_op_type)
        # var name -> quantized copy name (dedup repeated uses)
        self._quantized = {}

    def apply(self, program):
        block = program.desc.global_block()
        scales_created = []
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            if op.type in self._op_types and not op.attrs.get(
                    "__quantized__", False):
                a_slot, w_slot = _SLOTS[op.type]
                n_inserted = 0
                for slot, is_weight in ((a_slot, False), (w_slot, True)):
                    names = op.inputs.get(slot, [])
                    new_names = []
                    for name in names:
                        qname, ins = self._quant_var(
                            block, name, is_weight, i + n_inserted,
                            scales_created, program)
                        new_names.append(qname)
                        n_inserted += ins
                    op.inputs[slot] = new_names
                op.attrs["__quantized__"] = True
                i += n_inserted
            i += 1
        program._bump_version()
        return scales_created

    def _quant_var(self, block, name, is_weight, insert_at, scales_created,
                   program):
        if name in self._quantized:
            return self._quantized[name], 0
        vd = block.find_var_recursive(name)
        qname = unique_name.generate(name + ".quantized")
        block.vars[qname] = VarDescData(
            qname,
            shape=list(vd.shape) if vd is not None and vd.shape else None,
            dtype=vd.dtype if vd is not None else None,
        )
        if is_weight:
            scale_name = unique_name.generate(name + ".scale")
            block.vars[scale_name] = VarDescData(
                scale_name, shape=[1], dtype="float32")
            op = OpDesc(
                "fake_quantize_abs_max",
                inputs={"X": [name]},
                outputs={"Out": [qname], "OutScale": [scale_name]},
                attrs={"bit_length": self._weight_bits},
            )
        else:
            # deterministic name: a for_test clone instrumented later picks
            # up the SAME scope state the training observers learned
            state_name = name + ".quant_scale"
            block.vars[state_name] = VarDescData(
                state_name, shape=[1], dtype="float32", persistable=True)
            self._init_scale_state(program, state_name)
            scale_name = state_name
            op = OpDesc(
                "fake_quantize_moving_average_abs_max",
                inputs={"X": [name], "InScale": [state_name]},
                outputs={"Out": [qname], "OutScale": [state_name]},
                attrs={"bit_length": self._activation_bits,
                       "moving_rate": self._moving_rate},
            )
        block.ops.insert(insert_at, op)
        scales_created.append((name, scale_name, is_weight))
        self._quantized[name] = qname
        return qname, 1

    @staticmethod
    def _init_scale_state(program, state_name):
        """Seed the moving-average scale in the scope (startup-equivalent).
        The pass runs after startup, so write directly when a scope is
        active."""
        from paddle_tpu_torch.executor import global_scope

        scope = global_scope()
        if scope.get(state_name) is None:
            scope.set(state_name, np.ones(1, np.float32))


class QuantizationFreezePass:
    """Convert a trained QAT program into the int8 inference form:
    fake-quant observers are removed, weights are materialized as int8
    tensors in the scope, and quantizable ops become quantized_* ops with
    baked scales (reference: quantization_pass.py QuantizationFreezePass;
    execution analog of the fork's ComputeINT8)."""

    def __init__(self, scope, weight_bits=8, activation_bits=8):
        self._scope = scope
        self._weight_bits = weight_bits
        self._qmax = float(2 ** (weight_bits - 1) - 1)

    def apply(self, program):
        block = program.desc.global_block()
        # map: quantized-var name -> (source var, scale name, is_weight)
        obs = {}
        kept_ops = []
        for op in block.ops:
            if op.type == "fake_quantize_abs_max":
                obs[op.outputs["Out"][0]] = (
                    op.inputs["X"][0], None, True)
                continue
            if op.type == "fake_quantize_moving_average_abs_max":
                obs[op.outputs["Out"][0]] = (
                    op.inputs["X"][0], op.inputs["InScale"][0], False)
                continue
            kept_ops.append(op)

        # observers removed first so the index-based inserts below land in
        # the final op list
        block.ops = kept_ops

        for op in list(kept_ops):
            if op.type not in _SLOTS or not op.attrs.get("__quantized__"):
                continue
            a_slot, w_slot = _SLOTS[op.type]
            a_name_q = op.inputs[a_slot][0]
            w_name_q = op.inputs[w_slot][0]
            if a_name_q not in obs or w_name_q not in obs:
                continue
            a_src, a_scale_name, _ = obs[a_name_q]
            w_src, _, _ = obs[w_name_q]

            # bake the int8 weight into the scope
            w_val = host_array(self._scope.get(w_src))
            w_scale = float(np.abs(w_val).max()) or 1e-8
            w_int8 = np.clip(
                np.round(w_val / w_scale * self._qmax), -self._qmax,
                self._qmax).astype(np.int8)
            w_int8_name = unique_name.generate(w_src + ".int8")
            block.vars[w_int8_name] = VarDescData(
                w_int8_name, shape=list(w_int8.shape), dtype="int8",
                persistable=True)
            self._scope.set(w_int8_name, w_int8)

            a_scale = float(host_array(self._scope.get(a_scale_name))[0])
            # int8 activation feed: quantize op ahead of the compute op
            a_q_name = unique_name.generate(a_src + ".q8")
            block.vars[a_q_name] = VarDescData(a_q_name, dtype="int8")
            idx = block.ops.index(op)
            block.ops.insert(idx, OpDesc(
                "quantize",
                inputs={"Input": [a_src]},
                outputs={"Output": [a_q_name]},
                attrs={"Scale": self._qmax / max(a_scale, 1e-8)},
            ))

            if op.type in ("conv2d", "depthwise_conv2d"):
                op.type = "quantized_conv2d"
                op.inputs["Input"] = [a_q_name]
                op.inputs["Filter"] = [w_int8_name]
                op.attrs["scale_x"] = self._qmax / max(a_scale, 1e-8)
                op.attrs["scale_w"] = self._qmax / w_scale
            else:
                op.type = "quantized_matmul"
                op.inputs["X"] = [a_q_name]
                op.inputs["Y"] = [w_int8_name]
                op.attrs["scale_x"] = self._qmax / max(a_scale, 1e-8)
                op.attrs["scale_y"] = self._qmax / w_scale
        program._bump_version()
        return program
