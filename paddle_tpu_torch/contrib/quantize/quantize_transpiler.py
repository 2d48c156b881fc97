"""QuantizeTranspiler — the program-level QAT API (reference:
python/paddle/fluid/contrib/quantize/quantize_transpiler.py:63). A thin
driver over the slim quantization passes (the same relationship the
reference has with its IrGraph passes)."""

import numpy as np

from paddle_tpu_torch.inference.freeze import host_array
from paddle_tpu_torch.contrib.slim.quantization import (
    QuantizationFreezePass,
    QuantizationTransformPass,
)

__all__ = ["QuantizeTranspiler"]


class QuantizeTranspiler:
    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        if activation_quantize_type not in (
                "abs_max", "range_abs_max", "moving_average_abs_max"):
            raise ValueError(
                "Unknown activation_quantize_type: %s"
                % activation_quantize_type)
        self.activation_quantize_type = activation_quantize_type
        self.weight_quantize_type = weight_quantize_type
        self.window_size = window_size

    def training_transpile(self, program=None, startup_program=None):
        """Insert fake-quant/dequant observers for QAT (reference:
        quantize_transpiler.py training_transpile)."""
        from paddle_tpu_torch.framework import default_main_program

        program = program or default_main_program()
        QuantizationTransformPass(
            weight_bits=self.weight_bits,
            activation_bits=self.activation_bits).apply(program)
        return program

    def freeze_program(self, program, place, fuse_bn=False, scope=None):
        """Fold observers into an int8 inference program (reference:
        quantize_transpiler.py freeze_program)."""
        from paddle_tpu_torch.executor import global_scope

        scope = scope if scope is not None else global_scope()
        if fuse_bn:
            raise NotImplementedError(
                "freeze_program(fuse_bn=True) runs the InferenceTranspiler, "
                "which is ROADMAP Queue 1 item 12 (transpiler/); fold "
                "batch norm with inference.freeze_program instead")
        QuantizationFreezePass(
            scope, weight_bits=self.weight_bits,
            activation_bits=self.activation_bits).apply(program)
        return program

    def convert_to_int8(self, program, place, scope=None):
        """Store the quantized weights as actual int8 tensors in the
        scope (reference: quantize_transpiler.py convert_to_int8)."""
        from paddle_tpu_torch.executor import global_scope

        scope = scope if scope is not None else global_scope()
        qmax = float(2 ** (self.weight_bits - 1) - 1)
        converted = []
        for p in program.all_parameters():
            val = scope.get(p.name)
            if val is None:
                continue
            arr = host_array(val)
            if arr.dtype not in (np.float32, np.float64):
                continue
            scale = float(np.abs(arr).max()) or 1.0
            q = np.clip(np.round(arr / scale * qmax), -qmax - 1,
                        qmax).astype(np.int8)
            scope.set(p.name + "@INT8", q)
            scope.set(p.name + "@SCALE", np.float32(scale))
            converted.append(p.name)
        return converted
