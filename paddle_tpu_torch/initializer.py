"""Initializers appended as ops to the startup program.

Port of ``paddle_tpu/initializer.py`` (reference:
python/paddle/fluid/initializer.py): Constant (``fill_constant``),
Uniform (``uniform_random``), Normal (``gaussian_random``),
TruncatedNormal (``truncated_gaussian_random``), Xavier and MSRA,
uniform or normal, with the reference's fan rules, and NumpyArray
(``assign_value``, the values written into the desc).
"""

import math

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value
        del force_cpu  # placement is the executor's

    def __call__(self, var, block):
        block.append_op(
            type="fill_constant",
            outputs={"Out": [var]},
            attrs={
                "shape": list(var.shape),
                "dtype": int(var.dtype),
                "value": float(self.value),
            },
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low = low
        self.high = high
        self.seed = seed

    def __call__(self, var, block):
        block.append_op(
            type="uniform_random",
            outputs={"Out": [var]},
            attrs={
                "shape": list(var.shape),
                "dtype": int(var.dtype),
                "min": float(self.low),
                "max": float(self.high),
                "seed": self.seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc = loc
        self.scale = scale
        self.seed = seed

    def _append(self, type, var, block):
        block.append_op(
            type=type,
            outputs={"Out": [var]},
            attrs={
                "shape": list(var.shape),
                "dtype": int(var.dtype),
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
            },
        )

    def __call__(self, var, block):
        self._append("gaussian_random", var, block)


class TruncatedNormalInitializer(NormalInitializer):
    def __call__(self, var, block):
        self._append("truncated_gaussian_random", var, block)


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return (shape[0] if shape else 1, shape[0] if shape else 1)
    fan_in = shape[0]
    fan_out = shape[1]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return fan_in * receptive, fan_out * receptive


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.fan_out = fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.seed = seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    """The array's values as an ``assign_value`` op (initializer.py:136):
    floats in ``fp32_values`` as Python floats, so the desc's JSON holds
    the same digits as the JAX package's."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        arr = self.value
        if arr.dtype in (np.float32, np.float64, np.float16):
            key, vals = "fp32_values", [float(v) for v in arr.flatten()]
        else:
            key, vals = "int32_values", [int(v) for v in arr.flatten()]
        block.append_op(
            type="assign_value",
            outputs={"Out": [var]},
            attrs={
                "shape": list(arr.shape),
                "dtype": int(var.dtype),
                key: vals,
            },
        )


# Reference-compatible aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
