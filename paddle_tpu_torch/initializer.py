"""Initializers appended as ops to the startup program.

Port of ``paddle_tpu/initializer.py`` (reference:
python/paddle/fluid/initializer.py), for the initializers whose startup
ops this slice lowers: ``fill_constant`` (Constant) and
``uniform_random`` (Uniform, and Xavier in its default uniform form).
The normal-distribution form appends ``gaussian_random``, which a later
slice lowers (ROADMAP Queue 1, the remaining op families); it raises here
instead of emitting an op nothing can run.
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
        if not self.uniform:
            raise NotImplementedError(
                "XavierInitializer(uniform=False) appends gaussian_random, "
                "which the port does not lower yet (ROADMAP Queue 1: the "
                "remaining op families)")
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = math.sqrt(6.0 / (fi + fo))
        UniformInitializer(-limit, limit, self.seed)(var, block)


# Reference-compatible aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Xavier = XavierInitializer
