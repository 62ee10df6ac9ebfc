"""Initializers: emit init ops into the startup program.

Capability parity: `python/paddle/fluid/initializer.py` (Constant :103,
Uniform :145, Normal :196, Xavier :246). Init ops are ordinary
random/fill ops that the executor runs once with the startup program;
``uniform_random`` and ``gaussian_random`` draw from a
``torch.Generator`` seeded per op (``TraceContext.rng``).
TruncatedNormal, MSRA, Bilinear and NumpyArrayInitializer arrive with a
later slice.
"""

import math

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "Xavier", "ConstantInitializer",
           "UniformInitializer", "NormalInitializer", "XavierInitializer"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan(var):
        shape = var.shape
        if len(shape) < 1:
            return 1, 1
        if len(shape) == 1:
            return shape[0], shape[0]
        recep = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        fan_in = shape[1] * recep if len(shape) > 2 else shape[0]
        fan_out = shape[0] * recep if len(shape) > 2 else shape[1]
        return fan_in, fan_out


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            "fill_constant", {}, {"Out": [var.name]},
            {"shape": list(var.shape), "dtype": var.dtype, "value": self.value})


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            "uniform_random", {}, {"Out": [var.name]},
            {"shape": list(var.shape), "dtype": var.dtype,
             "min": self.low, "max": self.high, "seed": self.seed})


class Normal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.mean, self.std, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "gaussian_random", {}, {"Out": [var.name]},
            {"shape": list(var.shape), "dtype": var.dtype,
             "mean": self.mean, "std": self.std, "seed": self.seed})


class Xavier(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out = fan_in, fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = self._fan(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return Uniform(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std, self.seed)(var, block)


# reference-compatible aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
XavierInitializer = Xavier
