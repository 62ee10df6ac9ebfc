"""Initializers: emit init ops into the startup program.

Capability parity: `python/paddle/fluid/initializer.py` (Constant :103,
Uniform :145, Normal :196, Xavier :246, MSRA :339, Bilinear,
NumpyArrayInitializer). Init ops are ordinary random/fill ops that the
executor runs once with the startup program; ``uniform_random``,
``gaussian_random`` and ``truncated_gaussian_random`` draw from a
``torch.Generator`` seeded per op (``TraceContext.rng``).
"""

import math

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier",
           "MSRA", "Bilinear", "NumpyArrayInitializer", "ConstantInitializer",
           "UniformInitializer", "NormalInitializer", "XavierInitializer",
           "MSRAInitializer"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan(var):
        shape = var.shape
        # pipeline-stacked params carry a leading [num_stages] dim that is
        # not part of any one stage's fan
        if getattr(var, "pp_stages", None) and len(shape) > 1:
            shape = shape[1:]
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


class TruncatedNormal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.mean, self.std, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "truncated_gaussian_random", {}, {"Out": [var.name]},
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


class MSRA(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = self._fan(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return Uniform(-limit, limit, self.seed)(var, block)
        return Normal(0.0, math.sqrt(2.0 / fi), self.seed)(var, block)


class Bilinear(Initializer):
    """Bilinear upsampling kernel for a transposed convolution's
    [out, in, k, k] weight (reference initializer.py
    BilinearInitializer): output channel i takes the kernel on input
    channel i mod in."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("Bilinear init needs a 4-D conv weight")
        c, k = shape[1], shape[3]
        f = int(np.ceil(k / 2.0))
        center = (2 * f - 1 - f % 2) / (2.0 * f)
        og = np.ogrid[:k, :k]
        filt = (1 - abs(og[0] / f - center)) * (1 - abs(og[1] / f - center))
        weight = np.zeros(shape, dtype=np.float32)
        for i in range(shape[0]):
            weight[i, i % c] = filt
        return NumpyArrayInitializer(weight)(var, block)


class NumpyArrayInitializer(Initializer):
    """The variable takes a numpy array's values, held in the startup
    program by an ``assign_value`` op."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            "assign_value", {}, {"Out": [var.name]},
            {"shape": list(self.value.shape), "dtype": str(self.value.dtype),
             "values": self.value.reshape(-1).tolist()})


# reference-compatible aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
XavierInitializer = Xavier
MSRAInitializer = MSRA
