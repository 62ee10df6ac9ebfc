"""Running weighted means over fetched metric values.

Capability parity: `python/paddle/fluid/average.py` (WeightedAverage —
the benchmark scripts' accumulator for per-batch accuracy weighted by
batch size), the JAX package's ``average.py`` name for name: a host
accumulator over fetched numpy values.
"""

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number_or_array(x):
    return isinstance(x, (int, float, np.number, np.ndarray)) or (
        hasattr(x, "shape") and hasattr(x, "dtype"))


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_array(value):
            raise ValueError("The 'value' must be a number or a numpy array.")
        if not _is_number_or_array(weight):
            raise ValueError("The 'weight' must be a number or a numpy array.")
        value = np.asarray(value, dtype=np.float64)
        weight = np.asarray(weight, dtype=np.float64)
        if self.numerator is None:
            self.numerator = float((value * weight).sum())
            self.denominator = float(weight.sum())
        else:
            self.numerator += float((value * weight).sum())
            self.denominator += float(weight.sum())

    def eval(self):
        if self.numerator is None or self.denominator == 0.0:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage.")
        return self.numerator / self.denominator
