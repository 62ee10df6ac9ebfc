"""UCI housing regression (reference python/paddle/dataset/uci_housing.py
schema: (13-float features, 1-float price)). Synthetic linear-ish fallback."""

import numpy as np

__all__ = ["train", "test"]

_W = None


def _gen(n, seed):
    global _W
    if _W is None:
        _W = np.random.RandomState(3).randn(13).astype(np.float32)

    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            x = r.randn(13).astype(np.float32)
            y = float(x @ _W + 0.1 * r.randn())
            yield x, np.asarray([y], np.float32)
    return reader


def train():
    return _gen(404, seed=41)


def test():
    return _gen(102, seed=43)
