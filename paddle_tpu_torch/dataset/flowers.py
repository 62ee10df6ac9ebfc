"""Oxford 102 Flowers schema (reference python/paddle/dataset/flowers.py:
(3x224x224 float image, 0..101 label)). Synthetic fallback."""

import numpy as np

__all__ = ["train", "test", "valid"]

_CLASSES = 102


def _images(n, seed):
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            label = int(r.randint(0, _CLASSES))
            img = r.rand(3 * 224 * 224).astype(np.float32)
            yield img, label
    return reader


def train(mapper=None, buffered_size=1024, use_xmap=False):
    return _images(512, seed=47)


def test(mapper=None, buffered_size=1024, use_xmap=False):
    return _images(64, seed=53)


def valid(mapper=None, buffered_size=1024, use_xmap=False):
    return _images(64, seed=59)
