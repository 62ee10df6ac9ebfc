"""PASCAL VOC2012 segmentation schema (reference
python/paddle/dataset/voc2012.py: (3xHxW image, HxW label mask)).
Synthetic fallback at a fixed 224x224."""

import numpy as np

__all__ = ["train", "test", "val"]

_CLASSES = 21
_HW = 224


def _samples(n, seed):
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            img = r.rand(3, _HW, _HW).astype(np.float32)
            mask = r.randint(0, _CLASSES, (_HW, _HW)).astype(np.int64)
            yield img, mask
    return reader


def train():
    return _samples(256, seed=61)


def test():
    return _samples(32, seed=67)


def val():
    return _samples(32, seed=71)
