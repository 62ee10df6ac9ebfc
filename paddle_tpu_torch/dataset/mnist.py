"""MNIST dataset (reference python/paddle/dataset/mnist.py schema:
(784-float image in [-1,1], int label)). Synthetic fallback: class-dependent
Gaussian blobs, so models measurably learn."""

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test"]

_SYN_TRAIN = 8192
_SYN_TEST = 1024


_PROTO_SEED = 7  # ONE prototype set for train AND test: a model trained
# on the train split must generalize to the test split (the book tests
# assert test accuracy); only the sample stream differs per split


def _synthetic(n, seed):
    rng = np.random.RandomState(_PROTO_SEED)
    protos = rng.uniform(-1, 1, size=(10, 784)).astype(np.float32)

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(n):
            label = int(r.randint(0, 10))
            img = protos[label] + 0.3 * r.randn(784).astype(np.float32)
            yield np.clip(img, -1, 1).astype(np.float32), label
    return reader


def _idx_reader(img_path, lab_path):
    import gzip
    import struct

    def reader():
        with gzip.open(img_path) as fi, gzip.open(lab_path) as fl:
            fi.read(4)
            n, rows, cols = struct.unpack(">III", fi.read(12))
            fl.read(8)
            for _ in range(n):
                img = np.frombuffer(fi.read(rows * cols), np.uint8)
                img = img.astype(np.float32) / 127.5 - 1.0
                label = fl.read(1)[0]
                yield img, int(label)
    return reader


def train():
    ip = common.data_path("mnist", "train-images-idx3-ubyte.gz")
    lp = common.data_path("mnist", "train-labels-idx1-ubyte.gz")
    if common.has_cached("mnist", "train-images-idx3-ubyte.gz"):
        return _idx_reader(ip, lp)
    return _synthetic(_SYN_TRAIN, seed=7)


def test():
    ip = common.data_path("mnist", "t10k-images-idx3-ubyte.gz")
    lp = common.data_path("mnist", "t10k-labels-idx1-ubyte.gz")
    if common.has_cached("mnist", "t10k-images-idx3-ubyte.gz"):
        return _idx_reader(ip, lp)
    return _synthetic(_SYN_TEST, seed=11)
