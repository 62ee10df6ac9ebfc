"""IMDB sentiment (reference python/paddle/dataset/imdb.py schema:
(word-id sequence, 0/1 label)). Synthetic fallback with class-correlated
token distributions."""

import numpy as np

__all__ = ["train", "test", "word_dict"]

_VOCAB = 5149  # matches the reference's imdb.word_dict() size era


def word_dict():
    # reference imdb.word_dict(): token -> id with '<unk>' appended last
    # (python/paddle/dataset/imdb.py build_dict); synthetic ids stand in
    # for tokens, but '<unk>' must be a real key — callers index it
    # (benchmark/fluid/stacked_dynamic_lstm.py:87)
    d = {"w%d" % i: i for i in range(_VOCAB - 1)}
    d["<unk>"] = _VOCAB - 1
    return d


def _synthetic(n, seed):
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            label = int(r.randint(0, 2))
            length = int(r.randint(8, 120))
            center = 1000 if label else 3000
            ids = np.clip(r.normal(center, 800, size=length).astype(np.int64),
                          0, _VOCAB - 1)
            yield ids.tolist(), label
    return reader


def train(word_idx=None):
    return _synthetic(4096, seed=31)


def test(word_idx=None):
    return _synthetic(512, seed=37)
