"""NLTK movie-reviews sentiment schema (reference
python/paddle/dataset/sentiment.py: (word-id sequence, 0/1 label)).
Synthetic fallback."""

import numpy as np

__all__ = ["train", "test", "get_word_dict"]

_VOCAB = 39768  # NLTK movie_reviews vocabulary size era


def get_word_dict():
    return [("w%d" % i, i) for i in range(_VOCAB)]


def _docs(n, seed):
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            label = int(r.randint(0, 2))
            length = int(r.randint(20, 200))
            center = 5000 if label else 20000
            ids = np.clip(r.normal(center, 6000, length).astype(np.int64),
                          0, _VOCAB - 1)
            yield ids.tolist(), label
    return reader


def train():
    return _docs(1600, seed=83)


def test():
    return _docs(400, seed=89)
