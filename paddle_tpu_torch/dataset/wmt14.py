"""WMT'14 EN-FR schema (reference python/paddle/dataset/wmt14.py:
(src_ids, trg_ids, trg_ids_next) with <s>/<e>/<unk> control ids 0/1/2).
Synthetic fallback."""

import numpy as np

__all__ = ["train", "test", "get_dict"]

START, END, UNK = 0, 1, 2


def get_dict(dict_size):
    src = {"<s>": 0, "<e>": 1, "<unk>": 2}
    src.update({"s%d" % i: i + 3 for i in range(dict_size - 3)})
    trg = {"<s>": 0, "<e>": 1, "<unk>": 2}
    trg.update({"t%d" % i: i + 3 for i in range(dict_size - 3)})
    return src, trg


def _pairs(n, dict_size, seed):
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            slen = int(r.randint(4, 30))
            tlen = int(r.randint(4, 30))
            src = r.randint(3, dict_size, slen).tolist()
            trg_core = r.randint(3, dict_size, tlen).tolist()
            trg = [START] + trg_core
            trg_next = trg_core + [END]
            yield src, trg, trg_next
    return reader


def train(dict_size=30000):
    return _pairs(4096, dict_size, seed=29)


def test(dict_size=30000):
    return _pairs(512, dict_size, seed=31)
