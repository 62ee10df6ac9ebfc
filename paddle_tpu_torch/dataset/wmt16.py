"""WMT'16 EN-DE schema (reference python/paddle/dataset/wmt16.py — same
(src, trg, trg_next) triples as wmt14 with configurable src/trg dict
sizes). Synthetic fallback."""

import numpy as np

__all__ = ["train", "test", "validation", "get_dict"]

START, END, UNK = 0, 1, 2


def get_dict(lang, dict_size):
    d = {"<s>": 0, "<e>": 1, "<unk>": 2}
    d.update({"%s%d" % (lang, i): i + 3 for i in range(dict_size - 3)})
    return d


def _pairs(n, src_size, trg_size, seed):
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            slen = int(r.randint(4, 40))
            tlen = int(r.randint(4, 40))
            src = r.randint(3, src_size, slen).tolist()
            core = r.randint(3, trg_size, tlen).tolist()
            yield src, [START] + core, core + [END]
    return reader


def train(src_dict_size=30000, trg_dict_size=30000, src_lang="en"):
    return _pairs(4096, src_dict_size, trg_dict_size, seed=37)


def test(src_dict_size=30000, trg_dict_size=30000, src_lang="en"):
    return _pairs(512, src_dict_size, trg_dict_size, seed=41)


def validation(src_dict_size=30000, trg_dict_size=30000, src_lang="en"):
    return _pairs(512, src_dict_size, trg_dict_size, seed=43)
