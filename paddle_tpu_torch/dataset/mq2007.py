"""MQ2007 learning-to-rank schema (reference
python/paddle/dataset/mq2007.py: pairwise/listwise/pointwise modes over
46-dim query-document feature vectors with 0-2 relevance). Synthetic."""

import numpy as np

__all__ = ["train", "test"]

_FEATS = 46


def _queries(n_queries, seed):
    r = np.random.RandomState(seed)
    out = []
    for q in range(n_queries):
        docs = int(r.randint(5, 20))
        feats = r.rand(docs, _FEATS).astype(np.float32)
        rels = r.randint(0, 3, docs)
        out.append((rels, feats))
    return out


def _reader(n_queries, seed, format):
    def pointwise():
        for rels, feats in _queries(n_queries, seed):
            for rel, f in zip(rels, feats):
                yield float(rel), f

    def pairwise():
        for rels, feats in _queries(n_queries, seed):
            for i in range(len(rels)):
                for j in range(len(rels)):
                    if rels[i] > rels[j]:
                        yield 1.0, feats[i], feats[j]

    def listwise():
        for rels, feats in _queries(n_queries, seed):
            yield rels.astype(np.float32), feats

    return {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise}[format]


def train(format="pairwise"):
    return _reader(128, seed=73, format=format)


def test(format="pairwise"):
    return _reader(16, seed=79, format=format)
