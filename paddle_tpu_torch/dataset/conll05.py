"""CoNLL-2005 semantic role labeling schema (reference
python/paddle/dataset/conll05.py: (word_ids, ctx_n2, ctx_n1, ctx_0,
ctx_p1, ctx_p2, verb_ids, mark, label_ids)). Synthetic fallback."""

import numpy as np

__all__ = ["train", "test", "get_dict", "get_embedding"]

_WORDS = 44068
_VERBS = 3162
_LABELS = 59  # IOB tags over 29 chunk types + O


def get_dict():
    word_dict = {"w%d" % i: i for i in range(_WORDS)}
    verb_dict = {"v%d" % i: i for i in range(_VERBS)}
    label_dict = {"l%d" % i: i for i in range(_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Path to the pretrained-embedding file (reference conll05.py
    get_embedding returns a FILE the book test reads with a 16-byte
    header skip + float32 payload, test_label_semantic_roles.py:45)."""
    import os

    from paddle_tpu_torch.dataset import common

    path = common.data_path("conll05", "emb")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        r = np.random.RandomState(17)
        emb = r.rand(_WORDS, 32).astype(np.float32)
        tmp = "%s.tmp.%d" % (path, os.getpid())  # per-pid: parallel
        # first-callers must not replace each other's tmp away
        with open(tmp, "wb") as f:
            f.write(b"\0" * 16)  # header the readers skip
            emb.tofile(f)
        os.replace(tmp, path)
    return path


def _rows(n, seed):
    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            length = int(r.randint(5, 40))
            words = r.randint(0, _WORDS, length).tolist()
            ctx = [r.randint(0, _WORDS, length).tolist() for _ in range(5)]
            verb = [int(r.randint(0, _VERBS))] * length
            mark = (r.rand(length) < 0.15).astype(np.int64).tolist()
            labels = r.randint(0, _LABELS, length).tolist()
            yield tuple([words] + ctx + [verb, mark, labels])
    return reader


def train():
    return _rows(2048, seed=19)


def test():
    return _rows(256, seed=23)
