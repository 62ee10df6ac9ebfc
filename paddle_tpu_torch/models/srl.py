"""The semantic-role tagger of the 2018 book (label_semantic_roles):
word and predicate embeddings, a bidirectional ``dynamic_lstm``, a
linear-chain CRF.

Capability parity: the reference book's ``test_label_semantic_roles.py``
cut to its tagger, as ``tests/test_book.py`` (TestBookLabelSemanticRoles)
builds it with the JAX package's layers: embeddings -> concat -> an
``fc(4H)`` and a ``dynamic_lstm`` forward, another pair ``is_reverse``
-> ``fc`` to the label count -> ``linear_chain_crf`` -> ``mean``. The
training program adds Adam; the inference program decodes the tags with
``crf_decoding`` and scores them with ``chunk_eval`` (IOB). Built under
one ``unique_name.guard()`` each, the two share every parameter by
name, and the CRF's transition is ``crfw``. The default widths are the
CoNLL-2005 schema's (``paddle_tpu/dataset/conll05.py``: 44068 words,
3162 predicates, 59 labels, IOB over 29 chunk types and O) at the
book's embedding 32 and ``hidden_dim`` 512 (the LSTM size: H = 128).
"""

import math

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers

__all__ = ["srl_features", "build_srl"]

WORDS, PREDICATES, LABELS = 44068, 3162, 59


def srl_features(word, pred, word_dict_len, pred_dict_len, label_dict_len,
                 emb_dim, hid_dim):
    """The per-token label scores ``[B, T, label_dict_len]``."""
    wx = layers.embedding(word, size=[word_dict_len, emb_dim])
    px = layers.embedding(pred, size=[pred_dict_len, emb_dim])
    x = layers.concat([wx, px], axis=-1)
    fwd = layers.fc(x, 4 * hid_dim, num_flatten_dims=2)
    h_f, _ = layers.dynamic_lstm(fwd, 4 * hid_dim)
    bwd = layers.fc(x, 4 * hid_dim, num_flatten_dims=2)
    h_b, _ = layers.dynamic_lstm(bwd, 4 * hid_dim, is_reverse=True)
    return layers.fc(layers.concat([h_f, h_b], axis=-1), label_dict_len,
                     num_flatten_dims=2)


def build_srl(word_dict_len=WORDS, pred_dict_len=PREDICATES,
              label_dict_len=LABELS, emb_dim=32, hid_dim=128, lr=1e-3,
              mode="train"):
    """``mode="train"``: (prog, startup, feeds, (loss,)), the mean CRF
    cost minimised by Adam. ``mode="infer"``: (prog, startup, feeds,
    (tags, precision, recall, f1, num_infer, num_label, num_correct)).
    Feeds: "word", "pred", "label", each ragged ``[len_i, 1]`` int64."""
    if mode not in ("train", "infer"):
        raise ValueError("mode must be 'train' or 'infer', got %r" % mode)
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        word = layers.data("word", [1], dtype="int64", lod_level=1)
        pred = layers.data("pred", [1], dtype="int64", lod_level=1)
        feat = srl_features(word, pred, word_dict_len, pred_dict_len,
                            label_dict_len, emb_dim, hid_dim)
        label = layers.data("label", [1], dtype="int64", lod_level=1)
        crfw = fluid.ParamAttr(name="crfw")
        if mode == "train":
            loss = layers.mean(layers.linear_chain_crf(feat, label,
                                                       param_attr=crfw))
            fluid.optimizer.Adam(lr).minimize(loss)
            fetches = (loss,)
        else:
            tags = layers.crf_decoding(feat, param_attr=crfw)
            fetches = (tags,) + layers.chunk_eval(
                tags, label, chunk_scheme="IOB",
                num_chunk_types=int(math.ceil((label_dict_len - 1) / 2.0)))
    return prog, startup, ("word", "pred", "label"), fetches
