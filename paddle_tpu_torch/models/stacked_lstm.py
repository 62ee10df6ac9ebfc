"""Stacked dynamic-LSTM text classifier.

Capability parity: `benchmark/fluid/stacked_dynamic_lstm.py` (IMDB
sentiment: embedding -> [fc(4H) -> dynamic_lstm] x N -> max pools -> fc)
and the understand_sentiment book config. The JAX package's
``models/stacked_lstm.py``, name for name."""

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers

__all__ = ["stacked_lstm_net", "build_stacked_lstm_train"]


def stacked_lstm_net(word_ids, dict_dim, class_dim=2, emb_dim=128,
                     hid_dim=128, stacked_num=3):
    emb = layers.embedding(word_ids, size=[dict_dim, emb_dim])
    fc1 = layers.fc(emb, size=hid_dim * 4, num_flatten_dims=2)
    lstm1, _ = layers.dynamic_lstm(fc1, size=hid_dim * 4)

    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(layers.concat(inputs, axis=-1), size=hid_dim * 4,
                       num_flatten_dims=2)
        # alternating direction per layer, as in the reference config
        # (benchmark/fluid/stacked_dynamic_lstm.py)
        lstm, _ = layers.dynamic_lstm(fc, size=hid_dim * 4,
                                      is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]

    fc_last = layers.sequence_pool(inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(inputs[1], pool_type="max")
    return layers.fc(layers.concat([fc_last, lstm_last], axis=1),
                     size=class_dim, act="softmax")


def build_stacked_lstm_train(dict_dim=5000, class_dim=2, emb_dim=64,
                             hid_dim=64, stacked_num=3, lr=1e-3):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        words = layers.data("words", [1], dtype="int64", lod_level=1)
        label = layers.data("label", [1], dtype="int64")
        predict = stacked_lstm_net(words, dict_dim, class_dim, emb_dim,
                                   hid_dim, stacked_num)
        cost = layers.cross_entropy(predict, label)
        avg_cost = layers.mean(cost)
        acc = layers.accuracy(predict, label)
        fluid.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    return prog, startup, ("words", "label"), (avg_cost, acc)
