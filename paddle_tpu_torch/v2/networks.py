"""v2 prebuilt network compositions.

Capability parity: `python/paddle/trainer_config_helpers/networks.py`
(simple_img_conv_pool, sequence_conv_pool, bidirectional_lstm,
simple_gru, simple_attention)."""

from paddle_tpu_torch import layers as L
from paddle_tpu_torch.v2 import layer as v2l
from paddle_tpu_torch.v2.activation import act_name

__all__ = ["simple_img_conv_pool", "sequence_conv_pool",
           "bidirectional_lstm", "simple_gru", "simple_attention"]


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride, act=None, **kw):
    return v2l.simple_img_conv_pool(input, filter_size, num_filters,
                                    pool_size, pool_stride, act=act, **kw)


def sequence_conv_pool(input, context_len, hidden_size,
                       pool_type=None, act=None):
    conv = L.sequence_conv(input, num_filters=hidden_size,
                           filter_size=context_len,
                           act=act_name(act) or "tanh")
    return v2l.pooling(conv, pooling_type=pool_type)


def bidirectional_lstm(input, size, return_unmerged=False):
    fwd = v2l.simple_lstm(input, size)
    bwd = v2l.simple_lstm(input, size, reverse=True)
    if return_unmerged:
        return fwd, bwd
    return L.concat([fwd, bwd], axis=-1)


def simple_gru(input, size, reverse=False):
    return v2l.gru(input, size, reverse=reverse)


def simple_attention(encoded_sequence, encoded_proj, decoder_state):
    """Bahdanau attention context (networks.py simple_attention)."""
    dec_proj = L.fc(decoder_state, int(encoded_proj.shape[-1]),
                    bias_attr=False)
    expanded = L.sequence_expand(dec_proj, encoded_proj)
    mix = L.tanh(L.elementwise_add(encoded_proj, expanded))
    scores = L.fc(mix, 1, num_flatten_dims=2, bias_attr=False)
    weights = L.sequence_softmax(scores)
    scaled = L.elementwise_mul(encoded_sequence, weights, axis=0)
    return L.sequence_pool(scaled, pool_type="sum")
