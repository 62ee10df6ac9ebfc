"""Prebuilt network compositions.

Capability parity: `python/paddle/fluid/nets.py` (simple_img_conv_pool,
img_conv_group, sequence_conv_pool, glu, scaled_dot_product_attention),
as the JAX package's ``nets.py`` builds them.
"""

from paddle_tpu_torch import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act=None, pool_type="max",
                         param_attr=None, bias_attr=None, use_cudnn=True):
    conv_out = layers.conv2d(input, num_filters, filter_size,
                             param_attr=param_attr, bias_attr=bias_attr,
                             act=act)
    return layers.pool2d(conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    tmp = input
    if isinstance(conv_padding, int):
        conv_padding = [conv_padding] * len(conv_num_filter)
    if not isinstance(conv_with_batchnorm, (list, tuple)):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    if not isinstance(conv_batchnorm_drop_rate, (list, tuple)):
        conv_batchnorm_drop_rate = \
            [conv_batchnorm_drop_rate] * len(conv_num_filter)
    for i, nf in enumerate(conv_num_filter):
        local_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(tmp, nf, conv_filter_size,
                            padding=conv_padding[i], act=local_act,
                            param_attr=param_attr)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i]:
                tmp = layers.dropout(tmp, conv_batchnorm_drop_rate[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    conv_out = layers.sequence_conv(input, num_filters, filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(conv_out, pool_type)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention (reference nets.py) over
    dense [B, T, D] tensors, composed of ops: matmul, softmax, matmul
    (the fused kernel is ``layers.flash_attention``)."""
    d_k = int(queries.shape[-1]) // num_heads

    def _split_heads(x):
        if num_heads == 1:
            return x
        x = layers.reshape(x, [0, 0, num_heads, int(x.shape[-1]) // num_heads])
        return layers.transpose(x, [0, 2, 1, 3])

    q, k, v = map(_split_heads, (queries, keys, values))
    scores = layers.matmul(q, k, transpose_y=True, alpha=d_k ** -0.5)
    weights = layers.softmax(scores)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_rate)
    ctx = layers.matmul(weights, v)
    if num_heads > 1:
        ctx = layers.transpose(ctx, [0, 2, 1, 3])
        ctx = layers.reshape(ctx, [0, 0, num_heads * d_k])
    return ctx
