"""Prebuilt network compositions.

Capability parity: `python/paddle/fluid/nets.py`
(simple_img_conv_pool), as the JAX package's ``nets.py`` builds it. Its
other compositions arrive with later slices.
"""

from paddle_tpu_torch import layers

__all__ = ["simple_img_conv_pool"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act=None, pool_type="max",
                         param_attr=None, bias_attr=None, use_cudnn=True):
    conv_out = layers.conv2d(input, num_filters, filter_size,
                             param_attr=param_attr, bias_attr=bias_attr,
                             act=act)
    return layers.pool2d(conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)
