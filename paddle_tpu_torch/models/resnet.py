"""ResNet models built on the layers DSL.

Capability parity: `benchmark/fluid/resnet.py` (conv_bn_layer :90,
shortcut :100, basicblock/bottleneck :110-125, resnet_imagenet :132,
resnet_cifar10 :148), as the JAX package's ``models/resnet.py`` builds
them. ``recompute=True`` wraps each residual block in a
``RecomputeRegion`` (``bench.py --recompute``).
"""

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers

__all__ = ["resnet_imagenet", "resnet_cifar10", "build_resnet50_train",
           "build_resnet50_infer"]


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False):
    conv1 = layers.conv2d(input, ch_out, filter_size, stride=stride,
                          padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(conv1, act=act, is_test=is_test)


def shortcut(input, ch_out, stride, is_test=False):
    ch_in = int(input.shape[1])
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None,
                             is_test=is_test)
    return input


def basicblock(input, ch_out, stride, is_test=False):
    short = shortcut(input, ch_out, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test)
    return layers.elementwise_add(short, conv2, act="relu")


def bottleneck(input, ch_out, stride, is_test=False):
    short = shortcut(input, ch_out * 4, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test)
    return layers.elementwise_add(short, conv3, act="relu")


def _recompute_block(block_func):
    """Wrap a residual block in a RecomputeRegion: its activations are
    rematerialized during backward instead of stashed."""
    def wrapped(input, ch_out, stride, is_test=False):
        rr = layers.RecomputeRegion()
        with rr.scope():
            out = block_func(rr.input(input), ch_out, stride,
                             is_test=is_test)
            rr.output(out)
        return rr()
    return wrapped


def layer_warp(block_func, input, ch_out, count, stride, is_test=False,
               recompute=False):
    if recompute:
        block_func = _recompute_block(block_func)
    res_out = block_func(input, ch_out, stride, is_test=is_test)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_test=is_test)
    return res_out


def resnet_imagenet(input, class_dim, depth=50, is_test=False,
                    recompute=False):
    cfg = {
        18: ([2, 2, 2, 2], basicblock),
        34: ([3, 4, 6, 3], basicblock),
        50: ([3, 4, 6, 3], bottleneck),
        101: ([3, 4, 23, 3], bottleneck),
        152: ([3, 8, 36, 3], bottleneck),
    }
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, 64, 7, 2, 3, is_test=is_test)
    pool1 = layers.pool2d(conv1, pool_size=3, pool_stride=2, pool_padding=1,
                          pool_type="max")
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1,
                      is_test=is_test, recompute=recompute)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2,
                      is_test=is_test, recompute=recompute)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2,
                      is_test=is_test, recompute=recompute)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2,
                      is_test=is_test, recompute=recompute)
    pool2 = layers.pool2d(res4, pool_type="avg", global_pooling=True)
    out = layers.fc(pool2, size=class_dim, act="softmax")
    return out


def resnet_cifar10(input, class_dim, depth=32, is_test=False):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, 16, 3, 1, 1, is_test=is_test)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_test=is_test)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_test=is_test)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_test=is_test)
    pool = layers.pool2d(res3, pool_type="avg", global_pooling=True)
    out = layers.fc(pool, size=class_dim, act="softmax")
    return out


def build_resnet50_train(batch_size=None, image_shape=(3, 224, 224),
                         class_dim=1000, lr=0.1, depth=50, layout="NCHW",
                         recompute=False):
    """Build (main_program, startup_program, feeds, fetches) for a ResNet
    training step (the benchmark/fluid/resnet.py program shape).

    ``layout="NHWC"`` runs the whole image domain channels-minor via the
    layout pass (``paddle_tpu_torch.passes``), forward and backward with
    no layout copies, and the feed then takes NHWC batches."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        img = layers.data("data", list(image_shape))
        label = layers.data("label", [1], dtype="int64")
        predict = resnet_imagenet(img, class_dim, depth=depth,
                                  recompute=recompute)
        cost = layers.cross_entropy(predict, label)
        avg_cost = layers.mean(cost)
        acc = layers.accuracy(predict, label)
        if layout == "NHWC":
            fluid.passes.enable(prog, layout="NHWC")
        opt = fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9)
        opt.minimize(avg_cost)
    return prog, startup, ("data", "label"), (avg_cost, acc)


def build_resnet50_infer(image_shape=(3, 224, 224), class_dim=1000, depth=50):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        img = layers.data("data", list(image_shape))
        predict = resnet_imagenet(img, class_dim, depth=depth, is_test=True)
    return prog, startup, ("data",), (predict,)
