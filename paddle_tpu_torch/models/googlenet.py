"""GoogLeNet v1 (reference `benchmark/paddle/image/googlenet.py`: the
benchmark variant — aux heads removed; inception branch projections are
linear, relu applied after the concat; published K40m numbers at
benchmark/README.md:46-51)."""

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers

__all__ = ["googlenet", "build_googlenet_train"]


def _inception(input, f1, f3r, f3, f5r, f5, proj):
    # branch projections stay LINEAR; relu lands after the concat
    # (reference inception(): conv_projection + ReluActivation concat)
    b1 = layers.conv2d(input, f1, 1, act=None)
    b3r = layers.conv2d(input, f3r, 1, act="relu")
    b3 = layers.conv2d(b3r, f3, 3, padding=1, act=None)
    b5r = layers.conv2d(input, f5r, 1, act="relu")
    b5 = layers.conv2d(b5r, f5, 5, padding=2, act=None)
    pool = layers.pool2d(input, pool_size=3, pool_stride=1,
                         pool_padding=1, pool_type="max")
    bp = layers.conv2d(pool, proj, 1, act=None)
    return layers.relu(layers.concat([b1, b3, b5, bp], axis=1))


def googlenet(input, class_dim=1000):
    conv1 = layers.conv2d(input, 64, 7, stride=2, padding=3, act="relu")
    pool1 = layers.pool2d(conv1, pool_size=3, pool_stride=2,
                          pool_type="max")

    conv2_1 = layers.conv2d(pool1, 64, 1, act="relu")
    conv2_2 = layers.conv2d(conv2_1, 192, 3, padding=1, act="relu")
    pool2 = layers.pool2d(conv2_2, pool_size=3, pool_stride=2,
                          pool_type="max")

    i3a = _inception(pool2, 64, 96, 128, 16, 32, 32)
    i3b = _inception(i3a, 128, 128, 192, 32, 96, 64)
    pool3 = layers.pool2d(i3b, pool_size=3, pool_stride=2,
                          pool_type="max")

    i4a = _inception(pool3, 192, 96, 208, 16, 48, 64)
    i4b = _inception(i4a, 160, 112, 224, 24, 64, 64)
    i4c = _inception(i4b, 128, 128, 256, 24, 64, 64)
    i4d = _inception(i4c, 112, 144, 288, 32, 64, 64)
    i4e = _inception(i4d, 256, 160, 320, 32, 128, 128)
    pool4 = layers.pool2d(i4e, pool_size=3, pool_stride=2,
                          pool_type="max")

    i5a = _inception(pool4, 256, 160, 320, 32, 128, 128)
    i5b = _inception(i5a, 384, 192, 384, 48, 128, 128)
    pool5 = layers.pool2d(i5b, pool_type="avg", global_pooling=True)

    return layers.fc(pool5, class_dim, act="softmax")


def build_googlenet_train(image_shape=(3, 224, 224), class_dim=1000,
                          lr=0.01):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        img = layers.data("data", list(image_shape))
        label = layers.data("label", [1], dtype="int64")
        predict = googlenet(img, class_dim)
        cost = layers.cross_entropy(predict, label)
        avg_cost = layers.mean(cost)
        acc = layers.accuracy(predict, label)
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=0.9).minimize(avg_cost)
    return prog, startup, ("data", "label"), (avg_cost, acc)
