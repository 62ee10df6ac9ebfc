"""AlexNet (reference `benchmark/paddle/image/alexnet.py`: conv1 11x11/4
-> LRN -> pool, conv2 5x5 -> LRN -> pool, conv3-5 3x3, pool, two
dropout(0.5) fc4096, fc1000 softmax; published K40m numbers at
benchmark/README.md:33-38)."""

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers

__all__ = ["alexnet", "build_alexnet_train"]


def alexnet(input, class_dim=1000, groups=1):
    conv1 = layers.conv2d(input, 96, 11, stride=4, padding=1, act="relu")
    norm1 = layers.lrn(conv1, n=5, alpha=1e-4, beta=0.75)
    pool1 = layers.pool2d(norm1, pool_size=3, pool_stride=2,
                          pool_type="max")

    conv2 = layers.conv2d(pool1, 256, 5, stride=1, padding=2,
                          groups=groups, act="relu")
    norm2 = layers.lrn(conv2, n=5, alpha=1e-4, beta=0.75)
    pool2 = layers.pool2d(norm2, pool_size=3, pool_stride=2,
                          pool_type="max")

    conv3 = layers.conv2d(pool2, 384, 3, stride=1, padding=1, act="relu")
    conv4 = layers.conv2d(conv3, 384, 3, stride=1, padding=1,
                          groups=groups, act="relu")
    conv5 = layers.conv2d(conv4, 256, 3, stride=1, padding=1,
                          groups=groups, act="relu")
    pool5 = layers.pool2d(conv5, pool_size=3, pool_stride=2,
                          pool_type="max")

    fc6 = layers.dropout(layers.fc(pool5, 4096, act="relu"),
                         dropout_prob=0.5)
    fc7 = layers.dropout(layers.fc(fc6, 4096, act="relu"),
                         dropout_prob=0.5)
    return layers.fc(fc7, class_dim, act="softmax")


def build_alexnet_train(image_shape=(3, 227, 227), class_dim=1000,
                        lr=0.01):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        img = layers.data("data", list(image_shape))
        label = layers.data("label", [1], dtype="int64")
        predict = alexnet(img, class_dim)
        cost = layers.cross_entropy(predict, label)
        avg_cost = layers.mean(cost)
        acc = layers.accuracy(predict, label)
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=0.9).minimize(avg_cost)
    return prog, startup, ("data", "label"), (avg_cost, acc)
