"""SmallNet — the CIFAR-10 "quick" net (reference
`benchmark/paddle/image/smallnet_mnist_cifar.py`, after Caffe's
cifar10_quick: conv5x5/32 maxpool, conv5x5/32 avgpool, conv3x3/64
avgpool, fc64, fc10; published K40m number at
benchmark/README.md:53-59)."""

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers

__all__ = ["smallnet", "build_smallnet_train"]


def smallnet(input, class_dim=10):
    c1 = layers.conv2d(input, 32, 5, stride=1, padding=2, act="relu")
    p1 = layers.pool2d(c1, pool_size=3, pool_stride=2, pool_padding=1,
                       pool_type="max")
    c2 = layers.conv2d(p1, 32, 5, stride=1, padding=2, act="relu")
    p2 = layers.pool2d(c2, pool_size=3, pool_stride=2, pool_padding=1,
                       pool_type="avg")
    c3 = layers.conv2d(p2, 64, 3, stride=1, padding=1, act="relu")
    p3 = layers.pool2d(c3, pool_size=3, pool_stride=2, pool_padding=1,
                       pool_type="avg")
    fc1 = layers.fc(p3, 64, act="relu")
    return layers.fc(fc1, class_dim, act="softmax")


def build_smallnet_train(image_shape=(3, 32, 32), class_dim=10, lr=0.01):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        img = layers.data("data", list(image_shape))
        label = layers.data("label", [1], dtype="int64")
        predict = smallnet(img, class_dim)
        cost = layers.cross_entropy(predict, label)
        avg_cost = layers.mean(cost)
        acc = layers.accuracy(predict, label)
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=0.9).minimize(avg_cost)
    return prog, startup, ("data", "label"), (avg_cost, acc)
