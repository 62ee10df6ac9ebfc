"""LeNet-style MNIST convnet and the MNIST MLP (reference
benchmark/fluid/mnist.py cnn_model :41-60 and the book's
test_recognize_digits), as the JAX package's ``models/lenet.py`` builds
them."""

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers, nets

__all__ = ["lenet", "mlp", "build_mnist_train"]


def lenet(img, class_dim=10):
    conv_pool_1 = nets.simple_img_conv_pool(
        img, num_filters=20, filter_size=5, pool_size=2, pool_stride=2,
        act="relu")
    conv_pool_2 = nets.simple_img_conv_pool(
        conv_pool_1, num_filters=50, filter_size=5, pool_size=2,
        pool_stride=2, act="relu")
    return layers.fc(conv_pool_2, size=class_dim, act="softmax")


def mlp(img, class_dim=10):
    hidden = layers.fc(img, size=200, act="tanh")
    hidden = layers.fc(hidden, size=200, act="tanh")
    return layers.fc(hidden, size=class_dim, act="softmax")


def build_mnist_train(model="cnn", lr=0.01, layout="NCHW"):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        if model == "cnn":
            img = layers.data("img", [1, 28, 28])
            predict = lenet(img)
        else:
            img = layers.data("img", [784])
            predict = mlp(img)
        label = layers.data("label", [1], dtype="int64")
        cost = layers.cross_entropy(predict, label)
        avg_cost = layers.mean(cost)
        acc = layers.accuracy(predict, label)
        if layout == "NHWC" and model == "cnn":
            fluid.passes.enable(prog, layout="NHWC")
        fluid.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    return prog, startup, ("img", "label"), (avg_cost, acc)
