"""MNIST classifiers (reference benchmark/fluid/mnist.py and the book's
test_recognize_digits), as the JAX package's ``models/lenet.py`` builds
them. This slice carries the MLP; the LeNet convnet (``model="cnn"``)
needs the convolution and pooling ops, which arrive with a later
slice."""

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers

__all__ = ["mlp", "build_mnist_train"]


def mlp(img, class_dim=10):
    hidden = layers.fc(img, size=200, act="tanh")
    hidden = layers.fc(hidden, size=200, act="tanh")
    return layers.fc(hidden, size=class_dim, act="softmax")


def build_mnist_train(model="cnn", lr=0.01, layout="NCHW"):
    if model != "mlp" or layout != "NCHW":
        raise NotImplementedError(
            "build_mnist_train(model=%r, layout=%r): the convnet arrives "
            "with a later slice; model='mlp' runs" % (model, layout))
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        img = layers.data("img", [784])
        predict = mlp(img)
        label = layers.data("label", [1], dtype="int64")
        cost = layers.cross_entropy(predict, label)
        avg_cost = layers.mean(cost)
        acc = layers.accuracy(predict, label)
        fluid.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    return prog, startup, ("img", "label"), (avg_cost, acc)
