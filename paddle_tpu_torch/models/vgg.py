"""VGG-16 (reference benchmark/fluid/vgg.py vgg16_bn_drop :51-79)."""

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers, nets

__all__ = ["vgg16_bn_drop", "build_vgg16_train"]


def vgg16_bn_drop(input, class_dim):
    def conv_block(inp, num_filter, groups, dropouts):
        return nets.img_conv_group(
            inp, conv_num_filter=[num_filter] * groups, pool_size=2,
            pool_stride=2, conv_filter_size=3, conv_act="relu",
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts)

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(conv5, dropout_prob=0.5)
    fc1 = layers.fc(drop, size=512, act=None)
    bn = layers.batch_norm(fc1, act="relu")
    drop2 = layers.dropout(bn, dropout_prob=0.5)
    fc2 = layers.fc(drop2, size=512, act=None)
    return layers.fc(fc2, size=class_dim, act="softmax")


def build_vgg16_train(image_shape=(3, 32, 32), class_dim=10, lr=0.01,
                      layout="NCHW"):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        img = layers.data("data", list(image_shape))
        label = layers.data("label", [1], dtype="int64")
        predict = vgg16_bn_drop(img, class_dim)
        cost = layers.cross_entropy(predict, label)
        avg_cost = layers.mean(cost)
        acc = layers.accuracy(predict, label)
        if layout == "NHWC":
            fluid.passes.enable(prog, layout="NHWC")
        fluid.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    return prog, startup, ("data", "label"), (avg_cost, acc)
