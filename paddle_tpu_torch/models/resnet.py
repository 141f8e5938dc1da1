"""ResNet (50/101/152 bottleneck for ImageNet-shape inputs, 20/32/44/56
basic-block for CIFAR) built on the port's layers.

The port's copy of models/resnet.py (the reference benchmark's model,
benchmark/fluid/models/resnet.py:47-133): it appends the same ops with the
same names. The space-to-depth stem option of the JAX copy, a TPU layout
trick that needs pad/reshape/transpose ops, is not ported.
"""
from __future__ import annotations

import paddle_tpu_torch as fluid


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act='relu',
                  is_train=True):
    conv = fluid.layers.conv2d(input=input, num_filters=ch_out,
                               filter_size=filter_size, stride=stride,
                               padding=padding, act=None, bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act=act, is_test=not is_train)


def shortcut(input, ch_out, stride, is_train=True):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None,
                             is_train=is_train)
    return input


def basicblock(input, ch_out, stride, is_train=True):
    short = shortcut(input, ch_out, stride, is_train=is_train)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_train=is_train)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_train=is_train)
    return fluid.layers.elementwise_add(x=short, y=conv2, act='relu')


def bottleneck_block(input, num_filters, stride, is_train=True):
    short = shortcut(input, num_filters * 4, stride, is_train=is_train)
    conv0 = conv_bn_layer(input, num_filters, 1, 1, 0, is_train=is_train)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride, 1, is_train=is_train)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, 1, 0, act=None,
                          is_train=is_train)
    return fluid.layers.elementwise_add(x=short, y=conv2, act='relu')


def resnet_imagenet(input, class_dim=1000, depth=50, is_train=True):
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
    conv = conv_bn_layer(input, 64, 7, 2, 3, is_train=is_train)
    pool = fluid.layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                               pool_padding=1, pool_type='max')
    num_filters = [64, 128, 256, 512]
    for block in range(len(cfg)):
        for i in range(cfg[block]):
            stride = 2 if i == 0 and block != 0 else 1
            pool = bottleneck_block(pool, num_filters[block], stride,
                                    is_train=is_train)
    pool = fluid.layers.pool2d(input=pool, pool_type='avg',
                               global_pooling=True)
    out = fluid.layers.fc(input=pool, size=class_dim, act=None)
    return out


def resnet_cifar10(input, class_dim=10, depth=32, is_train=True):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv = conv_bn_layer(input, 16, 3, 1, 1, is_train=is_train)
    for ch, stride in ((16, 1), (32, 2), (64, 2)):
        for i in range(n):
            conv = basicblock(conv, ch, stride if i == 0 else 1,
                              is_train=is_train)
    pool = fluid.layers.pool2d(input=conv, pool_type='avg',
                               global_pooling=True)
    out = fluid.layers.fc(input=pool, size=class_dim, act=None)
    return out
