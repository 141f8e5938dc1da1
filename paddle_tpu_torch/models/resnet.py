"""ResNet (50/101/152 bottleneck for ImageNet-shape inputs, 20/32/44/56
basic-block for CIFAR) built on the port's layers.

The port's copy of models/resnet.py (the reference benchmark's model,
benchmark/fluid/models/resnet.py:47-133): it appends the same ops with the
same names, the space-to-depth stem (`s2d_stem`) and the training program
of `build_train_net` (softmax cross-entropy, mean, top-1 accuracy and
Momentum) included.
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


def _s2d_stem(input, is_train):
    """Space-to-depth stem: pad the image by 3 on each side, fold each 2x2
    pixel block into the channels ([B, 3, 230, 230] -> [B, 12, 115, 115])
    and run a 4x4/s1 conv with no padding. Its window covers padded rows
    [2o, 2o+7] for output o, a superset of the 7x7/s2/p3 stem's [2o, 2o+6],
    so it gives the same 112x112 outputs from a 12-channel input."""
    x = fluid.layers.pad(input, paddings=[0, 0, 0, 0, 3, 3, 3, 3])
    n, c, h, w = x.shape
    x = fluid.layers.reshape(x, shape=[-1, c, h // 2, 2, w // 2, 2])
    x = fluid.layers.transpose(x, perm=[0, 1, 3, 5, 2, 4])
    x = fluid.layers.reshape(x, shape=[-1, c * 4, h // 2, w // 2])
    return conv_bn_layer(x, 64, 4, 1, 0, is_train=is_train)


def resnet_imagenet(input, class_dim=1000, depth=50, is_train=True,
                    s2d_stem=False):
    """s2d_stem takes the space-to-depth stem, at 224x224 input only."""
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
    if s2d_stem and input.shape[2] == 224 and input.shape[3] == 224:
        conv = _s2d_stem(input, is_train)
    else:
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


def build_train_net(batch_size=None, dshape=(3, 32, 32), class_dim=10,
                    depth=32, imagenet=False, lr=0.1, s2d_stem=False):
    """Returns (images, label, avg_loss, acc) with Momentum(lr, 0.9)'s
    backward and update ops appended."""
    images = fluid.layers.data(name='data', shape=list(dshape),
                               dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    if imagenet:
        logits = resnet_imagenet(images, class_dim, depth=depth,
                                 s2d_stem=s2d_stem)
    else:
        logits = resnet_cifar10(images, class_dim, depth=depth)
    loss = fluid.layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_loss = fluid.layers.mean(loss)
    probs = fluid.layers.softmax(logits)
    acc = fluid.layers.accuracy(input=probs, label=label)
    opt = fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9)
    opt.minimize(avg_loss)
    return images, label, avg_loss, acc
