"""VGG (16/19) built on the port's layers.

The port's copy of models/vgg.py (the reference benchmark's VGG,
benchmark/fluid/models/vgg.py: groups of 3x3 convs and a 2x2 max pool,
two dropout + fc + batch_norm heads, an fc classifier): the same ops with
the same names, and the training program of `build_train_net`. The heads'
batch_norm runs on a 2-D [N, 4096] input, so its apply is the bn_apply
kernel with an inner size of 1.
"""
from __future__ import annotations

import paddle_tpu_torch as fluid

_CFG = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}


def _conv_block(x, ch, n):
    for _ in range(n):
        x = fluid.layers.conv2d(x, num_filters=ch, filter_size=3,
                                padding=1, act='relu')
    return fluid.layers.pool2d(x, pool_size=2, pool_type='max',
                               pool_stride=2)


def vgg_net(input, class_dim=1000, depth=19, is_train=True):
    cfg = _CFG[depth]
    x = input
    for ch, n in zip((64, 128, 256, 512, 512), cfg):
        x = _conv_block(x, ch, n)
    for _ in range(2):
        x = fluid.layers.dropout(x, dropout_prob=0.5, is_test=not is_train)
        x = fluid.layers.fc(x, size=4096, act=None)
        x = fluid.layers.batch_norm(x, act='relu', is_test=not is_train)
    return fluid.layers.fc(x, size=class_dim)


def build_train_net(dshape=(3, 224, 224), class_dim=1000, depth=19, lr=0.01):
    """Returns (images, label, avg_loss, acc)."""
    images = fluid.layers.data(name='data', shape=list(dshape),
                               dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    logits = vgg_net(images, class_dim, depth)
    loss = fluid.layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_loss = fluid.layers.mean(loss)
    probs = fluid.layers.softmax(logits)
    acc = fluid.layers.accuracy(input=probs, label=label)
    fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(avg_loss)
    return images, label, avg_loss, acc
