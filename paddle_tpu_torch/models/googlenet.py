"""GoogLeNet (Inception v1) built on the port's layers.

The port's copy of models/googlenet.py (the reference's benchmark config,
benchmark/paddle/image/googlenet.py:104-240: 7x7/2 stem, 1x1+3x3 stage 2,
inception stages 3a-5b with the classic filter table, 7x7 average pool,
dropout 0.4, fc-1000 head, no auxiliary heads): the same ops with the same
names, each inception's four branches joined by a `concat` on the channel
axis, and the training program of `build_train_net`.
"""
from __future__ import annotations

import paddle_tpu_torch as fluid


def _conv(x, ch, k, stride=1, pad=0):
    return fluid.layers.conv2d(x, num_filters=ch, filter_size=k,
                               stride=stride, padding=pad, act='relu')


def _inception(x, f1, f3r, f3, f5r, f5, proj):
    branch1 = _conv(x, f1, 1)
    branch3 = _conv(_conv(x, f3r, 1), f3, 3, pad=1)
    branch5 = _conv(_conv(x, f5r, 1), f5, 5, pad=2)
    pooled = fluid.layers.pool2d(x, pool_size=3, pool_stride=1,
                                 pool_padding=1, pool_type='max')
    branchp = _conv(pooled, proj, 1)
    return fluid.layers.concat([branch1, branch3, branch5, branchp], axis=1)


def googlenet(input, class_dim=1000, is_train=True):
    x = _conv(input, 64, 7, stride=2, pad=3)                   # stage 1
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2, pool_type='max')
    x = _conv(_conv(x, 64, 1), 192, 3, pad=1)                  # stage 2
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2, pool_type='max')
    x = _inception(x, 64, 96, 128, 16, 32, 32)                 # 3a
    x = _inception(x, 128, 128, 192, 32, 96, 64)               # 3b
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2, pool_type='max')
    x = _inception(x, 192, 96, 208, 16, 48, 64)                # 4a
    x = _inception(x, 160, 112, 224, 24, 64, 64)               # 4b
    x = _inception(x, 128, 128, 256, 24, 64, 64)               # 4c
    x = _inception(x, 112, 144, 288, 32, 64, 64)               # 4d
    x = _inception(x, 256, 160, 320, 32, 128, 128)             # 4e
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2, pool_type='max')
    x = _inception(x, 256, 160, 320, 32, 128, 128)             # 5a
    x = _inception(x, 384, 192, 384, 48, 128, 128)             # 5b
    x = fluid.layers.pool2d(x, pool_size=7, pool_type='avg',
                            global_pooling=True)
    x = fluid.layers.dropout(x, dropout_prob=0.4, is_test=not is_train)
    return fluid.layers.fc(x, size=class_dim)


# forward MACs @224 for the v1 filter table above (conv+fc, standard count)
GOOGLENET_FWD_MACS = 1.59e9


def build_train_net(dshape=(3, 224, 224), class_dim=1000, lr=0.01):
    """Returns (images, label, avg_loss, acc)."""
    images = fluid.layers.data(name='data', shape=list(dshape),
                               dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    logits = googlenet(images, class_dim)
    loss = fluid.layers.softmax_with_cross_entropy(logits=logits,
                                                   label=label)
    avg_loss = fluid.layers.mean(loss)
    probs = fluid.layers.softmax(logits)
    acc = fluid.layers.accuracy(input=probs, label=label)
    fluid.optimizer.Momentum(learning_rate=lr,
                             momentum=0.9).minimize(avg_loss)
    return images, label, avg_loss, acc
