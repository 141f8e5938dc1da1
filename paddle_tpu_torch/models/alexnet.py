"""AlexNet built on the port's layers.

The port's copy of models/alexnet.py (the classic 5-conv/3-fc topology of
the reference's benchmark, benchmark/README.md:37): the same ops with the
same names, the two dropout(0.5) + fc-4096 heads and the training program
of `build_train_net` (softmax cross-entropy, mean, top-1 accuracy,
Momentum).
"""
from __future__ import annotations

import paddle_tpu_torch as fluid


def alexnet(input, class_dim=1000, is_train=True):
    x = fluid.layers.conv2d(input, num_filters=64, filter_size=11,
                            stride=4, padding=2, act='relu')
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2, pool_type='max')
    x = fluid.layers.conv2d(x, num_filters=192, filter_size=5, padding=2,
                            act='relu')
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2, pool_type='max')
    x = fluid.layers.conv2d(x, num_filters=384, filter_size=3, padding=1,
                            act='relu')
    x = fluid.layers.conv2d(x, num_filters=256, filter_size=3, padding=1,
                            act='relu')
    x = fluid.layers.conv2d(x, num_filters=256, filter_size=3, padding=1,
                            act='relu')
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2, pool_type='max')
    for size in (4096, 4096):
        x = fluid.layers.dropout(x, dropout_prob=0.5, is_test=not is_train)
        x = fluid.layers.fc(x, size=size, act='relu')
    return fluid.layers.fc(x, size=class_dim)


def build_train_net(dshape=(3, 224, 224), class_dim=1000, lr=0.01):
    """Returns (images, label, avg_loss, acc)."""
    images = fluid.layers.data(name='data', shape=list(dshape),
                               dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    logits = alexnet(images, class_dim)
    loss = fluid.layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_loss = fluid.layers.mean(loss)
    probs = fluid.layers.softmax(logits)
    acc = fluid.layers.accuracy(input=probs, label=label)
    fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(avg_loss)
    return images, label, avg_loss, acc
