"""SmallNet (cifar-quick) built on the port's layers.

The port's copy of models/smallnet.py (the reference's small CNN
benchmark, benchmark/paddle/image/smallnet_mnist_cifar.py:22-46:
conv5x5(32) -> maxpool3/2 -> conv5x5(32) -> avgpool3/2 -> conv3x3(64) ->
avgpool3/2 -> fc64 -> fc10): the same ops with the same names, and the
training program of `build_train_net` (softmax cross-entropy, mean, top-1
accuracy, Momentum).
"""
from __future__ import annotations

import paddle_tpu_torch as fluid


def smallnet(input, class_dim=10):
    x = fluid.layers.conv2d(input, num_filters=32, filter_size=5,
                            padding=2, act='relu')
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                            pool_type='max')
    x = fluid.layers.conv2d(x, num_filters=32, filter_size=5, padding=2,
                            act='relu')
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                            pool_type='avg')
    x = fluid.layers.conv2d(x, num_filters=64, filter_size=3, padding=1,
                            act='relu')
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                            pool_type='avg')
    x = fluid.layers.fc(x, size=64, act='relu')
    return fluid.layers.fc(x, size=class_dim)


def build_train_net(dshape=(3, 32, 32), class_dim=10, lr=0.01):
    """Returns (images, label, avg_loss, acc)."""
    images = fluid.layers.data(name='data', shape=list(dshape),
                               dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    logits = smallnet(images, class_dim)
    loss = fluid.layers.softmax_with_cross_entropy(logits=logits,
                                                   label=label)
    avg_loss = fluid.layers.mean(loss)
    probs = fluid.layers.softmax(logits)
    acc = fluid.layers.accuracy(input=probs, label=label)
    fluid.optimizer.Momentum(learning_rate=lr,
                             momentum=0.9).minimize(avg_loss)
    return images, label, avg_loss, acc
