"""SE-ResNeXt (50/101/152) built on the port's layers.

The port's copy of models/se_resnext.py (the reference benchmark's
SE-ResNeXt, benchmark/fluid/models/se_resnext.py:45-185: conv-bn stem,
grouped 3x3 bottlenecks of cardinality 32/64, squeeze-excitation with
reduction 16, global average pool + dropout 0.5 + fc head): the same ops
with the same names, and the training program of `build_train_net`. The
excitation [N, C] scales the block's [N, C, H, W] output through
`elementwise_mul(x, excite, axis=0)`.
"""
from __future__ import annotations

import math

import paddle_tpu_torch as fluid

_CFG = {  # depth -> (cardinality, per-stage block counts)
    50: (32, (3, 4, 6, 3)),
    101: (32, (3, 4, 23, 3)),
    152: (64, (3, 8, 36, 3)),
}
_NUM_FILTERS = (128, 256, 512, 1024)
_REDUCTION = 16


def _conv_bn(x, ch, k, stride=1, groups=1, act=None, is_train=True):
    x = fluid.layers.conv2d(x, num_filters=ch, filter_size=k, stride=stride,
                            padding=(k - 1) // 2, groups=groups, act=None,
                            bias_attr=False)
    return fluid.layers.batch_norm(x, act=act, is_test=not is_train)


def _squeeze_excitation(x, ch, reduction, is_train=True):
    pooled = fluid.layers.pool2d(x, pool_type='avg', global_pooling=True)
    stdv = 1.0 / math.sqrt(pooled.shape[1])
    squeeze = fluid.layers.fc(
        pooled, size=ch // reduction, act='relu',
        param_attr=fluid.param_attr.ParamAttr(
            initializer=fluid.initializer.Uniform(-stdv, stdv)))
    stdv = 1.0 / math.sqrt(squeeze.shape[1])
    excite = fluid.layers.fc(
        squeeze, size=ch, act='sigmoid',
        param_attr=fluid.param_attr.ParamAttr(
            initializer=fluid.initializer.Uniform(-stdv, stdv)))
    return fluid.layers.elementwise_mul(x, excite, axis=0)


def _shortcut(x, ch_out, stride, is_train=True):
    if x.shape[1] != ch_out or stride != 1:
        return _conv_bn(x, ch_out, 1, stride, is_train=is_train)
    return x


def _bottleneck(x, num_filters, stride, cardinality, is_train=True):
    conv0 = _conv_bn(x, num_filters, 1, act='relu', is_train=is_train)
    conv1 = _conv_bn(conv0, num_filters, 3, stride=stride,
                     groups=cardinality, act='relu', is_train=is_train)
    conv2 = _conv_bn(conv1, num_filters * 2, 1, act=None, is_train=is_train)
    scale = _squeeze_excitation(conv2, num_filters * 2, _REDUCTION,
                                is_train)
    short = _shortcut(x, num_filters * 2, stride, is_train)
    return fluid.layers.elementwise_add(x=short, y=scale, act='relu')


def se_resnext(input, class_dim=1000, depth=50, is_train=True):
    cardinality, blocks = _CFG[depth]
    if depth == 152:
        x = _conv_bn(input, 64, 3, stride=2, act='relu', is_train=is_train)
        x = _conv_bn(x, 64, 3, act='relu', is_train=is_train)
        x = _conv_bn(x, 128, 3, act='relu', is_train=is_train)
    else:
        x = _conv_bn(input, 64, 7, stride=2, act='relu', is_train=is_train)
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                            pool_type='max')
    for stage, n in enumerate(blocks):
        for i in range(n):
            x = _bottleneck(x, _NUM_FILTERS[stage],
                            stride=2 if i == 0 and stage != 0 else 1,
                            cardinality=cardinality, is_train=is_train)
    x = fluid.layers.pool2d(x, pool_size=7, pool_type='avg',
                            global_pooling=True)
    x = fluid.layers.dropout(x, dropout_prob=0.5, is_test=not is_train)
    stdv = 1.0 / math.sqrt(x.shape[1])
    return fluid.layers.fc(
        x, size=class_dim,
        param_attr=fluid.param_attr.ParamAttr(
            initializer=fluid.initializer.Uniform(-stdv, stdv)))


def build_train_net(dshape=(3, 224, 224), class_dim=1000, depth=50,
                    lr=0.01):
    """Returns (images, label, avg_loss, acc)."""
    images = fluid.layers.data(name='data', shape=list(dshape),
                               dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    logits = se_resnext(images, class_dim, depth)
    loss = fluid.layers.softmax_with_cross_entropy(logits=logits,
                                                   label=label)
    avg_loss = fluid.layers.mean(loss)
    probs = fluid.layers.softmax(logits)
    acc = fluid.layers.accuracy(input=probs, label=label)
    fluid.optimizer.Momentum(learning_rate=lr,
                             momentum=0.9).minimize(avg_loss)
    return images, label, avg_loss, acc
