"""CRNN + CTC OCR recognition on the port's layers (the port's copy of
models/crnn.py, with its signatures, program and return values): a
conv-bn-pool backbone, im2sequence's column slicing, two stacked
bidirectional dynamic GRUs, a num_classes+1 projection, warpctc over
variable-length LoD labels, and ctc_greedy_decoder + edit_distance for
evaluation. Images arrive at a fixed [1, H, W]; only the labels are
variable-length (LoD)."""
from __future__ import annotations

import paddle_tpu_torch as fluid


def _conv_block(x, ch, n_conv, pool_stride, is_train=True):
    for _ in range(n_conv):
        x = fluid.layers.conv2d(x, num_filters=ch, filter_size=3,
                                stride=1, padding=1, act=None,
                                bias_attr=False)
        x = fluid.layers.batch_norm(x, act='relu', is_test=not is_train)
    return fluid.layers.pool2d(x, pool_size=2, pool_type='max',
                               pool_stride=pool_stride)


def ctc_encoder(images, num_classes, rnn_hidden=96, is_train=True):
    """images [B, 1, H, W] -> per-column logits as a LoD sequence
    [B*W', num_classes+1] (blank = num_classes)."""
    x = _conv_block(images, 16, 2, [2, 2], is_train)
    x = _conv_block(x, 32, 2, [2, 2], is_train)
    x = _conv_block(x, 64, 2, [2, 1], is_train)   # keep width resolution
    x = _conv_block(x, 96, 2, [2, 1], is_train)
    # [B, C, H', W'] -> one sequence step per image column (im2sequence
    # with the full remaining height as the kernel)
    h_now = x.shape[2]
    seq = fluid.layers.im2sequence(x, filter_size=[h_now, 1],
                                   stride=[1, 1], padding=[0, 0, 0, 0])

    def bigru(inp, hidden):
        fc_f = fluid.layers.fc(inp, size=hidden * 3)
        fc_b = fluid.layers.fc(inp, size=hidden * 3)
        g_f = fluid.layers.dynamic_gru(fc_f, size=hidden)
        g_b = fluid.layers.dynamic_gru(fc_b, size=hidden, is_reverse=True)
        return g_f, g_b

    g1f, g1b = bigru(seq, rnn_hidden)
    merged = fluid.layers.concat([g1f, g1b], axis=1)
    g2f, g2b = bigru(merged, rnn_hidden)   # the second stacked BiGRU
    merged2 = fluid.layers.concat([g2f, g2b], axis=1)
    return fluid.layers.fc(merged2, size=num_classes + 1)


def build_crnn_train(num_classes=95, img_h=32, img_w=96, lr=1e-3,
                     rnn_hidden=96):
    """Returns (images, label, avg_cost, decoded, edit_dist)."""
    images = fluid.layers.data(name='pixel', shape=[1, img_h, img_w],
                               dtype='float32')
    label = fluid.layers.data(name='label', shape=[1], dtype='int32',
                              lod_level=1)
    logits = ctc_encoder(images, num_classes, rnn_hidden)
    cost = fluid.layers.warpctc(input=logits, label=label,
                                blank=num_classes, norm_by_times=True)
    avg_cost = fluid.layers.mean(cost)
    # evaluation path: best-path decode and edit distance to the label
    decoded = fluid.layers.ctc_greedy_decoder(input=logits,
                                              blank=num_classes)
    edit, _seq_num = fluid.layers.edit_distance(input=decoded, label=label)
    fluid.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    return images, label, avg_cost, decoded, edit
