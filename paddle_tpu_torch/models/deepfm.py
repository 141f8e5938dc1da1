"""DeepFM CTR model built on the port's layers (the port's copy of
models/deepfm.py, the same program op for op).

N categorical id fields and dense features: a first-order term (a weight
per feature), an FM second-order term by the sum-square trick over the
field embeddings, and a DNN tower over the concatenated embeddings. The
embeddings take is_sparse=True, so their gradients are SelectedRows
(core/selected_rows.py, ref lookup_table_op.cc sparse grads), and lazy
Adam updates only the rows a batch looked up.
"""
from __future__ import annotations

import paddle_tpu_torch as fluid


def build_deepfm_train(num_fields=26, dense_dim=13, vocab=100000,
                       embed_dim=16, dnn_dims=(400, 400, 400), lr=1e-3):
    """Returns (feeds, avg_loss); feeds = [(name, shape, dtype, vocab)]."""
    sparse_ids = fluid.layers.data(name='field_ids', shape=[num_fields],
                                   dtype='int64')
    dense = fluid.layers.data(name='dense_x', shape=[dense_dim],
                              dtype='float32')
    label = fluid.layers.data(name='click', shape=[1], dtype='float32')

    # first-order: one scalar weight per sparse feature + dense linear
    first = fluid.layers.embedding(sparse_ids, size=[vocab, 1],
                                   is_sparse=True,
                                   param_attr=fluid.ParamAttr(name='fm_w1'))
    first = fluid.layers.reduce_sum(first, dim=1)              # [B, 1]
    first = first + fluid.layers.fc(dense, size=1)

    # second-order FM over field embeddings: 0.5 * ((Σv)² - Σv²)
    emb = fluid.layers.embedding(sparse_ids, size=[vocab, embed_dim],
                                 is_sparse=True,
                                 param_attr=fluid.ParamAttr(name='fm_v'))
    sum_v = fluid.layers.reduce_sum(emb, dim=1)                # [B, k]
    sum_sq = fluid.layers.square(sum_v)
    sq_sum = fluid.layers.reduce_sum(fluid.layers.square(emb), dim=1)
    second = 0.5 * fluid.layers.reduce_sum(sum_sq - sq_sum, dim=1,
                                           keep_dim=True)      # [B, 1]

    # DNN tower over [B, num_fields * k] + dense
    flat = fluid.layers.reshape(emb, shape=[-1, num_fields * embed_dim])
    h = fluid.layers.concat([flat, dense], axis=1)
    for d in dnn_dims:
        h = fluid.layers.fc(h, size=d, act='relu')
    dnn_out = fluid.layers.fc(h, size=1)

    logit = first + second + dnn_out
    loss = fluid.layers.sigmoid_cross_entropy_with_logits(logit, label)
    avg_loss = fluid.layers.mean(loss)
    # lazy_mode: rowwise sparse adam over the embedding tables (the CTR
    # configuration; non-lazy densifies every table each step)
    fluid.optimizer.Adam(learning_rate=lr, lazy_mode=True).minimize(avg_loss)

    feeds = [('field_ids', (num_fields,), 'int64', vocab),
             ('dense_x', (dense_dim,), 'float32', 0),
             ('click', (1,), 'float32', 2)]
    return feeds, avg_loss
