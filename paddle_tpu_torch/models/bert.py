"""BERT encoder with its masked-LM head, built on the port's layers: the
forward of models/bert.py:17-66 (build_bert_pretrain), from the token and
segment feeds to the [B*S, vocab] logits that feed its loss.

It appends the same layers in the same order as the JAX builder, so under
a fresh unique_name.guard() the parameters carry the same names (word_emb,
sent_emb, pos_emb, fc_N.w_0, fc_N.b_0, layer_norm_N.w_0, layer_norm_N.b_0)
and a directory saved by either package serves in the other. Dropout,
the masked-LM loss and Adam.minimize come with the training slice.
"""
from __future__ import annotations

import paddle_tpu_torch as fluid

from .transformer import encoder_layer


def bert_mlm_logits(vocab=30522, max_len=128, d_model=768, d_ff=3072,
                    n_head=12, n_layer=12, type_vocab=2):
    """Returns (feeds, logits2d): feeds = [(name, shape, dtype)] of the two
    int64 inputs, logits2d the [-1, vocab] masked-LM logits."""
    S = max_len
    tok = fluid.layers.data(name='tok_ids', shape=[S], dtype='int64')
    seg = fluid.layers.data(name='seg_ids', shape=[S], dtype='int64')

    def emb(ids, size, name):
        e = fluid.layers.embedding(
            ids, size=size,
            param_attr=fluid.ParamAttr(
                name=name,
                initializer=fluid.initializer.Normal(0., 0.02)))
        return fluid.layers.reshape(e, shape=[-1, S, size[1]])

    pos_ids = fluid.layers.reshape(
        fluid.layers.range(0, S, 1, 'int64'), shape=[S, 1])
    x = emb(tok, [vocab, d_model], 'word_emb') \
        + emb(seg, [type_vocab, d_model], 'sent_emb')
    pos = fluid.layers.embedding(
        pos_ids, size=[S, d_model],
        param_attr=fluid.ParamAttr(
            name='pos_emb', initializer=fluid.initializer.Normal(0., 0.02)))
    x = x + fluid.layers.reshape(pos, shape=[1, S, d_model])
    x = fluid.layers.layer_norm(x, begin_norm_axis=2)

    for _ in range(n_layer):
        x = encoder_layer(x, n_head, d_model, d_ff, S, 0.0)

    # MLM head: transform + vocab projection
    h = fluid.layers.fc(x, size=d_model, num_flatten_dims=2, act='relu')
    h = fluid.layers.layer_norm(h, begin_norm_axis=2)
    logits = fluid.layers.fc(h, size=vocab, num_flatten_dims=2,
                             bias_attr=False)
    logits2d = fluid.layers.reshape(logits, shape=[-1, vocab])
    feeds = [('tok_ids', (S,), 'int64'), ('seg_ids', (S,), 'int64')]
    return feeds, logits2d
