"""BERT encoder pretraining with its masked-LM head, built on the port's
layers: models/bert.py:17-66 (build_bert_pretrain).

`build_bert_pretrain` appends the same layers in the same order as the JAX
builder, the masked-LM loss and Adam.minimize included, so under a fresh
unique_name.guard() both packages build the same training program, op for
op, with the same persistable names (word_emb, sent_emb, pos_emb,
fc_N.w_0, fc_N.b_0, layer_norm_N.w_0, layer_norm_N.b_0, learning_rate_1,
<param>_moment1_0, ...). `bert_mlm_logits` builds the forward alone, to
the [B*S, vocab] logits, for serving; a directory saved by either package
serves in the other.

With dropout > 0 (build_bert_pretrain's default 0.1, as bench.py's bench_bert
trains it) the embeddings' layer norm, every attention's weights and every
residual branch take a dropout op (1 + 3·n_layer of them), and the
attention takes the composed branch (matmul → softmax → dropout → matmul);
with dropout 0 it takes the fused flash-attention op.
"""
from __future__ import annotations

import paddle_tpu_torch as fluid

from .transformer import encoder_layer


def _mlm_logits(tok, seg, vocab, S, d_model, d_ff, n_head, n_layer,
                type_vocab, dropout=0.0, layer_outs=None):
    """Embeddings, encoder and MLM head: [B*S, vocab] logits. Each encoder
    layer's output is appended to `layer_outs` when it is a list."""
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
    if dropout:
        x = fluid.layers.dropout(x, dropout_prob=dropout,
                                 dropout_implementation='upscale_in_train')

    for _ in range(n_layer):
        x = encoder_layer(x, n_head, d_model, d_ff, S, dropout)
        if layer_outs is not None:
            layer_outs.append(x)

    # MLM head: transform + vocab projection
    h = fluid.layers.fc(x, size=d_model, num_flatten_dims=2, act='relu')
    h = fluid.layers.layer_norm(h, begin_norm_axis=2)
    logits = fluid.layers.fc(h, size=vocab, num_flatten_dims=2,
                             bias_attr=False)
    return fluid.layers.reshape(logits, shape=[-1, vocab])


def bert_mlm_logits(vocab=30522, max_len=128, d_model=768, d_ff=3072,
                    n_head=12, n_layer=12, type_vocab=2):
    """Returns (feeds, logits2d): feeds = [(name, shape, dtype)] of the two
    int64 inputs, logits2d the [-1, vocab] masked-LM logits."""
    S = max_len
    tok = fluid.layers.data(name='tok_ids', shape=[S], dtype='int64')
    seg = fluid.layers.data(name='seg_ids', shape=[S], dtype='int64')
    logits2d = _mlm_logits(tok, seg, vocab, S, d_model, d_ff, n_head,
                           n_layer, type_vocab)
    feeds = [('tok_ids', (S,), 'int64'), ('seg_ids', (S,), 'int64')]
    return feeds, logits2d


def build_bert_pretrain(vocab=30522, max_len=128, d_model=768, d_ff=3072,
                        n_head=12, n_layer=12, type_vocab=2, dropout=0.1,
                        lr=1e-4, checkpoints=None):
    """Returns (feeds, avg_mlm_loss). feeds = [(name, shape, dtype)].

    The masked-LM loss is the masked mean of softmax_with_cross_entropy
    over the positions whose mlm_weights are non-zero; Adam(lr) minimizes
    it. checkpoints: activation rematerialization (models/bert.py:22-25,
    72-79). True wraps each encoder layer's output as a recompute
    boundary, a list names the boundaries, 'auto' lets the pass pick √N
    segments, None trains without recompute."""
    S = max_len
    tok = fluid.layers.data(name='tok_ids', shape=[S], dtype='int64')
    seg = fluid.layers.data(name='seg_ids', shape=[S], dtype='int64')
    mlm_lbl = fluid.layers.data(name='mlm_labels', shape=[S], dtype='int64')
    mlm_w = fluid.layers.data(name='mlm_weights', shape=[S], dtype='float32')
    layer_outs = []
    logits2d = _mlm_logits(tok, seg, vocab, S, d_model, d_ff, n_head,
                           n_layer, type_vocab, dropout, layer_outs)
    lbl2d = fluid.layers.reshape(mlm_lbl, shape=[-1, 1])
    loss = fluid.layers.softmax_with_cross_entropy(logits=logits2d,
                                                   label=lbl2d)
    w = fluid.layers.reshape(mlm_w, shape=[-1, 1])
    # masked mean: only the masked positions contribute
    avg_loss = fluid.layers.reduce_sum(loss * w) / (
        fluid.layers.reduce_sum(w) + 1e-6)
    cps = layer_outs if checkpoints is True else (checkpoints or None)
    fluid.optimizer.Adam(learning_rate=lr).minimize(avg_loss,
                                                    checkpoints=cps)
    feeds = [('tok_ids', (S,), 'int64'), ('seg_ids', (S,), 'int64'),
             ('mlm_labels', (S,), 'int64'), ('mlm_weights', (S,), 'float32')]
    return feeds, avg_loss
