"""Transformer-base NMT built on the port's layers.

The port's copy of models/transformer.py:16-196 (post-LN residual blocks,
sinusoid position encoding, as in the reference benchmark's Transformer):
_split_heads, _merge_heads, multi_head_attention, _residual_ln, ffn,
encoder_layer, decoder_layer, _embed and build_transformer_train,
appending the same ops with the same names. The decode-serving programs
(build_decode_spec) are not ported yet.

multi_head_attention takes the reference's two branches. With attention
dropout 0 and no additive mask (or a causal one): one
fused_multihead_attention op, the flash-attention kernels on the card
(the decoder's self-attention causal). Otherwise the composition matmul →
[+ mask] → softmax → dropout → matmul, since attention-weight dropout has
no fused kernel.
"""
from __future__ import annotations

import paddle_tpu_torch as fluid


def _split_heads(x, n_head, d_model, seq):
    # [B, S, D] -> [B, H, S, D/H]
    x = fluid.layers.reshape(x, shape=[-1, seq, n_head, d_model // n_head])
    return fluid.layers.transpose(x, perm=[0, 2, 1, 3])


def _merge_heads(x, n_head, d_model, seq):
    x = fluid.layers.transpose(x, perm=[0, 2, 1, 3])
    return fluid.layers.reshape(x, shape=[-1, seq, d_model])


def multi_head_attention(q_in, kv_in, n_head, d_model, q_len, kv_len,
                         mask=None, dropout=0.0, causal=False):
    q = fluid.layers.fc(q_in, size=d_model, num_flatten_dims=2,
                        bias_attr=False)
    k = fluid.layers.fc(kv_in, size=d_model, num_flatten_dims=2,
                        bias_attr=False)
    v = fluid.layers.fc(kv_in, size=d_model, num_flatten_dims=2,
                        bias_attr=False)
    q = _split_heads(q, n_head, d_model, q_len)
    k = _split_heads(k, n_head, d_model, kv_len)
    v = _split_heads(v, n_head, d_model, kv_len)
    scale = (d_model // n_head) ** -0.5
    if dropout == 0.0 and (mask is None or causal):
        ctxv = fluid.layers.fused_multihead_attention(q, k, v,
                                                      causal=causal,
                                                      scale=scale)
    else:
        scores = fluid.layers.matmul(q, k, transpose_y=True, alpha=scale)
        if mask is not None:
            scores = scores + mask  # [S, S] broadcast over [B, H, S, S]
        elif causal:
            pos = fluid.layers.range(0, q_len, 1, 'int32')
            row = fluid.layers.reshape(pos, shape=[q_len, 1])
            col = fluid.layers.reshape(pos, shape=[1, q_len])
            above = fluid.layers.cast(
                fluid.layers.greater_than(col, row), 'float32')
            scores = scores + above * -1e9
        weights = fluid.layers.softmax(scores)
        if dropout:
            weights = fluid.layers.dropout(
                weights, dropout_prob=dropout,
                dropout_implementation='upscale_in_train')
        ctxv = fluid.layers.matmul(weights, v)
    out = _merge_heads(ctxv, n_head, d_model, q_len)
    return fluid.layers.fc(out, size=d_model, num_flatten_dims=2,
                           bias_attr=False)


def _residual_ln(x, sub_out, dropout=0.0):
    if dropout:
        sub_out = fluid.layers.dropout(
            sub_out, dropout_prob=dropout,
            dropout_implementation='upscale_in_train')
    return fluid.layers.layer_norm(x + sub_out, begin_norm_axis=2)


def ffn(x, d_model, d_ff):
    h = fluid.layers.fc(x, size=d_ff, num_flatten_dims=2, act='relu')
    return fluid.layers.fc(h, size=d_model, num_flatten_dims=2)


def encoder_layer(x, n_head, d_model, d_ff, seq, dropout,
                  attn_dropout=None):
    ad = dropout if attn_dropout is None else attn_dropout
    x = _residual_ln(x, multi_head_attention(x, x, n_head, d_model, seq, seq,
                                             dropout=ad), dropout)
    return _residual_ln(x, ffn(x, d_model, d_ff), dropout)


def decoder_layer(x, enc_out, n_head, d_model, d_ff, trg_len, src_len,
                  causal_mask, dropout, attn_dropout=None):
    ad = dropout if attn_dropout is None else attn_dropout
    x = _residual_ln(x, multi_head_attention(x, x, n_head, d_model, trg_len,
                                             trg_len, mask=causal_mask,
                                             dropout=ad, causal=True),
                     dropout)
    x = _residual_ln(x, multi_head_attention(x, enc_out, n_head, d_model,
                                             trg_len, src_len,
                                             dropout=ad), dropout)
    return _residual_ln(x, ffn(x, d_model, d_ff), dropout)


def _embed(ids, vocab, d_model, seq, name):
    emb = fluid.layers.embedding(
        ids, size=[vocab, d_model],
        param_attr=fluid.ParamAttr(
            name=name, initializer=fluid.initializer.Normal(
                0., d_model ** -0.5)))
    emb = fluid.layers.reshape(emb, shape=[-1, seq, d_model])
    emb = emb * (d_model ** 0.5)
    return fluid.layers.add_position_encoding(emb, alpha=1.0, beta=1.0)


def build_transformer_train(src_vocab=32000, trg_vocab=32000, max_len=256,
                            d_model=512, d_ff=2048, n_head=8, n_layer=6,
                            dropout=0.1, attn_dropout=None, lr=None,
                            checkpoints=None):
    """Returns (feeds, avg_loss, train_flops_per_token).

    feeds = [(name, per-sample shape, dtype)]; sequences arrive padded to
    max_len. The learning rate defaults to the reference schedule,
    2.0·noam_decay(d_model, 4000), and the optimizer is Adam(beta1 0.9,
    beta2 0.997, epsilon 1e-9). `checkpoints` (remat) is not ported yet:
    any value but None raises.
    """
    if checkpoints is not None:
        raise NotImplementedError(
            "build_transformer_train: checkpoints (activation "
            "rematerialization) are not ported yet")
    S = max_len
    src = fluid.layers.data(name='src_ids', shape=[S], dtype='int64')
    trg = fluid.layers.data(name='trg_ids', shape=[S], dtype='int64')
    lbl = fluid.layers.data(name='lbl_ids', shape=[S], dtype='int64')

    # causal mask [S, S] built in-graph: -1e9 strictly above the diagonal
    pos = fluid.layers.range(0, S, 1, 'int32')
    row = fluid.layers.reshape(pos, shape=[S, 1])
    col = fluid.layers.reshape(pos, shape=[1, S])
    above = fluid.layers.cast(fluid.layers.greater_than(col, row), 'float32')
    causal_mask = above * -1e9

    enc = _embed(src, src_vocab, d_model, S, 'src_emb')
    if dropout:
        enc = fluid.layers.dropout(enc, dropout_prob=dropout,
                                   dropout_implementation='upscale_in_train')
    for _ in range(n_layer):
        enc = encoder_layer(enc, n_head, d_model, d_ff, S, dropout,
                            attn_dropout=attn_dropout)

    dec = _embed(trg, trg_vocab, d_model, S, 'trg_emb')
    if dropout:
        dec = fluid.layers.dropout(dec, dropout_prob=dropout,
                                   dropout_implementation='upscale_in_train')
    for _ in range(n_layer):
        dec = decoder_layer(dec, enc, n_head, d_model, d_ff, S, S,
                            causal_mask, dropout,
                            attn_dropout=attn_dropout)

    logits = fluid.layers.fc(dec, size=trg_vocab, num_flatten_dims=2,
                             bias_attr=False)
    logits2d = fluid.layers.reshape(logits, shape=[-1, trg_vocab])
    lbl2d = fluid.layers.reshape(lbl, shape=[-1, 1])
    loss = fluid.layers.softmax_with_cross_entropy(logits=logits2d,
                                                   label=lbl2d)
    avg_loss = fluid.layers.mean(loss)

    if lr is None:
        # reference schedule: learning_rate(2.0) x noam(d_model, warmup)
        lr = fluid.layers.noam_decay(d_model, 4000) * 2.0
    opt = fluid.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.997,
                               epsilon=1e-9)
    opt.minimize(avg_loss)

    # analytic training FLOPs per target token (fwd 2*MACs, train = 3x):
    # enc layer 4d^2+2*d*dff, dec layer 8d^2+2*d*dff, attention scores
    # 2*S*d per token per attention (12 self + 6 cross at n_layer=6),
    # logits d*V once
    enc_macs = n_layer * (4 * d_model ** 2 + 2 * d_model * d_ff)
    dec_macs = n_layer * (8 * d_model ** 2 + 2 * d_model * d_ff)
    attn_macs = (3 * n_layer) * 2 * S * d_model
    logit_macs = d_model * trg_vocab
    flops_per_tok = 3 * 2 * (enc_macs + dec_macs + attn_macs + logit_macs)

    feeds = [('src_ids', (S,), 'int64'), ('trg_ids', (S,), 'int64'),
             ('lbl_ids', (S,), 'int64')]
    return feeds, avg_loss, flops_per_tok
