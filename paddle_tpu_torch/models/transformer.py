"""Transformer encoder blocks built on the port's layers.

The port's copy of the encoder half of models/transformer.py:16-90
(post-LN residual blocks, as in the reference benchmark's Transformer):
_split_heads, _merge_heads, multi_head_attention, _residual_ln, ffn and
encoder_layer, appending the same ops with the same names.

multi_head_attention takes the reference's two branches. With attention
dropout 0 and no additive mask (or a causal one): one
fused_multihead_attention op, the flash-attention kernels on the card.
Otherwise the composition matmul → [+ mask] → softmax → dropout → matmul,
since attention-weight dropout has no fused kernel. decoder_layer and the
NMT model functions are not ported yet.
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
