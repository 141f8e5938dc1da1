"""Transformer-base NMT built on the port's layers.

The port's copy of models/transformer.py:16-196 (post-LN residual blocks,
sinusoid position encoding, as in the reference benchmark's Transformer):
_split_heads, _merge_heads, multi_head_attention, _residual_ln, ffn,
encoder_layer, decoder_layer, _embed and build_transformer_train,
appending the same ops with the same names; and of :210-550, _pe_table
and build_decode_spec, the decode-serving programs of a decoder-only LM
in the slot layout with an f32 cache.

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
    beta2 0.997, epsilon 1e-9). checkpoints: activation
    rematerialization (models/transformer.py:127-130, 177-182). True wraps
    each encoder/decoder layer's output as a recompute boundary, a list
    names the boundaries, 'auto' lets the pass pick √N segments, None
    trains without recompute.
    """
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
    layer_outs = []
    for _ in range(n_layer):
        enc = encoder_layer(enc, n_head, d_model, d_ff, S, dropout,
                            attn_dropout=attn_dropout)
        layer_outs.append(enc)

    dec = _embed(trg, trg_vocab, d_model, S, 'trg_emb')
    if dropout:
        dec = fluid.layers.dropout(dec, dropout_prob=dropout,
                                   dropout_implementation='upscale_in_train')
    for _ in range(n_layer):
        dec = decoder_layer(dec, enc, n_head, d_model, d_ff, S, S,
                            causal_mask, dropout,
                            attn_dropout=attn_dropout)
        layer_outs.append(dec)

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
    cps = layer_outs if checkpoints is True else (checkpoints or None)
    opt.minimize(avg_loss, checkpoints=cps)

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


# ---------------------------------------------------------------------------
# Continuous-decode serving programs (models/transformer.py:200-550): a
# decoder-only LM as the fixed-shape programs the decode-serving tier
# (inference/decoding.py) runs: a PREFILL program per prompt-length bucket
# (one request, causal self-attention over the bucket, its K/V rows written
# into one slot of the paged cache) and a DECODE-STEP program (max_slots
# requests, one token per slot per step, cache-aware attention through
# ops/decode_ops.py). Every parameter is shared by name across the
# programs.
# ---------------------------------------------------------------------------

def _pe_table(max_len, d_model):
    """Sinusoid position-encoding table [max_len, d_model] in float32 host
    numpy: prefill (a slice) and decode step (a gather by position) read
    the same table, so the two programs agree on positions bit for bit."""
    import numpy as np
    half = d_model // 2
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.power(np.float32(10000.0),
                   np.arange(half, dtype=np.float32) / np.float32(half))
    return np.concatenate([np.sin(pos / div), np.cos(pos / div)],
                          axis=1).astype(np.float32)


def build_decode_spec(vocab=67, d_model=32, n_head=4, n_layer=2, d_ff=64,
                      max_slots=8, max_cache_len=48, prompt_buckets=(8, 16),
                      eos_id=1, kv_cache_dtype='float32', block_size=None,
                      num_blocks=None, chunk_sizes=None, mp_shard=0,
                      draft_k=0):
    """The decode-serving program set of a decoder-only transformer LM, as
    the dict `inference.export_decode` takes:

      {'startup': Program,           # run ONCE to init the shared params
       'step':    {'program', 'feeds', 'samples', 'fetches'},
       'prefill': {bucket_len: {'program', 'feeds', 'samples', 'fetches'}},
       'cache_vars': [names],        # paged KV state [S, T, d_model]
       'max_slots', 'max_cache_len', 'eos_id', 'vocab', 'kv_cache_dtype'}

    The slot layout with an f32 cache, op for op the reference's
    (models/transformer.py:224). The reference's other tiers are not
    ported yet and raise NotImplementedError: kv_cache_dtype='int8' (queue
    1 item 8, the int8 tier), block_size (the block-paged layout with
    chunked prefill; num_blocks and chunk_sizes belong to it), mp_shard
    (the sharded block tier, item 10) and draft_k (the speculative verify
    program, item 7's drafters).
    """
    import numpy as np
    PA = fluid.ParamAttr
    if kv_cache_dtype not in ('float32', 'int8'):
        raise ValueError("kv_cache_dtype must be 'float32' or 'int8', "
                         "got %r" % (kv_cache_dtype,))
    if not 0 <= int(draft_k) <= int(max_cache_len) - 2:
        raise ValueError('draft_k must be in [0, max_cache_len - 2], '
                         'got %r' % (draft_k,))
    for what, given in (
            ("kv_cache_dtype='int8' (the int8 KV tier, ROADMAP queue 1 "
             "item 8)", kv_cache_dtype == 'int8'),
            ('block_size (the block-paged layout, ROADMAP queue 1 item 7)',
             block_size is not None or num_blocks is not None
             or chunk_sizes is not None),
            ('mp_shard (the sharded decode tier, ROADMAP queue 1 item 10)',
             bool(mp_shard)),
            ('draft_k (the speculative verify program, ROADMAP queue 1 '
             'item 7)', bool(draft_k))):
        if given:
            raise NotImplementedError(
                'build_decode_spec: %s is not ported yet; the port builds '
                'the slot layout with an f32 cache' % what)
    S, T, D = int(max_slots), int(max_cache_len), int(d_model)
    if D % n_head or D % 2:
        raise ValueError("d_model must be even and divisible by n_head")
    buckets = sorted({int(b) for b in prompt_buckets})
    if not buckets or buckets[0] < 1 or buckets[-1] > T:
        raise ValueError("prompt_buckets must be in [1, max_cache_len]")
    dh = D // n_head
    startup = fluid.Program()
    pe = _pe_table(T, D)
    cache_vars = []
    for i in range(n_layer):
        cache_vars += ['kv_k_%d' % i, 'kv_v_%d' % i]

    def const_param(name, shape, init, dtype='float32'):
        return fluid.layers.create_parameter(
            shape, dtype, attr=PA(name=name, trainable=False),
            default_initializer=init)

    def caches(i):
        zero = fluid.initializer.ConstantInitializer(0.0)
        return (const_param('kv_k_%d' % i, [S, T, D], zero),
                const_param('kv_v_%d' % i, [S, T, D], zero))

    def pe_param():
        return const_param(
            'pos_enc_w', [T, D], fluid.initializer.NumpyArrayInitializer(pe))

    def qkv(x, i, nfd):
        def proj(tag):
            return fluid.layers.fc(
                x, D, num_flatten_dims=nfd,
                param_attr=PA(name='l%d_%s_w' % (i, tag)), bias_attr=False)
        return proj('q'), proj('k'), proj('v')

    def block_tail(x, a, i, nfd):
        """The residual + LN + FFN tail; `nfd` = 1 (step, [S, D]) or 2
        (prefill, [1, L, D]), the same [D]-shaped params either way."""
        x = fluid.layers.layer_norm(
            x + fluid.layers.fc(a, D, num_flatten_dims=nfd,
                                param_attr=PA(name='l%d_o_w' % i),
                                bias_attr=False),
            begin_norm_axis=nfd, param_attr=PA(name='l%d_ln1_s' % i),
            bias_attr=PA(name='l%d_ln1_b' % i))
        h = fluid.layers.fc(x, d_ff, num_flatten_dims=nfd, act='relu',
                            param_attr=PA(name='l%d_f1_w' % i),
                            bias_attr=PA(name='l%d_f1_b' % i))
        f = fluid.layers.fc(h, D, num_flatten_dims=nfd,
                            param_attr=PA(name='l%d_f2_w' % i),
                            bias_attr=PA(name='l%d_f2_b' % i))
        return fluid.layers.layer_norm(
            x + f, begin_norm_axis=nfd, param_attr=PA(name='l%d_ln2_s' % i),
            bias_attr=PA(name='l%d_ln2_b' % i))

    def embed(ids):
        x = fluid.layers.embedding(ids, size=[vocab, D],
                                   param_attr=PA(name='dec_emb_w'))
        return fluid.layers.scale(x, scale=float(D ** 0.5))

    def out_logits(x):
        return fluid.layers.fc(x, vocab, param_attr=PA(name='out_w'),
                               bias_attr=False)

    # ---- decode-step program: [S] slots advance one token ----------------
    # fully static shapes (append_batch_size=False): one shape per program
    step_p = fluid.Program()
    with fluid.program_guard(step_p, startup):
        tokens = fluid.layers.data(name='tokens', shape=[S, 1],
                                   append_batch_size=False, dtype='int64')
        pos = fluid.layers.data(name='pos', shape=[S, 1],
                                append_batch_size=False, dtype='int32')
        table = pe_param()
        x = embed(tokens)                                       # [S, D]
        x = fluid.layers.elementwise_add(x,
                                         fluid.layers.gather(table, pos))
        for i in range(n_layer):
            # cache params first, then q, k, v: the op-creation order seeds
            # the per-op random streams, as in the reference
            kcache, vcache = caches(i)
            q, k, v = qkv(x, i, 1)
            kcache = fluid.layers.kv_cache_write(kcache, k, pos)
            vcache = fluid.layers.kv_cache_write(vcache, v, pos)
            a = fluid.layers.kv_cache_attention(q, kcache, vcache, pos,
                                                n_head)
            x = block_tail(x, a, i, 1)
        step_logits = out_logits(x)                             # [S, V]

    # ---- prefill programs: one request, bucketed by prompt length --------
    prefills = {}
    for L in buckets:
        pp = fluid.Program()
        with fluid.program_guard(pp, startup):
            prompt = fluid.layers.data(name='prompt_ids', shape=[1, L],
                                       append_batch_size=False,
                                       dtype='int64')
            plen = fluid.layers.data(name='prompt_len', shape=[1, 1],
                                     append_batch_size=False, dtype='int32')
            slot = fluid.layers.data(name='slot', shape=[1, 1],
                                     append_batch_size=False, dtype='int32')
            table = pe_param()
            x = embed(prompt)                                   # [1, L, D]
            pe_l = fluid.layers.slice(table, axes=[0], starts=[0],
                                      ends=[L])
            x = fluid.layers.elementwise_add(
                x, fluid.layers.reshape(pe_l, shape=[1, L, D]))
            pidx = fluid.layers.range(0, L, 1, 'int32')
            above = fluid.layers.cast(fluid.layers.greater_than(
                fluid.layers.reshape(pidx, shape=[1, L]),
                fluid.layers.reshape(pidx, shape=[L, 1])), 'float32')
            mask = above * -1e9                                 # [L, L]

            def heads(z):
                return fluid.layers.transpose(
                    fluid.layers.reshape(z, shape=[1, L, n_head, dh]),
                    perm=[0, 2, 1, 3])
            for i in range(n_layer):
                kcache, vcache = caches(i)
                q, k, v = qkv(x, i, 2)
                kcache = fluid.layers.kv_cache_prefill_write(kcache, k, slot)
                vcache = fluid.layers.kv_cache_prefill_write(vcache, v, slot)
                scores = fluid.layers.matmul(heads(q), heads(k),
                                             transpose_y=True,
                                             alpha=dh ** -0.5)
                w = fluid.layers.softmax(scores + mask)
                ctxv = fluid.layers.matmul(w, heads(v))
                a = fluid.layers.reshape(
                    fluid.layers.transpose(ctxv, perm=[0, 2, 1, 3]),
                    shape=[1, L, D])
                x = block_tail(x, a, i, 2)
            # logits at the last real prompt position (the padded rows past
            # prompt_len hold garbage the decode step overwrites first)
            flat = fluid.layers.reshape(x, shape=[L, D])
            last = fluid.layers.gather(
                flat, fluid.layers.elementwise_sub(
                    plen, fluid.layers.fill_constant([1], 'int32', 1)))
            pre_logits = out_logits(last)                       # [1, V]
        prefills[L] = {
            'program': pp,
            'feeds': ['prompt_ids', 'prompt_len', 'slot'],
            'samples': {'prompt_ids': np.zeros((1, L), np.int64),
                        'prompt_len': np.ones((1, 1), np.int32),
                        'slot': np.zeros((1, 1), np.int32)},
            'fetches': [pre_logits.name]}

    return {'startup': startup,
            'step': {'program': step_p,
                     'feeds': ['tokens', 'pos'],
                     'samples': {'tokens': np.zeros((S, 1), np.int64),
                                 'pos': np.zeros((S, 1), np.int32)},
                     'fetches': [step_logits.name]},
            'prefill': prefills,
            'cache_vars': list(cache_vars),
            'max_slots': S, 'max_cache_len': T,
            'eos_id': int(eos_id), 'vocab': int(vocab),
            'kv_cache_dtype': kv_cache_dtype}
