"""Transformer-base NMT built on the port's layers.

The port's copy of models/transformer.py:16-196 (post-LN residual blocks,
sinusoid position encoding, as in the reference benchmark's Transformer):
_split_heads, _merge_heads, multi_head_attention, _residual_ln, ffn,
encoder_layer, decoder_layer, _embed and build_transformer_train,
appending the same ops with the same names; and of :210-929, _pe_table
and build_decode_spec, the decode-serving programs of a decoder-only LM
with an f32 cache, in the slot and the block-paged layout, with the
speculative verify program.

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
# Continuous-decode serving programs (models/transformer.py:200-929): a
# decoder-only LM as the fixed-shape programs the decode-serving tier
# (inference/decoding.py) runs. In the slot layout: a PREFILL program per
# prompt-length bucket (one request, causal self-attention over the bucket,
# its K/V rows written into one slot of the paged cache) and a DECODE-STEP
# program (max_slots requests, one token per slot per step, cache-aware
# attention through ops/decode_ops.py). In the block layout: the step
# reads and writes a block pool through block tables, and prefill is one
# CHUNK program per chunk size. With draft_k, a VERIFY program scores
# draft_k + 1 rows a slot. Every parameter is shared by name across the
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
       'cache_vars': [names],        # KV state, one K and one V a layer
       'max_slots', 'max_cache_len', 'eos_id', 'vocab', 'kv_cache_dtype'}

    Op for op the reference's (models/transformer.py:224), with an f32
    cache. The slot layout's cache is [S, T, d_model].

    block_size=N: the block-paged layout (models/transformer.py:553). The
    cache is a pool [num_blocks, N, d_model] addressed through block
    tables the serving tier feeds each dispatch (the step's
    'block_tables' [S, max_blocks]); prefill is chunked, one program per
    size in `chunk_sizes` (default: the prompt_buckets) under 'chunk'
    instead of 'prefill'; num_blocks defaults to full capacity, S *
    ceil(T / N) + 1 (block 0 is the trash block). The spec adds 'layout':
    'block', 'block_size', 'num_blocks' and 'max_blocks_per_slot'.

    draft_k=K: a verify program under 'verify' (and 'draft_k': K) scores
    [S, K+1] token rows in one dispatch over the same cache, row i
    attending j <= pos[s, i]. It is built last and shares every weight by
    name, so the other programs and the startup are what a draft_k=0
    build gives. Pad rows carry pos = T (slot layout: the write drops
    them) or max_blocks * block_size (block layout: the trash block).

    kv_cache_dtype='int8' (models/transformer.py:242): the cache stores
    int8 rows with one f32 scale a row, kv_ks_<i> and kv_vs_<i> ([S, T] in
    the slot layout, [num_blocks, block_size] in the block layout, 1.0 at
    init), listed in cache_vars after each layer's kv_k_<i> and kv_v_<i>;
    every program uses the `*_quant` write and attention ops. Each layer
    makes its cache params (pages, then scales) before its q, k and v
    projections, as the reference's build_decode_spec does.

    Not ported yet: mp_shard (the sharded decode tier, ROADMAP queue 1 item
    10) raises NotImplementedError.
    """
    import numpy as np
    PA = fluid.ParamAttr
    if kv_cache_dtype not in ('float32', 'int8'):
        raise ValueError("kv_cache_dtype must be 'float32' or 'int8', "
                         "got %r" % (kv_cache_dtype,))
    if not 0 <= int(draft_k) <= int(max_cache_len) - 2:
        raise ValueError('draft_k must be in [0, max_cache_len - 2], '
                         'got %r' % (draft_k,))
    if mp_shard:
        raise NotImplementedError(
            'build_decode_spec: mp_shard (the sharded decode tier, ROADMAP '
            'queue 1 item 10) is not ported yet; the port builds the slot '
            'and block layouts on one device')
    S, T, D = int(max_slots), int(max_cache_len), int(d_model)
    if D % n_head or D % 2:
        raise ValueError("d_model must be even and divisible by n_head")
    block = block_size is not None
    if block:
        BS = int(block_size)
        if not 1 <= BS <= T:
            raise ValueError("block_size must be in [1, max_cache_len]")
        MAXB = -(-T // BS)                 # logical blocks a slot
        NB = int(num_blocks) if num_blocks is not None else S * MAXB + 1
        if NB < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved trash block)")
        chunks = sorted({int(c) for c in (chunk_sizes or prompt_buckets)})
        if not chunks or chunks[0] < 1 or chunks[-1] > T:
            raise ValueError("chunk_sizes must be in [1, max_cache_len]")
        cache_shape = [NB, BS, D]
        pad_pos = MAXB * BS                # a verify pad row: trash block
    else:
        buckets = sorted({int(b) for b in prompt_buckets})
        if not buckets or buckets[0] < 1 or buckets[-1] > T:
            raise ValueError("prompt_buckets must be in [1, max_cache_len]")
        cache_shape = [S, T, D]
        pad_pos = T                        # a verify pad row: dropped
    dh = D // n_head
    startup = fluid.Program()
    pe = _pe_table(T, D)
    kv_int8 = kv_cache_dtype == 'int8'
    cache_vars = []
    for i in range(n_layer):
        cache_vars += ['kv_k_%d' % i, 'kv_v_%d' % i]
        if kv_int8:
            cache_vars += ['kv_ks_%d' % i, 'kv_vs_%d' % i]

    def const_param(name, shape, init, dtype='float32'):
        return fluid.layers.create_parameter(
            shape, dtype, attr=PA(name=name, trainable=False),
            default_initializer=init)

    def caches(i):
        """The layer's cache params: (k, v), and with the int8 cache (k,
        v, k_scale, v_scale), the scales one a page row at 1.0, so a
        never-written row dequantizes to zeros."""
        zero = fluid.initializer.ConstantInitializer(0.0)
        dt = 'int8' if kv_int8 else 'float32'
        kv = (const_param('kv_k_%d' % i, cache_shape, zero, dt),
              const_param('kv_v_%d' % i, cache_shape, zero, dt))
        if not kv_int8:
            return kv
        one = fluid.initializer.ConstantInitializer(1.0)
        return kv + (const_param('kv_ks_%d' % i, cache_shape[:2], one),
                     const_param('kv_vs_%d' % i, cache_shape[:2], one))

    def write_attend(kind, i, x, nfd, ins, attend=True):
        """Layer i's cache params, its q, k and v projections of x, the K
        and V writes of op `kv_<kind>_write` and the attention of
        `kv_<kind>_attention` (the `_quant` ops with the int8 cache), both
        taking `ins` (pos, slot or start, and a block table) after their
        cache inputs. Returns the attention's output, or (q, k, v) without
        `attend` (a slot prefill attends in the program itself)."""
        c = caches(i)
        q, k, v = qkv(x, i, nfd)
        layers = fluid.layers
        quant = '_quant' if kv_int8 else ''
        write = getattr(layers, 'kv_%s_write%s' % (kind, quant))
        if kv_int8:
            kc, vc, ks, vs = c
            kc, ks = write(kc, ks, k, *ins)
            vc, vs = write(vc, vs, v, *ins)
            caches_in = (kc, ks, vc, vs)
        else:
            kc, vc = c
            caches_in = (write(kc, k, *ins), write(vc, v, *ins))
        if not attend:
            return q, k, v
        # the int8 chunk attention attends the chunk's own rows in f32
        fresh = (k, v) if kv_int8 and kind == 'block_chunk' else ()
        return getattr(layers, 'kv_%s_attention%s' % (kind, quant))(
            q, *(caches_in + fresh + tuple(ins)), n_head)

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
        (prefill, chunk and verify, [*, L, D]), the same [D]-shaped params
        either way."""
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

    def out_logits(x, nfd=1):
        return fluid.layers.fc(x, vocab, num_flatten_dims=nfd,
                               param_attr=PA(name='out_w'), bias_attr=False)

    def int_feed(name, shape, dtype='int32'):
        # fully static shapes (append_batch_size=False): one shape a program
        return fluid.layers.data(name=name, shape=shape,
                                 append_batch_size=False, dtype=dtype)

    # ---- decode-step program: [S] slots advance one token ----------------
    step_p = fluid.Program()
    with fluid.program_guard(step_p, startup):
        tokens = int_feed('tokens', [S, 1], 'int64')
        pos = int_feed('pos', [S, 1])
        if block:
            tables = int_feed('block_tables', [S, MAXB])
        table = pe_param()
        x = embed(tokens)                                       # [S, D]
        x = fluid.layers.elementwise_add(x,
                                         fluid.layers.gather(table, pos))
        for i in range(n_layer):
            # cache params first, then q, k, v: the op-creation order seeds
            # the per-op random streams, as in the reference
            a = write_attend('block' if block else 'cache', i, x, 1,
                             (pos, tables) if block else (pos,))
            x = block_tail(x, a, i, 1)
        step_logits = out_logits(x)                             # [S, V]
    step_feeds = ['tokens', 'pos'] + (['block_tables'] if block else [])
    step_samples = {'tokens': np.zeros((S, 1), np.int64),
                    'pos': np.zeros((S, 1), np.int32)}
    if block:
        step_samples['block_tables'] = np.zeros((S, MAXB), np.int32)

    def last_logits(x, n, length):
        """Logits at the last real row of [1, n, D] `x` (`length` [1, 1]
        int32): the rows past it hold pad garbage."""
        flat = fluid.layers.reshape(x, shape=[n, D])
        last = fluid.layers.gather(
            flat, fluid.layers.elementwise_sub(
                length, fluid.layers.fill_constant([1], 'int32', 1)))
        return out_logits(last)                                 # [1, V]

    # ---- prefill programs (slot layout): one request, bucketed by prompt
    # length ---------------------------------------------------------------
    prefills = {}
    for L in ([] if block else buckets):
        pp = fluid.Program()
        with fluid.program_guard(pp, startup):
            prompt = int_feed('prompt_ids', [1, L], 'int64')
            plen = int_feed('prompt_len', [1, 1])
            slot = int_feed('slot', [1, 1])
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
                # the prompt attends its fresh f32 rows in the program
                q, k, v = write_attend('cache_prefill', i, x, 2, (slot,),
                                       attend=False)
                scores = fluid.layers.matmul(heads(q), heads(k),
                                             transpose_y=True,
                                             alpha=dh ** -0.5)
                w = fluid.layers.softmax(scores + mask)
                ctxv = fluid.layers.matmul(w, heads(v))
                a = fluid.layers.reshape(
                    fluid.layers.transpose(ctxv, perm=[0, 2, 1, 3]),
                    shape=[1, L, D])
                x = block_tail(x, a, i, 2)
            pre_logits = last_logits(x, L, plen)
        prefills[L] = {
            'program': pp,
            'feeds': ['prompt_ids', 'prompt_len', 'slot'],
            'samples': {'prompt_ids': np.zeros((1, L), np.int64),
                        'prompt_len': np.ones((1, 1), np.int32),
                        'slot': np.zeros((1, 1), np.int32)},
            'fetches': [pre_logits.name]}

    # ---- chunked-prefill programs (block layout): one chunk of one prompt,
    # attending the earlier chunks and shared prefix blocks through the
    # slot's table --------------------------------------------------------
    chunk_progs = {}
    for C in (chunks if block else []):
        cp = fluid.Program()
        with fluid.program_guard(cp, startup):
            chunk_ids = int_feed('chunk_ids', [1, C], 'int64')
            start = int_feed('start', [1, 1])
            clen = int_feed('chunk_len', [1, 1])
            btab = int_feed('block_table', [1, MAXB])
            table = pe_param()
            x = embed(chunk_ids)                               # [1, C, D]
            cidx = fluid.layers.range(0, C, 1, 'int32')        # [C]
            posv = fluid.layers.elementwise_add(
                cidx, fluid.layers.reshape(start, shape=[1]))
            # a final slice's pad rows may run past the PE table (the
            # reference's gather fills them with NaN, the port's refuses
            # the index): clamp the gather's index only, as the verify
            # program does; the writes still route rows past the table's
            # span to the trash block
            pe_idx = fluid.layers.clip(posv, 0, T - 1, name='chunk_pe_idx')
            pe_c = fluid.layers.gather(table, pe_idx)          # [C, D]
            x = fluid.layers.elementwise_add(
                x, fluid.layers.reshape(pe_c, shape=[1, C, D]))
            for i in range(n_layer):
                a = write_attend('block_chunk', i, x, 2, (start, btab))
                x = block_tail(x, a, i, 2)
            # the scheduler reads them only from a prompt's final chunk
            chunk_logits = last_logits(x, C, clen)
        chunk_progs[C] = {
            'program': cp,
            'feeds': ['chunk_ids', 'start', 'chunk_len', 'block_table'],
            'samples': {'chunk_ids': np.zeros((1, C), np.int64),
                        'start': np.zeros((1, 1), np.int32),
                        'chunk_len': np.ones((1, 1), np.int32),
                        'block_table': np.zeros((1, MAXB), np.int32)},
            'fetches': [chunk_logits.name]}

    # ---- verify program, built LAST so the op-creation order of the
    # programs above (and so the weights the startup draws) is unchanged:
    # [S, R] rows (R = draft_k + 1) score in one dispatch ------------------
    verify = None
    if draft_k:
        R = int(draft_k) + 1
        vp = fluid.Program()
        with fluid.program_guard(vp, startup):
            vtok = int_feed('tokens', [S, R], 'int64')
            vpos = int_feed('pos', [S, R])
            if block:
                vtab = int_feed('block_tables', [S, MAXB])
            table = pe_param()
            x = embed(vtok)                                 # [S, R, D]
            # pad rows carry a position past the PE table: clamp the
            # gather's index only (the writes keep the pad encoding)
            pe_idx = fluid.layers.clip(vpos, 0, T - 1)
            pe_r = fluid.layers.gather(table, pe_idx)       # [S*R, D]
            x = fluid.layers.elementwise_add(
                x, fluid.layers.reshape(pe_r, shape=[S, R, D]))
            for i in range(n_layer):
                a = write_attend('block_verify' if block else 'cache_verify',
                                 i, x, 2, (vpos, vtab) if block else (vpos,))
                x = block_tail(x, a, i, 2)
            verify_logits = out_logits(x, nfd=2)            # [S, R, V]
        vsamples = {'tokens': np.zeros((S, R), np.int64),
                    'pos': np.full((S, R), pad_pos, np.int32)}
        if block:
            vsamples['block_tables'] = np.zeros((S, MAXB), np.int32)
        verify = {'program': vp, 'feeds': list(step_feeds),
                  'samples': vsamples, 'fetches': [verify_logits.name]}

    spec = {'startup': startup,
            'step': {'program': step_p, 'feeds': step_feeds,
                     'samples': step_samples,
                     'fetches': [step_logits.name]},
            'cache_vars': list(cache_vars),
            'max_slots': S, 'max_cache_len': T,
            'eos_id': int(eos_id), 'vocab': int(vocab),
            'kv_cache_dtype': kv_cache_dtype}
    if block:
        spec.update({'layout': 'block', 'block_size': BS,
                     'num_blocks': NB, 'max_blocks_per_slot': MAXB,
                     'chunk': chunk_progs})
    else:
        spec['prefill'] = prefills
    if verify is not None:
        spec['verify'] = verify
        spec['draft_k'] = int(draft_k)
    return spec
