"""KV-cache op lowerings of continuous decode serving (ref:
paddle_tpu/ops/decode_ops.py:456-537, 619-775, 898-1028): the slot
layout's kv_cache_write, kv_cache_prefill_write and kv_cache_attention;
the block layout's kv_block_write, kv_block_attention,
kv_block_chunk_write and kv_block_chunk_attention; and the speculative
verify ops of both layouts, kv_cache_verify_write,
kv_cache_verify_attention, kv_block_verify_write and
kv_block_verify_attention; and the int8 (`*_quant`) variant of each of
those eleven ops (ref: :523-617, 777-860, 955-988, 1030-1074). And
the LoD decode ops of CRNN+CTC training (ref: :53-205): warpctc,
ctc_greedy_decoder, ctc_align and edit_distance (the section at the end
of this file says how).

The decode-serving tier (inference/decoding.py) runs a decoder-only LM as
fixed-shape programs over a preallocated KV cache held as persistable
state. In the slot layout the cache is [max_slots, max_cache_len,
d_model]: a bucketed prefill program writes a whole prompt's K/V rows
into one slot, and a decode-step program advances every slot by one
token. In the block layout it is a pool [num_blocks, block_size, d_model]
addressed through per-slot block tables (int32 [*, max_blocks]) that the
scheduler feeds each dispatch: logical position p of a slot lives at
cache[table[p // bs], p % bs]. Prefill is chunked there (one program per
chunk size), and physical block 0 is the trash block, where idle and pad
rows scatter and which no table maps into an attention window. A verify
program scores R = draft_k + 1 rows per slot in one dispatch.

- The writes update the cache tensor in place (index_put_ /
  index_copy_), as their Out aliases Cache: nothing of the cache is
  copied per write. The slot writes' starts map as
  jax.lax.dynamic_update_slice maps them (_dus_start): a negative start
  counts from the end, then the start clamps so that the update fits. A
  step position at or above T writes row T-1, a prefill slot at or above
  S writes slot S-1. No index ever leaves the tensor.
- A block write's row whose position lies past the table's logical span
  (a chunk's pad rows past max_cache_len, a verify pad row at
  max_blocks * block_size) lands in the trash block, as in the reference
  (_block_scatter_idx). A slot-layout verify pad row (position T) writes
  nothing, as the reference's out-of-bounds scatter drops it.
- The int8 cache stores int8 rows and one f32 scale a row (a slot-page
  or block-page: Scale [S, T] or [NB, BS] beside the [S, T, D] or [NB,
  BS, D] pages). A row quantizes at write time at its own abs-max scale
  (round(x / s) half to even, clipped to +-127, s = max|x| / 127 floored
  at 1e-30 so an all-zero row stays finite); each write op updates Cache
  and Scale in place and outputs both (Out, OutScale). The attention
  dequantizes its operands (int8 row x its scale, one f32 copy of the
  layer's K or V view) and then runs the f32 ops' own body, as the
  reference's does. The block chunk attention attends the chunk's own
  rows at full precision (the fresh f32 K and V splice over the view's
  span of the chunk), as the slot layout's prefill does.
- The attention is plain torch (einsum, masked_fill, softmax), as the
  reference's is plain jnp: no Pallas kernel stands behind it, so no
  hand-written one does here. Rows j > pos are set to -inf before the
  softmax, so they get exactly zero weight and stale finite garbage in
  masked or foreign rows cannot move an active slot's output. Every
  product keeps a slot's rows apart from the others' (the slot is a batch
  dim of each einsum), so a slot's outputs do not depend on which other
  requests share the step: the continuous-batching contract. The block
  attention gathers each slot's logical view through its table and runs
  the slot layout's expression on it, and a verify row i runs that
  expression with its own frontier pos[s, i].
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.lod import (LoDArray, device_index, pad_from_lod,
                        segment_ids_from_offsets, unwrap)
from ..core.registry import register


def _dus_start(start, dim, size):
    """jax.lax.dynamic_update_slice's start for an update of `size` along
    a dim of `dim`: a negative start counts from the end, then the start
    clamps to [0, dim - size]."""
    start = torch.where(start < 0, start + dim, start)
    return start.clamp(0, dim - size)


@register('kv_cache_write', no_grad=True)
def _kv_cache_write(ctx, ins):
    """Cache [S, T, D], KV [S, D], Pos [S] or [S, 1] int: row Pos[s] of
    slot s becomes KV[s], in place. Out is Cache."""
    cache = ins['Cache'][0]
    kv = ins['KV'][0]
    s, t = cache.shape[0], cache.shape[1]
    pos = _dus_start(ins['Pos'][0].reshape(-1).long(), t, 1)
    rows = torch.arange(s, device=cache.device)
    cache.index_put_((rows, pos), kv.reshape(s, -1).to(cache.dtype))
    return {'Out': [cache]}


@register('kv_cache_prefill_write', no_grad=True)
def _kv_cache_prefill_write(ctx, ins):
    """Cache [S, T, D], KV [1, L, D] (one request), Slot [1] or [1, 1]
    int: rows 0..L-1 of that slot become KV[0], in place. Rows past the
    true prompt length carry pad garbage; the decode step overwrites
    position p before any step attends it (mask j <= pos)."""
    cache = ins['Cache'][0]
    kv = ins['KV'][0]
    slot = _dus_start(ins['Slot'][0].reshape(-1)[:1].long(), cache.shape[0],
                      1)
    cache[:, :kv.shape[1]].index_copy_(0, slot, kv.to(cache.dtype))
    return {'Out': [cache]}


def _paged_attention_body(ctx, q, kc, vc, pos):
    """The masked attention of one query row a slot: Q [S, D] attends its
    slot's cache rows j <= Pos[s] (KCache/VCache [S, T, D]), heads split
    inside (attr n_head), scale the attr or dh^-0.5. Out [S, D] in Q's
    dtype. Shared by the slot and block ops, so a slot's output is the same
    however its history is paged."""
    n_head = int(ctx.attr('n_head', 1))
    s, t, d = kc.shape
    dh = d // n_head
    scale = float(ctx.attr('scale', 0.0) or 0.0) or dh ** -0.5
    qh = q.reshape(s, n_head, dh)
    kh = kc.reshape(s, t, n_head, dh)
    vh = vc.reshape(s, t, n_head, dh)
    scores = torch.einsum('shd,sthd->sht', qh, kh) * scale
    valid = torch.arange(t, device=q.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~valid[:, None, :], float('-inf'))
    w = torch.softmax(scores, dim=-1)
    ctxv = torch.einsum('sht,sthd->shd', w, vh)
    return ctxv.reshape(s, d).to(q.dtype)


@register('kv_cache_attention', no_grad=True)
def _kv_cache_attention(ctx, ins):
    """Q [S, D], KCache/VCache [S, T, D], Pos [S] int: each slot's query
    attends its own cache rows j <= Pos[s] (already written this step).
    Out [S, D] in Q's dtype."""
    pos = ins['Pos'][0].reshape(-1).long()
    return {'Out': [_paged_attention_body(ctx, ins['Q'][0], ins['KCache'][0],
                                          ins['VCache'][0], pos)]}


# -- block layout ------------------------------------------------------------
def _block_view(cache, table):
    """Each row's logically ordered view of the block pool: cache [NB, BS,
    D], table [R, MAXB] int -> [R, MAXB * BS, D] (view row j is logical
    position j)."""
    r, maxb = table.shape
    v = cache.index_select(0, table.reshape(-1).long())
    return v.reshape((r, maxb * cache.shape[1]) + tuple(cache.shape[2:]))


def _block_scatter_idx(table, pos, bs):
    """(physical block, offset in the block) of each row: table [R, MAXB],
    pos [R] int -> (bidx [R], boff [R]) int64. A row whose table entry is
    the trash block lands in block 0, and so does a row whose position
    lies past the table's logical span (a chunk's pad rows past
    max_cache_len): clamping the table lookup would give the last
    column's block, a real one when the table is full."""
    pos = pos.long()
    lblk = torch.div(pos, bs, rounding_mode='floor')
    boff = pos - lblk * bs
    maxb = table.shape[1]
    bidx = table.long().gather(1, lblk.clamp(0, maxb - 1)[:, None])[:, 0]
    bidx = torch.where(lblk < maxb, bidx, torch.zeros_like(bidx))
    return bidx, boff


@register('kv_block_write', no_grad=True)
def _kv_block_write(ctx, ins):
    """Cache [NB, BS, D], KV [S, D], Pos [S] or [S, 1] int, BlockTable [S,
    MAXB] int: slot s's row scatters to (table[s][Pos // BS], Pos % BS),
    in place. The scheduler makes every real write block uniquely owned
    (copy on write), so real rows never collide; idle slots all write the
    trash block, which nothing reads. Out is Cache."""
    cache = ins['Cache'][0]
    kv = ins['KV'][0]
    pos = ins['Pos'][0].reshape(-1)
    bidx, boff = _block_scatter_idx(ins['BlockTable'][0], pos,
                                    cache.shape[1])
    cache.index_put_((bidx, boff), kv.reshape(bidx.shape[0], -1)
                     .to(cache.dtype))
    return {'Out': [cache]}


@register('kv_block_attention', no_grad=True)
def _kv_block_attention(ctx, ins):
    """kv_cache_attention over the block pool: Q [S, D], KCache/VCache
    [NB, BS, D], Pos [S] int, BlockTable [S, MAXB] int. Each slot attends
    its table's logical view rows j <= Pos[s]; foreign blocks and trash
    rows get exactly zero weight. Out [S, D]."""
    table = ins['BlockTable'][0]
    pos = ins['Pos'][0].reshape(-1).long()
    kview = _block_view(ins['KCache'][0], table)
    vview = _block_view(ins['VCache'][0], table)
    return {'Out': [_paged_attention_body(ctx, ins['Q'][0], kview, vview,
                                          pos)]}


def _chunk_attention_body(ctx, q, kview, vview, start, d):
    """Chunked-prefill attention of one slot: q [1, C, D] (chunk rows at
    positions start + i), kview/vview [T', D] the slot's logical view. Row
    i attends j <= start + i: causal in the chunk and over everything
    written before it (earlier chunks, shared prefix blocks). Out [1, C,
    D]."""
    n_head = int(ctx.attr('n_head', 1))
    c = q.shape[1]
    t = kview.shape[0]
    dh = d // n_head
    scale = float(ctx.attr('scale', 0.0) or 0.0) or dh ** -0.5
    qh = q.reshape(c, n_head, dh)
    kh = kview.reshape(t, n_head, dh)
    vh = vview.reshape(t, n_head, dh)
    scores = torch.einsum('chd,thd->cht', qh, kh) * scale
    start = start.reshape(()).long()
    valid = (torch.arange(t, device=q.device)[None, :]
             <= start + torch.arange(c, device=q.device)[:, None])
    scores = scores.masked_fill(~valid[:, None, :], float('-inf'))
    w = torch.softmax(scores, dim=-1)
    ctxv = torch.einsum('cht,thd->chd', w, vh)
    return ctxv.reshape(1, c, d).to(q.dtype)


@register('kv_block_chunk_write', no_grad=True)
def _kv_block_chunk_write(ctx, ins):
    """Cache [NB, BS, D], KV [1, C, D], Start [1, 1] int, BlockTable [1,
    MAXB] int: the chunk's rows at positions Start..Start+C-1 of one slot
    scatter into the pool through its table, in place. Rows past the
    chunk's true length carry pad garbage into the slot's own tail block
    (or the trash block past its allocated span), which a decode step
    overwrites before any mask admits it. Out is Cache."""
    cache = ins['Cache'][0]
    kv = ins['KV'][0]
    table = ins['BlockTable'][0]
    c = kv.shape[1]
    pos = (ins['Start'][0].reshape(()).long()
           + torch.arange(c, device=table.device))
    bidx, boff = _block_scatter_idx(table.reshape(1, -1).expand(c, -1), pos,
                                    cache.shape[1])
    cache.index_put_((bidx, boff), kv[0].to(cache.dtype))
    return {'Out': [cache]}


@register('kv_block_chunk_attention', no_grad=True)
def _kv_block_chunk_attention(ctx, ins):
    """Q [1, C, D] chunk rows of one slot attend its logical view
    (KCache/VCache [NB, BS, D] through BlockTable [1, MAXB]) rows j <=
    Start + i. Out [1, C, D]."""
    kc = ins['KCache'][0]
    table = ins['BlockTable'][0].reshape(1, -1)
    kview = _block_view(kc, table)[0]
    vview = _block_view(ins['VCache'][0], table)[0]
    return {'Out': [_chunk_attention_body(ctx, ins['Q'][0], kview, vview,
                                          ins['Start'][0], kc.shape[2])]}


# -- speculative verify ------------------------------------------------------
def _verify_attention_body(ctx, q, kc, vc, pos):
    """Verify attention: Q [S, R, D] attends its slot's cache view
    (KCache/VCache [S, T, D]) with a frontier a row: row i sees j <=
    pos[s, i]. Row by row it is _paged_attention_body's expression. Out
    [S, R, D]."""
    n_head = int(ctx.attr('n_head', 1))
    s, t, d = kc.shape
    r = q.shape[1]
    dh = d // n_head
    scale = float(ctx.attr('scale', 0.0) or 0.0) or dh ** -0.5
    qh = q.reshape(s, r, n_head, dh)
    kh = kc.reshape(s, t, n_head, dh)
    vh = vc.reshape(s, t, n_head, dh)
    scores = torch.einsum('srhd,sthd->srht', qh, kh) * scale
    valid = (torch.arange(t, device=q.device)[None, None, :]
             <= pos[:, :, None])
    scores = scores.masked_fill(~valid[:, :, None, :], float('-inf'))
    w = torch.softmax(scores, dim=-1)
    ctxv = torch.einsum('srht,sthd->srhd', w, vh)
    return ctxv.reshape(s, r, d).to(q.dtype)


def _verify_targets(pos, t):
    """Where kv_cache_verify_write puts each row: (rows, tgt, real) [S, R],
    a negative position counted from the end; a pad row (position T or
    beyond, real False) targets the first position of its slot that no
    real row of the call writes (one exists while R < T, as draft_k <=
    max_cache_len - 2 makes it), so it writes back the value already
    there."""
    pos = pos.long()
    s, r = pos.shape
    pos = torch.where(pos < 0, pos + t, pos)
    real = (pos >= 0) & (pos < t)
    safe = torch.where(real, pos, torch.zeros_like(pos))
    written = torch.zeros((s, t), dtype=torch.int32, device=pos.device)
    written.scatter_add_(1, safe, real.to(torch.int32))
    spare = (written == 0).to(torch.int32).argmax(dim=1)       # [S]
    tgt = torch.where(real, pos, spare[:, None])
    rows = torch.arange(s, device=pos.device)[:, None].expand(s, r)
    return rows, tgt, real


def _verify_put(cache, rows, tgt, real, vals):
    """cache[rows, tgt] = vals where real, else the value already there
    (every write of a fixed value: the result does not depend on the order
    of duplicate indices)."""
    if vals.dim() == 3:
        real = real[:, :, None]
    vals = torch.where(real, vals.to(cache.dtype), cache[rows, tgt])
    cache.index_put_((rows.reshape(-1), tgt.reshape(-1)),
                     vals.reshape((-1,) + tuple(cache.shape[2:])))


@register('kv_cache_verify_write', no_grad=True)
def _kv_cache_verify_write(ctx, ins):
    """Cache [S, T, D], KV [S, R, D], Pos [S, R] int: row (s, i) becomes
    cache[s, Pos[s, i]], in place. A negative position counts from the
    end; a pad row (position T or beyond) writes nothing, as the
    reference's out-of-bounds scatter drops it (_verify_targets). Out is
    Cache."""
    cache = ins['Cache'][0]
    rows, tgt, real = _verify_targets(ins['Pos'][0], cache.shape[1])
    _verify_put(cache, rows, tgt, real, ins['KV'][0])
    return {'Out': [cache]}


@register('kv_cache_verify_attention', no_grad=True)
def _kv_cache_verify_attention(ctx, ins):
    """Q [S, R, D], KCache/VCache [S, T, D], Pos [S, R] int: row i of a
    slot attends its cache rows j <= Pos[s, i], the speculative rows this
    dispatch wrote included. Out [S, R, D]."""
    return {'Out': [_verify_attention_body(
        ctx, ins['Q'][0], ins['KCache'][0], ins['VCache'][0],
        ins['Pos'][0].long())]}


@register('kv_block_verify_write', no_grad=True)
def _kv_block_verify_write(ctx, ins):
    """kv_cache_verify_write over the block pool: Cache [NB, BS, D], KV
    [S, R, D], Pos [S, R] int, BlockTable [S, MAXB] int; each slot's table
    serves its R rows. Pad rows carry position MAXB * BS, past the span,
    so they land in the trash block. Out is Cache."""
    cache = ins['Cache'][0]
    kv = ins['KV'][0]
    pos = ins['Pos'][0]
    table = ins['BlockTable'][0]
    s, r = pos.shape
    wide = table[:, None, :].expand(s, r, table.shape[1]).reshape(s * r, -1)
    bidx, boff = _block_scatter_idx(wide, pos.reshape(-1), cache.shape[1])
    cache.index_put_((bidx, boff), kv.reshape(s * r, -1).to(cache.dtype))
    return {'Out': [cache]}


@register('kv_block_verify_attention', no_grad=True)
def _kv_block_verify_attention(ctx, ins):
    """kv_cache_verify_attention over the block pool: each slot's logical
    view gathers through its table row, and row i masks at j <= Pos[s,
    i]. Out [S, R, D]."""
    table = ins['BlockTable'][0]
    kview = _block_view(ins['KCache'][0], table)
    vview = _block_view(ins['VCache'][0], table)
    return {'Out': [_verify_attention_body(ctx, ins['Q'][0], kview, vview,
                                           ins['Pos'][0].long())]}


# -- the int8 cache ----------------------------------------------------------
_KV_QMAX = 127.0
# an all-zero row quantizes at scale 0; the floor keeps x / s finite (0 / eps
# = 0) without moving any real row's scale
_KV_SCALE_EPS = 1e-30


def _quantize_kv_rows(kv):
    """[..., D] -> (int8 [..., D], f32 scale [...]): one symmetric abs-max
    scale a row. The divisors are device tensors: a Python scalar divisor
    of a CUDA tensor is applied as a multiply by its reciprocal."""
    kv = kv.float()
    qmax = torch.full((), _KV_QMAX, dtype=torch.float32, device=kv.device)
    s = torch.clamp_min(kv.abs().amax(dim=-1) / qmax, _KV_SCALE_EPS)
    q = torch.clamp(torch.round(kv / s[..., None]), -_KV_QMAX, _KV_QMAX)
    return q.to(torch.int8), s


def _dequant(cache, scale):
    """int8 rows [..., D] times their f32 scales [...] -> f32."""
    return cache.float() * scale[..., None]


@register('kv_cache_write_quant', no_grad=True)
def _kv_cache_write_quant(ctx, ins):
    """kv_cache_write over the int8 cache: Cache int8 [S, T, D], Scale f32
    [S, T], KV [S, D], Pos [S] or [S, 1] int. Each slot's row quantizes at
    its own scale; Out and OutScale are Cache and Scale, updated in
    place."""
    cache, cscale = ins['Cache'][0], ins['Scale'][0]
    s, t = cache.shape[0], cache.shape[1]
    q, sc = _quantize_kv_rows(ins['KV'][0].reshape(s, -1))
    pos = _dus_start(ins['Pos'][0].reshape(-1).long(), t, 1)
    rows = torch.arange(s, device=cache.device)
    cache.index_put_((rows, pos), q)
    cscale.index_put_((rows, pos), sc)
    return {'Out': [cache], 'OutScale': [cscale]}


@register('kv_cache_prefill_write_quant', no_grad=True)
def _kv_cache_prefill_write_quant(ctx, ins):
    """kv_cache_prefill_write over the int8 cache: KV [1, L, D] quantizes
    a row a position and lands in rows 0..L-1 of one slot of Cache int8
    [S, T, D] and Scale f32 [S, T], in place."""
    cache, cscale = ins['Cache'][0], ins['Scale'][0]
    q, sc = _quantize_kv_rows(ins['KV'][0])             # [1, L, D], [1, L]
    slot = _dus_start(ins['Slot'][0].reshape(-1)[:1].long(), cache.shape[0],
                      1)
    cache[:, :q.shape[1]].index_copy_(0, slot, q)
    cscale[:, :q.shape[1]].index_copy_(0, slot, sc)
    return {'Out': [cache], 'OutScale': [cscale]}


@register('kv_cache_attention_quant', no_grad=True)
def _kv_cache_attention_quant(ctx, ins):
    """kv_cache_attention over the int8 cache: K and V dequantize (int8
    row x its scale), then the f32 op's body runs. Q stays f32."""
    pos = ins['Pos'][0].reshape(-1).long()
    return {'Out': [_paged_attention_body(
        ctx, ins['Q'][0], _dequant(ins['KCache'][0], ins['KScale'][0]),
        _dequant(ins['VCache'][0], ins['VScale'][0]), pos)]}


def _block_put_quant(cache, cscale, kv, bidx, boff):
    q, sc = _quantize_kv_rows(kv)
    cache.index_put_((bidx, boff), q)
    cscale.index_put_((bidx, boff), sc)


@register('kv_block_write_quant', no_grad=True)
def _kv_block_write_quant(ctx, ins):
    """kv_block_write over the int8 block pool: Cache int8 [NB, BS, D],
    Scale f32 [NB, BS], KV [S, D], Pos [S] int, BlockTable [S, MAXB] int;
    rows quantize at their own scale and scatter with it, in place."""
    cache, cscale = ins['Cache'][0], ins['Scale'][0]
    bidx, boff = _block_scatter_idx(ins['BlockTable'][0],
                                    ins['Pos'][0].reshape(-1),
                                    cache.shape[1])
    _block_put_quant(cache, cscale,
                     ins['KV'][0].reshape(bidx.shape[0], -1), bidx, boff)
    return {'Out': [cache], 'OutScale': [cscale]}


def _block_view_quant(cache, scale, table):
    """The dequantized logical views [R, MAXB * BS, D] of the int8 pool
    through table [R, MAXB]."""
    return _dequant(_block_view(cache, table), _block_view(scale, table))


@register('kv_block_attention_quant', no_grad=True)
def _kv_block_attention_quant(ctx, ins):
    """kv_block_attention over the int8 block pool: each slot's view
    dequantizes, then the f32 op's body runs."""
    table = ins['BlockTable'][0]
    pos = ins['Pos'][0].reshape(-1).long()
    return {'Out': [_paged_attention_body(
        ctx, ins['Q'][0],
        _block_view_quant(ins['KCache'][0], ins['KScale'][0], table),
        _block_view_quant(ins['VCache'][0], ins['VScale'][0], table), pos)]}


@register('kv_block_chunk_write_quant', no_grad=True)
def _kv_block_chunk_write_quant(ctx, ins):
    """kv_block_chunk_write over the int8 block pool: the chunk's rows
    quantize a row a position and scatter through the slot's table, in
    place."""
    cache, cscale = ins['Cache'][0], ins['Scale'][0]
    kv = ins['KV'][0]
    table = ins['BlockTable'][0]
    c = kv.shape[1]
    pos = (ins['Start'][0].reshape(()).long()
           + torch.arange(c, device=table.device))
    bidx, boff = _block_scatter_idx(table.reshape(1, -1).expand(c, -1), pos,
                                    cache.shape[1])
    _block_put_quant(cache, cscale, kv[0], bidx, boff)
    return {'Out': [cache], 'OutScale': [cscale]}


@register('kv_block_chunk_attention_quant', no_grad=True)
def _kv_block_chunk_attention_quant(ctx, ins):
    """kv_block_chunk_attention over the int8 block pool. The chunk's own
    rows attend at full precision: K and V [1, C, D] (the f32 projections
    the write ops quantized) replace the view's rows start..start+C-1, as
    the slot layout's prefill attends its fresh f32 rows; earlier chunks
    and shared prefix blocks exist only as int8 pages and dequantize."""
    kc = ins['KCache'][0]
    table = ins['BlockTable'][0].reshape(1, -1)
    start = ins['Start'][0].reshape(()).long()

    def spliced(cache, scale, fresh):
        view = _block_view_quant(cache, scale, table)[0]       # [T', D]
        t, c = view.shape[0], fresh.shape[1]
        j = torch.arange(t, device=view.device)
        rel = (j - start).clamp(0, c - 1)
        in_chunk = (j >= start) & (j < start + c)
        return torch.where(in_chunk[:, None], fresh[0].float()[rel], view)

    kview = spliced(kc, ins['KScale'][0], ins['K'][0])
    vview = spliced(ins['VCache'][0], ins['VScale'][0], ins['V'][0])
    return {'Out': [_chunk_attention_body(ctx, ins['Q'][0], kview, vview,
                                          ins['Start'][0], kc.shape[2])]}


@register('kv_cache_verify_write_quant', no_grad=True)
def _kv_cache_verify_write_quant(ctx, ins):
    """kv_cache_verify_write over the int8 cache: each speculative row
    quantizes at its own scale; a pad row writes neither row nor scale
    (_verify_targets). Out and OutScale are Cache and Scale, in place."""
    cache, cscale = ins['Cache'][0], ins['Scale'][0]
    rows, tgt, real = _verify_targets(ins['Pos'][0], cache.shape[1])
    q, sc = _quantize_kv_rows(ins['KV'][0])             # [S, R, D], [S, R]
    _verify_put(cache, rows, tgt, real, q)
    _verify_put(cscale, rows, tgt, real, sc)
    return {'Out': [cache], 'OutScale': [cscale]}


@register('kv_cache_verify_attention_quant', no_grad=True)
def _kv_cache_verify_attention_quant(ctx, ins):
    """kv_cache_verify_attention over the int8 cache: K and V dequantize,
    then the f32 verify body runs."""
    return {'Out': [_verify_attention_body(
        ctx, ins['Q'][0], _dequant(ins['KCache'][0], ins['KScale'][0]),
        _dequant(ins['VCache'][0], ins['VScale'][0]),
        ins['Pos'][0].long())]}


@register('kv_block_verify_write_quant', no_grad=True)
def _kv_block_verify_write_quant(ctx, ins):
    """kv_block_verify_write over the int8 block pool: speculative rows
    quantize at their own scale and scatter with it through the slots'
    tables (pad rows to the trash block), in place."""
    cache, cscale = ins['Cache'][0], ins['Scale'][0]
    pos = ins['Pos'][0]
    table = ins['BlockTable'][0]
    s, r = pos.shape
    wide = table[:, None, :].expand(s, r, table.shape[1]).reshape(s * r, -1)
    bidx, boff = _block_scatter_idx(wide, pos.reshape(-1), cache.shape[1])
    _block_put_quant(cache, cscale, ins['KV'][0].reshape(s * r, -1), bidx,
                     boff)
    return {'Out': [cache], 'OutScale': [cscale]}


@register('kv_block_verify_attention_quant', no_grad=True)
def _kv_block_verify_attention_quant(ctx, ins):
    """kv_block_verify_attention over the int8 block pool: each slot's view
    dequantizes, then the f32 verify body runs."""
    table = ins['BlockTable'][0]
    return {'Out': [_verify_attention_body(
        ctx, ins['Q'][0],
        _block_view_quant(ins['KCache'][0], ins['KScale'][0], table),
        _block_view_quant(ins['VCache'][0], ins['VScale'][0], table),
        ins['Pos'][0].long())]}


# -- CTC, best-path decoding and edit distance over LoD rows -----------------
# (paddle_tpu/ops/decode_ops.py:53-205). The reference's decoders keep
# static shapes: a decoded sequence is left-aligned in its input row span
# and padded with -1, never compacted to a data-dependent LoD, and
# edit_distance skips the -1 entries. The port keeps those shapes. Every
# index these ops build from offsets is built on the host and cached on
# the device (core/lod.py device_index).
_LOG_EPS = -1e5   # optax.ctc_loss's log_epsilon, the reference's log(+0)


def _lod_offsets(x, what):
    if not (isinstance(x, LoDArray) and x.lod):
        raise TypeError("%s requires a LoD input" % what)
    return tuple(x.lod[-1])


def _pad_batch(x, what):
    """LoDArray -> (padded [B, T, ...], valid mask [B, T], offsets)."""
    off = _lod_offsets(x, what)
    padded, mask = pad_from_lod(unwrap(x), off)
    if mask is None:
        mask = torch.ones(padded.shape[:2], dtype=torch.bool,
                          device=padded.device)
    return padded, mask, off


def _logaddexp_tail(phi, added):
    """phi with phi[:, 1:] log-added to `added` (optax's update_phi_score):
    column 0 log-added to -inf, which leaves it as it is, exactly."""
    return torch.logaddexp(phi, F.pad(added, (1, 0), value=-math.inf))


def ctc_loss(logits, logit_pad, labels, label_pad, blank):
    """The CTC loss of each sequence, -log p(labels | logits): optax's
    ctc_loss_with_forward_probs (the reference's warpctc calls it) in
    torch, one loop over time. logits [B, T, K], logit_pad [B, T] (1.0 at
    padding), labels [B, N] int, label_pad [B, N]; the log-softmax in the
    logits' dtype and the recursion in f32, as optax computes them."""
    b, t_max, _ = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = n - label_pad.sum(1).to(torch.int64)
    repeat = (labels[:, :-1] == labels[:, 1:]).float()
    repeat = torch.cat([repeat, repeat.new_zeros(b, 1)], dim=1)
    lp_phi = logprobs[:, :, blank:blank + 1].transpose(0, 1).unbind(0)
    lp_emit = torch.gather(
        logprobs, 2, labels[:, None, :].expand(b, t_max, n).long()
    ).float().transpose(0, 1).unbind(0)            # T of [B, 1] and [B, N]
    dev = logits.device
    phi = torch.full((b, n + 1), _LOG_EPS, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), _LOG_EPS, device=dev)
    # a padded frame keeps the state: where(pad, old, new), the value of
    # optax's pad·old + (1 - pad)·new for pad in {0, 1}
    pads = (logit_pad != 0).transpose(0, 1).reshape(t_max, b, 1).unbind(0)
    eps_repeat = _LOG_EPS * repeat
    eps_single = _LOG_EPS * (1.0 - repeat)
    for t in range(t_max):
        phi_orig = phi
        phi = _logaddexp_tail(phi, emit + eps_repeat)
        next_emit = torch.logaddexp(phi[:, :-1] + lp_emit[t],
                                    emit + lp_emit[t])
        next_phi = _logaddexp_tail(phi + lp_phi[t],
                                   emit + lp_phi[t] + eps_single)
        emit = torch.where(pads[t], emit, next_emit)
        phi = torch.where(pads[t], phi_orig, next_phi)
    last = _logaddexp_tail(phi, emit)
    return -torch.gather(last, 1, labellens[:, None]).reshape(-1)


@register('warpctc', lod='aware')
def _warpctc(ctx, ins):
    """Logits LoD rows [T, K], Label LoD int rows -> Loss [B, 1]. With
    norm_by_times the gradient is scaled by 1/T of each sequence while
    the reported loss stays unnormalized (the reference's
    WarpCTCGradKernel, decode_ops.py:75-81)."""
    logits, label = ins['Logits'][0], ins['Label'][0]
    blank = int(ctx.attr('blank', 0))
    lg, lg_mask, lg_off = _pad_batch(logits, 'warpctc Logits')
    lb, lb_mask, _ = _pad_batch(label, 'warpctc Label')
    lb = lb.reshape(lb.shape[0], -1)
    logit_pad = 1.0 - lg_mask.to(lg.dtype)
    label_pad = 1.0 - lb_mask.to(lg.dtype)
    loss = ctc_loss(lg, logit_pad, lb, label_pad, blank)
    if ctx.attr('norm_by_times', False):
        lens = device_index('lens', lg_off, 0, loss.device,
                            lambda: np.diff(np.asarray(lg_off)),
                            torch.float32)
        scaled = loss / lens
        loss = scaled + (loss - scaled).detach()
    return {'Loss': [loss.reshape(-1, 1)], 'WarpCTCGrad': None}


def _align_flat(best, off, blank, merge_repeated=True):
    """Merge repeats (optionally) and drop blanks over a flat LoD token
    stream [T]: each kept token moves to its rank within its sequence's
    row span, -1 elsewhere. A frame is kept if it is not blank and (when
    merging) differs from the previous frame of the same sequence."""
    t_len = best.shape[0]
    o = np.asarray(off, np.int64)
    dev = best.device
    # each row's sequence start
    start = device_index('start', off, t_len, dev,
                         lambda: o[segment_ids_from_offsets(o)])
    keep = best != blank
    if merge_repeated:
        first = device_index('first', off, t_len, dev,
                             lambda: np.isin(np.arange(t_len), o[:-1]),
                             torch.bool)
        prev = torch.cat([best.new_full((1,), -1), best[:-1]])
        keep = keep & (first | (best != prev))
    csum = torch.cumsum(keep.to(torch.int64), 0)
    base = torch.cat([csum.new_zeros(1), csum])[start]
    tgt = torch.where(keep, start + csum - 1 - base,
                      torch.full_like(csum, t_len))
    out = best.new_full((t_len + 1,), -1)
    out.index_put_((tgt,), best)
    return out[:t_len]


@register('ctc_greedy_decoder', no_grad=True, lod='aware')
def _ctc_greedy_decoder(ctx, ins):
    """Best path: argmax of each frame, repeats merged, blanks dropped;
    Output [T, 1] int64 with the input's LoD, -1 after each sequence's
    kept tokens."""
    x = ins['Input'][0]
    off = _lod_offsets(x, 'ctc_greedy_decoder')
    best = torch.argmax(unwrap(x), dim=-1)
    out = _align_flat(best, off, int(ctx.attr('blank', 0)))
    return {'Output': [LoDArray(out.reshape(-1, 1), x.lod)]}


@register('ctc_align', no_grad=True, lod='aware')
def _ctc_align(ctx, ins):
    """Already-decoded tokens aligned: repeats merged (merge_repeated),
    blanks dropped, the input's LoD kept with -1 padding."""
    x = ins['Input'][0]
    off = _lod_offsets(x, 'ctc_align')
    toks = unwrap(x).reshape(-1).to(torch.int64)
    out = _align_flat(toks, off, int(ctx.attr('blank', 0)),
                      merge_repeated=bool(ctx.attr('merge_repeated', True)))
    return {'Output': [LoDArray(out.reshape(-1, 1), x.lod)]}


def _compact(seq, ignored):
    """Each row's tokens (>= 0, not ignored) left-aligned, -1 after."""
    keep = seq >= 0
    for tok in ignored:
        keep = keep & (seq != tok)
    rows, width = seq.shape
    pos = torch.cumsum(keep.to(torch.int64), 1) - 1
    flat = torch.arange(rows, device=seq.device)[:, None] * (width + 1)
    tgt = torch.where(keep, flat + pos, flat + width).reshape(-1)
    out = seq.new_full((rows * (width + 1),), -1)
    out.index_put_((tgt,), seq.reshape(-1))
    return out.reshape(rows, width + 1)[:, :width]


def edit_distances(hseq, rseq):
    """The Levenshtein distance of each row pair of -1-padded, left-aligned
    token rows hseq [B, H] and rseq [B, R], as f32 [B]. One loop over the
    hypothesis tokens; each DP row at once, by
    new[j] = min(a[j], new[j-1] + 1) = j + cummin_k<=j (a[k] - k), with
    a[0] = row[0] + 1 and a[j] = min(row[j] + 1, row[j-1] + cost)."""
    b, r = rseq.shape
    cols = torch.arange(r + 1, device=rseq.device)
    row = cols.expand(b, r + 1)
    rows = [row]
    for i in range(hseq.shape[1]):
        cost = (hseq[:, i:i + 1] != rseq).to(torch.int64)
        a = torch.cat([row[:, :1] + 1,
                       torch.minimum(row[:, 1:] + 1, row[:, :-1] + cost)], 1)
        row = torch.cummin(a - cols, dim=1).values + cols
        rows.append(row)
    hlen = (hseq >= 0).sum(1)
    rlen = (rseq >= 0).sum(1)
    table = torch.stack(rows, 1)                        # [B, H + 1, R + 1]
    ar = torch.arange(b, device=rseq.device)
    return table[ar, hlen, rlen].to(torch.float32), rlen


@register('edit_distance', no_grad=True, lod='aware')
def _edit_distance(ctx, ins):
    """Hyps and Refs LoD rows (-1 entries and ignored_tokens skipped) ->
    Out [B, 1] f32 (divided by each reference's length with normalized),
    SequenceNum [1] int64."""
    hyps, refs = ins['Hyps'][0], ins['Refs'][0]
    ignored = tuple(ctx.attr('ignored_tokens', ()) or ())
    seqs = []
    for x, what in ((hyps, 'edit_distance Hyps'),
                    (refs, 'edit_distance Refs')):
        off = _lod_offsets(x, what)
        p, m = pad_from_lod(unwrap(x).reshape(-1).to(torch.int64), off)
        if m is not None:
            p = torch.where(m, p, torch.full_like(p, -1))
        seqs.append(_compact(p, ignored))
    d, rlen = edit_distances(*seqs)
    if ctx.attr('normalized', True):
        d = d / torch.clamp(rlen, min=1).to(torch.float32)
    n = len(_lod_offsets(hyps, 'edit_distance Hyps')) - 1
    return {'Out': [d.reshape(-1, 1)],
            'SequenceNum': [torch.tensor([n], dtype=torch.int64,
                                         device=d.device)]}
