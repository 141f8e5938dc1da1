"""KV-cache op lowerings of continuous decode serving: kv_cache_write,
kv_cache_prefill_write and kv_cache_attention (ref:
paddle_tpu/ops/decode_ops.py:456-537).

The decode-serving tier (inference/decoding.py) runs a decoder-only LM as
fixed-shape programs over a preallocated slot-paged KV cache
[max_slots, max_cache_len, d_model] held as persistable state: a bucketed
prefill program writes a whole prompt's K/V rows into one slot, and a
decode-step program advances every slot by one token.

- The two writes update the cache tensor in place (index_put_ /
  index_copy_), as their Out aliases Cache: nothing of [S, T, D] is
  copied per write. Their starts map as jax.lax.dynamic_update_slice
  maps them (_dus_start): a negative start counts from the end, then the
  start clamps so that the update fits. A step position at or above T
  writes row T-1, a prefill slot at or above S writes slot S-1. No index
  ever leaves the tensor.
- The attention is plain torch (einsum, masked_fill, softmax), as the
  reference's is plain jnp: no Pallas kernel stands behind it, so no
  hand-written one does here. Rows j > pos are set to -inf before the
  softmax, so they get exactly zero weight and stale finite garbage in
  masked or foreign rows cannot move an active slot's output. Every
  product keeps a slot's rows apart from the others' (the slot is a batch
  dim of each einsum), so a slot's outputs do not depend on which other
  requests share the step: the continuous-batching contract.
"""
from __future__ import annotations

import torch

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


@register('kv_cache_attention', no_grad=True)
def _kv_cache_attention(ctx, ins):
    """Q [S, D], KCache/VCache [S, T, D], Pos [S] int: each slot's query
    attends its own cache rows j <= Pos[s] (already written this step),
    heads split inside the op (attr n_head), scale the attr or dh^-0.5.
    Out [S, D] in Q's dtype."""
    q = ins['Q'][0]
    kc = ins['KCache'][0]
    vc = ins['VCache'][0]
    pos = ins['Pos'][0].reshape(-1).long()
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
    return {'Out': [ctxv.reshape(s, d).to(q.dtype)]}
