"""NN op lowerings: conv2d, pool2d, batch_norm, layer_norm, lookup_table
and its explicit grad (dense or SelectedRows), merge_selected_rows,
get_tensor_from_selected_rows, fused_multihead_attention (ref:
operators/conv_op.cc, pool_op.cc, batch_norm_op.cc, layer_norm_op.cc,
lookup_table_op.cc, merge_selected_rows_op.cc,
get_tensor_from_selected_rows_op.cc; paddle_tpu/ops/nn_ops.py:29,186,334,
388,480,502,542,552,684).

conv2d maps to torch.nn.functional.conv2d (cuDNN on the card), as the JAX
package leaves it to XLA, through core/amp.py: bf16 operands and result
under the amp scope. batch_norm and layer_norm keep their statistics in
f32 and return x's dtype; pool2d, lookup_table and the attention take bf16
or f32 as they come. The batch_norm apply runs through the hand-written
kernel in ops/bn_apply.py, fused_multihead_attention and its gradient
through the ones in ops/flash_attention.py.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import amp
from ..core.registry import register
from ..core.selected_rows import SelectedRowsVal
from .bn_apply import bn_apply
from .flash_attention import FlashAttention, flash_attn_fwd
from .math_ops import X


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


@register('conv2d')
def _conv2d(ctx, ins):
    x, w = ins['Input'][0], ins['Filter'][0]
    out = amp.conv2d(x, w,
                     stride=_pair(ctx.attr('strides', [1, 1])),
                     padding=_pair(ctx.attr('paddings', [0, 0])),
                     dilation=_pair(ctx.attr('dilations', [1, 1])),
                     groups=ctx.attr('groups', 1) or 1)
    return {'Output': [out]}


def ceil_mode_pads(spatial, ksize, strides, pads):
    """Per-spatial-dim (lo, hi) padding implementing pool ceil_mode: the
    high side grows so the last (partial) window is kept instead of
    dropped — output dims become ceil((in + 2p - k) / s) + 1."""
    out = []
    for i in range(len(ksize)):
        in_sz = spatial[i] + 2 * pads[i]
        rem = (in_sz - ksize[i]) % strides[i]
        out.append((pads[i],
                    pads[i] + (strides[i] - rem if rem else 0)))
    return out


def _window_sum(x, ksize, strides, pads_hw):
    """Sum over each window of zero-padded x ([N, C, H, W])."""
    (hlo, hhi), (wlo, whi) = pads_hw
    xp = F.pad(x, (wlo, whi, hlo, hhi))
    return F.avg_pool2d(xp, ksize, strides, divisor_override=1)


@register('pool2d')
def _pool2d(ctx, ins):
    x = X(ins)
    ptype = ctx.attr('pooling_type', 'max')
    ksize = _pair(ctx.attr('ksize'))
    strides = _pair(ctx.attr('strides', [1, 1]))
    pads = _pair(ctx.attr('paddings', [0, 0]))
    if ctx.attr('adaptive', False):
        raise NotImplementedError("adaptive pool2d is not ported yet")
    if ctx.attr('global_pooling', False):
        ksize = list(x.shape[2:])
        pads = [0, 0]
    pads_hw = [(p, p) for p in pads]
    if ctx.attr('ceil_mode', False):
        pads_hw = ceil_mode_pads(x.shape[2:], ksize, strides, pads)
    (hlo, hhi), (wlo, whi) = pads_hw
    if ptype == 'max':
        fill = (-float('inf') if x.dtype.is_floating_point
                else torch.iinfo(x.dtype).min)
        xp = F.pad(x, (wlo, whi, hlo, hhi), value=fill)
        return {'Out': [F.max_pool2d(xp, ksize, strides)]}
    s = _window_sum(x, ksize, strides, pads_hw)
    if ctx.attr('exclusive', True) and any(lo or hi for lo, hi in pads_hw):
        # count each window's real elements, ceil_mode's high-side extension
        # included; a window wholly inside padding counts 0 -> clamp to 1
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        cnt = _window_sum(ones, ksize, strides, pads_hw)
        return {'Out': [s / torch.clamp(cnt, min=1.0)]}
    return {'Out': [s / float(np.prod(ksize))]}


@register('batch_norm')
def _batch_norm(ctx, ins):
    """y = x*k + (bias - m*k), with k = scale / sqrt(v + eps) computed in
    the stats' dtype as paddle_tpu/ops/nn_ops.py:358-366 does. With
    is_test or use_global_stats, m and v are the running stats; otherwise
    they are this batch's, reduced in f32 in plain torch (a bf16 x too),
    and the running stats move by `momentum`. The apply is the bn_apply
    kernel on x in its own dtype (k and b rounded to it), through
    BnApplyFunction: under the generic batch_norm_grad, dk and db flow back
    into Scale and Bias, and into X through the batch mean and `inv`."""
    x = X(ins)
    scale, bias = ins['Scale'][0], ins['Bias'][0]
    mean, var = ins['Mean'][0], ins['Variance'][0]
    eps = ctx.attr('epsilon', 1e-5)
    momentum = ctx.attr('momentum', 0.9)
    layout = ctx.attr('data_layout', 'NCHW')
    use_global = ctx.attr('use_global_stats', False) or ctx.is_test

    c_axis = 1 if layout == 'NCHW' else x.ndim - 1
    if use_global:
        m, v = mean, var
        mean_out, var_out = mean, var
    else:
        red_axes = tuple(i for i in range(x.ndim) if i != c_axis)
        xf = x.float()
        m = xf.mean(red_axes)
        v = xf.square().mean(red_axes) - m.square()
        mean_out = momentum * mean + (1.0 - momentum) * m
        var_out = momentum * var + (1.0 - momentum) * v
    inv = torch.rsqrt(v + eps)
    kvec = inv * scale
    bvec = bias - m * kvec
    y = bn_apply(x.contiguous(), kvec.float().contiguous(),
                 bvec.float().contiguous(), channel_axis=c_axis)
    return {'Y': [y], 'MeanOut': [mean_out], 'VarianceOut': [var_out],
            'SavedMean': [m], 'SavedVariance': [inv]}


@register('layer_norm')
def _layer_norm(ctx, ins):
    """Normalize over the dims from begin_norm_axis on, with the biased
    variance and eps from the attr, computed in f32 and cast back to x's
    dtype; Mean and Variance are f32 of shape [prod(x.shape[:axis])]. One
    torch.native_layer_norm gives Y, the mean and 1/sqrt(var + eps); the
    variance is recovered from the latter."""
    x_in = X(ins)
    x = x_in.float()
    eps = ctx.attr('epsilon', 1e-5)
    axis = ctx.attr('begin_norm_axis', 1)
    norm_shape = tuple(x.shape[axis:])
    scale = (ins.get('Scale') or [None])[0]
    bias = (ins.get('Bias') or [None])[0]
    y, mean, rstd = torch.native_layer_norm(
        x, norm_shape,
        None if scale is None else scale.float().reshape(norm_shape),
        None if bias is None else bias.float().reshape(norm_shape), eps)
    lead = int(np.prod(x.shape[:axis]))
    return {'Y': [y.to(x_in.dtype)], 'Mean': [mean.reshape(lead)],
            'Variance': [(rstd.reshape(lead) ** -2) - eps]}


@register('lookup_table')
def _lookup_table(ctx, ins):
    """Rows of W by integer id. As in the JAX lowering, ids in [-V, 0) count
    from the end, ids outside [-V, V) give NaN rows, and with padding_idx
    the rows of that id are 0. A trailing ids dim of 1 is squeezed:
    ids [S, 1] give [S, D]."""
    w, ids = ins['W'][0], ins['Ids'][0]
    n = w.shape[0]
    flat = ids.reshape(-1)
    idx = torch.where(flat < 0, flat + n, flat)
    valid = (idx >= 0) & (idx < n)
    out = F.embedding(idx.clamp(0, n - 1), w)  # a fresh tensor: fill in place
    out.masked_fill_(~valid[:, None], float('nan'))
    pad = ctx.attr('padding_idx', -1)
    if pad is not None and pad != -1:
        if pad < 0:
            pad += n
        out.masked_fill_((flat == pad)[:, None], 0.0)
    shape = tuple(ids.shape)
    if shape[-1] == 1:
        shape = shape[:-1]
    return {'Out': [out.reshape(shape + (w.shape[1],))]}


@register('lookup_table_grad', no_grad=True)
def _lookup_table_grad(ctx, ins):
    """The explicit grad of lookup_table (paddle_tpu/ops/nn_ops.py:502).
    Each id's output gradient row goes to that id (ids in [-V, 0) count
    from the end, ids outside [-V, V) add nothing), and padding_idx's rows
    get zeros. Dense: W@GRAD is a zero [V, D] table with the rows added.
    is_sparse: W@GRAD is a SelectedRowsVal of the batch's ids and their
    rows (the reference's SelectedRows path, lookup_table_op.cc), a
    padding id keeping its slot with a zero row, an id out of range
    parked at row V."""
    a = ctx.attrs
    w_name = a['_fwd_inputs']['W'][0]
    gname = a['_in_grad_map'].get(w_name, '')
    if not gname:
        return {}
    interp, op = ctx.interp, ctx.op
    w = interp.read(w_name, op)
    n = w.shape[0]
    flat = interp.read(a['_fwd_inputs']['Ids'][0], op).reshape(-1).long()
    g_out = interp.cotangent(
        a['_out_grad_map'].get(a['_fwd_outputs']['Out'][0], ''), op)
    idx = torch.where(flat < 0, flat + n, flat)
    keep = (idx >= 0) & (idx < n)
    pad = ctx.attr('padding_idx', -1)
    not_pad = torch.ones_like(keep)
    if pad is not None and pad != -1:
        not_pad = flat != (pad + n if pad < 0 else pad)
    if g_out is None:
        gv = w.new_zeros((flat.shape[0], w.shape[1]))
    else:
        gv = g_out.reshape(flat.shape[0], w.shape[1]).to(w.dtype)
    if ctx.attr('is_sparse', False):
        gv = torch.where(not_pad[:, None], gv, torch.zeros_like(gv))
        rows = torch.where(keep, idx, torch.full_like(idx, n))
        return {'IN@GRAD': [SelectedRowsVal(rows, gv, n)]}
    dense = torch.zeros_like(w)
    if g_out is None:
        return {'IN@GRAD': [dense]}
    keep &= not_pad
    dense.index_add_(0, idx[keep], gv[keep])
    return {'IN@GRAD': [dense]}


@register('merge_selected_rows', no_grad=True)
def _merge_selected_rows(ctx, ins):
    """A SelectedRows with its duplicate rows summed (SelectedRowsVal.merged:
    N kept, freed slots parked at row == height)."""
    x = ins['X'][0]
    if not isinstance(x, SelectedRowsVal):
        raise TypeError("merge_selected_rows expects SelectedRows input "
                        "(a sparse embedding gradient), got %r" % (x,))
    return {'Out': [x.merged()]}


@register('get_tensor_from_selected_rows', no_grad=True)
def _get_tensor_from_selected_rows(ctx, ins):
    """A SelectedRows' values, [N, *tail]."""
    x = ins['X'][0]
    if not isinstance(x, SelectedRowsVal):
        raise TypeError("get_tensor_from_selected_rows expects SelectedRows "
                        "input, got %r" % (x,))
    return {'Out': [x.values]}


@register('fused_multihead_attention', diff_inputs=('Q', 'K', 'V'))
def _fused_multihead_attention(ctx, ins):
    """Q, K, V [B, H, S, D] -> softmax(scale·Q·Kᵀ [+ causal mask])·V, the
    flash-attention kernel on every CUDA tensor. Under autograd (the generic
    grad op re-running this lowering) it goes through FlashAttention, whose
    forward keeps the rows' log-sum-exp and whose backward runs the two
    backward kernels; otherwise (serving, the training forward) the plain
    forward kernel, which writes no log-sum-exp. sequence_parallel takes
    the single-device semantics, as the JAX lowering does when no
    sequence-parallel mesh is present; the TPU's measured block and
    kernel-selection policy (_flash_policy, PTPU_FLASH_ATTN) is not
    carried over."""
    q, k, v = ins['Q'][0], ins['K'][0], ins['V'][0]
    causal = bool(ctx.attr('causal', False))
    scale = float(ctx.attr('scale', 1.0))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return {'Out': [FlashAttention.apply(q, k, v, causal, scale)]}
    return {'Out': [flash_attn_fwd(q, k, v, causal=causal, scale=scale)]}
