"""Tensor op lowerings: the startup program's init ops (assign_value
among them), range, dropout, the reshape2/transpose2 views, concat,
split, slice, gather, pad, cum_sum, top_k and add_position_encoding (ref:
operators/fill_constant_op.cc, assign_value_op.cc, uniform_random_op.cc,
gaussian_random_op.cc, range_op.cc, dropout_op.cc, reshape_op.cc,
transpose_op.cc, concat_op.cc, split_op.cc, slice_op.cc, gather_op.cc,
pad_op.cc, cum_op.h, top_k_op.cc, add_position_encoding_op.h;
paddle_tpu/ops/tensor_ops.py:28,73,95,116,46,174,282,298,365,359,379,445,
470,517,539,617).

Random ops draw from the torch.Generator that ctx.rng() seeds for the op.
torch's streams differ from JAX's threefry streams, so the two packages
initialize the same program to different numbers and draw different
dropout masks; weights.py carries the JAX package's values across where a
comparison needs the same ones, and a test that compares dropout across
packages replaces `draw_dropout_keep` with the reference's masks.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register
from ..framework import to_torch_dtype
from .math_ops import X, weak_scalar


def _shape_dtype(ctx):
    shape = [int(s) for s in ctx.attr('shape', [1])]
    return shape, to_torch_dtype(ctx.attr('dtype') or 'float32')


@register('fill_constant', no_grad=True)
def _fill_constant(ctx, ins):
    shape, dt = _shape_dtype(ctx)
    return {'Out': [torch.full(shape, ctx.attr('value', 0.0), dtype=dt,
                               device=ctx.device)]}


@register('assign_value', no_grad=True)
def _assign_value(ctx, ins):
    """The constant the attrs hold (int32_values, or int64_values, for an
    integer or bool dtype; fp32_values otherwise), in the declared dtype
    and shape, made on the executor's device."""
    dt = to_torch_dtype(ctx.attr('dtype') or 'float32')
    if dt.is_floating_point:
        vals = ctx.attr('fp32_values')
    else:
        vals = ctx.attr('int32_values') or ctx.attr('int64_values')
    host = np.asarray(vals, dtype=np.float32 if dt.is_floating_point
                      else np.int64)
    return {'Out': [torch.as_tensor(host).reshape(
        [int(s) for s in ctx.attr('shape')]).to(device=ctx.device,
                                                 dtype=dt)]}


@register('uniform_random', no_grad=True)
def _uniform_random(ctx, ins):
    shape, dt = _shape_dtype(ctx)
    out = torch.empty(shape, dtype=dt, device=ctx.device)
    out.uniform_(ctx.attr('min', -1.0), ctx.attr('max', 1.0),
                 generator=ctx.rng())
    return {'Out': [out]}


@register('gaussian_random', no_grad=True)
def _gaussian_random(ctx, ins):
    shape, dt = _shape_dtype(ctx)
    out = torch.empty(shape, dtype=dt, device=ctx.device)
    out.normal_(ctx.attr('mean', 0.0), ctx.attr('std', 1.0),
                generator=ctx.rng())
    return {'Out': [out]}


@register('range', no_grad=True)
def _range(ctx, ins):
    """[start, end) by step from static attrs, int64 unless the attr says
    otherwise, made on the executor's device."""
    dt = to_torch_dtype(ctx.attr('dtype') or 'int64')
    return {'Out': [torch.arange(ctx.attr('start', 0), ctx.attr('end'),
                                 ctx.attr('step', 1), dtype=dt,
                                 device=ctx.device)]}


def draw_dropout_keep(ctx, shape, p):
    """dropout's keep decision for one op: u < 1 - p with u uniform in
    [0, 1), drawn on the op's device from the op's generator (ctx.rng()),
    as jax.random.bernoulli(key, 1 - p, shape) decides it. A bool tensor of
    `shape`; every element False for p >= 1."""
    u = torch.rand(tuple(shape), generator=ctx.rng(), device=ctx.device)
    return u < 1.0 - p


def _dropout_scale(ctx):
    """The factor a kept element is multiplied by in training: 1/(1-p) for
    upscale_in_train (0 for p >= 1), 1 for downgrade_in_infer. A Python
    float; weak_scalar rounds it to the operand's dtype."""
    p = ctx.attr('dropout_prob', 0.5)
    if ctx.attr('dropout_implementation',
                'downgrade_in_infer') != 'upscale_in_train':
        return 1.0
    return 0.0 if p >= 1.0 else 1.0 / (1.0 - p)


@register('dropout')
def _dropout(ctx, ins):
    """paddle_tpu/ops/tensor_ops.py:174 without FLAGS_dropout_bits. In
    training, Out = where(keep, x·scale, 0) in x's dtype (x·scale rounds
    once, to bf16 for a bf16 x); with is_test, x for upscale_in_train and
    x·(1-p) for downgrade_in_infer. Mask is the keep decision in x's
    dtype (ones with is_test)."""
    x = X(ins)
    p = ctx.attr('dropout_prob', 0.5)
    if ctx.is_test:
        upscale = ctx.attr('dropout_implementation',
                           'downgrade_in_infer') == 'upscale_in_train'
        return {'Out': [x if upscale else x * weak_scalar(1.0 - p, x)],
                'Mask': [torch.ones_like(x)]}
    keep = draw_dropout_keep(ctx, x.shape, p)
    out = torch.where(keep, x * weak_scalar(_dropout_scale(ctx), x),
                      torch.zeros_like(x))
    return {'Out': [out], 'Mask': [keep.to(x.dtype)]}


@register('dropout_grad', no_grad=True)
def _dropout_grad(ctx, ins):
    """The explicit grad of dropout: dX = where(Mask, dOut·scale, 0), dOut
    first cast to Out's dtype as the generic grad casts a cotangent
    (core/lowering.py, _lower_generic_grad). It reads the forward's Mask,
    so the mask is drawn once a step and the gradient never replays a
    generator.
    With is_test: dOut for upscale_in_train, dOut·(1-p) for
    downgrade_in_infer. No cotangent: a zero dX."""
    a = ctx.attrs
    x_name = a['_fwd_inputs']['X'][0]
    gname = a['_in_grad_map'].get(x_name, '')
    if not gname:
        return {}
    interp, op = ctx.interp, ctx.op
    out_name = a['_fwd_outputs']['Out'][0]
    out = interp.read(out_name, op)
    g = interp.cotangent(a['_out_grad_map'].get(out_name, ''), op)
    if g is None:
        return {'IN@GRAD': [torch.zeros_like(interp.read(x_name, op))]}
    g = g.to(out.dtype).reshape(out.shape)
    if ctx.is_test:
        upscale = ctx.attr('dropout_implementation',
                           'downgrade_in_infer') == 'upscale_in_train'
        return {'IN@GRAD': [g if upscale else g * weak_scalar(
            1.0 - ctx.attr('dropout_prob', 0.5), g)]}
    mask = interp.read(a['_fwd_outputs']['Mask'][0], op)
    return {'IN@GRAD': [torch.where(
        mask != 0, g * weak_scalar(_dropout_scale(ctx), g),
        torch.zeros_like(g))]}


def _xshape(x):
    """reshape2/transpose2's XShape: shape (0,) + x.shape, so it holds no
    element and allocates no memory."""
    return x.new_empty((0,) + tuple(x.shape))


def _resolve_reshape(x, shape):
    """A 0 in the target shape copies that dim of x; -1 is left to torch."""
    return [x.shape[i] if s == 0 else int(s) for i, s in enumerate(shape)]


def _reshape_infer(op, block):
    """reshape2's build-time shapes, as paddle_tpu's _reshape_infer gives
    them: the target with 0 copied from x and -1 resolved when x is fully
    static; XShape is (0,) + x.shape. The generic meta evaluation cannot
    reshape a -1-batch input to a static target (probe sizes disagree)."""
    shape = list(op.attrs.get('shape', ()))
    if not shape or (op.inputs.get('Shape') and op.inputs['Shape'][0]):
        return  # runtime shape tensor: declared shapes stay
    xv = block._find_var_recursive(op.inputs['X'][0])
    out = []
    for i, s in enumerate(shape):
        if s == 0:
            if xv is None or xv.shape is None or i >= len(xv.shape):
                return
            out.append(xv.shape[i])
        else:
            out.append(int(s))
    if -1 in out and xv is not None and xv.shape is not None \
            and all(d not in (-1, None) for d in xv.shape):
        known = int(np.prod([d for d in out if d != -1]))
        numel = int(np.prod(xv.shape))
        if known > 0 and numel % known == 0:
            out[out.index(-1)] = numel // known
    for n in op.outputs.get('Out', []):
        v = block._find_var_recursive(n)
        if v is not None:
            v.shape = tuple(out)
            if xv is not None and xv.dtype:
                v.dtype = xv.dtype
    if xv is not None and xv.shape is not None:
        for n in op.outputs.get('XShape', []):
            v = block._find_var_recursive(n)
            if v is not None:
                v.shape = (0,) + tuple(xv.shape)
                if xv.dtype:
                    v.dtype = xv.dtype


@register('reshape2', infer_shape=_reshape_infer)
def _reshape2(ctx, ins):
    """A view of x where its strides allow one (always, for the contiguous
    tensors and head-merge outputs of the BERT path), else a copy: torch's
    `reshape` decides."""
    x = X(ins)
    if ins.get('Shape') and ins['Shape'][0] is not None:
        shape = [int(s) for s in ins['Shape'][0].tolist()]
    else:
        shape = ctx.attr('shape')
    return {'Out': [x.reshape(_resolve_reshape(x, shape))],
            'XShape': [_xshape(x)]}


@register('transpose2')
def _transpose2(ctx, ins):
    """Always a view: no data moves. A consumer that needs contiguous
    memory copies (`mul` via reshape); fused_multihead_attention's kernel
    takes the strides as they are."""
    x = X(ins)
    return {'Out': [x.permute(*ctx.attr('axis'))], 'XShape': [_xshape(x)]}


@register('concat')
def _concat(ctx, ins):
    """The X entries joined along `axis`. Mixed entries take their common
    dtype: torch.cat promotes a bf16 and an f32 entry to f32 as
    jnp.concatenate does, inside the amp scope as outside it (unlike the
    elementwise ops' amp.unify). Its gradient is the generic one
    (core/lowering.py): autograd splits dOut back into the entries, each
    cast to its entry's dtype."""
    xs = [x for x in ins['X'] if x is not None]
    return {'Out': [torch.cat(xs, dim=ctx.attr('axis', 0))]}


@register('split')
def _split(ctx, ins):
    """X cut along `axis` into `num` equal parts, or into parts of the
    sizes `sections` (paddle_tpu/ops/tensor_ops.py:365): views of X.
    horizontal_fuse (passes/horizontal_fuse.py) emits it after a widened
    conv2d to give each branch its own channels back."""
    x = X(ins)
    axis = ctx.attr('axis', 0)
    num = ctx.attr('num', 0)
    if num:
        if x.shape[axis] % num:
            raise ValueError("split: dim %d of size %d does not divide into "
                             "%d parts" % (axis, x.shape[axis], num))
        return {'Out': list(torch.split(x, x.shape[axis] // num, dim=axis))}
    sections = [int(s) for s in ctx.attr('sections', [])]
    if sum(sections) != x.shape[axis]:
        raise ValueError("split: sections %s do not sum to dim %d of size "
                         "%d" % (sections, axis, x.shape[axis]))
    return {'Out': list(torch.split(x, sections, dim=axis))}


@register('slice')
def _slice(ctx, ins):
    """Input[starts:ends] along each of `axes`, a view. Starts and ends
    clamp as the reference's do: a negative one counts from the end (and
    stops at 0), a positive one stops at the dim's size."""
    x = ins['Input'][0]
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(ctx.attr('axes'), ctx.attr('starts'),
                       ctx.attr('ends')):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return {'Out': [x[tuple(idx)]]}


@register('gather')
def _gather(ctx, ins):
    """Rows of X by Index, an int tensor of any shape, flattened: Out is
    [Index.numel()] + X.shape[1:]. An index in [-n, 0) counts from the end,
    as jnp.take wraps it. One outside [-n, n) raises: jnp.take would fill
    its row, but on the card an out-of-range index_select is a device
    assert that ends the CUDA context, so the range is checked on the host
    first (one sync)."""
    x = X(ins)
    n = x.shape[0]
    raw = ins['Index'][0].reshape(-1).long()
    idx = torch.where(raw < 0, raw + n, raw)
    if idx.device.type != 'meta' and idx.numel() and bool(
            ((idx < 0) | (idx >= n)).any()):
        raise IndexError("gather: Index holds a value outside [-%d, %d): %s"
                         % (n, n, raw[:8].tolist()))
    return {'Out': [torch.index_select(x, 0, idx)]}


@register('pad')
def _pad(ctx, ins):
    """Constant padding of every dim: `paddings` is [lo0, hi0, lo1, hi1,
    ...] in dim order, filled with pad_value."""
    x = X(ins)
    p = ctx.attr('paddings')
    flat = []
    for i in reversed(range(x.ndim)):  # F.pad takes the last dim first
        flat += [int(p[2 * i]), int(p[2 * i + 1])]
    return {'Out': [torch.nn.functional.pad(
        x, flat, value=float(ctx.attr('pad_value', 0.0)))]}


@register('cum_sum')
def _cum_sum(ctx, ins):
    """The running sum along `axis` (of the flattened x with flatten),
    from the end with reverse, each element's own term left out with
    exclusive."""
    x = X(ins)
    axis = ctx.attr('axis', -1)
    if ctx.attr('flatten', False):
        x = x.reshape(-1)
        axis = 0
    axis %= x.ndim
    reverse = ctx.attr('reverse', False)
    out = torch.flip(x, (axis,)) if reverse else x
    if ctx.attr('exclusive', False):
        pad = [0, 0] * (out.ndim - 1 - axis) + [1, 0]
        out = torch.nn.functional.pad(out, pad).narrow(axis, 0,
                                                       out.shape[axis])
    out = torch.cumsum(out, dim=axis)
    return {'Out': [torch.flip(out, (axis,)) if reverse else out]}


@register('add_position_encoding')
def _add_position_encoding(ctx, ins):
    """alpha·x + beta·PE for x [batch, seq, dim]: PE[t] is
    [sin(t / 10000^(i/half)), cos(t / 10000^(i/half))] over i < half =
    dim/2, built in f32 and cast to x's dtype, as the reference builds
    it; each product and the sum round to x's dtype."""
    x = X(ins)
    _, t, d = x.shape
    half = d // 2
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    div = torch.pow(torch.tensor(10000.0, device=x.device),
                    torch.arange(half, dtype=torch.float32,
                                 device=x.device) / half)
    enc = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    return {'Out': [x * weak_scalar(ctx.attr('alpha', 1.0), x)
                    + enc[None].to(x.dtype)
                    * weak_scalar(ctx.attr('beta', 1.0), x)]}


@register('top_k')
def _top_k(ctx, ins):
    """The k largest values along the last dim, largest first, and their
    indices as int64."""
    vals, idx = torch.topk(X(ins), int(ctx.attr('k', 1)), dim=-1)
    return {'Out': [vals], 'Indices': [idx]}
