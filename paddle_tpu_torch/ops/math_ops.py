"""Elementwise, activation, matmul, reduction, softmax and loss op
lowerings (ref: operators/elementwise/, activation_op.cc, mul_op.cc,
reduce_ops/, mean_op.cc, sum_op.cc, softmax_op.cc,
softmax_with_cross_entropy_op.cc, square_error_cost (nn.py);
paddle_tpu/ops/math_ops.py:27,70,216,262,287,306,335,368,385).

Under the amp scope (core/amp.py) they follow the reference's dtypes:
`mul` runs in bf16, an elementwise op resolves a bf16/f32 pair to bf16,
and mean, softmax and the loss compute in f32."""
from __future__ import annotations

import numpy as np
import torch

from ..core import amp
from ..core.registry import register


def X(ins, slot='X'):
    return ins[slot][0]


def _bcast_y(x, y, axis):
    """Fluid's axis broadcast (elementwise_op_function.h): y's dims line up
    with x's starting at `axis` (-1: trailing)."""
    if x.ndim == y.ndim:
        return y
    if axis == -1:
        axis = x.ndim - y.ndim
    shape = [1] * axis + list(y.shape)
    shape += [1] * (x.ndim - len(shape))
    return y.reshape(shape)


def _elementwise(name, fn):
    @register(name)
    def _lower(ctx, ins, _fn=fn):
        x, y = ins['X'][0], ins['Y'][0]
        x, y = amp.unify(x, _bcast_y(x, y, ctx.attr('axis', -1)))
        out = _fn(x, y)
        scale = ctx.attr('scale', None)  # fused scale (rare attr)
        if scale not in (None, 1.0):
            out = out * scale
        return {'Out': [out]}


_elementwise('elementwise_add', torch.add)
_elementwise('elementwise_mul', torch.mul)
_elementwise('elementwise_div', torch.div)


@register('relu')
def _relu(ctx, ins):
    return {'Out': [torch.relu(X(ins))]}


@register('mul')
def _mul(ctx, ins):
    x, y = ins['X'][0], ins['Y'][0]
    xn = ctx.attr('x_num_col_dims', 1)
    yn = ctx.attr('y_num_col_dims', 1)
    x2 = x.reshape(int(np.prod(x.shape[:xn])), int(np.prod(x.shape[xn:])))
    y2 = y.reshape(int(np.prod(y.shape[:yn])), int(np.prod(y.shape[yn:])))
    out = amp.matmul(x2, y2, preferred_element_type=x2.dtype)
    return {'Out': [out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}


@register('reduce_sum')
def _reduce_sum(ctx, ins):
    """Sum over `dim` (negative dims count from the end), or over every dim
    with reduce_all, keeping the reduced dims with keep_dim."""
    x = X(ins)
    keep = bool(ctx.attr('keep_dim', False))
    if ctx.attr('reduce_all', False):
        dims = tuple(range(x.ndim))
    else:
        dims = ctx.attr('dim', [0])
        dims = tuple(d % x.ndim for d in
                     ([dims] if isinstance(dims, int) else dims))
    return {'Out': [torch.sum(x, dim=dims, keepdim=keep)]}


@register('mean')
def _mean(ctx, ins):
    """The mean of every element as a [1] tensor (mean_op.cc's shape),
    accumulated in f32 for a bf16 x, and left in f32 as the reference
    leaves it."""
    return {'Out': [torch.mean(amp.promote_f32(X(ins))).reshape(1)]}


@register('sum')
def _sum(ctx, ins):
    """The sum of the X inputs: how append_backward adds the gradients of
    a var read by several ops. Dense tensors only (no SelectedRows yet)."""
    xs = [x for x in ins['X'] if x is not None]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {'Out': [out]}


@register('softmax')
def _softmax(ctx, ins):
    """softmax over `axis` (default the last), exp and sum in f32 for a
    bf16 x, the result cast back to x's dtype."""
    x = X(ins)
    return {'Out': [amp.restore(torch.softmax(amp.promote_f32(x),
                                              dim=ctx.attr('axis', -1)), x)]}


@register('softmax_with_cross_entropy')
def _softmax_with_cross_entropy(ctx, ins):
    """Loss = -log softmax(logits)[label] over the last dim, in f32 for
    bf16 logits (promote_f32); 0 where label == ignore_index. Hard labels
    ([N, 1] or [N]) only: soft_label raises. Softmax comes back in the
    logits' dtype."""
    if ctx.attr('soft_label', False):
        raise NotImplementedError("softmax_with_cross_entropy: soft_label is "
                                  "not ported yet")
    logits = ins['Logits'][0]
    label = ins['Label'][0]
    logp = torch.log_softmax(amp.promote_f32(logits), dim=-1)
    lab = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
    lab = lab.long()
    ignore = lab == ctx.attr('ignore_index', -100)
    picked = torch.gather(logp, -1, torch.where(ignore, 0, lab)[..., None])
    loss = torch.where(ignore[..., None], 0.0, -picked)
    return {'Softmax': [amp.restore(torch.exp(logp), logits)],
            'Loss': [loss]}


@register('square_error_cost')
def _square_error_cost(ctx, ins):
    """(X - Y)², elementwise."""
    return {'Out': [torch.square(ins['X'][0] - ins['Y'][0])]}
