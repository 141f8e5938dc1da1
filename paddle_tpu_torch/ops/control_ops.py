"""Control op lowerings: increment and select (ref:
operators/increment_op.cc, select_op; paddle_tpu/ops/control_ops.py:289,
295)."""
from __future__ import annotations

import torch

from ..core.registry import register
from .math_ops import X


@register('increment', no_grad=True, lod='none')
def _increment(ctx, ins):
    """x + step in x's dtype: the LR schedules' step counter, whose Out is
    its X, so the program rebinds the counter's name."""
    x = X(ins)
    return {'Out': [x + torch.tensor(ctx.attr('step', 1.0), device=x.device)
                    .to(x.dtype)]}


@register('select', lod='none')
def _select(ctx, ins):
    """where(Cond, X, Y), row by row: trailing size-1 dims of Cond are
    dropped, or size-1 dims added, until its rank is X's."""
    cond, x, y = ins['Cond'][0], ins['X'][0], ins['Y'][0]
    while cond.ndim > x.ndim and cond.shape[-1] == 1:
        cond = cond.reshape(cond.shape[:-1])
    if cond.ndim < x.ndim:
        cond = cond.reshape(tuple(cond.shape) + (1,) * (x.ndim - cond.ndim))
    return {'Out': [torch.where(cond, x, y)]}
