"""Elementwise, activation and matmul op lowerings
(ref: operators/elementwise/, activation_op.cc, mul_op.cc;
paddle_tpu/ops/math_ops.py:27,70,216)."""
from __future__ import annotations

import numpy as np
import torch

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


@register('elementwise_add')
def _elementwise_add(ctx, ins):
    x, y = ins['X'][0], ins['Y'][0]
    out = x + _bcast_y(x, y, ctx.attr('axis', -1))
    scale = ctx.attr('scale', None)  # fused scale (rare attr)
    if scale not in (None, 1.0):
        out = out * scale
    return {'Out': [out]}


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
    out = torch.matmul(x2, y2)
    return {'Out': [out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}
