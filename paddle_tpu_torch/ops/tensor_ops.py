"""Tensor creation op lowerings: the startup program's init ops
(ref: operators/fill_constant_op.cc, uniform_random_op.cc,
gaussian_random_op.cc; paddle_tpu/ops/tensor_ops.py:28,95,116).

Random ops draw from the torch.Generator that ctx.rng() seeds for the op.
torch's streams differ from JAX's threefry streams, so the two packages
initialize the same program to different numbers; weights.py carries the
JAX package's values across where a comparison needs the same ones.
"""
from __future__ import annotations

import torch

from ..core.registry import register
from ..framework import to_torch_dtype


def _shape_dtype(ctx):
    shape = [int(s) for s in ctx.attr('shape', [1])]
    return shape, to_torch_dtype(ctx.attr('dtype') or 'float32')


@register('fill_constant', no_grad=True)
def _fill_constant(ctx, ins):
    shape, dt = _shape_dtype(ctx)
    return {'Out': [torch.full(shape, ctx.attr('value', 0.0), dtype=dt,
                               device=ctx.device)]}


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
