"""Optimizer op lowerings (ref: operators/optimizers/sgd_op.h,
momentum_op.h, adam_op.h; paddle_tpu/ops/optimizer_ops.py:26,37,79).

Each writes its outputs under the names of its state inputs (ParamOut is
Param, Moment1Out is Moment1, ...); the interpreter rebinds those names
and the Executor commits the persistable ones to the Scope after the run.
"""
from __future__ import annotations

import torch

from ..core.registry import register


@register('sgd', no_grad=True)
def _sgd(ctx, ins):
    """Dense SGD: p -= lr·g. Sparse (SelectedRows) gradients cannot reach
    it, since lookup_table_grad refuses is_sparse."""
    p, g = ins['Param'][0], ins['Grad'][0]
    return {'ParamOut': [p - ins['LearningRate'][0].reshape(()) * g]}


@register('momentum', no_grad=True)
def _momentum(ctx, ins):
    """Dense momentum, as the JAX lowering's dense branch computes it:
    v = mu·v + g, then p -= lr·v, or with use_nesterov
    p -= (g + mu·v)·lr. Sparse (SelectedRows) gradients cannot reach it,
    since lookup_table_grad refuses is_sparse."""
    p, g, v = ins['Param'][0], ins['Grad'][0], ins['Velocity'][0]
    mu = ctx.attr('mu')
    lr = ins['LearningRate'][0].reshape(())
    v_out = mu * v + g
    if ctx.attr('use_nesterov', False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {'ParamOut': [p_out], 'VelocityOut': [v_out]}


@register('adam', no_grad=True)
def _adam(ctx, ins):
    """Dense Adam, as the JAX lowering's dense branch computes it:
    lr_t = lr·sqrt(1 - beta2_pow)/(1 - beta1_pow), m = b1·m + (1 - b1)·g,
    v = b2·v + (1 - b2)·g², p -= lr_t·m/(sqrt(v) + eps), and each beta
    power times its beta. lazy_mode raises; sparse (SelectedRows)
    gradients cannot reach it, since lookup_table_grad refuses is_sparse."""
    if ctx.attr('lazy_mode', False):
        raise NotImplementedError("adam: lazy_mode (the sparse-row update) "
                                  "is not ported yet")
    p, g = ins['Param'][0], ins['Grad'][0]
    m, v = ins['Moment1'][0], ins['Moment2'][0]
    b1p, b2p = ins['Beta1Pow'][0], ins['Beta2Pow'][0]
    b1 = ctx.attr('beta1', 0.9)
    b2 = ctx.attr('beta2', 0.999)
    eps = ctx.attr('epsilon', 1e-8)
    lr = ins['LearningRate'][0].reshape(())
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    m_out = b1 * m + (1 - b1) * g
    v_out = b2 * v + (1 - b2) * torch.square(g)
    p_out = p - lr_t * m_out / (torch.sqrt(v_out) + eps)
    return {'ParamOut': [p_out], 'Moment1Out': [m_out], 'Moment2Out': [v_out],
            'Beta1PowOut': [b1p * b1], 'Beta2PowOut': [b2p * b2]}
