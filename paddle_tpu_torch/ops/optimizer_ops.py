"""Optimizer op lowerings (ref: operators/optimizers/sgd_op.h,
momentum_op.h, adam_op.h; paddle_tpu/ops/optimizer_ops.py:22-112), each
with its SelectedRows branch for a sparse embedding's gradient.

Each writes its outputs under the names of its state inputs (ParamOut is
Param, Moment1Out is Moment1, ...); the interpreter rebinds those names
and the Executor commits the persistable ones to the Scope after the run.
"""
from __future__ import annotations

import torch

from ..core.registry import register
from ..core.selected_rows import SelectedRowsVal, rows_add, rows_get, rows_set


@register('sgd', no_grad=True)
def _sgd(ctx, ins):
    """p -= lr·g. A SelectedRows g adds -lr·values at its rows only,
    duplicates added (sgd_op.h's SelectedRows path)."""
    p, g = ins['Param'][0], ins['Grad'][0]
    lr = ins['LearningRate'][0].reshape(())
    if isinstance(g, SelectedRowsVal):
        return {'ParamOut': [rows_add(p, g.rows, -lr * g.values)]}
    return {'ParamOut': [p - lr * g]}


@register('momentum', no_grad=True)
def _momentum(ctx, ins):
    """v = mu·v + g, then p -= lr·v, or with use_nesterov
    p -= (g + mu·v)·lr. A SelectedRows g (momentum_op.h
    SparseMomentumFunctor) is merged first and updates only its rows'
    velocity and parameter."""
    p, g, v = ins['Param'][0], ins['Grad'][0], ins['Velocity'][0]
    mu = ctx.attr('mu')
    lr = ins['LearningRate'][0].reshape(())
    if isinstance(g, SelectedRowsVal):
        m = g.merged()
        gv, rows = m.values, m.rows
        v_new = mu * rows_get(v, rows) + gv
        if ctx.attr('use_nesterov', False):
            p_delta = (gv + mu * v_new) * lr
        else:
            p_delta = lr * v_new
        return {'ParamOut': [rows_add(p, rows, -p_delta)],
                'VelocityOut': [rows_set(v, rows, v_new)]}
    v_out = mu * v + g
    if ctx.attr('use_nesterov', False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {'ParamOut': [p_out], 'VelocityOut': [v_out]}


@register('adam', no_grad=True)
def _adam(ctx, ins):
    """lr_t = lr·sqrt(1 - beta2_pow)/(1 - beta1_pow), m = b1·m + (1 - b1)·g,
    v = b2·v + (1 - b2)·g², p -= lr_t·m/(sqrt(v) + eps), and each beta
    power times its beta. A SelectedRows g (adam_op.h SparseAdamFunctor):
    without lazy_mode it is merged and densified, so every row's moments
    decay; with lazy_mode only its merged rows' moments and parameter
    move, every other row keeps its bits."""
    p, g = ins['Param'][0], ins['Grad'][0]
    m, v = ins['Moment1'][0], ins['Moment2'][0]
    b1p, b2p = ins['Beta1Pow'][0], ins['Beta2Pow'][0]
    b1 = ctx.attr('beta1', 0.9)
    b2 = ctx.attr('beta2', 0.999)
    eps = ctx.attr('epsilon', 1e-8)
    lr = ins['LearningRate'][0].reshape(())
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    powers = {'Beta1PowOut': [b1p * b1], 'Beta2PowOut': [b2p * b2]}
    if isinstance(g, SelectedRowsVal) and not ctx.attr('lazy_mode', False):
        g = g.merged().to_dense()
    if isinstance(g, SelectedRowsVal):
        mg = g.merged()
        rows, gv = mg.rows, mg.values
        m_new = b1 * rows_get(m, rows) + (1 - b1) * gv
        v_new = b2 * rows_get(v, rows) + (1 - b2) * torch.square(gv)
        delta = lr_t * m_new / (torch.sqrt(v_new) + eps)
        return dict(powers, ParamOut=[rows_add(p, rows, -delta)],
                    Moment1Out=[rows_set(m, rows, m_new)],
                    Moment2Out=[rows_set(v, rows, v_new)])
    m_out = b1 * m + (1 - b1) * g
    v_out = b2 * v + (1 - b2) * torch.square(g)
    p_out = p - lr_t * m_out / (torch.sqrt(v_out) + eps)
    return dict(powers, ParamOut=[p_out], Moment1Out=[m_out],
                Moment2Out=[v_out])
