"""Control op lowerings: increment, select and remat_segment (ref:
operators/increment_op.cc, select_op; paddle_tpu/ops/control_ops.py:289,
295, 125-165)."""
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


# ---------------------------------------------------------------------------
# Activation rematerialization: remat_segment runs a sub-block that
# passes/recompute.py moved a forward segment into
# (paddle_tpu/ops/control_ops.py:125-165).
# ---------------------------------------------------------------------------
def _remat_infer_shape(op, block):
    # the rewrite moves ops verbatim after their outputs were inferred at
    # build time, so the boundary vars' metadata is already right
    return


@register('remat_segment', infer_shape=_remat_infer_shape)
def _remat_segment(ctx, ins):
    """Run the segment's sub-block on an environment of its own, seeded
    with the boundary inputs X, and return only the boundary outputs Out:
    its interior values are freed inside the segment and never reach the
    outer environment (the Executor runs the forward under no_grad).

    Its gradient is the generic one (core/lowering.py): the
    remat_segment_grad op re-runs this lowering under autograd, so the
    whole segment replays with its interior alive only during that grad
    op, and one torch.autograd.grad call takes every boundary input's
    gradient; the port's counterpart of jax.checkpoint under jax.vjp.
    Interior ops keep their `_op_uid`, so a replayed dropout draws what
    the forward drew. At the replay `ctx.op` is the grad op, and the
    boundary names come from its `_fwd_inputs` / `_fwd_outputs`."""
    op = ctx.op
    if op.type == 'remat_segment':
        in_names = list(op.inputs.get('X', ()))
        out_names = list(op.outputs.get('Out', ()))
    else:
        in_names = list(op.attrs['_fwd_inputs']['X'])
        out_names = list(op.attrs['_fwd_outputs']['Out'])
    env = dict(zip(in_names, ins['X']))
    ctx.run_block(int(ctx.attr('sub_block')), env, keep=out_names)
    return {'Out': [env[n] for n in out_names]}
