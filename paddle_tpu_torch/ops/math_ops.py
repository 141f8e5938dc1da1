"""Elementwise, activation, clip, mul/matmul, reduction, scale, cast,
softmax, loss, compare and gradient-norm op lowerings (ref:
operators/elementwise/, activation_op.cc, clip_op.cc, clip_by_norm_op.cc,
mul_op.cc, matmul_op.cc, reduce_ops/, mean_op.cc, scale_op.cc, sum_op.cc,
cast_op.cc, softmax_op.cc, softmax_with_cross_entropy_op.cc,
square_error_cost (nn.py), sigmoid_cross_entropy_with_logits_op.cc,
controlflow/compare_op.cc, squared_l2_norm_op.cc;
paddle_tpu/ops/math_ops.py:27,55-56,70-160,195,200,216,228,265-284,287,294,
306,325,335,368,385,463,520,550,556).

Under the amp scope (core/amp.py) they follow the reference's dtypes:
`mul` and `matmul` run in bf16, an elementwise op resolves a bf16/f32
pair to bf16, and mean, softmax and the loss compute in f32. The unary
ops, clip and scale keep their input's dtype, a Python scalar attr
rounded to it first (weak_scalar), as JAX's weak typing gives it."""
from __future__ import annotations

import numpy as np
import torch

from ..core import amp
from ..core.registry import register
from ..core.selected_rows import SelectedRowsVal, concat_rows
from ..framework import to_torch_dtype


def X(ins, slot='X'):
    return ins[slot][0]


def weak_scalar(c, x):
    """The Python scalar c as JAX's weak typing gives it to an op with x:
    rounded to x's dtype (a bf16 x scales by bf16(c)), so `x * c` rounds
    once, as the reference's does."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(c, dtype=x.dtype))
    return c


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
_elementwise('elementwise_sub', torch.sub)
_elementwise('elementwise_mul', torch.mul)
_elementwise('elementwise_div', torch.div)
# torch.maximum and torch.minimum split the gradient of a tie in half, as
# JAX's max and min do
_elementwise('elementwise_max', torch.maximum)
_elementwise('elementwise_min', torch.minimum)
_elementwise('elementwise_pow', torch.pow)


# -- activations and other unary ops (ref: operators/activation_op.cc;
# paddle_tpu/ops/math_ops.py:70-160) ------------------------------------------
def _unary(name, fn):
    @register(name)
    def _lower(ctx, ins, _fn=fn):
        return {'Out': [_fn(X(ins))]}


def _scalar_like(c, x):
    """The Python scalar c as a 0-d tensor of x's dtype (rounded to it, as
    weak typing rounds it) on x's device."""
    return torch.tensor(weak_scalar(c, x), dtype=x.dtype, device=x.device)


_unary('relu', torch.relu)
_unary('sigmoid', torch.sigmoid)
_unary('logsigmoid', torch.nn.functional.logsigmoid)
_unary('tanh', torch.tanh)
_unary('tanh_shrink', lambda x: x - torch.tanh(x))
_unary('exp', torch.exp)
_unary('sqrt', torch.sqrt)
# |x| with JAX's gradient at 0, 1 (torch.abs's is 0)
_unary('abs', lambda x: torch.where(x >= 0, x, -x))
_unary('ceil', torch.ceil)
_unary('floor', torch.floor)
_unary('cos', torch.cos)
_unary('sin', torch.sin)
_unary('round', torch.round)  # half to even, as jnp.round
_unary('reciprocal', torch.reciprocal)
_unary('square', torch.square)


class _Softplus(torch.autograd.Function):
    """jax.nn.softplus, logaddexp(x, 0), step for step in x's dtype:
    max(x, 0) + log1p(exp(-|x|)), with no linear branch above a threshold,
    and logaddexp's own derivative dOut·exp(x - out) (jax/_src/lax/
    other.py logaddexp and its jvp), where torch's logaddexp backward
    divides by 1 + exp(-x) and rounds otherwise in bf16."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


_unary('softplus', _Softplus.apply)
_unary('softsign', torch.nn.functional.softsign)
_unary('sign', torch.sign)


@register('hard_shrink')
def _hard_shrink(ctx, ins):
    """x where |x| > threshold, else 0."""
    x = X(ins)
    t = weak_scalar(ctx.attr('threshold', 0.5), x)
    return {'Out': [torch.where(torch.abs(x) > t, x, 0.0)]}


@register('softshrink')
def _softshrink(ctx, ins):
    """x - lambda above lambda, x + lambda below -lambda, else 0."""
    x = X(ins)
    lam = weak_scalar(ctx.attr('lambda', 0.5), x)
    return {'Out': [torch.where(x > lam, x - lam,
                                torch.where(x < -lam, x + lam, 0.0))]}


@register('thresholded_relu')
def _thresholded_relu(ctx, ins):
    """x where x > threshold, else 0."""
    x = X(ins)
    t = weak_scalar(ctx.attr('threshold', 1.0), x)
    return {'Out': [torch.where(x > t, x, 0.0)]}


@register('clip')
def _clip(ctx, ins):
    """x clamped to [min, max] as jnp.clip clamps it: maximum(min, x) then
    minimum(max, x), so a tie with a bound takes half the gradient."""
    x = X(ins)
    out = torch.maximum(_scalar_like(ctx.attr('min'), x), x)
    return {'Out': [torch.minimum(_scalar_like(ctx.attr('max'), x), out)]}


@register('clip_by_norm')
def _clip_by_norm(ctx, ins):
    """x·(max_norm / ‖x‖₂) where the L2 norm of the whole tensor exceeds
    max_norm, else x."""
    x = X(ins)
    m = ctx.attr('max_norm')
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {'Out': [torch.where(norm > weak_scalar(m, norm),
                                x * (weak_scalar(m, norm) / norm), x)]}


@register('mul')
def _mul(ctx, ins):
    x, y = ins['X'][0], ins['Y'][0]
    xn = ctx.attr('x_num_col_dims', 1)
    yn = ctx.attr('y_num_col_dims', 1)
    x2 = x.reshape(int(np.prod(x.shape[:xn])), int(np.prod(x.shape[xn:])))
    y2 = y.reshape(int(np.prod(y.shape[:yn])), int(np.prod(y.shape[yn:])))
    out = amp.matmul(x2, y2, preferred_element_type=x2.dtype)
    return {'Out': [out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}


@register('matmul')
def _matmul(ctx, ins):
    """paddle_tpu/ops/math_ops.py:228: the batched product of X and Y, each
    transposed in its last two dims first where transpose_X/transpose_Y
    say, through amp.matmul (bf16 under the amp scope), then alpha applied
    to the result in its dtype; a 1-D X (Y) is taken as a row (column)
    and its dim squeezed from the result."""
    x, y = ins['X'][0], ins['Y'][0]
    alpha = ctx.attr('alpha', 1.0)
    squeeze = []
    if x.ndim == 1:
        x = x[None, :]
        squeeze.append(-2)
    if y.ndim == 1:
        y = y[:, None]
        squeeze.append(-1)
    if ctx.attr('transpose_X', False):
        x = x.transpose(-1, -2)
    if ctx.attr('transpose_Y', False):
        y = y.transpose(-1, -2)
    out = amp.matmul(x, y)
    if alpha != 1.0:
        out = out * weak_scalar(alpha, out)
    for d in squeeze:  # -2 first: then -1 is still the last dim
        out = out.squeeze(d)
    return {'Out': [out]}


def _acc_dtype(x):
    """f32 for a bf16 or f16 x (jnp.sum, mean and prod compute in f32 and
    round the result once), else x's own dtype."""
    return torch.float32 if x.dtype in (torch.bfloat16, torch.float16) \
        else x.dtype


def _prod(x, dims, keep, dtype):
    for d in sorted(dims, reverse=True):  # later dims first: indices hold
        x = torch.prod(x, d, keepdim=keep, dtype=dtype)
    return x


# reduce op -> (fn(x, dims, keep, accumulation dtype), how jnp types an
# integer or bool x: 'int' sums bools as int32, 'float' averages in f32,
# None keeps the dtype)
_REDUCE = {
    'reduce_sum': (lambda x, d, k, acc: torch.sum(x, d, k, dtype=acc), 'int'),
    'reduce_mean': (lambda x, d, k, acc: torch.mean(x, d, k, dtype=acc),
                    'float'),
    'reduce_max': (lambda x, d, k, acc: torch.amax(x, d, k), None),
    'reduce_min': (lambda x, d, k, acc: torch.amin(x, d, k), None),
    'reduce_prod': (_prod, 'int'),
}


def _reduce(name):
    fn, integer = _REDUCE[name]

    @register(name)
    def _lower(ctx, ins):
        """paddle_tpu/ops/math_ops.py:265-284: reduce over `dim` (negative
        dims count from the end), or over every dim with reduce_all,
        keeping the reduced dims with keep_dim; the result in x's dtype
        (bools summed as int32, integers averaged in f32, as jnp does).
        No dims reduce nothing. reduce_max/min give tied elements equal
        shares of the gradient (torch.amax/amin), as jnp.max/min do."""
        x = X(ins)
        keep = bool(ctx.attr('keep_dim', False))
        if ctx.attr('reduce_all', False):
            dims = tuple(range(x.ndim))
        else:
            dims = ctx.attr('dim', [0])
            dims = tuple(sorted({d % x.ndim for d in
                                 ([dims] if isinstance(dims, int)
                                  else dims)}))
        if not dims:
            return {'Out': [x]}
        if not x.is_floating_point() and integer == 'float':
            x = x.float()
        elif x.dtype == torch.bool and integer == 'int':
            x = x.int()
        return {'Out': [fn(x, dims, keep, _acc_dtype(x)).to(x.dtype)]}


for _name in _REDUCE:
    _reduce(_name)


@register('mean')
def _mean(ctx, ins):
    """The mean of every element as a [1] tensor (mean_op.cc's shape),
    accumulated in f32 for a bf16 x, and left in f32 as the reference
    leaves it."""
    return {'Out': [torch.mean(amp.promote_f32(X(ins))).reshape(1)]}


@register('scale')
def _scale(ctx, ins):
    """x·scale + bias (bias_after_scale, the default) or (x + bias)·scale,
    the Python scalars rounded to x's dtype; a ScaleTensor input, when
    given, takes the place of the scale attr."""
    x = X(ins)
    s = ctx.attr('scale', 1.0)
    b = ctx.attr('bias', 0.0)
    if ins.get('ScaleTensor') and ins['ScaleTensor'][0] is not None:
        s = ins['ScaleTensor'][0]
    else:
        s = weak_scalar(s, x)
    b = weak_scalar(b, x)
    if ctx.attr('bias_after_scale', True):
        return {'Out': [x * s + b]}
    return {'Out': [(x + b) * s]}


@register('sum')
def _sum(ctx, ins):
    """The sum of the X inputs: how append_backward adds the gradients of
    a var read by several ops (paddle_tpu/ops/math_ops.py:306-320). All
    SelectedRows: their rows concatenated (addition, for the scatters that
    read them); a mix: the SelectedRows densified first."""
    xs = [x for x in ins['X'] if x is not None]
    sparse = [x for x in xs if isinstance(x, SelectedRowsVal)]
    if sparse:
        if len(sparse) == len(xs):
            return {'Out': [concat_rows(xs)]}
        xs = [x.to_dense() if isinstance(x, SelectedRowsVal) else x
              for x in xs]
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


@register('sigmoid_cross_entropy_with_logits')
def _sigmoid_cross_entropy_with_logits(ctx, ins):
    """max(x, 0) - x·label + log1p(exp(-|x|)) elementwise
    (paddle_tpu/ops/math_ops.py:463), 0 where label == ignore_index; with
    normalize, divided by the count of labels not ignored (at least 1).
    torch.maximum gives a tie at x == 0 half the gradient, as
    jnp.maximum does."""
    x = X(ins)
    label = ins['Label'][0]
    ignore = ctx.attr('ignore_index', -100)
    loss = (torch.maximum(x, torch.zeros_like(x)) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))
    loss = torch.where(label == ignore, torch.zeros_like(loss), loss)
    if ctx.attr('normalize', False):
        cnt = torch.clamp(torch.sum(label != ignore), min=1)
        loss = loss / cnt
    return {'Out': [loss]}


@register('square_error_cost')
def _square_error_cost(ctx, ins):
    """(X - Y)², elementwise."""
    return {'Out': [torch.square(ins['X'][0] - ins['Y'][0])]}


@register('cast')
def _cast(ctx, ins):
    """X in out_dtype (paddle_tpu/ops/math_ops.py:325)."""
    return {'Out': [X(ins).to(to_torch_dtype(ctx.attr('out_dtype')))]}


def _compare(name, fn):
    @register(name, no_grad=True)
    def _lower(ctx, ins, _fn=fn):
        """X <op> Y elementwise, Y broadcast on fluid's axis rule: bool."""
        x, y = ins['X'][0], ins['Y'][0]
        return {'Out': [_fn(x, _bcast_y(x, y, ctx.attr('axis', -1)))]}


_compare('less_than', torch.lt)
_compare('less_equal', torch.le)
_compare('greater_than', torch.gt)
_compare('greater_equal', torch.ge)
_compare('equal', torch.eq)
_compare('not_equal', torch.ne)


@register('squared_l2_norm', lod='none')
def _squared_l2_norm(ctx, ins):
    """The sum of x's squares, a 0-d tensor."""
    return {'Out': [torch.sum(torch.square(X(ins)))]}


@register('global_norm_scale', no_grad=True, lod='none')
def _global_norm_scale(ctx, ins):
    """min(1, clip_norm / max(norm, 1e-12)): the factor by which
    GradientClipByGlobalNorm scales every gradient of its group."""
    norm = ins['Norm'][0]
    clip = weak_scalar(ctx.attr('clip_norm'), norm)
    return {'Out': [torch.minimum(
        torch.ones_like(norm),
        clip / torch.maximum(norm, torch.full_like(norm, 1e-12)))]}
