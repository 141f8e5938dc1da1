"""Gradient clipping as graph ops, the port's copy of paddle_tpu/clip.py
(ref: python/paddle/fluid/clip.py).

`append_gradient_clip_ops` (called by Optimizer.minimize before the
regularization ops) rewrites each (param, grad) whose parameter carries a
`gradient_clip_attr` (ParamAttr(gradient_clip=...) or set_gradient_clip):
by value (`clip`), by the tensor's own L2 norm (`clip_by_norm`), or by the
global norm of a group of gradients (`squared_l2_norm` of each, `sum`,
`sqrt`, `global_norm_scale`, then an `elementwise_mul` of each). Every op
it appends carries op_role BACKWARD and `_grad_transform`, so gradient
merge runs it once, on the merged gradients (Executor._ga_partition).
"""
from __future__ import annotations

from . import unique_name
from .backward import OP_ROLE_BACKWARD
from .framework import default_main_program

_ATTRS = {'op_role': OP_ROLE_BACKWARD, '_grad_transform': True}


class BaseErrorClipAttr(object):
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    """Clips a gradient to [min, max] in place (min defaults to -max)."""

    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _append_clip_op(self, block, grad_name):
        block.append_op(type='clip', inputs={'X': [grad_name]},
                        outputs={'Out': [grad_name]},
                        attrs=dict(_ATTRS, min=self.min, max=self.max),
                        infer_shape=False)


class BaseGradientClipAttr(object):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    """grad clamped to [min, max] (min defaults to -max), as
    `<grad>@CLIP`."""

    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(dtype=grad.dtype, shape=grad.shape,
                               name=grad.name + '@CLIP')
        block.append_op(type='clip', inputs={'X': [grad.name]},
                        outputs={'Out': [out.name]},
                        attrs=dict(_ATTRS, min=self.min, max=self.max),
                        infer_shape=False)
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    """grad scaled to L2 norm clip_norm where its norm is larger."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(dtype=grad.dtype, shape=grad.shape,
                               name=grad.name + '@CLIP')
        block.append_op(type='clip_by_norm', inputs={'X': [grad.name]},
                        outputs={'Out': [out.name]},
                        attrs=dict(_ATTRS, max_norm=self.clip_norm),
                        infer_shape=False)
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Every gradient of the group scaled by min(1, clip_norm / g), g the
    L2 norm of all of them together (ref clip.py
    GradientClipByGlobalNorm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
        block = grad.block
        sq = block.create_var(dtype=grad.dtype, shape=())
        block.append_op(type='squared_l2_norm', inputs={'X': [grad.name]},
                        outputs={'Out': [sq.name]}, attrs=dict(_ATTRS),
                        infer_shape=False)
        context[self.group_name].append(sq)
        self.context = context

    def _create_operators(self, param, grad):
        block = grad.block
        group = self.context[self.group_name]
        scale_key = self.group_name + '@SCALE'
        if scale_key not in self.context:
            gsum = block.create_var(dtype=grad.dtype, shape=())
            block.append_op(type='sum', inputs={'X': [v.name for v in group]},
                            outputs={'Out': [gsum.name]},
                            attrs=dict(_ATTRS), infer_shape=False)
            gnorm = block.create_var(dtype=grad.dtype, shape=())
            block.append_op(type='sqrt', inputs={'X': [gsum.name]},
                            outputs={'Out': [gnorm.name]},
                            attrs=dict(_ATTRS), infer_shape=False)
            scale = block.create_var(dtype=grad.dtype, shape=(),
                                     name=unique_name.generate(
                                         self.group_name + '@SCALE'))
            block.append_op(type='global_norm_scale',
                            inputs={'Norm': [gnorm.name]},
                            outputs={'Out': [scale.name]},
                            attrs=dict(_ATTRS, clip_norm=self.clip_norm),
                            infer_shape=False)
            self.context[scale_key] = scale.name
        out = block.create_var(dtype=grad.dtype, shape=grad.shape,
                               name=grad.name + '@CLIP')
        block.append_op(
            type='elementwise_mul',
            inputs={'X': [grad.name], 'Y': [self.context[scale_key]]},
            outputs={'Out': [out.name]}, attrs=dict(_ATTRS, axis=-1),
            infer_shape=False)
        return param, out


def set_gradient_clip(clip, param_list=None, program=None):
    """Give `clip` to every parameter of param_list (default: all of the
    program's), by Parameter or by name."""
    program = program or default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    param_list = [program.global_block().var(p) if isinstance(p, str) else p
                  for p in param_list]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    """Append each parameter's clip ops; returns the (param, grad) list with
    the clipped gradients, the ones without a gradient last."""
    context = {}
    clips = []
    for p, g in param_grads:
        if g is None:
            continue
        clip_attr = (getattr(p, 'gradient_clip_attr', None)
                     or NullGradientClipAttr())
        clip_attr._process_context(context=context, param=p, grad=g)
        clips.append(clip_attr)
    res = []
    for (p, g), clip_attr in zip([pg for pg in param_grads
                                  if pg[1] is not None], clips):
        res.append(clip_attr._create_operators(param=p, grad=g))
    res.extend([(p, g) for p, g in param_grads if g is None])
    return res
