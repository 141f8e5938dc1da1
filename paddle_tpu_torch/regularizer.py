"""Weight-decay regularizers appended as graph ops, the port's copy of
paddle_tpu/regularizer.py (ref: python/paddle/fluid/regularizer.py).

`append_regularization_ops` (called by Optimizer.minimize after the clip
ops) adds `grad + coeff·param` (L2Decay) or `grad + coeff·sign(param)`
(L1Decay) for each parameter with a regularizer of its own or, failing
that, the optimizer's, as `<grad>@REGULARIZED`. Every op carries op_role
BACKWARD and `_grad_transform`, so gradient merge applies the decay once
a step (Executor._ga_partition).
"""
from __future__ import annotations

from .backward import OP_ROLE_BACKWARD
from .framework import Parameter

_ATTRS = {'op_role': OP_ROLE_BACKWARD, '_grad_transform': True}


class WeightDecayRegularizer(object):
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type='scale', inputs={"X": [param.name]},
                        outputs={"Out": [decay.name]},
                        attrs=dict(_ATTRS,
                                   scale=self._regularization_coeff),
                        infer_shape=False)
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(dtype=param.dtype, shape=param.shape)
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type='sign', inputs={"X": [param.name]},
                        outputs={"Out": [sign.name]}, attrs=dict(_ATTRS),
                        infer_shape=False)
        block.append_op(type='scale', inputs={"X": [sign.name]},
                        outputs={"Out": [decay.name]},
                        attrs=dict(_ATTRS,
                                   scale=self._regularization_coeff),
                        infer_shape=False)
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """Add `grad += reg(param)` ops (ref regularizer.py
    append_regularization_ops); returns the (param, grad) list with the
    regularized gradients."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        regularization_term = None
        if isinstance(param, Parameter) and param.regularizer is not None:
            regularization_term = param.regularizer(param, grad, grad.block)
        elif regularization is not None:
            regularization_term = regularization(param, grad, grad.block)
        if regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        new_grad = block.create_var(dtype=grad.dtype, shape=grad.shape,
                                    name=grad.name + '@REGULARIZED')
        block.append_op(type='sum',
                        inputs={"X": [grad.name, regularization_term.name]},
                        outputs={"Out": [new_grad.name]}, attrs=dict(_ATTRS),
                        infer_shape=False)
        params_and_grads.append((param, new_grad))
    return params_and_grads


# short aliases, as the reference has them
L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
