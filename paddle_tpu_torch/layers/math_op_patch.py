"""Operator overloading on Variable (ref: fluid/layers/math_op_patch.py;
paddle_tpu/layers/math_op_patch.py:36).

`x + y` on two Variables appends an elementwise_add op, a Python scalar
operand a fill_constant first. The other operators append their ops too;
a program that uses one whose op has no lowering in the port yet fails
with the registry's "no lowering" error when it runs.
"""
from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper

_CMP = {'less_than', 'less_equal', 'greater_than', 'greater_equal', 'equal',
        'not_equal'}


def _create_scalar_op(var, value, op_type):
    helper = LayerHelper(op_type)
    const = helper.create_variable_for_type_inference(var.dtype)
    helper.append_op(type='fill_constant', outputs={'Out': [const]},
                     attrs={'shape': list(var.shape) if var.shape and
                            -1 not in var.shape else [1],
                            'dtype': var.dtype, 'value': float(value)})
    return const


def _binary(op_type, reverse=False):
    def impl(self, other):
        helper = LayerHelper(op_type)
        if not isinstance(other, Variable):
            other = _create_scalar_op(self, other, op_type)
        lhs, rhs = (other, self) if reverse else (self, other)
        out = helper.create_variable_for_type_inference(
            'bool' if op_type in _CMP else lhs.dtype)
        helper.append_op(type=op_type, inputs={'X': [lhs], 'Y': [rhs]},
                         outputs={'Out': [out]}, attrs={'axis': -1})
        return out
    return impl


def monkey_patch_variable():
    Variable.__add__ = _binary('elementwise_add')
    Variable.__radd__ = _binary('elementwise_add', True)
    Variable.__sub__ = _binary('elementwise_sub')
    Variable.__rsub__ = _binary('elementwise_sub', True)
    Variable.__mul__ = _binary('elementwise_mul')
    Variable.__rmul__ = _binary('elementwise_mul', True)
    Variable.__truediv__ = _binary('elementwise_div')
    Variable.__rtruediv__ = _binary('elementwise_div', True)
    Variable.__div__ = Variable.__truediv__
    Variable.__pow__ = _binary('elementwise_pow')
    Variable.__rpow__ = _binary('elementwise_pow', True)
    Variable.__mod__ = _binary('elementwise_mod')
    Variable.__lt__ = _binary('less_than')
    Variable.__le__ = _binary('less_equal')
    Variable.__gt__ = _binary('greater_than')
    Variable.__ge__ = _binary('greater_equal')

    def __neg__(self):
        helper = LayerHelper('scale')
        out = helper.create_variable_for_type_inference(self.dtype)
        helper.append_op(type='scale', inputs={'X': [self]},
                         outputs={'Out': [out]},
                         attrs={'scale': -1.0, 'bias': 0.0,
                                'bias_after_scale': True})
        return out

    Variable.__neg__ = __neg__
