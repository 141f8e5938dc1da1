"""Tensor-creation layers (ref: python/paddle/fluid/layers/tensor.py;
paddle_tpu/layers/tensor.py:18,77,158)."""
from __future__ import annotations

from ..framework import convert_dtype
from ..layer_helper import LayerHelper

__all__ = ['create_parameter', 'fill_constant', 'range']


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A parameter of `shape` in the main program, its init op in the
    startup program (LayerHelper.create_parameter)."""
    from ..param_attr import ParamAttr
    helper = LayerHelper("create_parameter", name=name)
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    """A tensor of `shape` filled with `value` (no gradient)."""
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    helper.append_op(type='fill_constant', outputs={'Out': [out]},
                     attrs={'shape': list(shape), 'dtype': convert_dtype(dtype),
                            'value': float(value)})
    out.stop_gradient = True
    return out


def range(start, end, step=1, dtype='int64', name=None):
    """[start, end) with stride step, static bounds (torch.arange)."""
    helper = LayerHelper('range', name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='range', inputs={},
                     outputs={'Out': [out.name]},
                     attrs={'start': start, 'end': end, 'step': step,
                            'dtype': dtype}, infer_shape=False)
    if step == 0:
        raise ValueError("range step must be nonzero")
    span = end - start
    out.shape = (max(0, -(-span // step)),)  # ceil-div, sign-correct
    return out
