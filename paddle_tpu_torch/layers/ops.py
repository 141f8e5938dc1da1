"""Simple op wrappers, one layer per unary op (ref:
python/paddle/fluid/layers/ops.py via layer_function_generator.py;
paddle_tpu/layers/ops.py)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__activations__ = [
    'sigmoid', 'logsigmoid', 'exp', 'tanh', 'tanh_shrink', 'softshrink',
    'sqrt', 'abs', 'ceil', 'floor', 'cos', 'sin', 'round', 'reciprocal',
    'square', 'softplus', 'softsign',
]

__all__ = __activations__ + [
    'uniform_random', 'hard_shrink', 'cumsum', 'thresholded_relu',
]


def _make_unary(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={'X': x}, outputs={'Out': out},
                         attrs=attrs)
        return out
    layer.__name__ = op_type
    return layer


for _t in __activations__:
    globals()[_t] = _make_unary(_t)
del _t

hard_shrink = _make_unary('hard_shrink')
thresholded_relu = _make_unary('thresholded_relu')


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper('cum_sum')
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='cum_sum', inputs={'X': x}, outputs={'Out': out},
                     attrs={'axis': axis, 'exclusive': exclusive,
                            'reverse': reverse})
    return out


def uniform_random(shape, dtype='float32', min=-1.0, max=1.0, seed=0):
    helper = LayerHelper('uniform_random')
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='uniform_random', outputs={'Out': out},
                     attrs={'shape': list(shape), 'dtype': dtype, 'min': min,
                            'max': max, 'seed': seed})
    out.stop_gradient = True
    return out
