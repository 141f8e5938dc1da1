"""Compare layers (ref: python/paddle/fluid/layers/control_flow.py;
paddle_tpu/layers/control_flow.py:38-56): each appends its compare op
and returns a bool var that takes no gradient."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ['less_than', 'less_equal', 'greater_than', 'greater_equal',
           'equal', 'not_equal']


def _cmp(op_type):
    def layer(x, y, cond=None):
        helper = LayerHelper(op_type)
        if cond is None:
            cond = helper.create_variable_for_type_inference('bool')
        cond.stop_gradient = True
        helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                         outputs={'Out': [cond]}, attrs={})
        return cond
    layer.__name__ = op_type
    return layer


less_than = _cmp('less_than')
less_equal = _cmp('less_equal')
greater_than = _cmp('greater_than')
greater_equal = _cmp('greater_equal')
equal = _cmp('equal')
not_equal = _cmp('not_equal')
