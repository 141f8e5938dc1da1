"""Tensor-creation layers (ref: python/paddle/fluid/layers/tensor.py;
paddle_tpu/layers/tensor.py:158)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ['range']


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
