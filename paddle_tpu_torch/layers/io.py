"""Data input layers (ref: python/paddle/fluid/layers/io.py;
paddle_tpu/layers/io.py:14)."""
from __future__ import annotations

from ..framework import default_main_program
from ..layer_helper import LayerHelper

__all__ = ['data']


def data(name, shape, append_batch_size=True, dtype='float32', lod_level=0,
         type=None, stop_gradient=True):
    helper = LayerHelper('data')
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    var = helper.block.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True)
    # mirror the reference: a feed op records the feed order
    block = default_main_program().global_block()
    if not any(op.type == 'feed' and op.output('Out') == [name]
               for op in block.ops):
        block.prepend_op(type='feed', inputs={}, outputs={'Out': [name]},
                         attrs={'col': 0}, infer_shape=False)
    return var
