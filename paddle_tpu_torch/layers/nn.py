"""Neural-network layer functions (ref: python/paddle/fluid/layers/nn.py;
paddle_tpu/layers/nn.py:25,52,71,182,234,275,356,370,388,510,578,691,736,
776-793,842,849,857,867,900,937,983,1008,1049,1057,1161,1573-1615,
1685-1750,1827-1920,1955).

The port's copies of the layers the serving and training slices need. Each appends the
same ops with the same attrs and names as its paddle_tpu counterpart, so a
model built under a fresh unique_name guard gives the same Program, op for
op, in both packages.
"""
from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper
from ..initializer import NormalInitializer, ConstantInitializer
from ..param_attr import ParamAttr

__all__ = ['fc', 'embedding', 'conv2d', 'pool2d', 'batch_norm', 'layer_norm',
           'dropout', 'relu', 'elementwise_add', 'elementwise_sub',
           'elementwise_mul', 'elementwise_div', 'elementwise_max',
           'elementwise_min', 'elementwise_pow', 'reshape', 'transpose',
           'fused_multihead_attention', 'matmul',
           'softmax_with_cross_entropy', 'reduce_sum', 'reduce_mean',
           'reduce_max', 'reduce_min', 'reduce_prod', 'mean', 'softmax',
           'topk', 'pad', 'cast', 'concat', 'square_error_cost',
           'sigmoid_cross_entropy_with_logits', 'merge_selected_rows',
           'get_tensor_from_selected_rows',
           'add_position_encoding', 'scale', 'slice', 'gather', 'clip',
           'kv_cache_write', 'kv_cache_prefill_write', 'kv_cache_attention',
           'kv_block_write', 'kv_block_attention', 'kv_block_chunk_write',
           'kv_block_chunk_attention', 'kv_cache_verify_write',
           'kv_cache_verify_attention', 'kv_block_verify_write',
           'kv_block_verify_attention', 'kv_cache_write_quant',
           'kv_cache_prefill_write_quant', 'kv_cache_attention_quant',
           'kv_block_write_quant', 'kv_block_attention_quant',
           'kv_block_chunk_write_quant', 'kv_block_chunk_attention_quant',
           'kv_cache_verify_write_quant', 'kv_cache_verify_attention_quant',
           'kv_block_verify_write_quant', 'kv_block_verify_attention_quant']


def _single(v, n):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected layer (ref nn.py fc): mul per input + sum + bias + act."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, pattr in helper.iter_inputs_and_params():
        input_shape = input_var.shape
        param_shape = [int(np.prod(input_shape[num_flatten_dims:])), size]
        w = helper.create_parameter(attr=pattr, shape=param_shape, dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="mul", inputs={"X": input_var, "Y": w},
            outputs={"Out": tmp},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": pre_bias}, attrs={})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype='float32'):
    """Embedding lookup (ref nn.py embedding / lookup_table_op.cc).
    is_sparse/is_distributed are recorded as attrs; the lookup is dense."""
    helper = LayerHelper('embedding', param_attr=param_attr)
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype, is_bias=False)
    tmp = helper.create_variable_for_type_inference(dtype)
    padding_idx = (-1 if padding_idx is None else
                   padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        type='lookup_table', inputs={'Ids': input, 'W': w},
        outputs={'Out': tmp},
        attrs={'is_sparse': is_sparse, 'is_distributed': is_distributed,
               'padding_idx': padding_idx})
    return tmp


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    helper = LayerHelper('conv2d', param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1
    filter_size = _single(filter_size, 2)
    stride = _single(stride, 2)
    padding = _single(padding, 2)
    dilation = _single(dilation, 2)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    filter_elem_num = int(np.prod(filter_shape[1:]))
    std = (2.0 / filter_elem_num) ** 0.5
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, std))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='conv2d',
        inputs={'Input': input, 'Filter': w},
        outputs={'Output': pre_bias},
        attrs={'strides': stride, 'paddings': padding, 'dilations': dilation,
               'groups': groups, 'use_cudnn': use_cudnn})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    helper = LayerHelper('pool2d', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type='pool2d', inputs={'X': input}, outputs={'Out': out},
        attrs={'pooling_type': pool_type, 'ksize': _single(pool_size, 2),
               'global_pooling': global_pooling,
               'strides': _single(pool_stride, 2),
               'paddings': _single(pool_padding, 2),
               'ceil_mode': ceil_mode, 'exclusive': exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-05,
               param_attr=None, bias_attr=None, data_layout='NCHW',
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               fuse_with_relu=False, use_global_stats=False):
    helper = LayerHelper('batch_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    c = input.shape[1] if data_layout == 'NCHW' else input.shape[-1]
    scale = helper.create_parameter(
        attr=helper.param_attr or ParamAttr(), shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr or ParamAttr(),
                                   shape=[c], dtype=dtype, is_bias=True)
    mean = helper.create_or_get_global_variable(
        name=moving_mean_name or (helper.name + '.mean'),
        shape=[c], dtype=dtype, persistable=True)
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    variance = helper.create_or_get_global_variable(
        name=moving_variance_name or (helper.name + '.variance'),
        shape=[c], dtype=dtype, persistable=True)
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))
    mean.stop_gradient = True
    variance.stop_gradient = True

    saved_mean = helper.create_variable_for_type_inference(dtype, True)
    saved_var = helper.create_variable_for_type_inference(dtype, True)
    out = input if in_place else helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='batch_norm',
        inputs={'X': input, 'Scale': scale, 'Bias': bias,
                'Mean': mean, 'Variance': variance},
        outputs={'Y': out, 'MeanOut': mean, 'VarianceOut': variance,
                 'SavedMean': saved_mean, 'SavedVariance': saved_var},
        attrs={'momentum': momentum, 'epsilon': epsilon, 'is_test': is_test,
               'data_layout': data_layout,
               'use_global_stats': use_global_stats})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-05, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper('layer_norm', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    param_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {'X': input}
    if scale:
        inputs['Scale'] = helper.create_parameter(
            attr=helper.param_attr, shape=param_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
    if shift:
        inputs['Bias'] = helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype=dtype,
            is_bias=True)
    mean_out = helper.create_variable_for_type_inference(dtype, True)
    var_out = helper.create_variable_for_type_inference(dtype, True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='layer_norm', inputs=inputs,
        outputs={'Y': out, 'Mean': mean_out, 'Variance': var_out},
        attrs={'epsilon': epsilon, 'begin_norm_axis': begin_norm_axis})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """Dropout (ref nn.py dropout; paddle_tpu/layers/nn.py:356): Out and a
    Mask in x's dtype; seed None draws from the op's uid."""
    helper = LayerHelper('dropout', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(
        type='dropout', inputs={'X': x},
        outputs={'Out': out, 'Mask': mask},
        attrs={'dropout_prob': dropout_prob, 'is_test': is_test,
               'seed': seed if seed is not None else 0,
               'dropout_implementation': dropout_implementation})
    return out


def relu(x, name=None):
    helper = LayerHelper('relu', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='relu', inputs={'X': x}, outputs={'Out': out},
                     attrs={})
    return out


def _elementwise_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, act=act, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={'X': x, 'Y': y},
                         outputs={'Out': out}, attrs={'axis': axis})
        return helper.append_activation(out)
    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise_layer('elementwise_add')
elementwise_sub = _elementwise_layer('elementwise_sub')
elementwise_mul = _elementwise_layer('elementwise_mul')
elementwise_div = _elementwise_layer('elementwise_div')
elementwise_max = _elementwise_layer('elementwise_max')
elementwise_min = _elementwise_layer('elementwise_min')
elementwise_pow = _elementwise_layer('elementwise_pow')


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper('reshape2', act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    x_shape = helper.create_variable_for_type_inference(x.dtype, True)
    inputs = {'X': x}
    if actual_shape is not None:
        inputs['Shape'] = actual_shape
    helper.append_op(type='reshape2', inputs=inputs,
                     outputs={'Out': out, 'XShape': x_shape},
                     attrs={'shape': list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper('transpose2', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    x_shape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type='transpose2', inputs={'X': x},
                     outputs={'Out': out, 'XShape': x_shape},
                     attrs={'axis': list(perm)})
    return out


def fused_multihead_attention(q, k, v, causal=False, scale=1.0,
                              sequence_parallel=False, name=None):
    """Fused [B, H, S, D] attention, softmax(scale·q·kᵀ [+ causal])·v: the
    flash-attention kernel on the card (ops/flash_attention.py).
    sequence_parallel is recorded; the port runs it on one device."""
    helper = LayerHelper('fused_multihead_attention', name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    helper.append_op(
        type='fused_multihead_attention',
        inputs={'Q': q, 'K': k, 'V': v}, outputs={'Out': out},
        attrs={'causal': causal, 'scale': scale,
               'sequence_parallel': sequence_parallel}, infer_shape=False)
    out.shape = q.shape  # same [B, H, S, D] as the query
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    """alpha·(X·Y), each transposed in its last two dims first where asked
    (ref nn.py matmul; paddle_tpu/layers/nn.py:736)."""
    helper = LayerHelper('matmul', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type='matmul', inputs={'X': x, 'Y': y}, outputs={'Out': out},
        attrs={'transpose_X': transpose_x, 'transpose_Y': transpose_y,
               'alpha': float(alpha)})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False):
    helper = LayerHelper('softmax_with_cross_entropy')
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type='softmax_with_cross_entropy',
        inputs={'Logits': logits, 'Label': label},
        outputs={'Softmax': softmax_out, 'Loss': loss},
        attrs={'soft_label': soft_label, 'ignore_index': ignore_index})
    if return_softmax:
        return loss, softmax_out
    return loss


def _reduce_layer(op_type):
    """The reduce_* layers (paddle_tpu/layers/nn.py:827-847): `dim` an int
    or a list; None reduces every dim (reduce_all)."""
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is not None and not isinstance(dim, (list, tuple)):
            dim = [dim]
        helper.append_op(
            type=op_type, inputs={'X': input}, outputs={'Out': out},
            attrs={'dim': dim if dim is not None else [0],
                   'keep_dim': keep_dim, 'reduce_all': dim is None})
        return out
    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer('reduce_sum')
reduce_mean = _reduce_layer('reduce_mean')
reduce_max = _reduce_layer('reduce_max')
reduce_min = _reduce_layer('reduce_min')
reduce_prod = _reduce_layer('reduce_prod')


def mean(x, name=None):
    helper = LayerHelper('mean', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='mean', inputs={'X': x}, outputs={'Out': out},
                     attrs={})
    return out


def softmax(input, use_cudnn=True, name=None, axis=-1):
    helper = LayerHelper('softmax', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='softmax', inputs={'X': input},
                     outputs={'Out': out}, attrs={'axis': axis})
    return out


def topk(input, k, name=None):
    helper = LayerHelper('top_k', name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference('int64')
    helper.append_op(type='top_k', inputs={'X': input},
                     outputs={'Out': values, 'Indices': indices},
                     attrs={'k': k})
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper('pad', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='pad', inputs={'X': x}, outputs={'Out': out},
                     attrs={'paddings': paddings, 'pad_value': pad_value})
    return out


def square_error_cost(input, label):
    helper = LayerHelper('square_error_cost')
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='square_error_cost',
                     inputs={'X': input, 'Y': label}, outputs={'Out': out},
                     attrs={})
    return out


def merge_selected_rows(x, name=None):
    """Deduplicate a SelectedRows' rows, summing values
    (ref merge_selected_rows_op.cc)."""
    helper = LayerHelper('merge_selected_rows', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='merge_selected_rows', inputs={'X': x},
                     outputs={'Out': out})
    return out


def get_tensor_from_selected_rows(x, name=None):
    """The dense values tensor of a SelectedRows
    (ref get_tensor_from_selected_rows_op.cc)."""
    helper = LayerHelper('get_tensor_from_selected_rows', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='get_tensor_from_selected_rows', inputs={'X': x},
                     outputs={'Out': out})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper('sigmoid_cross_entropy_with_logits', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type='sigmoid_cross_entropy_with_logits',
        inputs={'X': x, 'Label': label}, outputs={'Out': out},
        attrs={'ignore_index': ignore_index, 'normalize': normalize})
    return out


def cast(x, dtype):
    """x in `dtype` (ref nn.py cast; paddle_tpu/layers/nn.py:1057)."""
    from ..framework import convert_dtype
    helper = LayerHelper('cast')
    out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    helper.append_op(type='cast', inputs={'X': x}, outputs={'Out': out},
                     attrs={'in_dtype': x.dtype,
                            'out_dtype': convert_dtype(dtype)})
    return out


def concat(input, axis=0, name=None):
    """The variables of the list `input` joined along `axis` (ref nn.py
    concat; paddle_tpu/layers/nn.py:1049)."""
    helper = LayerHelper('concat', name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type='concat', inputs={'X': input},
                     outputs={'Out': out}, attrs={'axis': axis})
    return out


def add_position_encoding(input, alpha, beta, name=None):
    """alpha·input + beta·(sinusoid position encoding) for input [batch,
    seq, dim] (ref nn.py add_position_encoding;
    paddle_tpu/layers/nn.py:1161)."""
    helper = LayerHelper('add_position_encoding', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='add_position_encoding', inputs={'X': input},
                     outputs={'Out': out},
                     attrs={'alpha': alpha, 'beta': beta})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """x·scale + bias, or (x + bias)·scale (ref nn.py scale;
    paddle_tpu/layers/nn.py:857)."""
    helper = LayerHelper('scale', act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type='scale', inputs={'X': x}, outputs={'Out': out},
        attrs={'scale': float(scale), 'bias': float(bias),
               'bias_after_scale': bias_after_scale})
    return helper.append_activation(out)


def slice(input, axes, starts, ends):
    """input[starts:ends] along `axes` (ref nn.py slice;
    paddle_tpu/layers/nn.py:937)."""
    helper = LayerHelper('slice')
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='slice', inputs={'Input': input},
                     outputs={'Out': out},
                     attrs={'axes': axes, 'starts': starts, 'ends': ends})
    return out


def gather(input, index):
    """Rows of `input` by the flattened int `index` (ref nn.py gather;
    paddle_tpu/layers/nn.py:983)."""
    helper = LayerHelper('gather')
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='gather', inputs={'X': input, 'Index': index},
                     outputs={'Out': out}, attrs={})
    return out


def clip(x, min, max, name=None):
    """x clamped to [min, max] (ref nn.py clip; paddle_tpu/layers/nn.py:578)."""
    helper = LayerHelper('clip', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='clip', inputs={'X': x}, outputs={'Out': out},
                     attrs={'min': min, 'max': max})
    return out

def kv_cache_write(cache, kv, pos):
    """Write one decode step's K or V rows [max_slots, d] into the
    persistable slot-paged `cache` [max_slots, max_cache_len, d] at each
    slot's `pos` (int32 [max_slots] or [max_slots, 1]). The output is
    `cache` itself (the ParamOut==Param discipline): the op updates it in
    place and returns it (paddle_tpu/layers/nn.py:1573)."""
    return _write_op('kv_cache_write', cache, {'KV': kv, 'Pos': pos})


def kv_cache_prefill_write(cache, kv, slot):
    """Write a whole prompt's K or V rows [1, bucket_len, d] into ONE slot
    of the paged `cache` (int32 `slot`, shape [1] or [1, 1]), in place like
    kv_cache_write (paddle_tpu/layers/nn.py:1588)."""
    return _write_op('kv_cache_prefill_write', cache, {'KV': kv, 'Slot': slot})


def kv_cache_attention(query, k_cache, v_cache, pos, n_head, scale=None):
    """One-token-per-slot attention over the slot-paged KV cache: `query`
    [max_slots, d] attends rows j <= pos of its own slot, heads split
    inside the op; returns the merged context [max_slots, d]
    (paddle_tpu/layers/nn.py:1599)."""
    return _attention_op('kv_cache_attention', query,
                         {'KCache': k_cache, 'VCache': v_cache, 'Pos': pos},
                         n_head, scale)

def _attention_op(type, query, inputs, n_head, scale):
    """Append one of the cache attention ops; returns its output."""
    helper = LayerHelper(type)
    out = helper.create_variable_for_type_inference(query.dtype)
    helper.append_op(type=type, inputs=dict(inputs, Q=query),
                     outputs={'Out': out},
                     attrs={'n_head': int(n_head),
                            'scale': float(scale or 0.0)})
    out.stop_gradient = True
    return out


def _write_op(type, cache, inputs):
    """Append one of the in-place cache writes; returns `cache`, the
    post-write binding."""
    helper = LayerHelper(type)
    helper.append_op(type=type, inputs=dict(inputs, Cache=cache),
                     outputs={'Out': cache}, attrs={})
    return cache


def kv_block_write(cache, kv, pos, block_table):
    """Write one decode step's K or V rows [max_slots, d] into the block
    pool `cache` [num_blocks, block_size, d] through each slot's row of
    `block_table` [max_slots, max_blocks] int32 at `pos`; in place,
    returns `cache` (paddle_tpu/layers/nn.py:1685)."""
    return _write_op('kv_block_write', cache,
                     {'KV': kv, 'Pos': pos, 'BlockTable': block_table})


def kv_block_attention(query, k_cache, v_cache, pos, block_table,
                       n_head, scale=None):
    """One query row a slot [max_slots, d] attends its own slot's logical
    block view rows j <= pos, gathered through `block_table`
    (paddle_tpu/layers/nn.py:1700)."""
    return _attention_op('kv_block_attention', query,
                         {'KCache': k_cache, 'VCache': v_cache, 'Pos': pos,
                          'BlockTable': block_table}, n_head, scale)


def kv_block_chunk_write(cache, kv, start, block_table):
    """Chunked-prefill write: one chunk's K or V rows [1, chunk, d] at
    positions start..start+chunk-1 of one slot scatter into the pool
    through its `block_table` row [1, max_blocks]; in place
    (paddle_tpu/layers/nn.py:1721)."""
    return _write_op('kv_block_chunk_write', cache,
                     {'KV': kv, 'Start': start, 'BlockTable': block_table})


def kv_block_chunk_attention(query, k_cache, v_cache, start, block_table,
                             n_head, scale=None):
    """Chunked-prefill attention: chunk row i ([1, chunk, d] `query`)
    attends the slot's block view rows j <= start + i
    (paddle_tpu/layers/nn.py:1734)."""
    return _attention_op('kv_block_chunk_attention', query,
                         {'KCache': k_cache, 'VCache': v_cache,
                          'Start': start, 'BlockTable': block_table},
                         n_head, scale)


def kv_cache_verify_write(cache, kv, pos):
    """Write R = draft_k + 1 speculative K or V rows a slot ([max_slots,
    R, d]) into the slot-paged `cache` at `pos` [max_slots, R] int32; pad
    rows carry pos = max_cache_len and write nothing. In place
    (paddle_tpu/layers/nn.py:1827)."""
    return _write_op('kv_cache_verify_write', cache, {'KV': kv, 'Pos': pos})


def kv_cache_verify_attention(query, k_cache, v_cache, pos, n_head,
                              scale=None):
    """Verify attention over the slot-paged cache: row i of `query`
    [max_slots, R, d] attends its slot's rows j <= pos[s, i]
    (paddle_tpu/layers/nn.py:1840)."""
    return _attention_op('kv_cache_verify_attention', query,
                         {'KCache': k_cache, 'VCache': v_cache, 'Pos': pos},
                         n_head, scale)


def kv_block_verify_write(cache, kv, pos, block_table):
    """kv_cache_verify_write over the block pool: R speculative rows a
    slot scatter through its `block_table` row; pad rows carry pos =
    max_blocks * block_size and land in the trash block. In place
    (paddle_tpu/layers/nn.py:1890)."""
    return _write_op('kv_block_verify_write', cache,
                     {'KV': kv, 'Pos': pos, 'BlockTable': block_table})


def kv_block_verify_attention(query, k_cache, v_cache, pos, block_table,
                              n_head, scale=None):
    """kv_cache_verify_attention over the block pool: each slot's logical
    view gathers through `block_table`, row i masks at j <= pos[s, i]
    (paddle_tpu/layers/nn.py:1904)."""
    return _attention_op('kv_block_verify_attention', query,
                         {'KCache': k_cache, 'VCache': v_cache, 'Pos': pos,
                          'BlockTable': block_table}, n_head, scale)


# -- the int8 cache (paddle_tpu/layers/nn.py:1620-1950): int8 pages beside one
# f32 scale a page row; each write updates the (cache, scale) pair in place
# and returns both, each attention dequantizes inside the op ---------------
def _write_quant_op(type, cache, cache_scale, inputs):
    """Append one of the in-place int8 cache writes; returns (cache,
    cache_scale), the post-write bindings."""
    helper = LayerHelper(type)
    helper.append_op(type=type,
                     inputs=dict(inputs, Cache=cache, Scale=cache_scale),
                     outputs={'Out': cache, 'OutScale': cache_scale},
                     attrs={})
    return cache, cache_scale


def _quant_caches(k_cache, k_scale, v_cache, v_scale):
    return {'KCache': k_cache, 'KScale': k_scale, 'VCache': v_cache,
            'VScale': v_scale}


def kv_cache_write_quant(cache, cache_scale, kv, pos):
    """kv_cache_write over the int8 slot-paged cache: `cache` int8
    [max_slots, max_cache_len, d], `cache_scale` f32 [max_slots,
    max_cache_len]; each slot's f32 row quantizes at its own abs-max scale
    (paddle_tpu/layers/nn.py:1620)."""
    return _write_quant_op('kv_cache_write_quant', cache, cache_scale,
                           {'KV': kv, 'Pos': pos})


def kv_cache_prefill_write_quant(cache, cache_scale, kv, slot):
    """kv_cache_prefill_write over the int8 cache: a prompt's [1,
    bucket_len, d] rows quantize a row a position into one slot
    (paddle_tpu/layers/nn.py:1635)."""
    return _write_quant_op('kv_cache_prefill_write_quant', cache,
                           cache_scale, {'KV': kv, 'Slot': slot})


def kv_cache_attention_quant(query, k_cache, k_scale, v_cache, v_scale,
                             pos, n_head, scale=None):
    """kv_cache_attention over the int8 cache: the rows dequantize inside
    the op (paddle_tpu/layers/nn.py:1648)."""
    return _attention_op('kv_cache_attention_quant', query,
                         dict(_quant_caches(k_cache, k_scale, v_cache,
                                            v_scale), Pos=pos),
                         n_head, scale)


def kv_block_write_quant(cache, cache_scale, kv, pos, block_table):
    """kv_block_write over the int8 block pool (`cache_scale` f32
    [num_blocks, block_size]) (paddle_tpu/layers/nn.py:1754)."""
    return _write_quant_op('kv_block_write_quant', cache, cache_scale,
                           {'KV': kv, 'Pos': pos,
                            'BlockTable': block_table})


def kv_block_attention_quant(query, k_cache, k_scale, v_cache, v_scale,
                             pos, block_table, n_head, scale=None):
    """kv_block_attention over the int8 block pool
    (paddle_tpu/layers/nn.py:1770)."""
    return _attention_op('kv_block_attention_quant', query,
                         dict(_quant_caches(k_cache, k_scale, v_cache,
                                            v_scale), Pos=pos,
                              BlockTable=block_table), n_head, scale)


def kv_block_chunk_write_quant(cache, cache_scale, kv, start, block_table):
    """kv_block_chunk_write over the int8 block pool
    (paddle_tpu/layers/nn.py:1789)."""
    return _write_quant_op('kv_block_chunk_write_quant', cache, cache_scale,
                           {'KV': kv, 'Start': start,
                            'BlockTable': block_table})


def kv_block_chunk_attention_quant(query, k_cache, k_scale, v_cache,
                                   v_scale, k, v, start, block_table,
                                   n_head, scale=None):
    """kv_block_chunk_attention over the int8 block pool; `k` and `v` are
    the chunk's own f32 projections, attended at full precision in place
    of their quantized rows (paddle_tpu/layers/nn.py:1803)."""
    return _attention_op('kv_block_chunk_attention_quant', query,
                         dict(_quant_caches(k_cache, k_scale, v_cache,
                                            v_scale), K=k, V=v, Start=start,
                              BlockTable=block_table), n_head, scale)


def kv_cache_verify_write_quant(cache, cache_scale, kv, pos):
    """kv_cache_verify_write over the int8 cache; pad rows write neither
    row nor scale (paddle_tpu/layers/nn.py:1860)."""
    return _write_quant_op('kv_cache_verify_write_quant', cache,
                           cache_scale, {'KV': kv, 'Pos': pos})


def kv_cache_verify_attention_quant(query, k_cache, k_scale, v_cache,
                                    v_scale, pos, n_head, scale=None):
    """kv_cache_verify_attention over the int8 cache
    (paddle_tpu/layers/nn.py:1873)."""
    return _attention_op('kv_cache_verify_attention_quant', query,
                         dict(_quant_caches(k_cache, k_scale, v_cache,
                                            v_scale), Pos=pos),
                         n_head, scale)


def kv_block_verify_write_quant(cache, cache_scale, kv, pos, block_table):
    """kv_block_verify_write over the int8 block pool
    (paddle_tpu/layers/nn.py:1922)."""
    return _write_quant_op('kv_block_verify_write_quant', cache,
                           cache_scale, {'KV': kv, 'Pos': pos,
                                         'BlockTable': block_table})


def kv_block_verify_attention_quant(query, k_cache, k_scale, v_cache,
                                    v_scale, pos, block_table, n_head,
                                    scale=None):
    """kv_block_verify_attention over the int8 block pool
    (paddle_tpu/layers/nn.py:1936)."""
    return _attention_op('kv_block_verify_attention_quant', query,
                         dict(_quant_caches(k_cache, k_scale, v_cache,
                                            v_scale), Pos=pos,
                              BlockTable=block_table), n_head, scale)
