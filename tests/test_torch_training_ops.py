"""The training slices' ops (BERT's, ResNet-50's, then the image zoo's
concat and squeeze-excitation scaling), each as a one-op program with its
gradient op, in both packages on the CPU.

Each case builds the forward op over data vars and, where it has inputs to
differentiate, the `<type>_grad` op that append_backward would emit (the
grad-op convention of backward.py: forward slots, 'Out@GRAD@ALL',
'IN@GRAD', the _fwd_* and _in/_out_grad_map attrs), with the output
cotangents fed as `<out>@GRAD` data vars. paddle_tpu derives a generic
grad op's lowering with jax.vjp of its forward lowering
(paddle_tpu/core/lowering.py:236); the port re-runs its own forward
lowering under torch autograd (paddle_tpu_torch/core/lowering.py). The
explicit lookup_table_grad, one adam step, momentum steps and the
no-grad accuracy op run as themselves. The same numpy inputs and
cotangents go to both, and the forward outputs and the gradients are
compared.

Tolerance: rtol 1e-5 with an absolute floor of 1e-6 of the largest value
compared: f32 on both sides, the same arithmetic summed in other orders.
Integer outputs (top_k's indices, accuracy's counts) compare by value:
paddle_tpu gives int32 indices where the port gives int64.

bf16 mixed precision (the `amp-*` cases): the cases on the BERT and
ResNet-50 training paths run again with the program marked `_amp_bf16`
in both packages, activations fed as bf16 and parameters, statistics and
optimizer state as f32, as an AMP step gives them to the op. Every output
and gradient must have the reference's dtype exactly. Values: where the
op computes in bf16 (a bf16 input, or mul and conv2d, which cast to
bf16), within AMP_ULPS bf16 ulps of each tensor's largest value, and never
looser than what a one-bf16-ulp perturbation of every float input moves
the tensor in the port (measured in the same test); where it stays in f32,
the f32 tolerance above.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as ptt


def _r(*shape, seed=0, low=None):
    rng = np.random.RandomState(seed + 7 * len(shape) + sum(shape))
    if low is not None:
        return rng.uniform(low, low + 1.0, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _ids(*shape, high=10, seed=0):
    return np.random.RandomState(seed).randint(0, high, shape).astype(np.int64)


def _bf16(a):
    """a rounded to bf16 (round to nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _case(type, inputs, outputs, attrs=None, diff=(), cot=None):
    """diff: input names to differentiate; cot: output slots that get a
    cotangent (default: every output slot, when diff is not empty)."""
    if cot is None:
        cot = list(outputs) if diff else []
    return dict(type=type, inputs=inputs, outputs=outputs,
                attrs=dict(attrs or {}), diff=list(diff), cot=list(cot))


def _lookup_grad_case(ids, padding_idx):
    return _case('lookup_table',
                 {'Ids': ('ids', ids), 'W': ('w', _r(10, 4, seed=8))},
                 {'Out': 'out'},
                 {'is_sparse': False, 'is_distributed': False,
                  'padding_idx': padding_idx}, diff=['w'])


def _adam_case():
    g = _r(3, 4, seed=2)
    return _case('adam', {
        'Param': ('p', _r(3, 4, seed=1)), 'Grad': ('g', g),
        'LearningRate': ('lr', np.array([0.01], np.float32)),
        'Moment1': ('m1', 0.1 * _r(3, 4, seed=3)),
        'Moment2': ('m2', 0.01 * _r(3, 4, seed=4, low=0.0)),
        'Beta1Pow': ('b1p', np.array([0.9 ** 3], np.float32)),
        'Beta2Pow': ('b2p', np.array([0.999 ** 3], np.float32))},
        {'ParamOut': 'p_out', 'Moment1Out': 'm1_out', 'Moment2Out': 'm2_out',
         'Beta1PowOut': 'b1p_out', 'Beta2PowOut': 'b2p_out'},
        {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8, 'lazy_mode': False})


def _momentum_case(use_nesterov):
    return _case('momentum', {
        'Param': ('p', _r(3, 4, seed=1)), 'Grad': ('g', _r(3, 4, seed=2)),
        'Velocity': ('v', 0.1 * _r(3, 4, seed=3)),
        'LearningRate': ('lr', np.array([0.1], np.float32))},
        {'ParamOut': 'p_out', 'VelocityOut': 'v_out'},
        {'mu': 0.9, 'use_nesterov': use_nesterov})


def _pool_case(x, **attrs):
    base = {'pooling_type': 'max', 'ksize': [3, 3], 'strides': [2, 2],
            'paddings': [1, 1], 'global_pooling': False, 'ceil_mode': False,
            'exclusive': True}
    base.update(attrs)
    return _case('pool2d', {'X': ('x', x)}, {'Out': 'out'}, base, diff=['x'])


def _tied(*shape, seed=0):
    """relu of rounded normals: mostly 0 and small integers, so most pool
    windows hold ties for their max, as after a relu in ResNet's stem."""
    return np.maximum(np.round(_r(*shape, seed=seed)), 0.0).astype(
        np.float32)


def _batch_norm_case(x, c_axis=1):
    c = x.shape[c_axis]
    return _case('batch_norm', {
        'X': ('x', x), 'Scale': ('scale', _r(c, seed=1, low=0.5)),
        'Bias': ('bias', _r(c, seed=2)), 'Mean': ('mean', _r(c, seed=3)),
        'Variance': ('variance', _r(c, seed=4, low=0.5))},
        {'Y': 'y', 'MeanOut': 'mean_out', 'VarianceOut': 'variance_out',
         'SavedMean': 'saved_mean', 'SavedVariance': 'saved_variance'},
        {'momentum': 0.9, 'epsilon': 1e-5, 'is_test': False,
         'data_layout': 'NCHW' if c_axis == 1 else 'NHWC',
         'use_global_stats': False},
        diff=['x', 'scale', 'bias'], cot=['Y'])


def _accuracy_case(indices, label):
    return _case('accuracy', {
        'Out': ('values', _r(*indices.shape, seed=5)),
        'Indices': ('indices', indices), 'Label': ('label', label)},
        {'Accuracy': 'acc', 'Correct': 'correct', 'Total': 'total'})


def _conv_attrs(stride, pad):
    return {'strides': [stride, stride], 'paddings': [pad, pad],
            'dilations': [1, 1], 'groups': 1, 'use_cudnn': True}


_LABELS = np.array([[3], [-100], [0], [6], [-100], [2]], np.int64)

CASES = {
    'elementwise_add_bias_axis2': _case(
        'elementwise_add', {'X': ('x', _r(2, 3, 4)), 'Y': ('y', _r(4, seed=1))},
        {'Out': 'out'}, {'axis': 2}, diff=['x', 'y']),
    'elementwise_add_broadcast_rows': _case(
        'elementwise_add',
        {'X': ('x', _r(2, 3, 4)), 'Y': ('y', _r(1, 3, 4, seed=2))},
        {'Out': 'out'}, {'axis': -1}, diff=['x', 'y']),
    'elementwise_mul': _case(
        'elementwise_mul', {'X': ('x', _r(6, 1)), 'Y': ('y', _r(6, 1, seed=3))},
        {'Out': 'out'}, {'axis': -1}, diff=['x', 'y']),
    'elementwise_mul_axis1': _case(
        'elementwise_mul', {'X': ('x', _r(2, 3, 4)), 'Y': ('y', _r(3, seed=4))},
        {'Out': 'out'}, {'axis': 1}, diff=['x', 'y']),
    'elementwise_div': _case(
        'elementwise_div',
        {'X': ('x', _r(2, 3)), 'Y': ('y', _r(3, seed=5, low=0.5))},
        {'Out': 'out'}, {'axis': -1}, diff=['x', 'y']),
    'elementwise_div_scalar_by_1': _case(
        'elementwise_div',
        {'X': ('x', np.array(2.5, np.float32)),
         'Y': ('y', np.array([1.75], np.float32))},
        {'Out': 'out'}, {'axis': -1}, diff=['x', 'y']),
    'reduce_sum_all': _case(
        'reduce_sum', {'X': ('x', _r(6, 1))}, {'Out': 'out'},
        {'dim': [0], 'keep_dim': False, 'reduce_all': True}, diff=['x']),
    'reduce_sum_dim1_keep': _case(
        'reduce_sum', {'X': ('x', _r(2, 3, 4))}, {'Out': 'out'},
        {'dim': [1], 'keep_dim': True, 'reduce_all': False}, diff=['x']),
    'reduce_sum_negative_dim': _case(
        'reduce_sum', {'X': ('x', _r(2, 3, 4))}, {'Out': 'out'},
        {'dim': [-1, 0], 'keep_dim': False, 'reduce_all': False}, diff=['x']),
    'sum_three': _case(
        'sum', {'X': [('a', _r(2, 3)), ('b', _r(2, 3, seed=1)),
                      ('c', _r(2, 3, seed=2))]}, {'Out': 'out'}),
    'softmax_with_cross_entropy_ignore_index': _case(
        'softmax_with_cross_entropy',
        {'Logits': ('logits', _r(6, 7)), 'Label': ('label', _LABELS)},
        {'Softmax': 'softmax', 'Loss': 'loss'},
        {'soft_label': False, 'ignore_index': -100}, diff=['logits'],
        cot=['Loss']),
    'fused_multihead_attention': _case(
        'fused_multihead_attention',
        {'Q': ('q', _r(2, 2, 16, 8)), 'K': ('k', _r(2, 2, 16, 8, seed=1)),
         'V': ('v', _r(2, 2, 16, 8, seed=2))},
        {'Out': 'out'}, {'causal': False, 'scale': 0.35,
                         'sequence_parallel': False}, diff=['q', 'k', 'v']),
    'fused_multihead_attention_causal': _case(
        'fused_multihead_attention',
        {'Q': ('q', _r(1, 2, 12, 8)), 'K': ('k', _r(1, 2, 20, 8, seed=1)),
         'V': ('v', _r(1, 2, 20, 8, seed=2))},
        {'Out': 'out'}, {'causal': True, 'scale': 0.35,
                         'sequence_parallel': False}, diff=['q', 'k', 'v']),
    'layer_norm_axis2': _case(
        'layer_norm', {'X': ('x', _r(2, 3, 8)), 'Scale': ('scale', _r(8, seed=1)),
                       'Bias': ('bias', _r(8, seed=2))},
        {'Y': 'y', 'Mean': 'mean', 'Variance': 'variance'},
        {'epsilon': 1e-5, 'begin_norm_axis': 2},
        diff=['x', 'scale', 'bias'], cot=['Y']),
    'mul_x_num_col_dims_2': _case(
        'mul', {'X': ('x', _r(2, 3, 4)), 'Y': ('w', _r(4, 5))}, {'Out': 'out'},
        {'x_num_col_dims': 2, 'y_num_col_dims': 1}, diff=['x', 'w']),
    'relu': _case('relu', {'X': ('x', _r(3, 5))}, {'Out': 'out'},
                  diff=['x']),
    'reshape2_merge_heads': _case(
        'reshape2', {'X': ('x', _r(2, 5, 2, 4))},
        {'Out': 'out', 'XShape': 'xshape'}, {'shape': [-1, 5, 8]},
        diff=['x'], cot=['Out']),
    'transpose2': _case(
        'transpose2', {'X': ('x', _r(2, 5, 2, 4))},
        {'Out': 'out', 'XShape': 'xshape'}, {'axis': [0, 2, 1, 3]},
        diff=['x'], cot=['Out']),
    'lookup_table_grad': _lookup_grad_case(_ids(2, 6), -1),
    'lookup_table_grad_padding_idx': _lookup_grad_case(
        np.array([[1, 3, 3], [0, 3, 9]], np.int64), 3),
    'adam': _adam_case(),
    'mean': _case('mean', {'X': ('x', _r(4, 3, 5))}, {'Out': 'out'},
                  diff=['x']),
    'softmax_last_axis': _case('softmax', {'X': ('x', _r(6, 10))},
                               {'Out': 'out'}, {'axis': -1}, diff=['x']),
    'softmax_axis1': _case('softmax', {'X': ('x', _r(2, 5, 3))},
                           {'Out': 'out'}, {'axis': 1}, diff=['x']),
    'pad_s2d_stem': _case(
        'pad', {'X': ('x', _r(2, 3, 6, 6))}, {'Out': 'out'},
        {'paddings': [0, 0, 0, 0, 3, 3, 3, 3], 'pad_value': 0.0},
        diff=['x']),
    'pad_uneven_value': _case(
        'pad', {'X': ('x', _r(3, 4))}, {'Out': 'out'},
        {'paddings': [1, 0, 2, 3], 'pad_value': -1.5}, diff=['x']),
    'top_k_1': _case('top_k', {'X': ('x', _r(6, 10))},
                     {'Out': 'out', 'Indices': 'indices'}, {'k': 1}),
    'top_k_3': _case('top_k', {'X': ('x', _r(5, 2, 9))},
                     {'Out': 'out', 'Indices': 'indices'}, {'k': 3}),
    'accuracy_top1': _accuracy_case(
        np.array([[3], [1], [0], [7], [2], [2]], np.int64),
        np.array([[3], [2], [0], [7], [9], [1]], np.int64)),
    'accuracy_top3': _accuracy_case(
        np.array([[3, 1, 0], [1, 2, 5], [4, 6, 8]], np.int64),
        np.array([[0], [9], [8]], np.int64)),
    'momentum': _momentum_case(False),
    'momentum_nesterov': _momentum_case(True),
    'pool2d_max_ties': _pool_case(_tied(2, 3, 9, 9)),
    'pool2d_max_ties_even_edge': _pool_case(_tied(2, 2, 8, 8, seed=1)),
    'pool2d_max_random': _pool_case(_r(2, 3, 9, 9)),
    'pool2d_global_avg': _pool_case(_r(2, 4, 5, 5), pooling_type='avg',
                                    global_pooling=True),
    'batch_norm_train': _batch_norm_case(_r(4, 3, 5, 5)),
    'batch_norm_train_offset': _batch_norm_case(3.0 + _r(2, 6, 7, 7)),
    'batch_norm_train_nhwc': _batch_norm_case(_r(3, 4, 4, 5), c_axis=3),
    'concat_2_axis1': _case(
        'concat', {'X': [('a', _r(2, 3, 4)), ('b', _r(2, 5, 4, seed=1))]},
        {'Out': 'out'}, {'axis': 1}, diff=['a', 'b']),
    'concat_4_inception': _case(
        'concat', {'X': [('a', _r(2, 4, 3, 3)), ('b', _r(2, 6, 3, 3, seed=1)),
                         ('c', _r(2, 2, 3, 3, seed=2)),
                         ('d', _r(2, 3, 3, 3, seed=3))]},
        {'Out': 'out'}, {'axis': 1}, diff=['a', 'b', 'c', 'd']),
    'concat_2_axis0_one_differentiated': _case(
        'concat', {'X': [('a', _r(3, 4)), ('b', _r(2, 4, seed=1))]},
        {'Out': 'out'}, {'axis': 0}, diff=['b']),
    'elementwise_mul_axis0_excite': _case(
        'elementwise_mul',
        {'X': ('x', _r(2, 3, 4, 4)), 'Y': ('y', _r(2, 3, seed=6, low=0.0))},
        {'Out': 'out'}, {'axis': 0}, diff=['x', 'y']),
    'conv2d_3x3_pad1': _case(
        'conv2d', {'Input': ('x', _r(2, 3, 8, 8)),
                   'Filter': ('w', 0.3 * _r(4, 3, 3, 3, seed=1))},
        {'Output': 'out'}, _conv_attrs(1, 1), diff=['x', 'w']),
    'conv2d_1x1_stride2': _case(
        'conv2d', {'Input': ('x', _r(2, 8, 7, 7)),
                   'Filter': ('w', 0.3 * _r(6, 8, 1, 1, seed=2))},
        {'Output': 'out'}, _conv_attrs(2, 0), diff=['x', 'w']),
    'conv2d_s2d_stem_4x4': _case(
        'conv2d', {'Input': ('x', _r(2, 12, 9, 9)),
                   'Filter': ('w', 0.2 * _r(5, 12, 4, 4, seed=3))},
        {'Output': 'out'}, _conv_attrs(1, 0), diff=['x', 'w']),
}

# The AMP cases: {id: (case, inputs fed as bf16)}. An AMP step hands an op
# bf16 activations (the outputs of mul and conv2d, and everything computed
# from them) and f32 parameters, BN and optimizer state, embeddings, the
# image and the loss path.
AMP_CASES = {
    'amp-fc_bias_add': ('elementwise_add_bias_axis2', ['x']),
    'amp-residual_add_f32_x': ('elementwise_add_broadcast_rows', ['y']),
    'amp-shortcut_add': ('elementwise_add_broadcast_rows', ['x', 'y']),
    'amp-loss_mul': ('elementwise_mul', []),
    'amp-loss_div': ('elementwise_div_scalar_by_1', []),
    'amp-loss_reduce_sum': ('reduce_sum_all', []),
    'amp-sum_grads': ('sum_three', ['a', 'b', 'c']),
    'amp-softmax_with_cross_entropy': (
        'softmax_with_cross_entropy_ignore_index', ['logits']),
    'amp-fused_multihead_attention': ('fused_multihead_attention',
                                      ['q', 'k', 'v']),
    'amp-layer_norm': ('layer_norm_axis2', ['x']),
    'amp-mul_bf16_x': ('mul_x_num_col_dims_2', ['x']),
    'amp-mul_f32_x': ('mul_x_num_col_dims_2', []),
    'amp-relu': ('relu', ['x']),
    'amp-reshape2': ('reshape2_merge_heads', ['x']),
    'amp-transpose2': ('transpose2', ['x']),
    'amp-lookup_table_grad': ('lookup_table_grad', []),
    'amp-adam': ('adam', []),
    'amp-momentum': ('momentum', []),
    'amp-mean': ('mean', ['x']),
    'amp-softmax': ('softmax_last_axis', ['x']),
    'amp-pad': ('pad_s2d_stem', []),
    'amp-top_k': ('top_k_1', ['x']),
    'amp-accuracy': ('accuracy_top1', ['values']),
    'amp-pool2d_max_ties': ('pool2d_max_ties', ['x']),
    'amp-pool2d_max_random': ('pool2d_max_random', ['x']),
    'amp-pool2d_global_avg': ('pool2d_global_avg', ['x']),
    'amp-batch_norm': ('batch_norm_train', ['x']),
    'amp-batch_norm_offset': ('batch_norm_train_offset', ['x']),
    'amp-conv2d_f32_image': ('conv2d_s2d_stem_4x4', []),
    'amp-conv2d_3x3': ('conv2d_3x3_pad1', ['x']),
    'amp-conv2d_1x1_stride2': ('conv2d_1x1_stride2', ['x']),
    'amp-concat_2': ('concat_2_axis1', ['a', 'b']),
    'amp-concat_4': ('concat_4_inception', ['a', 'b', 'c', 'd']),
    # a bf16/f32 mix promotes to f32, as jnp.concatenate does; each
    # entry's gradient comes back in its own dtype
    'amp-concat_2_mixed': ('concat_2_axis1', ['b']),
    'amp-concat_4_mixed': ('concat_4_inception', ['a', 'c']),
    'amp-elementwise_mul_axis0_excite': ('elementwise_mul_axis0_excite',
                                         ['x', 'y']),
}
# bf16 ulps of a tensor's largest value that an AMP case may differ by
AMP_ULPS = 1


def _slot_items(v):
    return v if isinstance(v, list) else [v]


def _cotangents(case, bf16=(), amp=False):
    """A cotangent for each output slot in case['cot'], shaped as the
    port's forward output on the CPU; under amp, also the names of the
    outputs that are bf16 (their cotangents are fed rounded to bf16)."""
    with ptt.scope_guard(ptt.Scope()):
        main, _, feed, _ = _build(ptt, case, {}, bf16, amp)
        names = [case['outputs'][s] for s in case['cot']]
        outs = ptt.Executor(ptt.CPUPlace()).run(main, feed=feed,
                                                fetch_list=names,
                                                return_numpy=False)
    cots = {name: _r(*out.shape, seed=20 + i) if out.ndim
            else np.array(0.75, np.float32)
            for i, (name, out) in enumerate(zip(names, outs))}
    if not amp:
        return cots
    return cots, {n for n, o in zip(names, outs) if o.dtype == torch.bfloat16}


def _build(pkg, case, cots, bf16=(), amp=False):
    """The forward op over data vars and, with cotangents, its grad op.
    The inputs and cotangents (`<out>@GRAD`) named in bf16 are declared
    bfloat16 and fed rounded to it; amp marks the program `_amp_bf16`.
    Returns (program, startup, feed, fetch names)."""
    main, startup = pkg.Program(), pkg.Program()
    main._amp_bf16 = amp
    feed = {}
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        block = main.global_block()
        for slot, items in case['inputs'].items():
            for name, arr in _slot_items(items):
                dtype = 'bfloat16' if name in bf16 else str(arr.dtype)
                pkg.layers.data(name, shape=list(arr.shape), dtype=dtype,
                                append_batch_size=False, stop_gradient=False)
                feed[name] = _bf16(arr) if name in bf16 else arr
        for name in case['outputs'].values():
            block.create_var(name=name, dtype='float32')
        fwd_inputs = {s: [n for n, _ in _slot_items(items)]
                      for s, items in case['inputs'].items()}
        fwd_outputs = {s: [n] for s, n in case['outputs'].items()}
        op = block.append_op(type=case['type'], inputs=fwd_inputs,
                             outputs=fwd_outputs, attrs=dict(case['attrs']))
        fetch = [case['outputs'][s] for s in case['outputs']
                 if s not in ('XShape', 'Mean', 'Variance')]
        if cots:
            out_grad_map = {n: '' for n in case['outputs'].values()}
            for s in case['cot']:
                n = case['outputs'][s]
                arr = cots[n]
                g = n + '@GRAD'
                pkg.layers.data(g, shape=list(arr.shape),
                                dtype='bfloat16' if g in bf16 else 'float32',
                                append_batch_size=False)
                feed[g] = _bf16(arr) if g in bf16 else arr
                out_grad_map[n] = n + '@GRAD'
            in_grad_map = {n: n + '@GRAD' for n in case['diff']}
            for n in case['diff']:
                v = block.var(n)
                block.create_var(name=n + '@GRAD', shape=v.shape,
                                 dtype=v.dtype)
            grad_inputs = {s: list(v) for s, v in fwd_inputs.items()}
            for s, v in fwd_outputs.items():
                grad_inputs[s + '@OUT' if s in grad_inputs else s] = list(v)
            grad_inputs['Out@GRAD@ALL'] = [g for g in out_grad_map.values()
                                           if g]
            attrs = {k: v for k, v in op.attrs.items()
                     if not k.startswith('_')}
            attrs.update({
                '_fwd_inputs': fwd_inputs, '_fwd_outputs': fwd_outputs,
                '_out_grad_map': out_grad_map, '_in_grad_map': in_grad_map,
                '_fwd_op_uid': op.attrs['_op_uid'], '_fwd_seed': 0,
                'op_role': 1, 'op_role_var': []})
            block.append_op(type=case['type'] + '_grad', inputs=grad_inputs,
                            outputs={'IN@GRAD': list(in_grad_map.values())},
                            attrs=attrs, infer_shape=False)
            fetch += list(in_grad_map.values())
    return main, startup, feed, fetch


def _ulp_bf16(x):
    """One bf16 ulp at each element's magnitude (0 at 0)."""
    m, e = np.frexp(np.asarray(x, np.float64))
    return np.where(m == 0, 0.0, np.ldexp(1.0, e - 8))


def _one_bf16_ulp(feed, seed):
    """Every float feed moved by one bf16 ulp at its magnitude, up or down
    at random: a bf16 value lands on its neighbour, an f32 parameter on a
    value that rounds to the neighbour of its bf16 cast."""
    rng = np.random.RandomState(seed)
    return {n: (a + rng.choice([-1.0, 1.0], a.shape) * _ulp_bf16(a)).astype(
        a.dtype) if a.dtype.kind == 'f' else a for n, a in feed.items()}


def _as_numpy(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _amp_inputs(case, bf16):
    """The cotangents (from the port's forward), the full set of names fed
    as bf16 (the bf16 outputs' cotangents added), and the paddle_tpu
    program's feed and fetch names of an AMP case."""
    bf16 = set(bf16)
    cots, cot_bf16 = (_cotangents(case, bf16, amp=True) if case['diff']
                      else ({}, set()))
    bf16 |= {n + '@GRAD' for n in cot_bf16}
    return cots, bf16


def _jax_amp_reference(root):
    """paddle_tpu's side of the AMP cases, written to root/amp.npz (every
    fetch as f32, bf16 ones exactly) and root/amp.json (their dtypes).

    Run in a fresh interpreter (the amp_reference fixture) with XLA's
    excess precision off (--xla_allow_excess_precision=false), so that
    every bf16 op of the reference's jitted step rounds as written and as
    JAX runs it op by op. With it on, XLA:CPU drops the bf16 rounding of
    the products dy·x in pallas_bn._bwd's dk = sum((dy·x).astype(f32)):
    2.5 bf16 ulps of scale@GRAD's largest value at amp-batch_norm_offset
    (x ≈ 3, where dk and the mean's term m·db cancel).

    batch_norm goes through its TPU kernel's path (PTPU_PALLAS_BN=1:
    pallas_bn.fused_bn_apply, the Pallas kernel in interpret mode, whose
    backward `_bwd` sums dk and db in f32 as the port's BnApplyFunction
    does). Its default path on the CPU, y = x*k + b in plain JAX, sums
    the bf16 gradients of k and b with a bf16 accumulator (XLA:CPU's
    reduce_sum of a bf16 tensor): 2.3% of scale@GRAD's largest value at
    amp-batch_norm, 9 times what a one-bf16-ulp input perturbation moves
    it."""
    from jax.experimental import pallas as pl
    from paddle_tpu.ops import pallas_bn
    os.environ['PTPU_PALLAS_BN'] = '1'
    pallas_bn.supported = lambda x, layout: layout == 'NCHW' and x.ndim == 4
    pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    arrays, dtypes = {}, {}
    for case_id, (name, bf16) in sorted(AMP_CASES.items()):
        case = CASES[name]
        cots, bf16 = _amp_inputs(case, bf16)
        main, _, feed, fetch = _build(fluid, case, cots, bf16, amp=True)
        outs = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                                    fetch_list=fetch)
        dtypes[case_id] = []
        for j, o in enumerate(outs):
            o = np.asarray(o)
            dtypes[case_id].append(o.dtype.name)
            arrays['%s/%d' % (case_id, j)] = (
                o.astype(np.float32) if o.dtype.name == 'bfloat16' else o)
    np.savez(os.path.join(root, 'amp.npz'), **arrays)
    with open(os.path.join(root, 'amp.json'), 'w') as f:
        json.dump(dtypes, f)


@pytest.fixture(scope='module')
def amp_reference(tmp_path_factory):
    """{AMP case id: [(dtype name, array) of each fetch]} from paddle_tpu,
    computed by _jax_amp_reference in a fresh interpreter (this file run
    as a script, with the tests' environment and XLA's excess precision
    off)."""
    root = str(tmp_path_factory.mktemp('jax_amp_reference'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    env['XLA_FLAGS'] = ' '.join(
        f for f in (env.get('XLA_FLAGS'),
                    '--xla_allow_excess_precision=false') if f)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with open(os.path.join(root, 'amp.json')) as f:
        dtypes = json.load(f)
    with np.load(os.path.join(root, 'amp.npz')) as f:
        return {case_id: [(dt, f['%s/%d' % (case_id, j)])
                          for j, dt in enumerate(dts)]
                for case_id, dts in dtypes.items()}


def _check_amp(case, bf16, want):
    cots, bf16 = _amp_inputs(case, bf16)
    runs = []
    for move in (False, True):
        with ptt.scope_guard(ptt.Scope()):
            main, _, feed, fetch = _build(ptt, case, cots, bf16, amp=True)
            runs.append(ptt.Executor(ptt.CPUPlace()).run(
                main, feed=_one_bf16_ulp(feed, 5) if move else feed,
                fetch_list=fetch, return_numpy=False))
    assert len(want) == len(fetch)
    in_bf16 = bool(bf16) or case['type'] in ('mul', 'conv2d')
    for n, g, m, (dtype, w) in zip(fetch, runs[0], runs[1], want):
        if dtype in ('float32', 'bfloat16'):
            assert str(g.dtype)[6:] == dtype, (n, g.dtype, dtype)
        else:
            assert not g.dtype.is_floating_point, (n, g.dtype, dtype)
        g, m = _as_numpy(g), _as_numpy(m)
        assert g.shape == w.shape, (n, g.shape, w.shape)
        assert np.isfinite(g).all(), n
        if n == case['outputs'].get('Indices'):
            # ties: each index must pick a value equal to the reference's
            x = feed[case['inputs']['X'][0]]
            np.testing.assert_array_equal(
                np.take_along_axis(x, g, -1), np.take_along_axis(x, w, -1),
                err_msg=n)
        elif w.dtype.kind != 'f':
            np.testing.assert_array_equal(g, w, err_msg=n)
        elif in_bf16:
            top = float(np.abs(w).max())
            noise = float(np.abs(m - g).max())
            tol = min(AMP_ULPS * float(_ulp_bf16(top)), noise)
            err = float(np.abs(g - w).max())
            assert err <= tol, '%s: %r > %r (one-ulp noise %r, largest %r)' \
                % (n, err, tol, noise, top)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-6 * max(1.0, np.abs(w).max()),
                                       err_msg=n)


PARAMS = ([pytest.param(n, None, id=n) for n in sorted(CASES)]
          + [pytest.param(*AMP_CASES[a], id=a) for a in sorted(AMP_CASES)])


@pytest.mark.parametrize('name,bf16', PARAMS)
def test_op_and_grad_match_jax(name, bf16, request):
    case = CASES[name]
    if bf16 is not None:
        want = request.getfixturevalue('amp_reference')[
            request.node.callspec.id]
        _check_amp(case, bf16, want)
        return
    cots = _cotangents(case) if case['diff'] else {}
    main, _, feed, fetch = _build(fluid, case, cots)
    want = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                                fetch_list=fetch)
    with ptt.scope_guard(ptt.Scope()):
        main, _, feed, fetch = _build(ptt, case, cots)
        got = ptt.Executor(ptt.CPUPlace()).run(main, feed=feed,
                                               fetch_list=fetch)
    assert len(got) == len(want) == len(fetch)
    for n, g, w in zip(fetch, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, (n, g.shape, w.shape)
        assert np.isfinite(g).all(), n
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(w).max()),
                                   err_msg=n)


def test_generic_grad_without_cotangent_is_zero():
    """A grad op whose forward outputs have no gradient var yields zeros,
    as JAX's zero cotangent does."""
    x = _r(2, 3)
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()), ptt.unique_name.guard():
        block = main.global_block()
        ptt.layers.data('x', shape=[2, 3], append_batch_size=False,
                        stop_gradient=False)
        block.create_var(name='out', dtype='float32')
        block.create_var(name='x@GRAD', shape=(2, 3), dtype='float32')
        op = block.append_op(type='relu', inputs={'X': ['x']},
                             outputs={'Out': ['out']})
        block.append_op(
            type='relu_grad', inputs={'X': ['x'], 'Out': ['out'],
                                      'Out@GRAD@ALL': []},
            outputs={'IN@GRAD': ['x@GRAD']},
            attrs={'_fwd_inputs': {'X': ['x']}, '_fwd_outputs': {'Out': ['out']},
                   '_out_grad_map': {'out': ''},
                   '_in_grad_map': {'x': 'x@GRAD'},
                   '_fwd_op_uid': op.attrs['_op_uid'], '_fwd_seed': 0},
            infer_shape=False)
    g, = ptt.Executor(ptt.CPUPlace()).run(main, feed={'x': x},
                                          fetch_list=['x@GRAD'],
                                          scope=ptt.Scope())
    np.testing.assert_array_equal(g, np.zeros_like(x))


def test_grad_op_outputs_take_forward_shapes():
    """A `<type>_grad` op appended with shape inference gives each output
    var without a shape its forward var's shape and dtype, as
    paddle_tpu/core/registry.py:201 does."""
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()), ptt.unique_name.guard():
        block = main.global_block()
        x = ptt.layers.data('x', shape=[3, 5], dtype='float32')
        block.create_var(name='x@GRAD')
        block.create_var(name='y@GRAD', shape=(7,), dtype='float32')
        block.append_op(type='relu_grad', inputs={'X': ['x']},
                        outputs={'IN@GRAD': ['x@GRAD', 'y@GRAD']})
    assert block.var('x@GRAD').shape == x.shape == (-1, 3, 5)
    assert block.var('x@GRAD').dtype == 'float32'
    assert block.var('y@GRAD').shape == (7,)  # declared shapes stay


def test_sparse_and_lazy_branches_raise():
    case = _lookup_grad_case(_ids(2, 3), -1)
    case['attrs']['is_sparse'] = True
    cots = {'out': _r(2, 3, 4)}
    main, _, feed, fetch = _build(ptt, case, cots)
    with pytest.raises(NotImplementedError, match='SelectedRows'):
        ptt.Executor(ptt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                         scope=ptt.Scope())
    case = _adam_case()
    case['attrs']['lazy_mode'] = True
    main, _, feed, fetch = _build(ptt, case, {})
    with pytest.raises(NotImplementedError, match='lazy_mode'):
        ptt.Executor(ptt.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                         scope=ptt.Scope())


def test_grad_op_rng_follows_forward_op():
    """A grad op seeds its generator from its forward op's seed, else its
    forward op's uid, so a recomputed forward draws what the forward drew
    (paddle_tpu/core/lowering.py:60-70)."""
    from paddle_tpu_torch.core.lowering import Interpreter, OpCtx

    main = ptt.Program()
    block = main.global_block()
    interp = Interpreter(main, ptt.CPUPlace().device(), {})

    def draw(attrs):
        op = ptt.Operator(block, 'x_grad', attrs=attrs)
        return torch.rand(4, generator=OpCtx(interp, op, block).rng())

    fwd = ptt.Operator(block, 'x', attrs={})
    uid = fwd.attrs['_op_uid']
    assert torch.equal(draw({'_fwd_op_uid': uid, '_fwd_seed': 0}),
                       torch.rand(4, generator=OpCtx(interp, fwd,
                                                     block).rng()))
    seeded = ptt.Operator(block, 'x', attrs={'seed': 11})
    assert torch.equal(draw({'_fwd_op_uid': uid, '_fwd_seed': 11}),
                       torch.rand(4, generator=OpCtx(interp, seeded,
                                                     block).rng()))


if __name__ == '__main__':
    _jax_amp_reference(sys.argv[1])
