"""Each op of the serving slices as a one-op Program in both packages.

The same numpy inputs (fed as data vars) go through paddle_tpu's Executor
and paddle_tpu_torch's Executor on the CPU. The outputs agree at rtol 1e-5
(f32; the two frameworks sum in different orders; integer outputs and NaN
rows must match exactly), and the build-time shapes inferred for a -1
batch dim (JAX eval_shape vs torch meta tensors) are equal.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as ptt


def _r(*shape, seed=0, low=None):
    rng = np.random.RandomState(seed + sum(shape))
    if low is not None:
        return rng.uniform(low, low + 1.0, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _bn_case(is_test):
    c = 3
    return dict(
        type='batch_norm',
        inputs={'X': ('x', _r(2, c, 5, 5)), 'Scale': ('scale', _r(c, seed=1)),
                'Bias': ('bias', _r(c, seed=2)),
                'Mean': ('mean', _r(c, seed=3)),
                'Variance': ('variance', _r(c, seed=4, low=0.5))},
        outputs={'Y': 'y', 'MeanOut': 'mean', 'VarianceOut': 'variance',
                 'SavedMean': 'saved_mean', 'SavedVariance': 'saved_var'},
        attrs={'momentum': 0.9, 'epsilon': 1e-5, 'is_test': is_test,
               'data_layout': 'NCHW', 'use_global_stats': False})


def _pool_case(x, **attrs):
    full = {'pooling_type': 'max', 'ksize': [3, 3], 'global_pooling': False,
            'strides': [1, 1], 'paddings': [0, 0], 'ceil_mode': False,
            'exclusive': True}
    full.update(attrs)
    return dict(type='pool2d', inputs={'X': ('x', x)},
                outputs={'Out': 'out'}, attrs=full)


def _ids(*shape, high=10, seed=0):
    return np.random.RandomState(seed).randint(0, high, shape).astype(np.int64)


def _lookup_case(ids, padding_idx=-1):
    return dict(type='lookup_table',
                inputs={'Ids': ('ids', ids), 'W': ('w', _r(10, 4, seed=8))},
                outputs={'Out': 'out'},
                attrs={'is_sparse': False, 'is_distributed': False,
                       'padding_idx': padding_idx})


def _layer_norm_case(shape, axis, affine=True):
    inputs = {'X': ('x', _r(*shape))}
    if affine:
        n = int(np.prod(shape[axis:]))
        inputs['Scale'] = ('scale', _r(n, seed=9))
        inputs['Bias'] = ('bias', _r(n, seed=10))
    return dict(type='layer_norm', inputs=inputs,
                outputs={'Y': 'y', 'Mean': 'mean', 'Variance': 'variance'},
                attrs={'epsilon': 1e-5, 'begin_norm_axis': axis})


def _reshape2_case(x, shape):
    return dict(type='reshape2', inputs={'X': ('x', x)},
                outputs={'Out': 'out', 'XShape': 'xshape'},
                attrs={'shape': shape})


CASES = {
    'conv2d_stride_pad': dict(
        type='conv2d',
        inputs={'Input': ('x', _r(2, 3, 9, 9)), 'Filter': ('w', _r(4, 3, 3, 3))},
        outputs={'Output': 'out'},
        attrs={'strides': [2, 2], 'paddings': [1, 1], 'dilations': [1, 1],
               'groups': 1}),
    'conv2d_groups_dilation': dict(
        type='conv2d',
        inputs={'Input': ('x', _r(2, 4, 8, 8)), 'Filter': ('w', _r(6, 2, 3, 3))},
        outputs={'Output': 'out'},
        attrs={'strides': [1, 1], 'paddings': [2, 2], 'dilations': [2, 2],
               'groups': 2}),
    'batch_norm_is_test': _bn_case(True),
    'batch_norm_batch_stats': _bn_case(False),
    'pool2d_max': _pool_case(_r(2, 3, 9, 9), strides=[2, 2], paddings=[1, 1]),
    'pool2d_avg_exclusive': _pool_case(_r(2, 3, 9, 9), pooling_type='avg',
                                       strides=[2, 2], paddings=[1, 1]),
    'pool2d_avg_inclusive': _pool_case(_r(2, 3, 9, 9), pooling_type='avg',
                                       strides=[2, 2], paddings=[1, 1],
                                       exclusive=False),
    'pool2d_global_avg': _pool_case(_r(2, 3, 7, 7), pooling_type='avg',
                                    global_pooling=True),
    'pool2d_ceil_max': _pool_case(_r(2, 3, 8, 8), strides=[2, 2],
                                  ceil_mode=True),
    'pool2d_ceil_avg_exclusive': _pool_case(_r(2, 3, 8, 8), pooling_type='avg',
                                            strides=[2, 2], paddings=[1, 1],
                                            ceil_mode=True),
    'mul_flatten_4d': dict(
        type='mul', inputs={'X': ('x', _r(2, 3, 2, 2)), 'Y': ('w', _r(12, 5))},
        outputs={'Out': 'out'}, attrs={'x_num_col_dims': 1, 'y_num_col_dims': 1}),
    'mul_x_num_col_dims_2': dict(
        type='mul', inputs={'X': ('x', _r(2, 3, 4)), 'Y': ('w', _r(4, 5))},
        outputs={'Out': 'out'}, attrs={'x_num_col_dims': 2, 'y_num_col_dims': 1}),
    'elementwise_add_axis1': dict(
        type='elementwise_add',
        inputs={'X': ('x', _r(2, 3, 4, 4)), 'Y': ('y', _r(3, seed=5))},
        outputs={'Out': 'out'}, attrs={'axis': 1}),
    'elementwise_add_trailing': dict(
        type='elementwise_add',
        inputs={'X': ('x', _r(2, 3, 4)), 'Y': ('y', _r(4, seed=6))},
        outputs={'Out': 'out'}, attrs={'axis': -1}),
    'elementwise_add_same_shape': dict(
        type='elementwise_add',
        inputs={'X': ('x', _r(2, 3, 4)), 'Y': ('y', _r(2, 3, 4, seed=7))},
        outputs={'Out': 'out'}, attrs={'axis': -1}),
    'relu': dict(type='relu', inputs={'X': ('x', _r(2, 3, 5))},
                 outputs={'Out': 'out'}, attrs={}),
    'range_int64': dict(type='range', inputs={}, outputs={'Out': 'out'},
                        attrs={'start': 2, 'end': 17, 'step': 3,
                               'dtype': 'int64'}),
    'range_float32': dict(type='range', inputs={}, outputs={'Out': 'out'},
                          attrs={'start': 0, 'end': 5, 'step': 1,
                                 'dtype': 'float32'}),
    'reshape2_minus1': _reshape2_case(_r(2, 3, 4), [-1, 12]),
    'reshape2_copy_dim0': _reshape2_case(_r(2, 3, 4), [0, 4, 3]),
    'reshape2_split_heads': _reshape2_case(_r(2, 5, 8), [-1, 5, 2, 4]),
    'transpose2': dict(type='transpose2', inputs={'X': ('x', _r(2, 5, 2, 4))},
                       outputs={'Out': 'out', 'XShape': 'xshape'},
                       attrs={'axis': [0, 2, 1, 3]}),
    'lookup_table_2d_ids': _lookup_case(_ids(2, 6)),
    'lookup_table_trailing1_squeeze': _lookup_case(_ids(5, 1, seed=1)),
    'lookup_table_padding_idx': _lookup_case(
        np.array([[1, 3, 3], [0, 3, 9]], np.int64), padding_idx=3),
    'lookup_table_negative_and_out_of_range_ids': _lookup_case(
        np.array([[-1, -10, 10], [-11, 4, 25]], np.int64)),
    'layer_norm_axis2': _layer_norm_case((2, 3, 8), 2),
    'layer_norm_axis1': _layer_norm_case((2, 3, 8), 1),
    'layer_norm_no_affine': _layer_norm_case((3, 16), 1, affine=False),
    'fill_constant': dict(type='fill_constant', inputs={},
                          outputs={'Out': 'out'},
                          attrs={'shape': [2, 3], 'dtype': 'float32',
                                 'value': 1.5}),
}


def _build_and_run(pkg, case, exe):
    """One-op program: slot 'X'/'Input' is a data var with a -1 batch dim,
    every other input a fixed-shape data var. Returns (inferred output
    shapes, fetched outputs)."""
    main, startup = pkg.Program(), pkg.Program()
    feed = {}
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        block = main.global_block()
        for slot, (name, arr) in case['inputs'].items():
            batched = slot in ('X', 'Input', 'Ids')
            shape = list(arr.shape[1:]) if batched else list(arr.shape)
            pkg.layers.data(name, shape=shape, dtype=str(arr.dtype),
                            append_batch_size=batched)
            feed[name] = arr
        out_names = []
        for name in case['outputs'].values():
            if not block.has_var(name):
                block.create_var(name=name, dtype='float32')
            out_names.append(name)
        block.append_op(type=case['type'],
                        inputs={s: [n] for s, (n, _) in case['inputs'].items()},
                        outputs={s: [n] for s, n in case['outputs'].items()},
                        attrs=dict(case['attrs']))
        shapes = [block.var(n).shape for n in out_names]
    outs = exe.run(main, feed=feed, fetch_list=out_names)
    return shapes, outs


@pytest.mark.parametrize('name', sorted(CASES))
def test_op_matches_jax(name):
    case = CASES[name]
    j_shapes, j_outs = _build_and_run(fluid, case,
                                      fluid.Executor(fluid.CPUPlace()))
    with ptt.scope_guard(ptt.Scope()):
        t_shapes, t_outs = _build_and_run(ptt, case,
                                          ptt.Executor(ptt.CPUPlace()))
    assert t_shapes == j_shapes
    for t, j in zip(t_outs, j_outs):
        assert t.shape == np.shape(j)
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-5)


def test_random_init_ops_seeded_per_op():
    """uniform_random / gaussian_random draw from a torch.Generator seeded
    by the program's random_seed, the op uid and the Executor's step of the
    program: the same program draws the same numbers on each Executor's
    first run and other numbers on its next run (as the reference's step
    key does), two ops draw different ones, and the numbers follow the
    requested distribution."""
    startup = ptt.Program()
    startup.random_seed = 7
    block = startup.global_block()
    for name, typ, attrs in (
            ('u0', 'uniform_random', {'min': -0.5, 'max': 2.0}),
            ('u1', 'uniform_random', {'min': -0.5, 'max': 2.0}),
            ('g0', 'gaussian_random', {'mean': 1.0, 'std': 3.0})):
        block.create_var(name=name, shape=[100, 100], dtype='float32',
                         persistable=True)
        block.append_op(type=typ, outputs={'Out': [name]},
                        attrs=dict(attrs, shape=[100, 100], dtype='float32',
                                   seed=0), infer_shape=False)
    exe = ptt.Executor(ptt.CPUPlace())
    u0, u1, g0 = exe.run(startup, fetch_list=['u0', 'u1', 'g0'],
                         scope=ptt.Scope())
    again, = ptt.Executor(ptt.CPUPlace()).run(
        startup, fetch_list=['u0'], scope=ptt.Scope())
    np.testing.assert_array_equal(u0, again)
    next_step, = exe.run(startup, fetch_list=['u0'], scope=ptt.Scope())
    assert not np.array_equal(u0, next_step)
    assert not np.array_equal(u0, u1)
    assert u0.min() >= -0.5 and u0.max() < 2.0
    assert abs(u0.mean() - 0.75) < 0.05
    assert abs(g0.mean() - 1.0) < 0.1 and abs(g0.std() - 3.0) < 0.1
