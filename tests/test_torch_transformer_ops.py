"""The ops that Transformer NMT training adds to the port (the LR
schedules', the gradient clips' and regularizers', layers/ops.py's unary
ops, add_position_encoding, increment and select), each as a one-op
program with its generic gradient op, in both packages on the CPU.

The cases are built with tests/test_torch_training_ops.py's helpers: the
forward op over data vars and, where it has inputs to differentiate, the
`<type>_grad` op that append_backward would emit, the output cotangents
fed as `<out>@GRAD` data vars. The same numpy inputs and cotangents go to
both packages, and the forward outputs and the gradients are compared.

- f32: rtol 1e-5 with an absolute floor of 1e-6 of the largest value
  compared (test_torch_training_ops.py's rule). Integer outputs compare
  by value (paddle_tpu carries int64 as int32).
- bf16 (the `amp-*` cases): the program marked `_amp_bf16` in both
  packages and the float inputs fed as bf16, as a bf16 activation reaches
  the op in an AMP step. Every output and gradient has the reference's
  dtype exactly, and its values lie within one bf16 ulp of its largest
  value and within what a one-bf16-ulp perturbation of every float input
  moves it in the port (test_torch_training_ops.py's _check_amp).

paddle_tpu's side of every case runs once, in a fresh interpreter (this
file run as a script) with XLA's excess precision off, as
tests/test_torch_bert_dropout.py's does and for its reasons.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as ptt

from test_torch_training_ops import (_amp_inputs, _build, _case,
                                     _check_amp, _cotangents, _r)


def _pos(*shape, seed=0):
    """Values in [0.5, 2.5): away from the poles of sqrt's and
    reciprocal's gradients and from pow's base 0."""
    return 0.5 + 2.0 * np.random.RandomState(seed).rand(*shape).astype(
        np.float32)


def _ties(*shape, seed=0):
    """Halves in [-2, 2]: ties with each other and with the bounds and
    thresholds of clip, min, max and the shrinks."""
    return (np.random.RandomState(seed).randint(-4, 5, shape) / 2.0).astype(
        np.float32)


def _unary(type, x, **attrs):
    return _case(type, {'X': ('x', x)}, {'Out': 'out'}, attrs, diff=['x'])


def _binary(type, x, y, axis=-1):
    return _case(type, {'X': ('x', x), 'Y': ('y', y)}, {'Out': 'out'},
                 {'axis': axis}, diff=['x', 'y'])


CASES = {
    'elementwise_sub': _binary('elementwise_sub', _r(2, 3, 4),
                               _r(3, 4, seed=1)),
    'elementwise_sub_axis1': _binary('elementwise_sub', _r(2, 3, 4),
                                     _r(3, seed=2), axis=1),
    'elementwise_min': _binary('elementwise_min', _r(2, 5), _r(2, 5, seed=3)),
    'elementwise_min_ties': _binary('elementwise_min', _ties(3, 4),
                                    _ties(3, 4, seed=4)),
    'elementwise_max': _binary('elementwise_max', _r(2, 5), _r(2, 5, seed=5)),
    'elementwise_max_ties_broadcast': _binary(
        'elementwise_max', _ties(3, 4, seed=6), _ties(4, seed=7)),
    'elementwise_pow': _binary('elementwise_pow', _pos(3, 4),
                               _r(3, 4, seed=8)),
    'elementwise_pow_scalar_exponent': _binary(
        'elementwise_pow', _pos(1, seed=9), np.array([-0.5], np.float32)),
    'scale': _case('scale', {'X': ('x', _r(3, 4))}, {'Out': 'out'},
                   {'scale': 0.37, 'bias': 1.25, 'bias_after_scale': True},
                   diff=['x']),
    'scale_bias_first': _case(
        'scale', {'X': ('x', _r(3, 4, seed=1))}, {'Out': 'out'},
        {'scale': -2.5, 'bias': 0.3, 'bias_after_scale': False},
        diff=['x']),
    'clip': _unary('clip', _r(4, 5), min=-0.7, max=0.9),
    'clip_ties': _unary('clip', _ties(4, 5, seed=1), min=-1.0, max=0.5),
    'clip_by_norm_clips': _unary('clip_by_norm', _r(4, 5), max_norm=1.5),
    'clip_by_norm_keeps': _unary('clip_by_norm', _r(4, 5), max_norm=100.0),
    'squared_l2_norm': _unary('squared_l2_norm', _r(3, 7)),
    'global_norm_scale_clips': _case(
        'global_norm_scale', {'Norm': ('norm', np.array(3.5, np.float32))},
        {'Out': 'out'}, {'clip_norm': 1.25}),
    'global_norm_scale_keeps': _case(
        'global_norm_scale', {'Norm': ('norm', np.array(0.5, np.float32))},
        {'Out': 'out'}, {'clip_norm': 1.25}),
    'sign': _unary('sign', _ties(3, 5)),
    'sigmoid': _unary('sigmoid', _r(3, 5)),
    'logsigmoid': _unary('logsigmoid', 3 * _r(3, 5)),
    'exp': _unary('exp', _r(3, 5)),
    'tanh': _unary('tanh', _r(3, 5)),
    'tanh_shrink': _unary('tanh_shrink', _r(3, 5)),
    'softshrink': _unary('softshrink', _r(4, 5), **{'lambda': 0.5}),
    'softshrink_ties': _unary('softshrink', _ties(4, 5), **{'lambda': 0.5}),
    'sqrt': _unary('sqrt', _pos(3, 5)),
    'abs': _unary('abs', _ties(3, 5)),
    'ceil': _unary('ceil', 2 * _r(3, 5)),
    'floor': _unary('floor', 2 * _r(3, 5)),
    'cos': _unary('cos', 2 * _r(3, 5)),
    'sin': _unary('sin', 2 * _r(3, 5)),
    'round': _unary('round', _ties(3, 5) + 0.25 * _ties(3, 5, seed=1)),
    'reciprocal': _unary('reciprocal', _pos(3, 5)),
    'square': _unary('square', _r(3, 5)),
    'softplus': _unary('softplus', 4 * _r(3, 5)),
    'softsign': _unary('softsign', 2 * _r(3, 5)),
    'hard_shrink': _unary('hard_shrink', _ties(4, 5), threshold=0.5),
    'thresholded_relu': _unary('thresholded_relu', _ties(4, 5),
                               threshold=1.0),
    'cum_sum': _unary('cum_sum', _r(3, 4, 5), axis=1, exclusive=False,
                      reverse=False),
    'cum_sum_exclusive_reverse': _unary('cum_sum', _r(3, 4, 5), axis=-1,
                                        exclusive=True, reverse=True),
    'cum_sum_flatten': _unary('cum_sum', _r(3, 4), axis=0, flatten=True),
    'increment_int64_counter': _case(
        'increment', {'X': ('x', np.array([6], np.int64))}, {'Out': 'out'},
        {'step': 1.0}),
    'increment_float': _case(
        'increment', {'X': ('x', np.array([2.5], np.float32))},
        {'Out': 'out'}, {'step': 0.75}),
    'select': _case(
        'select', {'Cond': ('cond', np.array([[True], [False], [True]])),
                   'X': ('x', _r(3, 4)), 'Y': ('y', _r(3, 4, seed=1))},
        {'Out': 'out'}, diff=['x', 'y']),
    'select_lr_step': _case(
        'select', {'Cond': ('cond', np.array([False])),
                   'X': ('x', np.array([0.1], np.float32)),
                   'Y': ('y', np.array([0.01], np.float32))},
        {'Out': 'out'}),
    'add_position_encoding': _case(
        'add_position_encoding', {'X': ('x', _r(2, 16, 64))},
        {'Out': 'out'}, {'alpha': 1.0, 'beta': 1.0}, diff=['x']),
    'add_position_encoding_scaled': _case(
        'add_position_encoding', {'X': ('x', _r(3, 5, 12, seed=1))},
        {'Out': 'out'}, {'alpha': 0.5, 'beta': 2.0}, diff=['x']),
}

# The AMP cases: {id: (case, inputs fed as bf16)}: every case whose input
# can be a bf16 activation, fed as one.
AMP_CASES = {'amp-' + n: (n, [name for items in c['inputs'].values()
                              for name, arr in (items if isinstance(
                                  items, list) else [items])
                              if arr.dtype == np.float32])
             for n, c in CASES.items()
             if not n.startswith(('increment', 'global_norm_scale'))}


def _jax_reference(root):
    """paddle_tpu's side of every case, written to root/ops.npz (every
    fetch as f32 where it is bf16, exactly) and root/ops.json (its
    dtypes)."""
    arrays, dtypes = {}, {}
    runs = [(n, CASES[n], None) for n in sorted(CASES)] + [
        (a, CASES[AMP_CASES[a][0]], AMP_CASES[a][1]) for a in sorted(
            AMP_CASES)]
    for case_id, case, bf16 in runs:
        if bf16 is None:
            cots = _cotangents(case) if case['diff'] else {}
            main, _, feed, fetch = _build(fluid, case, cots)
        else:
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
    np.savez(os.path.join(root, 'ops.npz'), **arrays)
    with open(os.path.join(root, 'ops.json'), 'w') as f:
        json.dump(dtypes, f)


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
    """{case id: [(dtype name, array) of each fetch]} from paddle_tpu,
    computed by _jax_reference in a fresh interpreter."""
    root = str(tmp_path_factory.mktemp('jax_transformer_ops'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.path.join(repo, 'tests'),
                    os.environ.get('PYTHONPATH')) if p))
    env['XLA_FLAGS'] = ' '.join(
        f for f in (env.get('XLA_FLAGS'),
                    '--xla_allow_excess_precision=false') if f)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with open(os.path.join(root, 'ops.json')) as f:
        dtypes = json.load(f)
    with np.load(os.path.join(root, 'ops.npz')) as f:
        return {case_id: [(dt, f['%s/%d' % (case_id, j)])
                          for j, dt in enumerate(dts)]
                for case_id, dts in dtypes.items()}


PARAMS = ([pytest.param(n, None, id=n) for n in sorted(CASES)]
          + [pytest.param(*AMP_CASES[a], id=a) for a in sorted(AMP_CASES)])


@pytest.mark.parametrize('name,bf16', PARAMS)
def test_op_and_grad_match_jax(name, bf16, request, reference):
    case = CASES[name]
    want = reference[request.node.callspec.id]
    if bf16 is not None:
        _check_amp(case, bf16, want)
        return
    cots = _cotangents(case) if case['diff'] else {}
    with ptt.scope_guard(ptt.Scope()):
        main, _, feed, fetch = _build(ptt, case, cots)
        got = ptt.Executor(ptt.CPUPlace()).run(main, feed=feed,
                                               fetch_list=fetch)
    assert len(got) == len(want) == len(fetch)
    for n, g, (dtype, w) in zip(fetch, got, want):
        assert g.shape == w.shape, (n, g.shape, w.shape)
        if w.dtype.kind in 'iub':
            assert g.dtype.kind == w.dtype.kind, (n, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=n)
            continue
        assert g.dtype == np.float32 and dtype == 'float32', (n, g.dtype,
                                                              dtype)
        assert np.isfinite(g).all(), n
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(w).max()),
                                   err_msg=n)


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
