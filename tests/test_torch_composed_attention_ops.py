"""The ops of the composed attention branch and of dropout's exact cases,
each as a one-op program with its gradient op, in both packages on the
CPU: matmul (transposes, alpha, the 1-D squeeze), cast, the compare family,
and dropout at p=0, p=1 and with is_test (both implementations), where
its result does not depend on the random draw.

The cases run through tests/test_torch_training_ops.py's machinery: the
forward op over data vars and the `<type>_grad` op append_backward would
emit, the cotangents fed as `<out>@GRAD`. paddle_tpu's dropout_grad is its
generic grad (jax.vjp of the forward); the port's is the explicit
dropout_grad, which reads the forward's Mask.

Tolerances, as that file's: f32 within rtol 1e-5 (absolute floor 1e-6 of
the largest value), the same arithmetic summed in other orders; every
output's dtype the reference's (integers as any integer: paddle_tpu
carries int64 as int32). The `amp-*` cases run again with the program
marked `_amp_bf16` and the activations fed as bf16, as an AMP step hands
them to the op: dtypes exact, values within one bf16 ulp of each tensor's
largest value and never looser than a one-bf16-ulp move of the inputs
moves the port's result. paddle_tpu's AMP side runs in a fresh interpreter
with XLA's excess precision off, for the reason
tests/test_torch_training_ops.py's _jax_amp_reference gives.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as ptt

from test_torch_training_ops import (_amp_inputs, _as_numpy, _build,
                                     _case, _cotangents, _one_bf16_ulp, _r,
                                     _ulp_bf16)


def _ints(*shape, high=4, seed=0, dtype=np.int32):
    return np.random.RandomState(seed).randint(0, high, shape).astype(dtype)


def _matmul_case(x, y, **attrs):
    base = {'transpose_X': False, 'transpose_Y': False, 'alpha': 1.0}
    base.update(attrs)
    return _case('matmul', {'X': ('x', x), 'Y': ('y', y)}, {'Out': 'out'},
                 base, diff=['x', 'y'])


def _cmp_case(name, x, y):
    return _case(name, {'X': ('x', x), 'Y': ('y', y)}, {'Out': 'out'},
                 {'axis': -1})


def _dropout_case(p, impl, is_test):
    return _case('dropout', {'X': ('x', _r(3, 4, 5))},
                 {'Out': 'out', 'Mask': 'mask'},
                 {'dropout_prob': p, 'is_test': is_test, 'seed': 0,
                  'dropout_implementation': impl},
                 diff=['x'], cot=['Out'])


CASES = {
    'matmul_scores': _matmul_case(_r(2, 3, 4, 5), _r(2, 3, 6, 5, seed=1),
                                  transpose_Y=True, alpha=0.35),
    'matmul_context': _matmul_case(_r(2, 3, 4, 6), _r(2, 3, 6, 5, seed=2)),
    'matmul_transpose_x_alpha2': _matmul_case(
        _r(2, 5, 4), _r(2, 5, 3, seed=3), transpose_X=True, alpha=2.0),
    'matmul_vector_matrix': _matmul_case(_r(5), _r(5, 3, seed=4)),
    'matmul_matrix_vector': _matmul_case(_r(4, 5), _r(5, seed=5)),
    'cast_bool_to_float32': _case(
        'cast', {'X': ('x', _ints(6, 6, high=2).astype(bool))},
        {'Out': 'out'}, {'in_dtype': 'bool', 'out_dtype': 'float32'}),
    'cast_float32_to_int32': _case(
        'cast', {'X': ('x', 3.0 * _r(4, 5))}, {'Out': 'out'},
        {'in_dtype': 'float32', 'out_dtype': 'int32'}),
    'cast_int64_to_float32': _case(
        'cast', {'X': ('x', _ints(3, 4, high=50, dtype=np.int64))},
        {'Out': 'out'}, {'in_dtype': 'int64', 'out_dtype': 'float32'}),
    'cast_float32_grad': _case(
        'cast', {'X': ('x', _r(3, 4))}, {'Out': 'out'},
        {'in_dtype': 'float32', 'out_dtype': 'float32'}, diff=['x']),
    # the causal mask's compare: [1, S] against [S, 1], int32
    'greater_than_causal': _cmp_case(
        'greater_than', np.arange(6, dtype=np.int32).reshape(1, 6),
        np.arange(6, dtype=np.int32).reshape(6, 1)),
    'less_than_float': _cmp_case('less_than', _r(3, 4), _r(3, 4, seed=1)),
    'less_than_ties': _cmp_case('less_than', _ints(4, 5),
                                _ints(4, 5, seed=1)),
    'less_equal': _cmp_case('less_equal', _ints(4, 5), _ints(4, 5, seed=1)),
    'greater_equal': _cmp_case('greater_equal', _ints(4, 5),
                               _ints(4, 5, seed=1)),
    'equal': _cmp_case('equal', _ints(4, 5), _ints(4, 5, seed=1)),
    'not_equal': _cmp_case('not_equal', _ints(4, 5), _ints(4, 5, seed=1)),
    'dropout_p0_upscale': _dropout_case(0.0, 'upscale_in_train', False),
    'dropout_p0_downgrade': _dropout_case(0.0, 'downgrade_in_infer', False),
    'dropout_is_test_upscale': _dropout_case(0.3, 'upscale_in_train', True),
    'dropout_is_test_downgrade': _dropout_case(0.3, 'downgrade_in_infer',
                                               True),
    'dropout_p1_upscale': _dropout_case(1.0, 'upscale_in_train', False),
    'dropout_p1_downgrade': _dropout_case(1.0, 'downgrade_in_infer', False),
}

# {id: (case, inputs fed as bf16)}: the activations an AMP step hands the
# op are bf16 (q, k, v from the fc muls; the softmax restores bf16)
AMP_CASES = {
    'amp-matmul_scores': ('matmul_scores', ['x', 'y']),
    'amp-matmul_context': ('matmul_context', ['x', 'y']),
    'amp-matmul_transpose_x_alpha2': ('matmul_transpose_x_alpha2',
                                      ['x', 'y']),
    'amp-cast_bool_to_float32': ('cast_bool_to_float32', []),
    'amp-greater_than_causal': ('greater_than_causal', []),
    'amp-less_than_bf16': ('less_than_float', ['x', 'y']),
    'amp-dropout_p0_upscale': ('dropout_p0_upscale', ['x']),
    'amp-dropout_is_test_downgrade': ('dropout_is_test_downgrade', ['x']),
    'amp-dropout_p1_upscale': ('dropout_p1_upscale', ['x']),
}

_INTS = {'int32', 'int64'}


def _same_dtype(name, got, want):
    got = str(got)
    if got != want and not {got, want} <= _INTS:
        raise AssertionError('%s: dtype %s, the reference %s'
                             % (name, got, want))


def _jax_amp_reference(root):
    """paddle_tpu's side of the AMP cases, written to root/amp.npz (every
    fetch as f32, bf16 ones exactly) and root/amp.json (their dtypes)."""
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
    as a script, XLA's excess precision off)."""
    root = str(tmp_path_factory.mktemp('jax_amp_reference'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    env['XLA_FLAGS'] = ' '.join(
        f for f in (env.get('XLA_FLAGS'),
                    '--xla_allow_excess_precision=false') if f)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with open(os.path.join(root, 'amp.json')) as f:
        dtypes = json.load(f)
    with np.load(os.path.join(root, 'amp.npz')) as f:
        return {case_id: [(dt, f['%s/%d' % (case_id, j)])
                          for j, dt in enumerate(dts)]
                for case_id, dts in dtypes.items()}


@pytest.mark.parametrize('name', sorted(CASES))
def test_op_and_grad_match_jax_f32(name):
    case = CASES[name]
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
        _same_dtype(n, g.dtype, w.dtype.name)
        assert g.shape == w.shape, (n, g.shape, w.shape)
        if w.dtype.kind != 'f':
            np.testing.assert_array_equal(g, w, err_msg=n)
            continue
        assert np.isfinite(g).all(), n
        if case['type'] == 'dropout':  # no arithmetic but x·scale: exact
            np.testing.assert_array_equal(g, w, err_msg=n)
            continue
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(w).max()),
                                   err_msg=n)


@pytest.mark.parametrize('case_id', sorted(AMP_CASES))
def test_op_and_grad_match_jax_amp(case_id, amp_reference):
    name, bf16 = AMP_CASES[case_id]
    case = CASES[name]
    want = amp_reference[case_id]
    cots, bf16 = _amp_inputs(case, bf16)
    runs = []
    for move in (False, True):
        with ptt.scope_guard(ptt.Scope()):
            main, _, feed, fetch = _build(ptt, case, cots, bf16, amp=True)
            runs.append(ptt.Executor(ptt.CPUPlace()).run(
                main, feed=_one_bf16_ulp(feed, 5) if move else feed,
                fetch_list=fetch, return_numpy=False))
    assert len(want) == len(fetch)
    for n, g, m, (dtype, w) in zip(fetch, runs[0], runs[1], want):
        _same_dtype(n, str(g.dtype)[6:], dtype)
        g, m = _as_numpy(g), _as_numpy(m)
        assert g.shape == w.shape, (n, g.shape, w.shape)
        if w.dtype.kind != 'f':
            np.testing.assert_array_equal(g, w, err_msg=n)
            continue
        assert np.isfinite(g).all(), n
        top = float(np.abs(w).max())
        noise = float(np.abs(m - g).max())
        tol = min(float(_ulp_bf16(top)), noise) if bf16 else \
            1e-6 * max(1.0, top)
        err = float(np.abs(g - w).max())
        assert err <= tol, '%s: %r > %r (one-ulp noise %r, largest %r)' % (
            n, err, tol, noise, top)


def test_composed_causal_branch_builds_like_the_reference():
    """The causal composed branch (models/transformer.py with dropout):
    range, reshape, greater_than, cast, the -1e9 product and the mask add,
    the same ops in the same order in both packages."""
    from models import transformer as jax_tf
    from paddle_tpu_torch.models import transformer as ptt_tf

    def ops(pkg, mod):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()), \
                pkg.unique_name.guard():
            x = pkg.layers.data('x', shape=[8, 16], dtype='float32')
            mod.multi_head_attention(x, x, 2, 16, 8, 8, dropout=0.1,
                                     causal=True)
        return [(op.type, op.inputs, op.outputs)
                for op in main.global_block().ops]

    got, want = ops(ptt, ptt_tf), ops(fluid, jax_tf)
    assert got == want
    types = [t for t, _, _ in got]
    assert {'greater_than', 'cast', 'dropout', 'matmul', 'softmax'} <= \
        set(types)


if __name__ == '__main__':
    _jax_amp_reference(sys.argv[1])
