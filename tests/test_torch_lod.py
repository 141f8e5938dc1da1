"""LoD tensors and the LoD ops of the CRNN slice in the port
(paddle_tpu_torch/core/lod.py, lod_tensor.py, the interpreter's LoD modes,
ops/rnn_ops.py gru and lstm, ops/sequence_ops.py im2sequence,
ops/decode_ops.py warpctc, ctc_greedy_decoder, ctc_align and
edit_distance), held against paddle_tpu on the CPU on the same numpy
inputs.

The ops: each case calls the op's registered lowering in both packages on
LoD inputs made from a seed (sequences of unequal lengths unless a case
says otherwise, so that padding, masking and unpadding are exercised) and
compares every output, and for the differentiable ones the gradients of
sum(output * cotangent) with respect to every float input (jax.vjp of
paddle_tpu's lowering; torch.autograd of the port's). Tolerance: f32 on
both sides, the same arithmetic in other orders: within 2e-5 of each
tensor's largest value (absolute), or exact for integer outputs and the
edit distances (normalized ones within one f32 ulp of the largest: XLA
divides by a reciprocal). The bf16 GRU case (a bf16 input, f32 weights, as under
AMP) holds each output's dtype exactly and its values within 2 bf16 ulps
of the tensor's largest value.

The modes: one program built by both packages (a LoD feed through fc
('pass'), dynamic_gru ('aware'), concat ('pass'), squared_l2_norm
('none') and mean, with SGD) runs one step in each: every fetched
value's LoD (or its absence) equals paddle_tpu's, the values and the
gradients (through the aware op's generic grad) within the f32 tolerance
above; run_steps over two LoD feeds of one LoD (a list of LoDTensors,
and the stacked form) equals two run() calls bit for bit in the port,
and paddle_tpu's run_steps within the f32 tolerance.

paddle_tpu's side runs once, in a fresh interpreter (this file run as a
script, with the tests' environment); the port's with one torch thread.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import registry as ptt_registry
from paddle_tpu_torch.core.lod import LoDArray

F32_TOL = 2e-5


def _rng(seed):
    return np.random.RandomState(seed)


def _offsets(lens):
    return [0] + list(np.cumsum(lens))


def _gru_case(seed, lens, d, reverse=False, origin=False, h0=False):
    rng = _rng(seed)
    t = int(sum(lens))
    ins = {'Input': (rng.randn(t, 3 * d).astype(np.float32), lens),
           'Weight': rng.randn(d, 3 * d).astype(np.float32) * 0.5,
           'Bias': rng.randn(1, 3 * d).astype(np.float32) * 0.1}
    if h0:
        ins['H0'] = rng.randn(len(lens), d).astype(np.float32)
    return dict(op='gru', ins=ins, outs=['Hidden', 'BatchGate',
                                         'BatchResetHiddenPrev'],
                attrs={'is_reverse': reverse, 'origin_mode': origin,
                       'gate_activation': 'sigmoid', 'activation': 'tanh'})


def _lstm_case(seed, lens, d, reverse=False, peep=True):
    rng = _rng(seed)
    t = int(sum(lens))
    ins = {'Input': (rng.randn(t, 4 * d).astype(np.float32), lens),
           'Weight': rng.randn(d, 4 * d).astype(np.float32) * 0.5,
           'Bias': rng.randn(1, (7 if peep else 4) * d).astype(np.float32)
           * 0.1}
    return dict(op='lstm', ins=ins, outs=['Hidden', 'Cell', 'BatchGate'],
                attrs={'use_peepholes': peep, 'is_reverse': reverse,
                       'gate_activation': 'sigmoid',
                       'cell_activation': 'tanh',
                       'candidate_activation': 'tanh'})


def _ctc_case(seed, blank, norm):
    rng = _rng(seed)
    lg_lens, lb_lens, k = [5, 3, 7], [2, 1, 3], 6
    labels = rng.randint(0, k - 1, int(sum(lb_lens)))
    labels = np.where(labels >= blank, labels + 1, labels)  # never blank
    labels[1] = labels[0]  # a repeat inside the first label
    ins = {'Logits': (rng.randn(sum(lg_lens), k).astype(np.float32) * 2,
                      lg_lens),
           'Label': (labels.reshape(-1, 1).astype(np.int32), lb_lens)}
    return dict(op='warpctc', ins=ins, outs=['Loss'],
                attrs={'blank': blank, 'norm_by_times': norm})


def _decoder_case(seed, blank):
    rng = _rng(seed)
    lens, k = [6, 1, 4, 7], 5
    x = rng.randn(sum(lens), k).astype(np.float32)
    x[1] = x[0]  # a repeated frame
    x[2, blank] = 10.0  # a blank frame between two frames
    return dict(op='ctc_greedy_decoder', ins={'Input': (x, lens)},
                outs=['Output'], attrs={'blank': blank})


def _align_case(seed):
    rng = _rng(seed)
    lens = [5, 3, 6]
    toks = rng.randint(0, 3, (sum(lens), 1)).astype(np.int64)
    return dict(op='ctc_align', ins={'Input': (toks, lens)},
                outs=['Output'], attrs={'blank': 0, 'merge_repeated': True})


def _edit_case(seed, normalized, ignored=(), padded=True):
    rng = _rng(seed)
    h_lens, r_lens = [4, 6, 1, 5], [3, 6, 2, 4]
    hyps = rng.randint(0, 4, (sum(h_lens), 1)).astype(np.int64)
    if padded:  # -1 after the kept tokens, as the greedy decoder leaves them
        o = _offsets(h_lens)
        for i in range(len(h_lens)):
            keep = rng.randint(0, h_lens[i] + 1)
            hyps[o[i] + keep:o[i + 1]] = -1
    refs = rng.randint(0, 4, (sum(r_lens), 1)).astype(np.int64)
    return dict(op='edit_distance',
                ins={'Hyps': (hyps, h_lens), 'Refs': (refs, r_lens)},
                outs=['Out', 'SequenceNum'],
                attrs={'normalized': normalized,
                       'ignored_tokens': list(ignored)})


def _im2seq_case(seed, shape, kernels, strides, paddings):
    x = _rng(seed).randn(*shape).astype(np.float32)
    return dict(op='im2sequence', ins={'X': x}, outs=['Out'],
                attrs={'kernels': kernels, 'strides': strides,
                       'paddings': paddings})


CASES = {
    'gru': _gru_case(1, [3, 1, 4], 4),
    'gru-reverse': _gru_case(2, [3, 1, 4], 4, reverse=True),
    'gru-origin': _gru_case(3, [2, 5], 4, origin=True),
    'gru-origin-reverse-h0': _gru_case(4, [4, 2, 3], 3, reverse=True,
                                       origin=True, h0=True),
    'gru-uniform': _gru_case(5, [4, 4, 4], 4),
    'gru-uniform-reverse': _gru_case(6, [4, 4, 4], 4, reverse=True),
    'lstm': _lstm_case(7, [3, 1, 4], 3),
    'lstm-reverse': _lstm_case(8, [2, 5, 3], 3, reverse=True),
    'lstm-no-peepholes': _lstm_case(9, [3, 3], 2, peep=False),
    'lstm-no-peepholes-reverse': _lstm_case(10, [1, 4], 2, reverse=True,
                                            peep=False),
    'warpctc-blank0': _ctc_case(11, 0, False),
    'warpctc-blank0-norm': _ctc_case(12, 0, True),
    'warpctc-blank5': _ctc_case(13, 5, False),
    'warpctc-blank5-norm': _ctc_case(14, 5, True),
    'ctc_greedy_decoder-blank0': _decoder_case(15, 0),
    'ctc_greedy_decoder-blank4': _decoder_case(16, 4),
    'ctc_align': _align_case(17),
    'edit_distance': _edit_case(18, False),
    'edit_distance-normalized': _edit_case(19, True),
    'edit_distance-ignored': _edit_case(20, True, ignored=(1,)),
    'edit_distance-unpadded': _edit_case(21, False, padded=False),
    'im2sequence': _im2seq_case(22, (2, 3, 5, 4), [2, 2], [1, 1],
                                [0, 0, 0, 0]),
    'im2sequence-full-height': _im2seq_case(23, (2, 4, 3, 6), [3, 1],
                                            [1, 1], [0, 0, 0, 0]),
    'im2sequence-stride-pad': _im2seq_case(24, (1, 2, 5, 5), [2, 3],
                                           [2, 1], [1, 0, 1, 2]),
}
NO_GRAD = ('ctc_greedy_decoder', 'ctc_align', 'edit_distance')


def _cotangent(case_id, slot, shape):
    seed = sum(map(ord, case_id + slot))
    return _rng(seed).randn(*shape).astype(np.float32)


class _Ctx(object):
    def __init__(self, attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _float_inputs(case):
    return [s for s, v in sorted(case['ins'].items())
            if (v[0] if isinstance(v, tuple) else v).dtype.kind == 'f']


# -- paddle_tpu's side, in a fresh interpreter --------------------------------
def _jax_op(case_id, case, arrays, dtypes):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core import registry
    from paddle_tpu.core.lod import LoDArray as JLoD, unwrap
    lower = registry.get(case['op']).lower
    ctx = _Ctx(case['attrs'])
    diff = [] if case['op'] in NO_GRAD else _float_inputs(case)

    def build(vals):
        ins = {}
        for slot, v in case['ins'].items():
            data = vals.get(slot)
            if isinstance(v, tuple):
                data = jnp.asarray(v[0]) if data is None else data
                ins[slot] = [JLoD(data, [_offsets(v[1])])]
            else:
                ins[slot] = [jnp.asarray(v) if data is None else data]
        return ins

    def fwd(*diff_vals):
        outs = lower(ctx, build(dict(zip(diff, diff_vals))))
        return [unwrap(outs[s][0]) for s in case['outs']]

    primal = [jnp.asarray(case['ins'][s][0] if isinstance(
        case['ins'][s], tuple) else case['ins'][s]) for s in diff]
    # jitted: one compile a case, not one an op (the offsets are static)
    outs = jax.jit(lambda: lower(ctx, build({})))()
    for s in case['outs']:
        o = outs[s][0]
        arrays['%s/%s' % (case_id, s)] = np.asarray(unwrap(o))
        lod = [list(map(int, l)) for l in o.lod] if isinstance(o, JLoD) \
            else None
        dtypes['%s/%s' % (case_id, s)] = lod
    if diff:
        cots = [jnp.asarray(_cotangent(case_id, s, y.shape)).astype(y.dtype)
                for s, y in zip(case['outs'], _out_shapes(fwd, primal))]
        grads = jax.jit(lambda p, c: jax.vjp(fwd, *p)[1](c))(primal, cots)
        for s, g in zip(diff, grads):
            arrays['%s/grad/%s' % (case_id, s)] = np.asarray(g)


def _out_shapes(fwd, primal):
    import jax
    return jax.eval_shape(fwd, *primal)


def _jax_bf16_gru(arrays, dtypes):
    """The bf16 GRU case: a bf16 input against f32 weights and bias."""
    import jax.numpy as jnp
    from paddle_tpu.core import registry
    from paddle_tpu.core.lod import LoDArray as JLoD
    case = CASES['gru']
    x, lens = case['ins']['Input']
    outs = registry.get('gru').lower(_Ctx(case['attrs']), {
        'Input': [JLoD(jnp.asarray(x).astype(jnp.bfloat16),
                       [_offsets(lens)])],
        'Weight': [jnp.asarray(case['ins']['Weight'])],
        'Bias': [jnp.asarray(case['ins']['Bias'])]})
    for s in case['outs']:
        o = np.asarray(outs[s][0].data)
        dtypes['bf16-gru/%s' % s] = o.dtype.name
        arrays['bf16-gru/%s' % s] = o.astype(np.float32)


def _mode_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data('x', shape=[3], dtype='float32', lod_level=1)
        h = pkg.layers.fc(x, size=6)
        g = pkg.layers.dynamic_gru(h, size=2)
        c = pkg.layers.concat([g, g], axis=1)
        block = main.global_block()
        sq = block.create_var(name='sq', dtype='float32')
        block.append_op(type='squared_l2_norm', inputs={'X': [c]},
                        outputs={'Out': [sq]})
        loss = pkg.layers.mean(c)
        pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
    fetch = [h.name, g.name, c.name, 'sq', loss.name, 'fc_0.w_0@GRAD',
             'gru_0.w_0@GRAD']
    return main, startup, fetch


MODE_LENS = [[2, 4, 1], [3, 3, 1], [2, 4, 1]]  # steps 0 and 2 share a LoD


def _mode_feed(step):
    lens = MODE_LENS[step]
    x = _rng(40 + step).randn(sum(lens), 3).astype(np.float32)
    return x, lens


def _jax_modes(arrays, dtypes):
    import paddle_tpu as fluid
    main, startup, fetch = _mode_program(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        state = {v.name: np.array(scope.find_var(v.name).get_tensor())
                 for v in main.list_vars() if v.persistable}
        x, lens = _mode_feed(0)
        outs = exe.run(main, feed={'x': fluid.create_lod_tensor(x, [lens])},
                       fetch_list=fetch, return_numpy=False)
    from paddle_tpu.core.lod import LoDArray as JLoD, unwrap
    for n, o in zip(fetch, outs):
        arrays['modes/' + n] = np.asarray(unwrap(o))
        dtypes['modes/' + n] = ([list(map(int, l)) for l in o.lod]
                                if isinstance(o, JLoD) else None)
    for n, a in state.items():
        arrays['modes-state/' + n] = a
    # paddle_tpu's run_steps over steps 0 and 2 (one LoD: the static form)
    x0, l0 = _mode_feed(0)
    x2, _ = _mode_feed(2)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        for n, a in state.items():
            scope.var(n).get_tensor().set(a)
        lods = [fluid.create_lod_tensor(a, [l0]) for a in (x0, x2)]
        loss, = exe.run_steps(main, feed={'x': lods}, fetch_list=[fetch[4]],
                              fetch_policy='stack')
        arrays['modes-run_steps/loss'] = np.asarray(loss)
        arrays['modes-run_steps/fc_0.w_0'] = np.array(
            scope.find_var('fc_0.w_0').get_tensor())


def _jax_reference(root):
    arrays, dtypes = {}, {}
    for case_id, case in sorted(CASES.items()):
        _jax_op(case_id, case, arrays, dtypes)
    _jax_bf16_gru(arrays, dtypes)
    _jax_modes(arrays, dtypes)
    np.savez(os.path.join(root, 'lod.npz'), **arrays)
    with open(os.path.join(root, 'lod.json'), 'w') as f:
        json.dump(dtypes, f)


@pytest.fixture(scope='module')
def jax_ref(tmp_path_factory):
    """(arrays, {key: lod or dtype}) from paddle_tpu, computed by
    _jax_reference in a fresh interpreter (this file run as a script)."""
    root = str(tmp_path_factory.mktemp('jax_lod'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with np.load(os.path.join(root, 'lod.npz')) as f:
        arrays = dict(f)
    with open(os.path.join(root, 'lod.json')) as f:
        return arrays, json.load(f)


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


# -- the port's side ----------------------------------------------------------
def _close(got, want, what, tol=F32_TOL):
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in 'iub':
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-6),
                               err_msg=what)


def _port_op(case_id, case):
    lower = ptt_registry.get(case['op']).lower
    diff = [] if case['op'] in NO_GRAD else _float_inputs(case)
    leaves = {}
    ins = {}
    for slot, v in case['ins'].items():
        a, lens = v if isinstance(v, tuple) else (v, None)
        t = torch.from_numpy(a.copy())
        if slot in diff:
            t.requires_grad_()
            leaves[slot] = t
        ins[slot] = [LoDArray(t, [_offsets(lens)]) if lens else t]
    with torch.enable_grad():
        outs = lower(_Ctx(case['attrs']), ins)
        vals = [outs[s][0] for s in case['outs']]
        grads = {}
        if diff:
            ys = [v.data if isinstance(v, LoDArray) else v for v in vals]
            gs = torch.autograd.grad(
                ys, [leaves[s] for s in diff],
                [torch.from_numpy(_cotangent(case_id, s, tuple(y.shape)))
                 .to(y.dtype) for s, y in zip(case['outs'], ys)])
            grads = dict(zip(diff, gs))
    return vals, grads


@pytest.mark.parametrize('case_id', sorted(CASES))
def test_op_matches_the_reference(case_id, jax_ref):
    arrays, lods = jax_ref
    case = CASES[case_id]
    vals, grads = _port_op(case_id, case)
    for s, v in zip(case['outs'], vals):
        key = '%s/%s' % (case_id, s)
        want_lod = lods[key]
        if want_lod is None:
            assert not isinstance(v, LoDArray), key
        else:
            assert isinstance(v, LoDArray), key
            assert [list(l) for l in v.lod] == want_lod, key
        data = v.data if isinstance(v, LoDArray) else v
        tol = F32_TOL
        if case['op'] == 'edit_distance':
            # exact; normalized within one ulp (XLA divides by a reciprocal)
            tol = 2.0 ** -23 if case['attrs']['normalized'] else 0.0
        _close(data.detach().numpy(), arrays[key], key, tol=tol)
    for s, g in grads.items():
        key = '%s/grad/%s' % (case_id, s)
        assert np.abs(arrays[key]).max() > 0, key
        _close(g.numpy(), arrays[key], key)


def test_gru_under_bf16_keeps_the_carry_dtype(jax_ref):
    """A bf16 input against f32 weights (AMP's operands): the hidden state
    stays bf16, the gates come out f32, as in the reference; values within
    2 bf16 ulps of each tensor's largest value."""
    arrays, dtypes = jax_ref
    case = CASES['gru']
    x, lens = case['ins']['Input']
    outs = ptt_registry.get('gru').lower(_Ctx(case['attrs']), {
        'Input': [LoDArray(torch.from_numpy(x).bfloat16(),
                           [_offsets(lens)])],
        'Weight': [torch.from_numpy(case['ins']['Weight'])],
        'Bias': [torch.from_numpy(case['ins']['Bias'])]})
    for s in case['outs']:
        key = 'bf16-gru/%s' % s
        got = outs[s][0].data
        assert str(got.dtype)[6:] == dtypes[key], (key, got.dtype)
        _close(got.float().numpy(), arrays[key], key, tol=2 * 2.0 ** -8)
    assert dtypes['bf16-gru/Hidden'] == 'bfloat16'


def _port_state(arrays, main):
    scope = ptt.Scope()
    state = {k[len('modes-state/'):]: a for k, a in arrays.items()
             if k.startswith('modes-state/')}
    ptt.weights.params_from_numpy(state, main, scope)
    return scope


def test_lod_modes_in_a_program(jax_ref):
    arrays, lods = jax_ref
    main, _, fetch = _mode_program(ptt)
    types = [op.type for op in main.global_block().ops]
    assert 'gru_grad' in types and 'mul_grad' in types
    exe = ptt.Executor(ptt.CPUPlace())
    x, lens = _mode_feed(0)
    outs = exe.run(main, feed={'x': ptt.create_lod_tensor(x, [lens])},
                   fetch_list=fetch, scope=_port_state(arrays, main),
                   return_numpy=False)
    for n, o in zip(fetch, outs):
        want_lod = lods['modes/' + n]
        if want_lod is None:
            assert not isinstance(o, LoDArray), n
            data = o
        else:
            assert isinstance(o, LoDArray) and \
                [list(l) for l in o.lod] == want_lod, (n, o)
            data = o.data
        _close(data.numpy(), arrays['modes/' + n], n)
    # the fetched fc output is the LoD value (pass), the mean is dense
    assert lods['modes/' + fetch[0]] == [_offsets(lens)]
    assert lods['modes/sq'] is None


def test_run_steps_with_lod_feeds(jax_ref):
    """run_steps over LoD feeds, as a list and in the stacked static form,
    equals run() step by step bit for bit, and paddle_tpu's run_steps."""
    arrays, _ = jax_ref
    main, _, fetch = _mode_program(ptt)
    x0, l0 = _mode_feed(0)
    x2, _ = _mode_feed(2)
    exe = ptt.Executor(ptt.CPUPlace())
    feeds = [ptt.create_lod_tensor(a, [l0]) for a in (x0, x2)]
    scope = _port_state(arrays, main)
    runs = [exe.run(main, feed={'x': f}, fetch_list=[fetch[4]],
                    scope=scope)[0] for f in feeds]
    w_run = scope.get('fc_0.w_0').clone()
    results = []
    # a list of LoDTensors, and the stacked form: data [K, rows, ...]
    # under the LoD the steps share
    for feed in (feeds, LoDArray(torch.from_numpy(np.stack([x0, x2])),
                                 feeds[0].lod)):
        scope = _port_state(arrays, main)
        loss, = ptt.Executor(ptt.CPUPlace()).run_steps(
            main, feed={'x': feed}, fetch_list=[fetch[4]],
            fetch_policy='stack', scope=scope)
        assert torch.equal(scope.get('fc_0.w_0'), w_run)
        np.testing.assert_array_equal(loss.reshape(-1),
                                      np.concatenate(runs).reshape(-1))
        results.append(loss)
    _close(results[0], arrays['modes-run_steps/loss'], 'run_steps loss')
    _close(w_run.numpy(), arrays['modes-run_steps/fc_0.w_0'],
           'run_steps fc_0.w_0')


def test_lod_tensor_surface():
    t = ptt.create_lod_tensor(np.arange(12).reshape(6, 2), [[2, 4]])
    assert isinstance(t, ptt.LoDTensor)
    assert t.lod == ((0, 2, 6),) and t.recursive_sequence_lengths() == [[2, 4]]
    assert t.data.dtype == torch.int64 and tuple(t.shape) == (6, 2)
    from_list = ptt.create_lod_tensor([np.ones((2, 3)), np.zeros((1, 3))],
                                      [[2, 1]])
    assert from_list.lod == ((0, 2, 3),)
    np.random.seed(0)
    r = ptt.create_random_int_lodtensor([[2, 3]], [1], ptt.CPUPlace(), 0, 9)
    assert r.lod == ((0, 2, 5),) and int(r.data.max()) <= 9
    with pytest.raises(NotImplementedError, match='item 8'):
        ptt.create_lod_tensor(np.ones((3, 1)), [[3]], traced=True)
    with pytest.raises(NotImplementedError, match='item 8'):
        ptt.create_lod_tensor(np.ones((3, 1)), [[3]], bucket_rows=8)
    with pytest.raises(ValueError, match='rows'):
        ptt.create_lod_tensor(np.ones((3, 1)), [[2]])
    with pytest.raises(TypeError, match='LoD'):
        ptt_registry.get('gru').lower(_Ctx({}), {
            'Input': [torch.ones(3, 6)], 'Weight': [torch.ones(2, 6)],
            'Bias': [torch.ones(1, 6)]})


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
