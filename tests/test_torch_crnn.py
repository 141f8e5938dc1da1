"""CRNN+CTC training as bench.py's OCR rows build it (models/crnn.py
build_crnn_train: a conv-bn-pool backbone, im2sequence, two stacked
bidirectional dynamic GRUs, warpctc over LoD labels with norm_by_times,
ctc_greedy_decoder and edit_distance, Adam), the port
(paddle_tpu_torch/models/crnn.py) held against paddle_tpu on the CPU.

(a) At bench.py's size (95 classes, 32x96 images, rnn_hidden 96), built
    and not run: the same ops in the same order (types, inputs and
    outputs), the same persistable names and parameter shapes.
(b) At a small size (20 classes, 32x32 images, so 6 columns a sequence,
    rnn_hidden 16, batch 4, labels of 2-4 tokens from a seed), 2 Adam
    steps from paddle_tpu's initial state, f32 and bf16 AMP
    (enable_bf16): each step's loss, every parameter gradient, and every
    parameter's update over the steps, within 4 times the one-ulp noise
    of both packages (the largest move of the tensor over NOISE_DRAWS
    runs from the parameters moved by one ulp at each element's
    magnitude: f32 ulps for the f32 program, bf16 ulps for bf16, as
    tests/test_torch_amp.py holds its programs), never below 1e-5 (f32)
    or 1e-6 (bf16) of the tensor's largest value; in f32 also the
    decoded tokens and the edit distances of every step exactly, and
    the decoded LoD equal to the logits'.
(c) run_steps(3) of the bf16 program with the label fed as a list of
    three LoDTensors of one LoD (bench.py's static form) equals three
    run() calls bit for bit, losses and every persistable.

paddle_tpu's side runs once, in a fresh interpreter (this file run as a
script), the bf16 program as tests/test_torch_training_ops.py's
_jax_amp_reference runs it and for its reasons (XLA's excess precision
off; batch_norm on its TPU kernel's path in interpret mode). The port
runs with one torch thread.
"""
import collections
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.lod import LoDArray
from paddle_tpu_torch.models import crnn as ptt_crnn

from test_torch_amp import (NOISE_DRAWS, _bf16_moved, _grad_names, _hold,
                            _noise, _Out, _params, _part)

FULL = dict(num_classes=95, img_h=32, img_w=96, rnn_hidden=96)
SMALL = dict(num_classes=20, img_h=32, img_w=32, rnn_hidden=16)
BATCH = 4
STEPS = 2
SEED = 9
K = 3  # run_steps' group


class _HostLoD(object):
    """A LoD feed both packages' Executors take: the reference's LoDTensor
    API (`lod()`, the data as an array)."""

    def __init__(self, data, lens):
        self._data = data
        self._lod = [[0] + list(np.cumsum(lens))]
        self.dtype = data.dtype

    def lod(self):
        return self._lod

    def __array__(self, dtype=None, copy=None):
        return self._data if dtype is None else self._data.astype(dtype)


def _feed(step, batch=BATCH, cfg=SMALL):
    rng = np.random.RandomState(100 + step)
    lens = rng.randint(2, 5, batch)
    toks = rng.randint(0, cfg['num_classes'], int(lens.sum()))
    return {'pixel': rng.randn(batch, 1, cfg['img_h'], cfg['img_w']).astype(
                np.float32),
            'label': _HostLoD(toks.reshape(-1, 1).astype(np.int32), lens)}


FEEDS = [_feed(i) for i in range(STEPS)]


def _build(pkg, mod, cfg, amp=False):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = SEED
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, loss, decoded, edit = mod.build_crnn_train(**cfg)
    if amp:
        pkg.contrib.mixed_precision.enable_bf16(main)
    return main, startup, loss, decoded, edit


def _f32_moved(arrays, seed, only):
    """Every float array of `only` moved by one f32 ulp at each element's
    magnitude, up or down at random."""
    rng = np.random.RandomState(seed)
    out = {}
    for n, a in sorted(arrays.items()):
        if a.dtype.kind != 'f' or n not in only:
            out[n] = a
            continue
        m, e = np.frexp(a.astype(np.float64))
        step = np.where(m == 0, 0.0, np.ldexp(1.0, e - 24))
        out[n] = (a + rng.choice([-1.0, 1.0], a.shape) * step).astype(a.dtype)
    return out


def _moved(prec):
    return _bf16_moved if prec == 'bf16' else _f32_moved


# -- paddle_tpu's side, in a fresh interpreter --------------------------------
def _jax_reference(root):
    import paddle_tpu as fluid
    from models import crnn as jax_crnn
    main = _build(fluid, jax_crnn, FULL)[0]
    with open(os.path.join(root, 'program.json'), 'w') as f:
        json.dump({'ops': [(op.type, op.inputs, op.outputs)
                           for op in main.global_block().ops],
                   'persistables': sorted(v.name for v in main.list_vars()
                                          if v.persistable),
                   'params': {p.name: list(p.shape)
                              for p in main.all_parameters()}}, f)
    from test_torch_amp import _jax_init, _jax_run
    for prec in ('f32', 'bf16'):
        if prec == 'bf16':
            _pallas_bn_in_interpret_mode()
        main, startup, loss, decoded, edit = _build(
            fluid, jax_crnn, SMALL, amp=prec == 'bf16')
        fetch = [loss.name] + _grad_names(main) + [decoded.name, edit.name]
        state = _jax_init(main, startup)
        exe = fluid.Executor(fluid.CPUPlace())
        out = _Out()
        for d in range(NOISE_DRAWS + 1):
            st = state if d == 0 else _moved(prec)(state, 100 + d,
                                                   _params(main))
            steps, final = _jax_run(main, st, FEEDS, fetch, exe)
            for i, outs in enumerate(steps):
                for n, o in zip(fetch, outs):
                    out.put('d%d/step%d/%s' % (d, i, n), o)
            for key, s in (('state', st), ('final', final)):
                for n, a in s.items():
                    out.put('d%d/%s/%s' % (d, key, n), a)
        out.save(root, prec)


def _pallas_bn_in_interpret_mode():
    from jax.experimental import pallas as pl
    from paddle_tpu.ops import pallas_bn
    os.environ['PTPU_PALLAS_BN'] = '1'
    pallas_bn.supported = lambda x, layout: layout == 'NCHW' and x.ndim == 4
    pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('jax_crnn'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.path.dirname(os.path.abspath(__file__)),
                    os.environ.get('PYTHONPATH')) if p))
    env['XLA_FLAGS'] = ' '.join(
        f for f in (env.get('XLA_FLAGS'),
                    '--xla_allow_excess_precision=false') if f)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    out = {}
    with open(os.path.join(root, 'program.json')) as f:
        out['program'] = json.load(f)
    for prec in ('f32', 'bf16'):
        with np.load(os.path.join(root, prec + '.npz')) as f:
            arrays = dict(f)
        with open(os.path.join(root, prec + '.json')) as f:
            out[prec] = (arrays, json.load(f))
    return out


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


# -- the port's side ----------------------------------------------------------
def _numpy(t):
    t = t.data if isinstance(t, LoDArray) else t
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _port_run(main, state, feeds, fetch):
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(state, main, scope)
    exe = ptt.Executor(ptt.CPUPlace())
    steps = [dict(zip(fetch, exe.run(main, feed=f, fetch_list=fetch,
                                     scope=scope, return_numpy=False)))
             for f in feeds]
    return steps, ptt.weights.state_to_numpy(main, scope)


def test_same_program_in_both_packages(jax_run):
    want = jax_run['program']
    main = _build(ptt, ptt_crnn, FULL)[0]
    ops = main.global_block().ops
    assert [op.type for op in ops] == [t for t, _, _ in want['ops']]
    for a, (t, ins, outs) in zip(ops, want['ops']):
        assert json.loads(json.dumps([a.inputs, a.outputs])) == [ins, outs], t
    assert sorted(v.name for v in main.list_vars() if v.persistable) == \
        want['persistables']
    assert {p.name: list(p.shape) for p in main.all_parameters()} == \
        want['params']
    types = collections.Counter(op.type for op in ops)
    assert (types['conv2d'], types['batch_norm'], types['pool2d'],
            types['im2sequence'], types['gru'], types['gru_grad'],
            types['warpctc'], types['ctc_greedy_decoder'],
            types['edit_distance']) == (8, 8, 4, 1, 4, 4, 1, 1, 1)
    assert types['adam'] == len(main.all_parameters())


@pytest.mark.parametrize('prec', ['f32', 'bf16'])
def test_crnn_steps_match_jax(prec, jax_run):
    arrays, dtypes = jax_run[prec]
    main, _, loss, decoded, edit = _build(ptt, ptt_crnn, SMALL,
                                          amp=prec == 'bf16')
    grads = _grad_names(main)
    fetch = [loss.name] + grads + [decoded.name, edit.name]
    state = _part(arrays, 'd0/state/')
    params = _params(main)
    port = []
    for d in range(NOISE_DRAWS + 1):
        st = state if d == 0 else _moved(prec)(state, 100 + d, params)
        steps, final = _port_run(main, st, FEEDS, fetch)
        if d == 0:
            logits = next(op.input('Input')[0] for op in
                          main.global_block().ops
                          if op.type == 'ctc_greedy_decoder')
            for s in steps:
                assert isinstance(s[decoded.name], LoDArray)
                assert s[decoded.name].dtype == torch.int64
            if prec == 'bf16':
                assert all(s[g].dtype == torch.float32
                           for s in steps for g in grads)
        port.append(([{n: _numpy(t) for n, t in s.items()} for s in steps],
                     st, final))
    floor = 1e-5 if prec == 'f32' else 1e-6
    worst = 0.0
    for i in range(STEPS):
        for n in [loss.name] + grads:
            want = arrays['d0/step%d/%s' % (i, n)]
            assert dtypes['d0/step%d/%s' % (i, n)] == 'float32', n
            assert n == loss.name or np.abs(want).max() > 0, n
            noise = _noise([arrays['d%d/step%d/%s' % (d, i, n)]
                            for d in range(NOISE_DRAWS + 1)]) + _noise(
                [port[d][0][i][n] for d in range(NOISE_DRAWS + 1)])
            noise = max(noise, floor * float(np.abs(want).max()) / 4)
            worst = max(worst, _hold('step %d %s' % (i, n),
                                     port[0][0][i][n], want, noise))
        if prec == 'f32':
            for n in (decoded.name, edit.name):
                np.testing.assert_array_equal(
                    port[0][0][i][n], arrays['d0/step%d/%s' % (i, n)],
                    err_msg='step %d %s' % (i, n))
    for n in sorted(params):
        def update(final, start):
            return final[n].astype(np.float64) - start[n]
        want = update(_part(arrays, 'd0/final/'), state)
        noise = _noise([update(_part(arrays, 'd%d/final/' % d),
                               _part(arrays, 'd%d/state/' % d))
                        for d in range(NOISE_DRAWS + 1)]) + _noise(
            [update(port[d][2], port[d][1]) for d in range(NOISE_DRAWS + 1)])
        noise = max(noise, floor * float(np.abs(want).max()) / 4)
        worst = max(worst, _hold('update of ' + n, update(port[0][2], state),
                                 want, noise))
    print('crnn %s: worst err/tolerance %.3f' % (prec, worst))
    losses = [float(s[loss.name][0]) for s in port[0][0]]
    assert all(np.isfinite(losses)), losses


def test_run_steps_equals_run_bit_for_bit():
    main, startup, loss, _, _ = _build(ptt, ptt_crnn, SMALL, amp=True)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    persist = [v.name for v in main.list_vars() if v.persistable]
    start = {n: scope.get(n).clone() for n in persist
             if scope.get(n) is not None}
    feed = _feed(0)
    lbl = ptt.create_lod_tensor(np.asarray(feed['label']),
                                [list(np.diff(feed['label'].lod()[0]))])

    def fresh():
        sc = ptt.Scope()
        for n, t in start.items():
            sc.set(n, t.clone())
        return sc, ptt.Executor(ptt.CPUPlace())
    sc_a, exe_a = fresh()
    runs = [exe_a.run(main, feed={'pixel': feed['pixel'], 'label': lbl},
                      fetch_list=[loss], scope=sc_a, return_numpy=False)[0]
            for _ in range(K)]
    sc_b, exe_b = fresh()
    stacked, = exe_b.run_steps(
        main, feed={'pixel': np.stack([feed['pixel']] * K),
                    'label': [lbl] * K},
        fetch_list=[loss], steps=K, scope=sc_b, fetch_policy='stack',
        return_numpy=False)
    assert torch.equal(stacked.reshape(-1), torch.cat(runs).reshape(-1))
    differ = [n for n in start if not torch.equal(sc_a.get(n), sc_b.get(n))]
    assert not differ, differ[:5]
    assert sum(not torch.equal(sc_a.get(n), start[n]) for n in start) > 0


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
