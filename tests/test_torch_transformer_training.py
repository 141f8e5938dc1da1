"""The slice as a whole: Transformer NMT training as bench.py's
bench_transformer builds it (models/transformer.py build_transformer_train:
post-LN encoder-decoder, sinusoid position encoding, the in-graph causal
mask, Adam(0.9, 0.997, 1e-9) on 2·noam_decay(d_model, 4000)), at 2+2
layers, d_model 64, 4 heads, d_ff 128, S=16, vocab 97, batch 2, 3 steps,
built by both packages under a fresh unique_name.guard(), the port
started from paddle_tpu's state (weights.py, the step counter included).

Two programs: bench_transformer's default dropout 0.1 (a dropout op after
each embedding, on every attention's weights and on every residual
branch; every attention on the composed branch, the decoder's
self-attention adding the causal mask) and its ablation dropout 0 (every
attention one fused_multihead_attention op, the decoder's self-attention
causal: the port's K2 in its plain version on the CPU).

The two packages' generators differ, so at dropout 0.1 the port draws
paddle_tpu's masks (ops/tensor_ops.py draw_dropout_keep replaced, as
tests/test_torch_bert_dropout.py does). Then, for each program:

- both packages build the same ops in the same order, with the same
  inputs and outputs and the same persistable names;
- f32: per-step losses within rtol 1e-5; the first step's gradients
  within 1e-5 of each tensor's largest value; parameters after the steps
  within 1e-2 of steps·(the largest rate); the fetched learning rate
  equal to paddle_tpu's (rtol 1e-6) and to 2·d_model^-0.5·min(t^-0.5,
  t·4000^-1.5) at t = 1, 2, 3;
- bf16 AMP (enable_bf16): every loss, gradient, learning rate and
  parameter update within 4 times the one-bf16-ulp noise of both packages
  (tests/test_torch_amp.py's rule and helpers).

paddle_tpu's side runs once, in a fresh interpreter (this file run as a
script) with XLA's excess precision off, as tests/test_torch_amp.py's
does and for its reasons.
"""
import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from models import transformer as jax_transformer

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import transformer as ptt_transformer

from test_torch_amp import (NOISE_DRAWS, _check_steps, _grad_names,
                            _jax_init, _jax_run, _jax_steps, _Out)
from test_torch_bert_dropout import _inject, _masks, _part

CFG = dict(src_vocab=97, trg_vocab=97, max_len=16, d_model=64, d_ff=128,
           n_head=4, n_layer=2)
BATCH = 2
STEPS = 3
SEED = 13
DROPOUTS = (0.1, 0.0)


def _feed(seed):
    rng = np.random.RandomState(seed)
    s, v = CFG['max_len'], CFG['trg_vocab']
    return {n: rng.randint(1, v, (BATCH, s)).astype(np.int64)
            for n in ('src_ids', 'trg_ids', 'lbl_ids')}


FEEDS = [_feed(i) for i in range(STEPS)]


def _noam(t):
    d = CFG['d_model']
    return 2.0 * d ** -0.5 * min(t ** -0.5, t * 4000 ** -1.5)


def _build(pkg, mod, dropout, amp=False):
    """Returns (main, startup, loss, learning-rate var name)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = SEED
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, loss, _ = mod.build_transformer_train(dropout=dropout, **CFG)
    if amp:
        pkg.contrib.mixed_precision.enable_bf16(main)
    lr = next(op for op in main.global_block().ops
              if op.type == 'adam').input('LearningRate')[0]
    return main, startup, loss, lr


def _tag(dropout, prec):
    return 'p%g_%s' % (dropout, prec)


def _jax_reference(root):
    """paddle_tpu's side: program.json (ops and persistables of each
    program) and, for each program, f32 and bf16 .npz/.json in
    tests/test_torch_amp.py's layout, each step's fetches holding the loss,
    every gradient, every dropout Mask and the learning rate."""
    programs = {}
    for dropout in DROPOUTS:
        main, startup, loss, lr = _build(fluid, jax_transformer, dropout)
        programs[str(dropout)] = {
            'ops': [(op.type, op.inputs, op.outputs)
                    for op in main.global_block().ops],
            'persistables': sorted(v.name for v in main.list_vars()
                                   if v.persistable)}
        out = _Out()
        fetch = [loss.name, lr] + _grad_names(main) + _masks(main)
        state = _jax_init(main, startup)
        steps, final = _jax_run(main, state, FEEDS, fetch)
        for i, outs in enumerate(steps):
            for n, o in zip(fetch, outs):
                out.put('d0/step%d/%s' % (i, n), o)
        for key, st in (('state', state), ('final', final)):
            for n, a in st.items():
                out.put('d0/%s/%s' % (key, n), a)
        out.save(root, _tag(dropout, 'f32'))
        out = _Out()
        main, startup, loss, lr = _build(fluid, jax_transformer, dropout,
                                         amp=True)
        _jax_steps(out, main, startup, FEEDS,
                   [loss.name, lr] + _grad_names(main) + _masks(main))
        out.save(root, _tag(dropout, 'bf16'))
    with open(os.path.join(root, 'program.json'), 'w') as f:
        json.dump(programs, f)


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('jax_transformer_training'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    env['XLA_FLAGS'] = ' '.join(
        f for f in (env.get('XLA_FLAGS'),
                    '--xla_allow_excess_precision=false') if f)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    out = {}
    with open(os.path.join(root, 'program.json')) as f:
        out['program'] = json.load(f)
    for dropout in DROPOUTS:
        for prec in ('f32', 'bf16'):
            name = _tag(dropout, prec)
            with np.load(os.path.join(root, name + '.npz')) as f:
                arrays = dict(f)
            with open(os.path.join(root, name + '.json')) as f:
                out[name] = (arrays, json.load(f))
    return out


def _reference_masks(arrays, names, draw=0):
    return {(i, n): arrays['d%d/step%d/%s' % (draw, i, n)]
            for i in range(STEPS) for n in names}


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


@pytest.mark.parametrize('dropout', DROPOUTS)
def test_same_program_in_both_packages(dropout, jax_run):
    main, _, _, _ = _build(ptt, ptt_transformer, dropout)
    want = jax_run['program'][str(dropout)]
    assert [op.type for op in main.global_block().ops] == \
        [t for t, _, _ in want['ops']]
    for a, (t, ins, outs) in zip(main.global_block().ops, want['ops']):
        assert json.loads(json.dumps([a.inputs, a.outputs])) == [ins, outs], t
    assert sorted(v.name for v in main.list_vars() if v.persistable) == \
        want['persistables']
    types = collections.Counter(op.type for op in main.global_block().ops)
    n = CFG['n_layer']
    attn = 3 * n  # n encoder self-, n decoder self- and n cross-attentions
    assert types['increment'] == types['elementwise_pow'] == \
        types['elementwise_min'] == 1
    assert types['add_position_encoding'] == 2
    if dropout:
        # the embeddings', the attention weights' and the residual
        # branches' (2 an encoder layer, 3 a decoder layer)
        assert types['dropout'] == types['dropout_grad'] == 2 + attn + 5 * n
        assert types['matmul'] == 2 * attn and types['softmax'] == attn
        assert types['fused_multihead_attention'] == 0
    else:
        assert types['dropout'] == types['matmul'] == 0
        fused = [op for op in main.global_block().ops
                 if op.type == 'fused_multihead_attention']
        assert len(fused) == attn
        assert sum(op.attrs['causal'] for op in fused) == n


@pytest.mark.parametrize('dropout', DROPOUTS)
def test_training_steps_match_jax_f32(dropout, jax_run, monkeypatch):
    arrays, _ = jax_run[_tag(dropout, 'f32')]
    main, _, loss, lr = _build(ptt, ptt_transformer, dropout)
    names = _masks(main)
    asked = []
    if dropout:
        masks = _reference_masks(arrays, names)
        kept = np.mean([float((m != 0).mean()) for m in masks.values()])
        assert abs(kept - 0.9) < 0.02, kept  # paddle_tpu drew real masks
        asked = _inject(monkeypatch, masks)
    fetch = [loss.name, lr] + _grad_names(main)
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(_part(arrays, 'd0/state/'), main, scope)
    assert scope.get('@LR_DECAY_COUNTER@').tolist() == [0]
    exe = ptt.Executor(ptt.CPUPlace())
    steps = [dict(zip(fetch, exe.run(main, feed=f, fetch_list=fetch,
                                     scope=scope))) for f in FEEDS]
    assert sorted(asked) == sorted((i, n) for i in range(STEPS)
                                   for n in names)
    np.testing.assert_allclose(
        [float(s[loss.name][0]) for s in steps],
        [float(arrays['d0/step%d/%s' % (i, loss.name)][0])
         for i in range(STEPS)], rtol=1e-5)
    rates = [float(s[lr][0]) for s in steps]
    np.testing.assert_allclose(
        rates, [float(arrays['d0/step%d/%s' % (i, lr)][0])
                for i in range(STEPS)], rtol=1e-6)
    np.testing.assert_allclose(rates, [_noam(t) for t in
                                       range(1, STEPS + 1)], rtol=1e-6)
    for n in fetch[2:]:
        w = arrays['d0/step0/' + n]
        np.testing.assert_allclose(steps[0][n], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)
    final = ptt.weights.state_to_numpy(main, scope)
    want = _part(arrays, 'd0/final/')
    assert sorted(final) == sorted(want)
    assert final['@LR_DECAY_COUNTER@'].tolist() == [STEPS]
    for n in want:
        if want[n].dtype.kind in 'iu':
            np.testing.assert_array_equal(final[n], want[n], err_msg=n)
        else:
            np.testing.assert_allclose(final[n], want[n], rtol=0,
                                       atol=1e-2 * STEPS * max(rates),
                                       err_msg=n)


@pytest.mark.parametrize('dropout', DROPOUTS)
def test_training_steps_match_jax_bf16(dropout, jax_run, monkeypatch):
    arrays, dtypes = jax_run[_tag(dropout, 'bf16')]
    main, _, loss, lr = _build(ptt, ptt_transformer, dropout, amp=True)
    names = _masks(main)
    asked = []
    if dropout:
        masks = _reference_masks(arrays, names)
        for d in range(1, NOISE_DRAWS + 1):  # the same masks in every draw
            for key, m in _reference_masks(arrays, names, d).items():
                np.testing.assert_array_equal(m, masks[key])
        asked = _inject(monkeypatch, masks)
    port, worst = _check_steps(jax_run[_tag(dropout, 'bf16')], main, FEEDS,
                               [loss.name, lr] + _grad_names(main))
    assert worst <= 1.0
    assert len(asked) == (NOISE_DRAWS + 1) * STEPS * len(names)
    np.testing.assert_allclose([float(s[lr][0]) for s in port[0][0]],
                               [_noam(t) for t in range(1, STEPS + 1)],
                               rtol=1e-6)


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
