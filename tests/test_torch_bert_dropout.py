"""The slice as a whole: BERT pretraining as bench.py's bench_bert builds
it, with its default dropout 0.1 (a dropout op after the embeddings' layer
norm, on every attention's weights and on every residual branch; the
attention on the composed branch), at 2 layers, d_model 64, 4 heads,
S=128, vocab 97, batch 2, 3 Adam steps, f32 and bf16 AMP, built by both
packages under a fresh unique_name.guard(), the port started from
paddle_tpu's state (weights.py).

The two packages' generators give different streams, so the port draws
paddle_tpu's masks: the test replaces the port's mask-drawing function
(ops/tensor_ops.py draw_dropout_keep) with one that returns, for each
dropout op and step, the Mask paddle_tpu drew there, fetched from its run
by the Mask variables' names. Then:

- the programs have the same ops in the same order, the same inputs and
  outputs, and the same persistable names;
- f32: per-step losses within rtol 1e-5; the first step's gradients
  within 1e-5 of each tensor's largest value; parameters after the steps
  within 1e-2 of steps·lr (tests/test_torch_bert_training.py's rules);
- bf16: every loss, gradient and parameter update within 4 times the
  one-bf16-ulp noise of both packages (tests/test_torch_amp.py's rule;
  paddle_tpu draws the same masks in each noise draw).

Gradient merge with dropout is held within the port: a k=2 step's loss
and merged gradients equal the mean of two k=1 steps on the batch's
halves, each half fed the masks its microbatch drew. (paddle_tpu's
microbatch masks live inside its lax.scan and cannot be fetched.)

paddle_tpu's side runs once, in a fresh interpreter (this file run as a
script) with XLA's excess precision off, as tests/test_torch_amp.py's
does and for its reasons.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from models import bert as jax_bert

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import bert as ptt_bert
from paddle_tpu_torch.ops import tensor_ops

from test_torch_amp import (NOISE_DRAWS, _check_steps, _grad_names,
                            _jax_init, _jax_run, _jax_steps, _Out)

CFG = dict(vocab=97, max_len=128, d_model=64, d_ff=128, n_head=4, n_layer=2,
           dropout=0.1, lr=1e-4)
SEED = 11
STEPS = 3
N_DROPOUT = 1 + 3 * CFG['n_layer']


def _feed(seed, batch=2):
    rng = np.random.RandomState(seed)
    s, v = CFG['max_len'], CFG['vocab']
    return {'tok_ids': rng.randint(0, v, (batch, s)).astype(np.int64),
            'seg_ids': rng.randint(0, 2, (batch, s)).astype(np.int64),
            'mlm_labels': rng.randint(0, v, (batch, s)).astype(np.int64),
            'mlm_weights': (rng.rand(batch, s) < 0.15).astype(np.float32)}


FEEDS = [_feed(i) for i in range(STEPS)]


def _build(pkg, bert_mod, amp=False, k=1):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = SEED
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, loss = bert_mod.build_bert_pretrain(**CFG)
    if amp:
        pkg.contrib.mixed_precision.enable_bf16(main)
    if k > 1:
        pkg.contrib.gradient_merge.enable(k, main)
    return main, startup, loss


def _masks(main):
    return [op.output('Mask')[0] for op in main.global_block().ops
            if op.type == 'dropout']


def _jax_reference(root):
    """paddle_tpu's side: program.json (ops, persistable names); f32 and
    bf16 .npz/.json in tests/test_torch_amp.py's layout, each step's
    fetches holding the loss, every gradient and every dropout Mask."""
    main, startup, loss = _build(fluid, jax_bert)
    with open(os.path.join(root, 'program.json'), 'w') as f:
        json.dump({'ops': [(op.type, op.inputs, op.outputs)
                           for op in main.global_block().ops],
                   'persistables': sorted(v.name for v in main.list_vars()
                                          if v.persistable)}, f)
    out = _Out()
    fetch = [loss.name] + _grad_names(main) + _masks(main)
    state = _jax_init(main, startup)
    steps, final = _jax_run(main, state, FEEDS, fetch)
    for i, outs in enumerate(steps):
        for n, o in zip(fetch, outs):
            out.put('d0/step%d/%s' % (i, n), o)
    for key, st in (('state', state), ('final', final)):
        for n, a in st.items():
            out.put('d0/%s/%s' % (key, n), a)
    out.save(root, 'f32')
    out = _Out()
    main, startup, loss = _build(fluid, jax_bert, amp=True)
    _jax_steps(out, main, startup, FEEDS,
               [loss.name] + _grad_names(main) + _masks(main))
    out.save(root, 'bf16')


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('jax_bert_dropout'))
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
    out = {}
    with open(os.path.join(root, 'program.json')) as f:
        out['program'] = json.load(f)
    for name in ('f32', 'bf16'):
        with np.load(os.path.join(root, name + '.npz')) as f:
            arrays = dict(f)
        with open(os.path.join(root, name + '.json')) as f:
            out[name] = (arrays, json.load(f))
    return out


def _part(arrays, prefix):
    return {k[len(prefix):]: a for k, a in arrays.items()
            if k.startswith(prefix)}


def _inject(monkeypatch, masks):
    """Replace draw_dropout_keep: the keep decision of the op whose Mask is
    `name` at step s is masks[s, name] != 0 (as a bool tensor on the op's
    device); build-time shape inference (the meta device) keeps the real
    function. Returns the list of (step, name) the port asked for."""
    asked = []
    real = tensor_ops.draw_dropout_keep

    def draw(ctx, shape, p):
        if ctx.device.type == 'meta':
            return real(ctx, shape, p)
        key = (ctx.interp.step, ctx.op.output('Mask')[0])
        asked.append(key)
        keep = torch.from_numpy(np.asarray(masks[key])) != 0
        assert tuple(keep.shape) == tuple(shape), (key, keep.shape, shape)
        return keep.to(ctx.device)

    monkeypatch.setattr(tensor_ops, 'draw_dropout_keep', draw)
    return asked


def _reference_masks(arrays, names, draw=0):
    return {(i, n): arrays['d%d/step%d/%s' % (draw, i, n)]
            for i in range(STEPS) for n in names}


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


def test_same_program_in_both_packages(jax_run):
    main, _, _ = _build(ptt, ptt_bert)
    ops = jax_run['program']['ops']
    assert [op.type for op in main.global_block().ops] == \
        [t for t, _, _ in ops]
    for a, (t, ins, outs) in zip(main.global_block().ops, ops):
        assert json.loads(json.dumps([a.inputs, a.outputs])) == [ins, outs], t
    assert sorted(v.name for v in main.list_vars() if v.persistable) == \
        jax_run['program']['persistables']
    types = [t for t, _, _ in ops]
    assert types.count('dropout') == types.count('dropout_grad') == N_DROPOUT
    assert types.count('matmul') == 2 * CFG['n_layer']
    assert 'fused_multihead_attention' not in types


def test_training_steps_match_jax_f32(jax_run, monkeypatch):
    arrays, _ = jax_run['f32']
    main, _, loss = _build(ptt, ptt_bert)
    names = _masks(main)
    masks = _reference_masks(arrays, names)
    kept = np.mean([float((m != 0).mean()) for m in masks.values()])
    assert abs(kept - 0.9) < 0.01, kept  # paddle_tpu drew real masks
    asked = _inject(monkeypatch, masks)
    fetch = [loss.name] + _grad_names(main)
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(_part(arrays, 'd0/state/'), main, scope)
    exe = ptt.Executor(ptt.CPUPlace())
    steps = [dict(zip(fetch, exe.run(main, feed=f, fetch_list=fetch,
                                     scope=scope))) for f in FEEDS]
    assert sorted(asked) == sorted(masks)  # every op drew once a step
    np.testing.assert_allclose(
        [float(s[loss.name][0]) for s in steps],
        [float(arrays['d0/step%d/%s' % (i, loss.name)][0])
         for i in range(STEPS)], rtol=1e-5)
    for n in fetch[1:]:
        w = arrays['d0/step0/' + n]
        np.testing.assert_allclose(steps[0][n], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)
    final = ptt.weights.state_to_numpy(main, scope)
    want = _part(arrays, 'd0/final/')
    assert sorted(final) == sorted(want)
    for n in want:
        np.testing.assert_allclose(final[n], want[n], rtol=0,
                                   atol=1e-2 * STEPS * CFG['lr'], err_msg=n)


def test_training_steps_match_jax_bf16(jax_run, monkeypatch):
    arrays, dtypes = jax_run['bf16']
    main, _, loss = _build(ptt, ptt_bert, amp=True)
    names = _masks(main)
    masks = _reference_masks(arrays, names)
    for d in range(1, NOISE_DRAWS + 1):  # the same masks in every draw
        for key, m in _reference_masks(arrays, names, d).items():
            np.testing.assert_array_equal(m, masks[key])
    assert {dtypes['d0/step0/' + n] for n in names} == \
        {'float32', 'bfloat16'}  # the embeddings' is f32, the rest bf16
    asked = _inject(monkeypatch, masks)
    _, worst = _check_steps(jax_run['bf16'], main, FEEDS,
                            [loss.name] + _grad_names(main))
    assert worst <= 1.0
    assert len(asked) == (NOISE_DRAWS + 1) * STEPS * N_DROPOUT


def test_merged_step_is_the_mean_of_its_halves(monkeypatch):
    """k=2 with dropout: the merged step's loss and gradients against the
    mean of two k=1 steps, one on each half of the batch, from the same
    state, each fed the masks its microbatch drew (the same arithmetic in
    the same order, so equal within f32 rounding)."""
    feed = _feed(5, batch=4)
    main, startup, loss = _build(ptt, ptt_bert, k=2)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    state = ptt.weights.state_to_numpy(main, scope)
    fetch = [loss.name] + _grad_names(main)
    drawn = {}
    real = tensor_ops.draw_dropout_keep

    def record(ctx, shape, p):
        keep = real(ctx, shape, p)
        drawn[ctx.interp.micro, ctx.op.output('Mask')[0]] = keep
        return keep

    half_main, _, _ = _build(ptt, ptt_bert)
    monkeypatch.setattr(tensor_ops, 'draw_dropout_keep', record)
    merged = ptt.Executor(ptt.CPUPlace()).run(main, feed=feed,
                                              fetch_list=fetch, scope=scope)
    assert len(drawn) == 2 * N_DROPOUT
    halves = []
    for i in range(2):
        monkeypatch.setattr(tensor_ops, 'draw_dropout_keep', real)
        sc = ptt.Scope()
        ptt.weights.params_from_numpy(state, half_main, sc)
        _inject(monkeypatch, {(0, n): drawn[i, n].numpy()
                              for n in _masks(half_main)})
        halves.append(ptt.Executor(ptt.CPUPlace()).run(
            half_main, scope=sc, fetch_list=fetch,
            feed={n: a[2 * i:2 * i + 2] for n, a in feed.items()}))
    for n, got, a, b in zip(fetch, merged, *halves):
        want = a / 2 + b / 2
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=n)


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
