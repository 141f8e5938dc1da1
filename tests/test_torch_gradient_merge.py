"""Gradient merge (contrib.gradient_merge, executor.Executor._ga_step), the
port held against paddle_tpu on the CPU: BERT pretraining at 2 layers,
d_model 64, 4 heads, S=128, vocab 97, dropout 0, batch 4 in k=2
microbatches, 3 Adam steps, built by both packages under a fresh
unique_name.guard() and marked by `gradient_merge.enable(2, main)`; the
port starts from paddle_tpu's state (weights.py).

- f32: per-step losses within rtol 1e-5; the merged `<param>@GRAD` of
  the first step (from the same state) within 1e-5 of each tensor's
  largest value; parameters after the steps within 1e-2 of the most Adam
  can move an element (steps·lr), as tests/test_torch_bert_training.py
  holds them.
- bf16 AMP (`enable_bf16` too): every loss, merged gradient and parameter
  update within 4 times the one-bf16-ulp noise of both packages (the
  largest move over NOISE_DRAWS runs from the parameters moved by one
  bf16 ulp), never under 1e-6 of the largest value: the rule of
  tests/test_torch_amp.py, whose helpers run both sides.
- The port's k=2 equals its k=1 over the whole batch within f32
  rounding. Merging averages the microbatches' losses, and BERT's loss is
  a masked mean over each microbatch's weighted positions, so the feed
  weights as many positions in each half of the batch; then the mean of
  the two halves' losses is the whole batch's.
- The reference's errors: a batch that k does not divide, a LoD feed, a
  carried value that is not a float, a fetch that only the microbatches
  compute and that is not a scalar.

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

import paddle_tpu as fluid
from models import bert as jax_bert

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import bert as ptt_bert

from test_torch_amp import (_check_steps, _grad_names, _jax_init, _jax_run,
                            _jax_steps, _Out)

CFG = dict(vocab=97, max_len=128, d_model=64, d_ff=128, n_head=4, n_layer=2,
           dropout=0.0, lr=1e-4)
K = 2
BATCH = 4
STEPS = 3


def _feed(seed, batch=BATCH):
    rng = np.random.RandomState(seed)
    s, v = CFG['max_len'], CFG['vocab']
    return {'tok_ids': rng.randint(0, v, (batch, s)).astype(np.int64),
            'seg_ids': rng.randint(0, 2, (batch, s)).astype(np.int64),
            'mlm_labels': rng.randint(0, v, (batch, s)).astype(np.int64),
            'mlm_weights': (rng.rand(batch, s) < 0.15).astype(np.float32)}


FEEDS = [_feed(i) for i in range(STEPS)]


def _build(pkg, bert_mod, k=K, amp=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, loss = bert_mod.build_bert_pretrain(**CFG)
    if amp:
        pkg.contrib.mixed_precision.enable_bf16(main)
    if k > 1:
        pkg.contrib.gradient_merge.enable(k, main)
    return main, startup, loss


def _jax_reference(root):
    """paddle_tpu's k=2 steps, f32 (one run) and bf16 (and its noise
    draws), in tests/test_torch_amp.py's layout ('d<draw>/step<i>/<name>',
    'd<draw>/state/', 'd<draw>/final/'): root/{f32,bf16}.npz and .json."""
    out = _Out()
    main, startup, loss = _build(fluid, jax_bert)
    fetch = [loss.name] + _grad_names(main)
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
    _jax_steps(out, main, startup, FEEDS, [loss.name] + _grad_names(main))
    out.save(root, 'bf16')


@pytest.fixture(scope='module')
def jax_ga(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('jax_gradient_merge'))
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
    for name in ('f32', 'bf16'):
        with np.load(os.path.join(root, name + '.npz')) as f:
            arrays = dict(f)
        with open(os.path.join(root, name + '.json')) as f:
            out[name] = (arrays, json.load(f))
    return out


def _part(arrays, prefix):
    return {k[len(prefix):]: a for k, a in arrays.items()
            if k.startswith(prefix)}


def _port_steps(main, state, feeds, fetch):
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(state, main, scope)
    exe = ptt.Executor(ptt.CPUPlace())
    steps = [dict(zip(fetch, exe.run(main, feed=f, fetch_list=fetch,
                                     scope=scope))) for f in feeds]
    return steps, ptt.weights.state_to_numpy(main, scope)


def test_merged_steps_match_jax_f32(jax_ga):
    arrays, _ = jax_ga['f32']
    main, _, loss = _build(ptt, ptt_bert)
    fetch = [loss.name] + _grad_names(main)
    steps, final = _port_steps(main, _part(arrays, 'd0/state/'), FEEDS,
                               fetch)
    np.testing.assert_allclose(
        [float(s[loss.name][0]) for s in steps],
        [float(arrays['d0/step%d/%s' % (i, loss.name)][0])
         for i in range(STEPS)], rtol=1e-5)
    for n in fetch[1:]:
        w = arrays['d0/step0/' + n]
        assert steps[0][n].shape == w.shape, n
        np.testing.assert_allclose(steps[0][n], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)
    want = _part(arrays, 'd0/final/')
    assert sorted(final) == sorted(want)
    for n in want:
        np.testing.assert_allclose(final[n], want[n], rtol=0,
                                   atol=1e-2 * STEPS * CFG['lr'], err_msg=n)


def test_merged_steps_match_jax_bf16(jax_ga):
    main, _, loss = _build(ptt, ptt_bert, amp=True)
    _, worst = _check_steps(jax_ga['bf16'], main, FEEDS,
                            [loss.name] + _grad_names(main))
    assert worst <= 1.0


def test_k2_equals_k1_over_the_whole_batch():
    feed = _feed(7)
    feed['mlm_weights'][BATCH // 2:] = feed['mlm_weights'][:BATCH // 2]
    main, startup, loss = _build(ptt, ptt_bert, k=1)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    state = ptt.weights.state_to_numpy(main, scope)
    fetch = [loss.name] + _grad_names(main)
    (whole,), after_whole = _port_steps(main, state, [feed], fetch)
    merged_main, _, _ = _build(ptt, ptt_bert)
    (merged,), after_merged = _port_steps(merged_main, state, [feed], fetch)
    for n in fetch:
        w = whole[n]
        np.testing.assert_allclose(merged[n], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)
    for n in after_whole:
        np.testing.assert_allclose(after_merged[n], after_whole[n], rtol=0,
                                   atol=1e-2 * CFG['lr'], err_msg=n)


class _LoDFeed(object):
    """A host value with a LoD, as the reference's LoDTensor gives one."""

    def __init__(self, data, lod):
        self.data, self.lod, self.shape = data, lod, data.shape

    def __array__(self, dtype=None, copy=None):
        return self.data


@pytest.mark.parametrize('what', ['uneven_batch', 'lod_feed',
                                  'int_carried', 'non_scalar_fetch'])
def test_reference_errors(what):
    main, startup, loss = _build(ptt, ptt_bert)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    feed, fetch = _feed(0), [loss]
    ops = main.global_block().ops
    if what == 'uneven_batch':
        feed = _feed(0, batch=3)
        err, match = ValueError, 'not divisible by num_microbatches=2'
    elif what == 'lod_feed':
        feed['tok_ids'] = _LoDFeed(feed['tok_ids'], [[0, 128, 256]])
        err, match = TypeError, 'does not support LoD feeds'
    elif what == 'int_carried':
        # the position ids (range): the embedding's grad reads them
        fetch = [next(op for op in ops if op.type == 'range').output(
            'Out')[0]]
        err, match = RuntimeError, 'only float values average'
    else:
        fetch = [next(op for op in ops if op.type == 'softmax_with_cross_'
                      'entropy').output('Loss')[0]]
        err, match = RuntimeError, 'only scalar \\(loss-like\\) fetches'
    with pytest.raises(err, match=match):
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def test_surface_matches_the_reference():
    import inspect
    from paddle_tpu.contrib import gradient_merge as ref
    gm = ptt.contrib.gradient_merge
    for name in ('decorate', 'enable'):
        assert inspect.signature(getattr(gm, name)) == \
            inspect.signature(getattr(ref, name)), name
    assert inspect.signature(gm.GradientMergeOptimizer.minimize) == \
        inspect.signature(ref.GradientMergeOptimizer.minimize)
    main, _, _ = _build(ptt, ptt_bert, k=1)
    assert gm.enable(3, main) is main and main._grad_accum_k == 3
    with pytest.raises(ValueError, match='k_steps'):
        gm.decorate(ptt.optimizer.SGD(0.1), 0)
    opt = gm.decorate(ptt.optimizer.SGD(0.1), 2)
    assert opt.type == 'sgd'  # attributes reach the wrapped optimizer


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
