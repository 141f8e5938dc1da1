"""Executor.run_steps and Predictor.run_batches in the port
(paddle_tpu_torch/executor.py, inference/predictor.py), held against K
`run` calls and against paddle_tpu's run_steps and run_batches on the CPU.

The training program: fc(32, tanh) -> dropout(0.3) -> fc(10) -> softmax
cross-entropy -> mean, Momentum(0.1, 0.9), random_seed 7; with
gradient_merge.enable(2) too. Within the port, from one initial state:

- run_steps(K) with a stacked [K, ...] feed or with K-lists, 'final' or
  'stack', gives the same fetches, and leaves the same parameters and
  velocities, bit for bit, as K `run` calls (the same per-step dropout
  masks: the steps share `run`'s counter);
- run and run_steps interleave on that counter: run, run_steps(2), run
  equals four runs, bit for bit;
- the gradient-merge program's run_steps(3) equals three runs.

Against paddle_tpu, the program built by both packages under a fresh
unique_name.guard(), the port started from paddle_tpu's initial state
(weights.py) and given the masks paddle_tpu's run_steps drew (fetched
with fetch_policy='stack'): run_steps(4)'s stacked losses within rtol
1e-5, and the parameters and velocities after within 1e-5 of each
tensor's largest value (f32, tanh: no relu whose sign could flip).

The error cases raise what paddle_tpu raises: a bad fetch_policy, steps
< 1, steps against the feed's K, feeds that disagree on K, no feed
source, a feed with no step dimension (ValueError); and, in the port
only, reader= and checkpoint=, whose modules are not ported
(NotImplementedError).

Predictor.run_batches, on a conv net (conv2d 3x3 relu -> pool2d -> fc)
saved by paddle_tpu with save_inference_model: K batches, as lists and as
dicts, equal K `run` calls bit for bit, and paddle_tpu's run_batches
within rtol 1e-5 and 1e-5 of the largest logit.

paddle_tpu's side runs once, in a fresh interpreter (this file run as a
script), as tests/test_torch_resnet_training.py runs its own and for its
reason.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.ops import tensor_ops

K = 4
BATCH = 8
DIM = 16
CLASSES = 10
LR = 0.1
IMG = (3, 8, 8)
SERVE_K = 3
SERVE_BATCH = 2


def _build(pkg, k=1):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data('x', shape=[DIM], dtype='float32')
        y = pkg.layers.data('y', shape=[1], dtype='int64')
        h = pkg.layers.fc(x, size=32, act='tanh')
        h = pkg.layers.dropout(h, dropout_prob=0.3)
        logits = pkg.layers.fc(h, size=CLASSES)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            logits=logits, label=y))
        pkg.optimizer.Momentum(learning_rate=LR, momentum=0.9).minimize(loss)
    if k > 1:
        pkg.contrib.gradient_merge.enable(k, main)
    mask = next(op.output('Mask')[0] for op in main.global_block().ops
                if op.type == 'dropout')
    return main, startup, loss, mask


def _feeds(k, seed=0, batch=BATCH):
    """K per-step feeds."""
    rng = np.random.RandomState(seed)
    return [{'x': rng.randn(batch, DIM).astype(np.float32),
             'y': rng.randint(0, CLASSES, (batch, 1)).astype(np.int64)}
            for _ in range(k)]


def _stacked(feeds):
    return {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}


def _listed(feeds):
    return {n: [f[n] for f in feeds] for n in feeds[0]}


def _serve_batches(seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(SERVE_BATCH, *IMG).astype(np.float32)
            for _ in range(SERVE_K)]


def _errors(exe, main, scope_kw):
    """The error each bad call raises, by case: its type's name."""
    feeds = _feeds(2)
    cases = {
        'bad_policy': dict(feed=_stacked(feeds), fetch_policy='last'),
        'steps_0': dict(feed=_stacked(feeds), steps=0),
        'steps_mismatch': dict(feed=_stacked(feeds), steps=3),
        'k_disagree': dict(feed={'x': _stacked(feeds)['x'],
                                 'y': _stacked(_feeds(3))['y']}),
        'no_feed': dict(),
        'no_step_dim': dict(feed={'x': np.float32(1.0),
                                  'y': np.int64(1)}),
    }
    out = {}
    for name, kw in cases.items():
        try:
            exe.run_steps(main, **dict(kw, **scope_kw))
            out[name] = None
        except Exception as e:  # noqa: BLE001 - the type is the result
            out[name] = type(e).__name__
    return out


# -- paddle_tpu's side, in a fresh interpreter --------------------------------
def _jax_reference(root):
    """program.json (ops, persistables, error types) and arrays.npz: the
    initial state, run_steps(K)'s stacked losses and masks, the state
    after; the saved conv net (serve/) and its run_batches logits."""
    main, startup, loss, mask = _build(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    arrays = {}
    with fluid.scope_guard(scope):
        exe.run(startup)
        state = {v.name: np.array(scope.find_var(v.name).get_tensor())
                 for v in main.list_vars() if v.persistable}
        losses, masks = exe.run_steps(main, feed=_stacked(_feeds(K)),
                                      fetch_list=[loss, mask],
                                      fetch_policy='stack')
        after = {v.name: np.array(scope.find_var(v.name).get_tensor())
                 for v in main.list_vars() if v.persistable}
    arrays.update({'state/' + n: a for n, a in state.items()})
    arrays.update({'after/' + n: a for n, a in after.items()})
    arrays['losses'] = np.asarray(losses)
    arrays['masks'] = np.asarray(masks)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        errors = _errors(exe, main, {})

    smain, sstartup = fluid.Program(), fluid.Program()
    with fluid.program_guard(smain, sstartup), fluid.unique_name.guard():
        img = fluid.layers.data('img', shape=list(IMG), dtype='float32')
        h = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                padding=1, act='relu')
        h = fluid.layers.pool2d(h, pool_size=2, pool_stride=2)
        logits = fluid.layers.fc(h, size=CLASSES)
    d = os.path.join(root, 'serve')
    with fluid.scope_guard(fluid.Scope()):
        exe.run(sstartup)
        fluid.io.save_inference_model(d, ['img'], [logits], exe, smain)
    pred = jax_create_predictor(JaxConfig(d).disable_gpu())
    outs = pred.run_batches([[b] for b in _serve_batches()])
    arrays['served'] = np.stack([np.asarray(o[0]) for o in outs])
    np.savez(os.path.join(root, 'arrays.npz'), **arrays)
    with open(os.path.join(root, 'program.json'), 'w') as f:
        json.dump({'ops': [(op.type, op.inputs, op.outputs)
                           for op in main.global_block().ops],
                   'errors': errors}, f)


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('jax_run_steps'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with open(os.path.join(root, 'program.json')) as f:
        program = json.load(f)
    with np.load(os.path.join(root, 'arrays.npz')) as f:
        arrays = dict(f)
    return dict(root=root, program=program, arrays=arrays)


# -- the port's side ----------------------------------------------------------
def _start(k=1):
    main, startup, loss, mask = _build(ptt, k)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    return main, exe, scope, loss, mask


def _state(main, scope):
    return ptt.weights.state_to_numpy(main, scope)


def _same_state(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def _runs(k, feeds, gm=1):
    """K run() calls from the startup state: (losses, masks, state)."""
    main, exe, scope, loss, mask = _start(gm)
    fetch = [loss] if gm > 1 else [loss, mask]
    outs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds[:k]]
    return ([o[0] for o in outs], [o[-1] for o in outs],
            _state(main, scope))


@pytest.mark.parametrize('form', ['stacked', 'listed', 'stacked_tensor'])
@pytest.mark.parametrize('policy', ['final', 'stack'])
def test_run_steps_is_k_runs_bit_for_bit(form, policy):
    feeds = _feeds(K)
    losses, masks, state = _runs(K, feeds)
    main, exe, scope, loss, mask = _start()
    group = {'stacked': _stacked, 'listed': _listed}.get(
        form, lambda f: {n: torch.from_numpy(a)
                         for n, a in _stacked(f).items()})(feeds)
    got_loss, got_mask = exe.run_steps(main, feed=group,
                                       fetch_list=[loss, mask], steps=K,
                                       scope=scope, fetch_policy=policy)
    if policy == 'final':
        np.testing.assert_array_equal(got_loss, losses[-1])
        np.testing.assert_array_equal(got_mask, masks[-1])
    else:
        assert got_loss.shape == (K, 1) and got_mask.shape == (K, BATCH, 32)
        np.testing.assert_array_equal(got_loss, np.stack(losses))
        np.testing.assert_array_equal(got_mask, np.stack(masks))
    # fresh masks each step, as in run
    assert not np.array_equal(masks[0], masks[1])
    _same_state(_state(main, scope), state)


def test_run_and_run_steps_interleave_on_one_counter():
    feeds = _feeds(K)
    losses, masks, state = _runs(K, feeds)
    main, exe, scope, loss, mask = _start()
    got = [exe.run(main, feed=feeds[0], fetch_list=[loss, mask],
                   scope=scope)]
    ls, ms = exe.run_steps(main, feed=_listed(feeds[1:3]),
                           fetch_list=[loss, mask], scope=scope,
                           fetch_policy='stack')
    got += [(ls[0], ms[0]), (ls[1], ms[1])]
    got.append(exe.run(main, feed=feeds[3], fetch_list=[loss, mask],
                       scope=scope))
    for (gl, gm), wl, wm in zip(got, losses, masks):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gm, wm)
    _same_state(_state(main, scope), state)


def test_run_steps_under_gradient_merge_is_k_runs():
    feeds = _feeds(3, seed=1, batch=2 * BATCH)
    losses, _, state = _runs(3, feeds, gm=2)
    main, exe, scope, loss, _ = _start(2)
    got, = exe.run_steps(main, feed=_stacked(feeds), fetch_list=[loss],
                         scope=scope, fetch_policy='stack',
                         return_numpy=False)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), np.stack(losses))
    _same_state(_state(main, scope), state)


def test_same_program_in_both_packages(jax_run):
    main = _build(ptt)[0]
    ops = jax_run['program']['ops']
    assert [op.type for op in main.global_block().ops] == \
        [t for t, _, _ in ops]
    for a, (t, ins, outs) in zip(main.global_block().ops, ops):
        assert json.loads(json.dumps([a.inputs, a.outputs])) == [ins, outs], t


def test_run_steps_matches_jax(jax_run, monkeypatch):
    arrays = jax_run['arrays']
    main, _, loss, mask = _build(ptt)
    masks = arrays['masks']
    assert masks.shape == (K, BATCH, 32)
    assert 0.5 < float((masks != 0).mean()) < 0.9  # real keep-0.7 masks
    real = tensor_ops.draw_dropout_keep

    def draw(ctx, shape, p):
        if ctx.device.type == 'meta':
            return real(ctx, shape, p)
        assert ctx.op.output('Mask')[0] == mask
        return torch.from_numpy(masks[ctx.interp.step] != 0)

    monkeypatch.setattr(tensor_ops, 'draw_dropout_keep', draw)
    scope = ptt.Scope()
    state = {n[6:]: a for n, a in arrays.items() if n.startswith('state/')}
    ptt.weights.params_from_numpy(state, main, scope)
    exe = ptt.Executor(ptt.CPUPlace())
    losses, = exe.run_steps(main, feed=_stacked(_feeds(K)),
                            fetch_list=[loss], scope=scope,
                            fetch_policy='stack')
    np.testing.assert_allclose(losses, arrays['losses'], rtol=1e-5)
    after = _state(main, scope)
    for n, want in arrays.items():
        if n.startswith('after/'):
            np.testing.assert_allclose(
                after[n[6:]], want, rtol=0,
                atol=1e-5 * float(np.abs(want).max()), err_msg=n)


def test_errors_match_jax(jax_run):
    main, exe, scope, _, _ = _start()
    assert _errors(exe, main, {'scope': scope}) == \
        jax_run['program']['errors']
    assert set(jax_run['program']['errors'].values()) == {'ValueError'}
    for kw in (dict(reader=object()), dict(checkpoint=object())):
        with pytest.raises(NotImplementedError, match='item 11'):
            exe.run_steps(main, feed=_stacked(_feeds(2)), scope=scope, **kw)


def test_run_batches_is_k_runs_and_matches_jax(jax_run):
    pred = create_predictor(Config(os.path.join(jax_run['root'],
                                                'serve')).disable_gpu())
    batches = _serve_batches()
    want = [pred.run([b])[0] for b in batches]
    for form in ([[b] for b in batches], [{'img': b} for b in batches]):
        got = pred.run_batches(form)
        assert len(got) == SERVE_K and all(len(o) == 1 for o in got)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w)
    served = jax_run['arrays']['served']
    np.testing.assert_allclose(np.stack(want), served, rtol=1e-5,
                               atol=1e-5 * np.abs(served).max())
    tensors = pred.run_batches([[b] for b in batches], return_numpy=False)
    assert isinstance(tensors[0][0], torch.Tensor)
    assert pred.run_batches([]) == []
    with pytest.raises(ValueError, match='missing feeds'):
        pred.run_batches([{'image': batches[0]}])


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
