"""Training from an artifact on the port: export_train_step ->
CompiledTrainer, held against the port's own Executor and the JAX
package.

The model is tests/test_export_train.py's (fc 24 relu, dropout 0.3, fc 5,
softmax cross-entropy, Momentum). CompiledTrainer runs the exported
program on the port's Executor with the state in its own Scope and the
step counter set before each step, so its losses and final state equal
Executor.run steps bit for bit, dropout masks included. At dropout 0 its
losses match the JAX package's CompiledTrainer from the same initial state
within rtol 1e-5, the f32 tolerance the port's training tests use (the two
frameworks draw different dropout masks, so the cross-package comparison
takes dropout 0). The JAX side runs in a fresh interpreter, this file run
as a script, with PTPU_ARTIFACT_AOT=0 and precompile=False.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.contrib import gradient_merge
from paddle_tpu_torch.inference import export_train_step, load_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


def _build(pkg, dropout=0.3):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data('x', shape=[12], dtype='float32')
        label = pkg.layers.data('label', shape=[1], dtype='int64')
        h = pkg.layers.fc(x, 24, act='relu')
        if dropout:
            h = pkg.layers.dropout(h, dropout_prob=dropout)
        logits = pkg.layers.fc(h, 5)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            logits=logits, label=label))
        pkg.optimizer.Momentum(learning_rate=0.05,
                               momentum=0.9).minimize(loss)
    return main, startup, loss


def _feed():
    rng = np.random.RandomState(0)
    return {'x': rng.randn(16, 12).astype(np.float32),
            'label': rng.randint(0, 5, (16, 1)).astype(np.int64)}


def _port_setup(tmp, dropout=0.3, steps=STEPS):
    """The port's model initialized, exported to tmp/art, then trained
    `steps` Executor.run steps. Returns (artifact, losses, final state)."""
    main, startup, loss = _build(ptt, dropout)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    art = os.path.join(tmp, 'art')
    export_train_step(main, _feed(), [loss], art, scope=scope)
    losses = np.stack([exe.run(main, feed=_feed(), fetch_list=[loss],
                               scope=scope)[0] for _ in range(steps)])
    return art, losses, ptt.weights.state_to_numpy(main, scope)


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


def test_trainer_equals_executor_bit_for_bit(tmp_path):
    art, want, want_final = _port_setup(str(tmp_path))
    sig = json.load(open(os.path.join(art, 'train_signature.json')))
    assert sig['format'] == 'paddle_tpu_torch' and sig['rng']['seed'] == 7
    assert sig['amp_bf16'] is False
    assert len(sig['fetches']) == 1
    assert [e['name'] for e in sig['feeds']] == ['label', 'x']
    assert sorted(os.listdir(art)) == ['train_program.json',
                                       'train_signature.json',
                                       'train_state0.npz']
    trainer = load_trainer(art)
    assert trainer.get_input_names() == ['label', 'x']
    got = np.stack([trainer.step(_feed())[0] for _ in range(STEPS)])
    np.testing.assert_array_equal(got, want)
    final = trainer.state
    assert sorted(final) == sorted(want_final)
    for n in want_final:
        np.testing.assert_array_equal(final[n], want_final[n], err_msg=n)
    # strict shapes: a train step never pads
    with pytest.raises(ValueError, match='expected shape'):
        trainer.step({k: v[:8] for k, v in _feed().items()})


def test_trainer_checkpoint_round_trip_and_restart(tmp_path):
    art, want, _ = _port_setup(str(tmp_path), steps=4)
    t1 = load_trainer(art)
    first = np.stack([t1.step(_feed())[0] for _ in range(2)])
    ckpt = str(tmp_path / 'ckpt.npz')
    t1.save_state(ckpt)
    with np.load(ckpt) as z:
        assert int(z['__step_count__']) == 2
    t2 = load_trainer(art)
    t2.load_state(ckpt)  # the state AND the step counter
    rest = np.stack([t2.step(_feed())[0] for _ in range(2)])
    np.testing.assert_array_equal(np.concatenate([first, rest]), want)
    # a checkpoint without a counter (the initial state) restarts at 0
    t2.load_state(os.path.join(art, 'train_state0.npz'))
    np.testing.assert_array_equal(t2.step(_feed())[0], want[0])
    bad = str(tmp_path / 'bad.npz')
    np.savez(bad, x=np.zeros(1))
    with pytest.raises(ValueError, match='missing state'):
        t2.load_state(bad)


def test_export_refuses_gradient_merge_and_missing_state(tmp_path):
    main, startup, loss = _build(ptt)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    gm = main.clone()
    gradient_merge.enable(2, gm)
    with pytest.raises(ValueError, match='gradient-merge'):
        export_train_step(gm, _feed(), [loss], str(tmp_path / 'gm'),
                          scope=scope)
    with pytest.raises(ValueError, match='absent from the scope'):
        export_train_step(main, _feed(), [loss], str(tmp_path / 'empty'),
                          scope=ptt.Scope())


_CLI = r'''
import sys
from paddle_tpu_torch.inference import serve
rc = serve.main(['serve.py', 'train'] + sys.argv[1:])
leaked = [m for m in sys.modules
          if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu')]
assert not leaked, leaked
sys.exit(rc)
'''


def test_train_cli_fresh_process(tmp_path):
    art, want, want_final = _port_setup(str(tmp_path))
    feeds = str(tmp_path / 'feeds.npz')
    np.savez(feeds, **_feed())
    env = dict(os.environ, PTPU_PLATFORM='cpu', PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run(
        [sys.executable, '-c', _CLI, art, feeds, str(tmp_path / 'out.npz'),
         str(STEPS), str(tmp_path / 'ckpt.npz')],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    with np.load(str(tmp_path / 'out.npz')) as out:
        got = out[list(out.files)[0]]
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    with np.load(str(tmp_path / 'ckpt.npz')) as z:
        assert int(z['__step_count__']) == STEPS
        for n in want_final:
            np.testing.assert_array_equal(z[n], want_final[n], err_msg=n)


def _jax_reference(root):
    """paddle_tpu's side: the dropout-0 model initialized (init.npz, every
    persistable) and its CompiledTrainer's STEPS losses (losses.npy)."""
    import paddle_tpu as fluid
    from paddle_tpu.inference import export_train_step as jax_export
    from paddle_tpu.inference import load_trainer as jax_trainer
    main, startup, loss = _build(fluid, dropout=0)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    init = {v.name: np.asarray(scope.get(v.name)) for v in main.list_vars()
            if v.persistable and scope.get(v.name) is not None}
    jax_export(main, _feed(), [loss], os.path.join(root, 'art'),
               scope=scope, precompile=False)
    trainer = jax_trainer(os.path.join(root, 'art'))
    np.save(os.path.join(root, 'losses.npy'),
            np.stack([trainer.step(_feed())[0] for _ in range(STEPS)]))
    np.savez(os.path.join(root, 'init.npz'), **init)


def test_trainer_matches_jax_compiled_trainer(tmp_path):
    root = str(tmp_path / 'jax')
    env = dict(os.environ, PTPU_ARTIFACT_AOT='0', PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with np.load(os.path.join(root, 'init.npz')) as z:
        init = dict(z)
    main, _, loss = _build(ptt, dropout=0)
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(init, main, scope)
    art = str(tmp_path / 'art')
    export_train_step(main, _feed(), [loss], art, scope=scope)
    trainer = load_trainer(art)
    got = np.stack([trainer.step(_feed())[0] for _ in range(STEPS)])
    np.testing.assert_allclose(got, np.load(os.path.join(root,
                                                         'losses.npy')),
                               rtol=1e-5)


if __name__ == '__main__':
    os.makedirs(sys.argv[1], exist_ok=True)
    _jax_reference(sys.argv[1])
