"""The ResNet training slice as a whole, the port held against paddle_tpu on
the CPU, each program built by both packages under a fresh
unique_name.guard():

(a) models.resnet.build_train_net(depth=20): ResNet-20 on 32x32 images, 10
    classes, softmax cross-entropy, mean, top-1 accuracy and
    Momentum(0.1, 0.9), batch 8, 3 steps;
(b) the space-to-depth stem alone at 224x224 (_s2d_stem -> global average
    pool -> fc -> softmax cross-entropy -> mean, Momentum), batch 2, one
    step;
(c) build_train_net at ResNet-50's full size with the s2d stem (224x224,
    1000 classes), built but not run.

The programs must have the same ops in the same order (types, inputs and
outputs) and the same persistable names; (c) also the same parameter
shapes. paddle_tpu initializes (a) and (b) and takes the steps. Before each
step, weights.py carries its whole persistable state (parameters, BN
running stats, velocities, the learning rate) into the port, which is held
to that step in three parts, f32 on both sides:

- the whole step (forward, backward, Momentum) on the same feed: the loss
  within rtol 1e-5, the accuracy exactly, and the BN running stats after
  the step within 1e-5 of each tensor's largest value;
- the backward and update ops alone (those with an op_role, as
  append_backward and the optimizer mark them), fed paddle_tpu's forward
  values of the step: every `<param>@GRAD`, and every parameter and
  velocity after the step, within max(1e-5 of the tensor's largest value,
  4 times what a one-ulp perturbation moves it in the two packages
  together). The perturbation scales every float input of that run (the
  state and the fed values) by 1 + 1e-7·N(0, 1); each package runs its
  update ops again from the perturbed inputs, in the same test run.
  Where the gradient sums many terms of both signs (the stem's filter
  over 2·112·112 positions, the BN gradients), the two packages' sums
  differ by up to ~1.6e-5 of the largest value, 1.6 times 1e-5: both
  packages' own rounding has to be counted, not only the port's;
- the port's own forward into its own backward: the whole step's
  `<param>@GRAD` of every parameter above the highest relu whose mask
  (X > 0) differs between the two packages' forward values, or in either
  package between the step and the same step from the state and feed
  perturbed by one ulp. Below such a relu the gradients take different
  masks (see below). The tolerance is max(1e-5 of the largest value, 4
  times what the perturbation moves the whole step's gradient in the two
  packages together). At the seeds here 59 gradients are held so, all the
  stem's; 15 of them need more than 1e-5 of their largest value (up to
  1.9e-5, the same sums as above).

Why the backward is fed paddle_tpu's forward values: the two packages'
f32 forwards differ by up to ~2e-5 of a BN output's largest value
(E[x²] - E[x]² cancels; both packages use that formula, summed in
different orders). At the seed's first step one pre-relu value of ResNet-20
is 9.5e-7 and takes a different sign in the two packages. That one relu
moves the first step's gradients of the five lowest layers by up to 1.6e-3
of their largest value, where a one-ulp perturbation moves them by ~2e-6;
at lr 0.1 the later steps amplify the difference further. Fed the same
forward values, the backward takes the same relu masks.

What the tests take from paddle_tpu is computed once, by this file run as
a script in a fresh interpreter, as tests/test_torch_bert_training.py
does and for its reason: a test file that ran earlier in the same pytest
worker can leave jax's caches or config in a state that breaks a later JAX
run there.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from models import resnet as jax_resnet

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import resnet as ptt_resnet

R20 = dict(dshape=(3, 32, 32), class_dim=10, depth=20, lr=0.1)
R20_BATCH = 8
R20_STEPS = 3
R50 = dict(dshape=(3, 224, 224), class_dim=1000, depth=50, imagenet=True,
           s2d_stem=True)
STEM_BATCH = 2
STEM_CLASSES = 10


def _build_r20(pkg, models):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, loss, acc = models.build_train_net(**R20)
    return main, startup, loss, acc


def _build_stem(pkg, models):
    """The s2d stem alone, with a head and Momentum: the path of the 224x224
    ResNet-50's first layer that the 32x32 ResNet-20 does not take."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        images = pkg.layers.data(name='data', shape=[3, 224, 224],
                                 dtype='float32')
        label = pkg.layers.data(name='label', shape=[1], dtype='int64')
        conv = models._s2d_stem(images, is_train=True)
        pool = pkg.layers.pool2d(input=conv, pool_type='avg',
                                 global_pooling=True)
        logits = pkg.layers.fc(input=pool, size=STEM_CLASSES)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            logits=logits, label=label))
        pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return main, startup, loss, None


def _build_r50(pkg, models):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, loss, acc = models.build_train_net(**R50)
    return main, startup, loss, acc


def _feed(seed, batch, shape, classes):
    rng = np.random.RandomState(seed)
    return {'data': rng.randn(batch, *shape).astype(np.float32),
            'label': rng.randint(0, classes, (batch, 1)).astype(np.int64)}


R20_FEEDS = [_feed(i, R20_BATCH, R20['dshape'], R20['class_dim'])
             for i in range(R20_STEPS)]
STEM_FEED = _feed(10, STEM_BATCH, (3, 224, 224), STEM_CLASSES)


def _grad_names(main):
    return sorted(p.name + '@GRAD' for p in main.all_parameters())


def _ops(main):
    return [(op.type, op.inputs, op.outputs)
            for op in main.global_block().ops]


def _update_ops(main):
    """The backward and update ops: those that carry an op_role."""
    return [op for op in main.global_block().ops if op.attrs.get('op_role')]


def _update_feeds(main):
    """What the backward and update ops read that none of them writes and
    that is not persistable: the step's forward values and feeds."""
    persist = {v.name for v in main.list_vars() if v.persistable}
    written, names = set(), []
    for op in _update_ops(main):
        for n in op.input_arg_names():
            if n and n not in written and n not in persist \
                    and n not in names:
                names.append(n)
        written.update(op.output_arg_names())
    return names


def _jax_state(main, scope):
    return {v.name: np.array(scope.find_var(v.name).get_tensor())
            for v in main.list_vars() if v.persistable}


def _perturbed(arrays, seed):
    """Every float array scaled by 1 + 1e-7·N(0, 1): about one f32 ulp."""
    rng = np.random.RandomState(seed)
    return {n: (a * (1 + 1e-7 * rng.randn(*a.shape))).astype(a.dtype)
            if a.dtype.kind == 'f' else a for n, a in arrays.items()}


def _jax_run(build_fn, feeds, root, key):
    """Initialize and take the steps; save under root/<key>.npz the state
    before each step and after the last, each step's loss (and accuracy),
    gradients and the values _update_feeds names, and the gradients and
    state after the update ops alone, run from the step's state and those
    values perturbed by one ulp (_perturbed), and the whole step's
    fetches from the perturbed state and feed."""
    main, startup, loss, acc = build_fn(fluid, jax_resnet)
    heads = [loss] + ([acc] if acc is not None else [])
    grads = _grad_names(main)
    fetch = heads + grads + _update_feeds(main)
    update = main.clone()
    update.global_block().ops = _update_ops(update)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    arrays = {}
    for i, feed in enumerate(feeds):
        with fluid.scope_guard(scope):
            if i == 0:
                exe.run(startup)
            before = _jax_state(main, scope)
            for j, o in enumerate(exe.run(main, feed=feed,
                                          fetch_list=fetch)):
                arrays['step%d/%d' % (i, j)] = np.asarray(o)
        fed = {n: arrays['step%d/%d' % (i, j)] for j, n in
               enumerate(fetch) if j >= len(heads) + len(grads)}
        moved = fluid.Scope()
        with fluid.scope_guard(moved):
            for name, arr in _perturbed(before, 2 * i).items():
                moved.var(name).get_tensor().set(arr)
            outs = exe.run(update, feed=_perturbed(fed, 2 * i + 1),
                           fetch_list=grads)
        arrays.update({'moved%d/%s' % (i, n): np.asarray(o)
                       for n, o in zip(grads, outs)})
        whole = fluid.Scope()
        with fluid.scope_guard(whole):
            for name, arr in _perturbed(before, 2 * i).items():
                whole.var(name).get_tensor().set(arr)
            for j, o in enumerate(exe.run(main, feed=_perturbed(feed, 2 * i),
                                          fetch_list=fetch)):
                arrays['whole%d/%d' % (i, j)] = np.asarray(o)
        arrays.update({'state%d/%s' % (i, n): a for n, a in before.items()})
        arrays.update({'movedstate%d/%s' % (i + 1, n): a
                       for n, a in _jax_state(main, moved).items()})
    arrays.update({'state%d/%s' % (len(feeds), n): a
                   for n, a in _jax_state(main, scope).items()})
    np.savez(os.path.join(root, key + '.npz'), **arrays)
    return _ops(main)


def _jax_reference(root):
    """paddle_tpu's side of the tests, written under root: each program's
    ops and the update ops' feeds (program.json), and the runs of (a) and
    (b) (_jax_run)."""
    programs = {'r20': _jax_run(_build_r20, R20_FEEDS, root, 'r20'),
                'stem': _jax_run(_build_stem, [STEM_FEED], root, 'stem')}
    for key, build_fn in (('r20', _build_r20), ('stem', _build_stem)):
        programs[key + '_update_feeds'] = _update_feeds(
            build_fn(fluid, jax_resnet)[0])
    main = _build_r50(fluid, jax_resnet)[0]
    programs['r50'] = _ops(main)
    programs['r50_params'] = {p.name: list(p.shape)
                              for p in main.all_parameters()}
    with open(os.path.join(root, 'program.json'), 'w') as f:
        json.dump(programs, f)


def _json_round_trip(x):
    return json.loads(json.dumps(x))


def _load_run(root, key, build_fn):
    """{'states': [state before step 0, ..., after the last], 'steps':
    [{name: array} of each step's fetches], 'moved': [{name: array} of
    each step's gradients and state after it from the perturbed update
    run], 'whole': [{name: array} of each step's fetches from the
    perturbed state and feed]}, by the names the port's own program gives
    them."""
    main, _, loss, acc = build_fn(ptt, ptt_resnet)
    heads = [loss.name] + ([acc.name] if acc is not None else [])
    fetch = heads + _grad_names(main) + _update_feeds(main)
    with np.load(os.path.join(root, key + '.npz')) as f:
        arrays = dict(f)
    n_steps = len({k.split('/')[0] for k in arrays if k.startswith('step')})
    steps = [{n: arrays['step%d/%d' % (i, j)] for j, n in enumerate(fetch)}
             for i in range(n_steps)]

    def part(prefix):
        return {n.split('/', 1)[1]: a for n, a in arrays.items()
                if n.startswith(prefix + '/')}
    states = [part('state%d' % i) for i in range(n_steps + 1)]
    moved = [dict(part('moved%d' % i), **part('movedstate%d' % (i + 1)))
             for i in range(n_steps)]
    whole = [{n: arrays['whole%d/%d' % (i, j)] for j, n in enumerate(fetch)}
             for i in range(n_steps)]
    return dict(steps=steps, states=states, moved=moved, whole=whole)


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """paddle_tpu's programs and runs, computed by _jax_reference in a fresh
    interpreter (this file run as a script)."""
    root = str(tmp_path_factory.mktemp('jax_reference'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with open(os.path.join(root, 'program.json')) as f:
        programs = json.load(f)
    return dict(programs=programs,
                r20=_load_run(root, 'r20', _build_r20),
                stem=_load_run(root, 'stem', _build_stem))


def _same_program(main, key, jax_run):
    ops = jax_run['programs'][key]
    assert [op.type for op in main.global_block().ops] == \
        [t for t, _, _ in ops]
    for a, (t, ins, outs) in zip(main.global_block().ops, ops):
        # compared as JSON, the form paddle_tpu's side arrives in
        assert _json_round_trip([a.inputs, a.outputs]) == [ins, outs], t
    if key in jax_run:
        assert sorted(v.name for v in main.list_vars() if v.persistable) == \
            sorted(jax_run[key]['states'][0])
        assert _update_feeds(main) == \
            jax_run['programs'][key + '_update_feeds']


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


def test_same_resnet20_program_in_both_packages(jax_run):
    main, _, loss, acc = _build_r20(ptt, ptt_resnet)
    _same_program(main, 'r20', jax_run)
    assert loss.shape == (1,) and acc.shape == (1,)
    types = [op.type for op in main.global_block().ops]
    assert types.count('momentum') == len(main.all_parameters())
    assert types.count('batch_norm_grad') == types.count('batch_norm') == 21
    assert {'pool2d_grad', 'conv2d_grad', 'mean_grad', 'top_k',
            'accuracy'} <= set(types)
    # the update ops are the backward and Momentum, nothing of the forward
    assert {op.type for op in _update_ops(main)} <= \
        {t for t in types if t.endswith('_grad')} | {'sum', 'fill_constant',
                                                     'momentum'}


def test_same_stem_program_in_both_packages(jax_run):
    main = _build_stem(ptt, ptt_resnet)[0]
    _same_program(main, 'stem', jax_run)
    types = [op.type for op in main.global_block().ops]
    assert types[:6] == ['feed', 'feed', 'pad', 'reshape2', 'transpose2',
                         'reshape2']


def test_same_resnet50_s2d_program_in_both_packages(jax_run):
    main = _build_r50(ptt, ptt_resnet)[0]
    _same_program(main, 'r50', jax_run)
    assert {p.name: list(p.shape) for p in main.all_parameters()} == \
        jax_run['programs']['r50_params']
    types = [op.type for op in main.global_block().ops]
    assert types.count('batch_norm') == types.count('batch_norm_grad') == 53
    assert types.count('momentum') == len(main.all_parameters()) == 161
    conv0 = next(op for op in main.global_block().ops if op.type == 'conv2d')
    assert main.global_block().var(conv0.input('Filter')[0]).shape == \
        (64, 12, 4, 4)


def _close(got, want, tol, name):
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    err = float(np.abs(got - want).max())
    assert err <= tol, '%s: %r > %r (largest value %r)' % (
        name, err, tol, float(np.abs(want).max()))


def _params_above_flipped_relus(main, pairs):
    """The parameters of the forward ops above the highest relu whose mask
    (X > 0) differs within any of `pairs` of forward values of one step
    (two packages, or one package from two states one ulp apart). Their
    gradients come down through the same relu masks in both, so there the
    port's own forward and backward are held together. The fc head is
    always among them."""
    params = {p.name for p in main.all_parameters()}
    forward = [op for op in main.global_block().ops
               if not op.attrs.get('op_role')]
    flipped = [j for j, op in enumerate(forward) if op.type == 'relu'
               and any(not np.array_equal(a[op.input('X')[0]] > 0,
                                          b[op.input('X')[0]] > 0)
                       for a, b in pairs)]
    top = max(flipped, default=-1)
    above = sorted({n for op in forward[top + 1:]
                    for n in op.input_arg_names() if n in params})
    assert 'fc_0.w_0' in above, flipped
    return above


def _check_steps(run, build_fn, feeds):
    main, _, loss, acc = build_fn(ptt, ptt_resnet)
    params = {p.name for p in main.all_parameters()}
    grads = _grad_names(main)
    exe = ptt.Executor(ptt.CPUPlace())
    update = main.clone()
    update.global_block().ops = _update_ops(update)
    fed_names = _update_feeds(main)
    for i, feed in enumerate(feeds):
        want, before, after = run['steps'][i], run['states'][i], \
            run['states'][i + 1]
        # the whole step from paddle_tpu's state
        scope = ptt.Scope()
        ptt.weights.params_from_numpy(before, main, scope)
        heads = [loss.name] + ([acc.name] if acc is not None else [])
        fetch = heads + grads + fed_names
        own = dict(zip(fetch, exe.run(main, feed=feed, fetch_list=fetch,
                                      scope=scope)))
        np.testing.assert_allclose(own[loss.name], want[loss.name],
                                   rtol=1e-5)
        if acc is not None:
            assert float(own[acc.name][0]) == float(want[acc.name][0])
        state = ptt.weights.state_to_numpy(main, scope)
        for name in sorted(before):
            if '.mean' in name or '.variance' in name:
                _close(state[name], after[name],
                       1e-5 * np.abs(after[name]).max(), name)
        # the port's own forward into its own backward, where it can be held
        scope = ptt.Scope()
        ptt.weights.params_from_numpy(_perturbed(before, 2 * i), main, scope)
        own_moved = dict(zip(fetch, exe.run(
            main, feed=_perturbed(feed, 2 * i), fetch_list=fetch,
            scope=scope)))
        jax_whole = run['whole'][i]
        for name in _params_above_flipped_relus(
                main, [(own, want), (own, own_moved), (want, jax_whole)]):
            name += '@GRAD'
            noise = float(np.abs(own_moved[name] - own[name]).max()) + \
                float(np.abs(jax_whole[name] - want[name]).max())
            _close(own[name], want[name],
                   max(1e-5 * float(np.abs(want[name]).max()), 4 * noise),
                   'step %d own forward %s' % (i, name))
        # the backward and Momentum, fed paddle_tpu's forward values
        outs = []
        for st, fed in ((before, {n: want[n] for n in fed_names}),
                        (_perturbed(before, 2 * i),
                         _perturbed({n: want[n] for n in fed_names},
                                    2 * i + 1))):
            scope = ptt.Scope()
            ptt.weights.params_from_numpy(st, main, scope)
            g = exe.run(update, feed=fed, fetch_list=grads, scope=scope)
            outs.append((dict(zip(grads, g)),
                         ptt.weights.state_to_numpy(main, scope)))
        (got_g, got_s), (moved_g, moved_s) = outs
        jax_moved = run['moved'][i]
        for name in grads:
            assert np.abs(want[name]).max() > 0, name
        for name, g, m, w in (
                [(n, got_g[n], moved_g[n], want[n]) for n in grads]
                + [(n, got_s[n], moved_s[n], after[n]) for n in sorted(after)
                   if n in params or '_velocity_' in n]):
            noise = float(np.abs(m - g).max()) + \
                float(np.abs(jax_moved[name] - w).max())
            tol = max(1e-5 * float(np.abs(w).max()), 4 * noise)
            _close(g, w, tol, 'step %d %s' % (i, name))


def test_resnet20_training_steps_match_jax(jax_run):
    run = jax_run['r20']
    _check_steps(run, _build_r20, R20_FEEDS)
    losses = [float(s[_build_r20(ptt, ptt_resnet)[2].name][0])
              for s in run['steps']]
    assert all(np.isfinite(losses))
    # the state moved: velocities and BN running stats
    last = run['states'][-1]
    assert np.abs(last['batch_norm_0.w_0_velocity_0']).max() > 0
    assert not np.allclose(last['batch_norm_0.mean'],
                           run['states'][0]['batch_norm_0.mean'])


def test_s2d_stem_training_step_matches_jax(jax_run):
    _check_steps(jax_run['stem'], _build_stem, [STEM_FEED])


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
