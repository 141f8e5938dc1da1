"""Learning-rate schedules, gradient clipping, weight decay and
per-parameter learning rates in the port (layers/learning_rate_scheduler.py,
clip.py, regularizer.py, Optimizer.minimize), held against paddle_tpu on
the CPU. Each program is built by both packages under a fresh
unique_name.guard(); the port starts from paddle_tpu's state (weights.py,
the int32 step counter of paddle_tpu carried into the port's int64 one).

- Every schedule (noam, exponential and natural-exp and inverse-time
  decay with and without staircase, polynomial with and without cycle,
  piecewise, cosine) and autoincreased_step_counter: the value fetched at
  each of 8 runs equals paddle_tpu's within f32 rounding (rtol 1e-6);
  append_LARS's local rates at a step of the MLP too.
- The MLP of tests/test_amp.py (fc-relu-fc, square error) with
  GradientClipByValue, GradientClipByNorm, GradientClipByGlobalNorm,
  L2Decay (the optimizer's), L1Decay (a ParamAttr's), a ParamAttr
  learning rate, and a noam-scheduled Adam with global-norm clipping and
  L2 decay together, 3 steps each: the same ops in the same order, the
  losses within rtol 1e-5, the first step's raw and final (clipped,
  decayed) gradients within 1e-5 of each tensor's largest value, the
  parameters after the steps within 1e-5 of each one's largest value.
- Under gradient_merge.enable(2), the last MLP at batch 64: the clip and
  decay ops and the schedule run outside the microbatch loop
  (Executor._ga_partition), the step counter reads 1, 2, 3 after three
  steps, the fetched rate is noam's closed form at each step, and the merged
  raw gradients, the clipped gradients, the losses and the parameters
  equal paddle_tpu's k=2 results as above.

paddle_tpu's side runs once, in a fresh interpreter (this file run as a
script), as tests/test_torch_bert_dropout.py's does.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as ptt

from test_torch_amp import _jax_init, _jax_run, _mlp_feed, _Out

SCHED_STEPS = 8
MLP_STEPS = 3
K = 2

# name -> (layers function, args): each schedule and its variants
SCHEDULES = {
    'noam': ('noam_decay', (64, 4)),
    'exponential': ('exponential_decay', (0.1, 3, 0.5)),
    'exponential_staircase': ('exponential_decay', (0.1, 3, 0.5, True)),
    'natural_exp': ('natural_exp_decay', (0.1, 3, 0.5)),
    'natural_exp_staircase': ('natural_exp_decay', (0.1, 3, 0.5, True)),
    'inverse_time': ('inverse_time_decay', (0.1, 3, 0.5)),
    'inverse_time_staircase': ('inverse_time_decay', (0.1, 3, 0.5, True)),
    'polynomial': ('polynomial_decay', (0.1, 5, 0.001, 2.0)),
    'polynomial_cycle': ('polynomial_decay', (0.1, 3, 0.001, 2.0, True)),
    'piecewise': ('piecewise_decay', ([2, 5], [0.1, 0.05, 0.01])),
    'cosine': ('cosine_decay', (0.1, 2, 4)),
    'autoincreased_step_counter': ('autoincreased_step_counter',
                                   (None, 3, 2)),
}


def _build_schedule(pkg, name):
    main, startup = pkg.Program(), pkg.Program()
    fn, args = SCHEDULES[name]
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = getattr(pkg.layers, fn)(*args)
    return main, startup, out


# the MLP variants: name -> (optimizer, options)
MLPS = ['clip_by_value', 'clip_by_norm', 'clip_by_global_norm', 'l2_decay',
        'l1_decay_param_attr', 'param_learning_rate', 'noam_adam_clip_decay']


def _build_mlp(pkg, variant, k=1):
    """tests/test_amp.py's MLP with the variant's clip, regularizer,
    learning rate and optimizer. Returns (main, startup, loss,
    params_grads, lr)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    attr = {}
    if variant == 'clip_by_norm':
        attr = dict(gradient_clip=pkg.clip.GradientClipByNorm(0.5))
    elif variant == 'l1_decay_param_attr':
        attr = dict(regularizer=pkg.regularizer.L1Decay(0.02))
    elif variant == 'param_learning_rate':
        attr = dict(learning_rate=0.25)
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data('x', shape=[16], dtype='float32')
        y = pkg.layers.data('y', shape=[1], dtype='float32')
        h = pkg.layers.fc(x, size=32, act='relu',
                          param_attr=pkg.ParamAttr(**attr))
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        reg = None
        if variant == 'clip_by_value':
            pkg.clip.set_gradient_clip(pkg.clip.GradientClipByValue(0.05))
        elif variant == 'clip_by_global_norm':
            pkg.clip.set_gradient_clip(
                pkg.clip.GradientClipByGlobalNorm(0.3))
        elif variant == 'l2_decay':
            reg = pkg.regularizer.L2Decay(0.01)
        if variant == 'noam_adam_clip_decay':
            pkg.clip.set_gradient_clip(
                pkg.clip.GradientClipByGlobalNorm(0.3))
            lr = pkg.layers.noam_decay(16, 4) * 2.0
            opt = pkg.optimizer.Adam(learning_rate=lr, beta1=0.9,
                                     beta2=0.997, epsilon=1e-9,
                                     regularization=pkg.regularizer.L2Decay(
                                         0.01))
        else:
            opt = pkg.optimizer.SGD(learning_rate=0.05, regularization=reg)
        _, params_grads = opt.minimize(loss)
        lr = opt._global_learning_rate()
    if k > 1:
        pkg.contrib.gradient_merge.enable(k, main)
    return main, startup, loss, params_grads, lr


def _mlp_fetch(main, loss, params_grads, lr):
    """The loss, the raw <param>@GRAD, the gradients the optimizer reads
    and the learning rate."""
    raw = sorted(p.name + '@GRAD' for p in main.all_parameters())
    final = sorted({g.name for _, g in params_grads} - set(raw))
    return [loss.name] + raw + final + [lr.name]


def _ops(main):
    return [(op.type, op.inputs, op.outputs) for op in main.global_block().ops]


def _jax_reference(root):
    """paddle_tpu's side: ref.npz ('<case>/...') and ref.json (each
    case's ops and fetch names)."""
    out, meta = _Out(), {}
    for name in SCHEDULES:
        main, startup, v = _build_schedule(fluid, name)
        state = _jax_init(main, startup)
        steps, _ = _jax_run(main, state, [{}] * SCHED_STEPS, [v.name])
        out.put('sched/%s' % name, np.concatenate(
            [np.asarray(s[0]).reshape(-1) for s in steps]))
        meta['sched/' + name] = {'ops': _ops(main)}
    # append_LARS's local rates at a step of the plain MLP
    main, startup, loss, pg, _ = _build_mlp(fluid, 'l2_decay')
    with fluid.program_guard(main, startup):
        lars = fluid.layers.append_LARS(pg, 0.1, 0.0005)
    state = _jax_init(main, startup)
    (vals,), _ = _jax_run(main, state, [_mlp_feed()], [v.name for v in lars])
    for i, a in enumerate(vals):
        out.put('lars/%d' % i, a)
    for n, a in state.items():
        out.put('lars_state/' + n, a)
    meta['lars'] = {'ops': _ops(main)}
    for variant in MLPS:
        for k in ((1, K) if variant == 'noam_adam_clip_decay' else (1,)):
            key = 'mlp%d/%s' % (k, variant)
            main, startup, loss, pg, lr = _build_mlp(fluid, variant, k)
            fetch = _mlp_fetch(main, loss, pg, lr)
            state = _jax_init(main, startup)
            steps, final = _jax_run(main, state, [_mlp_feed()] * MLP_STEPS,
                                    fetch)
            for i, outs in enumerate(steps):
                for n, o in zip(fetch, outs):
                    out.put('%s/step%d/%s' % (key, i, n), o)
            for tag, st in (('state', state), ('final', final)):
                for n, a in st.items():
                    out.put('%s/%s/%s' % (key, tag, n), a)
            meta[key] = {'ops': _ops(main), 'fetch': fetch}
    out.save(root, 'ref')
    with open(os.path.join(root, 'meta.json'), 'w') as f:
        json.dump(meta, f)


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('jax_lr_clip_regularizer'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with np.load(os.path.join(root, 'ref.npz')) as f:
        arrays = dict(f)
    with open(os.path.join(root, 'meta.json')) as f:
        meta = json.load(f)
    return arrays, meta


def _part(arrays, prefix):
    return {k[len(prefix):]: a for k, a in arrays.items()
            if k.startswith(prefix)}


def _same_ops(main, want):
    got = json.loads(json.dumps(_ops(main)))
    assert [t for t, _, _ in got] == [t for t, _, _ in want]
    assert got == want


def _close(got, want, name, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=0 if rtol else
                               1e-5 * float(np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedule_values_match_jax(name, ref):
    arrays, meta = ref
    main, startup, v = _build_schedule(ptt, name)
    _same_ops(main, meta['sched/' + name]['ops'])
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    got = np.concatenate([exe.run(main, fetch_list=[v], scope=scope)[0]
                          .reshape(-1) for _ in range(SCHED_STEPS)])
    want = arrays['sched/' + name]
    if want.dtype.kind in 'iu':  # the step counter itself
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert len(set(got.tolist())) > 1  # the schedule moved


def test_append_lars_matches_jax(ref):
    arrays, meta = ref
    main, startup, loss, pg, _ = _build_mlp(ptt, 'l2_decay')
    with ptt.program_guard(main, startup):
        lars = ptt.layers.append_LARS(pg, 0.1, 0.0005)
    _same_ops(main, meta['lars']['ops'])
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(_part(arrays, 'lars_state/'), main, scope)
    got = ptt.Executor(ptt.CPUPlace()).run(
        main, feed=_mlp_feed(), fetch_list=lars, scope=scope)
    assert len(got) == len(pg) == 4
    for i, g in enumerate(got):
        _close(g, arrays['lars/%d' % i], 'lars %d' % i, rtol=1e-5)


def _run_mlp(variant, k, arrays, meta):
    key = 'mlp%d/%s' % (k, variant)
    main, _, loss, pg, lr = _build_mlp(ptt, variant, k)
    _same_ops(main, meta[key]['ops'])
    fetch = _mlp_fetch(main, loss, pg, lr)
    assert fetch == meta[key]['fetch']
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(_part(arrays, key + '/state/'), main,
                                  scope)
    exe = ptt.Executor(ptt.CPUPlace())
    steps = [dict(zip(fetch, exe.run(main, feed=_mlp_feed(), fetch_list=fetch,
                                     scope=scope)))
             for _ in range(MLP_STEPS)]
    for i, s in enumerate(steps):
        _close(s[loss.name], arrays['%s/step%d/%s' % (key, i, loss.name)],
               'step %d loss' % i, rtol=1e-5)
        _close(s[lr.name], arrays['%s/step%d/%s' % (key, i, lr.name)],
               'step %d lr' % i, rtol=1e-6)
    for n in fetch[1:-1]:
        _close(steps[0][n], arrays['%s/step0/%s' % (key, n)], n)
    final = ptt.weights.state_to_numpy(main, scope)
    want = _part(arrays, key + '/final/')
    assert sorted(final) == sorted(want)
    for n in want:
        if want[n].dtype.kind in 'iu':
            np.testing.assert_array_equal(final[n], want[n], err_msg=n)
        else:
            _close(final[n], want[n], n)
    return main, scope, fetch, steps


@pytest.mark.parametrize('variant', MLPS)
def test_mlp_steps_match_jax(variant, ref):
    arrays, meta = ref
    main, _, fetch, _ = _run_mlp(variant, 1, arrays, meta)
    types = [op.type for op in main.global_block().ops]
    transforms = [op for op in main.global_block().ops
                  if op.attrs.get('_grad_transform')]
    want_types = {
        'clip_by_value': {'clip'}, 'clip_by_norm': {'clip_by_norm'},
        'clip_by_global_norm': {'squared_l2_norm', 'sum', 'sqrt',
                                'global_norm_scale', 'elementwise_mul'},
        'l2_decay': {'scale', 'sum'}, 'l1_decay_param_attr': {'sign',
                                                              'scale', 'sum'},
        'param_learning_rate': set(),
        'noam_adam_clip_decay': {'squared_l2_norm', 'sum', 'sqrt',
                                 'global_norm_scale', 'elementwise_mul',
                                 'scale'}}[variant]
    assert {op.type for op in transforms} == want_types
    assert all(op.attrs['op_role'] == 1 for op in transforms)
    if variant == 'param_learning_rate':
        scales = [op for op in main.global_block().ops
                  if op.type == 'scale']
        assert len(scales) == 1 and scales[0].attrs['scale'] == 0.25
        assert scales[0].attrs['op_role'] == 2
    if variant == 'noam_adam_clip_decay':
        assert types.count('increment') == 1
        assert len([n for n in fetch
                    if n.endswith('@CLIP@REGULARIZED')]) == 4


def test_gradient_merge_clips_once_and_ticks_the_schedule_once(ref):
    arrays, meta = ref
    main, scope, fetch, steps = _run_mlp('noam_adam_clip_decay', K, arrays,
                                         meta)
    ops, cone, outer, _, _ = ptt.Executor._ga_partition(main, fetch)
    in_cone = {ops[i].type for i in cone}
    for i, op in enumerate(ops):
        if op.attrs.get('_grad_transform') or op.type in (
                'increment', 'adam', 'elementwise_min', 'elementwise_pow'):
            assert i in outer and i not in cone, op.type
    assert 'increment' not in in_cone and 'mul_grad' in in_cone
    counter = scope.get('@LR_DECAY_COUNTER@')
    assert counter.dtype.is_floating_point is False
    assert counter.tolist() == [MLP_STEPS]
    # the rate is noam's closed form at t = 1, 2, 3: one tick a step
    got = [float(s[fetch[-1]][0]) for s in steps]
    want = [2 * 16 ** -0.5 * min(t ** -0.5, t * 4 ** -1.5)
            for t in range(1, MLP_STEPS + 1)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
