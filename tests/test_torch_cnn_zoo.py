"""The image-classification zoo as a whole (models/smallnet.py, alexnet.py,
vgg.py, googlenet.py, se_resnext.py), the port held against paddle_tpu on
the CPU, each program built by both packages under a fresh
unique_name.guard():

(a) at full size (bench.py's settings: SmallNet 32x32 with 10 classes, the
    others 224x224 with 1000; VGG-19, SE-ResNeXt-50), built and not run:
    the same ops in the same order (types, inputs and outputs), the same
    persistable names and the same parameter shapes;
(b) at a small size (SmallNet and VGG-16 at 32x32, AlexNet, GoogLeNet and
    SE-ResNeXt-50 at 64x64, 10 classes; batch 4 for SmallNet and VGG-16,
    at which the reference's own VGG-16 steps stay finite, 2 for the
    others), f32, Momentum(0.01, 0.9) steps (3 for SmallNet, 2 for
    AlexNet, VGG-16 and GoogLeNet, 1 for SE-ResNeXt-50). paddle_tpu
    initializes and takes the steps; before each step weights.py carries
    its whole persistable state into the port, which is held to that step
    in two parts, with paddle_tpu's dropout masks (the test replaces
    ops/tensor_ops.py draw_dropout_keep with one that returns, for each
    dropout op, the Mask paddle_tpu drew at that step):
    - the whole step on the same feed: the accuracy exactly; the loss and
      the BN running stats after the step (VGG's two, SE-ResNeXt's 53)
      within max(1e-5 of the largest value, 4 times what a one-ulp
      perturbation of the state and the feed moves them in the two
      packages together): deep below them, a pre-relu value near 0 can
      take another sign in the two packages' f32 forwards (at the seeds
      here SE-ResNeXt's deepest running means move by up to 5e-5 of their
      largest value so);
    - the backward and Momentum ops alone (those with an op_role), fed
      paddle_tpu's forward values of the step, its masks among them: every
      `<param>@GRAD`, and every parameter and velocity after the step,
      within max(1e-5 of the tensor's largest value, 4 times what a
      one-ulp perturbation moves it in the two packages together), as
      tests/test_torch_resnet_training.py holds ResNet-20, and for its
      reason: a pre-relu value near 0 can take another sign in the two
      packages' f32 forwards;
(c) one bf16 AMP step (enable_bf16) of VGG-16 and of SE-ResNeXt-50 at the
    sizes of (b), held as tests/test_torch_amp.py holds ResNet-20: the
    loss, and the backward and Momentum fed paddle_tpu's forward values
    (gradients and each parameter's update), each within 4 times the
    one-bf16-ulp noise of both packages over NOISE_DRAWS draws (floor
    1e-6 of the largest value), paddle_tpu's masks in every draw;
(d) GoogLeNet inference (is_train=False, 64x64, 10 classes) saved by
    paddle_tpu with save_inference_model and served from that directory by
    the port's Predictor, at batch 2 and 3: logits within rtol 1e-5 and
    1e-5 of the largest logit of paddle_tpu's Predictor's.

paddle_tpu's side runs in fresh interpreters (this file run as a script,
one process for each job of JOBS, at most two at a time), as
tests/test_torch_resnet_training.py runs its own and for its reason. The
parameters of these models are large even at a small image size (VGG-16's
fc head alone has 19M), so (b) and (c) hold the port against paddle_tpu
in that process, right after paddle_tpu's run, and write a report of each
comparison, (label, err, tolerance), which the tests read; (a) and (d)
write the program and the saved directory. In a process for (b), one
Executor takes the steps; the update ops' runs are put at the step's count
of that Executor, so the generic dropout gradient there draws the step's
mask again. The bf16 processes run with XLA's excess precision off and
batch_norm on its TPU kernel's path in interpret mode, as
tests/test_torch_training_ops.py's _jax_amp_reference does and for its
reasons; VGG's 2-D batch_norm takes that path through a [N, C, 1, 1] view.
"""
import concurrent.futures
import contextlib
import functools
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
from models import alexnet as jax_alexnet
from models import googlenet as jax_googlenet
from models import se_resnext as jax_se_resnext
from models import smallnet as jax_smallnet
from models import vgg as jax_vgg

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.models import alexnet as ptt_alexnet
from paddle_tpu_torch.models import googlenet as ptt_googlenet
from paddle_tpu_torch.models import se_resnext as ptt_se_resnext
from paddle_tpu_torch.models import smallnet as ptt_smallnet
from paddle_tpu_torch.models import vgg as ptt_vgg
from paddle_tpu_torch.ops import tensor_ops

from test_torch_amp import (NOISE_DRAWS, _as_numpy, _bf16_moved, _f32,
                            _grad_names, _update_feeds, _update_ops,
                            _update_program)

MODULES = {'smallnet': (jax_smallnet, ptt_smallnet),
           'alexnet': (jax_alexnet, ptt_alexnet),
           'vgg': (jax_vgg, ptt_vgg),
           'googlenet': (jax_googlenet, ptt_googlenet),
           'se_resnext': (jax_se_resnext, ptt_se_resnext)}
MODELS = sorted(MODULES)
FULL = {'smallnet': {}, 'alexnet': {}, 'vgg': dict(depth=19),
        'googlenet': {}, 'se_resnext': dict(depth=50)}
SMALL = {'smallnet': dict(dshape=(3, 32, 32), class_dim=10),
         'alexnet': dict(dshape=(3, 64, 64), class_dim=10),
         'vgg': dict(dshape=(3, 32, 32), class_dim=10, depth=16),
         'googlenet': dict(dshape=(3, 64, 64), class_dim=10),
         'se_resnext': dict(dshape=(3, 64, 64), class_dim=10, depth=50)}
BATCH = {'smallnet': 4, 'alexnet': 2, 'vgg': 4, 'googlenet': 2,
         'se_resnext': 2}
STEPS = {'smallnet': 3, 'alexnet': 2, 'vgg': 2, 'googlenet': 2,
         'se_resnext': 1}
AMP_MODELS = ('vgg', 'se_resnext')
SEED = 5
SERVE_SHAPE = (3, 64, 64)
SERVE_CLASSES = 10
SERVE_BATCHES = ((2, 1), (3, 2))  # (batch, seed)
# per full-size program: (ops, batch_norm ops, concat ops, dropout ops)
CENSUS = {'smallnet': (54, 0, 0, 0), 'alexnet': (82, 0, 0, 2),
          'vgg': (182, 2, 0, 2), 'googlenet': (529, 0, 9, 1),
          'se_resnext': (875, 53, 0, 1)}


def _build(pkg, model, cfg, amp=False):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = SEED
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        mod = MODULES[model][0 if pkg is fluid else 1]
        _, _, loss, acc = mod.build_train_net(**cfg)
    if amp:
        pkg.contrib.mixed_precision.enable_bf16(main)
    return main, startup, loss, acc


def _feed(model, step):
    rng = np.random.RandomState(100 + step)
    cfg = SMALL[model]
    return {'data': rng.randn(BATCH[model], *cfg['dshape']).astype(
                np.float32),
            'label': rng.randint(0, cfg['class_dim'],
                                 (BATCH[model], 1)).astype(np.int64)}


def _masks(main):
    return [op.output('Mask')[0] for op in main.global_block().ops
            if op.type == 'dropout']


def _ops(main):
    return [(op.type, op.inputs, op.outputs)
            for op in main.global_block().ops]


def _perturbed(arrays, seed):
    """Every float array scaled by 1 + 1e-7·N(0, 1): about one f32 ulp
    (numpy's Generator: its normals come several times faster than
    RandomState's, for the tens of millions of parameters here)."""
    rng = np.random.default_rng(seed)
    return {n: (a * (1 + 1e-7 * rng.standard_normal(a.shape))).astype(
                a.dtype)
            if a.dtype.kind == 'f' else a for n, a in sorted(arrays.items())}


def _probs(main):
    return next(op.output('Out')[0] for op in main.global_block().ops
                if op.type == 'softmax')


# -- paddle_tpu's side, in fresh interpreters --------------------------------
def _jax_state(main, scope):
    return {v.name: np.array(scope.find_var(v.name).get_tensor())
            for v in main.list_vars() if v.persistable}


def _jax_program(root, model):
    """(a): the full-size program's ops, persistables and parameter shapes."""
    main = _build(fluid, model, FULL[model])[0]
    with open(os.path.join(root, model + '_program.json'), 'w') as f:
        json.dump({'ops': _ops(main),
                   'persistables': sorted(v.name for v in main.list_vars()
                                          if v.persistable),
                   'params': {p.name: list(p.shape)
                              for p in main.all_parameters()}}, f)


class _Report(object):
    """The comparisons of one job: rows (label, err, tolerance), each
    passing where err <= tolerance, and the checks that failed."""

    def __init__(self):
        self.rows, self.failed = [], []

    def check(self, cond, msg):
        if not cond:
            self.failed.append(msg)

    def hold(self, label, got, want, tol):
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape or not np.isfinite(got).all():
            self.failed.append('%s: shape %s (want %s) or not finite'
                               % (label, got.shape, want.shape))
            return
        err = float(np.abs(got.astype(np.float64) - want).max())
        self.rows.append((label, err, float(tol)))

    def save(self, root, name):
        with open(os.path.join(root, name + '.json'), 'w') as f:
            json.dump({'rows': self.rows, 'failed': self.failed}, f)


@contextlib.contextmanager
def _given_masks(masks, asked):
    """draw_dropout_keep replaced: the op whose Mask is `name` keeps where
    masks[name] != 0; build-time shape inference (the meta device) keeps
    the real function. Each name asked for is appended to `asked`."""
    real = tensor_ops.draw_dropout_keep

    def draw(ctx, shape, p):
        if ctx.device.type == 'meta':
            return real(ctx, shape, p)
        name = ctx.op.output('Mask')[0]
        asked.append(name)
        keep = torch.from_numpy(np.asarray(masks[name])) != 0
        assert tuple(keep.shape) == tuple(shape), (name, keep.shape, shape)
        return keep.to(ctx.device)

    tensor_ops.draw_dropout_keep = draw
    try:
        yield
    finally:
        tensor_ops.draw_dropout_keep = real


def _f32_job(root, model):
    """(b). paddle_tpu takes the steps on one Executor; at step i it also
    runs the update ops from the state before the step and the step's
    forward values moved by one ulp (_perturbed), at the step's count (so
    its generic dropout gradient draws the step's mask again). The port
    then takes step i from paddle_tpu's state before it, with its masks,
    and runs its update ops fed paddle_tpu's forward values, and again
    from the moved state and values. The report holds loss, accuracy, BN
    running stats, gradients, parameters and velocities."""
    main, startup, loss, acc = _build(fluid, model, SMALL[model])
    grads = _grad_names(main)
    fed_names = _update_feeds(main)
    heads = [loss.name, acc.name]
    # one fetch list for every run of main: paddle_tpu compiles a step for
    # each fetch list
    fetch = heads + grads + fed_names
    update = main.clone()
    update.global_block().ops = _update_ops(update)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    pmain = _build(ptt, model, SMALL[model])[0]
    pupdate = pmain.clone()
    pupdate.global_block().ops = _update_ops(pupdate)
    params = {p.name for p in pmain.all_parameters()}
    masks = _masks(pmain)
    report = _Report()
    report.check(set(masks) <= set(fed_names),
                 'dropout_grad does not read the Mask')
    pexe = ptt.Executor(ptt.CPUPlace())
    for i in range(STEPS[model]):
        feed = _feed(model, i)
        # every run's state set from numpy, as the moved runs' is: a state
        # the Executor left (or the startup's) can take another compile
        before = _jax_state(main, scope)
        scope = _jax_scope(before)
        with fluid.scope_guard(scope):
            want = dict(zip(fetch, exe.run(main, feed=feed,
                                           fetch_list=fetch)))
        after = _jax_state(main, scope)
        want = {n: np.asarray(a) for n, a in want.items()}
        fed = {n: want[n] for n in fed_names}
        stats = [loss.name] + [n for n in sorted(before)
                               if n.endswith(('.mean', '.variance'))]
        updated = grads + [n for n in sorted(after)
                           if n in params or '_velocity_' in n]

        def expect(n):
            return want[n] if n in want else after[n]
        # paddle_tpu's whole step and its update ops from the state and
        # values moved by one ulp, at the step's count; each kept as its
        # largest move from the unmoved run
        whole = _jax_scope(_perturbed(before, 2 * i))
        with fluid.scope_guard(whole):
            exe._step_counters[main._uid] = i
            moved = dict(zip(fetch, exe.run(
                main, feed=_perturbed(feed, 2 * i), fetch_list=fetch)))
        moved.update(_jax_state(main, whole))
        jax_noise = {n: _dist(moved[n], expect(n)) for n in stats}
        del whole, moved
        sc = _jax_scope(_perturbed(before, 2 * i))
        with fluid.scope_guard(sc):
            exe._step_counters[update._uid] = i
            moved = dict(zip(grads, exe.run(
                update, feed=_perturbed(fed, 2 * i + 1), fetch_list=grads)))
        moved.update(_jax_state(main, sc))
        jax_noise.update({n: _dist(moved[n], expect(n)) for n in updated})
        del sc, moved
        for n in masks:  # paddle_tpu drew real masks
            report.check(0 < float((want[n] != 0).mean()) < 1,
                         'step %d: mask %s keeps all or nothing' % (i, n))
        # the port's whole step from paddle_tpu's state, and from it and
        # the feed moved by one ulp, with paddle_tpu's masks
        runs = []
        for st, fd in ((before, feed), (_perturbed(before, 2 * i),
                                        _perturbed(feed, 2 * i))):
            asked = []
            pscope = ptt.Scope()
            ptt.weights.params_from_numpy(st, pmain, pscope)
            with _given_masks({n: want[n] for n in masks}, asked):
                run = dict(zip(heads, pexe.run(pmain, feed=fd,
                                               fetch_list=heads,
                                               scope=pscope)))
            report.check(sorted(asked) == sorted(masks),
                         'step %d: masks asked %s' % (i, asked))
            state = ptt.weights.state_to_numpy(pmain, pscope)
            run.update({n: state[n] for n in stats[1:]})
            runs.append(run)
            del pscope, state
        own, own_moved = runs
        report.hold('step %d accuracy' % i, own[acc.name], want[acc.name],
                    0.0)
        for n in stats:
            w = expect(n)
            noise = _dist(own_moved[n], own[n]) + jax_noise[n]
            report.hold('step %d %s' % (i, 'loss' if n == loss.name else n),
                        own[n], w,
                        max(1e-5 * float(np.abs(w).max()), 4 * noise))
        del runs, own, own_moved
        # the port's backward and Momentum fed paddle_tpu's forward values
        outs = []
        for st, fd in ((before, fed), (_perturbed(before, 2 * i),
                                       _perturbed(fed, 2 * i + 1))):
            pscope = ptt.Scope()
            ptt.weights.params_from_numpy(st, pmain, pscope)
            g = pexe.run(pupdate, feed=fd, fetch_list=grads, scope=pscope)
            out = dict(zip(grads, g))
            out.update(ptt.weights.state_to_numpy(pmain, pscope))
            outs.append(out)
            del pscope, g
        got, got_moved = outs
        for n in updated:
            w = expect(n)
            report.check(n not in grads or np.abs(w).max() > 0,
                         'step %d: %s is zero' % (i, n))
            noise = _dist(got_moved[n], got[n]) + jax_noise[n]
            report.hold('step %d %s' % (i, n), got[n], w,
                        max(1e-5 * float(np.abs(w).max()), 4 * noise))
        del outs, got, got_moved, want, fed, before
    report.save(root, model + '_f32')


def _dist(a, b):
    """The largest |a - b|."""
    return float(np.abs(np.asarray(a) - b).max())


def _pallas_bn_in_interpret_mode():
    """batch_norm on its TPU kernel's path, the Pallas kernel in interpret
    mode (tests/test_torch_training_ops.py _jax_amp_reference); a 2-D x
    goes through it as a [N, C, 1, 1] view."""
    from jax.experimental import pallas as pl
    from paddle_tpu.ops import pallas_bn
    os.environ['PTPU_PALLAS_BN'] = '1'
    pallas_bn.supported = lambda x, layout: layout == 'NCHW' and \
        x.ndim in (2, 4)
    pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    fused = pallas_bn.fused_bn_apply

    def fused_any_rank(x, k, b, act):
        if x.ndim == 2:
            return fused(x[:, :, None, None], k, b, act)[:, :, 0, 0]
        return fused(x, k, b, act)
    pallas_bn.fused_bn_apply = fused_any_rank


def _jax_scope(state):
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        for n, a in state.items():
            scope.var(n).get_tensor().set(a)
    return scope


class _Draws(object):
    """The values of the unmoved run (draw 0) and each tensor's largest
    move from them over the later draws: _noise kept as it goes."""

    def __init__(self):
        self.first, self.noise = {}, {}

    def add(self, d, values):
        for n, a in values.items():
            if d == 0:
                self.first[n], self.noise[n] = a, 0.0
            else:
                self.noise[n] = max(self.noise[n], _dist(a, self.first[n]))


def _bf16_job(root, model):
    """(c). From the initial state and from it with the parameters moved
    by one bf16 ulp (NOISE_DRAWS draws), each at step 0 of one Executor
    (so each draws the masks of step 0): paddle_tpu's whole step (loss,
    accuracy, softmax, the values the update ops read) and its update ops
    from the same state and those values (moved too in the draws), also at
    step 0 (gradients, parameters after); and the port's, from the same
    states and fed values, with paddle_tpu's masks. The report holds the
    loss, the accuracy (but for near ties), every gradient and every
    parameter's update, each within 4 times the noise of both packages
    (floor 1e-6 of its largest value)."""
    _pallas_bn_in_interpret_mode()
    main, startup, loss, acc = _build(fluid, model, SMALL[model], amp=True)
    params = sorted(p.name for p in main.all_parameters())
    grads = _grad_names(main)
    fed_names = _update_feeds(main)
    heads = [loss.name, acc.name, _probs(main)]
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    state = _jax_state(main, scope)
    del scope
    feed = _feed(model, 0)

    def delta(after, st):
        return {n: after[n].astype(np.float64) - st[n] for n in params}

    pmain = _build(ptt, model, SMALL[model], amp=True)[0]
    masks = _masks(pmain)
    pexe = ptt.Executor(ptt.CPUPlace())
    report = _Report()
    asked = []
    jax, port = _Draws(), _Draws()
    exe = fluid.Executor(fluid.CPUPlace())
    for d in range(NOISE_DRAWS + 1):
        # each draw's state and fed values, made once for both packages
        st = state if d == 0 else _bf16_moved(state, 200 + d, set(params))
        with fluid.scope_guard(_jax_scope(st)):
            exe._step_counters[main._uid] = 0
            vals = exe.run(main, feed=feed, fetch_list=heads + fed_names)
        if d == 0:
            fed = {n: _f32(np.asarray(v))
                   for n, v in zip(fed_names, vals[3:])}
            fed_dtypes = {n: np.asarray(v).dtype.name
                          for n, v in zip(fed_names, vals[3:])}
            update = _update_program(fluid, main, fed_dtypes)
            pupdate = _update_program(ptt, pmain, fed_dtypes)
        fd = fed if d == 0 else _bf16_moved(fed, 300 + d)
        out = {n: _f32(np.asarray(v)) for n, v in zip(heads, vals[:3])}
        del vals
        sc = _jax_scope(st)
        with fluid.scope_guard(sc):
            exe._step_counters[update._uid] = 0
            g = exe.run(update, feed=fd, fetch_list=grads)
        out.update({n: _f32(np.asarray(a)) for n, a in zip(grads, g)})
        out.update({'update of ' + n: a for n, a in
                    delta(_jax_state(main, sc), st).items()})
        jax.add(d, out)
        del sc, g, out
        with _given_masks({n: fed[n] for n in masks}, asked):
            pscope = ptt.Scope()
            ptt.weights.params_from_numpy(st, pmain, pscope)
            out = dict(zip(heads[:2], pexe.run(
                pmain, feed=feed, fetch_list=heads[:2], scope=pscope)))
            pscope = ptt.Scope()
            ptt.weights.params_from_numpy(st, pmain, pscope)
            g = pexe.run(pupdate, feed=fd, fetch_list=grads, scope=pscope,
                         return_numpy=False)
        report.check(all(t.dtype == torch.float32 for t in g),
                     'a gradient is not f32')
        out.update({n: _as_numpy(t) for n, t in zip(grads, g)})
        out.update({'update of ' + n: a for n, a in delta(
            ptt.weights.state_to_numpy(pmain, pscope), st).items()})
        port.add(d, out)
        del pscope, g, out, st, fd
    report.check(len(asked) == len(masks) * (NOISE_DRAWS + 1),
                 'masks asked %d times' % len(asked))
    for n in [loss.name] + grads + ['update of ' + p for p in params]:
        want = jax.first[n]
        report.check(n in (loss.name,) or n.startswith('update of ')
                     or np.abs(want).max() > 0, '%s is zero' % n)
        report.hold('loss' if n == loss.name else n, port.first[n], want,
                    max(4 * (port.noise[n] + jax.noise[n]),
                        1e-6 * float(np.abs(want).max())))
    probs = jax.first[heads[2]]
    top = np.sort(probs, axis=1)[:, ::-1]
    ulp = np.ldexp(1.0, np.frexp(top[:, 0].astype(np.float64))[1] - 8)
    ties = int(np.sum(top[:, 0] - top[:, 1] <= ulp))
    report.hold('accuracy (rows in near ties: %d)' % ties,
                float(port.first[acc.name][0]) * BATCH[model],
                float(jax.first[acc.name][0]) * BATCH[model], ties)
    report.save(root, model + '_bf16')


def _serve_feed(batch, seed):
    return np.random.RandomState(seed).randn(batch, *SERVE_SHAPE).astype(
        np.float32)


def _jax_serving(root):
    """(d): GoogLeNet's inference program, initialized and saved under
    root/googlenet_infer, and paddle_tpu's Predictor's logits from that
    directory at SERVE_BATCHES (googlenet_serving.npz)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        images = fluid.layers.data(name='data', shape=list(SERVE_SHAPE),
                                   dtype='float32')
        logits = jax_googlenet.googlenet(images, class_dim=SERVE_CLASSES,
                                         is_train=False)
    d = os.path.join(root, 'googlenet_infer')
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(d, ['data'], [logits], exe, main)
    pred = jax_create_predictor(JaxConfig(d).disable_gpu())
    served = {'batch%d' % b: np.asarray(pred.run([_serve_feed(b, s)])[0])
              for b, s in SERVE_BATCHES}
    np.savez(os.path.join(root, 'googlenet_serving.npz'), **served)


def _jax_reference(root, job):
    if job == 'serving':
        _jax_serving(root)
        return
    kind, model = job.split(':')
    if kind == 'f32':
        _jax_program(root, model)
        _f32_job(root, model)
    else:
        _bf16_job(root, model)


# the longest first, so that the pool's processes end together
JOBS = ['bf16:se_resnext', 'f32:se_resnext', 'f32:vgg', 'f32:googlenet',
        'f32:alexnet', 'bf16:vgg', 'serving', 'f32:smallnet']


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """paddle_tpu's side, each job of JOBS in a fresh interpreter (this
    file run as a script; the bf16 jobs with XLA's excess precision off),
    at most two at a time (each takes up to ~5 GB)."""
    root = str(tmp_path_factory.mktemp('jax_cnn_zoo'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    amp_env = dict(env, XLA_FLAGS=' '.join(
        f for f in (env.get('XLA_FLAGS'),
                    '--xla_allow_excess_precision=false') if f))

    def run(job):
        return subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, job],
            cwd=repo, env=amp_env if job.startswith('bf16') else env,
            capture_output=True, text=True, timeout=900)

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        results = dict(zip(JOBS, pool.map(run, JOBS)))
    for job, r in results.items():
        assert r.returncode == 0, (job, r.stdout[-4000:] + r.stderr[-4000:])
    return root


def _held(root, name):
    """Fail on any check the job's report failed, or any row whose err is
    above its tolerance; print the worst row."""
    with open(os.path.join(root, name + '.json')) as f:
        report = json.load(f)
    assert not report['failed'], report['failed'][:10]
    over = [r for r in report['rows'] if not r[1] <= r[2]]
    assert not over, over[:10]
    worst = max(report['rows'], key=lambda r: r[1] / r[2] if r[2] else 0.0)
    print('%s: %d held, worst %s' % (name, len(report['rows']), worst))
    return report['rows']


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


@pytest.mark.parametrize('model', MODELS)
def test_same_full_size_program_in_both_packages(model, jax_run):
    with open(os.path.join(jax_run, model + '_program.json')) as f:
        want = json.load(f)
    main = _build(ptt, model, FULL[model])[0]
    types = [op.type for op in main.global_block().ops]
    assert types == [t for t, _, _ in want['ops']]
    for a, (t, ins, outs) in zip(main.global_block().ops, want['ops']):
        assert json.loads(json.dumps([a.inputs, a.outputs])) == [ins, outs], t
    assert sorted(v.name for v in main.list_vars() if v.persistable) == \
        want['persistables']
    assert {p.name: list(p.shape) for p in main.all_parameters()} == \
        want['params']
    assert (len(types), types.count('batch_norm'), types.count('concat'),
            types.count('dropout')) == CENSUS[model]
    assert types.count('momentum') == len(main.all_parameters())


@pytest.mark.parametrize('model', MODELS)
def test_training_steps_match_jax_f32(model, jax_run):
    rows = _held(jax_run, model + '_f32')
    main = _build(ptt, model, SMALL[model])[0]
    labels = {r[0] for r in rows}
    for i in range(STEPS[model]):
        want = ['step %d %s' % (i, n) for n in ['loss', 'accuracy']
                + _grad_names(main)]
        assert set(want) <= labels, sorted(set(want) - labels)[:5]
        assert 'step %d %s_velocity_0' % (i, 'fc_0.w_0') in labels


@pytest.mark.parametrize('model', AMP_MODELS)
def test_bf16_step_matches_jax(model, jax_run):
    rows = _held(jax_run, model + '_bf16')
    main = _build(ptt, model, SMALL[model], amp=True)[0]
    labels = {r[0] for r in rows}
    want = ['loss'] + _grad_names(main) + [
        'update of ' + p.name for p in main.all_parameters()]
    assert set(want) <= labels, sorted(set(want) - labels)[:5]


def test_googlenet_served_from_the_jax_directory(jax_run):
    with np.load(os.path.join(jax_run, 'googlenet_serving.npz')) as f:
        served = dict(f)
    pred = create_predictor(Config(
        os.path.join(jax_run, 'googlenet_infer')).disable_gpu())
    assert pred.get_input_names() == ['data']
    types = [op.type for op in pred._program.global_block().ops]
    assert types.count('concat') == 9 and 'dropout' in types
    for batch, seed in SERVE_BATCHES:
        got, = pred.run([_serve_feed(batch, seed)])
        want = served['batch%d' % batch]
        assert got.shape == want.shape == (batch, SERVE_CLASSES)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


if __name__ == '__main__':
    torch.set_num_threads(1)  # the port's side of the job (one_thread)
    _jax_reference(sys.argv[1], sys.argv[2])
