"""bf16 mixed precision in the port (core/amp.py, contrib/mixed_precision.py),
held against paddle_tpu on the CPU.

The surface: decorate, enable_bf16 and disable_bf16 mark the program with
the reference's signatures, clone() does not carry the mark in either
package, and under the amp scope amp.matmul and amp.conv2d compute in bf16
and unify resolves a bf16/f32 pair to bf16, while outside it nothing
changes. The optimizers: under AMP every gradient that reaches an update
op is f32, and parameters and accumulators stay f32.

Whole programs, each built by both packages under a fresh
unique_name.guard() and marked for bf16, the port started from
paddle_tpu's state (weights.py):

(a) the MLP of tests/test_amp.py (fc-relu-fc, square error, SGD 0.05), 12
    steps: its AMP losses track its f32 ones as that test demands;
(b) BERT pretraining at 2 layers, d_model 64, 4 heads, S=128, vocab 97,
    batch 2, 3 Adam steps;
(c) ResNet-20 training (32x32, 10 classes, Momentum(0.1, 0.9)), batch 8,
    3 steps, each from paddle_tpu's state before it, with the backward
    and Momentum fed paddle_tpu's forward values of the step (the relu
    masks of the two forwards may differ: see
    tests/test_torch_resnet_training.py; in bf16 far more of them do).

Each is held on the dtype of every variable of its first step (identical:
bf16 activations and activation gradients, f32 parameter gradients,
statistics and losses), on the loss, on every parameter gradient and, for
(a) and (b), on every parameter's update over the steps. The tolerance of
each tensor is 4 times the bf16 one-ulp noise of both packages: the
largest move of the tensor over NOISE_DRAWS runs from the parameters (and
in (c) the fed values) moved by one bf16 ulp at each element's magnitude,
in paddle_tpu, plus the same in the port, with a floor of 1e-6 of the
tensor's largest value. (c)'s top-1 accuracy agrees but for rows whose
two largest bf16 probabilities in paddle_tpu lie within one bf16 ulp of
each other with the label among them.

What the tests take from paddle_tpu is computed once, by this file run as
a script in a fresh interpreter (as tests/test_torch_bert_training.py
does, and for its reason), with XLA's excess precision off
(--xla_allow_excess_precision=false, so each bf16 op of the jitted step
rounds as written) and batch_norm on its TPU kernel's path in interpret
mode, both for the reasons tests/test_torch_training_ops.py's
_jax_amp_reference gives. bf16 arrays cross as f32 (exactly), with their
dtype names beside them.
"""
import functools
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from models import bert as jax_bert
from models import resnet as jax_resnet

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import amp
from paddle_tpu_torch.models import bert as ptt_bert
from paddle_tpu_torch.models import resnet as ptt_resnet

NOISE_DRAWS = 3
MLP_STEPS = 12
BERT_CFG = dict(vocab=97, max_len=128, d_model=64, d_ff=128, n_head=4,
                n_layer=2, dropout=0.0, lr=1e-4)
BERT_STEPS = 3
R20 = dict(dshape=(3, 32, 32), class_dim=10, depth=20, lr=0.1)
R20_BATCH = 8
R20_STEPS = 3


# -- builders, shared by both packages ---------------------------------------
def _build_mlp(pkg, use_amp=True, seed=7):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data('x', shape=[16], dtype='float32')
        y = pkg.layers.data('y', shape=[1], dtype='float32')
        h = pkg.layers.fc(x, size=32, act='relu')
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        opt = pkg.optimizer.SGD(learning_rate=0.05)
        if use_amp:
            opt = pkg.contrib.mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def _mlp_feed():
    rng = np.random.RandomState(0)
    xs = rng.randn(64, 16).astype(np.float32)
    w = rng.randn(16, 1).astype(np.float32)
    ys = xs @ w + 0.01 * rng.randn(64, 1).astype(np.float32)
    return {'x': xs, 'y': ys}


def _build_bert(pkg, builder):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, loss = builder.build_bert_pretrain(**BERT_CFG)
    pkg.contrib.mixed_precision.enable_bf16(main)
    return main, startup, loss


def _bert_feed(seed, batch=2):
    rng = np.random.RandomState(seed)
    s, v = BERT_CFG['max_len'], BERT_CFG['vocab']
    return {'tok_ids': rng.randint(0, v, (batch, s)).astype(np.int64),
            'seg_ids': rng.randint(0, 2, (batch, s)).astype(np.int64),
            'mlm_labels': rng.randint(0, v, (batch, s)).astype(np.int64),
            'mlm_weights': (rng.rand(batch, s) < 0.15).astype(np.float32)}


def _build_r20(pkg, models):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, loss, acc = models.build_train_net(**R20)
    pkg.contrib.mixed_precision.enable_bf16(main)
    return main, startup, loss, acc


def _r20_feed(seed):
    rng = np.random.RandomState(seed)
    return {'data': rng.randn(R20_BATCH, *R20['dshape']).astype(np.float32),
            'label': rng.randint(0, R20['class_dim'],
                                 (R20_BATCH, 1)).astype(np.int64)}


def _grad_names(main):
    return sorted(p.name + '@GRAD' for p in main.all_parameters())


def _step_vars(main):
    """Every non-persistable variable the ops of a step write."""
    persist = {v.name for v in main.list_vars() if v.persistable}
    out = []
    for op in main.global_block().ops:
        for n in op.output_arg_names():
            if n and n not in persist and n not in out:
                out.append(n)
    return out


def _update_ops(main):
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


def _update_program(pkg, main, fed_dtypes):
    """The backward and update ops of `main` as a program of their own,
    marked for bf16 (clone does not carry the mark), with the fed values
    declared in their runtime dtypes."""
    update = main.clone()
    update.global_block().ops = _update_ops(update)
    pkg.contrib.mixed_precision.enable_bf16(update)
    for n, dt in fed_dtypes.items():
        update.global_block().var(n).dtype = dt
    return update


def _bf16_moved(arrays, seed, only=None):
    """Every float array (of the names in `only`, if given) moved by one
    bf16 ulp at each element's magnitude, up or down at random: a bf16
    value lands on its neighbour, an f32 parameter on a value whose bf16
    cast does."""
    rng = np.random.RandomState(seed)
    out = {}
    for n, a in sorted(arrays.items()):
        if a.dtype.kind != 'f' or (only is not None and n not in only):
            out[n] = a
            continue
        m, e = np.frexp(a.astype(np.float64))
        step = np.where(m == 0, 0.0, np.ldexp(1.0, e - 8))
        out[n] = (a + rng.choice([-1.0, 1.0], a.shape) * step).astype(
            a.dtype)
    return out


# -- paddle_tpu's side, in a fresh interpreter --------------------------------
class _Out(object):
    """Arrays saved as f32 where they are bf16 (exactly), dtypes beside."""

    def __init__(self):
        self.arrays, self.dtypes = {}, {}

    def put(self, key, value):
        a = np.asarray(value)
        self.dtypes[key] = a.dtype.name
        self.arrays[key] = (a.astype(np.float32)
                            if a.dtype.name == 'bfloat16' else a)

    def save(self, root, name):
        np.savez(os.path.join(root, name + '.npz'), **self.arrays)
        with open(os.path.join(root, name + '.json'), 'w') as f:
            json.dump(self.dtypes, f)


def _jax_state(main, scope):
    return {v.name: np.array(scope.find_var(v.name).get_tensor())
            for v in main.list_vars() if v.persistable}


def _f32(a):
    """bf16 arrays as f32 (exactly): paddle_tpu's Executor cannot take a
    numpy bf16 feed, and casts an f32 one to the var's declared bf16."""
    return a.astype(np.float32) if a.dtype.name == 'bfloat16' else a


def _jax_run(main, state, feeds, fetch):
    """paddle_tpu's steps from `state`: [fetches of each step], state."""
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        for n, a in state.items():
            scope.var(n).get_tensor().set(a)
        outs = [exe.run(main, feed={n: _f32(a) for n, a in f.items()},
                        fetch_list=fetch) for f in feeds]
    return outs, _jax_state(main, scope)


def _jax_init(main, startup):
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    return _jax_state(main, scope)


def _params(main):
    return {p.name for p in main.all_parameters()}


def _jax_steps(out, main, startup, feeds, fetch):
    """Initialize, then record the state, each step's `fetch`, the state
    after the steps, and the same from the state with its parameters moved
    by one bf16 ulp in NOISE_DRAWS draws (draw d under 'd<d>/')."""
    state = _jax_init(main, startup)
    for d in range(NOISE_DRAWS + 1):
        st = state if d == 0 else _bf16_moved(state, 100 + d, _params(main))
        steps, final = _jax_run(main, st, feeds, fetch)
        pre = 'd%d/' % d
        for i, outs in enumerate(steps):
            for n, o in zip(fetch, outs):
                out.put('%sstep%d/%s' % (pre, i, n), o)
        for n, a in st.items():
            out.put(pre + 'state/' + n, a)
        for n, a in final.items():
            out.put(pre + 'final/' + n, a)


def _jax_reference(root):
    """paddle_tpu's side of the whole-program tests, written under root:
    mlp, bert and r20 (.npz and .json each)."""
    from jax.experimental import pallas as pl
    from paddle_tpu.ops import pallas_bn
    os.environ['PTPU_PALLAS_BN'] = '1'
    pallas_bn.supported = lambda x, layout: layout == 'NCHW' and x.ndim == 4
    pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)

    out = _Out()
    main, startup, loss = _build_mlp(fluid)
    _jax_steps(out, main, startup, [_mlp_feed()] * MLP_STEPS,
               [loss.name] + _grad_names(main))
    out.put('mark', np.array(getattr(main, '_amp_bf16', False)))
    out.put('clone_mark', np.array(
        getattr(main.clone(), '_amp_bf16', False)))
    for n, o in zip(_step_vars(main), _jax_run(
            main, _jax_init(main, startup), [_mlp_feed()],
            _step_vars(main))[0][0]):
        out.put('vars/' + n, o)
    out.save(root, 'mlp')

    out = _Out()
    main, startup, loss = _build_bert(fluid, jax_bert)
    _jax_steps(out, main, startup,
               [_bert_feed(i) for i in range(BERT_STEPS)],
               [loss.name] + _grad_names(main))
    for n, o in zip(_step_vars(main), _jax_run(
            main, _jax_init(main, startup), [_bert_feed(0)],
            _step_vars(main))[0][0]):
        out.put('vars/' + n, o)
    out.save(root, 'bert')

    out = _Out()
    main, startup, loss, acc = _build_r20(fluid, jax_resnet)
    probs = next(op.output('Out')[0] for op in main.global_block().ops
                 if op.type == 'softmax')
    grads = _grad_names(main)
    fed_names = _update_feeds(main)
    fetch = [loss.name, acc.name, probs] + grads + fed_names
    state = _jax_init(main, startup)
    for i in range(R20_STEPS):
        feed = _r20_feed(i)
        for d in range(NOISE_DRAWS + 1):
            st = state if d == 0 else _bf16_moved(state, 200 + 10 * i + d,
                                                  _params(main))
            (outs,), after = _jax_run(main, st, [feed], fetch)
            vals = dict(zip(fetch, outs))
            pre = 'd%d/step%d/' % (d, i)
            for n in [loss.name, acc.name, probs] + grads:
                out.put(pre + n, vals[n])
            if d == 0:
                fed = {n: np.asarray(vals[n]) for n in fed_names}
                for n, a in fed.items():
                    out.put(pre + 'fed/' + n, a)
                for n, a in state.items():
                    out.put(pre + 'state/' + n, a)
                update = _update_program(fluid, main, {
                    n: a.dtype.name for n, a in fed.items()})
                state_after = after
                if i == 0:
                    names = _step_vars(main)
                    (allv,), _ = _jax_run(main, state, [feed], names)
                    for n, o in zip(names, allv):
                        out.put('vars/' + n, o)
            # the backward and Momentum fed the step's forward values
            fd = fed if d == 0 else _bf16_moved(
                {n: _f32(a) for n, a in fed.items()}, 300 + 10 * i + d)
            (g,), upd_state = _jax_run(update, st, [fd], grads)
            for n, a in zip(grads, g):
                out.put(pre + 'update/' + n, a)
            for n, a in upd_state.items():
                out.put(pre + 'update_state/' + n, a)
        state = state_after
    out.save(root, 'r20')


@pytest.fixture(scope='module')
def jax_amp(tmp_path_factory):
    """{'mlp' | 'bert' | 'r20': ({key: array}, {key: dtype name})} from
    paddle_tpu, computed by _jax_reference in a fresh interpreter (this
    file run as a script, with the tests' environment and XLA's excess
    precision off)."""
    root = str(tmp_path_factory.mktemp('jax_amp_reference'))
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
    for name in ('mlp', 'bert', 'r20'):
        with np.load(os.path.join(root, name + '.npz')) as f:
            arrays = dict(f)
        with open(os.path.join(root, name + '.json')) as f:
            out[name] = (arrays, json.load(f))
    return out


def _part(arrays, prefix):
    return {k[len(prefix):]: a for k, a in arrays.items()
            if k.startswith(prefix)}


# -- the port's side ----------------------------------------------------------
def _as_numpy(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _dtype_name(t):
    return str(t.dtype)[6:]


def _port_run(main, state, feeds, fetch):
    """The port's steps from `state`: [{name: tensor} of each step],
    final state."""
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(state, main, scope)
    exe = ptt.Executor(ptt.CPUPlace())
    steps = [dict(zip(fetch, exe.run(main, feed=f, fetch_list=fetch,
                                     scope=scope, return_numpy=False)))
             for f in feeds]
    return steps, ptt.weights.state_to_numpy(main, scope)


def _port_steps(main, state, feeds, fetch):
    """The port's steps from paddle_tpu's state and from it with its
    parameters moved in NOISE_DRAWS draws (the same draws as
    paddle_tpu's): {draw: (steps, start state, final state)}."""
    out = {}
    for d in range(NOISE_DRAWS + 1):
        st = state if d == 0 else _bf16_moved(state, 100 + d, _params(main))
        steps, final = _port_run(main, st, feeds, fetch)
        out[d] = ([{n: _as_numpy(t) for n, t in s.items()} for s in steps],
                  st, final)
    return out


def _noise(draws):
    """The largest move of a tensor over the draws: draws[0] is the run
    from the state, draws[1:] from the moved states."""
    return max(float(np.abs(m - draws[0]).max()) for m in draws[1:])


def _hold(name, got, want, noise):
    """got within 4 times the noise (paddle_tpu's plus the port's), never
    below 1e-6 of the largest |want|; returns err / tolerance."""
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    err = float(np.abs(got.astype(np.float64) - want).max())
    tol = max(4 * noise, 1e-6 * float(np.abs(want).max()))
    assert err <= tol, '%s: %r > %r (noise %r, largest %r)' % (
        name, err, tol, noise, float(np.abs(want).max()))
    return err / tol


def _same_dtypes(main, state, feed, dtypes):
    """Every variable of the port's first step has paddle_tpu's dtype
    (integers as any integer: paddle_tpu carries int64 as int32)."""
    names = _step_vars(main)
    (got,), _ = _port_run(main, state, [feed], names)
    ints = {'int32', 'int64'}
    bad = [(n, _dtype_name(got[n]), dtypes['vars/' + n]) for n in names
           if _dtype_name(got[n]) != dtypes['vars/' + n]
           and not {_dtype_name(got[n]), dtypes['vars/' + n]} <= ints]
    assert not bad, bad[:10]
    kinds = {dtypes['vars/' + n] for n in names}
    assert 'bfloat16' in kinds and 'float32' in kinds, kinds
    return got


def _check_steps(jax, main, feeds, fetch, losses_only=()):
    """Hold the port's steps from paddle_tpu's state against paddle_tpu's:
    every fetched tensor of every step and every parameter's update."""
    arrays, dtypes = jax
    state = _part(arrays, 'd0/state/')
    port = _port_steps(main, state, feeds, fetch)
    params = {p.name for p in main.all_parameters()}
    worst = 0.0
    for i in range(len(feeds)):
        for n in fetch:
            want = arrays['d0/step%d/%s' % (i, n)]
            assert dtypes['d0/step%d/%s' % (i, n)] == 'float32', n
            jnoise = _noise([arrays['d%d/step%d/%s' % (d, i, n)]
                             for d in range(NOISE_DRAWS + 1)])
            pnoise = _noise([port[d][0][i][n]
                             for d in range(NOISE_DRAWS + 1)])
            worst = max(worst, _hold('step %d %s' % (i, n),
                                     port[0][0][i][n], want,
                                     jnoise + pnoise))
    for n in sorted(params):
        def update(final, start):
            return final[n].astype(np.float64) - start[n]
        want = update(_part(arrays, 'd0/final/'), state)
        jnoise = _noise([update(_part(arrays, 'd%d/final/' % d),
                                _part(arrays, 'd%d/state/' % d))
                         for d in range(NOISE_DRAWS + 1)])
        pnoise = _noise([update(port[d][2], port[d][1])
                         for d in range(NOISE_DRAWS + 1)])
        got = update(port[0][2], state)
        worst = max(worst, _hold('update of ' + n, got, want,
                                 jnoise + pnoise))
        assert port[0][2][n].dtype == np.float32, n
    for n, a in port[0][2].items():
        assert a.dtype == np.float32 or a.dtype.kind != 'f', n
    return port, worst


# -- the surface --------------------------------------------------------------
def test_decorate_enable_disable_mark_the_program():
    main, _, _ = _build_mlp(ptt)
    assert main._amp_bf16 is True
    plain, _, _ = _build_mlp(ptt, use_amp=False)
    assert getattr(plain, '_amp_bf16', False) is False
    mp = ptt.contrib.mixed_precision
    assert mp.enable_bf16(plain) is plain and plain._amp_bf16 is True
    assert mp.disable_bf16(plain) is plain and plain._amp_bf16 is False
    with ptt.program_guard(plain, ptt.Program()):
        assert mp.enable_bf16() is plain and plain._amp_bf16 is True
    assert ptt.contrib.mixed_precision is mp


def test_clone_does_not_carry_the_mark_in_either_package():
    for pkg in (ptt, fluid):
        main, _, _ = _build_mlp(pkg)
        assert main._amp_bf16 is True
        assert not getattr(main.clone(), '_amp_bf16', False), pkg.__name__
        assert not getattr(main.clone(for_test=True), '_amp_bf16', False)


def test_surface_signatures_match_the_reference():
    from paddle_tpu.contrib import mixed_precision as ref
    mp = ptt.contrib.mixed_precision
    for name in ('decorate', 'enable_bf16', 'disable_bf16'):
        assert inspect.signature(getattr(mp, name)) == \
            inspect.signature(getattr(ref, name)), name
    assert inspect.signature(mp.OptimizerWithMixedPrecision.minimize) == \
        inspect.signature(ref.OptimizerWithMixedPrecision.minimize)
    opt = mp.decorate(ptt.optimizer.SGD(learning_rate=0.1))
    assert isinstance(opt, mp.OptimizerWithMixedPrecision)
    assert opt.type == 'sgd'  # attributes reach the wrapped optimizer


def test_matmul_and_conv2d_are_bf16_under_the_scope():
    x = torch.randn(4, 8)
    w = torch.randn(8, 3, requires_grad=True)
    img = torch.randn(2, 3, 6, 6)
    f = torch.randn(4, 3, 3, 3, requires_grad=True)
    assert not amp.enabled()
    assert amp.matmul(x, w).dtype == torch.float32
    assert amp.conv2d(img, f, padding=1).dtype == torch.float32
    # preferred_element_type keeps jnp.matmul's meaning outside the scope
    out = amp.matmul(x.bfloat16(), w, preferred_element_type=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    with amp.scope(True):
        assert amp.enabled()
        y = amp.matmul(x, w)
        c = amp.conv2d(img, f, padding=1)
        assert y.dtype == c.dtype == torch.bfloat16
        # the cast's transpose hands the f32 parameters f32 gradients
        gw, gf = torch.autograd.grad((y.float().sum(), c.float().sum()),
                                     (w, f))
        assert gw.dtype == gf.dtype == torch.float32
        with amp.scope(False):
            assert amp.matmul(x, w).dtype == torch.float32
        # integer operands are left alone
        i = torch.ones(2, 2, dtype=torch.int64)
        assert amp.matmul(i, i).dtype == torch.int64
    assert not amp.enabled()


def test_unify_acts_only_under_the_scope():
    b = torch.ones(3, dtype=torch.bfloat16)
    f = torch.ones(3)
    assert [t.dtype for t in amp.unify(b, f)] == [torch.bfloat16,
                                                  torch.float32]
    with amp.scope(True):
        assert [t.dtype for t in amp.unify(b, f)] == [torch.bfloat16] * 2
        assert [t.dtype for t in amp.unify(f, f)] == [torch.float32] * 2
        i = torch.ones(3, dtype=torch.int64)
        assert [t.dtype for t in amp.unify(b, i)] == [torch.bfloat16,
                                                      torch.int64]
    assert amp.promote_f32(b).dtype == torch.float32
    assert amp.promote_f32(f) is f
    assert amp.restore(f, b).dtype == torch.bfloat16
    assert amp.restore(f, f) is f


def test_shape_inference_stays_f32_under_the_scope():
    """Build-time shape inference runs outside the amp scope: declared
    dtypes stay f32, as in the reference, even for a program built while
    the scope is on."""
    with amp.scope(True):
        main, _, loss = _build_mlp(ptt)
    mul_outs = [op.output('Out')[0] for op in main.global_block().ops
                if op.type == 'mul']
    assert mul_outs
    for n in mul_outs + [loss.name]:
        assert main.global_block().var(n).dtype == 'float32', n


@pytest.mark.parametrize('model', ['bert', 'resnet20'])
def test_update_ops_get_f32_gradients_and_state_stays_f32(model,
                                                          monkeypatch):
    """Under AMP every gradient that reaches an Adam or Momentum op is f32,
    and parameters and accumulators stay f32 after the steps."""
    from paddle_tpu_torch.core import registry
    if model == 'bert':
        main, startup, loss = _build_bert(ptt, ptt_bert)
        feed, kind = _bert_feed(0), 'adam'
    else:
        main, startup, loss, _ = _build_r20(ptt, ptt_resnet)
        feed, kind = _r20_feed(0), 'momentum'
    seen = []
    opdef = registry.get(kind)
    lower = opdef.lower

    def spy(ctx, ins):
        seen.append((ins['Grad'][0].dtype, ins['Param'][0].dtype))
        return lower(ctx, ins)
    monkeypatch.setattr(opdef, 'lower', spy)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert len(seen) == 2 * len(main.all_parameters())
    assert set(seen) == {(torch.float32, torch.float32)}
    state = ptt.weights.state_to_numpy(main, scope)
    assert all(a.dtype == np.float32 for a in state.values()
               if a.dtype.kind == 'f')


# -- whole programs -----------------------------------------------------------
def test_mlp_amp_tracks_f32_and_matches_jax(jax_amp):
    arrays, dtypes = jax_amp['mlp']
    assert bool(arrays['mark']) and not bool(arrays['clone_mark'])
    main, _, loss = _build_mlp(ptt)
    state = _part(arrays, 'd0/state/')
    _same_dtypes(main, state, _mlp_feed(), dtypes)
    fetch = [loss.name] + _grad_names(main)
    port, worst = _check_steps(jax_amp['mlp'], main,
                               [_mlp_feed()] * MLP_STEPS, fetch)
    print('mlp AMP: worst err/tolerance %.3f' % worst)
    # the reference's own rule (tests/test_amp.py) on the port's losses
    bf16 = [float(s[loss.name][0]) for s in port[0][0]]
    f32_main, _, f32_loss = _build_mlp(ptt, use_amp=False)
    f32 = [float(s[f32_loss.name][0]) for s in _port_run(
        f32_main, state, [_mlp_feed()] * MLP_STEPS, [f32_loss.name])[0]]
    assert f32[-1] < f32[0] * 0.7
    assert bf16[-1] < bf16[0] * 0.7
    assert abs(bf16[-1] - f32[-1]) < 0.25 * max(abs(f32[0]), 1.0)


def test_bert_amp_steps_match_jax(jax_amp):
    arrays, dtypes = jax_amp['bert']
    main, _, loss = _build_bert(ptt, ptt_bert)
    got = _same_dtypes(main, _part(arrays, 'd0/state/'), _bert_feed(0),
                       dtypes)
    types = {op.type: op for op in main.global_block().ops}
    q = types['fused_multihead_attention'].input('Q')[0]
    assert got[q].dtype == torch.bfloat16  # K2 takes bf16
    fetch = [loss.name] + _grad_names(main)
    port, worst = _check_steps(jax_amp['bert'], main,
                               [_bert_feed(i) for i in range(BERT_STEPS)],
                               fetch)
    print('bert AMP: worst err/tolerance %.3f' % worst)
    losses = [float(s[loss.name][0]) for s in port[0][0]]
    assert losses[-1] < losses[0]


def _near_ties(probs, label):
    """Rows whose two largest probabilities lie within one bf16 ulp of
    each other with the label's among them: top-1 may break the tie
    either way."""
    top = np.sort(probs, axis=1)[:, ::-1]
    m, e = np.frexp(top[:, 0].astype(np.float64))
    ulp = np.ldexp(1.0, e - 8)
    lab = probs[np.arange(len(label)), label.reshape(-1)]
    return int(np.sum((top[:, 0] - top[:, 1] <= ulp)
                      & (top[:, 0] - lab <= ulp)))


def test_resnet20_amp_steps_match_jax(jax_amp):
    arrays, dtypes = jax_amp['r20']
    main, _, loss, acc = _build_r20(ptt, ptt_resnet)
    probs = next(op.output('Out')[0] for op in main.global_block().ops
                 if op.type == 'softmax')
    grads = _grad_names(main)
    fed_names = _update_feeds(main)
    got = _same_dtypes(main, _part(arrays, 'd0/step0/state/'),
                       _r20_feed(0), dtypes)
    bn = next(op for op in main.global_block().ops
              if op.type == 'batch_norm')
    assert got[bn.input('X')[0]].dtype == torch.bfloat16  # K1 takes bf16
    params = {p.name for p in main.all_parameters()}
    worst = 0.0
    for i in range(R20_STEPS):
        pre = 'd0/step%d/' % i
        state = _part(arrays, pre + 'state/')
        feed = _r20_feed(i)
        # the whole step: loss and accuracy
        runs = []
        for d in range(NOISE_DRAWS + 1):
            st = state if d == 0 else _bf16_moved(state, 200 + 10 * i + d,
                                                  params)
            (s,), _ = _port_run(main, st, [feed], [loss.name, acc.name,
                                                   probs])
            runs.append({n: _as_numpy(t) for n, t in s.items()})
        noise = _noise([r[loss.name] for r in runs]) + _noise(
            [arrays['d%d/step%d/%s' % (d, i, loss.name)]
             for d in range(NOISE_DRAWS + 1)])
        worst = max(worst, _hold('step %d loss' % i, runs[0][loss.name],
                                 arrays[pre + loss.name], noise))
        ties = _near_ties(arrays[pre + probs], feed['label'])
        assert abs(float(runs[0][acc.name][0])
                   - float(arrays[pre + acc.name][0])) * R20_BATCH \
            <= ties + 1e-6, (i, ties)
        # the backward and Momentum fed paddle_tpu's forward values
        fed = _part(arrays, pre + 'fed/')
        fed_dtypes = {n: dtypes[pre + 'fed/' + n] for n in fed_names}
        update = _update_program(ptt, main, fed_dtypes)
        outs = []
        for d in range(NOISE_DRAWS + 1):
            st, fd = state, fed
            if d:
                st = _bf16_moved(state, 200 + 10 * i + d, params)
                fd = _bf16_moved(fed, 300 + 10 * i + d)
            (g,), after = _port_run(update, st, [fd], grads)
            outs.append(({n: _as_numpy(t) for n, t in g.items()}, after))
        for n in grads:
            assert dtypes[pre + 'update/' + n] == 'float32', n
            assert outs[0][0][n].dtype == np.float32, n
            want = arrays[pre + 'update/' + n]
            assert np.abs(want).max() > 0, n
            noise = _noise([o[0][n] for o in outs]) + _noise(
                [arrays['d%d/step%d/update/%s' % (d, i, n)]
                 for d in range(NOISE_DRAWS + 1)])
            worst = max(worst, _hold('step %d %s' % (i, n), outs[0][0][n],
                                     want, noise))
        for n in sorted(params):
            want = arrays[pre + 'update_state/' + n].astype(np.float64) \
                - state[n]
            noise = _noise([o[1][n].astype(np.float64) - st_n for o, st_n in
                            zip(outs, [state[n]] + [
                                _bf16_moved(state, 200 + 10 * i + d,
                                            params)[n]
                                for d in range(1, NOISE_DRAWS + 1)])])
            noise += _noise([
                arrays['d%d/step%d/update_state/%s' % (d, i, n)]
                .astype(np.float64) - (state[n] if d == 0 else _bf16_moved(
                    state, 200 + 10 * i + d, params)[n])
                for d in range(NOISE_DRAWS + 1)])
            worst = max(worst, _hold(
                'step %d update of %s' % (i, n),
                outs[0][1][n].astype(np.float64) - state[n], want, noise))
    print('resnet20 AMP: worst err/tolerance %.3f' % worst)


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
