"""The stacked-LSTM rows' modules, the port held against paddle_tpu on the
CPU: the reduce family, cudnn_lstm's plain version, and a narrow
models.stacked_lstm model trained in f32 and in bf16 AMP.

- reduce_sum/mean/max/min/prod: each lowering called on the same numpy
  input with the same attrs (dims, negative dims, keep_dim, reduce_all,
  ties) in both packages, and its gradient (jax.vjp in the reference,
  torch autograd in the port, the generic grad's rules) for one fixed
  cotangent: within 1e-6 of the largest value.
- cudnn_lstm (2 layers, H 16, seq 8, batch 4, input 12): the forward
  (Out, LastH, LastC) and the gradient of every input and weight, per
  layer and fused, without and with dropout (p 0.25, the reference's
  keep masks given to the port's draw_lstm_keep): f32 within 1e-5 of the
  largest value.
- build_stacked_lstm_train(4, vocab 500, emb 32, hidden 32, seq 8): the
  same program op for op and the same flops_per_batch; from
  paddle_tpu's initial state, 3 Adam steps in f32 (losses and every
  persistable within 1e-5 of its largest value); one bf16 AMP step
  (enable_bf16) whose loss and parameter gradients are held as
  tests/test_torch_amp.py holds a whole AMP step: within 4 times the
  one-bf16-ulp noise of both packages (NOISE_DRAWS draws a side, the
  parameters moved), never less than 1e-6 of the largest value.

What the tests take from paddle_tpu is computed once, by this file run as
a script in a fresh interpreter (as tests/test_torch_bert_training.py
does, and for its reason), with XLA's excess precision off, as
tests/test_torch_training_ops.py's _jax_amp_reference runs the
reference's bf16 ops.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.contrib import mixed_precision
from paddle_tpu_torch.core import registry as ptt_registry
from paddle_tpu_torch.ops import rnn_ops
from paddle_tpu_torch.models import stacked_lstm as ptt_lstm

# (op type, x shape, attrs, tied input)
REDUCE_CASES = {
    'sum-dim1': ('reduce_sum', (3, 4, 5), dict(dim=[1]), False),
    'sum-neg-keep': ('reduce_sum', (3, 4, 5), dict(dim=[-1, 0],
                                                   keep_dim=True), False),
    'sum-all': ('reduce_sum', (3, 4, 5), dict(reduce_all=True), False),
    'mean-dim0': ('reduce_mean', (6, 4, 5), dict(dim=[0]), False),
    'mean-all-keep': ('reduce_mean', (3, 4), dict(reduce_all=True,
                                                  keep_dim=True), False),
    'max-dim2': ('reduce_max', (3, 4, 5), dict(dim=[2]), False),
    'max-ties': ('reduce_max', (3, 4, 5), dict(dim=[1, 2]), True),
    'max-all-ties': ('reduce_max', (4, 6), dict(reduce_all=True), True),
    'min-ties-keep': ('reduce_min', (3, 4, 5), dict(dim=[0],
                                                    keep_dim=True), True),
    'prod-dim1': ('reduce_prod', (3, 4, 5), dict(dim=[1]), False),
    'prod-dims': ('reduce_prod', (3, 4, 5), dict(dim=[0, 2]), False),
}
LSTM = dict(seq=8, batch=4, din=12, hidden=16, layers=2)
LSTM_CASES = {'layers': (False, 0.0), 'fused': (True, 0.0),
              'layers-dropout': (False, 0.25), 'fused-dropout': (True, 0.25)}
MODEL = dict(vocab=500, emb_dim=32, hidden=32, seq_len=8)
BATCH = 4
STEPS = 3
NOISE_DRAWS = 3


def _reduce_input(shape, tied, seed):
    rng = np.random.RandomState(seed)
    if tied:  # few distinct values: ties in every reduced slice
        return rng.randint(-2, 3, shape).astype(np.float32) * 0.5
    # positive: a sum is then held to 1e-6 of its own size, no cancellation
    return (rng.rand(*shape) + 0.5).astype(np.float32)


def _reduce_cot(out_shape, seed):
    return np.asarray(np.random.RandomState(seed).randn(*out_shape),
                      np.float32)


def _lstm_inputs():
    rng = np.random.RandomState(3)
    s, b, d, h, n = (LSTM[k] for k in ('seq', 'batch', 'din', 'hidden',
                                        'layers'))
    r = lambda *shape: (rng.randn(*shape) * 0.3).astype(np.float32)  # noqa
    return dict(x=r(s, b, d), h0=r(n, b, h), c0=r(n, b, h),
                wx=[r(d, 4 * h)] + [r(h, 4 * h) for _ in range(n - 1)],
                wh=[r(h, 4 * h) for _ in range(n)],
                bias=[r(4 * h) for _ in range(n)],
                cot=[r(s, b, h), r(n, b, h), r(n, b, h)])


def _lstm_flat(inp):
    """The differentiated inputs in one order: x, h0, c0, wx..., wh...,
    bias..."""
    return [inp['x'], inp['h0'], inp['c0']] + inp['wx'] + inp['wh'] + \
        inp['bias']


def _lstm_ins(flat):
    n = LSTM['layers']
    return {'Input': [flat[0]], 'InitH': [flat[1]], 'InitC': [flat[2]],
            'WeightX': list(flat[3:3 + n]),
            'WeightH': list(flat[3 + n:3 + 2 * n]),
            'Bias': list(flat[3 + 2 * n:3 + 3 * n])}


def _lstm_attrs(fused, p):
    return {'num_layers': LSTM['layers'], 'hidden_size': LSTM['hidden'],
            'is_bidirec': False, 'dropout_prob': p, 'is_test': False,
            'fuse_layers': fused}


class _Ctx(object):
    """The part of a lowering's ctx these ops read: attrs, is_test, rng and
    the device."""

    def __init__(self, attrs, rng=None, device=None):
        self.attrs = attrs
        self.is_test = bool(attrs.get('is_test', False))
        self._rng = rng
        self.device = device

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def rng(self):
        return self._rng


def _build(pkg, builder):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        ids, label, loss, flops = builder.build_stacked_lstm_train(
            BATCH, **MODEL)
    return main, startup, loss, flops


def _feed(seed):
    rng = np.random.RandomState(seed)
    return {'ids': rng.randint(1, MODEL['vocab'],
                               (BATCH, MODEL['seq_len'])).astype(np.int64),
            'label': rng.randint(0, 2, (BATCH, 1)).astype(np.int64)}


def _grad_names(main):
    return sorted(p.name + '@GRAD' for p in main.all_parameters())


def _ulp_bf16(x):
    m, e = np.frexp(np.asarray(x, np.float64))
    return np.where(m == 0, 0.0, np.ldexp(1.0, e - 8))


def _moved(state, params, seed):
    """The parameters moved by one bf16 ulp at each element's magnitude, up
    or down at random; the rest of the state as it is."""
    rng = np.random.RandomState(seed)
    return {n: (a + rng.choice([-1.0, 1.0], a.shape) * _ulp_bf16(a)).astype(
        a.dtype) if n in params else a for n, a in state.items()}


def _jax_state(main, scope):
    return {v.name: np.array(scope.find_var(v.name).get_tensor())
            for v in main.list_vars() if v.persistable}


def _jax_reference(root):
    """paddle_tpu's side, written to root/ref.npz and root/ref.json."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu as fluid
    from paddle_tpu.contrib import mixed_precision as ref_mp
    from paddle_tpu.core import registry
    from models import stacked_lstm as jax_lstm

    arrays, meta = {}, {}
    for cid, (op, shape, attrs, tied) in sorted(REDUCE_CASES.items()):
        x = _reduce_input(shape, tied, 1)
        lower = registry.get(op).lower
        fn = lambda a: lower(_Ctx(attrs), {'X': [a]})['Out'][0]  # noqa
        out, vjp = jax.vjp(fn, jnp.asarray(x))
        arrays['reduce/%s/out' % cid] = np.asarray(out)
        arrays['reduce/%s/dx' % cid] = np.asarray(
            vjp(jnp.asarray(_reduce_cot(out.shape, 2)))[0])

    def out_and_vjp(fn, args, cot):
        outs, vjp = jax.vjp(fn, *args)
        return outs, vjp(cot)

    inp = _lstm_inputs()
    lower = registry.get('cudnn_lstm').lower
    for cid, (fused, p) in sorted(LSTM_CASES.items()):
        key = jax.random.PRNGKey(7)
        ctx = _Ctx(_lstm_attrs(fused, p), rng=key)

        def fn(*flat):
            outs = lower(ctx, _lstm_ins(flat))
            return outs['Out'][0], outs['LastH'][0], outs['LastC'][0]
        # one jitted program a case (op by op, each primitive compiles)
        outs, grads = jax.jit(lambda args, cot: out_and_vjp(fn, args, cot))(
            [jnp.asarray(a) for a in _lstm_flat(inp)],
            tuple(jnp.asarray(c) for c in inp['cot']))
        for j, o in enumerate(outs):
            arrays['lstm/%s/out%d' % (cid, j)] = np.asarray(o)
        for j, g in enumerate(grads):
            arrays['lstm/%s/grad%d' % (cid, j)] = np.asarray(g)
        if p:  # the masks the reference drew: the same key splits
            h = LSTM['hidden']
            for layer in range(LSTM['layers'] - 1):
                key, sub = jax.random.split(key)
                arrays['lstm/%s/keep%d' % (cid, layer)] = np.asarray(
                    jax.random.bernoulli(sub, 1.0 - p,
                                         (LSTM['seq'], LSTM['batch'], h)))

    main, startup, loss, flops = _build(fluid, jax_lstm)
    meta['ops'] = [(op.type, op.inputs, op.outputs)
                   for op in main.global_block().ops]
    meta['flops'] = flops
    # each run's state set from numpy, one fetch list a program: the
    # Executor then compiles each program once
    exe = fluid.Executor(fluid.CPUPlace())

    def run(program, st, feed, fetch):
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            for n, a in st.items():
                scope.var(n).get_tensor().set(a)
            outs = exe.run(program, feed=feed, fetch_list=fetch)
            return outs, _jax_state(program, scope)

    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        state = _jax_state(main, scope)
    st = state
    for i in range(STEPS):
        (out,), st = run(main, st, _feed(i), [loss])
        arrays['f32/loss%d' % i] = np.asarray(out)
    arrays.update({'state/' + n: a for n, a in state.items()})
    arrays.update({'final/' + n: a for n, a in st.items()})

    # one bf16 step from the initial state, and from it with the
    # parameters moved by one bf16 ulp, NOISE_DRAWS times
    main, startup, loss, _ = _build(fluid, jax_lstm)
    ref_mp.enable_bf16(main)
    fetch = [loss.name] + _grad_names(main)
    params = {p.name for p in main.all_parameters()}
    for draw in range(NOISE_DRAWS + 1):
        outs, _ = run(main, state if draw == 0 else
                      _moved(state, params, 40 + draw), _feed(0), fetch)
        for j, o in enumerate(outs):
            arrays['bf16/%d/%d' % (draw, j)] = np.asarray(o).astype(
                np.float32)
    np.savez(os.path.join(root, 'ref.npz'), **arrays)
    with open(os.path.join(root, 'ref.json'), 'w') as f:
        json.dump(meta, f)


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('jax_lstm'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    env['XLA_FLAGS'] = ' '.join(
        f for f in (env.get('XLA_FLAGS'),
                    '--xla_allow_excess_precision=false') if f)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with np.load(os.path.join(root, 'ref.npz')) as f:
        arrays = dict(f)
    with open(os.path.join(root, 'ref.json')) as f:
        arrays['meta'] = json.load(f)
    return arrays


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


def _close(name, got, want, rel):
    got = np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        name, got.shape, got.dtype, want.shape, want.dtype)
    top = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * top, '%s: %r > %r of %r' % (name, err, rel, top)


@pytest.mark.parametrize('cid', sorted(REDUCE_CASES))
def test_reduce_matches_jax(cid, ref):
    op, shape, attrs, tied = REDUCE_CASES[cid]
    x = torch.tensor(_reduce_input(shape, tied, 1), requires_grad=True)
    out = ptt_registry.get(op).lower(_Ctx(attrs), {'X': [x]})['Out'][0]
    dx, = torch.autograd.grad(out, x, torch.tensor(
        _reduce_cot(tuple(out.shape), 2)))
    _close(cid + ' out', out.detach().numpy(),
           ref['reduce/%s/out' % cid], 1e-6)
    _close(cid + ' dx', dx.numpy(), ref['reduce/%s/dx' % cid], 1e-6)


@pytest.mark.parametrize('cid', sorted(LSTM_CASES))
def test_cudnn_lstm_plain_matches_jax(cid, ref, monkeypatch):
    fused, p = LSTM_CASES[cid]
    inp = _lstm_inputs()
    if p:
        keeps = [torch.from_numpy(ref['lstm/%s/keep%d' % (cid, layer)])
                 for layer in range(LSTM['layers'] - 1)]
        monkeypatch.setattr(rnn_ops, 'draw_lstm_keep',
                            lambda ctx, shape, p, n: keeps)
    flat = [torch.tensor(a, requires_grad=True) for a in _lstm_flat(inp)]
    ctx = _Ctx(_lstm_attrs(fused, p), device=torch.device('cpu'))
    outs = ptt_registry.get('cudnn_lstm').lower(ctx, _lstm_ins(flat))
    outs = [outs[k][0] for k in ('Out', 'LastH', 'LastC')]
    grads = torch.autograd.grad(outs, flat,
                                [torch.tensor(c) for c in inp['cot']])
    for j, o in enumerate(outs):
        _close('%s out%d' % (cid, j), o.detach().numpy(),
               ref['lstm/%s/out%d' % (cid, j)], 1e-5)
    for j, g in enumerate(grads):
        _close('%s grad%d' % (cid, j), g.numpy(),
               ref['lstm/%s/grad%d' % (cid, j)], 1e-5)


def test_cudnn_route_layout_matches_plain():
    """The cuDNN route's weight layout (transposed, the bias as b_ih, a
    zero b_hh, one buffer) through torch's own LSTM on the CPU
    (torch._VF.lstm runs it there without cuDNN), per layer with the
    masks between and in one call: Out, LastH, LastC and every gradient
    within 1e-5 of the plain version's largest value."""
    inp = _lstm_inputs()
    n = LSTM['layers']
    for keeps in (None, [torch.rand(LSTM['seq'], LSTM['batch'],
                                    LSTM['hidden'],
                                    generator=torch.Generator().manual_seed(
                                        5)) < 0.75]):
        runs = []
        for route in (rnn_ops.lstm_plain, rnn_ops.lstm_cudnn):
            flat = [torch.tensor(a, requires_grad=True)
                    for a in _lstm_flat(inp)]
            ins = _lstm_ins(flat)
            outs = route(flat[0], flat[1], flat[2], ins['WeightX'],
                         ins['WeightH'], ins['Bias'], n, 1, keeps, 0.25)
            grads = torch.autograd.grad(
                list(outs), flat, [torch.tensor(c) for c in inp['cot']])
            runs.append([o.detach().numpy() for o in outs]
                        + [g.numpy() for g in grads])
        for j, (g, w) in enumerate(zip(runs[1], runs[0])):
            _close('cudnn route %d' % j, g, w, 1e-5)


def test_same_program_and_flops(ref):
    main, _, _, flops = _build(ptt, ptt_lstm)
    ops = [(op.type, op.inputs, op.outputs)
           for op in main.global_block().ops]
    assert json.loads(json.dumps(ops)) == ref['meta']['ops']
    assert flops == ref['meta']['flops']


def _state(ref, key):
    return {n.split('/', 1)[1]: a for n, a in ref.items()
            if n.startswith(key + '/')}


def test_f32_adam_steps_match_jax(ref):
    main, startup, loss, _ = _build(ptt, ptt_lstm)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    ptt.weights.params_from_numpy(_state(ref, 'state'), main, scope)
    for i in range(STEPS):
        got, = exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
        _close('loss%d' % i, got, ref['f32/loss%d' % i], 1e-5)
    final = ptt.weights.state_to_numpy(main, scope)
    want = _state(ref, 'final')
    assert sorted(final) == sorted(want)
    for n in sorted(want):
        _close(n, final[n].astype(want[n].dtype), want[n], 1e-5)


def test_bf16_step_matches_jax(ref):
    main, startup, loss, _ = _build(ptt, ptt_lstm)
    mixed_precision.enable_bf16(main)
    fetch = [loss.name] + _grad_names(main)
    params = {p.name for p in main.all_parameters()}
    state = _state(ref, 'state')
    exe = ptt.Executor(ptt.CPUPlace())
    runs = []
    for i in range(NOISE_DRAWS + 1):
        scope = ptt.Scope()
        st = state if i == 0 else _moved(state, params, 40 + i)
        ptt.weights.params_from_numpy(st, main, scope)
        outs = exe.run(main, feed=_feed(0), fetch_list=fetch, scope=scope,
                       return_numpy=False)
        runs.append([o.float().numpy() for o in outs])
    worst = 0.0
    for j, name in enumerate(fetch):
        want = ref['bf16/0/%d' % j]
        got = runs[0][j]
        assert got.shape == want.shape, (name, got.shape, want.shape)
        noise = (max(float(np.abs(r[j] - got).max()) for r in runs[1:])
                 + max(float(np.abs(ref['bf16/%d/%d' % (i, j)] - want).max())
                       for i in range(1, NOISE_DRAWS + 1)))
        tol = max(4 * noise, 1e-6 * float(np.abs(want).max()))
        err = float(np.abs(got - want).max())
        assert err <= tol, '%s: %r > %r (noise %r)' % (name, err, tol, noise)
        worst = max(worst, err / tol)
    print('stacked-LSTM bf16 step: worst err/tolerance %.3f' % worst)


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
