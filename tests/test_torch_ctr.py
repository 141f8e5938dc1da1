"""The CTR row's modules, the port held against paddle_tpu on the CPU:
SelectedRows (core/selected_rows.py), the sparse lookup_table_grad, the
sparse optimizer branches and a narrow models.deepfm model.

- SelectedRowsVal: merged() (duplicates summed into the run's slot, the
  freed slots parked at row == height, N kept), to_dense() and
  concat_rows, on rows with duplicates: equal to the reference's, bit for
  bit (the same additions in the same order).
- lookup_table_grad with is_sparse (a padding_idx among the ids, a
  repeated id): the rows and values equal the reference's; its dense
  branch equals the densified sparse one.
- sgd, momentum and adam (lazy_mode and not) on a SelectedRows gradient
  with duplicate rows: every output within 1e-6 of its largest value, and
  with lazy_mode (and momentum and sgd) every row the gradient does not
  touch bit for bit unchanged.
- build_deepfm_train(4 fields, vocab 1000, embed 4, DNN 16x2): the same
  program op for op; from paddle_tpu's initial state, 3 lazy-Adam steps
  at batch 16: the losses, both tables (fm_v, fm_w1) and their Adam
  moments within 1e-6 of each tensor's largest value, their untouched
  rows exactly equal to the reference's (the initial ones), and every
  other persistable within 1e-5.

What the tests take from paddle_tpu is computed once, by this file run as
a script in a fresh interpreter (as tests/test_torch_bert_training.py
does, and for its reason).
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import registry as ptt_registry
from paddle_tpu_torch.core.selected_rows import SelectedRowsVal, concat_rows
from paddle_tpu_torch.models import deepfm as ptt_deepfm

HEIGHT = 10
ROWS = np.array([5, 2, 5, 9, 2, 5, 0], np.int64)
ROWS2 = np.array([9, 1, 2], np.int64)
IDS = np.array([[3, 7, 3], [1, 7, 4]], np.int64)   # 3 is padding_idx
PAD = 3
MODEL = dict(num_fields=4, vocab=1000, embed_dim=4, dnn_dims=(16, 16))
BATCH = 16
STEPS = 3
TABLES = ('fm_v', 'fm_w1')
OPT_CASES = {'sgd': {}, 'momentum': dict(mu=0.9),
             'momentum-nesterov': dict(mu=0.9, use_nesterov=True),
             'adam': dict(lazy_mode=False), 'adam-lazy': dict(lazy_mode=True)}


def _values(n, seed):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32)


def _opt_ins(case):
    """The numpy inputs of an optimizer case: a [HEIGHT, 3] table, its
    state and a SelectedRows gradient (ROWS, _values) as (rows, values)."""
    rng = np.random.RandomState(11)
    ins = {'Param': rng.randn(HEIGHT, 3).astype(np.float32),
           'LearningRate': np.array([0.01], np.float32)}
    op = case.split('-')[0]
    if op == 'momentum':
        ins['Velocity'] = rng.randn(HEIGHT, 3).astype(np.float32)
    if op == 'adam':
        ins['Moment1'] = (rng.randn(HEIGHT, 3) * 0.1).astype(np.float32)
        ins['Moment2'] = rng.rand(HEIGHT, 3).astype(np.float32) * 0.01
        ins['Beta1Pow'] = np.array([0.9 ** 3], np.float32)
        ins['Beta2Pow'] = np.array([0.999 ** 3], np.float32)
    return op, ins


class _Ctx(object):
    """The part of a lowering's ctx these ops read, in either package: the
    attrs, and for lookup_table_grad the values by name (the reference's
    ctx.env / ctx.tracer.env, the port's ctx.interp.read / cotangent)."""

    def __init__(self, attrs, env=None):
        self.attrs = attrs
        self._env = env or {}
        self.tracer = types.SimpleNamespace(env=self._env)
        self.interp = self
        self.op = None
        self.is_test = False

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def env(self, name):
        return self._env[name]

    def read(self, name, op):
        return self._env[name]

    def cotangent(self, name, op):
        return self._env.get(name) if name else None


def _lookup_attrs(is_sparse):
    return {'is_sparse': is_sparse, 'padding_idx': PAD,
            '_fwd_inputs': {'W': ['w'], 'Ids': ['ids']},
            '_fwd_outputs': {'Out': ['out']},
            '_in_grad_map': {'w': 'w@GRAD'},
            '_out_grad_map': {'out': 'out@GRAD'}}


def _lookup_env():
    rng = np.random.RandomState(4)
    return {'w': rng.randn(HEIGHT, 3).astype(np.float32), 'ids': IDS,
            'out@GRAD': rng.randn(2, 3, 3).astype(np.float32)}


def _build(pkg, builder):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        feeds, loss = builder.build_deepfm_train(**MODEL)
    return main, startup, loss


def _feed(seed):
    rng = np.random.RandomState(seed)
    return {'field_ids': rng.randint(0, MODEL['vocab'], (
        BATCH, MODEL['num_fields'])).astype(np.int64),
        'dense_x': rng.rand(BATCH, 13).astype(np.float32),
        'click': rng.randint(0, 2, (BATCH, 1)).astype(np.float32)}


def _jax_state(main, scope):
    return {v.name: np.array(scope.find_var(v.name).get_tensor())
            for v in main.list_vars() if v.persistable}


def _jax_reference(root):
    """paddle_tpu's side, written to root/ref.npz and root/ref.json."""
    import jax.numpy as jnp
    import paddle_tpu as fluid
    from paddle_tpu.core import registry
    from paddle_tpu.core.selected_rows import (SelectedRowsVal as SR,
                                               concat_rows as cat_rows)
    from models import deepfm as jax_deepfm

    arrays = {}
    sr = SR(jnp.asarray(ROWS, jnp.int32), jnp.asarray(_values(7, 1)), HEIGHT)
    m = sr.merged()
    arrays['merged/rows'] = np.asarray(m.rows)
    arrays['merged/values'] = np.asarray(m.values)
    arrays['dense'] = np.asarray(sr.to_dense())
    sr2 = SR(jnp.asarray(ROWS2, jnp.int32), jnp.asarray(_values(3, 2)),
             HEIGHT)
    c = cat_rows([sr, sr2])
    arrays['concat/rows'] = np.asarray(c.rows)
    arrays['concat/values'] = np.asarray(c.values)
    arrays['concat/dense'] = np.asarray(c.to_dense())

    lower = registry.get('lookup_table_grad').lower
    env = {k: jnp.asarray(v) for k, v in _lookup_env().items()}
    g = lower(_Ctx(_lookup_attrs(True), env), {})['IN@GRAD'][0]
    arrays['lookup/rows'] = np.asarray(g.rows)
    arrays['lookup/values'] = np.asarray(g.values)
    arrays['lookup/dense'] = np.asarray(
        lower(_Ctx(_lookup_attrs(False), env), {})['IN@GRAD'][0])

    for case, attrs in sorted(OPT_CASES.items()):
        op, ins = _opt_ins(case)
        jins = {k: [jnp.asarray(v)] for k, v in ins.items()}
        jins['Grad'] = [SR(jnp.asarray(ROWS, jnp.int32),
                           jnp.asarray(_values(7, 1)), HEIGHT)]
        outs = registry.get(op).lower(_Ctx(attrs), jins)
        for slot, vals in outs.items():
            arrays['opt/%s/%s' % (case, slot)] = np.asarray(vals[0])

    main, startup, loss = _build(fluid, jax_deepfm)
    meta = {'ops': [(op.type, op.inputs, op.outputs)
                    for op in main.global_block().ops]}
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        state = _jax_state(main, scope)
    st = state
    for i in range(STEPS):
        # each run's state set from numpy: the step compiles once
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            for n, a in st.items():
                scope.var(n).get_tensor().set(a)
            arrays['loss%d' % i] = np.asarray(
                exe.run(main, feed=_feed(i), fetch_list=[loss])[0])
            st = _jax_state(main, scope)
    arrays.update({'state/' + n: a for n, a in state.items()})
    arrays.update({'final/' + n: a for n, a in st.items()})
    np.savez(os.path.join(root, 'ref.npz'), **arrays)
    with open(os.path.join(root, 'ref.json'), 'w') as f:
        json.dump(meta, f)


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('jax_ctr'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with np.load(os.path.join(root, 'ref.npz')) as f:
        arrays = dict(f)
    with open(os.path.join(root, 'ref.json')) as f:
        arrays['meta'] = json.load(f)
    return arrays


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sr(rows, values):
    return SelectedRowsVal(torch.from_numpy(rows), torch.from_numpy(values),
                           HEIGHT)


def _equal(name, got, want):
    got = np.asarray(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=name)


def _close(name, got, want, rel):
    got = np.asarray(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    top = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * top, '%s: %r > %r of %r' % (name, err, rel, top)


def test_selected_rows_match_jax(ref):
    sr = _sr(ROWS, _values(7, 1))
    m = sr.merged()
    _equal('merged rows', m.rows.numpy(), ref['merged/rows'])
    _equal('merged values', m.values.numpy(), ref['merged/values'])
    _equal('dense', sr.to_dense().numpy(), ref['dense'])
    c = concat_rows([sr, _sr(ROWS2, _values(3, 2))])
    _equal('concat rows', c.rows.numpy(), ref['concat/rows'])
    _equal('concat values', c.values.numpy(), ref['concat/values'])
    _equal('concat dense', c.to_dense().numpy(), ref['concat/dense'])
    _equal('merged dense', m.to_dense().numpy(), ref['dense'])
    with pytest.raises(ValueError, match='height'):
        concat_rows([sr, SelectedRowsVal(sr.rows, sr.values, HEIGHT + 1)])


def test_sparse_lookup_table_grad_matches_jax(ref):
    lower = ptt_registry.get('lookup_table_grad').lower
    env = {k: torch.from_numpy(v) for k, v in _lookup_env().items()}
    g = lower(_Ctx(_lookup_attrs(True), env), {})['IN@GRAD'][0]
    assert isinstance(g, SelectedRowsVal) and g.height == HEIGHT
    _equal('rows', g.rows.numpy(), ref['lookup/rows'])
    _equal('values', g.values.numpy(), ref['lookup/values'])
    dense = lower(_Ctx(_lookup_attrs(False), env), {})['IN@GRAD'][0]
    _equal('dense', dense.numpy(), ref['lookup/dense'])
    _equal('densified sparse', g.to_dense().numpy(), ref['lookup/dense'])


@pytest.mark.parametrize('case', sorted(OPT_CASES))
def test_sparse_optimizer_branch_matches_jax(case, ref):
    op, ins = _opt_ins(case)
    tins = {k: [torch.from_numpy(v)] for k, v in ins.items()}
    tins['Grad'] = [_sr(ROWS, _values(7, 1))]
    outs = ptt_registry.get(op).lower(_Ctx(OPT_CASES[case]), tins)
    untouched = np.setdiff1d(np.arange(HEIGHT), ROWS)
    for slot, vals in outs.items():
        want = ref['opt/%s/%s' % (case, slot)]
        got = vals[0].numpy()
        _close('%s %s' % (case, slot), got, want, 1e-6)
        if slot.endswith('PowOut'):
            continue
        base = ins[{'ParamOut': 'Param', 'VelocityOut': 'Velocity',
                    'Moment1Out': 'Moment1',
                    'Moment2Out': 'Moment2'}[slot]]
        if case != 'adam':  # non-lazy adam decays every row's moments
            _equal('%s %s untouched' % (case, slot), got[untouched],
                   base[untouched])
            _equal('%s %s untouched (reference)' % (case, slot),
                   want[untouched], base[untouched])


def test_selected_rows_layers_in_a_program():
    """merge_selected_rows and get_tensor_from_selected_rows on an
    is_sparse embedding's gradient in a program: the merged values of the
    batch's ids, N kept (the lowerings are held against the reference
    above)."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        ids = ptt.layers.data('ids', shape=[2, 3], dtype='int64',
                              append_batch_size=False)
        emb = ptt.layers.embedding(ids, size=[HEIGHT, 3], is_sparse=True,
                                   param_attr=ptt.ParamAttr(name='w'))
        loss = ptt.layers.mean(ptt.layers.square(emb))
        ptt.backward.append_backward(loss)
        grad = main.global_block().var('w@GRAD')
        merged = ptt.layers.merge_selected_rows(grad)
        values = ptt.layers.get_tensor_from_selected_rows(merged)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    g, v = exe.run(main, feed={'ids': IDS}, scope=scope,
                   fetch_list=['w@GRAD', values], return_numpy=False)
    assert isinstance(g, SelectedRowsVal) and v.shape == (6, 3)
    want = g.merged()
    assert torch.equal(v, want.values)
    assert sorted(set(want.rows.tolist()) - {HEIGHT}) == \
        sorted(set(IDS.ravel().tolist()))


def test_same_program(ref):
    main, _, _ = _build(ptt, ptt_deepfm)
    ops = [(op.type, op.inputs, op.outputs)
           for op in main.global_block().ops]
    assert json.loads(json.dumps(ops)) == ref['meta']['ops']


def _state(ref, key):
    return {n.split('/', 1)[1]: a for n, a in ref.items()
            if n.startswith(key + '/')}


def test_lazy_adam_steps_match_jax(ref):
    main, startup, loss = _build(ptt, ptt_deepfm)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    init = _state(ref, 'state')
    ptt.weights.params_from_numpy(init, main, scope)
    touched = set()
    for i in range(STEPS):
        got, = exe.run(main, feed=_feed(i), fetch_list=[loss], scope=scope)
        _close('loss%d' % i, got, ref['loss%d' % i], 1e-6)
        touched |= set(_feed(i)['field_ids'].ravel().tolist())
    final = ptt.weights.state_to_numpy(main, scope)
    want = _state(ref, 'final')
    assert sorted(final) == sorted(want)
    untouched = np.array(sorted(set(range(MODEL['vocab'])) - touched))
    assert len(untouched) > 0
    tables = {n for n in want
              if any(n == t or n.startswith(t + '_moment') for t in TABLES)}
    assert len(tables) == 6, tables
    for n in sorted(want):
        got = final[n].astype(want[n].dtype)
        if n in tables:
            _close(n, got, want[n], 1e-6)
            _equal(n + ' untouched', got[untouched], want[n][untouched])
            _equal(n + ' untouched (initial)', got[untouched],
                   init[n][untouched])
        else:
            _close(n, got, want[n], 1e-5)


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
