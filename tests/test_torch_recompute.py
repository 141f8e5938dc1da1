"""Activation rematerialization on the port (passes/recompute.py, the
remat_segment op, `checkpoints` in append_backward, minimize and the BERT
and Transformer builders), held against paddle_tpu on the CPU.

Programs: a 2-layer BERT at S=64 (pretraining, Adam) with
`checkpoints=True` (each layer's output a boundary) and 'auto' (√N
segments), a 4-layer MLP with dropout (SGD) with 'auto', and
recompute_program run alone on the MLP's forward with an explicit list.

Checked against paddle_tpu, exactly: each rewritten program, op for op in
every block (types, inputs, outputs, attrs as JSON), and the recompute
report's details (segments, boundaries, interior bytes, skips).

Then in the port (f32 on the CPU):
- remat losses equal the no-remat losses bit for bit over 3 steps at
  dropout 0.1 (a replayed dropout draws what the forward drew), through
  Executor.run, run_steps, gradient merge (k=2) and CompiledTrainer, as
  tests/test_recompute.py requires of the reference. The gradients are
  held within 1e-6 of each tensor's largest value: the segment's grad
  sums a value's gradients from several readers in autograd's order,
  where the no-remat program's `sum` ops add them in program order;
- a remat BERT step (dropout 0, from paddle_tpu's initial state) matches
  paddle_tpu's remat step: per-step losses within rtol 1e-5 and
  `word_emb@GRAD` within 1e-5 of its largest value (the tolerances of
  tests/test_torch_bert_training.py);
- a Transformer with `checkpoints=True` takes the same step as without;
- the live non-persistable bytes at the peak of a step are lower with
  remat.

paddle_tpu's side is computed once, by this file run as a script in a
fresh interpreter (see tests/test_torch_bert_training.py for why).
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.models import bert as ptt_bert
from paddle_tpu_torch.models import transformer as ptt_transformer

BERT = dict(vocab=61, max_len=64, d_model=32, d_ff=64, n_head=2, n_layer=2)
STEPS = 3
JAX_STEPS = 2


def _json(x):
    return json.loads(json.dumps(x, default=repr))


def describe(program):
    return _json([[(op.type, op.inputs, op.outputs, op.attrs)
                   for op in b.ops] for b in program.blocks])


def _bert(pkg, m, checkpoints=None, dropout=0.1):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, loss = m.build_bert_pretrain(dropout=dropout,
                                        checkpoints=checkpoints, **BERT)
    return main, startup, loss


def _mlp(pkg, checkpoints=None, train=True):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        h = pkg.layers.data('x', shape=[16])
        for _ in range(4):
            h = pkg.layers.fc(h, 16, act='relu')
            h = pkg.layers.dropout(
                h, 0.1, dropout_implementation='upscale_in_train')
        loss = pkg.layers.mean(h)
        if train:
            pkg.optimizer.SGD(0.1).minimize(loss, checkpoints=checkpoints)
    return main, startup, loss


def rewrites(pkg, bert):
    """{case: (program, report details)} of each recompute rewrite."""
    out = {}
    for cp in (True, 'auto'):
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            main, _, _ = _bert(pkg, bert, cp)
        out['bert/%s' % cp] = (main, main._recompute_report.details)
    main, _, _ = _mlp(pkg, 'auto')
    out['mlp/auto'] = (main, main._recompute_report.details)
    main, _, loss = _mlp(pkg, train=False)
    names = [op.output_arg_names()[0] for op in main.global_block().ops
             if op.type == 'relu'][:2]
    prog, rep = pkg.passes.recompute_program(main, checkpoints=names,
                                             fetch_names=[loss.name])
    out['mlp_forward/explicit'] = (prog, rep.details)
    return out


def _feed(seed, batch=4):
    rng = np.random.RandomState(seed)
    s, v = BERT['max_len'], BERT['vocab']
    return {'tok_ids': rng.randint(0, v, (batch, s)).astype(np.int64),
            'seg_ids': rng.randint(0, 2, (batch, s)).astype(np.int64),
            'mlm_labels': rng.randint(0, v, (batch, s)).astype(np.int64),
            'mlm_weights': (rng.rand(batch, s) < 0.3).astype(np.float32)}


def _jax_reference(root):
    import paddle_tpu as fluid
    from models import bert
    out = {k: {'program': describe(p), 'details': _json(d)}
           for k, (p, d) in rewrites(fluid, bert).items()}
    with open(os.path.join(root, 'rewrites.json'), 'w') as f:
        json.dump(out, f)
    main, startup, loss = _bert(fluid, bert, True, dropout=0.0)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    arrays = {}
    with fluid.scope_guard(scope):
        exe.run(startup)
        for v in main.list_vars():
            if v.persistable:
                arrays['state/' + v.name] = np.array(
                    scope.find_var(v.name).get_tensor())
        for i in range(JAX_STEPS):
            l, g = exe.run(main, feed=_feed(i),
                           fetch_list=[loss, 'word_emb@GRAD'])
            arrays['loss%d' % i] = np.asarray(l)
            arrays['grad%d' % i] = np.asarray(g)
    np.savez(os.path.join(root, 'run.npz'), **arrays)


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('jax_recompute'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with open(os.path.join(root, 'rewrites.json')) as f:
        rw = json.load(f)
    with np.load(os.path.join(root, 'run.npz')) as f:
        run = dict(f)
    return rw, run


@pytest.mark.parametrize('case', ['bert/True', 'bert/auto', 'mlp/auto',
                                  'mlp_forward/explicit'])
def test_segments_equal_the_reference(ref, case):
    rw, _ = ref
    prog, details = rewrites(ptt, ptt_bert)[case]
    assert _json(details) == rw[case]['details']
    assert describe(prog) == rw[case]['program']
    assert details['segments']
    assert sum(op.type == 'remat_segment'
               for op in prog.global_block().ops) == len(details['segments'])


def _train(main, startup, loss, steps=STEPS, how='run', tmp=None):
    """Per-step (loss, word_emb@GRAD) of `steps` steps from the startup's
    state, driven `how`."""
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    feeds = [_feed(i) for i in range(steps)]
    fetch = [loss.name, 'word_emb@GRAD']
    if how == 'run':
        return [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                for f in feeds]
    if how == 'run_steps':
        stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
        out = exe.run_steps(main, feed=stacked, fetch_list=fetch,
                            scope=scope, fetch_policy='stack')
        return [[o[i] for o in out] for i in range(steps)]
    if how == 'gradient_merge':
        ptt.contrib.gradient_merge.enable(2, main)
        return [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                for f in feeds]
    from paddle_tpu_torch.inference import export_train_step, load_trainer
    art = os.path.join(tmp, 'remat' if main.num_blocks > 1 else 'plain')
    export_train_step(main, feeds[0], fetch, art, scope=scope)
    trainer = load_trainer(art, platform='cpu')
    return [trainer.step(f) for f in feeds]


@pytest.mark.parametrize('how', ['run', 'run_steps', 'gradient_merge',
                                 'compiled_trainer'])
def test_remat_equals_no_remat(how, tmp_path):
    plain = _train(*_bert(ptt, ptt_bert), how=how, tmp=str(tmp_path))
    remat = _train(*_bert(ptt, ptt_bert, True), how=how, tmp=str(tmp_path))
    for i, ((lp, gp), (lr, gr)) in enumerate(zip(plain, remat)):
        assert np.array_equal(lp, lr), (how, i, lp, lr)
        np.testing.assert_allclose(gr, gp, rtol=0,
                                   atol=1e-6 * np.abs(gp).max())


def test_remat_matches_the_reference(ref):
    _, run = ref
    main, _, loss = _bert(ptt, ptt_bert, True, dropout=0.0)
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(
        {k[6:]: v for k, v in run.items() if k.startswith('state/')},
        main, scope)
    exe = ptt.Executor(ptt.CPUPlace())
    for i in range(JAX_STEPS):
        l, g = exe.run(main, feed=_feed(i),
                       fetch_list=[loss, 'word_emb@GRAD'], scope=scope)
        np.testing.assert_allclose(l, run['loss%d' % i], rtol=1e-5)
        w = run['grad%d' % i]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_transformer_checkpoints_take_the_same_step():
    cfg = dict(src_vocab=37, trg_vocab=37, max_len=16, d_model=32, d_ff=64,
               n_head=2, n_layer=2, dropout=0.1)
    rng = np.random.RandomState(0)
    feed = {n: rng.randint(0, 37, (2, 16)).astype(np.int64)
            for n in ('src_ids', 'trg_ids', 'lbl_ids')}
    losses = []
    for cp in (None, True):
        main, startup = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, startup), ptt.unique_name.guard():
            _, loss, _ = ptt_transformer.build_transformer_train(
                checkpoints=cp, **cfg)
        if cp:
            # a boundary after each encoder and decoder layer
            assert len(main._recompute_report.details['segments']) > \
                2 * cfg['n_layer']
        scope = ptt.Scope()
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup, scope=scope)
        losses.append([exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope)[0] for _ in range(2)])
    assert np.array_equal(losses[0], losses[1])


def test_a_request_that_applies_nothing_warns():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data('x', shape=[4])
        loss = ptt.layers.mean(ptt.layers.fc(x, 1))
        with pytest.warns(UserWarning, match='0 recompute segments'):
            ptt.backward.append_backward(loss, checkpoints=[x])


def test_remat_lowers_the_live_bytes_at_the_peak(monkeypatch):
    peaks = []
    run_op = lowering.Interpreter.run_op
    for cp in (None, True):
        main, startup, loss = _bert(ptt, ptt_bert, cp)
        persist = {v.name for v in main.list_vars() if v.persistable}
        scope = ptt.Scope()
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup, scope=scope)
        seen = []

        def counted(self, op, block):
            out = run_op(self, op, block)
            storages = {t.untyped_storage().data_ptr():
                        t.untyped_storage().nbytes()
                        for n, t in self.env.items() if n not in persist}
            seen.append(sum(storages.values()))
            return out
        monkeypatch.setattr(lowering.Interpreter, 'run_op', counted)
        exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
        monkeypatch.setattr(lowering.Interpreter, 'run_op', run_op)
        peaks.append(max(seen))
    assert peaks[1] < peaks[0], peaks


if __name__ == '__main__':
    torch.set_num_threads(1)
    _jax_reference(sys.argv[1])
