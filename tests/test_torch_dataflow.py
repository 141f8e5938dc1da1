"""The port's dataflow analysis (paddle_tpu_torch/passes/dataflow.py) held
against paddle_tpu's on the CPU, and the Executor's freeing plan built
from it.

Programs, built by both packages under a fresh unique_name.guard(): a
2-layer BERT at S=64 (pretraining at dropout 0.1, Adam), the same with
`checkpoints=True` (one remat segment a layer), a ResNet with a stem and
two basic blocks (Momentum), and a 4-layer MLP with dropout (SGD). For
each, exactly (integers and names; no tolerance): the def-use chains, the
live intervals, the hazards, var_bytes of every var, peak_memory at two
batches with and without remat_aware, reuse_report, the remat interiors,
last_writer_at of every sub-block read, donation_plan and
certify_donation.

Then the port alone, on the Executor's freeing plan
(core/lowering.py free_plan): it drops
no persistable, no fetch target, no value carried out of gradient merge's
microbatch loop, and no name a later op reads, sub-block reads included;
a step with the plan computes what a step without one computes, bit for
bit; and the live non-persistable values at the peak of a BERT step, with
the plan and without (126 values of 3.07 MB against 249 of 5.47 MB when
this was written; the bar is 0.6 of the count and of the bytes).

paddle_tpu's side is computed once, by this file run as a script in a
fresh interpreter (see tests/test_torch_bert_training.py for why).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.models import bert as ptt_bert
from paddle_tpu_torch.models import resnet as ptt_resnet
from paddle_tpu_torch.passes.base import op_reads, op_writes

BERT = dict(vocab=61, max_len=64, d_model=32, d_ff=64, n_head=2, n_layer=2)
BATCHES = (1, 8)


def _json(x):
    return json.loads(json.dumps(x, default=repr))


def _bert(pkg, m, checkpoints=None, dropout=0.1):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, loss = m.build_bert_pretrain(dropout=dropout,
                                        checkpoints=checkpoints, **BERT)
    return main, startup, loss


def _resnet(pkg, m):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data('img', shape=[3, 8, 8])
        y = m.conv_bn_layer(x, 8, 3, 1, 1)
        y = m.basicblock(y, 8, 1)
        y = m.basicblock(y, 16, 2)
        out = pkg.layers.fc(y, 4, act='softmax')
        lab = pkg.layers.data('label', shape=[4])
        loss = pkg.layers.mean(pkg.layers.square_error_cost(out, lab))
        pkg.optimizer.Momentum(0.1, 0.9).minimize(loss)
    return main, startup, loss


def _mlp(pkg, k=1):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        h = pkg.layers.data('x', shape=[16])
        for _ in range(4):
            h = pkg.layers.fc(h, 16, act='relu')
            h = pkg.layers.dropout(
                h, 0.1, dropout_implementation='upscale_in_train')
        loss = pkg.layers.mean(h)
        pkg.optimizer.SGD(0.1).minimize(loss)
    if k > 1:
        pkg.contrib.gradient_merge.enable(k, main)
    return main, startup, loss


def programs(pkg, bert, resnet):
    return {'bert': _bert(pkg, bert), 'bert_remat': _bert(pkg, bert, True),
            'resnet': _resnet(pkg, resnet), 'mlp': _mlp(pkg)}


def summarize(pkg, bert, resnet):
    """Every number the analysis gives for each program, as JSON."""
    out = {}
    df = pkg.passes.dataflow
    for name, (main, _, loss) in programs(pkg, bert, resnet).items():
        feeds = [v.name for v in main.list_vars()
                 if getattr(v, 'is_data', False)]
        fetch = [loss.name, 'fc_0.w_0@GRAD']
        dfa = df.analyze_program(main, feed_names=feeds, fetch_names=fetch)
        n_seg, interiors = dfa.remat_interiors()
        writers = {}
        for b in main.blocks[1:]:
            for i, op in enumerate(b.ops):
                for n in op.input_arg_names():
                    writers['%d/%d/%s' % (b.idx, i, n)] = \
                        dfa.last_writer_at(b.idx, i, n)
        state = sorted(dfa.persistables & dfa.written)
        out[name] = _json({
            'defs': dfa.defs, 'uses': dfa.uses,
            'intervals': dfa.live_intervals(),
            'hazards': [h.as_dict() for h in dfa.hazards()],
            'var_bytes': {v.name: df.var_bytes(v, 3)
                          for v in main.list_vars()},
            'peak': {'%d/%s' % (b, ra): dfa.peak_memory(
                batch=b, remat_aware=ra).as_dict()
                for b in BATCHES for ra in (False, True)},
            'per_bucket': {b: e.as_dict() for b, e in
                           dfa.peak_memory_per_bucket(BATCHES).items()},
            'reuse': dfa.reuse_report(batch=4),
            'remat': [n_seg, sorted(interiors)],
            'last_writer_at': writers,
            'last_writer': {n: dfa.last_writer(n) for n in sorted(dfa.uses)},
            'donation_plan': df.donation_plan(
                main, feed_names=feeds, fetch_names=fetch).as_dict(),
            'certify': df.certify_donation(
                main, state[:3] + [feeds[0], fetch[0]], feed_names=feeds,
                fetch_names=fetch).as_dict()})
    return out


def _jax_reference(root):
    import paddle_tpu as fluid
    from models import bert, resnet
    with open(os.path.join(root, 'reference.json'), 'w') as f:
        json.dump(summarize(fluid, bert, resnet), f)


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('jax_dataflow'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with open(os.path.join(root, 'reference.json')) as f:
        return json.load(f)


@pytest.fixture(scope='module')
def port():
    return summarize(ptt, ptt_bert, ptt_resnet)


@pytest.mark.parametrize('name', ['bert', 'bert_remat', 'resnet', 'mlp'])
@pytest.mark.parametrize('part', ['defs', 'uses', 'intervals', 'hazards',
                                  'var_bytes', 'peak', 'per_bucket', 'reuse',
                                  'remat', 'last_writer_at', 'last_writer',
                                  'donation_plan', 'certify'])
def test_analysis_equals_the_reference(ref, port, name, part):
    assert port[name][part] == ref[name][part]


def test_remat_shrinks_the_static_peak(port):
    n_seg, interiors = port['bert_remat']['remat']
    assert n_seg == BERT['n_layer'] + 1 and interiors
    plain = port['bert']['peak']['8/False']['peak_bytes']
    remat = port['bert_remat']['peak']['8/True']['peak_bytes']
    assert remat < plain
    assert port['bert_remat']['last_writer_at']  # sub-block reads resolve


def _full_plan(main, fetch):
    """The plan Executor.run builds for `fetch`."""
    persist = {v.name for v in main.list_vars() if v.persistable}
    block = main.global_block()
    return lowering.free_plan(main, block, block.ops, persist | set(fetch),
                              ('run', tuple(fetch)))


def test_plan_drops_nothing_a_later_op_or_the_caller_reads():
    main, _, loss = _bert(ptt, ptt_bert, checkpoints=True)
    fetch = [loss.name, 'word_emb@GRAD']
    plan = _full_plan(main, fetch)
    ops = main.global_block().ops
    persist = {v.name for v in main.list_vars() if v.persistable}
    dropped = {}
    for p, names in enumerate(plan):
        for n in names:
            assert n not in persist and n not in fetch, n
            assert n not in dropped, n  # dropped once
            dropped[n] = p
            for later in ops[p + 1:]:
                assert n not in op_reads(later, main) | op_writes(later,
                                                                  main), n
    # the segments' interior values are read by their grad op through its
    # sub-block, and leave the plan there, not at the forward segment
    grads = [i for i, op in enumerate(ops)
             if op.type == 'remat_segment_grad']
    sub_reads = {n for i in grads for n in op_reads(ops[i], main)
                 if n not in ops[i].input_arg_names()}
    assert sub_reads and all(dropped[n] in grads
                             for n in sub_reads if n in dropped)


def test_gradient_merge_plan_keeps_carried_values():
    main, _, loss = _mlp(ptt, k=2)
    fetch = [loss.name]
    exe = ptt.Executor(ptt.CPUPlace())
    ops, cone_idx, outer_idx, carried, cone_outs = \
        exe._ga_partition(main, fetch)
    persist = {v.name for v in main.list_vars() if v.persistable}
    pers_names = sorted(persist & cone_outs)
    keep = persist | set(carried) | set(pers_names) | set(fetch)
    plan = lowering.free_plan(main, main.global_block(),
                              [ops[j] for j in cone_idx], keep,
                              ('cone', tuple(fetch)))
    dropped = {n for names in plan for n in names}
    assert carried and not dropped & set(carried)
    assert any(n.endswith('@GRAD') for n in carried)
    assert dropped  # the microbatch's own temporaries go


def _feed(batch=4, seed=0):
    rng = np.random.RandomState(seed)
    s, v = BERT['max_len'], BERT['vocab']
    return {'tok_ids': rng.randint(0, v, (batch, s)).astype(np.int64),
            'seg_ids': rng.randint(0, 2, (batch, s)).astype(np.int64),
            'mlm_labels': rng.randint(0, v, (batch, s)).astype(np.int64),
            'mlm_weights': (rng.rand(batch, s) < 0.3).astype(np.float32)}


def _live_counts(monkeypatch, persist):
    """After each op: (live non-persistable names, the bytes of their
    distinct storages)."""
    counts = []
    run_op = lowering.Interpreter.run_op

    def counted(self, op, block):
        out = run_op(self, op, block)
        live = [t for n, t in self.env.items() if n not in persist]
        storages = {t.untyped_storage().data_ptr():
                    t.untyped_storage().nbytes() for t in live}
        counts.append((len(live), sum(storages.values())))
        return out
    monkeypatch.setattr(lowering.Interpreter, 'run_op', counted)
    return counts


def test_plan_frees_values_and_changes_no_result(monkeypatch):
    """One BERT step (dropout 0.1: both runs draw the same masks at step 0)
    through the Executor, which frees by the plan, and through an
    Interpreter that frees nothing: the same loss and gradients bit for
    bit, and the count of live non-persistable values at the peak."""
    main, startup, loss = _bert(ptt, ptt_bert)
    fetch = [loss.name, 'word_emb@GRAD', 'fc_0.w_0@GRAD']
    persist = {v.name for v in main.list_vars() if v.persistable}
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    state = {n: scope.get(n).clone() for n in persist
             if scope.get(n) is not None}
    feed = _feed()

    counts = _live_counts(monkeypatch, persist)
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    with_plan = [max(c[j] for c in counts) for j in (0, 1)]
    del counts[:]
    env = dict(state)
    env.update({n: torch.as_tensor(v) for n, v in feed.items()})
    with torch.no_grad():
        interp = lowering.Interpreter(main, torch.device('cpu'), env, 0)
        interp.run_block(main.global_block())
    without = [max(c[j] for c in counts) for j in (0, 1)]
    for g, n in zip(got, fetch):
        assert np.array_equal(g, interp.env[n].numpy()), n
    print('live non-persistable values at the peak: %d (%d bytes) with the '
          'plan, %d (%d bytes) without' % tuple(with_plan + without))
    # the forward values the backward reads stay to their grad op; every
    # gradient and every value no later op reads goes
    assert with_plan[0] < 0.6 * without[0], (with_plan, without)
    assert with_plan[1] < 0.6 * without[1], (with_plan, without)


@pytest.mark.parametrize('reader, build', [
    ('dropout_grad', 'mlp'), ('mul_grad', 'mlp'),
    ('lookup_table_grad', 'bert')])
def test_a_cotangent_dropped_early_fails_loudly(reader, build):
    """A plan that drops a grad op's cotangent right after its writer (a
    plan bug) fails at the reader with the interpreter's 'has no value'
    TraceError, never as a silent zero gradient: dropout_grad and
    lookup_table_grad (their own lowerings) declare it as an input,
    mul_grad reads it in the generic grad."""
    main, startup, loss = (_mlp(ptt) if build == 'mlp'
                           else _bert(ptt, ptt_bert))
    fetch = [loss.name]
    block = main.global_block()
    ops = block.ops
    for r, op in enumerate(ops):
        if op.type != reader:
            continue
        out = op.attrs['_fwd_outputs']['Out'][0]
        g = op.attrs['_out_grad_map'].get(out, '')
        writers = [i for i in range(r) if g in op_writes(ops[i], main)]
        if g and writers and not any(
                g in op_reads(ops[i], main)
                for i in range(writers[-1] + 1, r)):
            break
    else:
        raise AssertionError('no %s with a cotangent written before it'
                             % reader)
    plan = [[n for n in names if n != g]
            for names in _full_plan(main, fetch)]
    plan[writers[-1]].append(g)
    persist = {v.name for v in main.list_vars() if v.persistable}
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    env = {n: scope.get(n) for n in persist if scope.get(n) is not None}
    feed = _feed() if build == 'bert' else {
        'x': np.random.RandomState(0).randn(4, 16).astype(np.float32)}
    env.update({n: torch.as_tensor(v) for n, v in feed.items()})
    interp = lowering.Interpreter(main, torch.device('cpu'), env, 0)
    with torch.no_grad(), pytest.raises(lowering.TraceError,
                                        match='has no value') as err:
        interp.run_block(block, free=[tuple(x) for x in plan])
    assert repr(g) in str(err.value) and reader in str(err.value)


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
