"""The port's program passes (paddle_tpu_torch/passes/) held against
paddle_tpu's on the CPU, and the places the port wires them in.

Small programs are built by both packages under a fresh
unique_name.guard(): a ResNet with a stem and two basic blocks (inference
and Momentum training), one GoogLeNet inception block at narrow widths, a
4-layer MLP with dropout and a constant chain (SGD training), and a
2-layer BERT at S=64 (pretraining at dropout 0.1, the masked-LM logits
fetched). Checked exactly (no
tolerance; the pass layer is pure program rewriting):
- each program is built the same in both packages, and each pipeline
  (OPTIMIZATION_PIPELINE, INFERENCE_PIPELINE) gives the same program, op
  for op (types, inputs, outputs and attrs, compared as JSON) and the
  same PassReports (PassReport.as_dict);
- verify_program gives the same diagnostics on seeded-bad programs, at
  both levels;
- memory_optimize's report and InferenceTranspiler.transpile's reports
  are the reference's.
Then the port alone: the Executor's verify hook (one RuntimeWarning per
program epoch and run boundary; PTPU_STRICT_VERIFY=1 raises), a fused
program equal to the unfused one bit for bit (fuse_activation) and within
1e-5 of the largest output (horizontal_fuse: one wide convolution sums as
the narrow ones do, but the CPU's convolution may block its loops
otherwise), and export_compiled writing the pipeline's program with each
bucket's peak_bytes_est, falling back with a RuntimeWarning.

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

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.lowering import TraceError
from paddle_tpu_torch.models import bert as ptt_bert
from paddle_tpu_torch.models import googlenet as ptt_googlenet
from paddle_tpu_torch.models import resnet as ptt_resnet

BERT = dict(vocab=61, max_len=64, d_model=32, d_ff=64, n_head=2, n_layer=2)
PIPELINES = ('apply_optimization_pipeline', 'apply_inference_pipeline')
BAD = ('use_before_def', 'undefined_input', 'unregistered_op',
       'dangling_sub_block', 'unreachable_fetch', 'bad_dtype',
       'shape_mismatch', 'double_write_dead_persistable')


def _json(x):
    return json.loads(json.dumps(x, default=repr))


def describe(program):
    """Every block's ops as (type, inputs, outputs, attrs), as JSON."""
    return _json([[(op.type, op.inputs, op.outputs, op.attrs)
                   for op in b.ops] for b in program.blocks])


def _resnet(pkg, m, train):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data('img', shape=[3, 8, 8])
        y = m.conv_bn_layer(x, 8, 3, 1, 1, is_train=train)
        y = m.basicblock(y, 8, 1, is_train=train)
        y = m.basicblock(y, 16, 2, is_train=train)
        out = pkg.layers.fc(y, 4, act='softmax')
        if not train:
            return main, startup, [out.name]
        lab = pkg.layers.data('label', shape=[4])
        loss = pkg.layers.mean(pkg.layers.square_error_cost(out, lab))
        pkg.optimizer.Momentum(0.1, 0.9).minimize(loss)
    return main, startup, [loss.name]


def _inception(pkg, m):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data('img', shape=[8, 8, 8])
        y = m._inception(x, 4, 4, 8, 2, 4, 4)
    return main, startup, [y.name]


def _mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        h = pkg.layers.data('x', shape=[16])
        for _ in range(4):
            h = pkg.layers.fc(h, 16, act='relu')
            h = pkg.layers.dropout(
                h, 0.1, dropout_implementation='upscale_in_train')
        c = pkg.layers.scale(pkg.layers.fill_constant([1], 'float32', 2.0),
                             3.0)
        loss = pkg.layers.mean(pkg.layers.elementwise_add(h, c))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [loss.name]


def _bert(pkg, m):
    """BERT pretraining at dropout 0.1; the fetch is the masked-LM logits
    (what a predictor of the trained program serves)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        m.build_bert_pretrain(dropout=0.1, **BERT)
    sce, = [op for op in main.global_block().ops
            if op.type == 'softmax_with_cross_entropy']
    return main, startup, [sce.input('Logits')[0]]


def programs(pkg, resnet, googlenet, bert):
    return {'resnet_infer': _resnet(pkg, resnet, False),
            'resnet_train': _resnet(pkg, resnet, True),
            'inception': _inception(pkg, googlenet),
            'mlp': _mlp(pkg),
            'bert': _bert(pkg, bert)}


def bad_program(pkg, kind):
    """A program seeded with one defect; returns (program, feeds,
    fetches)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data('x', shape=[4])
        b = main.global_block()

        def var(name, **kw):
            return b.create_var(name=name, shape=kw.pop('shape', [-1, 4]),
                                dtype='float32', **kw)

        def relu(src, dst, type='relu'):
            b.append_op(type=type, inputs={'X': [src]},
                        outputs={'Out': [dst]}, infer_shape=False)
        fetch = ['y']
        if kind == 'use_before_def':
            var('later')
            var('y')
            relu('later', 'y')
            relu('x', 'later')
        elif kind == 'undefined_input':
            var('y')
            relu('nowhere', 'y')
        elif kind == 'unregistered_op':
            var('y')
            relu('x', 'y', type='no_such_op')
        elif kind == 'dangling_sub_block':
            var('y')
            b.append_op(type='remat_segment', inputs={'X': ['x']},
                        outputs={'Out': ['y']}, attrs={'sub_block': 7},
                        infer_shape=False)
        elif kind == 'unreachable_fetch':
            fetch = ['never_made']
            var('y')
            relu('x', 'y')
        elif kind == 'bad_dtype':
            b.append_op(type='fill_constant', outputs={'Out': [var('y')]},
                        attrs={'shape': [1], 'value': 1.0,
                               'dtype': 'not_a_dtype'}, infer_shape=False)
        elif kind == 'shape_mismatch':
            y = pkg.layers.fill_constant([3, 4], 'float32', 1.0)
            y.shape = (5, 4)
            fetch = [y.name]
        else:
            var('y')
            relu('x', 'y')
            relu('x', 'y')
            b.create_var(name='orphan_w', shape=[4], dtype='float32',
                         persistable=True)
    return main, ['x'], fetch


def _memory_optimize(pkg, progs):
    out = {}
    for name in ('mlp', 'resnet_train'):
        main, _, fetch = progs[name]
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', DeprecationWarning)
            rep = pkg.memory_optimize(main, fetch_list=fetch, batch=4)
        out[name] = _json(rep.as_dict())
    main, _, fetch = progs['resnet_infer']
    main._fetch_names = fetch
    out['transpile'] = _json([r.as_dict() for r in
                              pkg.transpiler.InferenceTranspiler().transpile(
                                  main, pkg.CPUPlace())])
    out['transpiled'] = describe(main)
    return out


def summarize(pkg, resnet, googlenet, bert):
    """What both sides compute, as JSON: each program as built, each
    pipeline's program and reports, the verifier's diagnostics on the bad
    programs, memory_optimize's and transpile's reports."""
    progs = programs(pkg, resnet, googlenet, bert)
    out = {'built': {}, 'pipelines': {}, 'verify': {}}
    for name, (main, _, fetch) in progs.items():
        out['built'][name] = describe(main)
        for pipe in PIPELINES:
            prog, reports = getattr(pkg.passes, pipe)(main, fetch_names=fetch)
            out['pipelines'][name + '/' + pipe] = {
                'program': describe(prog),
                'reports': _json([r.as_dict() for r in reports])}
    for kind in BAD:
        main, feeds, fetch = bad_program(pkg, kind)
        for level in ('fast', 'full'):
            diags = pkg.passes.verify_program(main, feed_names=feeds,
                                              fetch_names=fetch, level=level)
            out['verify'][kind + '/' + level] = _json(
                [d.as_dict() for d in diags])
    out['memory'] = _memory_optimize(pkg, progs)
    return out


def _jax_reference(root):
    import paddle_tpu as fluid
    import paddle_tpu.transpiler  # noqa: F401
    from models import bert, googlenet, resnet
    with open(os.path.join(root, 'reference.json'), 'w') as f:
        json.dump(summarize(fluid, resnet, googlenet, bert), f)


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('jax_passes'))
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
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        return _json(summarize(ptt, ptt_resnet, ptt_googlenet, ptt_bert))


@pytest.mark.parametrize('name', ['resnet_infer', 'resnet_train',
                                  'inception', 'mlp', 'bert'])
def test_pipelines_equal_the_reference(ref, port, name):
    assert port['built'][name] == ref['built'][name]
    for pipe in PIPELINES:
        key = name + '/' + pipe
        assert port['pipelines'][key]['program'] == \
            ref['pipelines'][key]['program'], key
        assert port['pipelines'][key]['reports'] == \
            ref['pipelines'][key]['reports'], key


def test_pipelines_do_what_they_say(port):
    """What each program's pipeline did, so a pass that silently stopped
    firing in both packages at once is still caught."""
    def details(name, pipe, pass_name):
        reps = port['pipelines'][name + '/' + pipe]['reports']
        return next(r for r in reps if r['pass'] == pass_name)['details']
    inf = 'apply_inference_pipeline'
    # the two residual relus fold into their elementwise_add
    assert details('resnet_infer', inf, 'fuse_activation')['fused'] == 2
    hf = details('inception', inf, 'horizontal_fuse')
    assert hf['groups_fused'] == 1 and hf['convs_fused'] == 3
    types = [t for t, _, _, _ in
             port['pipelines']['inception/' + inf]['program'][0]]
    # the three 1x1 branch-entry convs become one; the 3x3, 5x5 and pool
    # projection convs stay
    assert types.count('split') == 1 and types.count('conv2d') == 4
    assert details('mlp', 'apply_optimization_pipeline',
                   'constant_fold')['folded_ops'] == 1
    # the inference pipeline sheds the whole training cone
    ops = port['pipelines']['resnet_train/' + inf]['program'][0]
    assert not any(t.endswith('_grad') or t == 'momentum'
                   for t, _, _, _ in ops)


@pytest.mark.parametrize('kind', BAD)
def test_verifier_diagnostics_equal_the_reference(ref, port, kind):
    for level in ('fast', 'full'):
        key = kind + '/' + level
        assert port['verify'][key] == ref['verify'][key], key
    assert port['verify'][kind + '/full'], kind  # each defect is found


def test_memory_optimize_and_transpile_equal_the_reference(ref, port):
    assert port['memory'] == ref['memory']
    assert port['memory']['mlp']['memory']['peak_bytes_after'] > 0


def test_executor_verify_hook_warns_once_and_strict_raises(monkeypatch):
    main, _, _ = bad_program(ptt, 'use_before_def')
    exe = ptt.Executor(ptt.CPUPlace())
    feed = {'x': np.ones((2, 4), np.float32)}
    monkeypatch.delenv('PTPU_STRICT_VERIFY', raising=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        for _ in range(2):
            with pytest.raises(TraceError, match='has no value'):
                exe.run(main, feed=feed, fetch_list=['y'],
                        scope=ptt.Scope())
    msgs = [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and 'use-before-def' in str(msgs[0].message)
    monkeypatch.setenv('PTPU_STRICT_VERIFY', '1')
    with pytest.raises(ptt.ProgramVerifyError, match='use-before-def'):
        exe.run(main, feed=feed, fetch_list=['y'], scope=ptt.Scope())
    # a new build epoch is linted again
    main.global_block().append_op(type='relu', inputs={'X': ['x']},
                                  outputs={'Out': ['y']})
    with pytest.raises(ptt.ProgramVerifyError):
        exe.run(main, feed=feed, fetch_list=['y'], scope=ptt.Scope())


def _run(program, startup, feed, fetch):
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    return exe.run(program, feed=feed, fetch_list=fetch, scope=scope)


def test_fused_programs_compute_what_the_unfused_do():
    rng = np.random.RandomState(0)
    main, startup, fetch = _resnet(ptt, ptt_resnet, False)
    main = main.clone(for_test=True)
    feed = {'img': rng.randn(4, 3, 8, 8).astype(np.float32)}
    fused, reports = ptt.passes.apply_inference_pipeline(main,
                                                         fetch_names=fetch)
    assert sum(op.attrs.get('fuse_act') == 'relu'
               for op in fused.global_block().ops) == 2
    want, = _run(main, startup, feed, fetch)
    got, = _run(fused, startup, feed, fetch)
    assert np.array_equal(got, want)  # the same lowerings, bit for bit

    main, startup, fetch = _inception(ptt, ptt_googlenet)
    feed = {'img': rng.randn(2, 8, 8, 8).astype(np.float32)}
    fused, reports = ptt.passes.apply_inference_pipeline(main,
                                                         fetch_names=fetch)
    assert reports[3].details['groups_fused'] == 1
    want, = _run(main, startup, feed, fetch)
    got, = _run(fused, startup, feed, fetch)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _saved_resnet(tmp):
    main, startup, fetch = _resnet(ptt, ptt_resnet, False)
    main = main.clone(for_test=True)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    with ptt.scope_guard(scope):
        ptt.io.save_inference_model(tmp, ['img'],
                                    [main.global_block().var(fetch[0])],
                                    exe, main)
    config = ptt.inference.Config(tmp)
    config.disable_gpu()
    return ptt.inference.create_predictor(config)


def test_export_compiled_writes_the_pipeline_program(tmp_path):
    from paddle_tpu_torch.inference import export_compiled, serve
    pred = _saved_resnet(str(tmp_path / 'model'))
    x = np.random.RandomState(1).randn(4, 3, 8, 8).astype(np.float32)
    adir = str(tmp_path / 'art')
    with warnings.catch_warnings():
        warnings.simplefilter('error', RuntimeWarning)
        export_compiled(pred, [x[:1]], adir, batch_sizes=[1, 4])
    with open(os.path.join(adir, '__model__')) as f:
        model = json.load(f)
    types = [op['type'] for op in model['blocks'][0]['ops']]
    want, _ = ptt.passes.apply_inference_pipeline(
        pred._program, fetch_names=pred.get_output_names(),
        feed_names=['img'])
    assert types == [op.type for op in want.global_block().ops]
    assert sum('fuse_act' in op['attrs']
               for op in model['blocks'][0]['ops']) == 2
    for b in (1, 4):
        with open(os.path.join(adir, serve._BUCKET_DIR % b,
                               'signature.json')) as f:
            sig = json.load(f)
        est = ptt.passes.analyze_program(
            want, feed_names=['img'],
            fetch_names=pred.get_output_names()).peak_memory(batch=b)
        assert sig['peak_bytes_est'] == est.peak_bytes > 0
    with open(os.path.join(adir, 'signature.json')) as f:
        ran = json.load(f)['passes']
    assert [r['pass'] for r in ran] == ptt.passes.pipeline_names(
        ptt.passes.INFERENCE_PIPELINE)
    assert ran[-1]['ops']['after'] == len(types)
    served = serve.CompiledPredictor(adir, platform='cpu')
    got, = served.run([x])
    assert np.array_equal(got, pred.run([x])[0])


def test_export_falls_back_to_the_raw_program_with_a_warning(
        tmp_path, monkeypatch):
    from paddle_tpu_torch.inference import export_compiled

    def broken(*a, **k):
        raise RuntimeError('pipeline bug')
    pred = _saved_resnet(str(tmp_path / 'model'))
    monkeypatch.setattr(ptt.passes, 'apply_inference_pipeline', broken)
    x = np.zeros((1, 3, 8, 8), np.float32)
    with pytest.warns(RuntimeWarning, match='pipeline bug'):
        export_compiled(pred, [x], str(tmp_path / 'art'))
    with open(os.path.join(str(tmp_path / 'art'), '__model__')) as f:
        types = [op['type'] for op in json.load(f)['blocks'][0]['ops']]
    assert types == [op.type for op in pred._program.global_block().ops]
    with open(os.path.join(str(tmp_path / 'art'), 'signature.json')) as f:
        assert json.load(f)['passes'] == []


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
