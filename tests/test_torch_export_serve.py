"""Artifact serving on the port: export_compiled (single and multi-bucket)
and CompiledPredictor (run, pad_partial, run_batches), the serve command
line, held against the port's own Predictor and the JAX package.

The port's artifact holds the program as JSON and the parameters once
(export.py has the layout); a bucket directory holds its signature only
and loads on its own. CompiledPredictor.run equals the port's
Predictor.run bit for bit (the same program, interpreted), and on the same
saved directory it matches the JAX package's CompiledPredictor at rtol
1e-4 with a floor of 1e-4 of the largest logit, as
test_torch_resnet_serving.py holds the two Predictors.

The port initializes and saves each ResNet (random BN state); the JAX
side (export_compiled and CompiledPredictor on the JAX_MODEL directory, a
jax.export artifact of the small model, and whether it refuses the
port's artifact) runs once per module in a fresh interpreter, this file
run as a script, with PTPU_ARTIFACT_AOT=0 and
export_compiled(precompile=False). Only JAX_MODEL goes through the JAX
package: the deeper model's CPU compile there costs most of this file's
time and adds nothing, since the port's CompiledPredictor equals its
Predictor at every model and test_torch_resnet_serving.py holds the two
packages' Predictors at both.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import (CompiledPredictor, Config,
                                        create_predictor, export_compiled)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tests'))
from test_torch_resnet_serving import (MODELS, _build,  # noqa: E402
                                       _close, _image, _randomize_bn)

DIM = 8
JAX_MODEL = 'resnet20_cifar'


def _fc_model(pkg, dirname, reduce_fetch=False):
    """The reference tests' small model (tests/test_batching.py): fc 32
    relu, fc 4 softmax, seed 7; with reduce_fetch also a scalar mean,
    which is not batch-aligned."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img = pkg.layers.data(name='img', shape=[DIM], dtype='float32')
        h = pkg.layers.fc(img, 32, act='relu')
        out = pkg.layers.fc(h, 4, act='softmax')
        fetches = [out] + ([pkg.layers.mean(out)] if reduce_fetch else [])
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(pkg.Scope()):
        exe.run(startup)
        pkg.io.save_inference_model(dirname, ['img'], fetches, exe, main)


def _x(seed, rows):
    return np.random.RandomState(100 + seed).randn(rows, DIM).astype(
        np.float32)


def _save_port_resnets(root):
    """Each model of MODELS initialized by the port (seed 3, random BN
    state) and saved under root/<name>/dir."""
    from paddle_tpu_torch.models import resnet as ptt_resnet
    for i, name in enumerate(sorted(MODELS)):
        main, startup, logits = _build(ptt, ptt_resnet, name)
        main.random_seed = startup.random_seed = 3
        scope = ptt.Scope()
        exe = ptt.Executor(ptt.CPUPlace())
        with ptt.scope_guard(scope):
            exe.run(startup)
            _randomize_bn(main, scope, seed=i)
            ptt.io.save_inference_model(os.path.join(root, name, 'dir'),
                                        ['data'], [logits], exe, main)


def _jax_reference(root):
    """paddle_tpu's side, under root: for JAX_MODEL its CompiledPredictor's
    logits on _image(2, side) from export_compiled at batch 2 of the
    directory the port saved (JAX_MODEL/logits.npy); the fc
    model's directory (fc/dir) and a jax.export artifact of it
    (fc/jax_art); and the exception its CompiledPredictor raises on the
    port's artifact (refusal.json)."""
    import paddle_tpu as fluid
    from paddle_tpu.inference import CompiledPredictor as JaxCompiled
    from paddle_tpu.inference import Config as JaxConfig
    from paddle_tpu.inference import create_predictor as jax_predictor
    from paddle_tpu.inference import export_compiled as jax_export
    side = MODELS[JAX_MODEL][2]
    d = os.path.join(root, JAX_MODEL, 'dir')
    pred = jax_predictor(JaxConfig(d).disable_gpu())
    art = os.path.join(root, JAX_MODEL, 'art')
    jax_export(pred, [_image(2, side)], art, precompile=False)
    got, = JaxCompiled(art).run([_image(2, side)])
    np.save(os.path.join(root, JAX_MODEL, 'logits.npy'), np.asarray(got))
    fc = os.path.join(root, 'fc')
    _fc_model(fluid, os.path.join(fc, 'dir'))
    pred = jax_predictor(JaxConfig(os.path.join(fc, 'dir')).disable_gpu())
    jax_export(pred, [_x(0, 4)], os.path.join(fc, 'jax_art'),
               batch_sizes=[1, 8], precompile=False)
    try:
        JaxCompiled(os.path.join(root, 'port_art'))
        refusal = None
    except Exception as e:  # noqa: BLE001 — the test reads what it was
        refusal = type(e).__name__
    with open(os.path.join(root, 'refusal.json'), 'w') as f:
        json.dump({'refusal': refusal}, f)


@pytest.fixture(scope='module')
def port_resnets(tmp_path_factory):
    """The root under which the port saved each model of MODELS."""
    root = str(tmp_path_factory.mktemp('jax_export_serve'))
    _save_port_resnets(root)
    return root


@pytest.fixture(scope='module')
def jax_side(port_resnets):
    """_jax_reference's outputs, beside the port's ResNets and the
    artifact the JAX package must refuse (root/port_art)."""
    root = port_resnets
    _fc_model(ptt, os.path.join(root, 'port_model'))
    pred = create_predictor(Config(os.path.join(root, 'port_model'))
                            .disable_gpu())
    export_compiled(pred, [_x(0, 4)], os.path.join(root, 'port_art'))
    env = dict(os.environ, PTPU_ARTIFACT_AOT='0', PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    return root


@pytest.fixture(scope='module')
def fc_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('fc_model'))
    _fc_model(ptt, os.path.join(d, 'model'))
    _fc_model(ptt, os.path.join(d, 'reduce'), reduce_fetch=True)
    return d


def _predictor(d):
    return create_predictor(Config(d).disable_gpu())


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


def test_single_and_multibucket_layouts(fc_dir, tmp_path):
    pred = _predictor(os.path.join(fc_dir, 'model'))
    single = str(tmp_path / 'single')
    export_compiled(pred, [_x(0, 4)], single)
    assert sorted(os.listdir(single)) == ['__model__', 'params',
                                          'signature.json']
    sig = json.load(open(os.path.join(single, 'signature.json')))
    assert sig['version'] == 3 and sig['format'] == 'paddle_tpu_torch'
    assert sig['tier'] == 'bf16' and 'buckets' not in sig
    assert sig['feeds'] == [{'name': 'img', 'shape': [4, DIM],
                             'dtype': 'float32'}]
    assert sig['fetches'][0]['shape'] == [4, 4]

    multi = str(tmp_path / 'multi')
    export_compiled(pred, [_x(0, 4)], multi, batch_sizes=[32, 1, 8])
    # the program and the parameters once, at the root; a bucket holds
    # its signature only
    assert sorted(os.listdir(multi)) == [
        '__model__', 'bucket_00001', 'bucket_00008', 'bucket_00032',
        'params', 'signature.json']
    params = sorted(f for f in os.listdir(os.path.join(multi, 'params'))
                    if not f.startswith('.'))
    assert params == ['fc_0.b_0', 'fc_0.w_0', 'fc_1.b_0', 'fc_1.w_0']
    top = json.load(open(os.path.join(multi, 'signature.json')))
    assert top['buckets'] == [1, 8, 32] and 'root' not in top
    assert top['feeds'][0]['shape'] == [32, DIM]  # mirrors the largest
    assert top['fetches'][0]['shape'] == [32, 4]
    for b in (1, 8, 32):
        bdir = os.path.join(multi, 'bucket_%05d' % b)
        assert os.listdir(bdir) == ['signature.json']
        bsig = json.load(open(os.path.join(bdir, 'signature.json')))
        assert bsig['feeds'][0]['shape'] == [b, DIM]
        assert bsig['fetches'][0]['shape'] == [b, 4]
        assert bsig['root'] == '..' and 'buckets' not in bsig

    x = _x(1, 32)
    want, = pred.run([x])
    got, = CompiledPredictor(multi).run([x])  # the top level: bucket 32
    np.testing.assert_array_equal(got, want)
    b8 = CompiledPredictor(os.path.join(multi, 'bucket_00008'))
    assert b8.get_input_names() == ['img']
    assert b8.get_output_names() == pred.get_output_names()
    got8, = b8.run([x[:8]])
    np.testing.assert_array_equal(got8, pred.run([x[:8]])[0])


def test_export_checks_buckets_and_leading_dims(fc_dir, tmp_path):
    pred = _predictor(os.path.join(fc_dir, 'model'))
    for bad in ([], [0, 8], [-1]):
        with pytest.raises(ValueError, match='positive'):
            export_compiled(pred, [_x(0, 4)], str(tmp_path / 'a'),
                            batch_sizes=bad)
    with pytest.raises(ValueError, match='missing feeds'):
        export_compiled(pred, {'other': _x(0, 4)}, str(tmp_path / 'b'))


def _served(root, name, tmp_path):
    """The port's Predictor on root/<name>/dir, its CompiledPredictor's
    logits on _image(2, side) through an export at batch 2, and its
    Predictor's."""
    x = _image(2, MODELS[name][2])
    pred = _predictor(os.path.join(root, name, 'dir'))
    art = str(tmp_path / 'art')
    export_compiled(pred, [x], art)
    got, = CompiledPredictor(art).run([x])
    want, = pred.run([x])
    return got, want


@pytest.mark.parametrize('name', sorted(MODELS))
def test_resnet_compiled_equals_predictor(port_resnets, name, tmp_path):
    got, want = _served(port_resnets, name, tmp_path)
    np.testing.assert_array_equal(got, want)


def test_resnet_compiled_matches_jax(jax_side, tmp_path):
    got, _ = _served(jax_side, JAX_MODEL, tmp_path)
    _close(got, np.load(os.path.join(jax_side, JAX_MODEL, 'logits.npy')))


def test_pad_partial_and_unaligned_fetch(fc_dir, tmp_path):
    pred = _predictor(os.path.join(fc_dir, 'model'))
    art = str(tmp_path / 'art16')
    export_compiled(pred, [np.resize(_x(0, 4), (16, DIM))], art)
    served = CompiledPredictor(art)
    x = _x(2, 5)
    got, = served.run([x])
    assert got.shape == (5, 4)
    np.testing.assert_allclose(got, pred.run([x])[0], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match='expected shape'):
        served.run([x], pad_partial=False)

    rpred = _predictor(os.path.join(fc_dir, 'reduce'))
    rart = str(tmp_path / 'reduce')
    export_compiled(rpred, [_x(3, 8)], rart)
    sig = json.load(open(os.path.join(rart, 'signature.json')))
    assert [f['shape'] for f in sig['fetches']] == [[8, 4], [1]]
    rserved = CompiledPredictor(rart)
    outs = rserved.run([_x(3, 8)])
    assert outs[0].shape == (8, 4) and outs[1].size == 1
    with pytest.raises(ValueError, match='not batch-aligned'):
        rserved.run([_x(3, 3)])
    # a legacy v2 signature (no fetch shapes) loads, and the same error
    # comes after the run instead of before it
    for e in sig['fetches']:
        e.pop('shape')
    sig['version'] = 2
    with open(os.path.join(rart, 'signature.json'), 'w') as f:
        json.dump(sig, f)
    legacy = CompiledPredictor(rart)
    outs = legacy.run([_x(3, 8)])
    np.testing.assert_array_equal(outs[0], rpred.run([_x(3, 8)])[0])
    with pytest.raises(ValueError, match='not batch-aligned'):
        legacy.run([_x(3, 3)])


def test_run_batches_equals_run_with_group_tail(fc_dir, tmp_path):
    pred = _predictor(os.path.join(fc_dir, 'model'))
    art = str(tmp_path / 'art')
    export_compiled(pred, [_x(0, 5)], art)
    served = CompiledPredictor(art)
    xs = [_x(10 + i, 5) for i in range(5)]
    seq = [served.run([x])[0] for x in xs]
    for group in (None, 2):
        bulk = served.run_batches([{'img': x} for x in xs], group=group)
        assert len(bulk) == 5
        for s, b in zip(seq, bulk):
            np.testing.assert_array_equal(s, b[0])
    stats = served.bulk_stats()
    assert sorted(stats) == ['batches', 'batches_per_dispatch',
                             'dispatches', 'host_stall_ms', 'occupancy',
                             'tail_flushes']
    # one dispatch for the whole, then 2 + 2 + a tail of 1
    assert stats['dispatches'] == 4 and stats['batches'] == 10
    assert stats['tail_flushes'] == 1 and 0 < stats['occupancy'] <= 1
    # partial batches pad per batch, as run() pads them
    part = served.run_batches([[xs[0][:3]], [xs[1]]])
    np.testing.assert_array_equal(part[0][0], served.run([xs[0][:3]])[0])
    assert served.run_batches([]) == []
    with pytest.raises(ValueError, match='group'):
        served.run_batches([[xs[0]]], group=0)


def test_int8_lod_and_jax_artifacts_raise(fc_dir, jax_side, tmp_path):
    pred = _predictor(os.path.join(fc_dir, 'model'))
    # the int8 tier is ported (tests/test_torch_quant.py); without a
    # calibration sweep it is refused
    with pytest.raises(ValueError, match='requires calibration'):
        export_compiled(pred, [_x(0, 4)], str(tmp_path / 'q'),
                        quantize='int8')
    with pytest.raises(ValueError, match='quantize'):
        export_compiled(pred, [_x(0, 4)], str(tmp_path / 'q'),
                        quantize='int4')
    with pytest.raises(ValueError, match='no .int8. tier'):
        CompiledPredictor(str(tmp_path / 'missing'), tier='int8')

    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        words = ptt.layers.data(name='words', shape=[DIM], dtype='float32',
                                lod_level=1)
        out = ptt.layers.fc(words, 4)
    exe = ptt.Executor(ptt.CPUPlace())
    d = str(tmp_path / 'lod_model')
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        ptt.io.save_inference_model(d, ['words'], [out], exe, main)
    with pytest.raises(NotImplementedError, match='item 8'):
        export_compiled(_predictor(d), [_x(0, 4)], str(tmp_path / 'lod'))

    # each package refuses the other's artifact
    for art in (os.path.join(jax_side, 'fc', 'jax_art'),
                os.path.join(jax_side, 'fc', 'jax_art', 'bucket_00008')):
        with pytest.raises(ValueError, match='jax.export artifact'):
            CompiledPredictor(art)
    with open(os.path.join(jax_side, 'refusal.json')) as f:
        assert json.load(f)['refusal'] is not None


_CLI = r'''
import json, sys
import numpy as np
from paddle_tpu_torch.inference import serve
art, d, lm = sys.argv[1], sys.argv[2], sys.argv[3]
assert serve.main(['serve.py', art, d + '/in.npz', d + '/out.npz']) == 0
assert serve.main(['serve.py', 'loop', art, d + '/loop_in.npz',
                   d + '/loop_out.npz', '2']) == 0
assert serve.main(['serve.py', 'bench', art, d + '/one.npz', '12',
                   '5']) == 0
assert serve.main(['serve.py', 'decode', lm, d + '/prompts.npz',
                   d + '/tokens.npz', '4']) == 0
assert serve.main(['serve.py', 'fleet', art, d + '/in.npz', '4']) == 0
assert serve.main(['serve.py', 'gateway', art]) == 2
assert serve.main(['serve.py']) == 2
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))
assert not leaked, leaked
'''


def test_serve_cli_fresh_process(fc_dir, tmp_path):
    """run, loop, bench, decode and fleet through serve.main in one fresh
    interpreter on PTPU_PLATFORM=cpu, which loads neither jax nor
    paddle_tpu; gateway prints that it is not ported and returns 2."""
    from paddle_tpu_torch.inference import DecodingPredictor, export_decode
    from paddle_tpu_torch.models.transformer import build_decode_spec
    pred = _predictor(os.path.join(fc_dir, 'model'))
    art = str(tmp_path / 'art')
    export_compiled(pred, [_x(0, 4)], art, batch_sizes=[2, 4])
    xs = np.stack([_x(20 + i, 4) for i in range(3)])
    np.savez(str(tmp_path / 'in.npz'), img=xs[0][:3])
    np.savez(str(tmp_path / 'loop_in.npz'), img=xs)
    np.savez(str(tmp_path / 'one.npz'), img=xs[0][:1])
    with ptt.unique_name.guard():
        spec = build_decode_spec(vocab=37, d_model=16, n_head=2, n_layer=1,
                                 d_ff=32, max_slots=2, max_cache_len=16,
                                 prompt_buckets=(4,), eos_id=1)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(spec['startup'], scope=scope)
    lm = str(tmp_path / 'lm')
    export_decode(spec, lm, scope=scope)
    prompts = np.array([[5, 6, 7, 0], [9, 3, 0, 0]], np.int64)
    np.savez(str(tmp_path / 'prompts.npz'), prompts=prompts,
             lens=np.array([3, 2]))
    env = dict(os.environ, PTPU_PLATFORM='cpu', PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, '-c', _CLI, art, str(tmp_path), lm],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert 'not ported yet' in r.stderr
    name = pred.get_output_names()[0]
    served = CompiledPredictor(art)
    with np.load(str(tmp_path / 'out.npz')) as out:
        np.testing.assert_array_equal(out[name],
                                      served.run([xs[0][:3]])[0])
    with np.load(str(tmp_path / 'loop_out.npz')) as out:
        np.testing.assert_array_equal(
            out[name], np.stack([served.run([x])[0] for x in xs]))
    bench = json.loads(r.stdout.strip().splitlines()[-3])
    assert bench['req_s'] > 0 and bench['p99_ms'] >= bench['p50_ms'] > 0
    decoded = json.loads(r.stdout.strip().splitlines()[-2])
    assert decoded['requests'] == 2
    fleet = json.loads(r.stdout.strip().splitlines()[-1])
    assert fleet['requests'] == 4 and fleet['failed'] == 0
    assert all(s['compiles'] == 0 for s in fleet['per_replica'].values())
    with np.load(str(tmp_path / 'tokens.npz')) as out, DecodingPredictor(
            lm, place=ptt.CPUPlace()) as dp:
        for i, n in enumerate((3, 2)):
            want = dp.generate(prompts[i, :n], max_new_tokens=4)
            got = out['tokens'][i][:out['n_tokens'][i]]
            np.testing.assert_array_equal(got, want)


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
