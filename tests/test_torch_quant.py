"""The int8 serving tier of export_compiled on the port, held against
paddle_tpu on the CPU.

1. The five quant ops (quantize_int8, dequantize_int8, mul_int8,
   conv2d_int8, depthwise_conv2d_int8) on the same seeded numpy inputs as
   the reference's lowerings (their CPU branch, f32 on the integer
   values): equal where every partial sum is an integer f32 holds exactly
   (K * 127^2 <= 2^24, i.e. K <= 1040), within SUM_TOL = 1e-6 of the
   largest |out| above it (the two f32 sums round in other orders). The
   quantize case puts values on .5 steps: round half to even. The card's
   route (an im2col of the int8 input, torch._int_mm with its padding, the
   epilogue's NCHW layout) is run here through torch's CPU _int_mm
   (ops/quant_ops.padded_int_mm) and held against the plain f32 route:
   equal below the limit, within SUM_TOL above it.
2. The pass on a small conv + batch_norm + conv + pool + fc net that
   paddle_tpu initializes and saves (the port loads the same directory):
   the calibration sweep's statistics within CALIB_TOL = 1e-5 relative
   (activations past the input differ by f32 rounding); given the
   reference's calibration, the same int8 weights and weight scales bit
   for bit, the same activation scales, quantized_ops, float_ops and
   reasons, the same op-type sequence; and the reason codes of a user skip
   and of a sweep-less pass.
3. export_compiled(quantize='int8') at buckets 1 and 4: the tier's layout
   and signature against the reference's; CompiledPredictor and
   BatchingPredictor with tier='int8' against the reference's int8
   CompiledPredictor on the same rows: argmax equal, logits within
   SERVE_TOL = 1e-3 of the largest |logit| (each package calibrates on its
   own activations, so an activation near a .5 step may round one level
   apart); the explicit-missing-tier error, the env preference's
   fallback, the removal of a stale tier, and int8 tensors through
   io._serialize_tensor and its reader.

paddle_tpu's side runs once, in a fresh interpreter (this file run as a
script, PTPU_ARTIFACT_AOT=0, export_compiled(precompile=False)).
"""
import io as _pyio
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import io as ptt_io
from paddle_tpu_torch import passes
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.inference import (BatchingPredictor, CompiledPredictor,
                                        Config, create_predictor,
                                        export_compiled)
from paddle_tpu_torch.ops import quant_ops
from paddle_tpu_torch.passes import quantize as quant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUM_TOL = 1e-6
CALIB_TOL = 1e-5
SERVE_TOL = 1e-3
EXACT_K = 1040          # K * 127^2 <= 2^24: every f32 partial sum exact
BUCKETS = [1, 4]
SIDE = 12


# -- 1. the ops --------------------------------------------------------------
def _i8(shape, seed):
    return np.random.RandomState(seed).randint(-127, 128, shape).astype(
        np.int8)


def _scale(n, seed):
    return (np.random.RandomState(seed).rand(n) * 0.02 + 1e-3).astype(
        np.float32)


# (name, x shape, w shape, strides, paddings, dilations, groups)
CONV_CASES = [
    ('3x3_pad1', (2, 8, 9, 9), (16, 8, 3, 3), 1, 1, 1, 1),
    ('3x3_stride2', (2, 8, 9, 9), (8, 8, 3, 3), 2, 1, 1, 1),
    ('stem_7x7_K147', (1, 3, 16, 16), (8, 3, 7, 7), 2, 3, 1, 1),
    ('1x1_odd_out', (3, 16, 5, 5), (12, 16, 1, 1), 1, 0, 1, 1),
    ('dilated', (1, 4, 10, 10), (8, 4, 3, 3), 1, 2, 2, 1),
    ('groups2', (2, 8, 6, 6), (8, 4, 3, 3), 1, 1, 1, 2),
    ('K1152_past_exact', (1, 128, 5, 5), (8, 128, 3, 3), 1, 1, 1, 1),
]
# (name, x shape, w shape, x_num_col_dims)
MUL_CASES = [('fc_b1', (1, 64), (64, 24), 1),
             ('fc_b5_K2048', (5, 2048), (2048, 10), 1),
             ('flatten2', (2, 3, 40), (40, 16), 2)]


def _op_cases():
    """{case: (op type, {slot: numpy}, attrs, K)}, the same in both
    processes."""
    c = {}
    scale = 0.25
    x = (np.arange(-600, 601, dtype=np.float32) / 2 * scale).reshape(1, -1)
    x = np.concatenate([x, np.random.RandomState(1).randn(1, 1201).astype(
        np.float32) * 20], axis=0)
    c['quantize_int8/half_steps'] = ('quantize_int8', {'X': x},
                                     {'scale': scale}, 0)
    c['quantize_int8/odd_scale'] = ('quantize_int8', {'X': x},
                                    {'scale': 0.0371}, 0)
    c['dequantize_int8'] = ('dequantize_int8', {'X': _i8((4, 9), 2)},
                            {'scale': 0.0371}, 0)
    for i, (name, xs, ws, xn) in enumerate(MUL_CASES):
        c['mul_int8/' + name] = (
            'mul_int8', {'X': _i8(xs, 10 + i), 'Y': _i8(ws, 20 + i),
                         'Scale': _scale(ws[-1], 30 + i)},
            {'in_scale': 0.0173, 'x_num_col_dims': xn, 'y_num_col_dims': 1},
            ws[0])
    for i, (name, xs, ws, st, pd, dl, g) in enumerate(CONV_CASES):
        c['conv2d_int8/' + name] = (
            'conv2d_int8', {'Input': _i8(xs, 40 + i), 'Filter': _i8(ws, 50 + i),
                            'Scale': _scale(ws[0], 60 + i)},
            {'in_scale': 0.0211, 'strides': [st, st], 'paddings': [pd, pd],
             'dilations': [dl, dl], 'groups': g},
            ws[1] * ws[2] * ws[3])
    c['depthwise_conv2d_int8/3x3'] = (
        'depthwise_conv2d_int8', {'Input': _i8((2, 6, 7, 7), 70),
                                  'Filter': _i8((6, 1, 3, 3), 71),
                                  'Scale': _scale(6, 72)},
        {'in_scale': 0.05, 'strides': [1, 1], 'paddings': [1, 1],
         'dilations': [1, 1], 'groups': 6}, 9)
    return c


class _Ctx(object):
    """The part of an op context these lowerings read."""

    def __init__(self, attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _jax_ops():
    """Each case through the reference's lowering, jitted as its serving
    programs run it."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core import registry as jax_registry
    out = {}
    for case, (op, ins, attrs, _) in _op_cases().items():
        lower = jax.jit(lambda a, op=op, attrs=attrs: jax_registry.get(
            op).lower(_Ctx(attrs), {k: [v] for k, v in a.items()}))
        got = lower({k: jnp.asarray(v) for k, v in ins.items()})
        out[case] = np.asarray(next(iter(got.values()))[0])
    return out


def _port_op(op, ins, attrs):
    got = registry.get(op).lower(
        _Ctx(attrs), {k: [torch.from_numpy(v)] for k, v in ins.items()})
    return next(iter(got.values()))[0].numpy()


# -- 2./3. the net -----------------------------------------------------------
def _net(pkg):
    """conv 3x3 + batch_norm + relu, conv 3x3 stride 2 + relu, avg pool,
    fc 10 (logits): four quantizable ops, seed 7."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img = pkg.layers.data(name='img', shape=[3, SIDE, SIDE],
                              dtype='float32')
        c = pkg.layers.conv2d(img, 8, 3, padding=1, bias_attr=False)
        c = pkg.layers.batch_norm(c, act='relu', is_test=True)
        c = pkg.layers.conv2d(c, 16, 3, stride=2, padding=1, act='relu')
        p = pkg.layers.pool2d(c, 2, 'avg', pool_stride=2)
        h = pkg.layers.fc(p, 24, act='relu')
        logits = pkg.layers.fc(h, 10)
    return main, startup, logits


def _calib_batches():
    rng = np.random.RandomState(0)
    return [{'img': rng.randn(4, 3, SIDE, SIDE).astype(np.float32)}
            for _ in range(2)]


def _rows(n, seed=5):
    return np.random.RandomState(seed).randn(n, 3, SIDE, SIDE).astype(
        np.float32)


def _report(rep, prog):
    d = rep.details
    return {'quantized_ops': d['quantized_ops'], 'float_ops': d['float_ops'],
            'float_op_reasons': d['float_op_reasons'],
            'act_scales': d['act_scales'],
            'weight_bytes_before': d['weight_bytes_before'],
            'weight_bytes_after': d['weight_bytes_after'],
            'float_weights_pruned': d['float_weights_pruned'],
            'types': [op.type for op in prog.global_block().ops]}


def _jax_reference(root):
    """paddle_tpu's side, under root: ops.npz; the net saved (model/);
    its calibration (calib.json), the pass's reports (reports.json: with
    that calibration, with a user skip, with none) and int8 weights
    (weights.npz); the int8-tier artifact (art/) and its int8 and default
    CompiledPredictors' logits on _rows(4) and _rows(1) (logits.npz)."""
    np.savez(os.path.join(root, 'ops.npz'),
             **{k.replace('/', '|'): v for k, v in _jax_ops().items()})
    import paddle_tpu as fluid
    from paddle_tpu.inference import CompiledPredictor as JaxCompiled
    from paddle_tpu.inference import Config as JaxConfig
    from paddle_tpu.inference import create_predictor as jax_predictor
    from paddle_tpu.inference import export_compiled as jax_export
    main, startup, logits = _net(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    mdir = os.path.join(root, 'model')
    with fluid.scope_guard(scope):
        exe.run(startup)
        # BN running stats and affine params away from the identity
        rng = np.random.RandomState(9)
        for op in main.global_block().ops:
            if op.type != 'batch_norm':
                continue
            c = main.global_block().var(op.input('Scale')[0]).shape[0]
            for slot, lo, hi in (('Scale', 0.5, 1.5), ('Bias', -.2, .2),
                                 ('Mean', -.2, .2), ('Variance', 0.5, 2.0)):
                scope.var(op.input(slot)[0]).get_tensor().set(
                    rng.uniform(lo, hi, c).astype(np.float32))
        fluid.io.save_inference_model(mdir, ['img'], [logits], exe, main)
    pred = jax_predictor(JaxConfig(mdir).disable_gpu())
    calib = fluid.passes.calibrate_program(
        pred._program, _calib_batches(), pred._exe, scope=pred._scope)
    with open(os.path.join(root, 'calib.json'), 'w') as f:
        json.dump(calib.as_dict(), f)
    fetch = [v.name for v in pred._fetch_vars]
    reports = {}
    w_conv = [op.input('Filter')[0] for op in pred._program.global_block().ops
              if op.type == 'conv2d'][0]
    for tag, cal, skip in (('calibrated', calib, ()),
                           ('skip', calib, (w_conv,)),
                           ('none', None, ())):
        prog, rep = fluid.passes.quantize_program(
            pred._program, cal, pred._scope, fetch_names=fetch,
            feed_names=['img'], skip_vars=skip)
        reports[tag] = _report(rep, prog)
        if tag == 'calibrated':
            np.savez(os.path.join(root, 'weights.npz'), **{
                v.name: np.asarray(pred._scope.get(v.name))
                for v in prog.list_vars()
                if v.persistable and (v.name.endswith('.int8')
                                      or v.name.endswith('.scale'))})
    with open(os.path.join(root, 'reports.json'), 'w') as f:
        json.dump(reports, f)
    art = os.path.join(root, 'art')
    jax_export(pred, [_rows(4)], art, batch_sizes=BUCKETS, quantize='int8',
               calibration=_calib_batches(), precompile=False)
    out = {}
    for tier in ('bf16', 'int8'):
        p = JaxCompiled(art, tier=tier)
        for n in (4, 1):
            out['%s_%d' % (tier, n)] = np.asarray(p.run([_rows(n)])[0])
    np.savez(os.path.join(root, 'logits.npz'), **out)


@pytest.fixture(scope='module')
def jax_side(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('quant_cross'))
    env = dict(os.environ, PTPU_ARTIFACT_AOT='0', PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with np.load(os.path.join(root, 'ops.npz')) as f:
        ops = {k.replace('|', '/'): f[k] for k in f.files}
    return root, ops


def _predictor(root):
    return create_predictor(Config(os.path.join(root, 'model')).disable_gpu())


@pytest.fixture(scope='module')
def port_art(jax_side, tmp_path_factory):
    """The port's int8-tier artifact of the reference's saved net."""
    art = str(tmp_path_factory.mktemp('quant_port') / 'art')
    pred = _predictor(jax_side[0])
    with warnings.catch_warnings():
        warnings.simplefilter('error', RuntimeWarning)
        export_compiled(pred, [_rows(4)], art, batch_sizes=BUCKETS,
                        quantize='int8', calibration=_calib_batches())
    return art


def _held(got, want, k):
    assert got.shape == want.shape and got.dtype == want.dtype
    if k <= EXACT_K:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=SUM_TOL * np.abs(want).max())


@pytest.mark.parametrize('case', sorted(_op_cases()))
def test_op_matches_reference(jax_side, case):
    op, ins, attrs, k = _op_cases()[case]
    _held(_port_op(op, ins, attrs), jax_side[1][case], k)


@pytest.mark.parametrize('case', [c for c in sorted(_op_cases())
                                  if c.split('/')[0] in ('mul_int8',
                                                         'conv2d_int8',
                                                         'depthwise_conv2d_int8')])
def test_card_lowering_matches_plain(monkeypatch, case):
    """The whole lowering on the card's route (the integer sums, the
    dequant epilogue and its NCHW layout), run on CPU tensors through
    torch's CPU _int_mm, against the plain route's output: equal below the
    exactness limit, within SUM_TOL above it."""
    op, ins, attrs, k = _op_cases()[case]
    want = _port_op(op, ins, attrs)
    monkeypatch.setattr(quant_ops, '_on_card', lambda t: True)
    monkeypatch.setattr(quant_ops, 'int8_gemm',
                        lambda a, bt, op_type=None:
                        quant_ops.padded_int_mm(a, bt))
    got = _port_op(op, ins, attrs)
    _held(got, want, k)


def test_padded_int_mm_shape_rules():
    """The pads int8_gemm adds for the card's _int_mm rules (rows > 16, K
    and N multiples of 8) are zeros and are sliced off: a 1-row product
    with K = 147 and N = 1000 equals the unpadded one."""
    a, bt = torch.from_numpy(_i8((1, 147), 1)), torch.from_numpy(
        _i8((1000, 147), 2))
    got = quant_ops.padded_int_mm(a, bt)
    assert got.shape == (1, 1000) and got.dtype == torch.int32
    assert torch.equal(got, a.int() @ bt.int().t())
    with pytest.raises(ValueError, match='CUDA'):
        quant_ops.int8_gemm(a, bt)


def test_calibration_matches_reference(jax_side):
    pred = _predictor(jax_side[0])
    calib = passes.calibrate_program(pred._program, _calib_batches(),
                                     pred._exe, scope=pred._scope)
    with open(os.path.join(jax_side[0], 'calib.json')) as f:
        want = json.load(f)
    assert sorted(calib.stats) == sorted(want['stats'])
    assert passes.calibration_targets(pred._program)[0] == 'img'
    for name, ent in want['stats'].items():
        got = calib.stats[name]
        assert got['batches'] == ent['batches'] == 2
        tol = 0.0 if name == 'img' else CALIB_TOL
        for key in ('abs_max', 'percentile'):
            np.testing.assert_allclose(got[key], ent[key], rtol=tol)


@pytest.mark.parametrize('tag', ['calibrated', 'skip', 'none'])
def test_pass_matches_reference(jax_side, tag):
    """quantize_program given the reference's calibration: the report, the
    op types, and (calibrated) the int8 weights and scales bit for bit."""
    root = jax_side[0]
    with open(os.path.join(root, 'calib.json')) as f:
        calib = quant.CalibrationResult.from_dict(json.load(f))
    with open(os.path.join(root, 'reports.json')) as f:
        want = json.load(f)[tag]
    pred = _predictor(root)
    fetch = [v.name for v in pred._fetch_vars]
    w_conv = [op.input('Filter')[0] for op in pred._program.global_block().ops
              if op.type == 'conv2d'][0]
    prog, rep = passes.quantize_program(
        pred._program, None if tag == 'none' else calib, pred._scope,
        fetch_names=fetch, feed_names=['img'],
        skip_vars=(w_conv,) if tag == 'skip' else ())
    got = _report(rep, prog)
    assert got == want
    assert all(e['reason'] in quant.REASON_CODES for e in got['float_ops'])
    if tag != 'calibrated':
        return
    assert got['quantized_ops'] == 4
    with np.load(os.path.join(root, 'weights.npz')) as f:
        weights = dict(f)
    assert weights
    for name, arr in weights.items():
        t = pred._scope.get(name)
        assert str(t.dtype)[6:] == arr.dtype.name
        np.testing.assert_array_equal(t.numpy(), arr)
    # the original program is untouched
    assert 'conv2d' in [op.type for op in pred._program.global_block().ops]


def _sig(d):
    with open(os.path.join(d, 'signature.json')) as f:
        return json.load(f)


def test_tier_layout_and_signature(jax_side, port_art):
    want_top = _sig(os.path.join(jax_side[0], 'art'))
    top = _sig(port_art)
    assert top['tiers'] == want_top['tiers'] == ['bf16', 'int8']
    assert top['tier'] == 'bf16' and top['buckets'] == BUCKETS
    assert sorted(os.listdir(os.path.join(port_art, 'int8'))) == [
        '__model__', 'bucket_00001', 'bucket_00004', 'params',
        'signature.json']
    q, wq = top['quantization'], want_top['quantization']
    for key in ('method', 'mode', 'percentile_q', 'calibration_batches',
                'quantized_ops', 'float_ops', 'float_op_reasons',
                'weight_bytes_before', 'weight_bytes_after'):
        assert q[key] == wq[key], key
    assert sorted(q['act_scales']) == sorted(wq['act_scales'])
    for name, s in wq['act_scales'].items():
        np.testing.assert_allclose(q['act_scales'][name], s, rtol=CALIB_TOL)
    tier = _sig(os.path.join(port_art, 'int8'))
    assert tier['tier'] == 'int8' and tier['buckets'] == BUCKETS
    assert tier['quantization'] == q
    for b in BUCKETS:
        bsig = _sig(os.path.join(port_art, 'int8', 'bucket_%05d' % b))
        assert bsig['tier'] == 'int8' and bsig['root'] == '..'
        assert bsig['feeds'][0]['shape'] == [b, 3, SIDE, SIDE]
        assert bsig['fetches'][0]['shape'] == [b, 10]
    # the tier's program holds the int8 ops and its parameters the int8
    # weights; the replaced f32 weights are gone from it
    with open(os.path.join(port_art, 'int8', '__model__')) as f:
        types = [op['type'] for op in json.load(f)['blocks'][0]['ops']]
    assert types.count('conv2d_int8') == 2 and types.count('mul_int8') == 2
    assert 'conv2d' not in types and 'mul' not in types
    params = os.listdir(os.path.join(port_art, 'int8', 'params'))
    assert any(p.endswith('.int8') for p in params)


def _logits(jax_side):
    with np.load(os.path.join(jax_side[0], 'logits.npz')) as f:
        return dict(f)


def _near(got, want):
    got = np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert (got.argmax(1) == want.argmax(1)).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SERVE_TOL * np.abs(want).max())


def test_compiled_predictor_int8_matches_reference(jax_side, port_art):
    want = _logits(jax_side)
    for tier in ('bf16', 'int8'):
        p = CompiledPredictor(port_art, platform='cpu', tier=tier)
        assert p.tier == tier
        for n in (4, 1):
            _near(p.run([_rows(n)])[0], want['%s_%d' % (tier, n)])
    # the int8 tier is not the default one
    assert not np.array_equal(want['int8_4'], want['bf16_4'])


def test_batching_predictor_int8_matches_reference(jax_side, port_art,
                                                   tmp_path):
    """Four batch-1 requests through BatchingPredictor(tier='int8'): each
    near the reference's int8 logits of its row; and through a 4-row
    single-bucket int8 artifact, each equal bit for bit to
    CompiledPredictor(tier='int8').run of that request through the same
    bucket, wherever it landed in its batch."""
    want = _logits(jax_side)['int8_4']
    rows = _rows(4)

    def served(art):
        with BatchingPredictor(art, platform='cpu', tier='int8',
                               batch_timeout_ms=50) as b:
            assert b.tier == 'int8'
            futs = [b.submit([rows[i:i + 1]]) for i in range(4)]
            got = [f.result(60)[0] for f in futs]
            assert b.stats.snapshot()['tier'] == 'int8'
        return got
    _near(np.concatenate(served(port_art)), want)
    one = str(tmp_path / 'one')
    export_compiled(_predictor(jax_side[0]), [_rows(4)], one,
                    batch_sizes=[4], quantize='int8',
                    calibration=_calib_batches())
    seq = CompiledPredictor(one, platform='cpu', tier='int8')
    for i, got in enumerate(served(one)):
        assert np.array_equal(got, seq.run([rows[i:i + 1]])[0]), i


def test_missing_tier_stale_tier_and_calibration(jax_side, port_art,
                                                 tmp_path, monkeypatch):
    pred = _predictor(jax_side[0])
    plain = str(tmp_path / 'plain')
    export_compiled(pred, [_rows(4)], plain)
    with pytest.raises(ValueError, match="no 'int8' tier"):
        CompiledPredictor(plain, platform='cpu', tier='int8')
    with pytest.raises(ValueError, match="no 'int8' tier"):
        BatchingPredictor(plain, platform='cpu', tier='int8')
    with pytest.raises(ValueError, match='requires calibration'):
        export_compiled(pred, [_rows(4)], plain, quantize='int8')
    with pytest.raises(ValueError, match='quantize'):
        export_compiled(pred, [_rows(4)], plain, quantize='int4')
    # the env preference falls back where the tier is absent
    monkeypatch.setenv('PTPU_SERVE_TIER', 'int8')
    assert CompiledPredictor(plain, platform='cpu').tier == 'bf16'
    assert CompiledPredictor(port_art, platform='cpu').tier == 'int8'
    assert CompiledPredictor(os.path.join(port_art, 'int8', 'bucket_00004'),
                             platform='cpu').tier == 'int8'
    monkeypatch.delenv('PTPU_SERVE_TIER')
    # a re-export without quantize removes the stale int8 tree
    tiered = str(tmp_path / 'tiered')
    export_compiled(pred, [_rows(4)], tiered, quantize='int8',
                    calibration=_calib_batches()[:1])
    assert _sig(os.path.join(tiered, 'int8'))['tier'] == 'int8'
    with pytest.warns(RuntimeWarning, match='stale int8 tier'):
        export_compiled(pred, [_rows(4)], tiered)
    assert not os.path.exists(os.path.join(tiered, 'int8'))
    assert 'tiers' not in _sig(tiered)


def test_int8_tensor_roundtrip():
    t = torch.from_numpy(_i8((3, 5, 7), 3))
    buf = _pyio.BytesIO()
    ptt_io._serialize_tensor(buf, t)
    back, end = ptt_io._deserialize_tensor(buf.getvalue(), 'cpu')
    assert end == len(buf.getvalue())
    assert back.dtype == torch.int8 and torch.equal(back, t)


def test_op_registry_counts():
    """The int8 family and the eleven int8 KV ops are registered, beside
    the reduce family, cudnn_lstm, sigmoid_cross_entropy_with_logits and
    the two SelectedRows ops: 114 op types."""
    for op in ('quantize_int8', 'dequantize_int8', 'mul_int8', 'conv2d_int8',
               'depthwise_conv2d_int8'):
        assert registry.get(op) is not None and registry.get(op).no_grad
    assert len(registry._REGISTRY) == 114


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
