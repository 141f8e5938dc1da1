"""The int8 serving tier on a card: the quant ops' integer route
(torch._int_mm, exact int32 sums) against their plain versions, the
int8 KV ops against their CPU runs, and an int8-tier artifact served by
CompiledPredictor and BatchingPredictor on CUDAPlace(0).

Run on a machine with an NVIDIA GPU (no jax needed):

    python -m pytest --noconftest tests/test_torch_quant_cuda.py

Without a card the tests skip. The card's int32 sums are held against
the plain versions computed in float64 on the card, where every sum of
int8 products is exact: equal, bit for bit (cuDNN's f32 algorithms,
Winograd and FFT among them, need not be exact on integers, so the f32
plain version is no exact yardstick there).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.inference import (BatchingPredictor, CompiledPredictor,
                                        Config, create_predictor,
                                        export_compiled)
from paddle_tpu_torch.ops import quant_ops


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: these tests run the int8 route on a card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _i8(shape, seed, device):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        -127, 128, shape).astype(np.int8)).to(device)


class _Ctx(object):
    def __init__(self, attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _held(got, want):
    assert torch.equal(got.double().cpu(), want.cpu())


# ResNet-50's kinds of convolution (the 7x7 stem, 3x3, strided 1x1, the
# widest 3x3) at a small batch and side
@pytest.mark.cuda
@pytest.mark.parametrize('shape', [
    ((2, 3, 32, 32), (64, 3, 7, 7), 2, 3),       # the stem, K = 147
    ((2, 64, 14, 14), (64, 64, 3, 3), 1, 1),
    ((2, 256, 14, 14), (128, 256, 1, 1), 2, 0),
    ((2, 512, 7, 7), (512, 512, 3, 3), 1, 1),    # K = 4608
])
def test_conv2d_int8_route(card, shape):
    xs, ws, st, pd = shape
    x, w = _i8(xs, 1, card), _i8(ws, 2, card)
    conv = ([st, st], [pd, pd], [1, 1], 1)
    quant_ops.reset_launches()
    got = quant_ops.conv2d_int8_card(x, w, *conv).permute(0, 3, 1, 2)
    assert quant_ops.int8_gemm.launches == 1 and got.dtype == torch.int32
    _held(got, quant_ops.conv2d_int8_plain(x, w, *conv, dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize('rows', [1, 8, 32])
def test_mul_int8_route_fc(card, rows):
    """ResNet-50's FC at buckets 1, 8 and 32: rows pad to 17 below 17."""
    x, y = _i8((rows, 2048), 3, card), _i8((2048, 1000), 4, card)
    quant_ops.reset_launches()
    got = quant_ops.int8_gemm(x, y.t(), 'mul_int8')
    assert quant_ops.int8_gemm.launches_by_op == {'mul_int8': 1}
    _held(got, quant_ops.mul_int8_plain(x, y, dtype=torch.float64))


@pytest.mark.cuda
def test_quantize_int8_divides(card):
    """round(x / scale) with a true division on the card: the CPU's
    result exactly, where a reciprocal multiply would move some .5
    steps."""
    x = torch.randn(1 << 16, generator=torch.Generator().manual_seed(0)) * 7
    ins = {'X': [x.to(card)]}
    for scale in (0.0371, 0.1, 1 / 3):
        ctx = _Ctx({'scale': scale})
        got = registry.get('quantize_int8').lower(ctx, ins)['Out'][0]
        want = registry.get('quantize_int8').lower(ctx, {'X': [x]})['Out'][0]
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_kv_quant_ops_match_cpu(card):
    """A write and an attention of the int8 slot cache on the card against
    the same ops on the CPU: pages equal, scales equal, attention within
    1e-5 of its largest |value|."""
    rng = np.random.RandomState(0)
    S, T, D = 4, 32, 64
    cache = rng.randint(-127, 128, (S, T, D)).astype(np.int8)
    scale = (rng.rand(S, T) * 0.05 + 1e-3).astype(np.float32)
    kv = rng.randn(S, D).astype(np.float32)
    pos = np.array([[3], [31], [0], [17]], np.int32)
    q = rng.randn(S, D).astype(np.float32)
    outs = {}
    for dev in ('cpu', card):
        t = {k: torch.from_numpy(v.copy()).to(dev) for k, v in dict(
            Cache=cache, Scale=scale, KV=kv, Pos=pos).items()}
        w = registry.get('kv_cache_write_quant').lower(
            _Ctx({}), {k: [v] for k, v in t.items()})
        a = registry.get('kv_cache_attention_quant').lower(
            _Ctx({'n_head': 8, 'scale': 0.0}),
            {'Q': [torch.from_numpy(q).to(dev)], 'KCache': w['Out'],
             'KScale': w['OutScale'], 'VCache': w['Out'],
             'VScale': w['OutScale'], 'Pos': [t['Pos']]})
        outs[str(dev)] = [w['Out'][0].cpu(), w['OutScale'][0].cpu(),
                          a['Out'][0].cpu()]
    c, g = outs['cpu'], outs['cuda']
    assert torch.equal(c[0], g[0]) and torch.equal(c[1], g[1])
    assert (c[2] - g[2]).abs().max().item() <= 1e-5 * c[2].abs().max().item()


@pytest.mark.cuda
def test_int8_tier_served_on_card(card, tmp_path):
    """A small conv + fc net's int8 tier on CUDAPlace(0): CompiledPredictor
    and BatchingPredictor run the integer route (one int8_gemm per
    quantized op a batch), and each batched request equals its unbatched
    run through the same bucket bit for bit."""
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 7
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        img = ptt.layers.data(name='img', shape=[3, 16, 16], dtype='float32')
        c = ptt.layers.conv2d(img, 16, 3, padding=1, act='relu')
        c = ptt.layers.conv2d(c, 32, 3, stride=2, padding=1, act='relu')
        logits = ptt.layers.fc(c, 16)
    exe = ptt.Executor(ptt.CUDAPlace(0))
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        ptt.io.save_inference_model(str(tmp_path / 'model'), ['img'],
                                    [logits], exe, main)
    pred = create_predictor(Config(str(tmp_path / 'model')))
    rng = np.random.RandomState(0)
    calib = [{'img': rng.randn(8, 3, 16, 16).astype(np.float32)}
             for _ in range(2)]
    art = str(tmp_path / 'art')
    export_compiled(pred, [calib[0]['img']], art, batch_sizes=[8],
                    quantize='int8', calibration=calib)
    p = CompiledPredictor(art, tier='int8')
    assert p.tier == 'int8' and p.place == ptt.CUDAPlace(0)
    quant_ops.reset_launches()
    want = p.run([calib[1]['img']])[0]
    assert quant_ops.int8_gemm.launches == 3
    rows = calib[1]['img']
    with BatchingPredictor(art, tier='int8', batch_timeout_ms=50) as b:
        futs = [b.submit([rows[i:i + 1]]) for i in range(8)]
        got = [f.result(60)[0] for f in futs]
    for i in range(8):
        assert np.array_equal(got[i], p.run([rows[i:i + 1]])[0])
    assert np.isfinite(want).all() and want.shape == (8, 16)
    assert os.path.isdir(os.path.join(art, 'int8', 'bucket_00008'))
