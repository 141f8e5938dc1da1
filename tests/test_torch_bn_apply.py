"""The port's bn_apply against the TPU kernel it replaces.

paddle_tpu/ops/pallas_bn.py's Pallas kernel runs here in interpret mode
(pallas_call patched with interpret=True for the test only), and the port's
bn_apply takes its plain PyTorch version on CPU tensors. The CUDA kernel
itself runs only on a card: tests/test_torch_bn_apply_cuda.py holds it
against the plain version there.
"""
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops import bn_apply as bn_mod
from paddle_tpu.ops import pallas_bn

SHAPES = [(2, 12, 7, 7), (2, 10, 14, 14), (1, 16, 32, 32)]
# f32: the kernel and the interpret-mode Pallas body both compute x*k + b;
# bf16: one bf16 rounding step (2^-8 relative) plus the different rounding
# points of the two frameworks
TOL = {'float32': 1e-6, 'bfloat16': 2e-2}


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    k = rng.uniform(0.5, 1.5, shape[1]).astype(np.float32)
    b = rng.randn(shape[1]).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('act', [None, 'relu'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_bn_apply_matches_pallas_kernel(monkeypatch, dtype, act, shape):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    x, k, b = _inputs(shape)
    jy = pallas_bn.fused_bn_apply(jnp.asarray(x).astype(dtype),
                                  jnp.asarray(k), jnp.asarray(b), act)
    want = np.asarray(jy.astype(jnp.float32))

    before = bn_mod.bn_apply.launches
    ty = bn_mod.bn_apply(torch.from_numpy(x).to(getattr(torch, dtype)),
                         torch.from_numpy(k), torch.from_numpy(b), act)
    assert bn_mod.bn_apply.launches == before  # CPU: plain version only
    assert ty.dtype == getattr(torch, dtype) and tuple(ty.shape) == shape
    np.testing.assert_allclose(ty.float().numpy(), want,
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_bn_apply_meta_takes_plain_version_uncounted():
    x = torch.empty(3, 5, 7, 7, device='meta')
    k = torch.empty(5, device='meta')
    before = bn_mod.bn_apply.launches
    y = bn_mod.bn_apply(x, k, k, 'relu')
    assert y.device.type == 'meta' and tuple(y.shape) == (3, 5, 7, 7)
    assert bn_mod.bn_apply.launches == before


def test_bn_apply_rejects_unknown_activation():
    x = torch.zeros(1, 2, 3, 3)
    with pytest.raises(ValueError, match='act'):
        bn_mod.bn_apply(x, torch.ones(2), torch.zeros(2), 'sigmoid')


def test_cuda_place_without_card_raises(monkeypatch, tmp_path):
    """The entry points run on the card by default and never carry on on
    the CPU when torch sees no card."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data('x', shape=[4])
        y = ptt.layers.fc(x, size=3)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe.run(startup)
        ptt.io.save_inference_model(str(tmp_path), ['x'], [y], exe, main)

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for make in (ptt.Executor, lambda: ptt.Executor(ptt.CUDAPlace(0)),
                 lambda: ptt.inference.create_predictor(
                     ptt.inference.Config(str(tmp_path)))):
        with pytest.raises(RuntimeError, match='is_available'):
            make()
    pred = ptt.inference.create_predictor(
        ptt.inference.Config(str(tmp_path)).disable_gpu())
    out, = pred.run([np.ones((2, 4), np.float32)])
    assert out.shape == (2, 3)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_one_ulp_bound_covers_single_rounding(dtype):
    """The card's tolerance is sound: the kernel's arithmetic (k, b rounded
    to x's dtype, x*k + b in f32, one rounding to x's dtype), emulated on
    the CPU, stays within one_ulp_bound of the plain version, which rounds
    x*k to x's dtype before the add; in f32 the two agree exactly."""
    x32, k, b = (torch.from_numpy(a) for a in _inputs((8, 64, 14, 14), 3))
    x = x32.to(dtype)
    kk = k.to(dtype).float().view(1, -1, 1, 1)
    bb = b.to(dtype).float().view(1, -1, 1, 1)
    once = (x.float() * kk + bb).to(dtype)
    plain = bn_mod.bn_apply_reference(x, k, b)
    err = (once.float() - plain.float()).abs()
    assert bool((err <= bn_mod.one_ulp_bound(x, k, b)).all())
    if dtype == torch.float32:
        assert torch.equal(once, plain)
    else:
        assert bool((err > 0).any())  # the bound is not vacuous in bf16
