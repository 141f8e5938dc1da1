"""The port's bn_apply against the TPU kernel it replaces.

paddle_tpu/ops/pallas_bn.py's Pallas kernel runs here in interpret mode
(pallas_call patched with interpret=True for the test only), and the port's
bn_apply takes its plain PyTorch version on CPU tensors. Its backward,
BnApplyFunction's, is held against jax.vjp of fused_bn_apply, whose
custom VJP (`_bwd`) is plain JAX. The CUDA kernel itself runs only on a
card: tests/test_torch_bn_apply_cuda.py holds it against the plain version
there.
"""
import functools

import numpy as np
import pytest
import torch
import jax
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


# dx = dy * k and the products dy * x are one multiply (one rounding to x's
# dtype) on both sides, and the relu mask comes from the same y at these
# inputs; dk and db sum the products in f32 in other orders, so they are
# held to 1e-6 of the sum of the terms' magnitudes, in bf16 as in f32.
GRAD_TOL = 1e-6


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('act', [None, 'relu'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_bn_apply_backward_matches_pallas_vjp(monkeypatch, dtype, act, shape):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    x, k, b = _inputs(shape, seed=1)
    dy = np.random.RandomState(2).randn(*shape).astype(np.float32)
    jy, vjp = jax.vjp(lambda x_, k_, b_: pallas_bn.fused_bn_apply(
        x_, k_, b_, act), jnp.asarray(x).astype(dtype), jnp.asarray(k),
        jnp.asarray(b))
    want = [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(dy).astype(dtype))]

    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(),
              torch.from_numpy(k).requires_grad_(),
              torch.from_numpy(b).requires_grad_()]
    ty = bn_mod.bn_apply(*leaves, act)
    got = torch.autograd.grad(ty, leaves, torch.from_numpy(dy).to(tdt))
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert [g.dtype for g in got] == [tdt, torch.float32, torch.float32]
    mask = np.ones(shape, np.float32) if act is None else \
        (np.asarray(jy.astype(jnp.float32)) > 0).astype(np.float32)
    dyx = np.abs(dy * mask * np.asarray(
        jnp.asarray(x).astype(dtype).astype(jnp.float32)))
    mags = [None, dyx.sum((0, 2, 3)), np.abs(dy * mask).sum((0, 2, 3))]
    tol = GRAD_TOL
    for name, g, w, mag in zip(('dx', 'dk', 'db'), got, want, mags):
        g = g.float().numpy()
        assert g.shape == w.shape, name
        if mag is None:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)
        else:
            assert (np.abs(g - w) <= tol * mag + 1e-30).all(), \
                (name, np.abs(g - w).max(), mag.min())


def test_bn_apply_backward_skips_unneeded_grads():
    """Only the inputs that require a gradient get one: serving's
    batch_norm runs under no_grad, a grad op differentiates what it
    needs; where none is needed, the Function is not dispatched."""
    x, k, b = (torch.from_numpy(a) for a in _inputs((2, 3, 4, 4)))
    xl = x.clone().requires_grad_()
    y = bn_mod.bn_apply(xl, k, b, 'relu')
    assert type(y.grad_fn).__name__ == 'BnApplyFunctionBackward'
    dx, = torch.autograd.grad(y, [xl], torch.ones_like(y))
    want = (bn_mod.bn_apply_reference(x, k, b) > 0).float() * \
        k.view(1, -1, 1, 1)
    assert torch.equal(dx, want)
    with torch.no_grad():
        y = bn_mod.bn_apply(xl, k, b)
        assert not y.requires_grad and y.grad_fn is None
    y = bn_mod.bn_apply(x, k, b, 'relu')
    assert y.grad_fn is None
    assert torch.equal(y, bn_mod.bn_apply_reference(x, k, b, 'relu'))


@pytest.mark.parametrize('act', [None, 'relu'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_backward_bounds_hold_against_plain_autograd(dtype, act):
    """backward_bounds, the card's tolerance for the Function's gradients
    against autograd through the plain version, holds on the CPU, where
    both forwards are the plain version: the masks agree, dx is the same
    multiply, and the plain dk and db (rounded to x's dtype) are within
    their bounds of the Function's f32 sums."""
    x, k, b = (torch.from_numpy(a) for a in _inputs((4, 8, 6, 6), 5))
    x = x.to(dtype)
    dy = torch.from_numpy(np.random.RandomState(6).randn(
        4, 8, 6, 6).astype(np.float32)).to(dtype)
    out = []
    for fn in (bn_mod.bn_apply, bn_mod.bn_apply_reference):
        leaves = [t.clone().requires_grad_() for t in (x, k, b)]
        y = fn(*leaves, act)
        out.append((y.detach(),) + torch.autograd.grad(y, leaves, dy))
    (y, dx, dk, db), (ry, rdx, rdk, rdb) = out
    differ, dx_tol, dk_tol, db_tol = bn_mod.backward_bounds(
        x, k, b, dy, y, ry, rdk, rdb, act)
    assert not bool(differ.any())
    assert bool(((dx.float() - rdx.float()).abs() <= dx_tol).all())
    for got, want, tol in ((dk, rdk, dk_tol), (db, rdb, db_tol)):
        assert got.dtype == torch.float32 and tol.shape == (8,)
        assert bool(((got - want.float()).abs() <= tol).all())
        assert bool((tol > 0).all())


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
