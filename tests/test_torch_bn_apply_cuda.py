"""The CUDA bn_apply kernel against its plain PyTorch version, on a card:
its forward, BnApplyFunction's backward through it, and a training
program's batch_norm_grad, which must reach Scale and Bias through the
kernel's output.

Run on a machine with an NVIDIA GPU (no jax needed):

    python -m pytest tests/test_torch_bn_apply_cuda.py

Without a card the tests skip.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops import bn_apply as bn_mod


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,offset', [
    ((16, 512, 7, 7), 0),     # inner 49: vectors cross channels
    ((3, 5, 7, 9), 0),        # numel % 8 != 0: masked tail
    ((2, 64, 56, 56), 1),     # x not 16-byte aligned: one element a thread
    ((6, 10), 0),             # 2-D [N, C]: inner 1
])
def test_bn_apply_kernel_on_card(dtype, shape, offset):
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: the CUDA kernel runs only on a card')
    rng = np.random.RandomState(1)
    flat = torch.from_numpy(
        rng.randn(int(np.prod(shape)) + offset).astype(np.float32))
    x = flat.to('cuda', dtype)[offset:].view(shape)
    c = shape[1]
    k = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.randn(c).astype(np.float32)).cuda()
    for act in (None, 'relu'):
        before = bn_mod.bn_apply.launches
        y = bn_mod.bn_apply(x, k, b, act)
        torch.cuda.synchronize()
        assert bn_mod.bn_apply.launches == before + 1
        assert y.dtype == dtype and y.shape == x.shape
        ref = bn_mod.bn_apply_reference(x, k, b, act)
        err = (y.float() - ref.float()).abs()
        assert bool((err <= bn_mod.one_ulp_bound(x, k, b)).all())
        if dtype == torch.float32:
            assert torch.equal(y, ref)


# threads of the kernel's largest grid (csrc/bn_apply.cu: kMaxBlocks blocks
# of kThreads); beyond as many vectors the grid-stride loop takes more passes
GRID_THREADS = (1 << 16) * 256


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,offset', [
    ((192, 64, 112, 112), 0),  # 154M elements: 3 passes in f32, 2 in bf16
    ((24, 256, 56, 56), 1),    # not 16-byte aligned, one element a thread
])
def test_bn_apply_kernel_grid_stride_on_card(dtype, shape, offset):
    """Shapes whose vectors outnumber the largest grid's threads, so every
    thread takes the grid-stride loop more than once (ResNet-50 training
    at batch 128 does so at its largest BN outputs in f32)."""
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: the CUDA kernel runs only on a card')
    gen = torch.Generator(device='cuda').manual_seed(5)
    n = int(np.prod(shape))
    x = torch.randn(n + offset, device='cuda', generator=gen).to(dtype)[
        offset:].view(shape)
    vec = 16 // x.element_size() if x.data_ptr() % 16 == 0 else 1
    assert n // vec > GRID_THREADS
    c = shape[1]
    k = torch.rand(c, device='cuda', generator=gen) + 0.5
    b = torch.randn(c, device='cuda', generator=gen)
    for act in (None, 'relu'):
        before = bn_mod.bn_apply.launches
        y = bn_mod.bn_apply(x, k, b, act)
        torch.cuda.synchronize()
        assert bn_mod.bn_apply.launches == before + 1
        ref = bn_mod.bn_apply_reference(x, k, b, act)
        err = (y.float() - ref.float()).abs()
        assert bool((err <= bn_mod.one_ulp_bound(x, k, b)).all())
        if dtype == torch.float32:
            assert torch.equal(y, ref)
        del y, ref, err


@pytest.mark.cuda
def test_bn_apply_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: the CUDA kernel runs only on a card')
    x = torch.zeros(2, 4, 3, 3, device='cuda')
    k = torch.ones(4, device='cuda')
    with pytest.raises(TypeError):
        bn_mod.bn_apply(x.half(), k, k)
    with pytest.raises(ValueError):
        bn_mod.bn_apply(x, k.double(), k)
    with pytest.raises(ValueError):
        bn_mod.bn_apply(x, k.cpu(), k)
    with pytest.raises(ValueError):
        bn_mod.bn_apply(x.transpose(2, 3), k, k)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('act', [None, 'relu'])
def test_bn_apply_backward_on_card(dtype, act):
    """dx, dk, db of BnApplyFunction (the kernel forward, the plain
    backward) against autograd through bn_apply_reference on the card,
    within bn_mod.backward_bounds; in f32 the two agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: the CUDA kernel runs only on a card')
    rng = np.random.RandomState(2)
    shape = (8, 64, 14, 14)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        'cuda', dtype)
    k = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.randn(64).astype(np.float32)).cuda()
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        'cuda', dtype)
    out = []
    for fn in (bn_mod.bn_apply, bn_mod.bn_apply_reference):
        leaves = [t.clone().requires_grad_() for t in (x, k, b)]
        before = bn_mod.bn_apply.launches
        y = fn(*leaves, act)
        assert bn_mod.bn_apply.launches - before == (fn is bn_mod.bn_apply)
        out.append((y.detach(),) + torch.autograd.grad(y, leaves, dy))
    (y, dx, dk, db), (ry, rdx, rdk, rdb) = out
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dk.dtype == db.dtype == torch.float32
    differ, dx_tol, dk_tol, db_tol = bn_mod.backward_bounds(
        x, k, b, dy, y, ry, rdk, rdb, act)
    assert bool((ry.float().abs()[differ]
                 <= bn_mod.one_ulp_bound(x, k, b)[differ]).all())
    dx_err = (dx.float() - rdx.float()).abs().masked_fill(differ, 0)
    assert bool((dx_err <= dx_tol).all())
    assert bool(((dk - rdk.float()).abs() <= dk_tol).all())
    assert bool(((db - rdb.float()).abs() <= db_tol).all())
    if dtype == torch.float32:
        for got, want in ((dx, rdx), (dk, rdk), (db, rdb)):
            assert torch.equal(got, want)


def _bn_program():
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 3
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data('x', shape=[4, 6, 6])
        y = ptt.layers.batch_norm(ptt.layers.conv2d(x, 8, 3, padding=1,
                                                    bias_attr=False),
                                  act='relu')
        loss = ptt.layers.mean(y)
        ptt.backward.append_backward(loss)
    return main, startup, loss


@pytest.mark.cuda
def test_batch_norm_grad_on_card_reaches_scale_and_bias():
    """The regression test for a BN apply whose output carried no autograd
    history: batch_norm_grad on CUDA tensors gives the CPU's Scale, Bias
    and conv filter gradients, and they are not zero."""
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: the CUDA kernel runs only on a card')
    torch.backends.cudnn.allow_tf32 = False
    main, startup, loss = _bn_program()
    names = [loss.name, 'batch_norm_0.w_0@GRAD', 'batch_norm_0.b_0@GRAD',
             'conv2d_0.w_0@GRAD']
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    state = ptt.weights.state_to_numpy(main, scope)
    feed = {'x': np.random.RandomState(4).randn(5, 4, 6, 6).astype(
        np.float32)}
    out = {}
    for place in (ptt.CUDAPlace(0), ptt.CPUPlace()):
        scope = ptt.Scope()
        ptt.weights.params_from_numpy(state, main, scope)
        before = bn_mod.bn_apply.launches
        out[place.device().type] = ptt.Executor(place).run(
            main, feed=feed, fetch_list=names, scope=scope)
        if place.device().type == 'cuda':
            # the forward op and the grad op's recomputed forward
            assert bn_mod.bn_apply.launches - before == 2
    for name, g, w in zip(names, out['cuda'], out['cpu']):
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
