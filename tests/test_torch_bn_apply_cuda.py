"""The CUDA bn_apply kernel against its plain PyTorch version, on a card.

Run on a machine with an NVIDIA GPU (no jax needed):

    python -m pytest tests/test_torch_bn_apply_cuda.py

Without a card the tests skip.
"""
import numpy as np
import pytest
import torch

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
