"""The CUDA flash-attention kernel against its plain PyTorch version, on a
card, and its launch count through one BERT request.

Run on a machine with an NVIDIA GPU (no jax needed):

    python -m pytest --noconftest tests/test_torch_flash_attention_cuda.py

Without a card the tests skip. The tolerance is flash_attention.tolerance:
1e-5 * max|v| in f32, 2**-6 * max|v| in bf16 (its docstring says why), and
1e-5 of the largest |lse| for the log-sum-exp. Two launches on the same
inputs, and the kernel's two ways of filling its tiles (cp.async and plain
loads), agree bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops import flash_attention as fa


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: the CUDA kernel runs only on a card')
    torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(b, h, sq, sk, d, dtype, seed=0):
    """q, k, v as [B, H, S, D] views of [B, S, H, D] memory, the layout the
    head split hands the kernel."""
    rng = np.random.RandomState(seed)

    def one(s):
        x = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
        return x.to('cuda', dtype).permute(0, 2, 1, 3)
    return one(sq), one(sk), one(sk)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,h,sq,sk,d,causal', [
    (1, 12, 512, 512, 64, False),   # BERT-base, batch 1
    (8, 12, 512, 512, 64, False),   # BERT-base, batch 8
    (2, 12, 512, 512, 64, True),
    (2, 12, 128, 512, 64, True),    # offset mask: key j kept for j <= i + 384
    (2, 4, 200, 200, 64, False),    # ragged query and key tiles
    (2, 4, 200, 200, 64, True),
    (2, 4, 512, 512, 32, False),
    (2, 4, 512, 512, 128, False),
    (1, 2, 77, 300, 40, False),     # D not a template width
    (2, 4, 65, 65, 64, False),      # one row and one key past a 64-row tile
    (2, 4, 65, 65, 128, True),      # ... and past f32's 32-key steps at D=128
    (2, 4, 128, 512, 32, True),     # D 32 and 128 under the offset mask
    (2, 4, 128, 512, 128, True),
    (1, 3, 70, 90, 13, True),       # rows of no 16-byte vectors: plain loads
])
def test_kernel_matches_plain(dtype, b, h, sq, sk, d, causal):
    _need_card()
    q, k, v = _qkv(b, h, sq, sk, d, dtype)
    before = fa.flash_attn_fwd.launches
    out, lse = fa.flash_attn_fwd(q, k, v, causal=causal, scale=d ** -0.5,
                                 return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attn_fwd.launches == before + 1
    assert out.shape == (b, h, sq, d) and out.dtype == dtype
    ref = fa.flash_attention_reference(q, k, v, causal, d ** -0.5)
    err = float((out.float() - ref.float()).abs().max())
    assert err <= fa.tolerance(v), (err, fa.tolerance(v))
    want_lse = fa.flash_attention_reference_lse(q, k, causal, d ** -0.5)
    assert float((lse - want_lse).abs().max()) <= \
        1e-5 * float(want_lse.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_two_launches_are_bit_identical(dtype):
    """A fixed order of summation and no atomics: the same inputs give the
    same bits, launch after launch."""
    _need_card()
    q, k, v = _qkv(2, 12, 300, 300, 64, dtype, seed=2)
    runs = [fa.flash_attn_fwd(q, k, v, True, 0.125, return_lse=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, first, second in zip(('out', 'lse'), *runs):
        assert torch.equal(first, second), name


def _strided(x):
    """x again, as a view whose stride along d is 2: no 16-byte rows."""
    y = torch.empty(x.shape[:-1] + (2 * x.shape[-1],), dtype=x.dtype,
                    device=x.device)[..., ::2]
    y.copy_(x)
    return y


def _misaligned(x):
    """x again, contiguous from an address one element past a 16-byte
    boundary."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype,
                    device=x.device)[1:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('layout', [_strided, _misaligned])
def test_rows_without_vectors_take_the_plain_load_path(dtype, layout):
    """A d-strided or misaligned operand has no 16-byte rows, so the kernel
    fills its tiles by plain loads instead of cp.async; the tiles, and so
    the bits of the result, are the same."""
    _need_card()
    q, k, v = (t.contiguous() for t in _qkv(1, 4, 130, 130, 64, dtype,
                                            seed=3))
    want = fa.flash_attn_fwd(q, k, v, False, 0.125, return_lse=True)
    for i in range(3):
        args = [q, k, v]
        args[i] = layout(args[i])
        got = fa.flash_attn_fwd(*args, False, 0.125, return_lse=True)
        torch.cuda.synchronize()
        for name, a, b in zip(('out', 'lse'), got, want):
            assert torch.equal(a, b), (layout.__name__, i, name)


@pytest.mark.cuda
def test_contiguous_inputs_and_output_layout():
    _need_card()
    q, k, v = (t.contiguous() for t in _qkv(2, 3, 130, 130, 64,
                                            torch.float32, seed=1))
    out = fa.flash_attn_fwd(q, k, v, scale=0.125)
    ref = fa.flash_attention_reference(q, k, v, False, 0.125)
    assert float((out - ref).abs().max()) <= fa.tolerance(v)
    # [B, H, S, D] over [B, S, H, D] memory: the head merge is a view
    assert out.permute(0, 2, 1, 3).is_contiguous()


@pytest.mark.cuda
def test_rejects_what_the_kernel_does_not_take():
    _need_card()
    q, k, v = _qkv(1, 2, 64, 64, 64, torch.float32)
    with pytest.raises(ValueError, match='128'):
        big = torch.zeros(1, 2, 64, 129, device='cuda')
        fa.flash_attn_fwd(big, big, big)
    with pytest.raises(ValueError, match='causal'):
        fa.flash_attn_fwd(q, k[:, :, :32], v[:, :, :32], causal=True)
    with pytest.raises(TypeError):
        fa.flash_attn_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fa.flash_attn_fwd(q, k.cpu(), v)


@pytest.mark.cuda
def test_one_launch_per_layer_in_a_bert_request(tmp_path):
    _need_card()
    n_layer, seq = 3, 128
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, logits = bert.bert_mlm_logits(vocab=97, max_len=seq, d_model=64,
                                         d_ff=128, n_head=2, n_layer=n_layer)
    exe = ptt.Executor(ptt.CUDAPlace(0))
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        ptt.io.save_inference_model(str(tmp_path), ['tok_ids', 'seg_ids'],
                                    [logits], exe, main)
    pred = ptt.inference.create_predictor(ptt.inference.Config(str(tmp_path)))
    rng = np.random.RandomState(0)
    tok = rng.randint(0, 97, (2, seq)).astype(np.int64)
    seg = rng.randint(0, 2, (2, seq)).astype(np.int64)
    fa.flash_attn_fwd.launches = 0
    got, = pred.run([tok, seg])
    assert fa.flash_attn_fwd.launches == n_layer
    want, = ptt.inference.create_predictor(
        ptt.inference.Config(str(tmp_path)).disable_gpu()).run([tok, seg])
    assert got.shape == (2 * seq, 97) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
