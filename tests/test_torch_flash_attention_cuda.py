"""The CUDA flash-attention kernel against its plain PyTorch version, on a
card, and its launch count through one BERT request.

Run on a machine with an NVIDIA GPU (no jax needed):

    python -m pytest --noconftest tests/test_torch_flash_attention_cuda.py

Without a card the tests skip. The tolerance is flash_attention.tolerance:
1e-5 * max|v| in f32, 2**-6 * max|v| in bf16 (its docstring says why).
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
])
def test_kernel_matches_plain(dtype, b, h, sq, sk, d, causal):
    _need_card()
    q, k, v = _qkv(b, h, sq, sk, d, dtype)
    before = fa.flash_attn_fwd.launches
    out = fa.flash_attn_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_attn_fwd.launches == before + 1
    assert out.shape == (b, h, sq, d) and out.dtype == dtype
    ref = fa.flash_attention_reference(q, k, v, causal, d ** -0.5)
    err = float((out.float() - ref.float()).abs().max())
    assert err <= fa.tolerance(v), (err, fa.tolerance(v))


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
