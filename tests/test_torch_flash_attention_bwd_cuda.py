"""The CUDA flash-attention backward kernels (K2-bwd-dkv, K2-bwd-dq) and
the forward's log-sum-exp against their plain PyTorch versions, on a card;
FlashAttention on the card against the same function on the CPU; and the
launch counts of one BERT training step.

Run on a machine with an NVIDIA GPU (no jax needed):

    python -m pytest --noconftest tests/test_torch_flash_attention_bwd_cuda.py

Without a card the tests skip. Tolerances: flash_attention.grad_tolerance
for the gradients (1e-5 of the largest value in f32, 2**-7 in bf16; its
docstring says why) and 1e-5 of the largest |lse| for the log-sum-exp;
two launches on the same inputs, and the kernels' two ways of filling
their tiles (cp.async and plain loads), agree bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops import flash_attention as fa


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: the CUDA kernels run only on a card')
    torch.backends.cuda.matmul.allow_tf32 = False


def _tensors(b, h, sq, sk, d, dtype, seed=0):
    """q, k, v, dO as [B, H, S, D] views of [B, S, H, D] memory, the layout
    the head split and the head merge's gradient hand the kernels."""
    rng = np.random.RandomState(seed)

    def one(s):
        x = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
        return x.to('cuda', dtype).permute(0, 2, 1, 3)
    return one(sq), one(sk), one(sk), one(sq)


def _check_backward(b, h, sq, sk, d, causal, dtype):
    q, k, v, do = _tensors(b, h, sq, sk, d, dtype)
    scale = d ** -0.5
    counts = (fa.flash_attn_fwd.launches, fa.flash_attn_bwd_dkv.launches,
              fa.flash_attn_bwd_dq.launches)
    out, lse = fa.flash_attn_fwd(q, k, v, causal, scale, return_lse=True)
    di = (do.float() * out.float()).sum(-1)
    dk, dv = fa.flash_attn_bwd_dkv(q, k, v, do, lse, di, causal, scale)
    dq = fa.flash_attn_bwd_dq(q, k, v, do, lse, di, causal, scale)
    torch.cuda.synchronize()
    assert (fa.flash_attn_fwd.launches, fa.flash_attn_bwd_dkv.launches,
            fa.flash_attn_bwd_dq.launches) == tuple(c + 1 for c in counts)
    want_lse = fa.flash_attention_reference_lse(q, k, causal, scale)
    assert float((lse - want_lse).abs().max()) <= \
        1e-5 * float(want_lse.abs().max())
    want_dk, want_dv = fa.flash_attn_bwd_dkv_reference(q, k, v, do, lse, di,
                                                       causal, scale)
    want_dq = fa.flash_attn_bwd_dq_reference(q, k, v, do, lse, di, causal,
                                             scale)
    for name, got, want in (('dq', dq, want_dq), ('dk', dk, want_dk),
                            ('dv', dv, want_dv)):
        assert got.shape == want.shape and got.dtype == dtype, name
        # [B, H, S, D] over [B, S, H, D] memory: the head split's grad is a view
        assert got.permute(0, 2, 1, 3).is_contiguous(), name
        err = float((got.float() - want.float()).abs().max())
        assert err <= fa.grad_tolerance(want), (name, err,
                                                fa.grad_tolerance(want))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,h,sq,sk,d,causal', [
    (8, 12, 512, 512, 64, False),   # BERT-base training, batch 8
    (1, 12, 512, 512, 64, False),   # batch 1
    (2, 12, 512, 512, 64, True),
    (2, 12, 128, 512, 64, True),    # offset mask: key j kept for j <= i + 384
    (2, 4, 300, 300, 64, False),    # ragged query and key tiles
    (2, 4, 300, 300, 64, True),
    (2, 4, 512, 512, 32, False),
    (2, 4, 512, 512, 128, True),
    (1, 2, 77, 300, 40, False),     # D not a template width
    (2, 4, 65, 65, 64, False),      # one row past a 64-row tile in both kernels
    (2, 4, 65, 65, 128, True),      # ... and past D=128's 32-row steps
])
def test_backward_kernels_match_plain(dtype, b, h, sq, sk, d, causal):
    _need_card()
    _check_backward(b, h, sq, sk, d, causal, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_two_launches_are_bit_identical(dtype):
    """No atomics and a fixed order of summation: the same inputs give the
    same bits, launch after launch."""
    _need_card()
    q, k, v, do = _tensors(2, 12, 300, 300, 64, dtype, seed=2)
    out, lse = fa.flash_attn_fwd(q, k, v, True, 0.125, return_lse=True)
    di = (do.float() * out.float()).sum(-1)
    runs = [fa.flash_attn_bwd_dkv(q, k, v, do, lse, di, True, 0.125)
            + (fa.flash_attn_bwd_dq(q, k, v, do, lse, di, True, 0.125),)
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, first, second in zip(('dk', 'dv', 'dq'), *runs):
        assert torch.equal(first, second), name


@pytest.mark.cuda
def test_strided_rows_take_the_plain_load_path():
    """d-strided operands (no 16-byte rows) take the kernels' plain loads
    instead of cp.async; the result is the same function."""
    _need_card()
    q, k, v, do = _tensors(1, 4, 130, 130, 64, torch.float32, seed=3)
    qs = torch.empty(1, 4, 130, 128, device='cuda')[..., ::2]
    qs.copy_(q)
    out, lse = fa.flash_attn_fwd(q, k, v, False, 0.125, return_lse=True)
    di = (do.float() * out.float()).sum(-1)
    got = fa.flash_attn_bwd_dkv(qs, k, v, do, lse, di, False, 0.125) + (
        fa.flash_attn_bwd_dq(qs, k, v, do, lse, di, False, 0.125),)
    want = fa.flash_attn_bwd_dkv(q, k, v, do, lse, di, False, 0.125) + (
        fa.flash_attn_bwd_dq(q, k, v, do, lse, di, False, 0.125),)
    torch.cuda.synchronize()
    for name, a, b in zip(('dk', 'dv', 'dq'), got, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_autograd_function_on_card_matches_cpu():
    _need_card()
    q, k, v, do = _tensors(2, 4, 200, 200, 64, torch.float32, seed=1)
    grads = []
    for device in ('cuda', 'cpu'):
        leaves = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        out = fa.FlashAttention.apply(*leaves, True, 0.125)
        out.backward(do.to(device))
        grads.append([out.detach()] + [t.grad for t in leaves])
    for got, want in zip(*grads):
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.cuda
def test_rejects_what_the_kernels_do_not_take():
    _need_card()
    q, k, v, do = _tensors(1, 2, 64, 64, 64, torch.float32)
    lse = di = torch.zeros(1, 2, 64, device='cuda')
    big = torch.zeros(1, 2, 64, 129, device='cuda')
    for wrapper in (fa.flash_attn_bwd_dkv, fa.flash_attn_bwd_dq):
        with pytest.raises(ValueError, match='128'):
            wrapper(big, big, big, big, lse, di)
        with pytest.raises(ValueError):
            wrapper(q, k.cpu(), v, do, lse, di)
        with pytest.raises(ValueError):
            wrapper(q, k, v, do, lse.cpu(), di)
        with pytest.raises(TypeError):
            wrapper(q.half(), k.half(), v.half(), do.half(), lse, di)
        with pytest.raises(ValueError):
            wrapper(q, k, v, do.bfloat16(), lse, di)
        with pytest.raises(ValueError):
            wrapper(q, k, v, do, lse.double(), di)


@pytest.mark.cuda
def test_launch_counts_of_a_training_step():
    """One training step of a 3-layer BERT on the card: each layer's
    attention gradient launches each backward kernel once, and the forward
    kernel twice (the forward op, and the grad op's recomputed forward)."""
    _need_card()
    n_layer, seq, batch = 3, 128, 2
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, loss = bert.build_bert_pretrain(vocab=97, max_len=seq, d_model=64,
                                           d_ff=128, n_head=2,
                                           n_layer=n_layer, dropout=0.0)
    exe = ptt.Executor(ptt.CUDAPlace(0))
    rng = np.random.RandomState(0)
    feed = {'tok_ids': rng.randint(0, 97, (batch, seq)),
            'seg_ids': rng.randint(0, 2, (batch, seq)),
            'mlm_labels': rng.randint(0, 97, (batch, seq)),
            'mlm_weights': (rng.rand(batch, seq) < 0.15).astype(np.float32)}
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        fa.flash_attn_fwd.launches = 0
        fa.flash_attn_bwd_dkv.launches = fa.flash_attn_bwd_dq.launches = 0
        first, = exe.run(main, feed=feed, fetch_list=[loss])
        assert (fa.flash_attn_fwd.launches, fa.flash_attn_bwd_dkv.launches,
                fa.flash_attn_bwd_dq.launches) == (2 * n_layer, n_layer,
                                                   n_layer)
        for _ in range(3):
            last, = exe.run(main, feed=feed, fetch_list=[loss])
    assert np.isfinite(first).all() and float(last[0]) < float(first[0])
