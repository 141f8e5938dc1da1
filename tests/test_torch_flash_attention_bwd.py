"""K2's backward on the CPU: the port's plain log-sum-exp and plain
backward versions held against JAX's TPU flash-attention kernels, and
FlashAttention (the port's autograd Function) held against jax.vjp of
paddle_tpu's fused_multihead_attention op.

1. JAX 0.9.0's Pallas TPU flash attention
   (jax/experimental/pallas/ops/tpu/flash_attention.py) runs here under
   `force_tpu_interpret_mode()`, with every block size 128: its forward
   with saved residuals gives l and m (ln l + m is the log-sum-exp), and
   jax.vjp through it runs the backward kernels _flash_attention_bwd_dkv
   and _flash_attention_bwd_dq. The port's flash_attention_reference_lse,
   flash_attn_bwd_dkv_reference and flash_attn_bwd_dq_reference, fed the
   same q, k, v, dO and di = rowsum(dO·O), must give the same LSE, dK, dV
   and dQ, in f32 and in bf16. Tolerance 1e-5 of each tensor's largest
   value for the LSE (f32 from the same inputs in both dtypes) and for the
   f32 gradients: the kernels sum block by block and the plain versions in
   one product. bf16 gradients: 2**-7 (one bf16 ulp of the largest value),
   because both round P, dS and the gradient to bf16 from f32 values that
   differ in summation order, so an entry may land one bf16 step apart;
   these cases land within 1.7e-3.
   The port's forward plain versions, flash_attention_reference and
   flash_attention_reference_lse, are held against that kernel's own
   output O and log-sum-exp (ln l + m) in f32 and bf16, with the kernel's
   tolerance (flash_attention.tolerance: 1e-5 of max|v| in f32, 2**-6 in
   bf16, where the plain version rounds q·scale, the scores and P to bf16
   and the TPU kernel only P) and 1e-5 of the largest |lse|.
2. paddle_tpu's fused_multihead_attention lowering on the CPU is the
   composition (scale on q, masked softmax, two einsums); jax.vjp of it is
   the gradient the JAX package's training takes here. FlashAttention on
   CPU tensors runs the plain versions. f32: rtol 1e-5 with a floor of 1e-5
   of the largest value. bf16: 2**-5 of the largest value, because JAX
   rounds q·scale, the scores, P, dP and dS to bf16 in its vjp (each a
   relative 2**-9) while the port computes each gradient in f32 from the
   bf16 inputs and rounds it once; these cases land within 1.1e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from paddle_tpu.core import registry as jax_registry
from paddle_tpu_torch.ops import flash_attention as fa

_BLOCKS = jfa.BlockSizes(
    block_q=128, block_k_major=128, block_k=128, block_b=1,
    block_q_major_dkv=128, block_k_major_dkv=128, block_k_dkv=128,
    block_q_dkv=128, block_k_major_dq=128, block_k_dq=128, block_q_dq=128)


def _arrays(shape_q, shape_k, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(*shape_q).astype(np.float32)
    k, v = (rng.randn(*shape_k).astype(np.float32) for _ in range(2))
    do = rng.randn(*shape_q).astype(np.float32)
    return q, k, v, do


def _close(got, want, rel, name):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    tol = rel * float(np.abs(want).max())
    assert err <= tol, '%s: max abs err %r > %r' % (name, err, tol)


_TPU_CASES = [(1, 2, 256, 64, False), (1, 2, 256, 64, True),
              (2, 2, 256, 32, True)]


@pytest.mark.parametrize('b,h,s,d,causal,dtype', [
    pytest.param(*case, dtype, id='-'.join(
        [str(x) for x in case] + ([] if dtype == 'float32' else [dtype])))
    for dtype in ('float32', 'bfloat16') for case in _TPU_CASES])
def test_plain_versions_match_jax_tpu_kernels(b, h, s, d, causal, dtype):
    arrays = _arrays((b, h, s, d), (b, h, s, d), seed=s + d)
    q, k, v, do = (jnp.asarray(a, jnp.dtype(dtype)) for a in arrays)
    scale = d ** -0.5

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, sm_scale=scale,
                                   block_sizes=_BLOCKS)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, q, k, v)
        dq, dk, dv = vjp(do)
        _, l, m = jfa._flash_attention(q, k, v, None, None, True, causal,
                                       scale, _BLOCKS, False)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
                       for a in (q, k, v, do))
    lse = fa.flash_attention_reference_lse(tq, tk, causal, scale)
    _close(lse, np.asarray(m) + np.log(np.asarray(l)), 1e-5, 'lse')
    # di from the TPU kernel's own output, as JAX's backward computes it
    di = (tdo.float() * torch.from_numpy(np.asarray(out, np.float32))).sum(-1)
    got_dk, got_dv = fa.flash_attn_bwd_dkv_reference(tq, tk, tv, tdo, lse,
                                                     di, causal, scale)
    got_dq = fa.flash_attn_bwd_dq_reference(tq, tk, tv, tdo, lse, di,
                                            causal, scale)
    rel = 1e-5 if dtype == 'float32' else 2.0 ** -7
    for name, got, want in (('dq', got_dq, dq), ('dk', got_dk, dk),
                            ('dv', got_dv, dv)):
        assert got.dtype == tdt, (name, got.dtype)
        _close(got.float(), want, rel, name)


@pytest.mark.parametrize('b,h,s,d,causal,dtype', [
    pytest.param(*case, dtype, id='-'.join(
        [str(x) for x in case] + ([] if dtype == 'float32' else [dtype])))
    for dtype in ('float32', 'bfloat16') for case in _TPU_CASES])
def test_plain_forward_matches_jax_tpu_forward_kernel(b, h, s, d, causal,
                                                      dtype):
    arrays = _arrays((b, h, s, d), (b, h, s, d), seed=s + d + 1)
    q, k, v = (jnp.asarray(a, jnp.dtype(dtype)) for a in arrays[:3])
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        out, l, m = jfa._flash_attention(q, k, v, None, None, True, causal,
                                         scale, _BLOCKS, False)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
                  for a in (q, k, v))
    got = fa.flash_attention_reference(tq, tk, tv, causal, scale)
    assert got.dtype == tdt
    err = float((got.float() - torch.from_numpy(
        np.asarray(out, np.float32))).abs().max())
    assert err <= fa.tolerance(tv), ('out', err, fa.tolerance(tv))
    lse = fa.flash_attention_reference_lse(tq, tk, causal, scale)
    _close(lse, np.asarray(m) + np.log(np.asarray(l)), 1e-5, 'lse')


class _Ctx(object):
    """The attrs a lowering reads, for calling paddle_tpu's directly."""

    def __init__(self, **attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


CASES = {
    # name: (B, H, Sq, Sk, D, causal)
    'noncausal': (2, 3, 64, 64, 16, False),
    'causal': (2, 3, 64, 64, 16, True),
    'causal_offset_sq_lt_sk': (2, 2, 24, 40, 8, True),
    'ragged_s': (1, 2, 37, 37, 12, False),
}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', sorted(CASES))
def test_autograd_function_matches_jax_op_vjp(name, dtype):
    b, h, sq, sk, d, causal = CASES[name]
    arrays = _arrays((b, h, sq, d), (b, h, sk, d), seed=sq + sk)
    scale = 0.3
    lower = jax_registry.get('fused_multihead_attention').lower
    ctx = _Ctx(causal=causal, scale=scale, sequence_parallel=False)
    jdt = jnp.dtype(dtype)

    def f(q, k, v):
        return lower(ctx, {'Q': [q], 'K': [k], 'V': [v]})['Out'][0]

    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrays)
    want_out, vjp = jax.vjp(f, jq, jk, jv)
    want = vjp(jdo)

    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in arrays)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fa.FlashAttention.apply(*leaves, causal, scale)
    out.backward(tdo)
    # the output as tests/test_torch_attention.py holds it: f32 1e-5,
    # bf16 2**-7 of max|v|
    v_max = float(np.abs(arrays[2]).max())
    out_tol = (1e-5 if dtype == 'float32' else 2.0 ** -7) * v_max
    err = float((out.detach().float()
                 - torch.from_numpy(np.array(want_out, np.float32))).abs()
                .max())
    assert err <= out_tol, ('out', err, out_tol)
    rel = 1e-5 if dtype == 'float32' else 2.0 ** -5
    for leaf, w, n in zip(leaves, want, ('dq', 'dk', 'dv')):
        assert leaf.grad.dtype == tdt
        _close(leaf.grad.float(), np.asarray(w, np.float32), rel, n)


def test_cpu_wrappers_take_plain_versions_without_counting():
    q, k, v, do = (torch.from_numpy(a) for a in
                   _arrays((1, 2, 16, 8), (1, 2, 16, 8), seed=3))
    counts = (fa.flash_attn_fwd.launches, fa.flash_attn_bwd_dkv.launches,
              fa.flash_attn_bwd_dq.launches)
    out, lse = fa.flash_attn_fwd(q, k, v, True, 0.5, return_lse=True)
    torch.testing.assert_close(
        lse, fa.flash_attention_reference_lse(q, k, True, 0.5), rtol=0,
        atol=0)
    di = (do * out).sum(-1)
    dk, dv = fa.flash_attn_bwd_dkv(q, k, v, do, lse, di, True, 0.5)
    dq = fa.flash_attn_bwd_dq(q, k, v, do, lse, di, True, 0.5)
    want_dk, want_dv = fa.flash_attn_bwd_dkv_reference(q, k, v, do, lse, di,
                                                       True, 0.5)
    want_dq = fa.flash_attn_bwd_dq_reference(q, k, v, do, lse, di, True, 0.5)
    for got, want in ((dk, want_dk), (dv, want_dv), (dq, want_dq)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert counts == (fa.flash_attn_fwd.launches,
                      fa.flash_attn_bwd_dkv.launches,
                      fa.flash_attn_bwd_dq.launches)


def test_backward_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, do = (torch.from_numpy(a) for a in
                   _arrays((1, 2, 16, 8), (1, 2, 16, 8), seed=4))
    lse = di = torch.zeros(1, 2, 16)
    big = torch.zeros(1, 2, 8, 129)
    for wrapper in (fa.flash_attn_bwd_dkv, fa.flash_attn_bwd_dq):
        with pytest.raises(ValueError, match='D <= 128'):
            wrapper(big, big, big, big, lse[..., :8], di[..., :8])
        with pytest.raises(ValueError, match='dO'):
            wrapper(q, k, v, do[:, :, :8], lse, di)
        with pytest.raises(ValueError, match='lse'):
            wrapper(q, k, v, do, lse[..., :8], di)
        with pytest.raises(ValueError, match='causal'):
            wrapper(q, k[:, :, :8], v[:, :, :8], do, lse, di, causal=True)
