"""K2's plain version and the port's fused_multihead_attention lowering,
held against paddle_tpu's fused_multihead_attention op on the CPU.

paddle_tpu's Executor runs the op on the CPU, where its lowering takes the
composition (the Pallas kernel runs only on a TPU), as
tests/test_fused_attention.py runs it. The port's Executor runs its
lowering, which on CPU tensors is flash_attention_reference; the test also
calls flash_attention_reference directly. The same numpy inputs go to both.

Tolerances: f32 rtol 1e-5, atol 1e-6 (the same algorithm summed in another
order). bf16 atol 2**-7 * max|v|: both round q*scale, the scores, P and O
to bf16 at the same steps, but an einsum that sums in another order can
land a score on the other side of a bf16 rounding, which moves P by up to
2**-8 relative; outputs are compared in f32.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as ptt
from paddle_tpu_torch.ops import flash_attention as fa

CASES = {
    # name: (B, H, Sq, Sk, D, causal)
    'noncausal': (2, 3, 64, 64, 16, False),
    'causal': (2, 3, 64, 64, 16, True),
    'noncausal_sq_ne_sk': (2, 2, 24, 40, 8, False),
    'causal_offset_sq_lt_sk': (2, 2, 24, 40, 8, True),
    'ragged_s': (1, 2, 37, 37, 12, False),
    'ragged_s_causal': (1, 2, 37, 37, 12, True),
}


def _inputs(b, h, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sq, d).astype(np.float32),
            rng.randn(b, h, sk, d).astype(np.float32),
            rng.randn(b, h, sk, d).astype(np.float32))


def _run(pkg, arrays, dtype, causal, scale, exe, **run_kw):
    """One fused_multihead_attention op over q, k, v data vars of `dtype`,
    fed f32 arrays that the executor casts."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        names = ('q', 'k', 'v')
        vs = [pkg.layers.data(n, shape=list(a.shape[1:]), dtype=dtype)
              for n, a in zip(names, arrays)]
        out = pkg.layers.fused_multihead_attention(*vs, causal=causal,
                                                   scale=scale)
    got, = exe.run(main, feed=dict(zip(names, arrays)), fetch_list=[out],
                   **run_kw)
    return got


def _jax(arrays, dtype, causal, scale):
    with fluid.scope_guard(fluid.Scope()):
        got = _run(fluid, arrays, dtype, causal, scale,
                   fluid.Executor(fluid.CPUPlace()))
    return np.asarray(got).astype(np.float32)


def _close(got, want, dtype, v):
    assert got.shape == want.shape
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0 ** -7 * np.abs(v).max())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', sorted(CASES))
def test_port_lowering_matches_jax_op(name, dtype):
    b, h, sq, sk, d, causal = CASES[name]
    arrays = _inputs(b, h, sq, sk, d)
    scale = d ** -0.5
    want = _jax(arrays, dtype, causal, scale)
    with ptt.scope_guard(ptt.Scope()):
        got = _run(ptt, arrays, dtype, causal, scale,
                   ptt.Executor(ptt.CPUPlace()), return_numpy=False)
    _close(got.float().numpy(), want, dtype, arrays[2])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', sorted(CASES))
def test_plain_version_matches_jax_op(name, dtype):
    b, h, sq, sk, d, causal = CASES[name]
    arrays = _inputs(b, h, sq, sk, d, seed=1)
    scale = 0.3
    want = _jax(arrays, dtype, causal, scale)
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    got = fa.flash_attention_reference(q, k, v, causal, scale)
    assert got.dtype == q.dtype
    _close(got.float().numpy(), want, dtype, arrays[2])


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 16, 16, 8))
    before = fa.flash_attn_fwd.launches
    got = fa.flash_attn_fwd(q, k, v, causal=True, scale=0.5)
    assert fa.flash_attn_fwd.launches == before
    torch.testing.assert_close(
        got, fa.flash_attention_reference(q, k, v, True, 0.5), rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 2, 8, 129)
    with pytest.raises(ValueError, match='D <= 128'):
        fa.flash_attn_fwd(q, q, q)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 16, 8, 8))
    with pytest.raises(ValueError, match='causal'):
        fa.flash_attn_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError, match='do not agree'):
        fa.flash_attn_fwd(q, k[..., :4], v)
    fa.flash_attn_fwd(q, k, v, causal=False)  # Sq > Sk is fine unmasked
