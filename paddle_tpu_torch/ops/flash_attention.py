"""Flash-attention forward: O = softmax(scale * Q Kᵀ [+ causal mask]) V.

Replaces the TPU kernel behind paddle_tpu's fused_multihead_attention
(paddle_tpu/ops/nn_ops.py:714-722): the forward of JAX 0.9.0's Pallas
flash attention, jax/experimental/pallas/ops/tpu/flash_attention.py,
_flash_attention_impl :589 with its pallas_call at :758. The port's kernel
is the hand-written CUDA C++ in csrc/flash_attn_fwd.cu, built for sm_90a at
first use (kernels.py).

Bound on an H100 SXM: 4·B·H·Sq·Sk·D operations (two products; the exp and
the rescaling are lower order) against the bytes of Q, K, V and O read or
written once. BERT-base at batch 8, S=512, f32 does 6.44 GFLOP a launch,
96 µs at the 67 TFLOP/s f32 CUDA-core peak, and moves 50 MB, 15 µs at
3.35 TB/s: bound by operations. In bf16 the operations' bound is the
989 TFLOP/s tensor-core peak; this first kernel computes in f32 on the
CUDA cores either way (tensor cores, wgmma and TMA are later work). The
[Sq, Sk] score matrix never goes to device memory.

`flash_attn_fwd` launches the kernel for CUDA tensors and takes the plain
version, `flash_attention_reference`, only for tensors on the CPU or the
'meta' device. It keeps a plain integer count of kernel launches in
`flash_attn_fwd.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
_MAX_GRID_Y = 65535


def flash_attention_reference(q, k, v, causal=False, scale=1.0):
    """The plain PyTorch version, step for step the JAX composition of
    paddle_tpu/ops/nn_ops.py:729-737: q*scale in q's dtype, the scores by
    einsum, masked with -1e30 above the diagonal offset by Sk-Sq when
    causal, softmax promoted to f32 and cast back, then einsum with v."""
    s = torch.einsum('bhqd,bhkd->bhqk', q * scale, k)
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype,
                                              device=s.device))
    p = torch.softmax(s.float(), dim=-1).to(s.dtype)
    return torch.einsum('bhqk,bhkd->bhqd', p, v)


def tolerance(v):
    """The kernel's absolute tolerance against flash_attention_reference,
    scaled by max|v| (every output row is a convex combination of v's rows).
    f32: 1e-5, for summation order and exp2 vs exp; both versions land
    within 2e-7 * max|v| of a float64 evaluation at the BERT-base shapes
    (CPU). bf16: 2**-6, because the plain version rounds q*scale, the
    scores, P and O to bf16 where the kernel rounds only O: a relative
    2**-9 on scores of magnitude up to ~8 moves P by up to ~1.6%."""
    rel = 1e-5 if v.dtype == torch.float32 else 2.0 ** -6
    return rel * float(v.abs().max())


def _check(q, k, v, causal):
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.ndim != 4:
            raise ValueError("flash_attn_fwd: %s must be [B, H, S, D], got "
                             "shape %s" % (name, tuple(t.shape)))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError("flash_attn_fwd: q %s, k %s, v %s do not agree "
                         "on B, H, D or Sk" % (tuple(q.shape),
                                               tuple(k.shape),
                                               tuple(v.shape)))
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError("flash_attn_fwd: head size D=%d; the kernel takes "
                         "1 <= D <= %d" % (d, MAX_HEAD_DIM))
    if causal and sq > sk:
        raise ValueError("flash_attn_fwd: causal with Sq=%d > Sk=%d leaves "
                         "query rows with no key; not supported" % (sq, sk))
    if sk == 0:
        raise ValueError("flash_attn_fwd: Sk=0, softmax over no keys")


def _lib():
    fn = kernels.load('flash_attn_fwd').ptpu_flash_attn_fwd
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attn_fwd(q, k, v, causal=False, scale=1.0):
    """softmax(scale·q·kᵀ [+ causal mask]) · v for q [B, H, Sq, D] and k, v
    [B, H, Sk, D], float32 or bfloat16, any strides. With causal, key j is
    kept for query i when j <= i + Sk - Sq.

    On CUDA tensors this launches the kernel or raises; it never falls back.
    The output is a [B, H, Sq, D] view of memory laid out [B, Sq, H, D], so
    the head merge that follows it (transpose [0, 2, 1, 3], reshape) is a
    view too. The kernel applies `scale` to the f32 scores, not to q in its
    own dtype as the plain version does."""
    _check(q, k, v, causal)
    if q.device.type in ('cpu', 'meta'):
        return flash_attention_reference(q, k, v, causal, scale)
    if q.device.type != 'cuda':
        raise ValueError("flash_attn_fwd: unsupported device %s" % q.device)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError("flash_attn_fwd: q must be float32 or bfloat16, got "
                        "%s" % q.dtype)
    for name, t in (('k', k), ('v', v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_attn_fwd: %s is %s on %s, q is %s on %s"
                             % (name, t.dtype, t.device, q.dtype, q.device))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if b * h > _MAX_GRID_Y:
        raise ValueError("flash_attn_fwd: B*H=%d exceeds the grid's %d"
                         % (b * h, _MAX_GRID_Y))
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 16)(*(q.stride() + k.stride() + v.stride()
                                         + out.stride()))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.addressof(strides), b, h, sq, sk, d, float(scale),
                 int(bool(causal)), _DTYPE_CODE[q.dtype], q.device.index,
                 stream)
    if err != 0:
        raise RuntimeError("flash_attn_fwd: kernel launch failed with CUDA "
                           "error %d" % err)
    flash_attn_fwd.launches += 1
    return out


flash_attn_fwd.launches = 0
