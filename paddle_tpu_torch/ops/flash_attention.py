"""Flash attention: O = softmax(scale * Q Kᵀ [+ causal mask]) V, and its
gradients.

Replaces the TPU kernels behind paddle_tpu's fused_multihead_attention
(paddle_tpu/ops/nn_ops.py:714-722), JAX 0.9.0's Pallas flash attention in
jax/experimental/pallas/ops/tpu/flash_attention.py:
- K2-fwd, _flash_attention_impl :589 (pallas_call :758), by the
  hand-written CUDA C++ in csrc/flash_attn_fwd.cu (`flash_attn_fwd`);
- K2-bwd-dkv, _flash_attention_bwd_dkv :941 (pallas_call :1121), and
  K2-bwd-dq, _flash_attention_bwd_dq :1287 (pallas_call :1456), by the two
  kernels of csrc/flash_attn_bwd.cu (`flash_attn_bwd_dkv`,
  `flash_attn_bwd_dq`).
All are built for sm_90a at first use (kernels.py). `FlashAttention` ties
them together as a torch.autograd.Function: its forward keeps each query
row's log-sum-exp (the port's form of JAX's l and m residuals, :246-251),
and its backward computes di = rowsum(dO·O) in plain torch, as JAX does
outside its kernels (:273-275), then runs the two backward kernels.

Bound on an H100 SXM: 4·B·H·Sq·Sk·D operations (two products; the exp and
the rescaling are lower order) against the bytes of Q, K, V and O read or
written once. BERT-base at batch 8, S=512 does 6.44 GFLOP a launch. All
three kernels run every product on the tensor cores (mma.sync): bf16 with
f32 accumulators, f32 in the 3xTF32 split (three TF32 products for each
f32 one), which keeps about f32 accuracy (csrc/mma_frag.cuh). In bf16 the
forward's bound is its 25 MB at 3.35 TB/s (7.5 µs; its operations take
6.5 µs at 989 TFLOP/s); in f32, its operations at a third of the
495 TFLOP/s TF32 rate (39 µs; 96 µs at the 67 TFLOP/s of f32 on the CUDA
cores). The [Sq, Sk] score matrix never goes to device memory.

The backward kernels do 8·B·H·Sq·Sk·D (dkv) and 6·B·H·Sq·Sk·D (dq)
operations: 12.9 and 9.7 GFLOP at BERT-base's batch 8, 13 and 10 µs at the
bf16 tensor-core peak, 78 and 59 µs at the f32 3xTF32 rate, bound by
operations as the forward is (csrc/flash_attn_bwd.cu has the design).

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (`flash_attention_reference` with `flash_attention_reference_lse`,
`flash_attn_bwd_dkv_reference`, `flash_attn_bwd_dq_reference`) only for
tensors on the CPU or the 'meta' device. Each keeps a plain integer count
of kernel launches in `<wrapper>.launches`, one by q's dtype in
`<wrapper>.launches_by_dtype` ({'float32': n, 'bfloat16': n}) and one by
the causal flag in `<wrapper>.launches_by_causal` ({'causal': n,
'noncausal': n}).
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


def flash_attention_reference_lse(q, k, causal=False, scale=1.0):
    """The plain version of K2-fwd's log-sum-exp: f32 [B, H, Sq],
    ln(sum_j exp(scale·q_i·k_j)) over the kept keys, with the kernel's
    semantics (q and k promoted to f32, the scale on the f32 scores)."""
    s = _scores(q, k, causal, scale)
    return torch.logsumexp(s, dim=-1)


def _scores(q, k, causal, scale):
    """scale·q·kᵀ in f32, -inf where the causal mask drops a key."""
    s = torch.einsum('bhqd,bhkd->bhqk', q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, float('-inf'))
    return s


def _probs_and_ds(q, k, v, do, lse, di, causal, scale):
    """P recomputed from the log-sum-exp, and dS = scale·P·(dO·Vᵀ - di),
    each computed in f32 and then rounded to q's dtype, as the TPU kernels
    round them before their second products (jax/experimental/pallas/ops/
    tpu/flash_attention.py: p.T.astype :900, ds.T.astype :918, ds.astype
    :1258, the scale already in ds); a no-op in f32. Returned as f32."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum('bhqd,bhkd->bhqk', do.float(), v.float())
    ds = p * (dp - di[..., None]) * scale
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_attn_bwd_dkv_reference(q, k, v, do, lse, di, causal=False,
                                 scale=1.0):
    """The plain version of K2-bwd-dkv: (dK, dV) in q's dtype, dV = Pᵀ·dO
    and dK = dSᵀ·Q in f32 from P and dS rounded as _probs_and_ds says."""
    p, ds = _probs_and_ds(q, k, v, do, lse, di, causal, scale)
    dv = torch.einsum('bhqk,bhqd->bhkd', p, do.float())
    dk = torch.einsum('bhqk,bhqd->bhkd', ds, q.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attn_bwd_dq_reference(q, k, v, do, lse, di, causal=False,
                                scale=1.0):
    """The plain version of K2-bwd-dq: dQ = dS·K in q's dtype, in f32 from
    dS rounded as _probs_and_ds says."""
    _, ds = _probs_and_ds(q, k, v, do, lse, di, causal, scale)
    return torch.einsum('bhqk,bhkd->bhqd', ds, k.float()).to(q.dtype)


def tolerance(v):
    """The kernel's absolute tolerance against flash_attention_reference,
    scaled by max|v| (every output row is a convex combination of v's rows).
    f32: 1e-5, for summation order, exp2 vs exp and the kernel's 3xTF32
    products; the plain version lands within 2e-7 * max|v| of a float64
    evaluation at the BERT-base shapes, and so does an emulation of the
    kernel's arithmetic at [1, 2, 512, 64] (CPU,
    tests/test_torch_flash_attention_tf32x3.py).
    bf16: 2**-6, because the plain version rounds q*scale, the scores, P
    and O to bf16 where the kernel rounds only P and O: a relative 2**-9
    on scores of magnitude up to ~8 moves P by up to ~1.6%."""
    rel = 1e-5 if v.dtype == torch.float32 else 2.0 ** -6
    return rel * float(v.abs().max())


def grad_tolerance(ref):
    """A backward kernel's absolute tolerance against its plain version,
    scaled by max|ref| of the gradient compared. Both start from the same
    inputs, LSE and di and accumulate in f32, so they differ by summation
    order, exp2 against exp and, in f32, the kernel's 3xTF32 products
    (about 2**-22 of each product; f32: 1e-5). In bf16 both round P, dS
    and the output to bf16, so they differ by where the output's rounding
    lands (2**-7, one bf16 ulp of the largest value)."""
    rel = 1e-5 if ref.dtype == torch.float32 else 2.0 ** -7
    return rel * float(ref.float().abs().max())


def _check(q, k, v, causal, who='flash_attn_fwd'):
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.ndim != 4:
            raise ValueError("%s: %s must be [B, H, S, D], got shape %s"
                             % (who, name, tuple(t.shape)))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError("%s: q %s, k %s, v %s do not agree on B, H, D or Sk"
                         % (who, tuple(q.shape), tuple(k.shape),
                            tuple(v.shape)))
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError("%s: head size D=%d; the kernel takes 1 <= D <= %d"
                         % (who, d, MAX_HEAD_DIM))
    if causal and sq > sk:
        raise ValueError("%s: causal with Sq=%d > Sk=%d leaves query rows "
                         "with no key; not supported" % (who, sq, sk))
    if sk == 0:
        raise ValueError("%s: Sk=0, softmax over no keys" % who)


def _check_cuda(who, q, others):
    """The kernels' own demands on CUDA tensors: float32 or bfloat16, all
    on q's device with q's dtype, and B*H within the grid."""
    if q.device.type != 'cuda':
        raise ValueError("%s: unsupported device %s" % (who, q.device))
    if q.dtype not in _DTYPE_CODE:
        raise TypeError("%s: q must be float32 or bfloat16, got %s"
                        % (who, q.dtype))
    for name, t, dtype in others:
        want = q.dtype if dtype is None else dtype
        if t.device != q.device or t.dtype != want:
            raise ValueError("%s: %s is %s on %s, want %s on %s"
                             % (who, name, t.dtype, t.device, want, q.device))
    if q.shape[0] * q.shape[1] > _MAX_GRID_Y:
        raise ValueError("%s: B*H=%d exceeds the grid's %d"
                         % (who, q.shape[0] * q.shape[1], _MAX_GRID_Y))


def _check_bwd(who, q, k, v, do, lse, di, causal):
    _check(q, k, v, causal, who)
    b, h, sq, _ = q.shape
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError("%s: dO %s differs from q %s"
                         % (who, tuple(do.shape), tuple(q.shape)))
    for name, t in (('lse', lse), ('di', di)):
        if tuple(t.shape) != (b, h, sq):
            raise ValueError("%s: %s must be [B, H, Sq] = %s, got %s"
                             % (who, name, (b, h, sq), tuple(t.shape)))


def _strides(*ts):
    return (ctypes.c_longlong * (4 * len(ts)))(
        *[s for t in ts for s in t.stride()])


def _bshd_like(x):
    """An empty [B, H, S, D] tensor over [B, S, H, D] memory, as the head
    merge and the head split's gradient want it."""
    b, h, s, d = x.shape
    return torch.empty((b, s, h, d), dtype=x.dtype,
                       device=x.device).permute(0, 2, 1, 3)


def _fn(name, n_ptrs):
    """The kernel's ctypes entry point with argtypes set: pointers as
    c_void_p, or ctypes cuts them to 32 bits."""
    fn = getattr(kernels.load(_SOURCE[name]), 'ptpu_' + name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


_SOURCE = {'flash_attn_fwd': 'flash_attn_fwd',
           'flash_attn_bwd_dkv': 'flash_attn_bwd',
           'flash_attn_bwd_dq': 'flash_attn_bwd'}


def _launch(name, ptrs, q, k, causal, scale):
    b, h, sq, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn(name, len(ptrs))(*ptrs, b, h, sq, k.shape[2], d, float(scale),
                               int(bool(causal)), _DTYPE_CODE[q.dtype],
                               q.device.index, stream)
    if err != 0:
        raise RuntimeError("%s: kernel launch failed with CUDA error %d"
                           % (name, err))


def flash_attn_fwd(q, k, v, causal=False, scale=1.0, return_lse=False):
    """softmax(scale·q·kᵀ [+ causal mask]) · v for q [B, H, Sq, D] and k, v
    [B, H, Sk, D], float32 or bfloat16, any strides. With causal, key j is
    kept for query i when j <= i + Sk - Sq. With return_lse, also each
    query row's log-sum-exp of the scaled scores, f32 [B, H, Sq].

    On CUDA tensors this launches the kernel or raises; it never falls back:
    bf16 inputs multiply bf16 operands on the tensor cores with f32
    accumulation (P rounded to bf16 for P·V, as the TPU kernel does), f32
    inputs use the 3xTF32 split there (about f32 accuracy). The output is a
    [B, H, Sq, D] view of memory laid out [B, Sq, H, D], so the head merge
    that follows it (transpose [0, 2, 1, 3], reshape) is a view too. The
    kernel applies `scale` to the f32 scores, not to q in its own dtype as
    the plain version does."""
    _check(q, k, v, causal)
    if q.device.type in ('cpu', 'meta'):
        out = flash_attention_reference(q, k, v, causal, scale)
        if return_lse:
            return out, flash_attention_reference_lse(q, k, causal, scale)
        return out
    _check_cuda('flash_attn_fwd', q, (('k', k, None), ('v', v, None)))
    b, h, sq, _ = q.shape
    out = _bshd_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() != 0:
        strides = _strides(q, k, v, out)  # alive until the call returns
        _launch('flash_attn_fwd',
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 ctypes.addressof(strides)),
                q, k, causal, scale)
        flash_attn_fwd.launches += 1
        flash_attn_fwd.launches_by_dtype[str(q.dtype)[6:]] += 1
        flash_attn_fwd.launches_by_causal[_CAUSAL[bool(causal)]] += 1
    return (out, lse) if return_lse else out


def flash_attn_bwd_dkv(q, k, v, do, lse, di, causal=False, scale=1.0):
    """(dK, dV) of flash_attn_fwd, [B, H, Sk, D] in q's dtype, from q, k, v,
    the output's gradient dO [B, H, Sq, D] (any strides), and the f32
    [B, H, Sq] log-sum-exp of the forward and di = rowsum(dO·O). On CUDA
    tensors this launches K2-bwd-dkv or raises: bf16 inputs multiply bf16
    operands on the tensor cores with f32 accumulation, f32 inputs use the
    3xTF32 split there (about f32 accuracy; csrc/flash_attn_bwd.cu). dK
    and dV are [B, H, Sk, D] views of [B, Sk, H, D] memory, so the head
    split's gradient is a view."""
    _check_bwd('flash_attn_bwd_dkv', q, k, v, do, lse, di, causal)
    if q.device.type in ('cpu', 'meta'):
        return flash_attn_bwd_dkv_reference(q, k, v, do, lse, di, causal,
                                            scale)
    _check_cuda('flash_attn_bwd_dkv', q, (
        ('k', k, None), ('v', v, None), ('dO', do, None),
        ('lse', lse, torch.float32), ('di', di, torch.float32)))
    lse, di = lse.contiguous(), di.contiguous()
    dk, dv = _bshd_like(k), _bshd_like(v)
    if dk.numel() != 0:
        strides = _strides(q, k, v, do, dk, dv)
        _launch('flash_attn_bwd_dkv',
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 ctypes.addressof(strides)),
                q, k, causal, scale)
        flash_attn_bwd_dkv.launches += 1
        flash_attn_bwd_dkv.launches_by_dtype[str(q.dtype)[6:]] += 1
        flash_attn_bwd_dkv.launches_by_causal[_CAUSAL[bool(causal)]] += 1
    return dk, dv


def flash_attn_bwd_dq(q, k, v, do, lse, di, causal=False, scale=1.0):
    """dQ of flash_attn_fwd, [B, H, Sq, D] in q's dtype (a view of
    [B, Sq, H, D] memory), from the same inputs as flash_attn_bwd_dkv. On
    CUDA tensors this launches K2-bwd-dq or raises, with the arithmetic of
    flash_attn_bwd_dkv."""
    _check_bwd('flash_attn_bwd_dq', q, k, v, do, lse, di, causal)
    if q.device.type in ('cpu', 'meta'):
        return flash_attn_bwd_dq_reference(q, k, v, do, lse, di, causal,
                                           scale)
    _check_cuda('flash_attn_bwd_dq', q, (
        ('k', k, None), ('v', v, None), ('dO', do, None),
        ('lse', lse, torch.float32), ('di', di, torch.float32)))
    lse, di = lse.contiguous(), di.contiguous()
    dq = _bshd_like(q)
    if dq.numel() != 0:
        strides = _strides(q, k, v, do, dq)
        _launch('flash_attn_bwd_dq',
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                 ctypes.addressof(strides)),
                q, k, causal, scale)
        flash_attn_bwd_dq.launches += 1
        flash_attn_bwd_dq.launches_by_dtype[str(q.dtype)[6:]] += 1
        flash_attn_bwd_dq.launches_by_causal[_CAUSAL[bool(causal)]] += 1
    return dq


_CAUSAL = {True: 'causal', False: 'noncausal'}
for _wrapper in (flash_attn_fwd, flash_attn_bwd_dkv, flash_attn_bwd_dq):
    _wrapper.launches = 0
    _wrapper.launches_by_dtype = {'float32': 0, 'bfloat16': 0}
    _wrapper.launches_by_causal = {'causal': 0, 'noncausal': 0}
del _wrapper


class FlashAttention(torch.autograd.Function):
    """softmax(scale·q·kᵀ [+ causal mask])·v with its gradient on the
    kernels: the forward runs K2-fwd and keeps q, k, v, O and the rows'
    log-sum-exp; the backward computes di = rowsum(dO·O) in f32 and runs
    K2-bwd-dkv and K2-bwd-dq. On CPU tensors every step takes its plain
    version.

        out = FlashAttention.apply(q, k, v, causal, scale)
    """

    @staticmethod
    def forward(ctx, q, k, v, causal=False, scale=1.0):
        out, lse = flash_attn_fwd(q, k, v, causal, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        di = (do.float() * out.float()).sum(-1)
        dk, dv = flash_attn_bwd_dkv(q, k, v, do, lse, di, ctx.causal,
                                    ctx.scale)
        dq = flash_attn_bwd_dq(q, k, v, do, lse, di, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None
