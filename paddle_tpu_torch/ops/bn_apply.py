"""Fused batch-norm apply: y = act(x * k[c] + b[c]) in one pass over x.

Replaces the TPU kernel paddle_tpu/ops/pallas_bn.py:_fwd_impl (pallas_call
at :48, body _kernel at :24) with the hand-written CUDA C++ kernel in
csrc/bn_apply.cu, built for sm_90a at first use (kernels.py).

Bound on an H100 SXM: 2 operations per element against 2 * numel *
itemsize bytes (x read once, y written once), so memory-bound at 3.35 TB/s;
ResNet-50's 53 batch_norm outputs at batch 16 in f32 move 1.42 GB, 0.42 ms
at that rate. The design answers the bound with 16-byte vector loads and
stores over contiguous x, one vector per thread, and k and b read through
the read-only cache (details in the source).

`bn_apply` goes through `BnApplyFunction` when a gradient is asked for,
the counterpart of the reference's `jax.custom_vjp` (pallas_bn.py:35
fused_bn_apply): its forward
launches the kernel for a CUDA tensor and takes the plain version,
`bn_apply_reference`, only for a tensor on the CPU or on the 'meta' device
(build-time shape inference); its backward is plain torch, ported from the
reference's `_bwd` (:68), which is plain JAX. So a training step's
batch_norm_grad gets dX, dScale and dBias through the kernel's output as
it would through the plain version. A plain integer count of kernel
launches is kept in `bn_apply.launches`, and one by x's dtype in
`bn_apply.launches_by_dtype` ({'float32': n, 'bfloat16': n}).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = (None, 'relu')


def _param_shape(x, channel_axis):
    shape = [1] * x.ndim
    shape[channel_axis] = x.shape[channel_axis]
    return shape


def bn_apply_reference(x, k, b, act=None, channel_axis=1):
    """The plain PyTorch version: k and b cast to x's dtype, then x*k + b
    (each rounded in x's dtype), then relu if asked."""
    if act not in _ACTS:
        raise ValueError("bn_apply: act must be None or 'relu', got %r" % (act,))
    shape = _param_shape(x, channel_axis)
    y = x * k.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)
    return torch.relu(y) if act == 'relu' else y


def one_ulp_bound(x, k, b, channel_axis=1):
    """The kernel's tolerance against bn_apply_reference, elementwise: one
    ulp of x's dtype at the operands' magnitude |x*k| + |b|. The kernel
    rounds once where the plain version rounds x*k and then the sum; in
    f32 both round the same and agree bit for bit."""
    shape = _param_shape(x, channel_axis)
    kk = k.to(x.dtype).float().reshape(shape)
    bb = b.to(x.dtype).float().reshape(shape)
    return torch.finfo(x.dtype).eps * ((x.float() * kk).abs() + bb.abs())


def backward_bounds(x, k, b, dy, y, y_plain, dk_plain, db_plain, act=None,
                    channel_axis=1):
    """The tolerances of BnApplyFunction's gradients against autograd
    through bn_apply_reference on the same x, k, b and dy, where y is the
    Function's output and y_plain, dk_plain, db_plain the plain version's.
    Returns (differ, dx_bound, dk_bound, db_bound):

    - differ: where the relu masks y > 0 and y_plain > 0 differ. The
      kernel's y may differ from the plain y by one_ulp_bound, so a mask
      may differ only where |y_plain| is within it (the caller checks);
      dx is not compared there.
    - dx_bound, elementwise: dx = dy·k is one multiply in x's dtype on both
      sides, eps·|dy·k|.
    - dk_bound, db_bound, per channel: dk = sum(dy·x) and db = sum(dy),
      summed in f32 over the L elements of a channel, within
      eps(x's dtype)·|plain| (the plain version's k and b gradients come
      back rounded to x's dtype) + L·2^-24·sum|terms| (the bound of an f32
      sum of L terms) + sum|terms| where the masks differ."""
    shape = _param_shape(x, channel_axis)
    red = tuple(i for i in range(x.ndim) if i != channel_axis)
    length = x.numel() // x.shape[channel_axis]
    eps = torch.finfo(x.dtype).eps
    if act == 'relu':
        differ = (y > 0) != (y_plain > 0)
        live = (y_plain > 0) & ~differ
    else:
        differ = torch.zeros_like(x, dtype=torch.bool)
        live = torch.ones_like(x, dtype=torch.bool)
    dx_bound = eps * (dy.float() * k.to(x.dtype).float().reshape(shape)).abs()
    bounds = []
    for plain, terms in ((dk_plain, (dy * x).float().abs()),
                         (db_plain, dy.float().abs())):
        bounds.append(eps * plain.float().abs()
                      + length * 2.0 ** -24 * (terms * live).sum(red)
                      + (terms * differ).sum(red))
    return differ, dx_bound, bounds[0], bounds[1]


def _lib():
    lib = kernels.load('bn_apply')
    fn = lib.ptpu_bn_apply
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_uint] * 3
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x, k, b, act, channel_axis):
    """The CUDA kernel on x, k, b (no autograd): checks what it takes,
    launches it into a fresh tensor and counts the launch."""
    c = x.shape[channel_axis]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("bn_apply: x must be float32 or bfloat16, got %s"
                        % x.dtype)
    for name, p in (('k', k), ('b', b)):
        if p.device != x.device or p.dtype != torch.float32 \
                or p.shape != (c,) or not p.is_contiguous():
            raise ValueError(
                "bn_apply: %s must be a contiguous float32 [%d] on %s, got "
                "%s %s on %s" % (name, c, x.device, p.dtype, tuple(p.shape),
                                 p.device))
    if not x.is_contiguous():
        raise ValueError("bn_apply: x must be contiguous")
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError("bn_apply: x has %d elements; the kernel indexes "
                         "with 32 bits (< 2**31)" % n)
    y = torch.empty_like(x)
    if n == 0:
        return y
    inner = int(np.prod(x.shape[channel_axis + 1:]))
    vectorize = int(x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    fn = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), k.data_ptr(), b.data_ptr(), y.data_ptr(),
             n, inner, c, _DTYPE_CODE[x.dtype], int(act == 'relu'),
             vectorize, x.device.index, stream)
    if err != 0:
        raise RuntimeError("bn_apply: kernel launch failed with CUDA error "
                           "%d" % err)
    bn_apply.launches += 1
    bn_apply.launches_by_dtype[str(x.dtype)[6:]] += 1
    return y


def _forward(x, k, b, act, channel_axis):
    if x.device.type in ('cpu', 'meta'):
        return bn_apply_reference(x, k, b, act, channel_axis)
    if x.device.type == 'cuda':
        return _launch(x, k, b, act, channel_axis)
    raise ValueError("bn_apply: unsupported device %s" % x.device)


class BnApplyFunction(torch.autograd.Function):
    """y = act(x * k[c] + b[c]) with the reference's custom VJP.

    Forward: the CUDA kernel on a CUDA tensor, the plain version on the CPU
    or 'meta'. Backward, plain torch as pallas_bn.py:68 `_bwd` is plain
    JAX: with act='relu' dy is first masked by y > 0; then
    dx = dy * k[c] (k cast to dy's dtype), dk = sum(dy * x) and
    db = sum(dy), both summed in f32 over every axis but the channel and
    cast to k's dtype (b's for db)."""

    @staticmethod
    def forward(ctx, x, k, b, act=None, channel_axis=1):
        y = _forward(x, k, b, act, channel_axis)
        ctx.act, ctx.channel_axis, ctx.b_dtype = act, channel_axis, b.dtype
        if act == 'relu':
            ctx.save_for_backward(x, k, y)
        else:
            ctx.save_for_backward(x, k)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, k = ctx.saved_tensors[:2]
        if ctx.act == 'relu':
            dy = dy * (ctx.saved_tensors[2] > 0).to(dy.dtype)
        red = tuple(i for i in range(x.ndim) if i != ctx.channel_axis)
        need_x, need_k, need_b = ctx.needs_input_grad[:3]
        dx = dk = db = None
        if need_x:
            shape = _param_shape(x, ctx.channel_axis)
            dx = dy * k.to(dy.dtype).reshape(shape)
        if need_k:
            dk = (dy * x).float().sum(red).to(k.dtype)
        if need_b:
            db = dy.float().sum(red).to(ctx.b_dtype)
        return dx, dk, db, None, None


def bn_apply(x, k, b, act=None, channel_axis=1):
    """y = act(x * k[c] + b[c]), c indexing `channel_axis` of x, through
    BnApplyFunction (differentiable in x, k and b) where autograd records
    and one of them requires grad; otherwise (serving, and every op the
    Executor runs under no_grad) straight through the same forward, which
    saves the Function's dispatch on the host.

    x: contiguous float32 or bfloat16; k, b: contiguous 1-D float32 of
    length x.shape[channel_axis] on x's device. On a CUDA tensor this
    launches the CUDA kernel or raises; it never falls back."""
    if act not in _ACTS:
        raise ValueError("bn_apply: act must be None or 'relu', got %r" % (act,))
    if torch.is_grad_enabled() and (x.requires_grad or k.requires_grad
                                    or b.requires_grad):
        return BnApplyFunction.apply(x, k, b, act, channel_axis)
    return _forward(x, k, b, act, channel_axis)


bn_apply.launches = 0
bn_apply.launches_by_dtype = {'float32': 0, 'bfloat16': 0}
