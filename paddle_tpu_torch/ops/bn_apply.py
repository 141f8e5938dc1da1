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

`bn_apply` launches the kernel for a CUDA tensor and takes the plain
version, `bn_apply_reference`, only for a tensor on the CPU or on the
'meta' device (build-time shape inference). It keeps a plain integer count
of kernel launches in `bn_apply.launches`.
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


def _lib():
    lib = kernels.load('bn_apply')
    fn = lib.ptpu_bn_apply
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_uint] * 3
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def bn_apply(x, k, b, act=None, channel_axis=1):
    """y = act(x * k[c] + b[c]), c indexing `channel_axis` of x.

    x: contiguous float32 or bfloat16; k, b: contiguous 1-D float32 of
    length x.shape[channel_axis] on x's device. On a CUDA tensor this
    launches the CUDA kernel or raises; it never falls back."""
    if act not in _ACTS:
        raise ValueError("bn_apply: act must be None or 'relu', got %r" % (act,))
    if x.device.type in ('cpu', 'meta'):
        return bn_apply_reference(x, k, b, act, channel_axis)
    if x.device.type != 'cuda':
        raise ValueError("bn_apply: unsupported device %s" % x.device)
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
    return y


bn_apply.launches = 0
