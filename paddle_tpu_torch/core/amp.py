"""bf16 mixed precision ("value mode"), the port's copy of
paddle_tpu/core/amp.py:29-152.

bf16 shares float32's exponent range, so mixed precision needs no loss
scaling. Under the amp scope, the matmul and convolution lowerings cast
their operands to bf16 and keep the result in bf16, so activations flow
through the network at half the bytes. Parameters stay float32 in the
Scope: they are cast to bf16 at each use, and autograd's transpose of that
cast hands every parameter an f32 gradient, as JAX's vjp does. Numerically
sensitive ops opt out with `promote_f32` and `restore`: norm statistics,
softmax and losses compute in float32.

A program is marked with `program._amp_bf16 = True`
(contrib.mixed_precision.decorate or enable_bf16), and the Executor runs its
block inside `scope(True)`, so one set of lowerings serves both precisions.
Build-time shape inference runs outside the scope: declared var dtypes stay
float32, as in the reference.

The switch is per thread. The reference reads its copy only while jit
traces a step, once, on one thread; the port reads it at every op of every
`Executor.run`, and a serving thread (inference/batching.py) may run f32
inference while another thread trains in bf16.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

_state = threading.local()
_AMP_FLOATS = (torch.float32, torch.bfloat16)


def enabled():
    return getattr(_state, 'bf16', False)


@contextlib.contextmanager
def scope(on):
    prev = enabled()
    _state.bf16 = bool(on)
    try:
        yield
    finally:
        _state.bf16 = prev


def _is_amp_float(x):
    return getattr(x, 'dtype', None) in _AMP_FLOATS


def promote_f32(x):
    """bf16 to f32 for numerically sensitive math (norm statistics,
    softmax, log/exp losses); every other dtype as it is."""
    if getattr(x, 'dtype', None) == torch.bfloat16:
        return x.float()
    return x


def restore(y, like):
    """y cast back to `like`'s compute dtype where that is bf16 and y is
    f32; otherwise y as it is."""
    if getattr(like, 'dtype', None) == torch.bfloat16 \
            and y.dtype == torch.float32:
        return y.to(torch.bfloat16)
    return y


def unify(x, y):
    """Under the amp scope, a bf16/f32 pair of operands becomes bf16/bf16
    (otherwise a parameter + activation elementwise, the fc bias add for
    one, would promote the activation back to f32). Outside the scope, or
    for any other pair of dtypes, x and y as they are."""
    if (enabled() and _is_amp_float(x) and _is_amp_float(y)
            and x.dtype != y.dtype):
        return x.to(torch.bfloat16), y.to(torch.bfloat16)
    return x, y


def matmul(x, y, preferred_element_type=None):
    """torch.matmul with bf16 operands and a bf16 result under the amp
    scope (the product accumulates in f32 and rounds once). Outside it, the
    operands promote to a common dtype, and with preferred_element_type
    the result is given in that dtype, as jnp.matmul's
    preferred_element_type gives it."""
    if enabled() and _is_amp_float(x) and _is_amp_float(y):
        return torch.matmul(x.to(torch.bfloat16), y.to(torch.bfloat16))
    common = torch.promote_types(x.dtype, y.dtype)
    out = torch.matmul(x.to(common), y.to(common))
    if preferred_element_type is not None:
        out = out.to(preferred_element_type)
    return out


def conv2d(x, w, stride=1, padding=0, dilation=1, groups=1):
    """F.conv2d (no bias), in bf16 with a bf16 result under the amp scope:
    the counterpart of the reference's conv_general_dilated."""
    if enabled() and _is_amp_float(x) and _is_amp_float(w):
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    return F.conv2d(x, w, None, stride=stride, padding=padding,
                    dilation=dilation, groups=groups)
