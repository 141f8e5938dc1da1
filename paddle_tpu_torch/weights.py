"""Carry a program's persistable state between numpy arrays and the
port's Scope.

The JAX package's scope holds its persistable vars as jax Arrays under the
names unique_name gave them; `np.asarray` of each is the hand-over format.
Both packages name a model's variables alike when it is built under a
fresh `unique_name.guard()`, so the arrays of a JAX-initialized model load
into the same model built with the port's layers. The state is every
persistable var, not only the parameters: a training program's Adam
moments (`<param>_moment1_0`, `<param>_moment2_0`), beta powers
(`<param>_beta1_pow_acc_0`, `<param>_beta2_pow_acc_0`) and learning-rate
var (`learning_rate_<n>`) come across too, and so does an LR schedule's
int64 step counter (`@LR_DECAY_COUNTER@`, shape [1]), which the JAX
package holds as int32 (JAX without x64): an integer array loads into an
integer var of another width, cast to the declared dtype, when its values
fit. So a JAX scope taken mid-training continues in the port.
`state_to_numpy` is the way back.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.scope import global_scope
from .core.selected_rows import SelectedRowsVal


def params_from_numpy(params, program, scope=None, device=None):
    """Set every persistable var of `program` in `scope` (default: the
    global scope) from `params` ({name: np.ndarray}), as a tensor on
    `device` (default: the CPU).

    Names must match exactly: a persistable of the program with no array,
    or an array with no persistable, raises. So does an array whose shape
    or dtype differs from the var's declaration, but for an integer array
    given to an integer var (int32 for int64, as JAX without x64 holds
    it), which is cast to the declared dtype if its values fit."""
    scope = scope if scope is not None else global_scope()
    device = torch.device(device) if device is not None else torch.device('cpu')
    persist = {v.name: v for v in program.list_vars() if v.persistable}
    missing = sorted(set(persist) - set(params))
    extra = sorted(set(params) - set(persist))
    if missing or extra:
        raise KeyError("params do not match the program's persistables: "
                       "missing %r, extra %r" % (missing, extra))
    arrays = {}
    for name, var in persist.items():
        arr = np.asarray(params[name])
        want = tuple(var.shape)
        if arr.shape == want and arr.dtype.name != var.dtype \
                and arr.dtype.kind in 'iu' \
                and var.dtype.startswith(('int', 'uint')):
            cast = arr.astype(var.dtype)
            if np.array_equal(cast, arr):
                arr = cast
        if arr.shape != want or arr.dtype.name != var.dtype:
            raise ValueError("param %r: got %s %s, the program declares %s %s"
                             % (name, arr.dtype.name, arr.shape, var.dtype,
                                want))
        arrays[name] = arr
    for name, arr in arrays.items():
        # a copy the caller's array does not alias: on the CPU a fresh
        # array, elsewhere the device's own
        t = torch.from_numpy(np.array(arr) if device.type == 'cpu'
                             else np.ascontiguousarray(arr))
        scope.set(name, t.to(device))


def _host(t):
    """A tensor, or a SelectedRowsVal (rows and values), copied to numpy."""
    if isinstance(t, SelectedRowsVal):
        return t.numpy()
    return t.detach().cpu().numpy()


def state_to_numpy(program, scope=None):
    """{name: np.ndarray} of every persistable var of `program` that
    `scope` (default: the global scope) holds, copied to the host (a
    SelectedRows value as a SelectedRowsVal of numpy arrays)."""
    scope = scope if scope is not None else global_scope()
    out = {}
    for v in program.list_vars():
        t = scope.get(v.name) if v.persistable else None
        if t is not None:
            out[v.name] = _host(t)
    return out
