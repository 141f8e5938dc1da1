"""Host-side Scope: name -> torch tensor map (ref: framework/scope.h:48).

The Scope is the home of parameters and other persistable state between
runs and the save/load surface. The Executor reads the persistables a
program uses from it and commits the program's persistable writes back.
Tensors stay on the device the Executor that wrote them runs on.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


class Scope(object):
    def __init__(self):
        self._vars = {}

    def var(self, name):
        """Create-or-get (reference Scope::Var)."""
        if name not in self._vars:
            self._vars[name] = None
        return _VarHandle(self, name)

    def find_var(self, name):
        return _VarHandle(self, name) if name in self._vars else None

    def get(self, name, default=None):
        return self._vars.get(name, default)

    def set(self, name, value):
        self._vars[name] = value

    def __contains__(self, name):
        return name in self._vars


class _VarHandle(object):
    """The reference Variable handle, enough for user code:
    var.get_tensor().set(np_array, place) / np.array(tensor)."""

    __slots__ = ('scope', 'name')

    def __init__(self, scope, name):
        self.scope = scope
        self.name = name

    def get_tensor(self):
        return _TensorHandle(self.scope, self.name)

    def get_value(self):
        return self.scope.get(self.name)

    def set_value(self, v):
        self.scope.set(self.name, v)


class _TensorHandle(object):
    __slots__ = ('scope', 'name')

    def __init__(self, scope, name):
        self.scope = scope
        self.name = name

    def set(self, array, place=None):
        device = place.device() if place is not None else torch.device('cpu')
        self.scope.set(self.name,
                       torch.as_tensor(np.asarray(array)).to(device))

    def shape(self):
        v = self.scope.get(self.name)
        return list(v.shape) if v is not None else []

    def __array__(self, dtype=None, copy=None):
        arr = self.scope.get(self.name).detach().cpu().numpy()
        return arr.astype(dtype) if dtype is not None else arr


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    prev, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = prev
