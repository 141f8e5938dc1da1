"""Executor: runs a Program's block 0 with torch on one device.

The counterpart of paddle_tpu/executor.py:208 `Executor.run`, with the same
feed/fetch contract. Where the JAX executor traces the block into a jitted
step function, this one interprets it eagerly (core/lowering.py):

1. gather the program's persistable vars present in the Scope,
2. convert the feeds to tensors of the declared dtypes on the device,
3. run the ops of block 0 in order, inside core.amp.scope(True) when the
   program is marked for bf16 (`program._amp_bf16`, set by
   contrib.mixed_precision), as paddle_tpu/executor.py:1160,1181 traces
   its step,
4. commit the persistable vars the block wrote back to the Scope,
5. return the fetches as numpy arrays, or as device tensors with
   return_numpy=False (a serving loop then syncs once, not per request).
"""
from __future__ import annotations

import numpy as np
import torch

from .framework import (CUDAPlace, Variable, default_main_program,
                        to_torch_dtype)
from .core import amp
from .core.lowering import Interpreter
from .core.scope import global_scope


def _fetch_name(f):
    if isinstance(f, Variable):
        return f.name
    if isinstance(f, str):
        return f
    raise TypeError("fetch_list entries must be Variable or str, got %r" % (f,))


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        raise TypeError("numpy has no bfloat16: fetch %s tensors with "
                        "return_numpy=False" % t.dtype)
    return t.detach().cpu().numpy()


class Executor(object):
    """Runs programs on `place`: CUDAPlace(0) unless the caller passes
    CPUPlace(). A CUDA place where torch sees no card raises here."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()

    def _feed_tensor(self, value, var):
        dtype = to_torch_dtype(var.dtype) if var is not None else None
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        return value.to(device=self.device, dtype=dtype)

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True):
        program = program if program is not None else default_main_program()
        fetch_list = fetch_list or []
        if isinstance(fetch_list, (Variable, str)):
            fetch_list = [fetch_list]
        fetch_names = [_fetch_name(f) for f in fetch_list]
        scope = scope if scope is not None else global_scope()
        block = program.global_block()

        env = {}
        persist = {v.name for v in program.list_vars() if v.persistable}
        for name in persist:
            val = scope.get(name)
            if val is not None:
                env[name] = val.to(self.device)
        for name, value in (feed or {}).items():
            env[name] = self._feed_tensor(value, block._find_var_recursive(name))

        interp = Interpreter(program, self.device, env)
        bf16 = getattr(program, '_amp_bf16', False)
        with torch.no_grad(), amp.scope(bf16):
            interp.run_block(block)
        for name in persist & interp.written:
            scope.set(name, env[name])

        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise ValueError("fetch targets %r have no value after the run: "
                             "not computed by the program and not fed"
                             % missing)
        fetches = interp.fetches + [env[n] for n in fetch_names]
        if return_numpy:
            return [_to_numpy(t) for t in fetches]
        return fetches
