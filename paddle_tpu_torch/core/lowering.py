"""Program interpreter: runs block 0 op by op with torch, eagerly.

The counterpart of paddle_tpu/core/lowering.py, which traces the block once
into a jitted JAX function. Here each op's registered lowering runs as soon
as it is reached, on the tensors of an environment (var name -> tensor) that
the Executor seeds with the persistable state and the feeds. There is no
tracing and no compile step; ops that write persistable vars rebind their
names in the environment, and the Executor commits those writes to the
Scope after the block has run.
"""
from __future__ import annotations

import torch

from . import registry


class TraceError(RuntimeError):
    pass


class OpCtx(object):
    """Per-op context handed to lowering rules."""

    __slots__ = ('interp', 'op', 'attrs', 'block', 'device')

    def __init__(self, interp, op, block):
        self.interp = interp
        self.op = op
        self.attrs = op.attrs
        self.block = block
        self.device = interp.device

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    @property
    def is_test(self):
        return bool(self.attrs.get('is_test', False))

    def rng(self):
        """A torch.Generator on the op's device for the op's random draws:
        seeded from the program's random_seed and the op's own 'seed' attr,
        or its uid when that is 0, so the same program draws the same
        numbers on every run on the same device type."""
        op_seed = int(self.attrs.get('seed', 0) or
                      self.attrs.get('_op_uid', 0)) & 0x7FFFFFFF
        seed = (int(self.interp.program.random_seed) * 0x9E3779B1
                + op_seed) & 0x7FFFFFFFFFFFFFFF
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def var(self, name):
        """Build-time Variable metadata (shape with -1s, dtype)."""
        return self.block._find_var_recursive(name)


class Interpreter(object):
    """Walks a block in order, keeping env: var name -> tensor."""

    def __init__(self, program, device, env):
        self.program = program
        self.device = device
        self.env = env
        self.fetches = []
        self.written = set()

    def read(self, name, op):
        if name in self.env:
            return self.env[name]
        raise TraceError(
            "Op %s reads variable %r which has no value. Feed it, initialize "
            "it via the startup program, or check op ordering." % (op, name))

    def run_block(self, block):
        for op in block.ops:
            self.run_op(op, block)
        return self.env

    def run_op(self, op, block):
        t = op.type
        if t == 'feed':
            return  # env pre-populated by the executor
        if t == 'fetch':
            self.fetches.append(self.read(op.inputs['X'][0], op))
            return
        d = registry.get(t)
        if d is None:
            raise TraceError("No lowering registered for op type %r (%s)" %
                             (t, op))
        ins = {slot: [self.read(n, op) if n else None for n in names]
               for slot, names in op.inputs.items()}
        outs = d.lower(OpCtx(self, op, block), ins) or {}
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            for n, v in zip(names, vals):
                if n and v is not None:
                    self.env[n] = v
                    self.written.add(n)
