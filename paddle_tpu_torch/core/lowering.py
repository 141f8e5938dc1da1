"""Program interpreter: runs block 0 op by op with torch, eagerly.

The counterpart of paddle_tpu/core/lowering.py, which traces the block once
into a jitted JAX function. Here each op's registered lowering runs as soon
as it is reached, on the tensors of an environment (var name -> tensor) that
the Executor seeds with the persistable state and the feeds. There is no
tracing and no compile step; ops that write persistable vars rebind their
names in the environment, and the Executor commits those writes to the
Scope after the block has run.

Gradient ops: append_backward (backward.py) emits `<type>_grad` ops. One
with no lowering of its own runs `_lower_generic_grad`, the counterpart of
paddle_tpu/core/lowering.py:236-314: it re-runs the forward lowering on
the differentiated inputs under autograd and takes torch.autograd.grad
with the output cotangents. Where JAX's XLA folds the recomputed forward
into the original one, here it runs again: a grad op costs its forward
once more.

Pass-fused activations: a producer op carrying `fuse_act` (set by
passes/fuse_act.py) applies the activation's own registered lowering to
its `fuse_act_slot` output, as paddle_tpu/core/lowering.py:168-200 does,
so a fused program and the unfused one are bit-identical.

Freeing dead values: `run_block` takes a plan (`free_plan`), one tuple of
names for each op of the list it runs, and drops those names from the
environment right after that op. A name read after it was dropped fails
with the TraceError below, never silently; a grad op's cotangent is read
through `Interpreter.cotangent`, which tells a gradient no op wrote (a
zero cotangent) from one that was dropped (the TraceError).

Sub-blocks: `OpCtx.run_block` runs a sub-block on an environment of its
own (the reference's ctx.run_block, paddle_tpu/ops/control_ops.py:
125-165); `remat_segment` (ops/control_ops.py) runs its segment that
way, so the segment's interior values never reach the outer
environment.
"""
from __future__ import annotations

import torch

from . import config, registry


class TraceError(RuntimeError):
    pass


# odd 64-bit constants (splitmix64's) by which the step and the microbatch
# move an op's seed, far from the seeds of the other ops of the program
_STEP_MIX = 0xBF58476D1CE4E5B9
_MICRO_MIX = 0x94D049BB133111EB


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
        """A torch.Generator on the op's device for the op's random draws,
        seeded from (the program's seed root, the Executor's step of the
        program, the microbatch index under gradient merge, the op's own
        'seed' attr or its uid when that is 0): deterministic given those,
        and fresh at every step and microbatch, as the reference folds its
        per-step key (paddle_tpu/core/lowering.py:61-70, executor.py:281,
        :1116). The root is config.step_seed: the program's random_seed,
        or for 0 the fixed root 1234567, or the process's entropy under
        FLAGS_deterministic=0 (paddle_tpu/executor.py:331-337). At step 0
        outside gradient merge the seed is `root·0x9E3779B1 + op seed`, so
        a startup program draws the same initial values on every run. A
        grad op takes its forward op's seed, then its forward op's uid, as
        JAX's rule does, so a recomputed forward draws what the forward
        drew."""
        a = self.attrs
        op_seed = int(a.get('seed', 0) or a.get('_fwd_seed', 0) or
                      a.get('_fwd_op_uid', a.get('_op_uid', 0))) & 0x7FFFFFFF
        interp = self.interp
        micro = 0 if interp.micro is None else interp.micro + 1
        seed = (config.step_seed(interp.program) * 0x9E3779B1 + op_seed
                + interp.step * _STEP_MIX + micro * _MICRO_MIX
                ) & 0x7FFFFFFFFFFFFFFF
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def var(self, name):
        """Build-time Variable metadata (shape with -1s, dtype)."""
        return self.block._find_var_recursive(name)

    def run_block(self, block_idx, env, keep=()):
        """Run sub-block `block_idx` on `env` (a dict the caller owns and
        reads back), freeing each value after its last reader except the
        names in `keep`. Writes land in `env` only: the interpreter's own
        environment and its record of written names are untouched."""
        interp = self.interp
        sub = interp.program.block(block_idx)
        saved = interp.env, interp.written
        interp.env, interp.written = env, set()
        try:
            interp.run_block(sub, free=free_plan(
                interp.program, sub, sub.ops, set(keep), tuple(keep)))
        finally:
            interp.env, interp.written = saved
        return env


class _FusedActOp(object):
    """Shadow op handed to an activation lowering when it runs fused into
    its producer (fuse_act attr): the activation's original attrs, and
    the producer's uid as its own (paddle_tpu/core/lowering.py:86-98)."""

    __slots__ = ('type', 'attrs', 'inputs', 'outputs')

    def __init__(self, act_type, act_attrs, producer):
        self.type = act_type
        self.attrs = dict(act_attrs)
        self.attrs.setdefault('_op_uid', producer.attrs.get('_op_uid', 0))
        self.inputs = {}
        self.outputs = {}


_PLAN_CACHE = {}


def free_plan(program, block, ops, keep, tag):
    """The freeing plan of one run of `ops` (in order, of `block`): for
    each op, the names whose last read or write among `ops` is at that op,
    except those in `keep`. Reads and writes are passes/base.py's
    op_reads / op_writes, a sub-block's folded into its owning op: the
    def-use chains passes/dataflow.py builds its live intervals from.
    Cached per (program uid, build epoch, block, op count, tag), where
    `tag` names what decides `ops` and `keep`; a plan is a tuple of
    tuples, so threads share it."""
    key = (program._uid, program._build_epoch, block.idx, len(block.ops),
           tag)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        from ..passes.base import op_reads, op_writes
        last = {}
        for p, op in enumerate(ops):
            for n in op_reads(op, program) | op_writes(op, program):
                last[n] = p
        lists = [[] for _ in ops]
        for n, p in last.items():
            if n not in keep:
                lists[p].append(n)
        plan = tuple(tuple(sorted(x)) for x in lists)
        _PLAN_CACHE[key] = plan
    return plan


class Interpreter(object):
    """Walks a block in order, keeping env: var name -> tensor. `step` is
    the Executor's run count of the program and `micro` the microbatch
    index under gradient merge (None outside it); both seed OpCtx.rng."""

    def __init__(self, program, device, env, step=0, micro=None):
        self.program = program
        self.device = device
        self.env = env
        self.step = step
        self.micro = micro
        self.written = set()

    def read(self, name, op):
        if name in self.env:
            return self.env[name]
        raise TraceError(
            "Op %s reads variable %r which has no value. Feed it, initialize "
            "it via the startup program, or check op ordering." % (op, name))

    def cotangent(self, name, op):
        """The value of gradient var `name` for a grad op, or None where no
        op of this run wrote it (a zero cotangent). A name that was written
        and is gone was dropped by the freeing plan before this reader:
        that fails with read's TraceError, never as a zero gradient."""
        if not name or (name not in self.env and name not in self.written):
            return None
        return self.read(name, op)

    def run_block(self, block, ops=None, free=None):
        """Run `ops` (default: every op of the block) in order. `free`, when
        given, holds one tuple of names for each op run: they leave the
        environment right after it."""
        ops = block.ops if ops is None else ops
        if free is None:
            for op in ops:
                self.run_op(op, block)
            return self.env
        if len(free) != len(ops):
            raise TraceError("freeing plan covers %d ops, the run %d"
                             % (len(free), len(ops)))
        env = self.env
        for op, dead in zip(ops, free):
            self.run_op(op, block)
            for n in dead:
                env.pop(n, None)
        return self.env

    def run_op(self, op, block):
        t = op.type
        if t in ('feed', 'fetch'):
            # feeds are in env already; the Executor returns its
            # fetch_list, not what a program's own fetch ops name
            return
        d = registry.get(t)
        if d is None:
            fwd = registry.get(t[:-5]) if t.endswith('_grad') else None
            if fwd is None:
                raise TraceError("No lowering registered for op type %r (%s)"
                                 % (t, op))
            return self._lower_generic_grad(op, block, fwd)
        ins = {slot: [self.read(n, op) if n else None for n in names]
               for slot, names in op.inputs.items()}
        outs = d.lower(OpCtx(self, op, block), ins) or {}
        if op.attrs.get('fuse_act'):
            outs = self._apply_fused_act(op, block, outs)
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            for n, v in zip(names, vals):
                if n and v is not None:
                    self.env[n] = v
                    self.written.add(n)

    def _apply_fused_act(self, op, block, outs):
        """Apply a pass-fused activation (passes/fuse_act.py) to the
        producer's `fuse_act_slot` output: the activation's own registered
        lowering on the slot's value, so fused and unfused programs are
        bit-identical."""
        act = op.attrs['fuse_act']
        slot = op.attrs.get('fuse_act_slot', 'Out')
        d = registry.get(act)
        if d is None:
            raise TraceError(
                "op %s carries fuse_act=%r but no lowering is registered "
                "for that activation" % (op, act))
        vals = outs.get(slot)
        if not vals or vals[0] is None:
            raise TraceError(
                "op %s carries fuse_act=%r but produced no value in slot "
                "%r to activate" % (op, act, slot))
        shadow = _FusedActOp(act, op.attrs.get('fuse_act_attrs', {}), op)
        acted = d.lower(OpCtx(self, shadow, block), {'X': [vals[0]]})['Out'][0]
        outs = dict(outs)
        outs[slot] = [acted] + list(vals[1:])
        return outs

    # Generic autograd-derived gradient lowering. The grad op's attrs (see
    # backward.py): '_fwd_inputs' / '_fwd_outputs' {slot: [names]} of the
    # forward op, '_out_grad_map' {fwd output: grad var or ''},
    # '_in_grad_map' {fwd input: grad var or ''}.
    def _lower_generic_grad(self, op, block, fwd_def):
        a = op.attrs
        fwd_inputs, fwd_outputs = a['_fwd_inputs'], a['_fwd_outputs']
        out_grad_map, in_grad_map = a['_out_grad_map'], a['_in_grad_map']

        # names to differentiate with respect to (deduped, order-stable)
        diff_names = []
        for names in fwd_inputs.values():
            for n in names:
                if n and in_grad_map.get(n) and n not in diff_names:
                    diff_names.append(n)
        if not diff_names:
            return
        env = {n: self.read(n, op) for names in fwd_inputs.values()
               for n in names if n}

        with torch.enable_grad():
            leaves = [env[n].detach().requires_grad_() for n in diff_names]
            env.update(zip(diff_names, leaves))
            ins = {slot: [env[n] if n else None for n in names]
                   for slot, names in fwd_inputs.items()}
            outs = fwd_def.lower(OpCtx(self, op, block), ins) or {}
            primals, cots = [], []
            for slot, names in fwd_outputs.items():
                for n, p in zip(names, outs.get(slot) or ()):
                    g = self.cotangent(out_grad_map.get(n, '') if n else '',
                                       op)
                    if p is None or g is None or not p.requires_grad:
                        continue  # a zero cotangent adds nothing
                    g = g.to(p.dtype)
                    if g.shape != p.shape:
                        g = (g.reshape(p.shape) if g.numel() == p.numel()
                             else g.expand(p.shape))
                    primals.append(p)
                    cots.append(g)
            grads = (torch.autograd.grad(primals, leaves, cots,
                                         allow_unused=True)
                     if primals else [None] * len(leaves))

        for n, leaf, g in zip(diff_names, leaves, grads):
            self.env[in_grad_map[n]] = (torch.zeros_like(leaf) if g is None
                                        else g)
            self.written.add(in_grad_map[n])
