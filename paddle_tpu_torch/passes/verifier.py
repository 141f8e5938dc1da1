"""verify_program: static-analysis lint over a Program (the port's copy
of paddle_tpu/passes/verifier.py).

The reference validates OpDescs at op-creation time (framework.py
Operator.__init__ checks against OpProto) and again in C++ at run time;
a malformed program would otherwise surface as a TraceError in the
middle of a run (core/lowering.py). This pass walks every block BEFORE
the interpreter runs it and emits structured diagnostics:

  error  — the interpreter/registry will reject this program (undefined
           inputs, use-before-def, unregistered op, dangling sub-block,
           unreachable fetch target, invalid dtype attr)
  warn   — suspicious but runnable (outputs nothing consumes, declared
           shape/dtype disagreeing with what the op registry infers)

Levels: 'fast' runs the structural checks only (the Executor runs this
per program epoch before a run); 'full' adds the
registry-backed shape/dtype consistency sweep (the lint CLI and the
optimization pipelines use this).
"""
from __future__ import annotations

from ..core import registry
from ..framework import convert_dtype
from .base import (Pass, register_pass, op_reads, op_writes,
                   sub_block_indices, _SUB_BLOCK_ATTRS)


class ProgramVerifyError(RuntimeError):
    """Raised under strict verification (PTPU_STRICT_VERIFY=1) when the
    verifier finds error-level diagnostics."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        errs = [d for d in self.diagnostics if d.level == 'error']
        lines = '\n'.join('  ' + str(d) for d in errs[:20])
        more = '' if len(errs) <= 20 else '\n  ... and %d more' % (
            len(errs) - 20)
        super().__init__(
            "program failed verification with %d error(s):\n%s%s\n"
            "(set PTPU_STRICT_VERIFY=0 to downgrade to warnings)"
            % (len(errs), lines, more))


class Diagnostic(object):
    """One verifier finding, anchored to (block id, op index)."""

    __slots__ = ('level', 'code', 'message', 'block', 'op_index', 'var')

    def __init__(self, level, code, message, block=0, op_index=-1, var=None):
        self.level = level        # 'error' | 'warn'
        self.code = code          # stable kebab-case class
        self.message = message
        self.block = block
        self.op_index = op_index  # -1: not tied to one op
        self.var = var

    def as_dict(self):
        return {'level': self.level, 'code': self.code,
                'message': self.message, 'block': self.block,
                'op_index': self.op_index, 'var': self.var}

    def __repr__(self):
        at = 'block %d' % self.block
        if self.op_index >= 0:
            at += ' op %d' % self.op_index
        return "[%s] %s (%s): %s" % (self.level, self.code, at, self.message)


# op types the interpreter handles without a registry entry
_TRACER_BUILTIN_OPS = ('feed', 'fetch')


def _registered(op_type):
    if op_type in _TRACER_BUILTIN_OPS:
        return True
    return registry.is_registered(op_type)


def _initially_defined(program, feed_names):
    """Names the executor seeds into env before any op runs: explicit
    feeds, data vars, scope-present persistables, feed-op outputs, and
    non-tensor var kinds (readers/tensor arrays) that ops materialize
    lazily."""
    defined = set(feed_names or ())
    for v in program.list_vars():
        if v.persistable or getattr(v, 'is_data', False):
            defined.add(v.name)
        if getattr(v, 'type', 'lod_tensor') != 'lod_tensor':
            defined.add(v.name)
    for op in program.global_block().ops:
        if op.type == 'feed':
            defined.update(op.output_arg_names())
    return defined


def verify_program(program, feed_names=None, fetch_names=None, level='full'):
    """Lint `program`; returns a list of Diagnostic (possibly empty).

    feed_names/fetch_names: the run boundary when known. Defaults come
    from the program itself (feed ops / data vars; fetch ops /
    `_fetch_names` recorded by save_inference_model).
    """
    if level not in ('fast', 'full'):
        raise ValueError("level must be 'fast' or 'full', got %r" % (level,))
    diags = []
    feed_names = list(feed_names if feed_names is not None
                      else getattr(program, '_feed_names', ()) or ())
    fetch_names = list(fetch_names if fetch_names is not None
                       else getattr(program, '_fetch_names', ()) or ())

    defined0 = _initially_defined(program, feed_names)

    # ordered recursive walk from block 0: sub-blocks verify against the
    # names defined at their owning op's position plus the bindings the
    # control op itself creates (rnn inner slots); orphan blocks nothing
    # references fall back to the unordered declared-somewhere check
    visited = set()
    _verify_block(program, program.global_block(), set(defined0), diags,
                  visited)
    for block in program.blocks:
        if block.idx not in visited:
            _verify_block(program, block, set(defined0), diags, visited,
                          ordered=False)

    if level == 'full':
        for block in program.blocks:
            _check_registry_consistency(program, block, diags)
        _warn_dead_outputs(program, program.global_block(), diags,
                           fetch_names)
        _check_rebind_and_dead_persistables(program, diags, feed_names,
                                            fetch_names)

    # fetch reachability: every fetch target must be produced by some op,
    # fed, or live in the scope (persistable)
    produced = set(defined0)
    for op in program.global_block().ops:
        produced |= op_writes(op, program)
    fetch_targets = list(fetch_names)
    for i, op in enumerate(program.global_block().ops):
        if op.type == 'fetch':
            fetch_targets.extend(op.input_arg_names())
    for name in fetch_targets:
        if name and name not in produced:
            diags.append(Diagnostic(
                'error', 'unreachable-fetch',
                "fetch target %r is produced by no op, never fed, and not "
                "persistable" % name, block=0, var=name))
    return diags


# inner sub-block names a control op binds into its body's env before
# any body op runs (ops/control_ops.py): rnn step-input/static-input
# slots and memory `pre` vars — each attr entry carries the inner name
# at index 1
_SUB_BLOCK_BINDING_ATTRS = ('rnn_step_inputs', 'rnn_static_inputs',
                            'rnn_memories')


def _op_sub_bindings(op):
    names = set()
    for key in _SUB_BLOCK_BINDING_ATTRS:
        for entry in op.attrs.get(key, ()) or ():
            try:
                if entry[1]:
                    names.add(entry[1])
            except (TypeError, IndexError):
                continue
    return names


def _verify_block(program, block, defined, diags, visited, ordered=True):
    """Order-exact use-before-def walk, recursive through sub-blocks.

    The interpreter runs every body against its own env at the owning
    op's position (while carries live in the outer env by construction;
    rnn inner slots are bound by the op — _op_sub_bindings), so a
    sub-block read of a name with neither an incoming binding nor an
    earlier in-block write fails the run on the first iteration:
    order-exact checking inside sub-blocks is sound, not conservative.
    `defined` is mutated (callers pass a copy per scope)."""
    visited.add(block.idx)

    for i, op in enumerate(block.ops):
        if not _registered(op.type):
            diags.append(Diagnostic(
                'error', 'unregistered-op',
                "op type %r has no registered lowering" % op.type,
                block=block.idx, op_index=i))

        # dtype attrs must canonicalize
        for attr in ('dtype', 'in_dtype', 'out_dtype'):
            if op.has_attr(attr) and op.attrs[attr] not in (None, -1):
                try:
                    convert_dtype(op.attrs[attr])
                except Exception:
                    diags.append(Diagnostic(
                        'error', 'bad-dtype',
                        "op %r attr %s=%r is not a valid dtype"
                        % (op.type, attr, op.attrs[attr]),
                        block=block.idx, op_index=i))

        # sub-block references must point at a real, distinct block
        for key in _SUB_BLOCK_ATTRS:
            idx = op.attrs.get(key)
            if idx is None:
                continue
            if (not isinstance(idx, int) or isinstance(idx, bool)
                    or idx <= 0 or idx >= len(program.blocks)
                    or idx == block.idx):
                diags.append(Diagnostic(
                    'error', 'dangling-sub-block',
                    "op %r attr %s=%r does not reference a valid "
                    "sub-block (program has %d blocks)"
                    % (op.type, key, idx, len(program.blocks)),
                    block=block.idx, op_index=i))

        for name in op.input_arg_names():
            if not name:
                continue
            if block._find_var_recursive(name) is None:
                diags.append(Diagnostic(
                    'error', 'undefined-input',
                    "op %r reads %r which is declared in no block"
                    % (op.type, name), block=block.idx, op_index=i,
                    var=name))
            elif ordered and name not in defined:
                where = '' if block.idx == 0 else \
                    ' inside sub-block %d' % block.idx
                diags.append(Diagnostic(
                    'error', 'use-before-def',
                    "op %r reads %r before any op produces it%s (not "
                    "fed, not persistable, not bound by the owning "
                    "control op — check op ordering)"
                    % (op.type, name, where), block=block.idx,
                    op_index=i, var=name))

        # recurse into bodies with the names defined AT THIS POINT plus
        # the op's own inner bindings — the env the interpreter hands them
        for idx in sub_block_indices(op):
            if 0 < idx < len(program.blocks) and idx != block.idx \
                    and idx not in visited:
                _verify_block(program, program.block(idx),
                              defined | _op_sub_bindings(op), diags,
                              visited, ordered=ordered)
        defined |= op_writes(op, program)


# ---------------------------------------------------------------------------
# full-level checks
# ---------------------------------------------------------------------------
def _check_registry_consistency(program, block, diags):
    """Re-infer each op's output shapes/dtypes through the registry (its
    lowering run on 'meta' tensors, as the build-time shape inference in
    core/registry.py does, where the reference calls jax.eval_shape) and
    compare against the DECLARED vars — a corrupted attr (fill_constant
    shape edited after append, dtype rewritten) shows up as a
    mismatch."""
    import torch
    from ..core import amp
    from ..core.registry import (get, ShapeCtx, META, _probe_shape,
                                 _unprobe_dim)
    from ..framework import to_torch_dtype

    for i, op in enumerate(block.ops):
        d = get(op.type)
        if d is None or d.infer_shape is not None or d.lower is None:
            continue  # custom/absent inference: trust the op
        if op.type.endswith('_grad') or op.attrs.get('fuse_act'):
            continue
        had_probe = False
        ins = {}
        ok = True
        for slot, names in op.inputs.items():
            vals = []
            for n in names:
                if not n:
                    vals.append(None)
                    continue
                v = block._find_var_recursive(n)
                if v is None or v.shape is None:
                    ok = False
                    break
                if any(s in (-1, None) for s in v.shape):
                    had_probe = True
                try:
                    vals.append(torch.empty(_probe_shape(v.shape),
                                            dtype=to_torch_dtype(v.dtype),
                                            device=META))
                except Exception:
                    ok = False
                    break
            if not ok:
                break
            ins[slot] = vals
        if not ok:
            continue
        ctx = ShapeCtx(op, block)
        try:
            with amp.scope(False):
                outs = d.lower(ctx, ins) or {}
        except Exception:
            continue  # lowering needs concrete values; nothing to check
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            for n, t in zip(names, vals):
                if not n or t is None:
                    continue
                v = block._find_var_recursive(n)
                if v is None or v.shape is None:
                    continue
                inferred = tuple(_unprobe_dim(s, had_probe)
                                 for s in t.shape)
                declared = tuple(v.shape)
                if len(inferred) != len(declared) or any(
                        dd not in (-1, None) and di not in (-1, None)
                        and dd != di
                        for dd, di in zip(declared, inferred)):
                    diags.append(Diagnostic(
                        'warn', 'shape-mismatch',
                        "op %r output %r declared shape %s but the "
                        "registry infers %s"
                        % (op.type, n, declared, inferred),
                        block=block.idx, op_index=i, var=n))
                    continue
                inferred_dt = convert_dtype(t.dtype)
                if v.dtype and inferred_dt != convert_dtype(v.dtype) \
                        and convert_dtype(v.dtype) not in (
                            'int64', 'float64'):  # 32-bit carrier dtypes
                    diags.append(Diagnostic(
                        'warn', 'dtype-mismatch',
                        "op %r output %r declared dtype %s but the "
                        "registry infers %s"
                        % (op.type, n, v.dtype, inferred_dt),
                        block=block.idx, op_index=i, var=n))


def _warn_dead_outputs(program, block, diags, fetch_names=()):
    """Outputs nothing consumes (not fetched, not persistable): often a
    built-but-forgotten metric branch. Warn-level — the executor prunes
    them with dead_op_elimination."""
    if block.idx != 0:
        return
    consumed = set(fetch_names or ())
    consumed |= set(getattr(program, '_fetch_names', ()) or ())
    for b in program.blocks:
        for op in b.ops:
            consumed |= set(n for n in op.input_arg_names() if n)
    for i, op in enumerate(block.ops):
        if op.type in ('feed', 'fetch'):
            continue
        outs = [n for n in op.output_arg_names() if n]
        if not outs:
            continue
        dead = []
        for n in outs:
            v = block._find_var_recursive(n)
            if v is not None and (v.persistable
                                  or getattr(v, 'is_data', False)):
                break
            if n in consumed:
                break
            dead.append(n)
        else:
            if dead:
                diags.append(Diagnostic(
                    'warn', 'dead-output',
                    "op %r outputs %s are consumed by nothing (not "
                    "fetched, not persistable)" % (op.type, dead),
                    block=block.idx, op_index=i, var=dead[0]))


def _check_rebind_and_dead_persistables(program, diags, feed_names=(),
                                        fetch_names=()):
    """Program-level full checks riding the dataflow engine:

    double-write — two ops bind one name with no read of the first
    binding in between (the first write is dead; usually a forgotten
    rename). Warn: the interpreter's rebinding semantics run it fine.

    dead-persistable — a persistable var no op reads or writes and
    nothing fetches: it costs scope memory and checkpoint bytes every
    step for nothing (often a pruned branch's orphaned parameter).
    """
    from .dataflow import DataflowAnalysis
    dfa = DataflowAnalysis(program, feed_names=feed_names,
                           fetch_names=fetch_names)
    for hz in dfa.hazards():
        if hz.code == 'double-write':
            diags.append(Diagnostic('warn', 'double-write', hz.message,
                                    block=0, op_index=hz.op_index,
                                    var=hz.var))
    keep = set(fetch_names or ()) | set(feed_names or ())
    for name in sorted(dfa.persistables):
        if name in dfa.written or name in dfa.uses or name in keep:
            continue
        diags.append(Diagnostic(
            'warn', 'dead-persistable',
            "persistable %r is read and written by no op and never "
            "fetched — it spends scope/checkpoint bytes for nothing"
            % name, block=0, var=name))


@register_pass
class VerifyProgramPass(Pass):
    """Pipeline wrapper: runs verify_program and stores the diagnostics
    in the report; error-level findings raise under PTPU_STRICT_VERIFY=1
    and warn otherwise (the fail-loudly-at-build-time contract)."""

    name = 'verify_program'

    def __init__(self, level='full'):
        self.level = level

    def run_on_program(self, program, ctx, report):
        diags = verify_program(program, feed_names=ctx.feed_names,
                               fetch_names=ctx.fetch_names,
                               level=self.level)
        report.diagnostics.extend(diags)
        report.details['errors'] = sum(1 for d in diags
                                       if d.level == 'error')
        report.details['warnings'] = sum(1 for d in diags
                                         if d.level == 'warn')
        maybe_raise_or_warn(diags)


def strict_verify_enabled():
    import os
    return os.environ.get('PTPU_STRICT_VERIFY', '') == '1'


def maybe_raise_or_warn(diags, warned_key=None, _warned=set()):
    """Shared error policy: strict env raises ProgramVerifyError; default
    emits ONE RuntimeWarning per warned_key (None: always warn)."""
    errs = [d for d in diags if d.level == 'error']
    if not errs:
        return
    if strict_verify_enabled():
        raise ProgramVerifyError(diags)
    if warned_key is not None:
        if warned_key in _warned:
            return
        _warned.add(warned_key)
    import warnings
    head = '; '.join(str(d) for d in errs[:3])
    more = '' if len(errs) <= 3 else ' (+%d more)' % (len(errs) - 3)
    warnings.warn(
        "program verification found %d error(s): %s%s — the run will "
        "likely fail; set PTPU_STRICT_VERIFY=1 to raise at build time"
        % (len(errs), head, more), RuntimeWarning, stacklevel=3)
