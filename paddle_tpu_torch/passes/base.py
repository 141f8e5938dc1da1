"""Pass framework over Program/Block — the Fluid IR-pass layer (the
port's copy of paddle_tpu/passes/base.py).

The reference rewrites graphs through `paddle/fluid/framework/ir/`
(pass.h:42 Pass::Apply, pass registry via REGISTER_PASS, and
build_strategy.cc assembling ordered pipelines). Here the Program IS the
IR (framework.py), so a Pass mutates a Program in place and the
PassManager owns cloning, ordering, and per-pass accounting:

    new_prog, reports = PassManager(['constant_fold',
                                     'dead_op_elimination']).apply(prog)

Each report records exactly which ops/vars the pass added and removed
(computed by identity diff, so a pass that splices a literal over a
computed op counts as one removed + one added, not zero).
"""
from __future__ import annotations


class PassContext(object):
    """Per-apply() context handed to every pass in the pipeline.

    fetch_names / feed_names: the run boundary, when the caller knows it
    (executor fetch list, predictor signature). None means unknown —
    passes must then stay conservative (dead_op_elimination keeps every
    terminal var a user could still fetch).
    preserve: extra var names a pass must not remove (the reference's
    memory_optimize skip_opt_set).
    """

    def __init__(self, fetch_names=None, feed_names=None, preserve=None):
        self.fetch_names = list(fetch_names) if fetch_names is not None \
            else None
        self.feed_names = list(feed_names) if feed_names is not None else None
        self.preserve = set(preserve or ())


class PassReport(object):
    """What one pass did to one program (ref: the per-pass VLOG counters
    in framework/ir/graph_pattern_detector.cc, made structured)."""

    __slots__ = ('name', 'ops_before', 'ops_after', 'ops_added',
                 'ops_removed', 'vars_added', 'vars_removed', 'details',
                 'diagnostics')

    def __init__(self, name):
        self.name = name
        self.ops_before = 0
        self.ops_after = 0
        self.ops_added = 0
        self.ops_removed = 0
        self.vars_added = 0
        self.vars_removed = 0
        self.details = {}      # pass-specific counters/notes
        self.diagnostics = []  # verifier.Diagnostic entries

    def as_dict(self):
        return {'pass': self.name,
                'ops': {'before': self.ops_before, 'after': self.ops_after,
                        'added': self.ops_added, 'removed': self.ops_removed},
                'vars': {'added': self.vars_added,
                         'removed': self.vars_removed},
                'details': dict(self.details),
                'diagnostics': [d.as_dict() for d in self.diagnostics]}

    def __repr__(self):
        extra = ''
        if self.diagnostics:
            errs = sum(1 for d in self.diagnostics if d.level == 'error')
            extra = ', %d diagnostics (%d errors)' % (len(self.diagnostics),
                                                      errs)
        return ("PassReport(%s: ops %d->%d (+%d/-%d), vars +%d/-%d%s)" %
                (self.name, self.ops_before, self.ops_after, self.ops_added,
                 self.ops_removed, self.vars_added, self.vars_removed, extra))


class Pass(object):
    """Base class: subclass, set `name`, implement run_on_program.

    run_on_program mutates `program` in place; the PassManager handles
    cloning and fills the report's op/var counters afterwards, so a pass
    only records pass-specific numbers in report.details.
    """

    name = None

    def run_on_program(self, program, ctx, report):
        raise NotImplementedError

    def __repr__(self):
        return "<Pass %s>" % (self.name,)


# ---------------------------------------------------------------------------
# registry (ref: framework/ir/pass.h REGISTER_PASS / PassRegistry::Get)
# ---------------------------------------------------------------------------
_PASS_REGISTRY = {}


def register_pass(cls):
    """Class decorator: register a Pass subclass under its `name`."""
    if not getattr(cls, 'name', None):
        raise ValueError("pass class %r must set a `name`" % (cls,))
    _PASS_REGISTRY[cls.name] = cls
    return cls


def get_pass_class(name):
    cls = _PASS_REGISTRY.get(name)
    if cls is None:
        raise KeyError("no pass registered under %r (have: %s)"
                       % (name, ', '.join(registered_passes())))
    return cls


def create_pass(name, **kwargs):
    return get_pass_class(name)(**kwargs)


def registered_passes():
    return sorted(_PASS_REGISTRY)


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------
def _count_ops(program):
    return sum(len(b.ops) for b in program.blocks)


def _op_ids(program):
    return {id(op) for b in program.blocks for op in b.ops}


def _var_keys(program):
    return {(b.idx, n) for b in program.blocks for n in b.vars}


# Program metadata set outside __init__ that clones must inherit: the
# executor reads these off whatever program object it is handed.
_DYNAMIC_PROGRAM_ATTRS = ('_py_readers', '_amp_bf16', '_grad_accum_k',
                          '_feed_names', '_fetch_names')


def _clone_with_metadata(program):
    clone = program.clone()
    for k in _DYNAMIC_PROGRAM_ATTRS:
        if hasattr(program, k) and not hasattr(clone, k):
            setattr(clone, k, getattr(program, k))
    return clone


class PassManager(object):
    """Ordered pipeline runner: resolves names through the registry,
    applies each pass, and returns (program, [PassReport])."""

    def __init__(self, pipeline=None):
        self.passes = []
        for p in (pipeline or ()):
            if isinstance(p, str):
                p = create_pass(p)
            if not isinstance(p, Pass):
                raise TypeError("pipeline entries must be pass names or "
                                "Pass instances, got %r" % (p,))
            self.passes.append(p)

    def pipeline_names(self):
        return [p.name for p in self.passes]

    def apply(self, program, fetch_names=None, feed_names=None,
              preserve=None, inplace=False):
        """Run the pipeline. Returns (new_program, reports); inplace=True
        mutates `program` itself (reference-transpiler semantics) and
        returns it."""
        ctx = PassContext(fetch_names=fetch_names, feed_names=feed_names,
                          preserve=preserve)
        prog = program if inplace else _clone_with_metadata(program)
        reports = []
        for p in self.passes:
            report = PassReport(p.name)
            report.ops_before = _count_ops(prog)
            ids0, vars0 = _op_ids(prog), _var_keys(prog)
            p.run_on_program(prog, ctx, report)
            report.ops_after = _count_ops(prog)
            ids1, vars1 = _op_ids(prog), _var_keys(prog)
            report.ops_added = len(ids1 - ids0)
            report.ops_removed = len(ids0 - ids1)
            report.vars_added = len(vars1 - vars0)
            report.vars_removed = len(vars0 - vars1)
            reports.append(report)
        # structural mutation: the Executor's verify and freeing-plan
        # caches must not replay
        prog._build_epoch += 1
        return prog, reports


# ---------------------------------------------------------------------------
# shared graph-walk helpers (sub-block-aware read/write sets)
# ---------------------------------------------------------------------------
_SUB_BLOCK_ATTRS = ('sub_block', 'sub_block_false')


def sub_block_indices(op):
    out = []
    for key in _SUB_BLOCK_ATTRS:
        idx = op.attrs.get(key)
        if isinstance(idx, int) and not isinstance(idx, bool):
            out.append(idx)
    return out


def op_reads(op, program, _seen=None):
    """All var names an op may read: declared inputs plus the closure
    reads of its sub-blocks (control-flow bodies read outer vars that are
    NOT listed in op.inputs — the interpreter resolves them from env)."""
    names = set(n for n in op.input_arg_names() if n)
    for idx in sub_block_indices(op):
        if idx < 0 or idx >= len(program.blocks):
            continue  # dangling ref: the verifier reports it
        _seen = _seen or set()
        if idx in _seen:
            continue
        _seen.add(idx)
        for sop in program.block(idx).ops:
            names |= op_reads(sop, program, _seen)
    return names


def op_writes(op, program, _seen=None):
    """All var names an op may write, transitively through sub-blocks
    (a while carry commits sub-block writes back to the outer env)."""
    names = set(n for n in op.output_arg_names() if n)
    for idx in sub_block_indices(op):
        if idx < 0 or idx >= len(program.blocks):
            continue
        _seen = _seen or set()
        if idx in _seen:
            continue
        _seen.add(idx)
        for sop in program.block(idx).ops:
            names |= op_writes(sop, program, _seen)
    return names
