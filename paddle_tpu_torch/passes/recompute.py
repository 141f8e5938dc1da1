"""Activation rematerialization pass (the port's copy of
paddle_tpu/passes/recompute.py).

Sublinear-memory recompute in the Chen et al. 2016 style, the rewrite
the reference lineage shipped as RecomputeOptimizer: partition the
block-0 forward into contiguous segments, move each segment's ops into
a fresh sub-block, and splice a single ``remat_segment`` op over the
segment's boundary names:

    remat_segment: {X: [seg inputs]} -> {Out: [seg outputs]}  sub_block=k

The interpreter runs ``remat_segment``'s sub-block on an environment of
its own (ops/control_ops.py), so only the boundary values survive the
forward; when ``append_backward`` later differentiates the op through
the generic grad, the whole segment re-runs under autograd inside that
one grad op instead of its interior staying live from forward to
backward. Interior ops move VERBATIM — their ``_op_uid`` attrs (which
seed dropout et al., core/lowering.py OpCtx.rng) are untouched, so
recomputed stochastic ops replay bit-identical draws.

Segment boundaries come from either
  * explicit checkpoints — var names the user handed to
    ``append_backward(checkpoints=...)`` / ``minimize(checkpoints=...)``;
    each checkpoint's def site closes a segment, or
  * auto (√N) selection — K ≈ √M segments over each eligible run of M
    ops, each cut placed inside a ±M/2K window at the program point
    crossed by the fewest live temp bytes (dataflow live intervals).

The pass runs BEFORE backward only (it declines programs that already
contain grad/optimizer ops) and reports at the horizontal_fuse
standard: every ineligible op and rejected segment carries a reason
code, and ``report.details['segments']`` records the applied rewrite.

    from paddle_tpu_torch.passes.recompute import recompute_program
    prog, report = recompute_program(prog, checkpoints='auto',
                                     fetch_names=[loss.name])
    report.details['segments'][0]['interior_bytes']   # bytes freed
"""
from __future__ import annotations

import math
import os

from ..framework import Operator
from .base import Pass, PassManager, register_pass, sub_block_indices
from .dataflow import analyze_program, var_bytes

# -- reason codes (module-level constants: tests & tools key on these) ------
REASON_BACKWARD_PRESENT = 'backward-ops-present'    # program already has
                                                    # grad/optimizer ops
REASON_FEED_FETCH = 'feed-fetch-boundary'           # feed/fetch plumbing op
REASON_SUB_BLOCK = 'sub-block-op'                   # control flow: already
                                                    # owns a sub-block
REASON_UNREGISTERED = 'unregistered-op'             # no lowering rule
REASON_NO_GRAD_OP = 'no-grad-op'                    # metric/decode op: no
                                                    # backward, outputs are
                                                    # fetch targets
REASON_LOD_VAR = 'lod-boundary-var'                 # variable-length value
                                                    # at the op boundary
REASON_HOST_OP = 'host-callback-op'                 # py_func/reader: not
                                                    # replayable in-graph
REASON_SEGMENT_TOO_SMALL = 'segment-too-small'      # fewer ops than min_ops
REASON_SEGMENT_REBINDS = 'segment-rebinds-outer'    # segment rebinds an
                                                    # outer non-persistable
                                                    # name (stale replay
                                                    # hazard at grad time)
REASON_NO_INTERIOR = 'segment-saves-nothing'        # every written name
                                                    # escapes: recompute
                                                    # would free 0 bytes
REASON_CODES = (REASON_BACKWARD_PRESENT, REASON_FEED_FETCH,
                REASON_SUB_BLOCK, REASON_UNREGISTERED, REASON_NO_GRAD_OP,
                REASON_LOD_VAR, REASON_HOST_OP, REASON_SEGMENT_TOO_SMALL,
                REASON_SEGMENT_REBINDS, REASON_NO_INTERIOR)

# ops that punch through to the host or stream data: replaying them in a
# segment's grad would double side effects / reads
_HOST_TYPES = frozenset(('py_func', 'read', 'create_py_reader', 'print',
                         'save', 'load'))
_BOUNDARY_TYPES = frozenset(('feed', 'fetch'))

_OP_ROLE_BACKWARD = 1
_OP_ROLE_OPTIMIZE = 2


def _env_disabled():
    return os.environ.get('PTPU_REMAT', '') == '0'


def _checkpoint_names(checkpoints):
    """Normalize a checkpoints argument to a list of var names."""
    out = []
    for c in checkpoints:
        name = getattr(c, 'name', c)
        if not isinstance(name, str):
            raise TypeError(
                "checkpoints must be Variables or names, got %r" % (c,))
        out.append(name)
    return out


@register_pass
class RecomputePass(Pass):
    """Partition the block-0 forward into remat_segment sub-blocks.

    checkpoints: None/'auto' for √N auto-selection, or a list of var
    names/Variables whose def sites close segments (the reference
    RecomputeOptimizer contract).
    min_ops: smallest segment worth wrapping (a 1-op segment saves
    nothing and costs a checkpoint boundary).
    batch: the -1-dim substitution used when ranking auto cut points by
    crossing bytes (relative ordering is all that matters).
    """

    name = 'recompute'

    def __init__(self, checkpoints=None, min_ops=2, batch=32):
        if checkpoints is None or checkpoints == 'auto':
            self.checkpoints = None
        else:
            self.checkpoints = _checkpoint_names(checkpoints)
        self.min_ops = max(int(min_ops), 1)
        self.batch = max(int(batch), 1)

    # -- eligibility -----------------------------------------------------
    def _op_reason(self, op, program, lod_names):
        from ..core import registry
        if op.type in _BOUNDARY_TYPES:
            return REASON_FEED_FETCH
        if op.type in _HOST_TYPES:
            return REASON_HOST_OP
        if sub_block_indices(op):
            return REASON_SUB_BLOCK
        d = registry.get(op.type)
        if d is None:
            return REASON_UNREGISTERED
        if d.no_grad:
            return REASON_NO_GRAD_OP
        for n in op.input_arg_names() + op.output_arg_names():
            if n in lod_names:
                return REASON_LOD_VAR
        return None

    # -- segmentation ----------------------------------------------------
    def _explicit_cuts(self, dfa, start, end, cps):
        """Cut points inside [start, end]: each checkpoint's def sites
        close the segment containing them (cut AFTER the def)."""
        cuts = set()
        for name in cps:
            for d in dfa.defs.get(name, ()):
                if start <= d < end:
                    cuts.add(d + 1)
        return sorted(cuts)

    def _auto_cuts(self, dfa, start, end, sizes):
        """√N cuts over [start, end]: K ≈ √M segments, each boundary
        slid within ±M/2K to the point crossed by the fewest live temp
        bytes (don't carry a wide activation across a checkpoint when a
        narrow bottleneck sits one op over)."""
        m = end - start + 1
        k = max(1, int(round(math.sqrt(m))))
        if k <= 1:
            return []
        intervals = [(n, s, e) for n, (s, e) in dfa.live_intervals().items()
                     if n not in dfa.persistables and n not in dfa.inputs
                     and sizes.get(n)]

        def crossing(p):       # bytes live across the cut before op p
            return sum(sizes[n] for n, s, e in intervals if s < p <= e)

        window = max(1, m // (2 * k))
        cuts, lo = [], start + 1
        for i in range(1, k):
            target = start + int(round(i * m / float(k)))
            cands = [p for p in range(max(lo, target - window),
                                      min(end, target + window) + 1)]
            if not cands:
                continue
            best = min(cands, key=lambda p: (crossing(p), abs(p - target)))
            cuts.append(best)
            lo = best + 1
        return cuts

    # -- boundary computation --------------------------------------------
    def _segment_io(self, dfa, ops, start, end, live_out):
        """(B_in, B_out, interior_bytes, boundary_bytes, rebinds) of the
        segment ops[start..end]. B_in: names read before any segment-
        internal write. B_out: segment writes read after the segment,
        persistable, or in the live-out set. rebinds: outer-defined
        non-persistable names the segment overwrites (decline those —
        the grad-time replay would read the post-segment binding)."""
        written = set()
        b_in, b_out, rebinds = [], [], []
        sizes = self._sizes_cache
        for i in range(start, end + 1):
            op = ops[i]
            for n in op.input_arg_names():
                if n and n not in written and n not in b_in:
                    b_in.append(n)
            for n in op.output_arg_names():
                if not n:
                    continue
                if n not in written:
                    outer_def = any(d < start for d in dfa.defs.get(n, ()))
                    if (outer_def or n in dfa.inputs) \
                            and n not in dfa.persistables:
                        rebinds.append(n)
                written.add(n)
        for i in range(start, end + 1):
            for n in ops[i].output_arg_names():
                if not n or n in b_out:
                    continue
                reads_after = any(u > end for u in dfa.uses.get(n, ()))
                if reads_after or n in dfa.persistables or n in live_out:
                    b_out.append(n)
        interior = sum(sizes.get(n, 0) for n in written
                       if n not in b_out and n not in dfa.persistables)
        boundary = sum(sizes.get(n, 0) for n in b_out)
        return b_in, b_out, interior, boundary, rebinds

    # -- main ------------------------------------------------------------
    def run_on_program(self, program, ctx, report):
        report.details.update({
            'mode': 'explicit' if self.checkpoints is not None else 'auto',
            'checkpoints': list(self.checkpoints or ()),
            'segments': [], 'skipped': [], 'skip_reasons': {},
            'declined': None,
        })
        if _env_disabled():
            report.details['disabled'] = True
            return

        block = program.global_block()
        ops = list(block.ops)
        skipped = report.details['skipped']
        reasons = report.details['skip_reasons']

        def skip(idx, kind, reason):
            skipped.append({'op_index': idx, 'block': 0, 'type': kind,
                            'reason': reason})
            reasons[reason] = reasons.get(reason, 0) + 1

        for i, op in enumerate(ops):
            role = int(op.attrs.get('op_role', 0) or 0)
            if role & (_OP_ROLE_BACKWARD | _OP_ROLE_OPTIMIZE):
                report.details['declined'] = REASON_BACKWARD_PRESENT
                skip(i, op.type, REASON_BACKWARD_PRESENT)
                return

        dfa = analyze_program(program, feed_names=ctx.feed_names,
                              fetch_names=ctx.fetch_names)
        sizes = {}
        for name, v in dfa.vars.items():
            sizes[name], _ = var_bytes(v, self.batch)
        self._sizes_cache = sizes
        lod_names = {n for n, v in dfa.vars.items()
                     if getattr(v, 'lod_level', 0)}
        live_out = set(ctx.fetch_names or ()) | set(ctx.preserve or ())

        if self.checkpoints is not None:
            known = set(dfa.defs) | set(dfa.vars)
            unknown = [n for n in self.checkpoints if n not in known]
            if unknown:
                raise ValueError(
                    "recompute checkpoints name vars the program never "
                    "defines: %s" % ', '.join(sorted(unknown)))

        # eligible runs: maximal contiguous stretches of wrappable ops
        runs, cur = [], None
        for i, op in enumerate(ops):
            reason = self._op_reason(op, program, lod_names)
            if reason is None:
                cur = [i, i] if cur is None else [cur[0], i]
            else:
                skip(i, op.type, reason)
                if cur is not None:
                    runs.append(tuple(cur))
                    cur = None
        if cur is not None:
            runs.append(tuple(cur))

        # candidate segments per run
        candidates = []
        for (rs, re_) in runs:
            if self.checkpoints is not None:
                cuts = self._explicit_cuts(dfa, rs, re_, self.checkpoints)
                if not cuts and not any(
                        rs <= d <= re_ for n in self.checkpoints
                        for d in dfa.defs.get(n, ())):
                    # run holds no checkpoint at all: leave it alone
                    # (explicit mode only wraps around named boundaries)
                    continue
            else:
                cuts = self._auto_cuts(dfa, rs, re_, sizes)
            bounds = [rs] + cuts + [re_ + 1]
            for s, e in zip(bounds, bounds[1:]):
                if s < e:
                    candidates.append((s, e - 1))

        accepted = []
        for (s, e) in candidates:
            if e - s + 1 < self.min_ops:
                skip(s, 'segment[%d:%d]' % (s, e), REASON_SEGMENT_TOO_SMALL)
                continue
            b_in, b_out, interior, boundary, rebinds = \
                self._segment_io(dfa, ops, s, e, live_out)
            if rebinds:
                skip(s, 'segment[%d:%d]' % (s, e), REASON_SEGMENT_REBINDS)
                continue
            if not b_out or not interior:
                skip(s, 'segment[%d:%d]' % (s, e), REASON_NO_INTERIOR)
                continue
            accepted.append((s, e, b_in, b_out, interior, boundary))

        if not accepted:
            return

        # rewrite: move each segment into a sub-block, splice remat ops
        new_ops, pos = [], 0
        for (s, e, b_in, b_out, interior, boundary) in accepted:
            new_ops.extend(ops[pos:s])
            sub = program._create_block(parent_idx=0)
            program._rollback()
            for op in ops[s:e + 1]:
                op.block = sub
                sub.ops.append(op)
            remat = Operator(block, 'remat_segment',
                             inputs={'X': list(b_in)},
                             outputs={'Out': list(b_out)},
                             attrs={'sub_block': sub.idx, 'op_role': 0})
            new_ops.append(remat)
            pos = e + 1
            report.details['segments'].append({
                'sub_block': sub.idx, 'start': s, 'end': e,
                'n_ops': e - s + 1, 'inputs': list(b_in),
                'outputs': list(b_out), 'interior_bytes': int(interior),
                'boundary_bytes': int(boundary),
            })
        new_ops.extend(ops[pos:])
        block.ops = new_ops
        del self._sizes_cache


def recompute_program(program, checkpoints=None, fetch_names=None,
                      feed_names=None, preserve=(), min_ops=2, batch=32,
                      inplace=False):
    """One-call wrapper: returns (program, PassReport). checkpoints is
    None/'auto' for √N auto-selection or a list of names/Variables."""
    p = RecomputePass(checkpoints=checkpoints, min_ops=min_ops, batch=batch)
    prog, reports = PassManager([p]).apply(
        program, fetch_names=fetch_names, feed_names=feed_names,
        preserve=preserve, inplace=inplace)
    return prog, reports[0]


def apply_recompute_for_backward(program, loss, checkpoints):
    """append_backward's entry: rewrite `program` in place around the
    user's checkpoints (or 'auto') before grad ops are emitted. The
    applied report is stored as program._recompute_report; a checkpoints
    request that applies zero segments warns loudly (it is NOT a silent
    no-op: the report says exactly why each segment was rejected)."""
    fetch = [loss.name] + list(getattr(program, '_fetch_names', ()) or ())
    _, report = recompute_program(program, checkpoints=checkpoints,
                                  fetch_names=fetch, inplace=True)
    program._recompute_report = report
    if not report.details['segments'] \
            and not report.details.get('disabled'):
        import warnings
        warnings.warn(
            "append_backward(checkpoints=...) applied 0 recompute "
            "segments: %s" % (report.details['skip_reasons'] or
                              report.details['declined'],),
            stacklevel=3)
    return report
