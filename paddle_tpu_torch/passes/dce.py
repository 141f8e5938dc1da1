"""dead_op_elimination: backward liveness from fetch targets + persistables
(the port's copy of paddle_tpu/passes/dce.py).

The reference prunes through framework/prune.cc (save_inference_model) and
reuses buffers via memory_optimization_transpiler; here the payoff is a
shorter op list: ops whose outputs can never reach a fetch target or a
persistable write are dropped before the interpreter walks the block (an
unfetched metric branch costs a launch per op at every run).

Liveness is sub-block-aware in both directions: a live control-flow op
keeps every outer var its body reads (closure reads are not listed in
op.inputs), and counts its body's writes as its own (a while carry commits
them to the outer env).

Root selection:
  * fetch targets known (executor/predictor/export): roots = fetches +
    persistables (+ ctx.preserve). Real pruning.
  * unknown (bare memory_optimize on a program with no fetch ops): roots
    additionally include every terminal var a user could still fetch —
    conservative by design; only vars feeding literally nothing die.
"""
from __future__ import annotations

from .base import Pass, register_pass, op_reads, op_writes, sub_block_indices

# ops kept regardless of liveness (host side effects)
_SIDE_EFFECT_OPS = ('print',)


@register_pass
class DeadOpEliminationPass(Pass):
    """keep_persistable_writers=False + feed_fetch='drop' reproduces
    io.prune_program (inference export) semantics; the defaults are the
    training-safe optimization-pipeline mode."""

    name = 'dead_op_elimination'

    def __init__(self, keep_persistable_writers=True, feed_fetch='keep',
                 prune_vars=True):
        if feed_fetch not in ('keep', 'drop'):
            raise ValueError("feed_fetch must be 'keep' or 'drop'")
        self.keep_persistable_writers = keep_persistable_writers
        self.feed_fetch = feed_fetch
        self.prune_vars = prune_vars

    # ------------------------------------------------------------------
    def _roots(self, program, ctx):
        roots = set(ctx.preserve)
        explicit_fetches = ctx.fetch_names is not None
        if explicit_fetches:
            roots |= set(ctx.fetch_names)
        block = program.global_block()
        for op in block.ops:
            if op.type == 'fetch':
                explicit_fetches = True
                roots |= set(n for n in op.input_arg_names() if n)
        fetch_attr = getattr(program, '_fetch_names', None)
        if fetch_attr:
            explicit_fetches = True
            roots |= set(fetch_attr)
        if self.keep_persistable_writers:
            roots |= {v.name for v in program.list_vars() if v.persistable}
        if not explicit_fetches:
            # no fetch info: any terminal var is a potential fetch target
            consumed = set()
            for b in program.blocks:
                for op in b.ops:
                    consumed |= set(n for n in op.input_arg_names() if n)
            for op in block.ops:
                roots |= {n for n in op.output_arg_names()
                          if n and n not in consumed}
        return roots

    def run_on_program(self, program, ctx, report):
        block = program.global_block()
        live = self._roots(program, ctx)
        keep = []
        removed_types = {}
        for op in reversed(block.ops):
            if op.type in ('feed', 'fetch'):
                if self.feed_fetch == 'keep':
                    keep.append(op)
                    if op.type == 'fetch':
                        live |= set(n for n in op.input_arg_names() if n)
                continue
            writes = op_writes(op, program)
            if (op.type in _SIDE_EFFECT_OPS or writes & live):
                keep.append(op)
                live |= op_reads(op, program)
            else:
                removed_types[op.type] = removed_types.get(op.type, 0) + 1
        keep.reverse()
        if len(keep) != len(block.ops):
            block.ops = keep
        report.details['removed_op_types'] = removed_types

        if self.prune_vars:
            self._prune_vars(program, block, ctx, live)

    def _prune_vars(self, program, block, ctx, live):
        """Drop block-0 vars no remaining op touches. Parameters, data
        slots, preserve-set and fetch roots always stay (a pruned program
        must keep its run boundary loadable/feedable)."""
        referenced = set(live) | set(ctx.preserve)
        referenced |= set(ctx.feed_names or ())
        for b in program.blocks:
            for op in b.ops:
                referenced |= set(n for n in op.input_arg_names() if n)
                referenced |= set(n for n in op.output_arg_names() if n)
        dead = [n for n, v in block.vars.items()
                if n not in referenced
                and not v.persistable and not getattr(v, 'is_data', False)]
        for n in dead:
            del block.vars[n]
