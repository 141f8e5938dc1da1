"""Program transpilers (the port's copy of paddle_tpu/transpiler.py:76-190):
`memory_optimize`, `release_memory` and `InferenceTranspiler`, thin calls
into the pass API (passes/). DistributeTranspiler waits for the parallel
stack (ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=False, fetch_list=None, batch=1,
                    checkpoints=None):
    """DEPRECATED front door to the pass API — prefer calling the passes
    directly: ``paddle_tpu_torch.passes.recompute_program`` for activation
    rematerialization, ``PassManager(['dead_op_elimination'])`` for the
    sweep, ``passes.dataflow.analyze_program`` for the liveness report.
    This wrapper routes to that pipeline (in place) and keeps the
    reference call signature alive.

    What runs: (1) with `checkpoints` (a list of checkpoint var names or
    'auto', pre-backward programs only) the recompute pass segments the
    forward and splices remat_segment ops; (2) the dead-op sweep; (3) the
    dataflow engine over the result, returning a MemoryOptimizeReport —
    per-var live ranges, reuse opportunities, and the remat-aware static
    peak before/after (at `batch` for -1 dims).

    No var is renamed for reuse: the Executor frees each value after its
    last reader by these live ranges, and torch's caching allocator
    reuses the freed blocks.

    fetch_list: optional fetch Variables/names. Without it only vars
    feeding literally nothing are prunable (any terminal var is a
    potential fetch target); with it, liveness roots at the fetches, the
    reference's skip_opt_set discipline.
    """
    import warnings
    from .framework import Variable
    from .passes import PassManager
    from .passes import dataflow as _dataflow
    warnings.warn(
        "transpiler.memory_optimize is deprecated: use the pass API — "
        "paddle_tpu_torch.passes.recompute_program(program, "
        "checkpoints=...) for activation recompute, "
        "PassManager(['dead_op_elimination']) for the sweep, "
        "passes.dataflow.analyze_program for the report",
        DeprecationWarning, stacklevel=2)
    fetch_names = None
    if fetch_list is not None:
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in fetch_list]
    peak_before = _dataflow.analyze_program(
        input_program, fetch_names=fetch_names).peak_memory(
            batch=batch, top=0, remat_aware=True).peak_bytes
    recompute_details = None
    if checkpoints is not None:
        from .passes.recompute import recompute_program
        _, rrep = recompute_program(
            input_program, checkpoints=checkpoints,
            fetch_names=fetch_names, preserve=skip_opt_set or (),
            batch=batch, inplace=True)
        recompute_details = {
            'segments': len(rrep.details.get('segments', ())),
            'skip_reasons': dict(rrep.details.get('skip_reasons', {}))}
    _, reports = PassManager(['dead_op_elimination']).apply(
        input_program, fetch_names=fetch_names,
        preserve=skip_opt_set, inplace=True)
    dfa = _dataflow.analyze_program(input_program, fetch_names=fetch_names)
    report = _dataflow.MemoryOptimizeReport(
        reports[0], dfa.live_intervals(),
        peak_before,
        dfa.peak_memory(batch=batch, top=0, remat_aware=True).peak_bytes,
        dfa.reuse_report(batch=batch), batch)
    if recompute_details is not None:
        report.details['recompute'] = recompute_details
    if print_log:
        print(report)
    return report


def release_memory(input_program, skip_opt_set=None):
    """Same dead-op sweep as memory_optimize (the reference's eager
    variant); returns the report."""
    return memory_optimize(input_program, skip_opt_set=skip_opt_set)


class InferenceTranspiler(object):
    """Inference-time program rewriting (ref inference_transpiler.py):
    runs the passes' inference pipeline (verify, constant_fold,
    dead_op_elimination, horizontal_fuse, fuse_activation) on `program`
    IN PLACE — reference semantics — and returns the per-pass reports."""

    def transpile(self, program, place, scope=None):
        from .passes import apply_inference_pipeline
        _, reports = apply_inference_pipeline(
            program, fetch_names=getattr(program, '_fetch_names', None),
            feed_names=getattr(program, '_feed_names', None),
            inplace=True)
        return reports
