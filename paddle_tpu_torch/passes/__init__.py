"""Program passes and lint: the port's copy of paddle_tpu/passes/ (all
but quantize.py, which waits for the int8 tier).

The Program is the IR (framework.py), and each pass rewrites it in place
under a PassManager that clones, orders and accounts for them:

  verify_program        static lint: undefined inputs, use-before-def,
                        unregistered ops, dangling sub-blocks,
                        unreachable fetch targets, registry shape/dtype
                        consistency (error/warn diagnostics)
  constant_fold         evaluate compile-time-constant chains on the
                        CPU and splice literal vars (IEEE-exact ops only)
  dead_op_elimination   backward liveness from fetch targets +
                        persistables
  horizontal_fuse       merge sibling same-input convs (the inception
                        branch pattern) into one wider conv + split
  fuse_activation       merge elementwise activations into conv/mul/
                        elementwise_add producers (the interpreter applies
                        the act's lowering to the producer's output)
  recompute             move forward segments into remat_segment
                        sub-blocks (append_backward's `checkpoints`)

Beside them sits the read-only dataflow analysis (dataflow.py): def-use
chains, last-writer resolution across sub-blocks, live intervals,
hazards, a bytes-from-shape peak-memory estimate, and the donation
certifier (an analysis here: the port's Executor donates nothing).

Consumers: the Executor lints each program epoch (warn-only;
PTPU_STRICT_VERIFY=1 raises) and frees each value after its last reader
from dataflow's live intervals; export_compiled runs the inference
pipeline before it writes an artifact and records each bucket's
peak_bytes_est; transpiler.memory_optimize and
InferenceTranspiler.transpile are thin calls into the PassManager.

    import paddle_tpu_torch as fluid
    prog, reports = fluid.passes.apply_optimization_pipeline(
        main_prog, fetch_names=[loss.name])
    for r in reports:
        print(r)   # PassReport(dead_op_elimination: ops 87->71 ...)
"""
from __future__ import annotations

from .base import (Pass, PassContext, PassManager, PassReport,
                   register_pass, create_pass, get_pass_class,
                   registered_passes)
from .verifier import (VerifyProgramPass, Diagnostic, ProgramVerifyError,
                       verify_program)
from .dce import DeadOpEliminationPass
from .const_fold import ConstantFoldPass
from .fuse_act import FuseActivationPass
from .dataflow import (DataflowAnalysis, DonationCertificate, Hazard,
                       MemoryEstimate, MemoryOptimizeReport,
                       analyze_program, certify_donation, donation_plan,
                       var_bytes)
from .horizontal_fuse import HorizontalFusePass, horizontal_fuse_program
from .recompute import RecomputePass, recompute_program

# constant_fold runs first so dead_op_elimination sweeps the literal
# producers whose consumers folded; fuse_activation last, on the final
# op list. verify_program leads: fail loudly before rewriting garbage.
#
# ORDER NOTE — horizontal_fuse before fuse_activation: widening sibling
# convs first leaves each branch's bias+act epilogue reading its own
# split output, so fuse_activation still folds the per-branch relu into
# the per-branch elementwise_add afterwards (single-reader guard intact).
# Run the other way round, an act already folded INTO a conv would have
# to be part of the widening decision; horizontal_fuse handles that too
# (fuse_act attrs are in its group key — elementwise acts commute with
# the channel concat), but only the fuse-first order can fold the acts
# that live behind the per-branch bias adds. Regression:
# tests/test_horizontal_fuse.py::test_per_branch_act_epilogues_survive.
OPTIMIZATION_PIPELINE = ('verify_program', 'constant_fold',
                         'dead_op_elimination', 'horizontal_fuse',
                         'fuse_activation')

# same ordered passes, but dead-op elimination roots liveness at the
# FETCHES ONLY (keep_persistable_writers=False): an inference program has
# no optimizer, and a train-derived clone handed to the inference
# pipeline sheds its whole training cone (grad ops, optimizer writes) —
# reference InferenceTranspiler semantics. The configured instance sits
# in the tuple so PassManager(INFERENCE_PIPELINE) reproduces exactly
# what apply_inference_pipeline runs.
INFERENCE_PIPELINE = ('verify_program', 'constant_fold',
                      DeadOpEliminationPass(keep_persistable_writers=False),
                      'horizontal_fuse', 'fuse_activation')


def pipeline_names(pipeline):
    """Names of a pipeline's entries (str entries pass through)."""
    return [p if isinstance(p, str) else p.name for p in pipeline]


def _disabled():
    import os
    return os.environ.get('PTPU_DISABLE_PASSES', '') == '1'


def apply_optimization_pipeline(program, fetch_names=None, feed_names=None,
                                inplace=False):
    """Run the standard optimization pipeline; returns (program, reports).
    PTPU_DISABLE_PASSES=1 short-circuits to the input program."""
    if _disabled():
        return program, []
    return PassManager(OPTIMIZATION_PIPELINE).apply(
        program, fetch_names=fetch_names, feed_names=feed_names,
        inplace=inplace)


def apply_inference_pipeline(program, fetch_names=None, feed_names=None,
                             inplace=False):
    """Inference-program variant: liveness roots at the fetches only, so
    a train-derived program sheds grads/optimizer. Do not point this at a
    program you still intend to train."""
    if _disabled():
        return program, []
    return PassManager(INFERENCE_PIPELINE).apply(
        program, fetch_names=fetch_names, feed_names=feed_names,
        inplace=inplace)
