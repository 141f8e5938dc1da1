"""Gradient merge / batch accumulation, the port's copy of
paddle_tpu/contrib/gradient_merge.py (ref:
framework/ir/multi_batch_merge_pass.cc): train with an effective batch k
times larger than one pass holds, by accumulating k microbatch gradients
before one optimizer update.

`decorate(optimizer, k)` returns an optimizer whose `minimize` marks the
program (`program._grad_accum_k = k`); `enable(k, program)` marks a
program already built. The Executor then slices each fed batch into k
microbatches, runs the forward and backward on each, accumulates every
raw gradient as `acc + g/k`, and runs the optimizer once
(executor.Executor._ga_step): the merged gradient is the mean of the
microbatches' gradients.

    fluid.contrib.gradient_merge.enable(2, main)
"""
from __future__ import annotations

from ..framework import default_main_program


class GradientMergeOptimizer(object):
    """Wraps an optimizer; minimize() marks the program for k-way
    microbatch accumulation."""

    def __init__(self, optimizer, k_steps):
        if int(k_steps) < 1:
            raise ValueError("k_steps must be >= 1, got %r" % (k_steps,))
        self._optimizer = optimizer
        self._k = int(k_steps)

    def __getattr__(self, name):
        return getattr(self._optimizer, name)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, checkpoints=None):
        loss.block.program._grad_accum_k = self._k
        return self._optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set,
            checkpoints=checkpoints)


def decorate(optimizer, k_steps):
    return GradientMergeOptimizer(optimizer, k_steps)


def enable(k_steps, program=None):
    """Mark an already-built program (the default main program if None)
    for k-way gradient merge; returns it."""
    program = program if program is not None else default_main_program()
    program._grad_accum_k = int(k_steps)
    return program
