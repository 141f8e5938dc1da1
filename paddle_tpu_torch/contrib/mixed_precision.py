"""bf16 mixed-precision training surface: the port's copy of
paddle_tpu/contrib/mixed_precision.py.

bf16 shares float32's exponent range, so no loss scaling is needed:
`decorate(optimizer)` returns an optimizer whose `minimize` marks the
program bf16 (`program._amp_bf16`), and `enable_bf16(program)` marks a
program already built. The Executor then runs the whole step inside
`core.amp.scope(True)`: the mul and conv2d lowerings compute forward and
backward in bf16 through `core.amp.matmul` and `core.amp.conv2d`, while
parameters, optimizer state, norm statistics and losses stay float32.
`Program.clone` does not carry the mark, as in the reference.

    opt = fluid.contrib.mixed_precision.decorate(fluid.optimizer.Adam(1e-4))
    opt.minimize(loss)
    # or, for a program built already:
    fluid.contrib.mixed_precision.enable_bf16(main)
"""
from __future__ import annotations

from ..framework import default_main_program


class OptimizerWithMixedPrecision(object):
    """Wraps an optimizer so that `minimize` enables bf16 on the program."""

    def __init__(self, optimizer):
        self._optimizer = optimizer

    def __getattr__(self, name):
        return getattr(self._optimizer, name)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, checkpoints=None):
        program = loss.block.program
        program._amp_bf16 = True
        return self._optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set,
            checkpoints=checkpoints)


def decorate(optimizer):
    """An AMP wrapper of `optimizer`: bf16 compute, no loss scaling."""
    return OptimizerWithMixedPrecision(optimizer)


def enable_bf16(program=None):
    """Mark an already-built program (the default main program if None)
    for bf16 execution; returns it."""
    program = program if program is not None else default_main_program()
    program._amp_bf16 = True
    return program


def disable_bf16(program=None):
    program = program if program is not None else default_main_program()
    program._amp_bf16 = False
    return program
