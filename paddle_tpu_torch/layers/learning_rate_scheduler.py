"""In-graph learning-rate schedules, the port's copy of
paddle_tpu/layers/learning_rate_scheduler.py (ref:
fluid/layers/learning_rate_scheduler.py).

A schedule is ops of the main program over a persistable int64 step
counter, `@LR_DECAY_COUNTER@`, which an `increment` op steps once a run
(under gradient merge, once a step: the Executor runs it outside the
microbatch loop). The schedule's ops compute the rate in f32 and its
output Variable goes to the optimizer as its learning rate.
"""
from __future__ import annotations

import math

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from . import nn, ops, tensor

__all__ = ['noam_decay', 'exponential_decay', 'natural_exp_decay',
           'inverse_time_decay', 'polynomial_decay', 'piecewise_decay',
           'cosine_decay', 'append_LARS', 'autoincreased_step_counter']


def _decay_step_counter(begin=0):
    """The step as f32: the counter starts at begin - 1 and the first run
    steps it to begin."""
    helper = LayerHelper('global_step_counter')
    counter = helper.create_or_get_global_variable(
        name='@LR_DECAY_COUNTER@', dtype='int64', shape=[1], persistable=True)
    helper.set_variable_initializer(counter, ConstantInitializer(begin - 1))
    helper.append_op(type='increment', inputs={'X': [counter]},
                     outputs={'Out': [counter]}, attrs={'step': 1.0})
    counter.stop_gradient = True
    return nn.cast(counter, 'float32')


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """An int64 counter (default `@STEP_COUNTER@`) that reads begin on the
    first run and grows by step at each."""
    helper = LayerHelper('global_step_counter')
    counter = helper.create_or_get_global_variable(
        name=counter_name or '@STEP_COUNTER@', dtype='int64', shape=[1],
        persistable=True)
    helper.set_variable_initializer(counter, ConstantInitializer(begin - 1))
    helper.append_op(type='increment', inputs={'X': [counter]},
                     outputs={'Out': [counter]}, attrs={'step': float(step)})
    counter.stop_gradient = True
    return counter


def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 · min(t^-0.5, t · warmup_steps^-1.5), t = 1, 2, ..."""
    global_step = _decay_step_counter(1)
    a = global_step ** -0.5
    b = (warmup_steps ** -1.5) * global_step
    return (d_model ** -0.5) * nn.elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate * (decay_rate ** div_res)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate * ops.exp(-1 * decay_rate * div_res)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / decay_steps
    if staircase:
        div_res = ops.floor(div_res)
    return learning_rate / (1 + decay_rate * div_res)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    global_step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(global_step / decay_steps)
        # an unused zero, appended as the reference appends it, so both
        # packages build the same ops
        tensor.fill_constant(shape=[1], dtype='float32', value=0.0)
        one_var = tensor.fill_constant(shape=[1], dtype='float32', value=1.0)
        div_res = nn.elementwise_max(div_res, one_var)
        decay_steps_var = decay_steps * div_res
    else:
        decay_steps_var = tensor.fill_constant(
            shape=[1], dtype='float32', value=float(decay_steps))
        global_step = nn.elementwise_min(global_step, decay_steps_var)
    frac = (1 - global_step / decay_steps_var) ** power
    return (learning_rate - end_learning_rate) * frac + end_learning_rate


def piecewise_decay(boundaries, values):
    """values[i] while the step is below boundaries[i], values[-1] after
    the last boundary: nested `select` ops, no control flow."""
    global_step = _decay_step_counter()
    lr = tensor.fill_constant(shape=[1], dtype='float32',
                              value=float(values[-1]))
    helper = LayerHelper('piecewise_decay')
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = global_step < float(b)
        v_var = tensor.fill_constant(shape=[1], dtype='float32',
                                     value=float(v))
        out = helper.create_variable_for_type_inference('float32')
        helper.append_op(type='select', inputs={'Cond': [cond], 'X': [v_var],
                                                'Y': [lr]},
                         outputs={'Out': [out]}, attrs={})
        lr = out
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    global_step = _decay_step_counter()
    cur_epoch = ops.floor(global_step / step_each_epoch)
    return learning_rate * 0.5 * (ops.cos(cur_epoch * math.pi / epochs) + 1)


def append_LARS(params_grads, learning_rate, weight_decay):
    """The LARS local rates, learning_rate·‖p‖ / (‖g‖ + weight_decay·‖p‖)
    times each parameter's own rate, one Variable per (param, grad)."""
    def _balanced_weight(param_norm, grad_norm):
        return learning_rate * param_norm / (grad_norm +
                                             weight_decay * param_norm)
    out = []
    for param, grad in params_grads:
        param_lr = param.optimize_attr['learning_rate']
        param_norm = ops.sqrt(nn.reduce_sum(input=ops.square(param)))
        grad_norm = ops.sqrt(nn.reduce_sum(input=ops.square(grad)))
        decayed = _balanced_weight(param_norm, grad_norm)
        out.append(decayed * param_lr)
    return out
