"""Optimizers: the port's copy of paddle_tpu/optimizer.py's `Optimizer`
(:22-141), `SGDOptimizer` (:143-155), `MomentumOptimizer` (:158-184) and
`AdamOptimizer` (:248-297).

`minimize` = append_backward, the gradient clip ops (clip.py), the
regularization ops (regularizer.py), then the optimizer's update ops, all
appended to the same program, with the JAX package's var names: the
global learning-rate var `learning_rate_<n>` (or the Variable a schedule
of layers/learning_rate_scheduler.py returns), a `scale` op for a
parameter whose ParamAttr asks for another learning rate, and
per-parameter accumulators `<param>_<acc>_<n>` (Momentum's velocity;
Adam's moment1, moment2, beta1_pow_acc, beta2_pow_acc), all persistable
and initialized by the startup program. `checkpoints` (activation
rematerialization) goes to append_backward, as in the reference.
"""
from __future__ import annotations

from collections import defaultdict

from . import unique_name
from .backward import OP_ROLE_OPTIMIZE, append_backward
from .clip import append_gradient_clip_ops
from .framework import Variable, default_main_program
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = defaultdict(dict)
        self.helper = None

    # -- learning rate -----------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if program in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        helper = LayerHelper('learning_rate')
        lr_var = helper.create_global_variable(
            name=unique_name.generate('learning_rate'), shape=[1],
            dtype='float32', persistable=True)
        helper.set_variable_initializer(
            lr_var, ConstantInitializer(float(self._learning_rate)))
        self._learning_rate_map[program] = lr_var

    def _global_learning_rate(self, program=None):
        return self._learning_rate_map.get(program or default_main_program())

    def _create_param_lr(self, param_and_grad):
        """The global learning rate, or for a parameter whose ParamAttr
        learning_rate is not 1 a `scale` op's output: the global rate
        times that factor."""
        param = param_and_grad[0]
        param_lr = (param.optimize_attr or {}).get('learning_rate', 1.0)
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        helper = LayerHelper('param_lr')
        out = helper.create_variable_for_type_inference('float32')
        helper.append_op(type='scale', inputs={'X': [base]},
                         outputs={'Out': [out]},
                         attrs={'scale': float(param_lr),
                                'op_role': OP_ROLE_OPTIMIZE})
        return out

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = LayerHelper(name)
        var = helper.create_global_variable(
            name=unique_name.generate('_'.join([param.name, name])),
            shape=shape if shape is not None else list(param.shape),
            dtype=dtype or param.dtype, persistable=True)
        helper.set_variable_initializer(
            var, ConstantInitializer(float(fill_value)))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- the pipeline ------------------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads, loss):
        block = loss.block
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(block, [p for p, g in parameters_and_grads
                                          if g is not None])
        return [self._append_optimize_op(block, pg)
                for pg in parameters_and_grads
                if pg[1] is not None and pg[0].trainable]

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None, checkpoints=None):
        return append_backward(loss, parameter_list, no_grad_set,
                               callbacks, checkpoints=checkpoints)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, checkpoints=None):
        """Append the backward, the clip and regularization ops and the
        update ops, in the reference's order (paddle_tpu/optimizer.py:
        128-140); returns (optimize_ops, params_grads). checkpoints:
        activation-rematerialization boundaries ('auto' or a list of
        Variables/names), see append_backward — the reference
        RecomputeOptimizer folded into minimize."""
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set, checkpoints=checkpoints)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        return self._create_optimization_pass(params_grads, loss), \
            params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        lr = self._create_param_lr(param_and_grad)
        return block.append_op(
            type=self.type,
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "LearningRate": [lr.name]},
            outputs={"ParamOut": [param.name]},
            attrs={'op_role': OP_ROLE_OPTIMIZE}, infer_shape=False)


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator(self._velocity_acc_str, param)
        lr = self._create_param_lr(param_and_grad)
        return block.append_op(
            type=self.type,
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Velocity": [velocity.name], "LearningRate": [lr.name]},
            outputs={"ParamOut": [param.name],
                     "VelocityOut": [velocity.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   'op_role': OP_ROLE_OPTIMIZE},
            infer_shape=False)


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None,
                 lazy_mode=False):
        super().__init__(learning_rate, regularization, name)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = lazy_mode

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p,
                                  fill_value=self._beta1, shape=[1])
            self._add_accumulator(self._beta2_pow_acc_str, p,
                                  fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment1 = self._get_accumulator(self._moment1_acc_str, param)
        moment2 = self._get_accumulator(self._moment2_acc_str, param)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, param)
        beta2_pow = self._get_accumulator(self._beta2_pow_acc_str, param)
        return block.append_op(
            type=self.type,
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "LearningRate": [self._create_param_lr(param_and_grad).name],
                    "Moment1": [moment1.name], "Moment2": [moment2.name],
                    "Beta1Pow": [beta1_pow.name],
                    "Beta2Pow": [beta2_pow.name]},
            outputs={"ParamOut": [param.name],
                     "Moment1Out": [moment1.name],
                     "Moment2Out": [moment2.name],
                     "Beta1PowOut": [beta1_pow.name],
                     "Beta2PowOut": [beta2_pow.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "lazy_mode": self._lazy_mode,
                   'op_role': OP_ROLE_OPTIMIZE},
            infer_shape=False)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
