"""Parameter initializers (ref: python/paddle/fluid/initializer.py).

As in the reference, an initializer appends an init op to the STARTUP
program; running the startup program materializes parameters on the
executor's device (ops/tensor_ops.py draws from a torch.Generator per op).
"""
from __future__ import annotations

import math

import numpy as np


class Initializer(object):
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            type='fill_constant', outputs={'Out': [var.name]},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'value': float(self.value)}, infer_shape=False)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type='uniform_random', outputs={'Out': [var.name]},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'min': self.low, 'max': self.high, 'seed': self.seed},
            infer_shape=False)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type='gaussian_random', outputs={'Out': [var.name]},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'mean': self.loc, 'std': self.scale, 'seed': self.seed},
            infer_shape=False)


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return int(shape[0]) if shape else 1, int(shape[0]) if shape else 1
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = int(shape[1]) * receptive
    fan_out = int(shape[0]) * receptive
    # fc weights are [in, out]
    if len(shape) == 2:
        fan_in, fan_out = int(shape[0]), int(shape[1])
    return fan_in, fan_out


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (fi + fo))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / fi)
        return NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    """The var set to a fixed numpy array by one assign_value op, its
    values in the op's attrs (int32_values for an int32/int64 array,
    fp32_values otherwise), as paddle_tpu/initializer.py:128 emits it."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        vals = self.value.reshape(-1)
        if self.value.dtype in (np.int32, np.int64):
            attr = {'int32_values': [int(v) for v in vals]}
        else:
            attr = {'fp32_values': [float(v) for v in vals]}
        return block.append_op(
            type='assign_value', outputs={'Out': [var.name]},
            attrs={'shape': list(self.value.shape), 'dtype': var.dtype,
                   **attr},
            infer_shape=False)


# reference-compatible aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
