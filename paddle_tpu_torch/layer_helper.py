"""LayerHelper: shared machinery for layer functions
(ref: python/paddle/fluid/layer_helper.py).

Creates parameters in the main program's global block + matching init ops in
the startup program, temp vars, and activation/bias append helpers.
"""
from __future__ import annotations

from . import unique_name
from .framework import (Parameter, Variable, default_main_program,
                        default_startup_program)
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get('name')
        if name is None:
            self.name = unique_name.generate(layer_type)
        else:
            self.name = name

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    # -- inputs ------------------------------------------------------------
    def input(self, input_param_name='input'):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            return [inputs]
        return list(inputs)

    def input_dtype(self, input_param_name='input'):
        inputs = self.input(input_param_name)
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
        return dtype

    # -- params ------------------------------------------------------------
    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get('param_attr'))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get('bias_attr'))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [attr]
        if len(attr) != 1 and len(attr) != length:
            raise ValueError("parameter number mismatch")
        if len(attr) == 1 and length != 1:
            attr = [attr[0]] + [ParamAttr(**attr[0].__dict__.copy())
                                for _ in range(length - 1)]
        return attr

    def iter_inputs_and_params(self, input_param_name='input'):
        inputs = self.input(input_param_name)
        param_attrs = self.multiple_param_attr(len(inputs))
        for ipt, pattr in zip(inputs, param_attrs):
            yield ipt, pattr

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if default_initializer is None:
            if is_bias:
                attr._set_default_initializer(ConstantInitializer(0.0))
            else:
                attr._set_default_initializer(XavierInitializer())
        else:
            attr._set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, 'w' if not is_bias else 'b']))

        shape = [int(s) for s in shape]
        # main-program parameter
        param = self.main_program.global_block().create_parameter(
            name=attr.name, shape=shape, dtype=dtype,
            **{k: v for k, v in attr._to_kwargs().items() if k != 'name'})
        # startup-program var + init op
        sb = self.startup_program.global_block()
        if not sb.has_var_local(attr.name):
            sv = sb.create_var(name=attr.name, shape=shape, dtype=dtype,
                               persistable=True)
            attr.initializer(sv, sb)
        return param

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, 'tmp'])),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def create_or_get_global_variable(self, name, *args, **kwargs):
        gb = self.main_program.global_block()
        if not gb.has_var_local(name):
            return self.create_global_variable(name=name, *args, **kwargs)
        return gb.var(name)

    def set_variable_initializer(self, var, initializer):
        sb = self.startup_program.global_block()
        if not sb.has_var_local(var.name):
            sv = sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                               persistable=True)
            initializer(sv, sb)

    # -- op append ---------------------------------------------------------
    def append_op(self, **kwargs):
        return self.block.append_op(**kwargs)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type='elementwise_add',
            inputs={'X': [input_var.name], 'Y': [b.name]},
            outputs={'Out': [tmp.name]}, attrs={'axis': dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get('act')
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {'type': act}
        else:
            act = dict(act)
        act_type = act.pop('type')
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(type=act_type, inputs={'X': [input_var.name]},
                       outputs={'Out': [tmp.name]}, attrs=act)
        return tmp
