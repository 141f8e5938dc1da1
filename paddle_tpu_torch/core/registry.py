"""Op registry: every op = a torch lowering rule (+ optional shape inference
and grad maker), with paddle_tpu/core/registry.py's `register` contract.

A lowering is a plain function `(ctx, ins) -> outs` on torch tensors, where
`ins`/`outs` map slot names to lists of tensors. The same function serves
three callers: the Executor's interpreter (core/lowering.py) on the device,
the plain CPU path, and build-time shape inference, which runs it on
tensors of torch's 'meta' device (shapes and dtypes, no data).
"""
from __future__ import annotations

import torch

from ..framework import GRAD_SUFFIX, convert_dtype, to_torch_dtype
from . import amp

# probe value substituted for -1 dims during meta-tensor shape inference;
# any output dim that is a multiple of it maps back to -1.
_PROBE = 12289


class OpDef(object):
    __slots__ = ('type', 'lower', 'infer_shape', 'grad_maker', 'no_grad',
                 'diff_inputs', 'infer_lod', 'lod_mode')

    def __init__(self, type, lower, infer_shape=None, grad_maker=None,
                 no_grad=False, diff_inputs=None, infer_lod=None, lod='pass'):
        self.type = type
        self.lower = lower
        self.infer_shape = infer_shape
        self.grad_maker = grad_maker
        self.no_grad = no_grad
        # slots eligible for gradients; None = every float-dtype input slot
        self.diff_inputs = diff_inputs
        self.infer_lod = infer_lod
        self.lod_mode = lod


_REGISTRY = {}


def register(type, lower=None, infer_shape=None, grad_maker=None,
             no_grad=False, diff_inputs=None, infer_lod=None, lod='pass'):
    """Register an op. Usable as decorator on the lowering fn:

        @register('relu')
        def _relu(ctx, ins):
            return {'Out': [torch.relu(ins['X'][0])]}
    """
    def deco(fn):
        _REGISTRY[type] = OpDef(type, fn, infer_shape, grad_maker, no_grad,
                                diff_inputs, infer_lod, lod)
        return fn
    if lower is not None:
        return deco(lower)
    return deco


def get(type):
    return _REGISTRY.get(type)


def is_registered(type):
    """An op type the interpreter can run: registered, or a `<type>_grad`
    whose forward is (the generic grad)."""
    return type in _REGISTRY or (
        type.endswith('_grad') and type[:-5] in _REGISTRY)


# ---------------------------------------------------------------------------
# Shape inference: run the lowering on meta tensors, substituting _PROBE for
# -1 dims and mapping probe-derived output dims back to -1 (the reference's
# compile-time InferShape, framework/shape_inference.h, without per-op code).
# ---------------------------------------------------------------------------
META = torch.device('meta')


class ShapeCtx(object):
    """Minimal ctx handed to lowerings during meta evaluation."""

    def __init__(self, op, block):
        self.op = op
        self.block = block
        self.attrs = op.attrs
        self.is_test = bool(op.attrs.get('is_test', False))
        self.device = META

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def rng(self):
        return None  # meta tensors draw no numbers

    def var(self, name):
        return self.block._find_var_recursive(name)


def _probe_shape(shape):
    return tuple(_PROBE if d in (-1, None) else int(d) for d in shape)


def _unprobe_dim(d, had_probe):
    if had_probe and d % _PROBE == 0 and d != 0:
        # a multiple of the large prime probe derives from the dynamic dim
        return -1
    return int(d)


def infer_shape(op, block):
    """Infer and assign output var shapes/dtypes for a freshly appended op."""
    d = get(op.type)
    if d is None:
        if op.type.endswith('_grad'):
            _infer_grad_shape(op, block)
        return  # feed/fetch and unknown ops keep their declared shapes
    if d.infer_shape is not None:
        d.infer_shape(op, block)
        return
    _generic_infer_shape(op, block, d)


def _generic_infer_shape(op, block, d):
    had_probe = False
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if not n:
                vals.append(None)
                continue
            v = block._find_var_recursive(n)
            if v is None or v.shape is None:
                return  # can't infer
            if any(s in (-1, None) for s in v.shape):
                had_probe = True
            vals.append(torch.empty(_probe_shape(v.shape),
                                    dtype=to_torch_dtype(v.dtype),
                                    device=META))
        ins[slot] = vals

    try:
        with amp.scope(False):  # declared dtypes stay those of f32 compute
            outs = d.lower(ShapeCtx(op, block), ins)
    except Exception:  # noqa: BLE001 — inference is best effort, as in
        # paddle_tpu: a lowering that needs values, or probe dims that only
        # agree at run time (a -1 batch added to a fixed batch), leaves the
        # declared shapes, and the run reports any real mismatch
        return

    for slot, names in op.outputs.items():
        vals = (outs or {}).get(slot)
        if vals is None:
            continue
        for n, t in zip(names, vals):
            if not n or t is None:
                continue
            v = block._find_var_recursive(n)
            if v is None:
                continue
            v.shape = tuple(_unprobe_dim(s, had_probe) for s in t.shape)
            v.dtype = convert_dtype(t.dtype)
    if d.infer_lod is not None:  # an op's own rule for its outputs' lod_level
        d.infer_lod(op, block)


def _infer_grad_shape(op, block):
    """A generic grad op's outputs take the shape and dtype of the forward
    vars they are the gradients of (paddle_tpu/core/registry.py:201): the
    name up to '@GRAD' names the forward var."""
    for names in op.outputs.values():
        for n in names:
            gv = block._find_var_recursive(n) if n else None
            if gv is None or gv.shape is not None:
                continue
            fv = block._find_var_recursive(n.split(GRAD_SUFFIX)[0])
            if fv is not None:
                gv.shape = fv.shape
                gv.dtype = fv.dtype
