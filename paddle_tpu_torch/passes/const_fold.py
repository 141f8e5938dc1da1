"""constant_fold: evaluate compile-time-constant ops on the host and
splice literal vars into the program (the port's copy of
paddle_tpu/passes/const_fold.py).

The reference folds through framework/ir/ passes at graph level; here a
folded op is replaced IN PLACE by an `assign_value` literal carrying the
evaluated result, so every consumer (including sub-block closure reads)
sees the identical value.
Running dead_op_elimination afterwards sweeps literal producers whose
only consumers were themselves folded — that is how a fill_constant →
scale → elementwise_add chain nets out to one literal.

Two discipline rules keep folding bit-identical to the run:
  * whitelist only IEEE-exact ops (adds, muls, casts, shapes, slices —
    no transcendentals, no rng, nothing platform-tuned), and
  * evaluate through the op's OWN registered lowering on CPU tensors,
    in the op's declared dtypes — the same torch calls the interpreter
    makes on the device, just executed now (where the reference runs its
    jnp lowerings on the host CPU backend).
"""
from __future__ import annotations

import numpy as np

from ..core import registry
from ..framework import convert_dtype
from .base import Pass, register_pass, op_writes

# largest literal worth embedding in the program (elements)
_FOLD_SIZE_LIMIT = 1 << 16

# ops that (a) are deterministic pure functions of inputs+attrs and
# (b) lower to IEEE-exact arithmetic, so a host eval equals the in-graph
# value bitwise on every platform
_FOLDABLE_OPS = frozenset((
    'fill_constant', 'assign_value', 'fill_zeros_like', 'fill_any_like',
    'assign', 'cast', 'scale', 'shape',
    'elementwise_add', 'elementwise_sub', 'elementwise_mul',
    'elementwise_div', 'elementwise_max', 'elementwise_min',
    'elementwise_floordiv', 'elementwise_mod',
    'sum', 'concat', 'stack', 'split',
    'reshape', 'reshape2', 'squeeze', 'squeeze2', 'unsqueeze',
    'unsqueeze2', 'transpose', 'transpose2', 'slice', 'expand',
    'abs', 'floor', 'ceil', 'round', 'sign', 'square', 'sqrt',
    'clip', 'equal', 'not_equal', 'less_than', 'less_equal',
    'greater_than', 'greater_equal', 'logical_not', 'logical_and',
    'logical_or', 'range',
))

# deliberately NOT foldable even though pure: shape depends on a feed
_BATCH_DEPENDENT = frozenset((
    'fill_constant_batch_size_like',
))


class _FoldCtx(object):
    """OpCtx lookalike for eager host evaluation of a lowering."""

    def __init__(self, op, block):
        import torch
        self.op = op
        self.attrs = op.attrs
        self.block = block
        self.device = torch.device('cpu')

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    @property
    def is_test(self):
        return bool(self.attrs.get('is_test', False))

    def rng(self):
        raise RuntimeError("constant folding must not evaluate rng ops")

    def var(self, name):
        return self.block._find_var_recursive(name)


def _eval_op(op, block, const_env):
    """Evaluate one whitelisted op through its own lowering on CPU
    tensors, each input in the dtype its producer gave it; returns
    {slot: [np arrays]} or None when evaluation is not possible."""
    import torch
    from ..core import amp
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if not n:
                vals.append(None)
                continue
            if n not in const_env:
                return None
            vals.append(torch.as_tensor(np.asarray(const_env[n])))
        ins[slot] = vals
    d = registry.get(op.type)
    if d is None:
        return None
    ctx = _FoldCtx(op, block)
    try:
        with torch.no_grad(), amp.scope(False):
            outs = d.lower(ctx, ins)
    except Exception:
        return None
    if not outs:
        return None
    host = {}
    for slot, vals in outs.items():
        if vals is None:
            continue
        host[slot] = [None if v is None else _to_host(v) for v in vals]
    return host


def _to_host(t):
    """A folded value as numpy: bf16 widens to f32 (exactly), as numpy
    has no bf16."""
    import torch
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _literal_attrs(arr, declared_dtype):
    """assign_value attrs carrying `arr` exactly. Python floats are f64
    (supersets f32/bf16/f16) and python ints are unbounded, so the
    round-trip through the attr list is lossless for every supported
    dtype; None when the dtype has no literal encoding."""
    if arr.size == 0:
        return None  # empty literals have no attr encoding (falsy lists)
    dt = convert_dtype(declared_dtype or arr.dtype.name)
    if dt in ('float16', 'bfloat16', 'float32', 'float64'):
        vals = {'fp32_values': [float(x)
                                for x in np.asarray(arr, np.float64).ravel()]}
    elif dt == 'bool':
        vals = {'int32_values': [int(x) for x in arr.ravel()]}
    elif dt in ('int8', 'uint8', 'int16', 'int32'):
        vals = {'int32_values': [int(x) for x in arr.ravel()]}
    elif dt == 'int64':
        vals = {'int64_values': [int(x) for x in arr.ravel()]}
    else:
        return None
    return {'shape': list(arr.shape), 'dtype': dt, **vals}


@register_pass
class ConstantFoldPass(Pass):
    name = 'constant_fold'

    def run_on_program(self, program, ctx, report):
        block = program.global_block()
        const_env = {}   # var name -> np value
        folded = 0
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            outs = self._fold_op(block, op, const_env)
            if outs is None:
                # the op recomputes its outputs at runtime: any const
                # recorded under those names (in-place increment, assign-
                # back counters, sub-block writes) is stale from here on
                for n in op_writes(op, block.program):
                    const_env.pop(n, None)
                i += 1
                continue
            for slot, names in op.outputs.items():
                vals = outs.get(slot)
                if vals is None:
                    continue
                for n, v in zip(names, vals):
                    if n and v is not None:
                        const_env[n] = v
            if not op.input_arg_names():
                # fill_constant / assign_value: already a literal — record
                # the value for downstream folds, keep the op as-is
                i += 1
                continue
            n_spliced = self._splice_literals(block, i, op, outs)
            if n_spliced:
                folded += 1
                i += n_spliced
            else:
                i += 1
        report.details['folded_ops'] = folded
        report.details['const_vars'] = len(const_env)

    def _fold_op(self, block, op, const_env):
        """{slot: [np values]} when op is a compile-time constant, else
        None."""
        t = op.type
        if t in _BATCH_DEPENDENT or t not in _FOLDABLE_OPS:
            return None
        ins = [n for n in op.input_arg_names() if n]
        # NOTE deliberately NOT folded: shape(x) of a var whose DECLARED
        # shape is static — the executor is shape-polymorphic (a run
        # takes the feeds' actual shapes), so declared shapes are
        # documentation, not compile-time constants
        if ins and any(n not in const_env for n in ins):
            return None
        if not ins and t not in ('fill_constant', 'assign_value'):
            return None
        outs = _eval_op(op, block, const_env)
        if outs is None:
            return None
        for vals in outs.values():
            for v in vals:
                if v is not None and v.size > _FOLD_SIZE_LIMIT:
                    return None
        return outs

    @staticmethod
    def _splice_literals(block, i, op, outs):
        """Replace op i with one assign_value literal per output. Returns
        the number of spliced literals, or 0 (op kept) when any consumed
        output has no evaluated value or no literal encoding for its
        dtype."""
        from ..framework import Operator
        lits = []
        evaluated = {}
        for slot, names in op.outputs.items():
            vals = outs.get(slot) or []
            for j, n in enumerate(names):
                if n:
                    evaluated[n] = vals[j] if j < len(vals) else None
        if any(v is None for v in evaluated.values()):
            return 0  # an output the graph may read has no value: keep op
        for n, v in evaluated.items():
            var = block._find_var_recursive(n)
            attrs = _literal_attrs(v, var.dtype if var is not None else None)
            if attrs is None:
                return 0
            attrs['op_role'] = op.attrs.get('op_role', 0)
            lits.append(Operator(block, 'assign_value', {},
                                 {'Out': [n]}, attrs))
        if not lits:
            return 0
        block.ops[i:i + 1] = lits
        return len(lits)
