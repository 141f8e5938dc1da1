"""Build-time autodiff over the op IR: the port's copy of
paddle_tpu/backward.py (append_backward :73, _sum_grads :50).

`append_backward` appends gradient ops to the program, as the reference
does (python/paddle/fluid/backward.py:394). Each is a generic
`<type>_grad` op that carries its forward op's slot and name maps, and the
interpreter derives its lowering with autograd over the forward lowering
(core/lowering.py); an op may register an explicit `<type>_grad` lowering
instead (lookup_table_grad). The convention is the JAX package's, so
either package builds the other's training program op for op:

- inputs: the forward op's input slots, its output slots (a slot name the
  inputs already use gets the suffix '@OUT'), and 'Out@GRAD@ALL', the
  gradients of its outputs that exist;
- output: 'IN@GRAD', one gradient var per differentiated input;
- attrs: '_fwd_inputs', '_fwd_outputs', '_out_grad_map', '_in_grad_map',
  '_fwd_op_uid', '_fwd_seed', 'op_role', 'op_role_var', and the forward
  op's public attrs.

A var consumed by several ops gets one gradient per consumer
(`<name>@GRAD@RENAME@<i>` after the first), summed by an explicit `sum`
op; ops that do not lead to the loss are skipped.
"""
from __future__ import annotations

from .core import registry
from .framework import Parameter, Variable, grad_var_name, is_float_dtype

# op_role values (ref: framework/op_proto_maker.h:26-48)
OP_ROLE_BACKWARD = 1
OP_ROLE_OPTIMIZE = 2
OP_ROLE_LOSS = 256


def _relevant_ops(block, target_names, no_grad):
    """Reverse reachability: which ops contribute to the targets."""
    needed = set(target_names)
    relevant = [False] * len(block.ops)
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if any(o in needed for o in op.output_arg_names()):
            relevant[i] = True
            for n in op.input_arg_names():
                if n and n not in no_grad:
                    needed.add(n)
    return relevant


def _create_grad_var(block, fwd_name, grad_name):
    fv = block._find_var_recursive(fwd_name)
    return block.create_var(
        name=grad_name,
        shape=fv.shape if fv is not None else None,
        dtype=fv.dtype if fv is not None else 'float32',
        lod_level=fv.lod_level if fv is not None else 0,
        persistable=False, stop_gradient=False)


def _sum_grads(block, fwd_name, grad_names, role=OP_ROLE_BACKWARD):
    canonical = grad_var_name(fwd_name)
    if canonical not in grad_names:
        _create_grad_var(block, fwd_name, canonical)
    block.append_op(
        type='sum', inputs={'X': list(grad_names)},
        outputs={'Out': [canonical]}, attrs={'op_role': role})
    return canonical


def _eligible_input(block, name, no_grad):
    if not name or name in no_grad:
        return False
    v = block._find_var_recursive(name)
    if v is None:
        return False
    if v.stop_gradient or not is_float_dtype(v.dtype):
        return False
    if isinstance(v, Parameter) and not v.trainable:
        return False
    return True


def _role_vars(block, in_grad_map):
    out = []
    for fwd, g in in_grad_map.items():
        if isinstance(block._find_var_recursive(fwd), Parameter):
            out.extend([fwd, g])
    return out


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append grad ops for `loss`; returns [(param, grad_var), ...].

    checkpoints: activation-rematerialization boundaries (the reference
    RecomputeOptimizer hook, paddle_tpu/backward.py:73-92). 'auto' picks
    √N segments from live intervals; a list of Variables/names closes a
    segment at each def site. The forward is rewritten IN PLACE around
    remat_segment sub-blocks (passes/recompute.py) before grad ops are
    emitted, so each segment's grad re-runs the segment under autograd
    instead of keeping its interior live. None (default) leaves the
    program untouched."""
    block = loss.block
    program = block.program
    if block.idx != 0:
        raise ValueError("append_backward supports block 0 only")

    if checkpoints is not None:
        from .passes.recompute import apply_recompute_for_backward
        apply_recompute_for_backward(program, loss, checkpoints)

    no_grad = set(no_grad_set or ())
    for v in program.list_vars():
        if v.stop_gradient:
            no_grad.add(v.name)

    relevant = _relevant_ops(block, {loss.name}, no_grad)

    # d(loss)/d(loss) = 1
    loss_grad = grad_var_name(loss.name)
    _create_grad_var(block, loss.name, loss_grad)
    block.append_op(
        type='fill_constant',
        inputs={}, outputs={'Out': [loss_grad]},
        attrs={'shape': list(loss.shape or (1,)), 'value': 1.0,
               'dtype': loss.dtype,
               'op_role': OP_ROLE_BACKWARD | OP_ROLE_LOSS})

    grads = {loss.name: [loss_grad]}  # fwd var -> its grad var names

    for i in range(len(relevant) - 1, -1, -1):
        if not relevant[i]:
            continue
        op = block.ops[i]
        d = registry.get(op.type)
        if d is not None and d.no_grad:
            continue

        # resolve and merge the output grads
        out_grad_map = {}
        have_any = False
        for o in op.output_arg_names():
            lst = grads.get(o, [])
            if not lst:
                out_grad_map[o] = ''
            elif len(lst) == 1:
                out_grad_map[o] = lst[0]
                have_any = True
            else:
                out_grad_map[o] = _sum_grads(block, o, lst)
                grads[o] = [out_grad_map[o]]
                have_any = True
        if not have_any:
            continue

        if d is not None and d.grad_maker is not None:
            in_grad_map = d.grad_maker(op, block, out_grad_map) or {}
            for fwd_name, gname in in_grad_map.items():
                grads.setdefault(fwd_name, [])
                if gname not in grads[fwd_name]:
                    grads[fwd_name].append(gname)
            continue

        # the differentiable inputs
        diff_slots = d.diff_inputs if (d and d.diff_inputs is not None) \
            else list(op.inputs)
        in_grad_map = {}
        for slot in diff_slots:
            for n in op.inputs.get(slot, []):
                if n in in_grad_map or not _eligible_input(block, n, no_grad):
                    continue
                gname = grad_var_name(n)
                if n in grads and grads[n]:
                    gname = gname + '@RENAME@' + str(len(grads[n]))
                _create_grad_var(block, n, gname)
                in_grad_map[n] = gname
                grads.setdefault(n, []).append(gname)
        if not in_grad_map:
            continue

        grad_inputs = {slot: list(names) for slot, names in op.inputs.items()}
        for slot, names in op.outputs.items():
            key = slot if slot not in grad_inputs else slot + '@OUT'
            grad_inputs[key] = list(names)
        grad_inputs['Out@GRAD@ALL'] = [g for g in out_grad_map.values() if g]

        block.append_op(
            type=op.type + '_grad',
            inputs=grad_inputs,
            outputs={'IN@GRAD': list(in_grad_map.values())},
            attrs={
                '_fwd_inputs': {k: list(v) for k, v in op.inputs.items()},
                '_fwd_outputs': {k: list(v) for k, v in op.outputs.items()},
                '_out_grad_map': dict(out_grad_map),
                '_in_grad_map': dict(in_grad_map),
                '_fwd_op_uid': op.attrs.get('_op_uid', i),
                '_fwd_seed': op.attrs.get('seed', 0),
                'op_role': OP_ROLE_BACKWARD,
                'op_role_var': _role_vars(block, in_grad_map),
                **{k: v for k, v in op.attrs.items()
                   if not k.startswith('_') and k != 'op_role'},
            },
            infer_shape=False)

    # final accumulation for leaves consumed by more than one op
    for fwd_name, lst in list(grads.items()):
        if len(lst) > 1:
            grads[fwd_name] = [_sum_grads(block, fwd_name, lst)]

    if parameter_list is not None:
        params = [block._find_var_recursive(
            p.name if isinstance(p, Variable) else p) for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]

    param_and_grads = []
    for p in params:
        if p is None or p.name in no_grad:
            continue
        lst = grads.get(p.name, [])
        if lst:
            param_and_grads.append((p, block._find_var_recursive(lst[0])))
    return param_and_grads
