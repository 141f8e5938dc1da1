"""fuse_activation: merge an elementwise activation into its producer
(the port's copy of paddle_tpu/passes/fuse_act.py).

The reference ships dedicated fused kernels (fused_elemwise_activation_op,
conv+act fusion through BuildStrategy.fuse_elewise_add_act_ops); here the
fusion is an IR rewrite: the producer op takes a `fuse_act` attr and the
interpreter applies the activation's OWN registered lowering to the
producer's primary output right after the producer's own
(core/lowering.py) — identical math, one fewer op for the
interpreter/verifier/serializer to walk, and the pattern every later
epilogue-fusion pass (bias+act, residual+act) builds on.

Fusion fires only when the intermediate is consumed by EXACTLY the
activation op: a training program's grad ops list forward intermediates
among their inputs, so fusion is structurally confined to inference
programs — which is where the inference pipeline runs it.
"""
from __future__ import annotations

from .base import Pass, register_pass, op_reads

# activation op -> nothing (attrs ride along); all single-input/single-
# output elementwise ops whose lowering is a pure function of X + attrs
FUSABLE_ACTS = frozenset((
    'relu', 'relu6', 'sigmoid', 'tanh', 'gelu', 'leaky_relu', 'elu',
    'brelu', 'soft_relu', 'softplus', 'softsign', 'hard_sigmoid',
    'swish',
))

# producer op type -> its primary output slot (the int8 producers are the
# reference's, kept so both packages fuse the same programs alike)
FUSABLE_PRODUCERS = {
    'conv2d': 'Output',
    'depthwise_conv2d': 'Output',
    'conv2d_transpose': 'Output',
    'mul': 'Out',
    'matmul': 'Out',
    'elementwise_add': 'Out',
    'conv2d_int8': 'Output',
    'depthwise_conv2d_int8': 'Output',
    'mul_int8': 'Out',
}


@register_pass
class FuseActivationPass(Pass):
    name = 'fuse_activation'

    def run_on_program(self, program, ctx, report):
        block = program.global_block()
        # names the rewrite must leave observable: fetches + anything a
        # caller asked to preserve
        keep_visible = set(ctx.preserve)
        keep_visible |= set(ctx.fetch_names or ())
        keep_visible |= set(getattr(program, '_fetch_names', ()) or ())
        for op in block.ops:
            if op.type == 'fetch':
                keep_visible |= set(op.input_arg_names())

        # consumer counts over the whole program (sub-block closure reads
        # included): fusing away a var someone else reads would break them
        readers = {}
        for b in program.blocks:
            for op in b.ops:
                for n in op_reads(op, program) if b.idx == 0 \
                        else op.input_arg_names():
                    readers[n] = readers.get(n, 0) + 1

        producer_of = {}  # var name -> (op, slot) for fusable producers
        fused = 0
        out_ops = []
        for op in block.ops:
            t = op.type
            if (t in FUSABLE_ACTS and len(op.input_arg_names()) == 1
                    and len(op.output_arg_names()) == 1):
                x = op.input_arg_names()[0]
                hit = producer_of.get(x)
                if hit is not None and self._fusable(block, x, readers,
                                                     keep_visible):
                    prod, slot = hit
                    out_name = op.output_arg_names()[0]
                    prod.outputs[slot] = [out_name]
                    prod.attrs['fuse_act'] = t
                    prod.attrs['fuse_act_slot'] = slot
                    prod.attrs['fuse_act_attrs'] = {
                        k: v for k, v in op.attrs.items()
                        if not k.startswith('_') and k != 'op_role'}
                    if x in block.vars:
                        del block.vars[x]
                    producer_of.pop(x, None)
                    producer_of.pop(out_name, None)
                    fused += 1
                    continue  # drop the activation op
            # any write invalidates a stale producer entry for that name
            for n in op.output_arg_names():
                producer_of.pop(n, None)
            slot = FUSABLE_PRODUCERS.get(t)
            if slot is not None and 'fuse_act' not in op.attrs:
                names = op.outputs.get(slot, [])
                if len(names) == 1 and names[0]:
                    producer_of[names[0]] = (op, slot)
            out_ops.append(op)
        if fused:
            block.ops = out_ops
        report.details['fused'] = fused

    @staticmethod
    def _fusable(block, name, readers, keep_visible):
        if name in keep_visible or readers.get(name, 0) != 1:
            return False
        v = block._find_var_recursive(name)
        if v is None:
            return True
        return not (v.persistable or getattr(v, 'is_data', False))
