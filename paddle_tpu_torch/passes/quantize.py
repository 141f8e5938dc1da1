"""quantize_program: post-training int8 quantization as an IR pass (the
port's copy of paddle_tpu/passes/quantize.py).

1. **Calibration sweep** (`calibrate_program`): run the inference program
   through the port's Executor over representative feeds and observe every
   quantizable activation edge, abs-max and per-batch percentile
   statistics a tensor, so the pass can take either observer (`mode=
   'abs_max' | 'percentile'`). The edges are the sweep's fetches, which
   keep them alive against the Executor's freeing plan.
2. **Rewrite** (`QuantizeProgramPass`, registered as 'quantize_program'):
   per-channel symmetric int8 weights for conv2d, depthwise_conv2d and mul
   (host-side, from the scope; the int8 weight and its scales become new
   persistable vars), a per-tensor `quantize_int8` op on each activation
   edge, placed by the dataflow analysis's def-use chains (a rebound var
   gets a fresh quantize op), and the dequant in the int8 ops' epilogue
   (ops/quant_ops.py).
3. **Report**: the PassReport names every op left in float with a
   machine-checkable reason code (REASON_* below), and the calibrated
   scales; `report.details['float_ops']` is what the export signature
   carries.

`inference.export_compiled(quantize='int8')` runs this pass and writes the
quantized tier beside the default one.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import Pass, register_pass, PassManager
from . import dataflow as _dataflow

# ops the pass can quantize, with their (activation slot, weight slot,
# weight flatten attr)
QUANTIZABLE = {
    'conv2d': ('Input', 'Filter', None),
    'depthwise_conv2d': ('Input', 'Filter', None),
    'mul': ('X', 'Y', 'y_num_col_dims'),
}
_INT8_TYPE = {'conv2d': 'conv2d_int8',
              'depthwise_conv2d': 'depthwise_conv2d_int8',
              'mul': 'mul_int8'}

# machine-checkable reasons an op stayed in float (the report contract)
REASON_OP_TYPE = 'op_type_unsupported'
REASON_SUB_BLOCK = 'sub_block_op'
REASON_NO_CALIBRATION = 'no_calibration'
REASON_ZERO_RANGE = 'zero_activation_range'
REASON_W_NOT_PERSISTABLE = 'weight_not_persistable'
REASON_W_VALUE_MISSING = 'weight_value_missing'
REASON_W_WRITTEN = 'weight_written_in_program'
REASON_LOD_INPUT = 'lod_input'
REASON_NON_FLOAT = 'non_float_dtype'
REASON_USER_SKIP = 'user_skip'

REASON_CODES = (REASON_OP_TYPE, REASON_SUB_BLOCK, REASON_NO_CALIBRATION,
                REASON_ZERO_RANGE, REASON_W_NOT_PERSISTABLE,
                REASON_W_VALUE_MISSING, REASON_W_WRITTEN,
                REASON_LOD_INPUT, REASON_NON_FLOAT, REASON_USER_SKIP)

# one symmetric-int8 grid and rounding rule everywhere: the runtime ops
# and the host-side weight quantization below share ops/quant_ops'
# constant and quantize_array
from ..ops.quant_ops import QMAX as _QMAX, quantize_array as _q_array


class CalibrationResult(object):
    """Per-tensor activation statistics from a calibration sweep:
    `stats[var] = {'abs_max': float, 'percentile': float, 'q': float,
    'batches': int}`. `percentile` is the max over batches of each
    batch's q-th percentile of |x| — the standard clipping observer that
    shrugs off single-element outliers abs-max would chase."""

    def __init__(self, stats=None, q=99.9):
        self.stats = dict(stats or {})
        self.q = float(q)

    def observe(self, name, arr):
        arr = np.abs(np.asarray(arr, np.float64)).reshape(-1)
        if not arr.size:
            return
        ent = self.stats.setdefault(
            name, {'abs_max': 0.0, 'percentile': 0.0, 'q': self.q,
                   'batches': 0})
        ent['abs_max'] = max(ent['abs_max'], float(arr.max()))
        ent['percentile'] = max(ent['percentile'],
                                float(np.percentile(arr, self.q)))
        ent['batches'] += 1

    def scale(self, name, mode='abs_max'):
        """The int8 scale for `name` under `mode`, or None when the var
        was never observed (or observed all-zero). A bad mode fails fast
        even for unobserved vars — a typo must not masquerade as
        'no_calibration'."""
        if mode not in ('abs_max', 'percentile'):
            raise ValueError("quantize mode must be 'abs_max' or "
                             "'percentile', got %r" % (mode,))
        ent = self.stats.get(name)
        if ent is None:
            return None
        r = float(ent[mode])
        # a clipped-to-zero percentile on a nonzero tensor must not
        # produce a degenerate scale: fall back to the abs-max observer
        if r <= 0.0:
            r = float(ent['abs_max'])
        return (r / _QMAX) if r > 0.0 else 0.0

    def as_dict(self):
        return {'q': self.q, 'stats': {k: dict(v)
                                       for k, v in self.stats.items()}}

    @classmethod
    def from_dict(cls, d):
        return cls(d.get('stats'), d.get('q', 99.9))


def calibration_targets(program, quant_ops=None):
    """Activation input names of every block-0 quantizable op (deduped,
    program order): the tensors a calibration sweep must observe."""
    quant_ops = set(quant_ops or QUANTIZABLE)
    block = program.global_block()
    seen, out = set(), []
    for op in block.ops:
        if op.type not in quant_ops:
            continue
        a_slot = QUANTIZABLE[op.type][0]
        names = op.inputs.get(a_slot) or ()
        for n in names:
            v = block._find_var_recursive(n)
            if v is not None and getattr(v, 'persistable', False):
                continue  # constant input: quantized host-side if at all
            if n not in seen:
                seen.add(n)
                out.append(n)
    return out


def calibrate_program(program, feed_batches, executor, scope=None,
                      quant_ops=None, q=99.9):
    """Run the calibration sweep: execute `program` over every feed in
    `feed_batches` (list of feed dicts) through `executor`, fetching the
    quantizable activation edges, and return a CalibrationResult.

    The sweep runs the unmodified program: the observed ranges describe
    the tensors the quantized program will see. `scope` defaults to the
    global scope (pass the predictor's scope when calibrating a loaded
    model)."""
    from ..core.scope import scope_guard
    import contextlib
    targets = calibration_targets(program, quant_ops)
    result = CalibrationResult(q=q)
    if not targets:
        return result
    ctxm = scope_guard(scope) if scope is not None \
        else contextlib.nullcontext()
    with ctxm:
        for feed in feed_batches:
            outs = executor.run(program, feed=dict(feed),
                                fetch_list=list(targets),
                                return_numpy=True)
            for name, val in zip(targets, outs):
                result.observe(name, val)
    return result


def quantize_weight(w, flatten_cols=None):
    """Per-channel symmetric int8 quantization of one weight array.

    conv filters (OIHW, flatten_cols=None): one scale per OUTPUT channel
    (axis 0). mul weights: one scale per output column of the [K, N]
    flattened form (N = prod(shape[flatten_cols:])). Returns (int8 array
    in the ORIGINAL shape, f32 scales [channels]). All-zero channels get
    scale 1.0 (they dequantize to exact zero either way)."""
    w = np.asarray(w, np.float32)
    if flatten_cols is None:
        flat = w.reshape(w.shape[0], -1)        # [O, I*KH*KW]
        absmax = np.abs(flat).max(axis=1)
        scales = np.where(absmax > 0.0, absmax / _QMAX, 1.0)
        col = scales[:, None]
    else:
        lead = int(np.prod(w.shape[:flatten_cols])) if flatten_cols else 1
        flat = w.reshape(lead, -1)              # [K, N]
        absmax = np.abs(flat).max(axis=0)
        scales = np.where(absmax > 0.0, absmax / _QMAX, 1.0)
        col = scales[None, :]
    q = _q_array(torch.from_numpy(flat),
                 torch.from_numpy(np.ascontiguousarray(col, np.float32)))
    return q.numpy().reshape(w.shape), scales.astype(np.float32)


def _is_float_var(v):
    from ..framework import is_float_dtype
    try:
        return v is not None and is_float_dtype(v.dtype)
    except Exception:
        return False


@register_pass
class QuantizeProgramPass(Pass):
    """Rewrite calibrated conv2d/depthwise_conv2d/mul ops to their int8
    forms. Constructor args:

      calibration   CalibrationResult (or its as_dict) from
                    calibrate_program; None quantizes nothing and
                    reports every candidate as 'no_calibration'.
      scope         Scope holding the weight values (required to
                    quantize anything; new int8 weight + scale vars are
                    written back into it).
      mode          'abs_max' (default) or 'percentile' activation
                    observer.
      skip_vars     activation/weight/output names to keep in float
                    (reported as 'user_skip').
    """

    name = 'quantize_program'

    def __init__(self, calibration=None, scope=None, mode='abs_max',
                 skip_vars=(), quant_ops=None):
        if isinstance(calibration, dict):
            calibration = CalibrationResult.from_dict(calibration)
        self.calibration = calibration
        self.scope = scope
        self.mode = mode
        self.skip_vars = set(skip_vars or ())
        self.quant_ops = set(quant_ops or QUANTIZABLE)

    # -- per-op eligibility -------------------------------------------------
    def _float_reason(self, op, block, dfa, op_idx):
        """None when the op is quantizable right now, else the reason
        code it stays float."""
        if op.type not in QUANTIZABLE or op.type not in self.quant_ops:
            return REASON_OP_TYPE
        a_slot, w_slot, _ = QUANTIZABLE[op.type]
        a_names = op.inputs.get(a_slot) or ()
        w_names = op.inputs.get(w_slot) or ()
        if len(a_names) != 1 or len(w_names) != 1:
            return REASON_OP_TYPE
        x_name, w_name = a_names[0], w_names[0]
        if self.skip_vars & ({x_name, w_name}
                             | set(op.output_arg_names())):
            return REASON_USER_SKIP
        vx = block._find_var_recursive(x_name)
        vw = block._find_var_recursive(w_name)
        if not _is_float_var(vx) or not _is_float_var(vw):
            return REASON_NON_FLOAT
        if int(getattr(vx, 'lod_level', 0) or 0):
            return REASON_LOD_INPUT
        if not getattr(vw, 'persistable', False):
            return REASON_W_NOT_PERSISTABLE
        # def-use: a weight some op WRITES cannot be frozen host-side
        # (its value at this op would differ from the scope snapshot)
        defs, _ = dfa.def_use(w_name)
        if defs:
            return REASON_W_WRITTEN
        if self.scope is None or self.scope.get(w_name) is None:
            return REASON_W_VALUE_MISSING
        if self.calibration is None:
            return REASON_NO_CALIBRATION
        scale = self.calibration.scale(x_name, self.mode)
        if scale is None:
            return REASON_NO_CALIBRATION
        if scale <= 0.0:
            return REASON_ZERO_RANGE
        return None

    # -- the rewrite --------------------------------------------------------
    def run_on_program(self, program, ctx, report):
        from ..framework import Operator

        block = program.global_block()
        dfa = _dataflow.analyze_program(
            program, feed_names=ctx.feed_names, fetch_names=ctx.fetch_names)

        float_ops = []     # every op left in float, with its reason
        act_scales = {}    # activation var -> calibrated scale used
        quantized = 0
        weight_bytes_before = 0
        weight_bytes_after = 0
        # (x_name, def_site) -> quantized var name: the def-use key that
        # makes reuse of a quantized activation SAFE — a consumer after a
        # re-write of x gets a fresh quantize op on the new binding
        q_cache = {}
        # w_name -> {flatten_cols: (wq_name, ws_name)}: a weight SHARED
        # by several quantizable consumers is quantized exactly once per
        # channel axis (bytes counted once per weight); a pathological
        # share across different flatten axes gets one suffixed pair per
        # axis, each also reused by later consumers
        w_done = {}
        new_ops = []

        for idx, op in enumerate(block.ops):
            if op.type in ('feed', 'fetch'):
                new_ops.append(op)
                continue
            reason = self._float_reason(op, block, dfa, idx)
            if reason is not None:
                # only FLOAT-computing ops belong in the kept-in-float
                # report; integer/bookkeeping ops aren't "left in float"
                if any(_is_float_var(block._find_var_recursive(n))
                       for n in op.input_arg_names() + op.output_arg_names()):
                    float_ops.append({'op_index': idx, 'block': 0,
                                      'type': op.type, 'reason': reason})
                new_ops.append(op)
                continue

            a_slot, w_slot, flat_attr = QUANTIZABLE[op.type]
            x_name = op.inputs[a_slot][0]
            w_name = op.inputs[w_slot][0]
            scale = self.calibration.scale(x_name, self.mode)
            act_scales[x_name] = float(scale)

            # -- weight: host-side per-channel quant (once per weight
            # and channel axis) -------------------------------------------
            flatten_cols = (int(op.attrs.get(flat_attr, 1) or 1)
                            if flat_attr else None)
            variants = w_done.setdefault(w_name, {})
            if flatten_cols in variants:
                wq_name, ws_name = variants[flatten_cols]
            else:
                w_val = self.scope.get(w_name)
                w_arr = w_val.detach().cpu().numpy()
                wq, ws = quantize_weight(w_arr, flatten_cols)
                suffix = '' if not variants else '.f%d' % idx
                wq_name = w_name + '.int8' + suffix
                ws_name = w_name + '.scale' + suffix
                block.create_var(name=wq_name, shape=list(w_arr.shape),
                                 dtype='int8', persistable=True,
                                 stop_gradient=True)
                block.create_var(name=ws_name, shape=[int(ws.shape[0])],
                                 dtype='float32', persistable=True,
                                 stop_gradient=True)
                self.scope.set(wq_name, torch.from_numpy(wq).to(w_val.device))
                self.scope.set(ws_name, torch.from_numpy(ws).to(w_val.device))
                if not variants:  # count each weight's bytes ONCE
                    weight_bytes_before += w_arr.nbytes
                variants[flatten_cols] = (wq_name, ws_name)
                weight_bytes_after += wq.nbytes + ws.nbytes

            # -- activation: one quantize_int8 per (var, def site) ----------
            def_site = dfa.last_writer(x_name, before=idx)
            key = (x_name, def_site)
            xq_name = q_cache.get(key)
            if xq_name is None:
                xq_name = x_name + '.q8'
                if block.has_var_local(xq_name):  # rebound upstream var
                    xq_name = '%s.q8.%d' % (x_name, idx)
                vx = block._find_var_recursive(x_name)
                block.create_var(name=xq_name,
                                 shape=list(getattr(vx, 'shape', None)
                                            or []) or None,
                                 dtype='int8', stop_gradient=True)
                new_ops.append(Operator(
                    block, 'quantize_int8', {'X': [x_name]},
                    {'Out': [xq_name]}, {'scale': float(scale)}))
                q_cache[key] = xq_name

            # -- the op itself: int8 form, dequant fused in its epilogue ----
            op.type = _INT8_TYPE[op.type]
            new_inputs = dict(op.inputs)
            new_inputs[a_slot] = [xq_name]
            new_inputs[w_slot] = [wq_name]
            new_inputs['Scale'] = [ws_name]
            op.inputs = new_inputs
            op.attrs['in_scale'] = float(scale)
            new_ops.append(op)
            quantized += 1

        block.ops = new_ops

        # a replaced f32 weight no op touches anymore leaves the program
        # (the export must not save it); its scope value stays: the default
        # tier and the caller's checkpoint still own the float weights
        from .base import op_reads, op_writes
        still_used = set()
        for b in program.blocks:
            for op in b.ops:
                still_used |= op_reads(op, program)
                still_used |= op_writes(op, program)
        pruned = 0
        for w_name in w_done:
            if w_name not in still_used and block.has_var_local(w_name):
                del block.vars[w_name]
                pruned += 1

        # sub-block candidates stay float: the rewrite is block-0-linear
        # (control-flow bodies re-enter per iteration; a stale quantized
        # binding there is not provable safe with linear def-use)
        for b in program.blocks[1:]:
            for idx, op in enumerate(b.ops):
                if op.type in QUANTIZABLE:
                    float_ops.append({'op_index': idx, 'block': b.idx,
                                      'type': op.type,
                                      'reason': REASON_SUB_BLOCK})

        reasons = {}
        for e in float_ops:
            reasons[e['reason']] = reasons.get(e['reason'], 0) + 1
        report.details.update({
            'mode': self.mode,
            'quantized_ops': quantized,
            'float_ops': float_ops,
            'float_op_reasons': reasons,
            'act_scales': {k: round(v, 10) for k, v in act_scales.items()},
            'weight_bytes_before': int(weight_bytes_before),
            'weight_bytes_after': int(weight_bytes_after),
            'float_weights_pruned': pruned,
        })


def quantize_program(program, calibration, scope, mode='abs_max',
                     fetch_names=None, feed_names=None, skip_vars=(),
                     inplace=False):
    """One-call form: apply QuantizeProgramPass and return
    (quantized_program, PassReport). The returned report's
    details['float_ops'] names every op left in float with a
    machine-checkable reason code (REASON_CODES)."""
    p = QuantizeProgramPass(calibration=calibration, scope=scope,
                            mode=mode, skip_vars=skip_vars)
    prog, reports = PassManager([p]).apply(
        program, fetch_names=fetch_names, feed_names=feed_names,
        inplace=inplace)
    return prog, reports[0]
