"""Artifact export (ref: paddle_tpu/inference/export.py): the serving
artifact of `export_compiled`, the training artifact of
`export_train_step`, and the decode-serving artifact of `export_decode`.

torch cannot load the reference's jax.export modules and the port
compiles nothing, so the port has its own artifact formats. Each holds
the program as JSON and its parameters or state once, beside a signature
with the reference's keys and 'format': 'paddle_tpu_torch'.

`export_compiled` (read by serve.py CompiledPredictor and batching.py
BatchingPredictor):

  signature.json          version 3: feeds {name, shape, dtype}, fetches
                          {name, lod_levels, shape}, tier; 'buckets' in a
                          multi-bucket artifact, whose top level mirrors
                          the largest bucket
  __model__               the predictor's program as JSON, with feed and
                          fetch names (written once)
  params/                 its persistables (io.save_vars; written once)
  bucket_<n>/signature.json   one per batch bucket, with 'root': '..':
                          a bucket directory loads on its own, from the
                          root's program and parameters
  int8/                   with quantize='int8': the quantized tier, a
                          tree of the same layout ('tier': 'int8' and
                          'quantization' in each signature); the top
                          signature then lists 'tiers'

`export_train_step` (read by serve.py CompiledTrainer):

  train_signature.json    feeds, fetches, state {name, shape, dtype}, the
                          AMP mark and the seed root
  train_program.json      the train program as JSON
  train_state0.npz        every persistable the program reads or writes

`export_decode` (read by inference/decoding.py DecodingPredictor; each
program after the inference pipeline, as `export_compiled`'s):

  decode_signature.json   kind, layout, slots, cache length, eos and
                          vocab, the cache dtype and bytes, the cache state
                          (an int8 cache: int8 pages and f32 scales) and
                          every program's feeds
                          and fetches (the reference's keys where they
                          mean the same thing): 'prompt_buckets' and
                          'prefill' in the slot layout; 'block',
                          'chunk_buckets' and 'chunk' in the block layout;
                          'verify' with a verify program
  decode_step/__model__   the decode-step program, as JSON
                          (io.program_to_dict, with feed and fetch names)
  prefill_<L>/__model__   slot layout: one prefill program per prompt
                          bucket L
  prefill_chunk_<C>/__model__   block layout: one chunked-prefill program
                          per chunk size C
  decode_verify/__model__ the speculative verify program, where the spec
                          has one (build_decode_spec(draft_k=K))
  params/                 every parameter once (io.save_vars: one file
                          per var and a manifest), the cache vars left
                          out: the server makes them zero

No AOT sidecar (`precompile=`), no reorder and no block-copy program: the
port interprets the programs, a beam reorder is an index copy over the
slot axis of each cache tensor (DecodingPredictor._dispatch_reorder), and
a copy on write one over the pool's block axis
(DecodingPredictor._dispatch_blockcopy).

`export_compiled` writes the predictor's program after the passes'
inference pipeline (_optimize_for_export: verify, constant_fold,
dead_op_elimination rooted at the fetches, horizontal_fuse,
fuse_activation), and each bucket's signature carries `peak_bytes_est`,
the static peak of passes/dataflow.py at that bucket's batch
(paddle_tpu/inference/export.py:731-787, 878-883); the top signature
records what each pass did ('passes'). `export_decode` runs its programs
through the same pipeline. As in the reference, a pipeline that fails
leaves the raw program with a RuntimeWarning, and a strict-verify error
(PTPU_STRICT_VERIFY=1) propagates.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from .. import io as _io
from ..core import amp, config as _config
from ..core.lowering import Interpreter
from ..core.registry import META
from ..core.scope import global_scope, scope_guard
from ..executor import _to_numpy
from ..framework import Variable, convert_dtype, to_torch_dtype
from . import decoding as _decoding
from . import serve as _serve

# the quantized tier's subdirectory of an export_compiled artifact
_TIER_INT8 = 'int8'


def _write_program(entry, out_dir, state_names=()):
    """One program's JSON (with its feed and fetch names) under out_dir,
    after the inference pipeline, whose liveness roots include the cache
    state (its in-place writes are outputs though nothing fetches them;
    paddle_tpu/inference/export.py:626-642); returns the feed signature
    entries (name, shape, dtype)."""
    program, _ = _optimize_for_export(
        entry['program'], list(entry['fetches']) + list(state_names),
        list(entry['feeds']))
    d = _io.program_to_dict(program)
    d['feed_names'] = list(entry['feeds'])
    d['fetch_names'] = list(entry['fetches'])
    os.makedirs(out_dir, exist_ok=True)
    with _io._atomic_file(os.path.join(out_dir,
                                       _decoding._PROGRAM_FILE)) as f:
        f.write(json.dumps(d).encode())
    samples = {n: np.asarray(entry['samples'][n]) for n in entry['feeds']}
    return [{'name': n, 'shape': list(samples[n].shape),
             'dtype': samples[n].dtype.name} for n in entry['feeds']]


def _check_feeds(what, entry, want):
    if sorted(entry['feeds']) != sorted(want):
        raise ValueError("%s feeds must be %r, got %r"
                         % (what, sorted(want), entry['feeds']))


def export_decode(spec, out_dir, scope=None, kv_cache_dtype=None):
    """Write the decode-serving artifact of `spec` (the dict
    models.transformer.build_decode_spec returns) to out_dir, the
    parameters taken from `scope` (default: the global scope), where the
    spec's startup program must have run. Feeds are checked as the
    reference checks them: the step takes 'tokens' [S, 1] int64 and 'pos'
    [S, 1] int32 (and 'block_tables' [S, max_blocks] int32 in the block
    layout) and fetches the logits [S, vocab]; a verify program takes the
    step's feed names at [S, K+1]. In the slot layout each prefill takes
    'prompt_ids' [1, L] int64, 'prompt_len' and 'slot' [1, 1] int32; in
    the block layout each chunk program 'chunk_ids' [1, C] int64, 'start'
    and 'chunk_len' [1, 1] int32 and 'block_table' [1, max_blocks] int32;
    both fetch the last real position's logits [1, vocab].

    kv_cache_dtype: None, or the cache dtype the caller expects; it must
    be the one the spec was built with (build_decode_spec(kv_cache_dtype=),
    paddle_tpu/inference/export.py:388-392). The signature records it, the
    cache's bytes and each state var's shape and dtype (an int8 cache's
    pages are int8, its scales f32). Returns out_dir."""
    scope = scope if scope is not None else global_scope()
    layout = spec.get('layout', 'slot')
    kv_dtype = spec.get('kv_cache_dtype', 'float32')
    if kv_cache_dtype is not None and kv_cache_dtype != kv_dtype:
        raise ValueError(
            "export_decode(kv_cache_dtype=%r) but the spec was built with "
            "kv_cache_dtype=%r — rebuild the decode spec with the requested "
            "cache dtype (build_decode_spec(kv_cache_dtype=...))"
            % (kv_cache_dtype, kv_dtype))
    if layout not in ('slot', 'block'):
        raise ValueError("layout must be 'slot' or 'block', got %r"
                         % (layout,))
    block = layout == 'block'
    state_names = list(spec['cache_vars'])
    state = []
    for n in state_names:
        val = scope.get(n)
        if val is None:
            raise ValueError(
                "cache var %r has no value in the scope — run the spec's "
                "startup program before export_decode" % n)
        state.append(val)
    step = spec['step']
    step_want = ['tokens', 'pos'] + (['block_tables'] if block else [])
    _check_feeds('decode-step', step, step_want)
    programs = {'step': step}
    if 'verify' in spec:
        _check_feeds('decode-verify', spec['verify'], step_want)
        programs['verify'] = spec['verify']
    if block:
        sizes = sorted(int(c) for c in spec['chunk'])
        if not sizes:
            raise ValueError("block-layout export needs at least one "
                             "chunk size")
        for C in sizes:
            _check_feeds('chunk', spec['chunk'][C],
                         ['chunk_ids', 'start', 'chunk_len', 'block_table'])
    else:
        sizes = sorted(int(b) for b in spec['prefill'])
        if not sizes:
            raise ValueError("export_decode needs at least one prompt "
                             "bucket")
        for L in sizes:
            _check_feeds('prefill', spec['prefill'][L],
                         ['prompt_ids', 'prompt_len', 'slot'])
    os.makedirs(out_dir, exist_ok=True)
    sig = {'version': 1, 'format': _decoding._FORMAT, 'kind': 'decode',
           'layout': layout,
           'max_slots': int(spec['max_slots']),
           'max_cache_len': int(spec['max_cache_len']),
           'eos_id': int(spec['eos_id']), 'vocab': int(spec['vocab']),
           'kv_cache_dtype': kv_dtype,
           'cache_bytes': int(sum(t.numel() * t.element_size()
                                  for t in state)),
           'state': [{'name': n, 'shape': list(t.shape),
                      'dtype': convert_dtype(t.dtype)}
                     for n, t in zip(state_names, state)]}
    sig['step'] = {
        'feeds': _write_program(step, os.path.join(
            out_dir, _decoding._STEP_DIR), state_names),
        'fetches': list(step['fetches'])}
    if 'verify' in programs:
        v = programs['verify']
        sig['verify'] = {
            'feeds': _write_program(v, os.path.join(
                out_dir, _decoding._VERIFY_DIR), state_names),
            'fetches': list(v['fetches']),
            'draft_k': int(spec['draft_k'])}
    entries = {}
    for n in sizes:
        e = spec['chunk' if block else 'prefill'][n]
        d = (_decoding._CHUNK_DIR if block else _decoding._PREFILL_DIR) % n
        entries[str(n)] = {
            'feeds': _write_program(e, os.path.join(out_dir, d),
                                    state_names),
            'fetches': list(e['fetches'])}
        programs[d] = e
    if block:
        sig['block'] = {'block_size': int(spec['block_size']),
                        'num_blocks': int(spec['num_blocks']),
                        'max_blocks_per_slot':
                            int(spec['max_blocks_per_slot'])}
        sig['chunk_buckets'] = sizes
        sig['chunk'] = entries
    else:
        sig['prompt_buckets'] = sizes
        sig['prefill'] = entries

    params = {}
    for e in programs.values():
        for v in e['program'].list_vars():
            if v.persistable and v.name not in state_names:
                params.setdefault(v.name, v)
    missing = sorted(n for n in params if scope.get(n) is None)
    if missing:
        raise ValueError("parameters %r have no value in the scope — run "
                         "the spec's startup program before export_decode"
                         % missing)
    with scope_guard(scope):
        _io.save_vars(None, os.path.join(out_dir, _decoding._PARAMS_DIR),
                      vars=[params[n] for n in sorted(params)])
    sig['params'] = sorted(params)
    with _io._atomic_file(os.path.join(out_dir,
                                       _decoding._DECODE_SIGNATURE)) as f:
        f.write(json.dumps(sig, indent=1).encode())
    return out_dir


# -- export_compiled ---------------------------------------------------------
def _write_model(predictor, program, out_dir):
    """The program as JSON (with feed and fetch names) and its
    persistables under out_dir: written once per artifact."""
    d = _io.program_to_dict(program)
    d['feed_names'] = list(predictor._feed_names)
    d['fetch_names'] = [v.name for v in predictor._fetch_vars]
    os.makedirs(out_dir, exist_ok=True)
    with _io._atomic_file(os.path.join(out_dir, _serve._PROGRAM_FILE)) as f:
        f.write(json.dumps(d).encode())
    with scope_guard(predictor._scope):
        _io.save_vars(None, os.path.join(out_dir, _serve._PARAMS_DIR),
                      main_program=program, predicate=_io.is_persistable)


def _fetch_shapes(predictor, program, sample):
    """Each fetch's shape at this sample's feed shapes: the program run on
    the 'meta' device (shapes and dtypes, no data), as the reference's
    export trace records them."""
    block = program.global_block()
    env = {}
    for v in program.list_vars():
        val = predictor._scope.get(v.name) if v.persistable else None
        if val is not None:
            env[v.name] = torch.empty(val.shape, dtype=val.dtype,
                                      device=META)
    for n, a in sample.items():
        env[n] = torch.empty(a.shape, dtype=to_torch_dtype(
            block.var(n).dtype), device=META)
    with torch.no_grad(), amp.scope(getattr(program, '_amp_bf16', False)):
        Interpreter(program, META, env).run_block(block)
    return [list(env[v.name].shape) for v in predictor._fetch_vars]


def _optimize_for_export(program, fetch_names, feed_names):
    """Run the inference pipeline (passes/) on `program` before it is
    written, rooted at `fetch_names`: constant chains fold, dead branches
    drop, sibling convs widen and activations fuse into their producers.
    Falls back to the raw program with a RuntimeWarning if the pipeline
    fails (export must never fail on an optimizer bug); strict-verify
    errors (PTPU_STRICT_VERIFY=1) propagate. Returns (program, reports),
    the reports empty after a fallback."""
    from .. import passes
    try:
        return passes.apply_inference_pipeline(
            program, fetch_names=list(fetch_names),
            feed_names=list(feed_names))
    except passes.ProgramVerifyError:
        raise
    except Exception as e:
        import warnings
        warnings.warn(
            "export optimization pipeline failed (%s: %s); exporting the "
            "unoptimized program" % (type(e).__name__, e), RuntimeWarning)
        return program, []


def _peak_bytes_est(program, feed_names, fetch_names, feed_sig):
    """Static peak-memory estimate of one export bucket, from the
    dataflow analyzer at the bucket's batch (the largest leading dim
    across the feeds). None when estimation declines — the signature must
    never fail an export over an analysis bug."""
    try:
        from ..passes import dataflow as _dataflow
        batch = 1
        for e in feed_sig:
            shp = e.get('shape') or ()
            if shp:
                batch = max(batch, int(shp[0]))
        dfa = _dataflow.analyze_program(program, feed_names=feed_names,
                                        fetch_names=fetch_names)
        return int(dfa.peak_memory(batch=batch).peak_bytes)
    except Exception:
        return None


def _export_single(predictor, program, sample, out_dir, root='.',
                   extra=None):
    """One fixed-shape signature under out_dir (the program and parameters
    are at `root`, relative to out_dir), with the keys of `extra` added;
    `sample` is {feed name: numpy array}."""
    feed_sig = [{'name': n, 'shape': list(sample[n].shape),
                 'dtype': sample[n].dtype.name}
                for n in predictor._feed_names]
    fetch_sig = [{'name': v.name, 'lod_levels': 0, 'shape': shape}
                 for v, shape in zip(predictor._fetch_vars,
                                     _fetch_shapes(predictor, program,
                                                   sample))]
    # 'bf16' is the reference's name of the default (unquantized) tier
    sig = {'version': 3, 'format': _serve._FORMAT, 'feeds': feed_sig,
           'fetches': fetch_sig, 'tier': 'bf16'}
    est = _peak_bytes_est(program, list(predictor._feed_names),
                          [v.name for v in predictor._fetch_vars], feed_sig)
    if est is not None:
        sig['peak_bytes_est'] = est
    if root != '.':
        sig['root'] = root
    sig.update(extra or {})
    os.makedirs(out_dir, exist_ok=True)
    with _io._atomic_file(os.path.join(out_dir, _serve._SIGNATURE)) as f:
        f.write(json.dumps(sig, indent=1).encode())
    return sig


def _export_tier(predictor, program, sample, out_dir, sizes, reports=(),
                 extra_sig=None):
    """The artifact tree: one signature when `sizes` is None, else one per
    bucket under bucket_<n>/ and a top signature mirroring the largest
    bucket, with the bucket list. The top signature records the
    pipeline's `reports` (PassReport.as_dict of each pass, in order;
    empty where the pipeline fell back to the raw program) under
    'passes'; every signature gets the keys of `extra_sig`."""
    _write_model(predictor, program, out_dir)
    passes_run = [r.as_dict() for r in reports]
    if sizes is None:
        return _export_single(predictor, program, sample, out_dir,
                              extra=dict(extra_sig or {},
                                         passes=passes_run))
    flat = [n for n, a in sample.items() if a.ndim < 1]
    if flat:
        raise ValueError("feeds %r have no batch dimension to bucket on"
                         % flat)
    lead = {a.shape[0] for a in sample.values()}
    if len(lead) != 1:
        raise ValueError(
            "multi-bucket export needs one uniform leading batch dim; "
            "sample feeds disagree: %s" % sorted(lead))
    for b in sizes:
        # np.resize tiles the sample rows up or down to the bucket: only
        # shapes and dtypes matter for a signature
        resized = {n: np.resize(a, (b,) + a.shape[1:])
                   for n, a in sample.items()}
        sig = _export_single(predictor, program, resized,
                             os.path.join(out_dir, _serve._BUCKET_DIR % b),
                             root='..', extra=extra_sig)
    sig.pop('root')
    sig['buckets'] = sizes
    sig['passes'] = passes_run
    with _io._atomic_file(os.path.join(out_dir, _serve._SIGNATURE)) as f:
        f.write(json.dumps(sig, indent=1).encode())
    return sig


def export_compiled(predictor, sample_inputs, out_dir, batch_sizes=None,
                    quantize=None, calibration=None,
                    quantize_mode='abs_max', calibration_q=99.9):
    """Export `predictor`'s program (a Predictor's), after the passes'
    inference pipeline (_optimize_for_export), as a serving artifact for
    CompiledPredictor and BatchingPredictor; each signature records the
    bucket's static `peak_bytes_est`, and the top signature the
    pipeline's reports under 'passes'.

    sample_inputs: list (feed order) or dict of arrays fixing shapes and
    dtypes. Dense feeds only: a LoD feed raises NotImplementedError
    (ROADMAP.md queue 1 item 8).

    batch_sizes: optional batch buckets (e.g. [1, 8, 32, 128]) for a
    multi-bucket artifact: a signature per bucket under
    out_dir/bucket_<n>/, the top level mirroring the largest, the program
    and parameters written once for all of them.

    quantize='int8' (paddle_tpu/inference/export.py:120-134): also write a
    post-training-quantized tier under out_dir/int8/, a whole artifact tree
    of its own (the same buckets, its own program and parameters) whose
    program went through passes/quantize.py (calibrated per-tensor
    activation quant, per-channel int8 weights, the dequant in the int8
    ops' epilogue) and then the inference pipeline. `calibration` is
    required: a list of representative feed batches (dicts, or lists in
    feed order) run through the predictor's Executor to observe the
    activation ranges; `quantize_mode` picks the observer ('abs_max' or
    'percentile', the latter at `calibration_q`). Each signature of the
    tier carries 'tier': 'int8' and 'quantization' (the quantized op count,
    every op left in float with its reason, the activation scales, the
    weight bytes before and after); the top signature records 'tiers':
    ['bf16', 'int8'] and the same 'quantization'. CompiledPredictor and
    BatchingPredictor serve it with tier='int8'. A later export without
    quantize removes a stale int8 tree. Returns out_dir."""
    if quantize is not None and quantize != 'int8':
        raise ValueError("quantize must be None or 'int8', got %r"
                         % (quantize,))
    feed_names = list(predictor._feed_names)
    if isinstance(sample_inputs, (list, tuple)):
        sample = dict(zip(feed_names, sample_inputs))
    else:
        sample = dict(sample_inputs)
    missing = [n for n in feed_names if n not in sample]
    if missing:
        raise ValueError("sample_inputs missing feeds: %r" % missing)
    program = predictor._program
    for name in feed_names:
        v = program.global_block().var(name)
        if int(getattr(v, 'lod_level', 0) or 0) or isinstance(
                sample[name], tuple):
            raise NotImplementedError(
                "export_compiled: feed %r carries a LoD; LoD artifacts are "
                "not ported yet (ROADMAP.md queue 1 item 8)" % name)
    sample = {n: np.asarray(sample[n]) for n in feed_names}
    sizes = None
    if batch_sizes is not None:
        sizes = sorted({int(b) for b in batch_sizes})
        if not sizes or sizes[0] < 1:
            raise ValueError("batch_sizes must be positive ints, got %r"
                             % (batch_sizes,))
    if quantize is not None:
        qprogram, qreports, quant_meta = _quantize_for_export(
            predictor, calibration, quantize_mode, calibration_q)
    program, reports = _optimize_for_export(
        program, [v.name for v in predictor._fetch_vars if v is not None],
        feed_names)
    _export_tier(predictor, program, sample, out_dir, sizes, reports)
    tier_dir = os.path.join(out_dir, _TIER_INT8)
    if quantize is None:
        # a stale int8 tree would serve old quantized weights beside the
        # fresh default tier; a tree without a signature (an interrupted
        # export) goes too
        if os.path.isdir(tier_dir):
            import warnings
            warnings.warn('export_compiled: removing stale int8 tier %s (this '
                          "export did not request quantize='int8')"
                          % tier_dir, RuntimeWarning)
            shutil.rmtree(tier_dir)
        return out_dir
    _export_tier(predictor, qprogram, sample, tier_dir, sizes, qreports,
                 extra_sig={'tier': 'int8', 'quantization': quant_meta})
    sig_path = os.path.join(out_dir, _serve._SIGNATURE)
    with open(sig_path) as f:
        sig = json.load(f)
    sig['tiers'] = ['bf16', 'int8']
    sig['quantization'] = quant_meta
    with _io._atomic_file(sig_path) as f:
        f.write(json.dumps(sig, indent=1).encode())
    return out_dir


def _quantize_for_export(predictor, calibration, mode, q):
    """Calibrate and quantize the predictor's program for the int8 tier
    (paddle_tpu/inference/export.py:261-307): the sweep runs through the
    predictor's own Executor and scope, and the quantized program then
    goes through the inference pipeline. Returns (program, the pipeline's
    reports, the signature's 'quantization')."""
    from .. import passes
    if not calibration:
        raise ValueError(
            "quantize='int8' requires calibration=[feed batches...]: a "
            "representative sweep is what defines the activation scales "
            "(passes/quantize.calibrate_program)")
    feed_names = list(predictor._feed_names)
    fetch_names = [v.name for v in predictor._fetch_vars if v is not None]
    batches = [dict(zip(feed_names, b)) if isinstance(b, (list, tuple))
               else dict(b) for b in calibration]
    calib = passes.calibrate_program(
        predictor._program, batches, predictor._exe,
        scope=predictor._scope, q=q)
    qprog, report = passes.quantize_program(
        predictor._program, calib, predictor._scope, mode=mode,
        fetch_names=fetch_names, feed_names=feed_names)
    qprog, reports = _optimize_for_export(qprog, fetch_names, feed_names)
    d = report.details
    meta = {'method': 'post_training_int8', 'mode': d['mode'],
            'percentile_q': float(q), 'calibration_batches': len(batches),
            'quantized_ops': d['quantized_ops'],
            'float_ops': d['float_ops'],
            'float_op_reasons': d['float_op_reasons'],
            'act_scales': d['act_scales'],
            'weight_bytes_before': d['weight_bytes_before'],
            'weight_bytes_after': d['weight_bytes_after']}
    return qprog, reports, meta


# -- export_train_step -------------------------------------------------------
def export_train_step(program, sample_inputs, fetch_list, out_dir,
                      scope=None, seed=None):
    """Export a train step (forward, backward and optimizer update) as a
    training artifact for CompiledTrainer.

    program: the built train program (optimizer applied; its AMP mark,
    `program._amp_bf16`, is kept). sample_inputs: {name: array} fixing
    the feed shapes and dtypes. fetch_list: Variables or names fetched
    each step (put the loss here). scope: where the startup program ran
    (default: the global scope); every persistable the program reads or
    writes becomes the artifact's initial state. seed: the random draws'
    root (default program.random_seed, else 1234567 under
    FLAGS_deterministic, else the process's entropy root, as the
    Executor falls back): CompiledTrainer's steps draw what the
    Executor's would. Gradient-merge programs and LoD feeds or fetches
    are refused, as in the reference. Returns out_dir."""
    if int(getattr(program, '_grad_accum_k', 1) or 1) > 1:
        raise ValueError(
            "export_train_step does not support gradient-merge programs; "
            "export the k=1 form and accumulate in the serving loop")
    scope = scope if scope is not None else global_scope()
    sample = {n: np.asarray(v) for n, v in dict(sample_inputs).items()}
    feed_names = sorted(sample)
    fetch_names = [f.name if isinstance(f, Variable) else str(f)
                   for f in fetch_list]
    block = program.global_block()
    for name in feed_names:
        v = block._find_var_recursive(name)
        if v is not None and getattr(v, 'lod_level', 0):
            raise ValueError(
                "export_train_step serves dense tensors only; feed %r is "
                "a LoD tensor" % name)
    for name in fetch_names:
        v = block._find_var_recursive(name)
        if v is not None and getattr(v, 'lod_level', 0):
            raise ValueError(
                "export_train_step fetches must be dense; %r carries lod "
                "— fetch the loss or a dense metric" % name)
    persist = {v.name for v in program.list_vars() if v.persistable}
    written = {n for op in block.ops for n in op.output_arg_names()
               if n in persist}
    state = {n: _to_numpy(scope.get(n)) for n in sorted(persist)
             if scope.get(n) is not None}
    extra = sorted(written - set(state))
    if extra:
        raise ValueError(
            "train-step state %r is written by the program but absent "
            "from the scope — run the startup program before export so "
            "every optimizer slot is materialized" % (extra,))
    if seed is None:
        seed = _config.step_seed(program)
    d = _io.program_to_dict(program)
    d['feed_names'] = feed_names
    d['fetch_names'] = fetch_names
    os.makedirs(out_dir, exist_ok=True)
    with _io._atomic_file(os.path.join(out_dir, _serve._TRAIN_PROGRAM)) as f:
        f.write(json.dumps(d).encode())
    sig = {'version': 1, 'format': _serve._FORMAT,
           'feeds': [{'name': n, 'shape': list(sample[n].shape),
                      'dtype': sample[n].dtype.name} for n in feed_names],
           'fetches': fetch_names,
           'state': [{'name': n, 'shape': list(a.shape),
                      'dtype': a.dtype.name} for n, a in state.items()],
           'rng': {'seed': int(seed)},
           'amp_bf16': bool(getattr(program, '_amp_bf16', False))}
    with _io._atomic_file(os.path.join(out_dir,
                                       _serve._TRAIN_SIGNATURE)) as f:
        f.write(json.dumps(sig, indent=1).encode())
    np.savez(os.path.join(out_dir, _serve._TRAIN_STATE0), **state)
    return out_dir
