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

`export_train_step` (read by serve.py CompiledTrainer):

  train_signature.json    feeds, fetches, state {name, shape, dtype}, the
                          AMP mark and the seed root
  train_program.json      the train program as JSON
  train_state0.npz        every persistable the program reads or writes

`export_decode` (read by inference/decoding.py DecodingPredictor; each
program after the inference pipeline, as `export_compiled`'s):

  decode_signature.json   kind, layout, slots, cache length, buckets,
                          eos and vocab, the cache state and every
                          program's feeds and fetches (the reference's
                          keys where they mean the same thing)
  decode_step/__model__   the decode-step program, as JSON
                          (io.program_to_dict, with feed and fetch names)
  prefill_<L>/__model__   one prefill program per prompt bucket L
  params/                 every parameter once (io.save_vars: one file
                          per var and a manifest), the cache vars left
                          out: the server makes them zero

No AOT sidecar (`precompile=`) and no reorder program: the port
interprets the programs, and a beam reorder is an index copy over the
slot axis of each cache tensor (DecodingPredictor._dispatch_reorder).

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


def export_decode(spec, out_dir, scope=None):
    """Write the decode-serving artifact of `spec` (the dict
    models.transformer.build_decode_spec returns) to out_dir, the
    parameters taken from `scope` (default: the global scope), where the
    spec's startup program must have run. Feeds are checked as the
    reference checks them: the step takes 'tokens' [S, 1] int64 and 'pos'
    [S, 1] int32 and fetches the logits [S, vocab]; each prefill takes
    'prompt_ids' [1, L] int64, 'prompt_len' and 'slot' [1, 1] int32 and
    fetches the last real position's logits [1, vocab]. The slot layout
    with an f32 cache only: another layout or cache dtype raises
    NotImplementedError. Returns out_dir."""
    scope = scope if scope is not None else global_scope()
    layout = spec.get('layout', 'slot')
    kv_dtype = spec.get('kv_cache_dtype', 'float32')
    if layout != 'slot' or kv_dtype != 'float32' or 'verify' in spec:
        raise NotImplementedError(
            'export_decode: the port exports the slot layout with an f32 '
            'cache and no verify program; got layout %r, kv_cache_dtype '
            '%r%s' % (layout, kv_dtype,
                      ', a verify program' if 'verify' in spec else ''))
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
    if sorted(step['feeds']) != ['pos', 'tokens']:
        raise ValueError("decode-step feeds must be ['pos', 'tokens'], "
                         "got %r" % (step['feeds'],))
    buckets = sorted(int(b) for b in spec['prefill'])
    if not buckets:
        raise ValueError("export_decode needs at least one prompt bucket")
    os.makedirs(out_dir, exist_ok=True)
    step_feeds = _write_program(step, os.path.join(out_dir,
                                                   _decoding._STEP_DIR),
                                state_names)
    prefill_sig = {}
    programs = [step['program']]
    for L in buckets:
        p = spec['prefill'][L]
        if sorted(p['feeds']) != ['prompt_ids', 'prompt_len', 'slot']:
            raise ValueError(
                "prefill feeds must be ['prompt_ids', 'prompt_len', "
                "'slot'], got %r" % (p['feeds'],))
        prefill_sig[str(L)] = {
            'feeds': _write_program(
                p, os.path.join(out_dir, _decoding._PREFILL_DIR % L),
                state_names),
            'fetches': list(p['fetches'])}
        programs.append(p['program'])

    params = {}
    for prog in programs:
        for v in prog.list_vars():
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

    sig = {'version': 1, 'format': _decoding._FORMAT, 'kind': 'decode',
           'layout': 'slot',
           'max_slots': int(spec['max_slots']),
           'max_cache_len': int(spec['max_cache_len']),
           'eos_id': int(spec['eos_id']), 'vocab': int(spec['vocab']),
           'kv_cache_dtype': kv_dtype,
           'cache_bytes': int(sum(t.numel() * t.element_size()
                                  for t in state)),
           'state': [{'name': n, 'shape': list(t.shape),
                      'dtype': convert_dtype(t.dtype)}
                     for n, t in zip(state_names, state)],
           'params': sorted(params),
           'step': {'feeds': step_feeds, 'fetches': list(step['fetches'])},
           'prompt_buckets': buckets,
           'prefill': prefill_sig}
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


def _export_tier(predictor, program, sample, out_dir, sizes, reports=()):
    """The artifact tree: one signature when `sizes` is None, else one per
    bucket under bucket_<n>/ and a top signature mirroring the largest
    bucket, with the bucket list. The top signature records the
    pipeline's `reports` (PassReport.as_dict of each pass, in order;
    empty where the pipeline fell back to the raw program) under
    'passes'."""
    _write_model(predictor, program, out_dir)
    passes_run = [r.as_dict() for r in reports]
    if sizes is None:
        return _export_single(predictor, program, sample, out_dir,
                              extra={'passes': passes_run})
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
                             root='..')
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

    quantize='int8' (the reference's post-training int8 tier) is not
    ported yet (ROADMAP.md queue 1 item 6) and raises
    NotImplementedError; `calibration`, `quantize_mode` and
    `calibration_q` belong to it. Returns out_dir."""
    if quantize is not None:
        if quantize != 'int8':
            raise ValueError("quantize must be None or 'int8', got %r"
                             % (quantize,))
        raise NotImplementedError(
            "export_compiled(quantize='int8'): the post-training int8 tier "
            "is not ported yet (ROADMAP.md queue 1 item 6)")
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
    program, reports = _optimize_for_export(
        program, [v.name for v in predictor._fetch_vars if v is not None],
        feed_names)
    _export_tier(predictor, program, sample, out_dir, sizes, reports)
    return out_dir


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
