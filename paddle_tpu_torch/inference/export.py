"""Decode-serving artifacts (ref: paddle_tpu/inference/export.py:348
export_decode).

torch cannot load the reference's jax.export modules, so the port has its
own artifact format, read by inference/decoding.py DecodingPredictor:

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

No AOT sidecar and no reorder program: the port interprets the programs,
and a beam reorder is an index copy over the slot axis of each cache
tensor (DecodingPredictor._dispatch_reorder).
"""
from __future__ import annotations

import json
import os

import numpy as np

from .. import io as _io
from ..core.scope import global_scope, scope_guard
from ..framework import convert_dtype
from . import decoding as _decoding


def _write_program(entry, out_dir):
    """One program's JSON (with its feed and fetch names) under out_dir;
    returns the feed signature entries (name, shape, dtype)."""
    d = _io.program_to_dict(entry['program'])
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
                                                   _decoding._STEP_DIR))
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
                p, os.path.join(out_dir, _decoding._PREFILL_DIR % L)),
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
