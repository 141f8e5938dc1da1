"""Checkpoint / inference-model save and load
(ref: python/paddle/fluid/io.py; paddle_tpu/io.py).

Reads and writes the same on-disk format as paddle_tpu/io.py, so a
directory saved by either package loads in the other:

- `__model__`: the Program as JSON (program_to_dict, with feed_names and
  fetch_names for an inference model);
- one file per var: b'PTPU', u32 version, u32 header length, a JSON header
  (dtype, shape, lod, crc32 of the payload), then the raw little-endian
  payload;
- or, with `filename=` (`params_filename=` for an inference model), every
  var in that one file: u32 count, then per var a u32 name length, the
  name and the var's bytes as above (paddle_tpu/io.py:333-502);
- `.ptpu_manifest.json`: sha256 and size of every file of the last
  completed save, written last, so a partial or mixed directory fails to
  load instead of loading stale values.

bfloat16 tensors are not in this format yet (numpy has no bfloat16).
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib

import numpy as np
import torch

from .framework import (Block, Operator, Parameter, Program, Variable,
                        default_main_program)
from .core.scope import global_scope

_MAGIC = b'PTPU'
_VERSION = 2  # v2 adds a crc32 of the payload to the header (v1 readable)
_MANIFEST_FILE = '.ptpu_manifest.json'


class _HashingFile(object):
    """File wrapper that sha256s and counts everything written through it."""

    def __init__(self, f):
        self._f = f
        self.sha = hashlib.sha256()
        self.nbytes = 0

    def write(self, data):
        self._f.write(data)
        self.sha.update(data)
        self.nbytes += len(data)


class _atomic_file(object):
    """Write-to-temp + fsync + os.replace: a reader never sees a partial
    file."""

    def __init__(self, path):
        self._path = path
        self._tmp = '%s.tmp.%d' % (path, os.getpid())

    def __enter__(self):
        self._f = open(self._tmp, 'wb')
        return self._f

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            os.replace(self._tmp, self._path)
        else:
            self._f.close()
            try:
                os.remove(self._tmp)
            except OSError:
                pass
        return False


def _load_manifest(dirname, tolerate_corrupt=False):
    path = os.path.join(dirname, _MANIFEST_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path, 'rb') as f:
            return json.loads(f.read().decode())
    except ValueError:
        if tolerate_corrupt:
            return None
        raise RuntimeError(
            "save manifest %s is unreadable (torn write?) — the save "
            "that produced this directory did not complete; re-save or "
            "delete the manifest to load unverified" % path)


def _write_manifest(dirname, entries):
    """Merge `entries` ({relname: {'sha256', 'bytes'}}) into the dir's
    manifest, atomically (save_inference_model writes __model__ and the
    params through separate calls)."""
    path = os.path.join(dirname, _MANIFEST_FILE)
    files = {}
    old = _load_manifest(dirname, tolerate_corrupt=True)
    if old is not None:
        files.update(old.get('files', {}))
    files.update(entries)
    with _atomic_file(path) as f:
        f.write(json.dumps({'version': 1, 'files': files},
                           sort_keys=True).encode())
    return path


def _read_verified(dirname, name, manifest):
    """One file's bytes, checked against its manifest entry when the
    directory has a manifest."""
    path = os.path.join(dirname, name)
    if not os.path.exists(path):
        raise RuntimeError("missing checkpoint file for var %r at %s"
                           % (name, path))
    with open(path, 'rb') as f:
        raw = f.read()
    if manifest is None:
        return raw
    ent = manifest.get('files', {}).get(name)
    if ent is None:
        raise RuntimeError(
            "file %r in %s has no entry in the save manifest — it is "
            "stale (left over from an older save) or the save that "
            "should have written it was interrupted; refusing to load "
            "it silently" % (name, dirname))
    if len(raw) != ent['bytes'] or \
            hashlib.sha256(raw).hexdigest() != ent['sha256']:
        raise RuntimeError(
            "file %r in %s does not match the save manifest (%d bytes vs "
            "%d expected) — partial or corrupt save; refusing to load"
            % (name, dirname, len(raw), ent['bytes']))
    return raw


# ---------------------------------------------------------------------------
# single-tensor serialization
# ---------------------------------------------------------------------------
def _serialize_tensor(f, value):
    if value.dtype == torch.bfloat16:
        raise NotImplementedError(
            "saving bfloat16 tensors is not supported by the port yet")
    data = value.detach().cpu().numpy()
    payload = np.ascontiguousarray(data).tobytes()
    header = json.dumps({'dtype': data.dtype.name,
                         'shape': list(data.shape), 'lod': [],
                         'crc32': zlib.crc32(payload) & 0xffffffff}).encode()
    f.write(_MAGIC)
    f.write(struct.pack('<I', _VERSION))
    f.write(struct.pack('<I', len(header)))
    f.write(header)
    f.write(payload)


def _deserialize_tensor(raw, device, pos=0):
    """The tensor serialized at raw[pos:], on `device`, and the offset
    just past it."""
    if raw[pos:pos + 4] != _MAGIC:
        raise ValueError("not a paddle_tpu tensor file (bad magic %r)"
                         % raw[pos:pos + 4])
    (hlen,) = struct.unpack('<I', raw[pos + 8:pos + 12])
    start = pos + 12 + hlen
    header = json.loads(raw[pos + 12:start].decode())
    if header['lod']:
        raise NotImplementedError("LoD tensors are not supported by the "
                                  "port yet (ROADMAP.md queue 1 item 8)")
    dt = np.dtype(header['dtype'])
    n = int(np.prod(header['shape'])) if header['shape'] else 1
    end = start + n * dt.itemsize
    payload = raw[start:end]
    if 'crc32' in header and (zlib.crc32(payload) & 0xffffffff) \
            != header['crc32']:
        raise ValueError("tensor payload CRC mismatch — corrupt checkpoint")
    data = np.frombuffer(payload, dtype=dt).reshape(header['shape'])
    return torch.from_numpy(data.copy()).to(device), end


def _parse_var_blob(raw, device):
    """{name: tensor} of a single-file save (count, then per var its name
    and serialized tensor)."""
    (n,) = struct.unpack('<I', raw[:4])
    pos, loaded = 4, {}
    for _ in range(n):
        (ln,) = struct.unpack('<I', raw[pos:pos + 4])
        name = raw[pos + 4:pos + 4 + ln].decode()
        loaded[name], pos = _deserialize_tensor(raw, device, pos + 4 + ln)
    return loaded


# ---------------------------------------------------------------------------
# program (de)serialization — the __model__ format
# ---------------------------------------------------------------------------
def _var_to_dict(v):
    return {'name': v.name,
            'shape': list(v.shape) if v.shape is not None else None,
            'dtype': v.dtype, 'lod_level': v.lod_level,
            'persistable': v.persistable, 'stop_gradient': v.stop_gradient,
            'is_parameter': isinstance(v, Parameter),
            'trainable': getattr(v, 'trainable', True),
            'type': v.type, 'is_data': getattr(v, 'is_data', False)}


def _attr_jsonable(a):
    if isinstance(a, np.integer):
        return int(a)
    if isinstance(a, np.floating):
        return float(a)
    if isinstance(a, dict):
        return {k: _attr_jsonable(v) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [_attr_jsonable(v) for v in a]
    return a


def program_to_dict(program):
    blocks = []
    for b in program.blocks:
        blocks.append({
            'idx': b.idx, 'parent_idx': b.parent_idx,
            'vars': [_var_to_dict(v) for v in b.vars.values()],
            'ops': [{'type': op.type, 'inputs': op.inputs,
                     'outputs': op.outputs,
                     'attrs': _attr_jsonable(op.attrs)} for op in b.ops],
        })
    return {'version': _VERSION, 'blocks': blocks,
            'random_seed': program.random_seed}


def program_from_dict(d):
    p = Program()
    p.random_seed = d.get('random_seed', 0)
    p.blocks = []
    for bd in d['blocks']:
        p.blocks.append(Block(p, bd['idx'], bd['parent_idx']))
    for bd, b in zip(d['blocks'], p.blocks):
        for vd in bd['vars']:
            if vd.get('is_parameter'):
                v = Parameter(b, vd['name'], vd['shape'], vd['dtype'],
                              trainable=vd.get('trainable', True))
            else:
                v = Variable(b, vd['name'], vd['shape'], vd['dtype'],
                             lod_level=vd.get('lod_level', 0),
                             persistable=vd.get('persistable', False),
                             stop_gradient=vd.get('stop_gradient', False),
                             type=vd.get('type', 'lod_tensor'),
                             is_data=vd.get('is_data', False))
            b.vars[vd['name']] = v
        for od in bd['ops']:
            b.ops.append(Operator(b, od['type'], od['inputs'], od['outputs'],
                                  od['attrs']))
    # ops appended later get uids past the loaded ones
    p._op_uid_counter = max(
        (op.attrs.get('_op_uid', 0) for b in p.blocks for op in b.ops),
        default=0)
    return p


# ---------------------------------------------------------------------------
# save/load vars
# ---------------------------------------------------------------------------
def is_persistable(var):
    return var.persistable


def _resolve_vars(main_program, vars, predicate):
    main_program = main_program or default_main_program()
    if vars is None:
        return [v for v in main_program.list_vars() if predicate(v)]
    return [main_program.global_block().var(v) if isinstance(v, str) else v
            for v in vars]


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Write each var present in the global scope to dirname/<name>, or
    all of them to dirname/<filename>, then the manifest. Returns the paths
    written."""
    vars = _resolve_vars(main_program, vars, predicate or (lambda v: True))
    scope = global_scope()
    present = [(v, scope.get(v.name)) for v in vars]
    present = [(v, val) for v, val in present if val is not None]
    os.makedirs(dirname, exist_ok=True)
    entries, written = {}, []
    if filename is None:
        for v, val in present:
            path = os.path.join(dirname, v.name)
            with _atomic_file(path) as f:
                hf = _HashingFile(f)
                _serialize_tensor(hf, val)
            entries[v.name] = {'sha256': hf.sha.hexdigest(),
                               'bytes': hf.nbytes}
            written.append(path)
    else:
        path = os.path.join(dirname, filename)
        with _atomic_file(path) as f:
            hf = _HashingFile(f)
            hf.write(struct.pack('<I', len(present)))
            for v, val in present:
                name = v.name.encode()
                hf.write(struct.pack('<I', len(name)))
                hf.write(name)
                _serialize_tensor(hf, val)
        entries[filename] = {'sha256': hf.sha.hexdigest(),
                             'bytes': hf.nbytes}
        written.append(path)
    # the manifest is written LAST: its digests committing to the files
    # above is what makes an interrupted save detectable
    written.append(_write_manifest(dirname, entries))
    return written


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Load vars from dirname (one file each, or all from
    dirname/<filename>) into the global scope, on the executor's device.
    A var a single file does not hold is left as it is, as in the
    reference."""
    vars = _resolve_vars(main_program, vars, predicate or (lambda v: True))
    scope = global_scope()
    manifest = _load_manifest(dirname)
    if filename is None:
        for v in vars:
            raw = _read_verified(dirname, v.name, manifest)
            scope.set(v.name, _deserialize_tensor(raw, executor.device)[0])
        return
    loaded = _parse_var_blob(_read_verified(dirname, filename, manifest),
                             executor.device)
    for v in vars:
        if v.name in loaded:
            scope.set(v.name, loaded[v.name])


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program, None, is_persistable,
                     filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, None, is_persistable,
              filename)


# ---------------------------------------------------------------------------
# inference model
# ---------------------------------------------------------------------------
def prune_program(program, feed_names, fetch_names):
    """Keep only the ops of block 0 that the fetches need (reverse
    reachability from the fetch names), in test mode, with feed and fetch
    ops dropped and every var left in place (ref framework/prune.cc)."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    live = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        if op.type in ('feed', 'fetch'):
            continue
        if live.intersection(op.output_arg_names()):
            keep.append(op)
            live.update(n for n in op.input_arg_names() if n)
    block.ops = keep[::-1]
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None):
    main_program = main_program or default_main_program()
    fetch_names = [v.name if isinstance(v, Variable) else v
                   for v in target_vars]
    pruned = prune_program(main_program, feeded_var_names, fetch_names)
    d = program_to_dict(pruned)
    d['feed_names'] = list(feeded_var_names)
    d['fetch_names'] = fetch_names
    os.makedirs(dirname, exist_ok=True)
    model_name = model_filename or '__model__'
    with _atomic_file(os.path.join(dirname, model_name)) as f:
        hf = _HashingFile(f)
        hf.write(json.dumps(d).encode())
    _write_manifest(dirname, {model_name: {
        'sha256': hf.sha.hexdigest(), 'bytes': hf.nbytes}})
    save_persistables(executor, dirname, pruned, params_filename)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """(program, feed_names, fetch_vars) of the model in dirname, its
    persistables loaded into the global scope on the executor's device."""
    model_name = model_filename or '__model__'
    raw = _read_verified(dirname, model_name, _load_manifest(dirname))
    d = json.loads(raw.decode())
    program = program_from_dict(d)
    load_persistables(executor, dirname, program, params_filename)
    feed_names = d.get('feed_names', [])
    fetch_vars = [program.global_block().var(n)
                  for n in d.get('fetch_names', [])]
    return program, feed_names, fetch_vars
