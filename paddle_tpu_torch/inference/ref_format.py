"""Reference artifact formats: `__model__` protobuf + SerializeToStream
params, the port's copy of paddle_tpu/inference/ref_format.py.

Byte layouts (re-derived from the reference sources):
- tensor stream (framework/tensor_util.cc:372 TensorToStream):
    u32 version(0); i32 desc_size; TensorDesc proto; raw data bytes.
- LoDTensor stream (framework/lod_tensor.cc:245 SerializeToStream):
    u32 version(0); u64 lod_level; per level: u64 nbytes + raw u64 offsets;
    then the tensor stream.
- `__model__`: serialized ProgramDesc (framework/framework.proto:184);
  save_inference_model writes it with params in separate files named by
  var (io.py:570) or one combined file (save_combine).

Loading builds the port's own Program (ops keep their reference attrs, a
dtype attr as its VarType enum int, which framework.convert_dtype reads),
so a model saved in the reference's format serves in the port; saving
emits directories the reference (and paddle_tpu) can load.

Dense tensors only: a tensor whose stored LoD is not empty raises
NotImplementedError (LoD is ROADMAP.md queue 1 item 8).
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch

from . import proto
from ..framework import Program

_VERSION = struct.pack('<I', 0)


def _no_lod(what):
    raise NotImplementedError(
        '%s carries a LoD: LoD tensors are not ported yet (ROADMAP.md queue '
        '1 item 8); the port reads and writes dense tensors of the '
        "reference's format" % what)


# -- tensors -----------------------------------------------------------------
def write_tensor_stream(f, array, lod=None, with_lod=True):
    """One tensor in the reference's stream format; `with_lod` writes the
    LoDTensor framing (lod_level 0, as SerializeToStream writes it for a
    plain tensor)."""
    if lod:
        _no_lod('write_tensor_stream: the tensor')
    array = np.ascontiguousarray(array)
    if with_lod:
        f.write(_VERSION)
        f.write(struct.pack('<Q', 0))
    f.write(_VERSION)
    desc = proto.encode_tensor_desc(str(array.dtype), list(array.shape))
    db = desc.tobytes()
    f.write(struct.pack('<i', len(db)))
    f.write(db)
    f.write(array.tobytes())


def read_tensor_stream(f, has_lod=True):
    """Returns (np array, lod list) — lod [] for plain tensors."""
    ver = struct.unpack('<I', f.read(4))[0]
    if ver != 0:
        raise ValueError("unsupported tensor version %d" % ver)
    lod = []
    if has_lod:
        (lod_level,) = struct.unpack('<Q', f.read(8))
        for _ in range(lod_level):
            (nbytes,) = struct.unpack('<Q', f.read(8))
            lod.append(np.frombuffer(f.read(nbytes), np.uint64)
                       .astype(np.int64))
        ver = struct.unpack('<I', f.read(4))[0]
        if ver != 0:
            raise ValueError("unsupported tensor version %d" % ver)
    (desc_size,) = struct.unpack('<i', f.read(4))
    dtype, dims = proto.parse_tensor_desc(f.read(desc_size))
    count = int(np.prod(dims)) if dims else 1
    arr = np.frombuffer(f.read(count * np.dtype(dtype).itemsize),
                        dtype).reshape(dims)
    return arr, lod


def _dense(name, arr, lod, device):
    if lod:
        _no_lod('variable %r' % name)
    return torch.from_numpy(np.array(arr)).to(device)


def load_reference_var(path):
    with open(path, 'rb') as f:
        return read_tensor_stream(f, has_lod=True)


# -- programs ----------------------------------------------------------------
def program_from_desc_bytes(buf):
    """Reference ProgramDesc bytes -> the port's Program."""
    from ..framework import Block, Operator, Variable
    blocks = proto.parse_program_desc(buf)
    p = Program()
    p.blocks = []
    for bd in blocks:
        p.blocks.append(Block(p, bd['idx'], bd['parent_idx']))
    for bd, b in zip(blocks, p.blocks):
        for vd in bd['vars']:
            t = vd['type']
            b.vars[vd['name']] = Variable(
                b, vd['name'], shape=t.get('shape'),
                dtype=t.get('dtype') or 'float32',
                lod_level=t.get('lod_level', 0),
                persistable=vd['persistable'],
                type=proto.TYPE_STR.get(t.get('type'), 'lod_tensor'))
        for od in bd['ops']:
            b.ops.append(Operator(b, od['type'], od['inputs'],
                                  od['outputs'], od['attrs']))
    return p


def program_to_desc_bytes(program):
    """The port's Program -> reference ProgramDesc bytes."""
    blocks = []
    for b in program.blocks:
        vars_enc = []
        for name, v in b.vars.items():
            vtype = {'lod_tensor': proto.VT_LOD_TENSOR,
                     'selected_rows': proto.VT_SELECTED_ROWS,
                     'tensor_array': proto.VT_TENSOR_ARRAY,
                     'reader': proto.VT_READER,
                     'raw': proto.VT_RAW}.get(v.type, proto.VT_LOD_TENSOR)
            vars_enc.append(proto.encode_var_desc(
                name, v.dtype, v.shape, v.lod_level, v.persistable, vtype))
        ops_enc = [proto.encode_op_desc(op.type, op.inputs, op.outputs,
                                        op.attrs) for op in b.ops]
        blocks.append({'idx': b.idx, 'parent_idx': b.parent_idx
                       if b.parent_idx is not None else -1,
                       'vars': vars_enc, 'ops': ops_enc})
    return proto.encode_program(blocks)


# -- inference model dirs ----------------------------------------------------
def _feed_fetch_from_program(program):
    feeds, fetches = [], []
    for op in program.global_block().ops:
        if op.type == 'feed':
            feeds.append((int(op.attrs.get('col', 0)),
                          op.outputs['Out'][0]))
        elif op.type == 'fetch':
            fetches.append((int(op.attrs.get('col', 0)),
                            op.inputs['X'][0]))
    # block order of prepended feed ops is reversed; 'col' is authoritative
    return ([n for _, n in sorted(feeds)],
            [n for _, n in sorted(fetches)])


def _device(executor):
    return executor.device if executor is not None else torch.device('cpu')


def load_reference_inference_model(dirname, executor=None,
                                   model_filename=None,
                                   params_filename=None, scope=None):
    """Load a reference save_inference_model directory (ref io.py:704) into
    `scope` (default: the global scope), on the executor's device.
    Returns (program, feed_names, fetch_vars)."""
    from ..core.scope import global_scope
    device = _device(executor)
    model_path = os.path.join(dirname, model_filename or '__model__')
    with open(model_path, 'rb') as f:
        program = program_from_desc_bytes(f.read())
    scope = scope or global_scope()
    persistables = [v for v in program.list_vars()
                    if v.persistable and v.type == 'lod_tensor']
    if params_filename:
        with open(os.path.join(dirname, params_filename), 'rb') as f:
            # save_combine order = sorted var names (ref io.py:570)
            for v in sorted(persistables, key=lambda v: v.name):
                arr, lod = read_tensor_stream(f)
                scope.set(v.name, _dense(v.name, arr, lod, device))
    else:
        for v in persistables:
            path = os.path.join(dirname, v.name)
            if not os.path.exists(path):
                continue
            arr, lod = load_reference_var(path)
            scope.set(v.name, _dense(v.name, arr, lod, device))
    feed_names, fetch_names = _feed_fetch_from_program(program)
    fetch_vars = [program.global_block()._find_var_recursive(n)
                  for n in fetch_names]
    return program, feed_names, fetch_vars


def save_reference_inference_model(dirname, feeded_var_names, target_vars,
                                   executor, main_program=None,
                                   model_filename=None,
                                   params_filename=None, scope=None):
    """Write a reference-format inference dir from the port's program
    (ref io.py:570 save_inference_model), the values from `scope`
    (default: the global scope). Returns the pruned program."""
    from ..framework import default_main_program
    from ..io import prune_program
    from ..core.scope import global_scope
    program = main_program or default_main_program()
    scope = scope or global_scope()
    target_names = [v.name if not isinstance(v, str) else v
                    for v in target_vars]
    pruned = prune_program(program, feeded_var_names, target_names)
    # reference-style feed/fetch ops, so the round trip is faithful
    block = pruned.global_block()
    for i, n in enumerate(feeded_var_names):
        block.prepend_op(type='feed', inputs={}, outputs={'Out': [n]},
                         attrs={'col': i}, infer_shape=False)
    for i, n in enumerate(target_names):
        block.append_op(type='fetch', inputs={'X': [n]},
                        outputs={'Out': ['fetch']}, attrs={'col': i},
                        infer_shape=False)
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, model_filename or '__model__'),
              'wb') as f:
        f.write(program_to_desc_bytes(pruned))
    persistables = sorted(
        {v.name for v in pruned.list_vars() if v.persistable})
    if params_filename:
        with open(os.path.join(dirname, params_filename), 'wb') as f:
            for name in persistables:
                val = scope.get(name)
                if val is None:
                    # the combined stream is positional: a silent skip would
                    # shift every later var's bytes onto the wrong weight
                    raise ValueError(
                        "persistable %r has no value in the scope; run the "
                        "startup program (or load a checkpoint) before "
                        "saving a combined-params model" % name)
                write_tensor_stream(f, val.detach().cpu().numpy())
    else:
        for name in persistables:
            val = scope.get(name)
            if val is None:
                continue
            with open(os.path.join(dirname, name), 'wb') as f:
                write_tensor_stream(f, val.detach().cpu().numpy())
    return pruned


def load_reference_persistables(dirname, program, scope=None, executor=None):
    """Load per-var reference checkpoint files into `scope` (default: the
    global scope), on the executor's device. Returns how many loaded."""
    from ..core.scope import global_scope
    device = _device(executor)
    scope = scope or global_scope()
    n = 0
    for v in program.list_vars():
        if not v.persistable:
            continue
        path = os.path.join(dirname, v.name)
        if os.path.exists(path):
            arr, lod = load_reference_var(path)
            scope.set(v.name, _dense(v.name, arr, lod, device))
            n += 1
    return n
