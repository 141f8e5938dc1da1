"""Minimal protobuf wire codec for the reference's framework.proto schema,
the port's copy of paddle_tpu/inference/proto.py.

Hand-rolled (no protobuf runtime dependency): the subset needed to read and
write ProgramDesc / BlockDesc / VarDesc / OpDesc / VarType / TensorDesc
(message and field numbers of paddle/fluid/framework/framework.proto:24-188
— the schema IS the interoperability contract). proto2 semantics: repeated
scalars are unpacked; enums/ints are varints; strings and messages
length-delimited.
"""
from __future__ import annotations

import struct


# -- wire primitives ---------------------------------------------------------
def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _signed(v):
    # plain (non-zigzag) int64 varint: values >= 2^63 are negative
    return v - (1 << 64) if v >= (1 << 63) else v


def _write_varint(out, v):
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _tag(field, wire):
    return (field << 3) | wire


def parse_fields(buf):
    """Yield (field_number, wire_type, value) over a message buffer.
    wire 0 -> varint int; wire 1 -> 8 bytes; wire 2 -> bytes; wire 5 -> 4."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            v = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            v = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError("unsupported wire type %d" % wire)
        yield field, wire, v


class Writer(object):
    def __init__(self):
        self.out = bytearray()

    def varint(self, field, v):
        _write_varint(self.out, _tag(field, 0))
        _write_varint(self.out, v)

    def float32(self, field, v):
        _write_varint(self.out, _tag(field, 5))
        self.out += struct.pack('<f', v)

    def bytes_(self, field, b):
        _write_varint(self.out, _tag(field, 2))
        _write_varint(self.out, len(b))
        self.out += b

    def string(self, field, s):
        self.bytes_(field, s.encode('utf-8'))

    def message(self, field, writer):
        self.bytes_(field, bytes(writer.out))

    def tobytes(self):
        return bytes(self.out)


# -- framework.proto decoders ------------------------------------------------
# AttrType enum (framework.proto:26)
ATTR_INT, ATTR_FLOAT, ATTR_STRING = 0, 1, 2
ATTR_INTS, ATTR_FLOATS, ATTR_STRINGS = 3, 4, 5
ATTR_BOOLEAN, ATTR_BOOLEANS, ATTR_BLOCK = 6, 7, 8
ATTR_LONG, ATTR_BLOCKS, ATTR_LONGS = 9, 10, 11

# VarType.Type enum (framework.proto:106) — single source of truth lives in
# framework.py (convert_dtype consumes the same table)
from ..framework import _PROTO_DTYPE as DTYPE_BY_ENUM
from ..framework import PROTO_DTYPE_ENUM as ENUM_BY_DTYPE
VT_LOD_TENSOR, VT_SELECTED_ROWS, VT_FEED, VT_FETCH = 7, 8, 9, 10
VT_STEP_SCOPES, VT_RANK_TABLE, VT_TENSOR_ARRAY, VT_READER = 11, 12, 13, 15
VT_RAW = 17
TYPE_STR = {VT_LOD_TENSOR: 'lod_tensor', VT_SELECTED_ROWS: 'selected_rows',
            VT_FEED: 'lod_tensor', VT_FETCH: 'lod_tensor',
            VT_STEP_SCOPES: 'raw', VT_RANK_TABLE: 'raw',
            VT_TENSOR_ARRAY: 'tensor_array', VT_READER: 'reader',
            VT_RAW: 'raw'}


def parse_tensor_desc(buf):
    """TensorDesc (framework.proto:139): data_type=1, dims=2."""
    dtype, dims = 'float32', []
    for f, w, v in parse_fields(buf):
        if f == 1:
            dtype = DTYPE_BY_ENUM.get(v, 'float32')
        elif f == 2:
            if w == 0:
                dims.append(_signed(v))
            else:  # packed
                pos = 0
                while pos < len(v):
                    d, pos = _read_varint(v, pos)
                    dims.append(_signed(d))
    return dtype, dims


def parse_var_type(buf):
    """VarType (framework.proto:105): type=1, selected_rows=2,
    lod_tensor=3 (LoDTensorDesc: tensor=1, lod_level=2), tensor_array=4."""
    out = {'type': VT_RAW, 'dtype': None, 'shape': None, 'lod_level': 0}
    for f, w, v in parse_fields(buf):
        if f == 1:
            out['type'] = v
        elif f in (3, 4):  # LoDTensorDesc / LoDTensorArrayDesc
            for f2, w2, v2 in parse_fields(v):
                if f2 == 1:
                    out['dtype'], out['shape'] = parse_tensor_desc(v2)
                elif f2 == 2:
                    out['lod_level'] = v2
        elif f == 2:       # selected_rows TensorDesc
            out['dtype'], out['shape'] = parse_tensor_desc(v)
    return out


def parse_var_desc(buf):
    """VarDesc (framework.proto:168): name=1, type=2, persistable=3."""
    out = {'name': '', 'persistable': False, 'type': {}}
    for f, w, v in parse_fields(buf):
        if f == 1:
            out['name'] = v.decode('utf-8')
        elif f == 2:
            out['type'] = parse_var_type(v)
        elif f == 3:
            out['persistable'] = bool(v)
    return out


def parse_attr(buf):
    """OpDesc.Attr (framework.proto:44)."""
    name, atype = '', ATTR_INT
    vals = {'i': 0, 'f': 0.0, 's': '', 'ints': [], 'floats': [],
            'strings': [], 'b': False, 'bools': [], 'block': -1, 'l': 0,
            'blocks': [], 'longs': []}
    for f, w, v in parse_fields(buf):
        if f == 1:
            name = v.decode('utf-8')
        elif f == 2:
            atype = v
        elif f == 3:
            vals['i'] = _to_int32(v)
        elif f == 4:
            vals['f'] = struct.unpack('<f', v)[0]
        elif f == 5:
            vals['s'] = v.decode('utf-8')
        elif f == 6:
            vals['ints'].append(_to_int32(v))
        elif f == 7:
            vals['floats'].append(struct.unpack('<f', v)[0])
        elif f == 8:
            vals['strings'].append(v.decode('utf-8'))
        elif f == 10:
            vals['b'] = bool(v)
        elif f == 11:
            vals['bools'].append(bool(v))
        elif f == 12:
            vals['block'] = v
        elif f == 13:
            vals['l'] = _signed(v)
        elif f == 14:
            vals['blocks'].append(v)
        elif f == 15:
            vals['longs'].append(_signed(v))
    value = {ATTR_INT: vals['i'], ATTR_FLOAT: vals['f'],
             ATTR_STRING: vals['s'], ATTR_INTS: vals['ints'],
             ATTR_FLOATS: vals['floats'], ATTR_STRINGS: vals['strings'],
             ATTR_BOOLEAN: vals['b'], ATTR_BOOLEANS: vals['bools'],
             ATTR_BLOCK: vals['block'], ATTR_LONG: vals['l'],
             ATTR_BLOCKS: vals['blocks'], ATTR_LONGS: vals['longs']
             }.get(atype)
    return name, atype, value


def _to_int32(v):
    v = v - (1 << 64) if v >= (1 << 63) else v
    if v >= (1 << 31):
        v -= (1 << 32)
    return v


def parse_op_desc(buf):
    """OpDesc (framework.proto:42): inputs=1, outputs=2, type=3, attrs=4."""
    out = {'type': '', 'inputs': {}, 'outputs': {}, 'attrs': {}}
    for f, w, v in parse_fields(buf):
        if f == 3:
            out['type'] = v.decode('utf-8')
        elif f in (1, 2):
            slot, args = '', []
            for f2, w2, v2 in parse_fields(v):
                if f2 == 1:
                    slot = v2.decode('utf-8')
                elif f2 == 2:
                    args.append(v2.decode('utf-8'))
            (out['inputs'] if f == 1 else out['outputs'])[slot] = args
        elif f == 4:
            name, atype, value = parse_attr(v)
            out['attrs'][name] = value
    return out


def parse_block_desc(buf):
    """BlockDesc (framework.proto:174)."""
    out = {'idx': 0, 'parent_idx': -1, 'vars': [], 'ops': []}
    for f, w, v in parse_fields(buf):
        if f == 1:
            out['idx'] = v
        elif f == 2:
            out['parent_idx'] = _to_int32(v)
        elif f == 3:
            out['vars'].append(parse_var_desc(v))
        elif f == 4:
            out['ops'].append(parse_op_desc(v))
    return out


def parse_program_desc(buf):
    """ProgramDesc (framework.proto:184): blocks=1, version=2."""
    blocks = []
    for f, w, v in parse_fields(buf):
        if f == 1:
            blocks.append(parse_block_desc(v))
    return blocks


# -- encoders (write reference-compatible artifacts) -------------------------
def encode_tensor_desc(dtype, dims):
    wr = Writer()
    wr.varint(1, ENUM_BY_DTYPE.get(dtype, 5))
    for d in dims:
        wr.varint(2, d if d >= 0 else d + (1 << 64))
    return wr


def encode_var_desc(name, dtype, shape, lod_level=0, persistable=False,
                    vtype=VT_LOD_TENSOR):
    vt = Writer()
    vt.varint(1, vtype)
    if vtype in (VT_LOD_TENSOR, VT_FEED, VT_FETCH):
        lt = Writer()
        lt.message(1, encode_tensor_desc(dtype or 'float32',
                                         list(shape or [])))
        if lod_level:
            lt.varint(2, lod_level)
        vt.message(3, lt)
    wr = Writer()
    wr.string(1, name)
    wr.message(2, vt)
    if persistable:
        wr.varint(3, 1)
    return wr


def encode_attr(name, value):
    wr = Writer()
    wr.string(1, name)
    if isinstance(value, bool):
        wr.varint(2, ATTR_BOOLEAN)
        wr.varint(10, int(value))
    elif isinstance(value, int):
        if -(1 << 31) <= value < (1 << 31):
            wr.varint(2, ATTR_INT)
            wr.varint(3, value if value >= 0 else value + (1 << 32))
        else:
            wr.varint(2, ATTR_LONG)
            wr.varint(13, value)
    elif isinstance(value, float):
        wr.varint(2, ATTR_FLOAT)
        wr.float32(4, value)
    elif isinstance(value, str):
        wr.varint(2, ATTR_STRING)
        wr.string(5, value)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, bool) for v in value) and value:
            wr.varint(2, ATTR_BOOLEANS)
            for v in value:
                wr.varint(11, int(v))
        elif all(isinstance(v, int) for v in value):
            if value and (max(value) >= (1 << 31) or min(value) < -(1 << 31)):
                wr.varint(2, ATTR_LONGS)
                for v in value:
                    wr.varint(15, v)
            else:
                wr.varint(2, ATTR_INTS)
                for v in value:
                    wr.varint(6, v if v >= 0 else v + (1 << 32))
        elif all(isinstance(v, str) for v in value):
            wr.varint(2, ATTR_STRINGS)
            for v in value:
                wr.string(8, v)
        else:
            wr.varint(2, ATTR_FLOATS)
            for v in value:
                wr.float32(7, float(v))
    else:
        return None  # unencodable (internal) attr
    return wr


def _attr_for_encode(name, value):
    # dtype attrs: the reference stores the VarType enum INT, not a string
    # (op protos declare them as AttrType INT)
    if name in ('dtype', 'out_dtype', 'in_dtype') and isinstance(value, str):
        return ENUM_BY_DTYPE.get(value, 5)
    return value


def encode_op_desc(op_type, inputs, outputs, attrs):
    wr = Writer()
    for slot, args in inputs.items():
        var = Writer()
        var.string(1, slot)
        for a in args:
            var.string(2, a)
        wr.message(1, var)
    for slot, args in outputs.items():
        var = Writer()
        var.string(1, slot)
        for a in args:
            var.string(2, a)
        wr.message(2, var)
    wr.string(3, op_type)
    for name, value in attrs.items():
        if name.startswith('_'):
            continue  # internal bookkeeping attrs don't serialize
        a = encode_attr(name, _attr_for_encode(name, value))
        if a is not None:
            wr.message(4, a)
    return wr


def encode_program(blocks):
    """blocks: list of dicts {idx, parent_idx, vars: [(...)], ops: [...]}"""
    pr = Writer()
    for b in blocks:
        bw = Writer()
        bw.varint(1, b['idx'])
        bw.varint(2, b['parent_idx'] if b['parent_idx'] >= 0
                  else b['parent_idx'] + (1 << 32))
        for v in b['vars']:
            bw.message(3, v)
        for o in b['ops']:
            bw.message(4, o)
        pr.message(1, bw)
    ver = Writer()
    ver.varint(1, 0)
    pr.message(2, ver)
    return pr.tobytes()
