"""Graph-program front end: Program / Block / Operator / Variable, Places.

The port's own copy of paddle_tpu/framework.py, trimmed to what the serving
and training slices need. The Program is the IR: ops carry a type,
input/output var names per slot and attrs, and shapes/dtypes are inferred
when an op is appended (core/registry.py runs the op's torch lowering on
'meta' tensors). The Executor interprets block 0 eagerly with torch on the
device a Place names.
"""
from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from . import unique_name

# ---------------------------------------------------------------------------
# dtypes: declared as canonical strings, carried as torch dtypes
# ---------------------------------------------------------------------------
_DTYPE_ALIASES = {
    'float': 'float32', 'double': 'float64', 'half': 'float16',
    'int': 'int32', 'long': 'int64', 'bool_': 'bool',
    'fp32': 'float32', 'fp64': 'float64', 'fp16': 'float16',
    'bf16': 'bfloat16',
}

_TORCH_DTYPE = {
    'float32': torch.float32, 'float64': torch.float64,
    'float16': torch.float16, 'bfloat16': torch.bfloat16,
    'int8': torch.int8, 'uint8': torch.uint8, 'int16': torch.int16,
    'int32': torch.int32, 'int64': torch.int64, 'bool': torch.bool,
}
_DTYPE_NAME = {v: k for k, v in _TORCH_DTYPE.items()}

# reference proto VarType.Type enum values (framework.proto:106): dtype
# attrs of programs in the reference's protobuf format arrive as these ints
_PROTO_DTYPE = {0: 'bool', 1: 'int16', 2: 'int32', 3: 'int64',
                4: 'float16', 5: 'float32', 6: 'float64',
                20: 'uint8', 21: 'int8'}
PROTO_DTYPE_ENUM = {v: k for k, v in _PROTO_DTYPE.items()}


def convert_dtype(dtype):
    """Canonicalize a dtype spec (str / np.dtype / torch.dtype / reference
    VarType enum int) to a string."""
    if dtype is None:
        return None
    if isinstance(dtype, int) and not isinstance(dtype, bool):
        if dtype in _PROTO_DTYPE:
            return _PROTO_DTYPE[dtype]
        raise TypeError("unknown dtype enum %r" % (dtype,))
    if isinstance(dtype, torch.dtype):
        return _DTYPE_NAME[dtype]
    if isinstance(dtype, str):
        s = _DTYPE_ALIASES.get(dtype, dtype)
    else:
        s = np.dtype(dtype).name
    if s not in _TORCH_DTYPE:
        s = np.dtype(s).name
    return s


def to_torch_dtype(dtype):
    """The torch dtype a declared var dtype is carried in."""
    return _TORCH_DTYPE[convert_dtype(dtype)]


def is_float_dtype(dtype):
    return convert_dtype(dtype) in ('float16', 'bfloat16', 'float32', 'float64')


# gradient var naming (ref: fluid/framework.py grad_var_name)
GRAD_SUFFIX = '@GRAD'


def grad_var_name(name):
    return name + GRAD_SUFFIX


class Variable(object):
    """A named tensor slot in a Block (ref: fluid/framework.py:232).
    shape may contain -1 (batch dim resolved at feed time)."""

    def __init__(self, block, name, shape=None, dtype='float32', lod_level=0,
                 persistable=False, stop_gradient=False, trainable=None,
                 type='lod_tensor', initializer=None, is_data=False):
        self.block = block
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.initializer = initializer
        self.is_data = is_data
        self.is_parameter = False

    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    def __repr__(self):
        return ("Variable(name=%r, shape=%r, dtype=%s, lod_level=%d%s)" %
                (self.name, self.shape, self.dtype, self.lod_level,
                 ', persistable' if self.persistable else ''))

    __str__ = __repr__


class Parameter(Variable):
    """Trainable persistable variable (ref: fluid/framework.py:2104)."""

    def __init__(self, block, name, shape, dtype, trainable=True,
                 optimize_attr=None, regularizer=None, gradient_clip_attr=None,
                 do_model_average=False, **kw):
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable, **kw)
        self.trainable = trainable
        self.optimize_attr = optimize_attr or {'learning_rate': 1.0}
        self.regularizer = regularizer
        self.gradient_clip_attr = gradient_clip_attr
        self.do_model_average = do_model_average
        self.is_parameter = True


class Operator(object):
    """One op in a block (ref: fluid/framework.py:546).

    inputs/outputs: dict slot_name -> list[str] of var names.
    attrs: plain-python attributes (JSON-serializable).
    """

    @staticmethod
    def _norm_slot(v):
        if v is None:
            return []
        if isinstance(v, (Variable, str)):
            v = [v]
        out = []
        for x in v:
            if isinstance(x, Variable):
                out.append(x.name)
            elif isinstance(x, str):
                out.append(x)
            else:
                raise TypeError(
                    "op inputs/outputs must be Variables or names, got %r"
                    % (type(x).__name__,))
        return out

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: self._norm_slot(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: self._norm_slot(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        # per-program op uid: seeds the op's random stream (core/lowering.py)
        if '_op_uid' not in self.attrs:
            program = block.program
            program._op_uid_counter += 1
            self.attrs['_op_uid'] = program._op_uid_counter

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def input_arg_names(self):
        return [n for v in self.inputs.values() for n in v]

    def output_arg_names(self):
        return [n for v in self.outputs.values() for n in v]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name):
        return name in self.attrs

    def __repr__(self):
        ins = {k: v for k, v in self.inputs.items() if v}
        outs = {k: v for k, v in self.outputs.items() if v}
        return "{%s: %s -> %s}" % (self.type, ins, outs)


class Block(object):
    """A straight-line list of ops + a var scope (ref: fluid/framework.py:992)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent_block(self):
        return self.program.block(self.parent_idx) if self.parent_idx >= 0 else None

    def create_var(self, name=None, **kw):
        if name is None:
            name = unique_name.generate('_generated_var')
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kw)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype, **kw):
        # parameters live in the global block, as in the reference
        global_block = self.program.global_block()
        p = Parameter(global_block, name, shape, dtype, **kw)
        global_block.vars[name] = p
        return p

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("Variable %r not found in block %d or ancestors" %
                             (name, self.idx))
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def has_var_local(self, name):
        return name in self.vars

    def _find_var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def _insert(self, index, type, inputs, outputs, attrs, infer_shape):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._build_epoch += 1
        if infer_shape:
            from .core import registry
            registry.infer_shape(op, self)
        return op

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        return self._insert(len(self.ops), type, inputs, outputs, attrs,
                            infer_shape)

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None,
                   infer_shape=True):
        return self._insert(0, type, inputs, outputs, attrs, infer_shape)

    def __repr__(self):
        lines = ["Block %d (parent %d):" % (self.idx, self.parent_idx)]
        for op in self.ops:
            lines.append("  " + repr(op))
        return "\n".join(lines)


class Program(object):
    """A list of blocks; block 0 is global (ref: fluid/framework.py:1510).

    `_uid` is unique in the process, and a clone gets a new one: the
    Executor keys its per-program step counter by it (the step seeds the
    ops' random draws, core/lowering.py). `_build_epoch` turns at every
    op appended or prepended and after each pass pipeline
    (passes/base.py), as paddle_tpu/framework.py:280-308 turns it: the
    Executor's verify and freeing-plan caches key on (_uid, _build_epoch)
    and never replay a plan of an older op list. A clone keeps the
    epoch."""

    _uid_counter = [0]

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self._current_block_idx = 0
        self.random_seed = 0
        self._op_uid_counter = 0
        Program._uid_counter[0] += 1
        self._uid = Program._uid_counter[0]
        self._build_epoch = 0

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self._current_block_idx]

    @property
    def num_blocks(self):
        return len(self.blocks)

    def _create_block(self, parent_idx=None):
        """Append a sub-block (parent: the current block, or parent_idx)
        and make it current; _rollback returns to its parent."""
        parent = self._current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def _rollback(self):
        self._current_block_idx = self.current_block().parent_idx

    def list_vars(self):
        for b in self.blocks:
            for v in b.vars.values():
                yield v

    def all_parameters(self):
        return self.global_block().all_parameters()

    def clone(self, for_test=False):
        """Deep-copy the program. for_test=True switches dropout and
        batch_norm into test mode (ref: fluid/framework.py Program.clone)."""
        p = copy.deepcopy(self)
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if op.type in _TEST_MODE_OPS:
                        op.attrs['is_test'] = True
        return p

    def __deepcopy__(self, memo):
        p = Program.__new__(Program)
        memo[id(self)] = p
        p.blocks = []
        p._current_block_idx = self._current_block_idx
        p.random_seed = self.random_seed
        p._op_uid_counter = self._op_uid_counter
        Program._uid_counter[0] += 1
        p._uid = Program._uid_counter[0]
        p._build_epoch = self._build_epoch
        for b in self.blocks:
            p.blocks.append(Block(p, b.idx, b.parent_idx))
        for b, nb in zip(self.blocks, p.blocks):
            for name, v in b.vars.items():
                nv = type(v).__new__(type(v))
                nv.__dict__.update({k: val for k, val in v.__dict__.items()
                                    if k != 'block'})
                nv.block = nb
                nb.vars[name] = nv
            for op in b.ops:
                nb.ops.append(Operator(nb, op.type,
                                       {k: list(v) for k, v in op.inputs.items()},
                                       {k: list(v) for k, v in op.outputs.items()},
                                       copy.deepcopy(op.attrs, memo)))
        return p

    def to_string(self, throw_on_error=False, with_details=False):
        return "\n".join(repr(b) for b in self.blocks)

    __repr__ = to_string
    __str__ = to_string


# ops whose 'is_test' attr flips at clone(for_test=True)
_TEST_MODE_OPS = ('dropout', 'batch_norm')


# ---------------------------------------------------------------------------
# default program singletons + guards (ref: fluid/framework.py:2188-2256)
# ---------------------------------------------------------------------------
_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    prev, _main_program_ = _main_program_, program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev, _startup_program_ = _startup_program_, program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)


# ---------------------------------------------------------------------------
# Places (ref: platform/place.h:79). Each maps to one explicit torch.device.
# ---------------------------------------------------------------------------
class Place(object):
    def __init__(self, device_id=0):
        self.device_id = device_id

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)


class CPUPlace(Place):
    def device(self):
        return torch.device('cpu')


class CUDAPlace(Place):
    """The card with index `device_id`. Never falls back to the CPU: asking
    for it where torch sees no CUDA device raises."""

    def device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "%r was asked for, but torch.cuda.is_available() is False. "
                "Pass CPUPlace() (or Config.disable_gpu()) to run on the CPU."
                % (self,))
        n = torch.cuda.device_count()
        if not 0 <= self.device_id < n:
            raise RuntimeError("%r was asked for, but only %d CUDA device(s) "
                               "are visible" % (self, n))
        return torch.device('cuda', self.device_id)
