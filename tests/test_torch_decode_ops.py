"""The ops that decode serving adds to the port (assign_value, slice,
gather and the three KV-cache ops), each against paddle_tpu's lowering on
the same numpy inputs, on the CPU.

The port's side runs each op as a one-op Program through its Executor
(the cache a persistable var in a Scope, as the serving programs hold
it); paddle_tpu's side calls the op's registered JAX lowering directly
with the same attrs. Writes and gathers must agree exactly; the attention
at rtol 1e-5 with an absolute floor of 1e-6 of its largest value (f32 on
both sides, the sums in different orders).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.core import registry as jax_registry

S, T, D, H = 4, 16, 8, 2


class _JaxCtx(object):
    """The part of paddle_tpu's OpCtx that these lowerings read."""

    def __init__(self, attrs, out_name='out'):
        self.attrs = attrs
        self.op = type('Op', (), {'outputs': {'Out': [out_name]}})()
        self.tracer = type('Tracer', (), {'host_consts': {}})()

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _jax(op_type, ins, attrs=None):
    """The JAX lowering of op_type on numpy inputs: {slot: numpy}."""
    import jax.numpy as jnp
    outs = jax_registry.get(op_type).lower(
        _JaxCtx(attrs or {}), {k: [jnp.asarray(v)] for k, v in ins.items()})
    return {k: np.asarray(v[0]) for k, v in outs.items()}


def _port(op_type, ins, attrs=None, persist=None, out='out'):
    """op_type as a one-op program run by the port's Executor on the CPU:
    `ins` {slot: (var name, numpy)} fed as data vars, except the names in
    `persist`, which live in the scope as persistable vars. Returns
    (the fetched `out`, the scope)."""
    persist = persist or {}
    main = ptt.Program()
    scope = ptt.Scope()
    feed = {}
    with ptt.program_guard(main, ptt.Program()), ptt.unique_name.guard():
        block = main.global_block()
        for slot, (name, arr) in ins.items():
            if name in persist:
                block.create_var(name=name, shape=arr.shape,
                                 dtype=str(arr.dtype), persistable=True)
                scope.set(name, torch.from_numpy(arr.copy()))
            else:
                ptt.layers.data(name, shape=list(arr.shape),
                                dtype=str(arr.dtype),
                                append_batch_size=False)
                feed[name] = arr
        if not block.has_var(out):
            block.create_var(name=out, dtype='float32')
        block.append_op(type=op_type,
                        inputs={s: [n] for s, (n, _) in ins.items()},
                        outputs={'Out': [out]}, attrs=dict(attrs or {}))
    got, = ptt.Executor(ptt.CPUPlace()).run(main, feed=feed,
                                            fetch_list=[out], scope=scope)
    return got, scope


def _r(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


# -- assign_value (NumpyArrayInitializer) -----------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'int32', 'int64'])
def test_assign_value_numpy_initializer(dtype):
    """create_parameter with a NumpyArrayInitializer emits one assign_value
    in the startup program; running it gives the array, as the JAX
    lowering of the same op does."""
    arr = (_r(5, 3) * 10).astype(dtype)
    startup, main = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        ptt.layers.create_parameter(
            [5, 3], dtype, attr=ptt.ParamAttr(name='w', trainable=False),
            default_initializer=ptt.initializer.NumpyArrayInitializer(arr))
    op, = startup.global_block().ops
    assert op.type == 'assign_value'
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    got = scope.get('w').numpy()
    want = _jax('assign_value', {}, op.attrs)['Out']
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, want.astype(dtype))


# -- slice ------------------------------------------------------------------

SLICES = {
    'prefix': ([0], [0], [5]),
    'negative_start_end': ([0, 1], [-4, 1], [-1, -1]),
    'end_past_dim': ([1], [2], [1000]),
    'start_past_dim': ([0], [99], [120]),
    'negative_past_dim': ([0], [-100], [3]),
}


@pytest.mark.parametrize('name', sorted(SLICES))
def test_slice_clamps_as_reference(name):
    axes, starts, ends = SLICES[name]
    x = _r(7, 6, 3)
    attrs = {'axes': axes, 'starts': starts, 'ends': ends}
    got, _ = _port('slice', {'Input': ('x', x)}, attrs)
    want = _jax('slice', {'Input': x}, attrs)['Out']
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- gather -----------------------------------------------------------------

GATHERS = {
    'positions_s1': np.array([[0], [T - 1], [3], [0]], np.int32),
    'matrix_flattened': np.array([[1, 2, 3], [4, 5, 15]], np.int64),
    'negative_wraps': np.array([[-1], [-T], [2]], np.int32),
}


@pytest.mark.parametrize('name', sorted(GATHERS))
def test_gather_matches_reference(name):
    idx = GATHERS[name]
    table = _r(T, D, seed=1)
    got, _ = _port('gather', {'X': ('x', table), 'Index': ('idx', idx)})
    want = _jax('gather', {'X': table, 'Index': idx})['Out']
    assert got.shape == want.shape == (idx.size, D)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('bad', [T, -T - 1])
def test_gather_out_of_range_raises(bad):
    """jnp.take fills an out-of-range row; on the card an out-of-range
    index_select would end the CUDA context, so the port raises."""
    idx = np.array([[0], [bad]], np.int32)
    with pytest.raises(IndexError):
        _port('gather', {'X': ('x', _r(T, D)), 'Index': ('idx', idx)})


# -- kv_cache_write / kv_cache_prefill_write --------------------------------

def _write_case(pos):
    cache = _r(S, T, D, seed=2)
    kv = _r(S, D, seed=3)
    return cache, kv, np.asarray(pos, np.int32).reshape(S, 1)


WRITES = {
    'first_and_last_row': [0, T - 1, 5, 1],
    'at_and_past_cache_len_clamp': [T, T + 7, 0, T - 1],
    'negative_counts_from_end': [-3, 2, T, -T - 4],
    'idle_slots_at_zero': [0, 0, 0, 9],
}


@pytest.mark.parametrize('name', sorted(WRITES))
def test_kv_cache_write_in_place_matches_reference(name):
    """Row pos[s] of slot s takes KV[s]; positions at or past T land on
    row T-1, a negative one counts from the end and clamps at row 0, as
    dynamic_update_slice places them. The port writes into the scope's
    cache tensor itself."""
    cache, kv, pos = _write_case(WRITES[name])
    got, scope = _port('kv_cache_write',
                       {'Cache': ('cache', cache), 'KV': ('kv', kv),
                        'Pos': ('pos', pos)}, persist={'cache'},
                       out='cache')
    want = _jax('kv_cache_write', {'Cache': cache, 'KV': kv,
                                   'Pos': pos})['Out']
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(scope.get('cache').numpy(), want)


def test_kv_cache_write_no_copy_of_cache():
    """The op's Out is the Cache tensor it was given: the step writes into
    the persistable buffer, it does not clone [S, T, D]."""
    cache, kv, pos = _write_case([1, 2, 3, 4])
    main = ptt.Program()
    scope = ptt.Scope()
    with ptt.program_guard(main, ptt.Program()), ptt.unique_name.guard():
        block = main.global_block()
        block.create_var(name='cache', shape=cache.shape, dtype='float32',
                         persistable=True)
        kv_v = ptt.layers.data('kv', shape=[S, D], append_batch_size=False)
        pos_v = ptt.layers.data('pos', shape=[S, 1], dtype='int32',
                                append_batch_size=False)
        out = ptt.layers.kv_cache_write(block.var('cache'), kv_v, pos_v)
    assert out.name == 'cache'
    buf = torch.from_numpy(cache.copy())
    scope.set('cache', buf)
    ptt.Executor(ptt.CPUPlace()).run(main, feed={'kv': kv, 'pos': pos},
                                     scope=scope)
    assert scope.get('cache') is buf
    np.testing.assert_array_equal(buf.numpy()[np.arange(S), [1, 2, 3, 4]],
                                  kv)


PREFILLS = {
    'slot0_short': (0, 5),
    'last_slot': (S - 1, 7),
    'slot_past_end_clamps': (S + 2, 4),
    'negative_slot_counts_from_end': (-1, 4),
    'negative_slot_past_start_clamps': (-S - 3, 4),
    'whole_cache_len': (2, T),
}


@pytest.mark.parametrize('name', sorted(PREFILLS))
def test_kv_cache_prefill_write_matches_reference(name):
    slot, L = PREFILLS[name]
    cache = _r(S, T, D, seed=4)
    kv = _r(1, L, D, seed=5)
    slot_a = np.array([[slot]], np.int32)
    got, scope = _port('kv_cache_prefill_write',
                       {'Cache': ('cache', cache), 'KV': ('kv', kv),
                        'Slot': ('slot', slot_a)}, persist={'cache'},
                       out='cache')
    want = _jax('kv_cache_prefill_write', {'Cache': cache, 'KV': kv,
                                           'Slot': slot_a})['Out']
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(scope.get('cache').numpy(), want)


# -- kv_cache_attention -----------------------------------------------------

ATTENTIONS = {
    'mixed_positions': [0, T - 1, 5, 9],
    'all_first_row': [0, 0, 0, 0],
    'all_full': [T - 1] * S,
}


def _attention(q, kc, vc, pos, attrs):
    ins = {'Q': ('q', q), 'KCache': ('kc', kc), 'VCache': ('vc', vc),
           'Pos': ('pos', pos)}
    return _port('kv_cache_attention', ins, attrs)[0]


@pytest.mark.parametrize('scale', [0.0, 0.3])
@pytest.mark.parametrize('name', sorted(ATTENTIONS))
def test_kv_cache_attention_matches_reference(name, scale):
    pos = np.asarray(ATTENTIONS[name], np.int32).reshape(S, 1)
    q, kc, vc = _r(S, D, seed=6), _r(S, T, D, seed=7), _r(S, T, D, seed=8)
    attrs = {'n_head': H, 'scale': scale}
    got = _attention(q, kc, vc, pos, attrs)
    want = _jax('kv_cache_attention', {'Q': q, 'KCache': kc, 'VCache': vc,
                                       'Pos': pos}, attrs)['Out']
    assert got.shape == want.shape == (S, D)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_kv_cache_attention_masked_rows_and_other_slots_have_no_effect():
    """Rows j > pos hold finite garbage (large values): the output is the
    same bits as with zeros there, and a slot's output does not move when
    every other slot's query, cache and position change, as continuous
    batching needs."""
    pos = np.array([[3], [0], [T - 1], [7]], np.int32)
    q, kc, vc = _r(S, D, seed=9), _r(S, T, D, seed=10), _r(S, T, D, seed=11)
    attrs = {'n_head': H}
    base = _attention(q, kc, vc, pos, attrs)
    garbage_k, garbage_v = kc.copy(), vc.copy()
    for s, p in enumerate(pos[:, 0]):
        garbage_k[s, p + 1:] = _r(T - p - 1, D, seed=12 + s, scale=1e4)
        garbage_v[s, p + 1:] = _r(T - p - 1, D, seed=20 + s, scale=1e4)
    np.testing.assert_array_equal(
        _attention(q, garbage_k, garbage_v, pos, attrs), base)
    others_q, others_k, others_v = (_r(S, D, seed=30),
                                    _r(S, T, D, seed=31),
                                    _r(S, T, D, seed=32))
    for s in range(S):
        q2, k2, v2 = others_q.copy(), others_k.copy(), others_v.copy()
        q2[s], k2[s], v2[s] = q[s], kc[s], vc[s]
        pos2 = np.full((S, 1), T - 1, np.int32)
        pos2[s] = pos[s]
        np.testing.assert_array_equal(
            _attention(q2, k2, v2, pos2, attrs)[s], base[s])
