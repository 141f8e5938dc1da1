"""Block-paged and speculative decode serving, the port held against
paddle_tpu on the CPU.

1. Each new op (kv_block_write, kv_block_attention, kv_block_chunk_write,
   kv_block_chunk_attention, kv_cache_verify_write,
   kv_cache_verify_attention, kv_block_verify_write,
   kv_block_verify_attention) on the same seeded numpy inputs as
   paddle_tpu's lowering: writes equal exactly (where pad rows of a block
   write collide in the trash block, which nothing reads, block 0 is left
   out: the order of colliding writes is unspecified in both packages);
   attention within OP_TOL = 1e-5 of its largest |value|.
2. The slice as a whole, at SPEC (vocab 67, d_model 32, 4 heads, 2 layers,
   d_ff 64, 4 slots, cache 48, block_size 4, chunk_sizes (4, 8),
   draft_k 3), paddle_tpu's weights carried to the port with
   weights.params_from_numpy (the block pool and the verify program need
   nothing more): the programs op for op; a fixed dispatch sequence (the
   chunk slices of four prompts, TF_STEPS steps of all four slots, two
   verify dispatches and a step after them), each dispatch's logits
   within TOL = 1e-5 of its largest |logit|, teacher-forced on the
   reference's greedy tokens; then the greedy and beam-3 transcripts of
   paddle_tpu's DecodingPredictor against the port's under the margin
   rule of tests/test_torch_decode_cross.py (a step is compared only where
   the reference's top-two gap exceeds twice the error the logits or the
   beam scores can carry; a smaller gap fails the test, the comparison is
   never shortened).

paddle_tpu's side runs once, in a fresh interpreter (this file run as a
script, with PTPU_ARTIFACT_AOT=0 and export_decode(precompile=False), so
that its DecodingPredictor jit-compiles its programs and loads no AOT
sidecar). It writes the op outputs, the parameters, the dispatch
sequence's logits (through its DecodingPredictor's own dispatch methods)
and the served transcripts with each step's margins.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import DecodingPredictor, export_decode
from paddle_tpu_torch.models.transformer import build_decode_spec

SPEC = dict(vocab=67, d_model=32, n_head=4, n_layer=2, d_ff=64,
            max_slots=4, max_cache_len=48, prompt_buckets=(4, 8), eos_id=1,
            block_size=4, chunk_sizes=(4, 8), draft_k=3)
MAXB = -(-SPEC['max_cache_len'] // SPEC['block_size'])
TOL = 1e-5
OP_TOL = 1e-5
TF_STEPS = 6
GREEDY_NEW = 12
BEAM, BEAM_NEW = 3, 8


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its programs are a few
    dozen rows wide, and torch's thread pool would only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(seed, n, hi=21):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, SPEC['vocab'], int(rng.randint(2, hi)))
            for _ in range(n)]


# lengths 5, 11, 3 and 17: one, two, one and three chunk slices
SLOT_PROMPTS = [np.random.RandomState(40 + n).randint(2, SPEC['vocab'], n)
                for n in (5, 11, 3, 17)]
GREEDY_PROMPTS = _prompts(41, 6)
BEAM_PROMPTS = _prompts(42, 2)

# -- 1. the ops --------------------------------------------------------------
NB, BS, D, H, S, T, R = 9, 4, 8, 2, 3, 16, 4
OP_MAXB = T // BS
# slot 0 owns four blocks, slot 1 two (the rest of its table is trash),
# slot 2 is idle (all trash)
TABLES = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32)


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _i32(a, *shape):
    return np.asarray(a, np.int32).reshape(shape)


def _op_cases():
    """{case: (op type, {slot: numpy}, attrs, the cache slot or None,
    whether block 0 is compared)}, the same in both processes."""
    c = {}
    pool = _r(NB, BS, D, seed=1)
    for name, pos, trash in (('mid', [5, 6, 0], True),
                             ('span_edge_and_past', [15, 16, 3], True),
                             ('unallocated_entry', [0, 9, 7], True)):
        c['kv_block_write/' + name] = (
            'kv_block_write', {'Cache': pool, 'KV': _r(S, D, seed=2),
                               'Pos': _i32(pos, S, 1), 'BlockTable': TABLES},
            {}, 'Cache', trash)
    for name, pos in (('mid', [5, 6, 0]), ('full_and_trash', [15, 7, 3]),
                      ('first_rows', [0, 0, 0])):
        for scale in (0.0, 0.3):
            c['kv_block_attention/%s/%g' % (name, scale)] = (
                'kv_block_attention',
                {'Q': _r(S, D, seed=3), 'KCache': pool,
                 'VCache': _r(NB, BS, D, seed=4), 'Pos': _i32(pos, S, 1),
                 'BlockTable': TABLES},
                {'n_head': H, 'scale': scale}, None, True)
    for name, start, row in (('first_chunk', 0, TABLES[0]),
                             ('overflows_span', 12, TABLES[0]),
                             ('past_allocated', 4, TABLES[1])):
        table = _i32(row, 1, OP_MAXB)
        c['kv_block_chunk_write/' + name] = (
            'kv_block_chunk_write',
            {'Cache': pool, 'KV': _r(1, 8, D, seed=5),
             'Start': _i32([start], 1, 1), 'BlockTable': table},
            {}, 'Cache', True)
        c['kv_block_chunk_attention/' + name] = (
            'kv_block_chunk_attention',
            {'Q': _r(1, 8, D, seed=6), 'KCache': pool,
             'VCache': _r(NB, BS, D, seed=7), 'Start': _i32([start], 1, 1),
             'BlockTable': table},
            {'n_head': H, 'scale': 0.0}, None, True)
    cache = _r(S, T, D, seed=8)
    for name, pos in (
            ('drafted_and_pad', [[5, 6, 7, 8], [9, 10, T, T], [T] * 4]),
            ('reaches_cache_end', [[13, 14, 15, T], [15, T, T, T],
                                   [0, 1, 2, 3]]),
            ('negative_counts_from_end', [[-2, -1, T, T], [3, 4, 5, 6],
                                          [T] * 4])):
        c['kv_cache_verify_write/' + name] = (
            'kv_cache_verify_write', {'Cache': cache,
                                      'KV': _r(S, R, D, seed=9),
                                      'Pos': _i32(pos, S, R)},
            {}, 'Cache', True)
        if name != 'negative_counts_from_end':
            c['kv_cache_verify_attention/' + name] = (
                'kv_cache_verify_attention',
                {'Q': _r(S, R, D, seed=10), 'KCache': cache,
                 'VCache': _r(S, T, D, seed=11), 'Pos': _i32(pos, S, R)},
                {'n_head': H, 'scale': 0.0}, None, True)
    pad = OP_MAXB * BS
    for name, pos in (
            ('drafted_and_pad', [[5, 6, 7, 8], [6, 7, pad, pad],
                                 [pad] * 4]),
            ('into_unallocated_entry', [[12, 13, 14, 15], [7, 8, 9, pad],
                                        [pad] * 4])):
        c['kv_block_verify_write/' + name] = (
            'kv_block_verify_write', {'Cache': pool,
                                      'KV': _r(S, R, D, seed=12),
                                      'Pos': _i32(pos, S, R),
                                      'BlockTable': TABLES},
            {}, 'Cache', False)
        c['kv_block_verify_attention/' + name] = (
            'kv_block_verify_attention',
            {'Q': _r(S, R, D, seed=13), 'KCache': pool,
             'VCache': _r(NB, BS, D, seed=14), 'Pos': _i32(pos, S, R),
             'BlockTable': TABLES},
            {'n_head': H, 'scale': 0.0}, None, True)
    return c


class _JaxCtx(object):
    """The part of paddle_tpu's OpCtx that these lowerings read."""

    def __init__(self, attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _jax_ops():
    import jax.numpy as jnp
    from paddle_tpu.core import registry as jax_registry
    out = {}
    for case, (op, ins, attrs, _, _) in _op_cases().items():
        got = jax_registry.get(op).lower(
            _JaxCtx(attrs), {k: [jnp.asarray(v)] for k, v in ins.items()})
        out[case] = np.asarray(got['Out'][0])
    return out


def _port_op(op, ins, attrs, cache_slot):
    """op as a one-op program run by the port's Executor on the CPU, the
    cache (if any) a persistable var in the scope; returns Out."""
    main = ptt.Program()
    scope = ptt.Scope()
    feed = {}
    with ptt.program_guard(main, ptt.Program()), ptt.unique_name.guard():
        block = main.global_block()
        for slot, arr in ins.items():
            name = slot.lower()
            if slot == cache_slot:
                block.create_var(name=name, shape=arr.shape,
                                 dtype=str(arr.dtype), persistable=True)
                scope.set(name, torch.from_numpy(arr.copy()))
            else:
                ptt.layers.data(name, shape=list(arr.shape),
                                dtype=str(arr.dtype),
                                append_batch_size=False)
                feed[name] = arr
        out = cache_slot.lower() if cache_slot else 'out'
        if not block.has_var(out):
            block.create_var(name=out, dtype='float32')
        block.append_op(type=op, inputs={s: [s.lower()] for s in ins},
                        outputs={'Out': [out]}, attrs=dict(attrs))
    got, = ptt.Executor(ptt.CPUPlace()).run(main, feed=feed,
                                            fetch_list=[out], scope=scope)
    if cache_slot:
        # the write went into the scope's tensor itself
        np.testing.assert_array_equal(scope.get(out).numpy(), got)
    return got


# -- 2. the slice ------------------------------------------------------------
def _table_rows():
    """A fixed block table a slot: slot s owns blocks 1 + s*MAXB .. (the
    default pool has max_slots * MAXB + 1 blocks)."""
    return np.arange(1, 1 + SPEC['max_slots'] * MAXB, dtype=np.int32
                     ).reshape(SPEC['max_slots'], MAXB)


def _dispatches(pred, ref=None):
    """The logits of a fixed dispatch sequence on a block-layout
    predictor (either package's; their dispatch methods take the same
    arguments): SLOT_PROMPTS admitted through chunk slices into slots
    0..3, TF_STEPS steps of the four, a verify dispatch of slots 0-2 (three
    random draft tokens; slot 3 all pad), a second one whose slot 1 rows
    start one position back (rejected rows written over), and one step
    after them. Each dispatch's tokens are the argmax of the reference's
    logits of the dispatch that produced them (`ref`, when given) else of
    this side's own. Returns the list of logits."""
    out = []
    tables = _table_rows()
    chunks = sorted(SPEC['chunk_sizes'])
    pad = MAXB * SPEC['block_size']
    S_ = SPEC['max_slots']

    def pick(i, axis=None):
        return np.argmax((ref if ref is not None else out)[i], axis=axis)
    last = []
    for s, p in enumerate(SLOT_PROMPTS):
        start = 0
        while start < len(p):
            rem = len(p) - start
            size = min(c for c in chunks if min(rem, chunks[-1]) <= c)
            take = min(size, rem)
            ids = np.zeros((1, size), np.int64)
            ids[0, :take] = p[start:start + take]
            out.append(np.asarray(pred._dispatch_chunk(
                size, ids, start, take, tables[s:s + 1]))[None])
            start += take
        last.append(int(pick(len(out) - 1)))
    lens = np.array([len(p) for p in SLOT_PROMPTS])
    for t in range(TF_STEPS):
        out.append(np.asarray(pred._dispatch_step(
            np.asarray(last, np.int64).reshape(S_, 1),
            (lens + t).astype(np.int32).reshape(S_, 1), tables)))
        last = [int(i) for i in pick(len(out) - 1, axis=1)]
    p0 = lens + TF_STEPS
    rng = np.random.RandomState(43)
    Rv = SPEC['draft_k'] + 1
    for back in (0, 1):
        tok = np.zeros((S_, Rv), np.int64)
        pos = np.full((S_, Rv), pad, np.int32)
        for s in range(3):
            start = p0[s] - (back if s == 1 else 0)
            tok[s, 0] = last[s]
            tok[s, 1:] = rng.randint(2, SPEC['vocab'], Rv - 1)
            pos[s] = start + np.arange(Rv)
        out.append(np.asarray(pred._dispatch_verify(tok, pos, tables)))
    out.append(np.asarray(pred._dispatch_step(
        np.asarray(last, np.int64).reshape(S_, 1),
        p0.astype(np.int32).reshape(S_, 1), tables)))
    return out


def _gaps(values, k):
    """The gaps between the k+1 largest of `values`, best first."""
    top = np.sort(np.asarray(values, np.float64).ravel())[::-1][:k + 1]
    return [float(top[i] - top[i + 1]) for i in range(k)]


def _log_softmax(row):
    x = np.asarray(row, np.float64)
    x = x - x.max()
    return x - np.log(np.exp(x).sum())


def _jax_reference(root):
    """paddle_tpu's side, written under root: ops.npz, params.npz,
    logits.npz (_dispatches) and served.json (greedy and beam transcripts
    with each step's margin and largest |logit|)."""
    np.savez(os.path.join(root, 'ops.npz'),
             **{k.replace('/', '|'): v for k, v in _jax_ops().items()})
    import paddle_tpu as fluid
    from paddle_tpu.inference import DecodingPredictor as JaxPredictor
    from paddle_tpu.inference import export_decode as jax_export
    from models.transformer import build_decode_spec as jax_build
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        with fluid.unique_name.guard():
            spec = jax_build(**SPEC)
        fluid.Executor(fluid.CPUPlace()).run(spec['startup'])
        params = {v.name: np.asarray(scope.find_var(v.name).get_tensor())
                  for v in spec['startup'].list_vars() if v.persistable}
        np.savez(os.path.join(root, 'params.npz'), **params)
        art = os.path.join(root, 'art')
        jax_export(spec, art, scope=scope, precompile=False)
    served = {'greedy': [], 'beam': []}
    with JaxPredictor(art) as pred:
        logits = _dispatches(pred)
        np.savez(os.path.join(root, 'logits.npz'),
                 **{'d%03d' % i: a for i, a in enumerate(logits)})
        pred._reset_state()
        rec = []
        first0, adv0, score0 = (pred._first_token, pred._advance_greedy,
                                pred._score_beam)

        def first(req, lg):
            rec.append(np.asarray(lg)[None])
            return first0(req, lg)

        def adv(req, lg, now):
            rec.append(np.asarray(lg)[req.slots[:1]])
            return adv0(req, lg, now)

        def score(req, lg):
            W, V = req.beam, pred._vocab
            cand = np.full((W, V), -np.inf, np.float64)
            for i in range(W):
                if req.finished[i]:
                    cand[i, pred._eos] = req.scores[i]
                else:
                    cand[i] = req.scores[i] + _log_softmax(lg[req.slots[i]])
            gaps.append(min(_gaps(cand, W)))
            scales.append(float(max(np.abs(lg[s]).max()
                                    for s in req.slots)))
            return score0(req, lg)
        pred._first_token, pred._advance_greedy = first, adv
        pred._score_beam = score
        for p in GREEDY_PROMPTS:
            del rec[:]
            toks = pred.generate(p, max_new_tokens=GREEDY_NEW)
            served['greedy'].append({
                'tokens': [int(t) for t in toks],
                'margins': [_gaps(a[0], 1)[0] for a in rec],
                'scales': [float(np.abs(a[0]).max()) for a in rec]})
        for p in BEAM_PROMPTS:
            del rec[:]
            gaps, scales = [], []
            ids, sc = pred.generate(p, max_new_tokens=BEAM_NEW, beam=BEAM)
            f = rec[0][0]
            served['beam'].append({
                'ids': np.asarray(ids).tolist(),
                'scores': np.asarray(sc).tolist(),
                'margins': [min(_gaps(_log_softmax(f), BEAM))] + gaps,
                'scales': [float(np.abs(f).max())] + scales})
    with open(os.path.join(root, 'served.json'), 'w') as f:
        json.dump(served, f)


@pytest.fixture(scope='module')
def jax_side(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('decode_block_cross'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PTPU_ARTIFACT_AOT='0', PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with np.load(os.path.join(root, 'ops.npz')) as f:
        ops = {k.replace('|', '/'): f[k] for k in f.files}
    with np.load(os.path.join(root, 'params.npz')) as f:
        params = dict(f)
    with np.load(os.path.join(root, 'logits.npz')) as f:
        logits = [f['d%03d' % i] for i in range(len(f.files))]
    with open(os.path.join(root, 'served.json')) as f:
        served = json.load(f)
    return ops, params, logits, served


@pytest.fixture(scope='module')
def port_side(jax_side, tmp_path_factory):
    """The port's spec with paddle_tpu's weights (the startup's every
    persistable: the parameters and the zero block pool), and the artifact
    the port exports from it."""
    params = jax_side[1]
    with ptt.unique_name.guard():
        spec = build_decode_spec(**SPEC)
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(params, spec['startup'], scope)
    art = str(tmp_path_factory.mktemp('decode_block_cross_port') / 'art')
    export_decode(spec, art, scope=scope)
    return spec, art


@pytest.mark.parametrize('case', sorted(_op_cases()))
def test_op_matches_reference(jax_side, case):
    op, ins, attrs, cache_slot, trash = _op_cases()[case]
    want = jax_side[0][case]
    got = _port_op(op, ins, attrs, cache_slot)
    assert got.shape == want.shape and got.dtype == want.dtype
    if cache_slot is None:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=OP_TOL * np.abs(want).max())
    elif trash:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got[1:], want[1:])


@pytest.mark.parametrize('which', ['startup', 'step', 'chunk4', 'chunk8',
                                   'verify', 'slot_verify'])
def test_programs_match_reference(which):
    """The block spec's programs and the slot layout's verify program, op
    for op (types, inputs, outputs, attrs) and var for var. One op is the
    port's own: a chunk program clamps its position-encoding gather's
    index (`clip`, named chunk_pe_idx, as the verify program already
    does), since a final slice's pad rows may run past the table and the
    port's gather refuses such an index where the reference's fills NaN.
    It is taken out, the gather reading its input again, before the
    comparison."""
    import paddle_tpu as fluid
    from models.transformer import build_decode_spec as jax_build
    kw = dict(SPEC)
    if which == 'slot_verify':
        for k in ('block_size', 'chunk_sizes'):
            kw.pop(k)
    with fluid.unique_name.guard():
        js = jax_build(**kw)
    with ptt.unique_name.guard():
        ts = build_decode_spec(**kw)

    def prog(spec):
        if which == 'startup':
            return spec['startup']
        if which.startswith('chunk'):
            return spec['chunk'][int(which[len('chunk'):])]['program']
        return spec['verify' if 'verify' in which else which]['program']

    def ops(p):
        return [(op.type, {k: list(v) for k, v in op.inputs.items()},
                 {k: list(v) for k, v in op.outputs.items()},
                 json.dumps({k: np.asarray(v).tolist()
                             if isinstance(v, np.ndarray) else v
                             for k, v in op.attrs.items()}, sort_keys=True,
                            default=str))
                for op in p.global_block().ops]

    def var_decls(p):
        return {v.name: (tuple(v.shape), str(v.dtype), v.persistable)
                for v in p.list_vars()}

    def without_pe_clip(got, decls):
        if not which.startswith('chunk'):
            return got, decls
        at = [i for i, o in enumerate(got) if o[0] == 'clip']
        assert len(at) == 1, got
        _, ins, outs, attrs = got.pop(at[0])
        attrs = json.loads(attrs)
        uid = attrs.pop('_op_uid')
        assert attrs == {'min': 0, 'max': SPEC['max_cache_len'] - 1}
        (src,), (dst,) = ins['X'], outs['Out']
        assert dst.startswith('chunk_pe_idx.tmp_')
        decls.pop(dst)
        gather = got[at[0]]
        assert gather[0] == 'gather' and gather[1]['Index'] == [dst]
        gather[1]['Index'] = [src]
        for i in range(at[0], len(got)):
            # the ops after it were numbered one later
            a = json.loads(got[i][3])
            if a.get('_op_uid', 0) > uid:
                a['_op_uid'] -= 1
            got[i] = got[i][:3] + (json.dumps(a, sort_keys=True),)
        return got, decls
    got, decls = without_pe_clip(ops(prog(ts)), var_decls(prog(ts)))
    assert got == ops(prog(js))
    assert decls == var_decls(prog(js))
    keys = ('layout', 'block_size', 'num_blocks', 'max_blocks_per_slot',
            'cache_vars', 'draft_k')
    assert {k: ts.get(k) for k in keys} == {k: js.get(k) for k in keys}


def test_weights_carry_across(jax_side, port_side):
    """The reference's startup persistables are exactly the port's: every
    program of the block spec (chunks and verify included) reads only
    parameters the startup makes, so params_from_numpy of the reference's
    arrays gives the port's block and draft_k specs all their weights."""
    spec, _ = port_side
    made = {v.name for v in spec['startup'].list_vars() if v.persistable}
    assert made == set(jax_side[1])
    for e in ([spec['step'], spec['verify']] + list(spec['chunk'].values())):
        read = {v.name for v in e['program'].list_vars() if v.persistable}
        assert read <= made


def test_teacher_forced_chunk_step_verify_logits(jax_side, port_side):
    """The dispatch sequence through the port's DecodingPredictor (the
    artifact the port exported from the reference's weights): every chunk
    slice's, step's and verify dispatch's logits within TOL of the largest
    |logit|, each step fed the reference's own greedy tokens."""
    ref = jax_side[2]
    with DecodingPredictor(port_side[1], place=ptt.CPUPlace()) as pred:
        got = _dispatches(pred, ref)
    assert len(got) == len(ref) == 7 + TF_STEPS + 3
    for g, r in zip(got, ref):
        assert g.shape == r.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL * np.abs(r).max())


def test_greedy_transcripts_under_margin_rule(jax_side, port_side):
    """The port's block-layout DecodingPredictor, all prompts submitted
    together, gives the reference's greedy transcripts (served one at a
    time) in full; every reference step's top-two gap first shown to
    exceed 2·TOL of its largest |logit|."""
    served = jax_side[3]
    for i, rec in enumerate(served['greedy']):
        assert len(rec['margins']) == len(rec['tokens'])
        small = [(t, m) for t, (m, s) in enumerate(zip(rec['margins'],
                                                        rec['scales']))
                 if m <= 2 * TOL * s]
        assert not small, ('prompt %d: reference top-two gaps at or below '
                           '2*TOL at (step, gap) %s' % (i, small))
    with DecodingPredictor(port_side[1], place=ptt.CPUPlace()) as pred:
        streams = [pred.submit(p, max_new_tokens=GREEDY_NEW)
                   for p in GREEDY_PROMPTS]
        got = [s.result(120) for s in streams]
    assert got == [rec['tokens'] for rec in served['greedy']]


def test_beam_transcripts_under_margin_rule(jax_side, port_side):
    """Beam-3 hypotheses in the block layout (forked tables, copy on
    write) equal the reference's exactly, their scores within the error a
    score can carry (4·TOL of the largest |logit| a step), every step's
    gaps between the W+1 best reference candidates first shown to exceed
    twice that error."""
    served = jax_side[3]
    with DecodingPredictor(port_side[1], place=ptt.CPUPlace()) as pred:
        streams = [pred.submit(p, max_new_tokens=BEAM_NEW, beam=BEAM)
                   for p in BEAM_PROMPTS]
        got = [s.result(120) for s in streams]
        snap = pred.stats.snapshot()
    for i, (rec, (ids, scores)) in enumerate(zip(served['beam'], got)):
        err = np.cumsum([4 * TOL * s for s in rec['scales']])
        small = [(t, m) for t, (m, e) in enumerate(zip(rec['margins'], err))
                 if m <= 2 * e]
        assert not small, ('beam prompt %d: reference candidate gaps at or '
                           'below twice the score error at (step, gap) %s'
                           % (i, small))
        np.testing.assert_array_equal(ids, np.asarray(rec['ids']))
        np.testing.assert_allclose(scores, rec['scores'], rtol=0,
                                   atol=err[-1])
    assert snap['cow_blocks'] > 0


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
