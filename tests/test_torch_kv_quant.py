"""The int8 KV cache of decode serving on the port, held against paddle_tpu
on the CPU.

1. The eleven int8 KV ops (kv_cache_write_quant,
   kv_cache_prefill_write_quant, kv_cache_attention_quant,
   kv_block_write_quant, kv_block_attention_quant,
   kv_block_chunk_write_quant, kv_block_chunk_attention_quant,
   kv_cache_verify_write_quant, kv_cache_verify_attention_quant,
   kv_block_verify_write_quant, kv_block_verify_attention_quant) on the
   same seeded numpy inputs as the reference's lowerings: the int8 pages
   equal, the scales within one f32 ulp, each attention within OP_TOL =
   1e-5 of its largest |value|. Where pad rows of a block write collide
   in the trash block (nothing reads it; the order of colliding writes is
   unspecified in both packages) block 0 is left out.
2. Int8 decode serving at SPEC (vocab 67, d_model 32, 4 heads, 2 layers,
   d_ff 64, 4 slots, cache 48, draft_k 3), slot layout (prompt buckets 4
   and 8) and block layout (block size 4, chunks 4 and 8), paddle_tpu's
   weights carried to the port with weights.params_from_numpy: the greedy
   transcripts of the port's DecodingPredictor, plain and with n-gram
   drafting (the verify program, no draft errors), all prompts submitted
   together, equal to the reference's plain transcripts (served one at a
   time) under the margin rule of tests/test_torch_decode_cross.py at TOL
   = 1e-4 (every reference step's top-two gap first shown to exceed
   2*TOL of its largest |logit|; a smaller gap fails the test): an f32
   K or V row that differs by an ulp between the packages can quantize
   one level apart, a ~1e-5 relative move of the logits. A beam-3
   request in the block layout copies blocks on write.
3. The tier against the fp cache (the reference's own gate,
   tests/test_quantize.py:392-431): the port's int8 transcripts at twice
   the slots agree with the fp tier's on the same weights in at least 85%
   of their tokens, the int8 cache at 2x the slots takes fewer bytes than
   the fp cache, stats.tier reads 'int8' and 'bf16'; DecodingPredictor(
   tier='int8') resolves the int8 tree under an artifact and refuses an
   artifact without one; export_decode refuses a kv_cache_dtype the spec
   was not built with.

paddle_tpu's side runs once, in a fresh interpreter (this file run as a
script, PTPU_ARTIFACT_AOT=0 and export_decode(precompile=False)).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.inference import DecodingPredictor, export_decode
from paddle_tpu_torch.models.transformer import build_decode_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(vocab=67, d_model=32, n_head=4, n_layer=2, d_ff=64,
            max_slots=4, max_cache_len=48, prompt_buckets=(4, 8), eos_id=1,
            kv_cache_dtype='int8', draft_k=3)
BLOCK = dict(block_size=4, chunk_sizes=(4, 8))
LAYOUTS = {'slot': {}, 'block': BLOCK}
OP_TOL = 1e-5
TOL = 1e-4
GREEDY_NEW = 12
MATCH_GATE = 0.85


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its programs are a few
    dozen rows wide, and torch's thread pool would only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts():
    rng = np.random.RandomState(41)
    # a repeated phrase gives the n-gram drafter something to propose
    out = [rng.randint(2, SPEC['vocab'], int(rng.randint(2, 9)))
           for _ in range(5)]
    out.append(np.tile(rng.randint(2, SPEC['vocab'], 2), 4))
    return out


# -- 1. the ops --------------------------------------------------------------
NB, BS, D, H, S, T, R = 9, 4, 8, 2, 3, 16, 4
MAXB = T // BS
TABLES = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32)


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _i8(*shape, seed=0):
    return np.random.RandomState(seed).randint(-127, 128, shape).astype(
        np.int8)


def _sc(*shape, seed=0):
    return (np.random.RandomState(seed).rand(*shape) * 0.05 + 1e-3).astype(
        np.float32)


def _i32(a, *shape):
    return np.asarray(a, np.int32).reshape(shape)


def _op_cases():
    """{case: (op type, {slot: numpy}, attrs, whether block 0 is
    compared)}, the same in both processes. A write's Cache and Scale are
    its outputs."""
    c = {}
    pages, scales = _i8(S, T, D, seed=1), _sc(S, T, seed=2)
    kv = _r(S, D, seed=3)
    kv[1] = 0.0                         # an all-zero row: the floor scale
    for name, pos in (('mid', [5, 15, 0]), ('clamped', [16, 20, 3]),
                      ('negative', [-1, 2, 7])):
        c['kv_cache_write_quant/' + name] = (
            'kv_cache_write_quant', {'Cache': pages, 'Scale': scales,
                                     'KV': kv, 'Pos': _i32(pos, S, 1)},
            {}, True)
    for slot in (1, 5):
        c['kv_cache_prefill_write_quant/slot%d' % slot] = (
            'kv_cache_prefill_write_quant',
            {'Cache': pages, 'Scale': scales, 'KV': _r(1, 8, D, seed=4),
             'Slot': _i32([slot], 1, 1)}, {}, True)
    kpages, kscales = _i8(S, T, D, seed=5), _sc(S, T, seed=6)
    for name, pos in (('mid', [5, 15, 0]), ('first_rows', [0, 0, 0])):
        for scale in (0.0, 0.3):
            c['kv_cache_attention_quant/%s/%g' % (name, scale)] = (
                'kv_cache_attention_quant',
                {'Q': _r(S, D, seed=7), 'KCache': kpages, 'KScale': kscales,
                 'VCache': pages, 'VScale': scales, 'Pos': _i32(pos, S, 1)},
                {'n_head': H, 'scale': scale}, True)
    pool, pscale = _i8(NB, BS, D, seed=8), _sc(NB, BS, seed=9)
    vpool, vscale = _i8(NB, BS, D, seed=10), _sc(NB, BS, seed=11)
    for name, pos in (('mid', [5, 6, 0]), ('span_edge_and_past', [15, 16, 3]),
                      ('unallocated_entry', [0, 9, 7])):
        c['kv_block_write_quant/' + name] = (
            'kv_block_write_quant',
            {'Cache': pool, 'Scale': pscale, 'KV': _r(S, D, seed=12),
             'Pos': _i32(pos, S, 1), 'BlockTable': TABLES}, {}, True)
        c['kv_block_attention_quant/' + name] = (
            'kv_block_attention_quant',
            {'Q': _r(S, D, seed=13), 'KCache': pool, 'KScale': pscale,
             'VCache': vpool, 'VScale': vscale, 'Pos': _i32(pos, S, 1),
             'BlockTable': TABLES}, {'n_head': H, 'scale': 0.0}, True)
    for name, start, row in (('first_chunk', 0, TABLES[0]),
                             ('second_chunk', 8, TABLES[0]),
                             ('overflows_span', 12, TABLES[0]),
                             ('past_allocated', 4, TABLES[1])):
        table = _i32(row, 1, MAXB)
        c['kv_block_chunk_write_quant/' + name] = (
            'kv_block_chunk_write_quant',
            {'Cache': pool, 'Scale': pscale, 'KV': _r(1, 8, D, seed=14),
             'Start': _i32([start], 1, 1), 'BlockTable': table}, {}, True)
        c['kv_block_chunk_attention_quant/' + name] = (
            'kv_block_chunk_attention_quant',
            {'Q': _r(1, 8, D, seed=15), 'KCache': pool, 'KScale': pscale,
             'VCache': vpool, 'VScale': vscale, 'K': _r(1, 8, D, seed=16),
             'V': _r(1, 8, D, seed=17), 'Start': _i32([start], 1, 1),
             'BlockTable': table}, {'n_head': H, 'scale': 0.0}, True)
    for name, pos in (
            ('drafted_and_pad', [[5, 6, 7, 8], [9, 10, T, T], [T] * 4]),
            ('reaches_cache_end', [[13, 14, 15, T], [15, T, T, T],
                                   [0, 1, 2, 3]])):
        c['kv_cache_verify_write_quant/' + name] = (
            'kv_cache_verify_write_quant',
            {'Cache': pages, 'Scale': scales, 'KV': _r(S, R, D, seed=18),
             'Pos': _i32(pos, S, R)}, {}, True)
        c['kv_cache_verify_attention_quant/' + name] = (
            'kv_cache_verify_attention_quant',
            {'Q': _r(S, R, D, seed=19), 'KCache': kpages, 'KScale': kscales,
             'VCache': pages, 'VScale': scales, 'Pos': _i32(pos, S, R)},
            {'n_head': H, 'scale': 0.0}, True)
    pad = MAXB * BS
    for name, pos in (
            ('drafted_and_pad', [[5, 6, 7, 8], [6, 7, pad, pad],
                                 [pad] * 4]),
            ('into_unallocated_entry', [[12, 13, 14, 15], [7, 8, 9, pad],
                                        [pad] * 4])):
        c['kv_block_verify_write_quant/' + name] = (
            'kv_block_verify_write_quant',
            {'Cache': pool, 'Scale': pscale, 'KV': _r(S, R, D, seed=20),
             'Pos': _i32(pos, S, R), 'BlockTable': TABLES}, {}, False)
        c['kv_block_verify_attention_quant/' + name] = (
            'kv_block_verify_attention_quant',
            {'Q': _r(S, R, D, seed=21), 'KCache': pool, 'KScale': pscale,
             'VCache': vpool, 'VScale': vscale, 'Pos': _i32(pos, S, R),
             'BlockTable': TABLES}, {'n_head': H, 'scale': 0.0}, True)
    return c


class _Ctx(object):
    """The part of an op context these lowerings read."""

    def __init__(self, attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _outs(got):
    """(Out, OutScale) of a write, (Out,) of an attention."""
    return tuple(np.asarray(got[k][0]) for k in ('Out', 'OutScale')
                 if k in got)


def _jax_ops():
    """Each case through the reference's lowering, jitted as its serving
    programs run it."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core import registry as jax_registry
    out = {}
    for case, (op, ins, attrs, _) in _op_cases().items():
        lower = jax.jit(lambda a, op=op, attrs=attrs: jax_registry.get(
            op).lower(_Ctx(attrs), {k: [v] for k, v in a.items()}))
        got = lower({k: jnp.asarray(v) for k, v in ins.items()})
        for i, a in enumerate(_outs(got)):
            out['%s|%d' % (case, i)] = a
    return out


# -- 2. serving --------------------------------------------------------------
def _gaps(values, k):
    top = np.sort(np.asarray(values, np.float64).ravel())[::-1][:k + 1]
    return [float(top[i] - top[i + 1]) for i in range(k)]


def _jax_reference(root):
    """paddle_tpu's side, under root: ops.npz; for each layout the int8
    spec's startup persistables (params_<layout>.npz) and its greedy
    transcripts with each step's top-two gap and largest |logit|
    (served.json)."""
    np.savez(os.path.join(root, 'ops.npz'), **_jax_ops())
    import paddle_tpu as fluid
    from paddle_tpu.inference import DecodingPredictor as JaxPredictor
    from paddle_tpu.inference import export_decode as jax_export
    from models.transformer import build_decode_spec as jax_build
    served = {}
    for layout, kw in LAYOUTS.items():
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            with fluid.unique_name.guard():
                spec = jax_build(**dict(SPEC, **kw))
            fluid.Executor(fluid.CPUPlace()).run(spec['startup'])
            np.savez(os.path.join(root, 'params_%s.npz' % layout), **{
                v.name: np.asarray(scope.find_var(v.name).get_tensor())
                for v in spec['startup'].list_vars() if v.persistable})
            art = os.path.join(root, 'art_' + layout)
            jax_export(spec, art, scope=scope, precompile=False)
        rec = []
        with JaxPredictor(art) as pred:
            first0, adv0 = pred._first_token, pred._advance_greedy

            def first(req, lg):
                rec.append(np.asarray(lg))
                return first0(req, lg)

            def adv(req, lg, now):
                rec.append(np.asarray(lg)[req.slots[0]])
                return adv0(req, lg, now)
            pred._first_token, pred._advance_greedy = first, adv
            plain = []
            for p in _prompts():
                del rec[:]
                toks = pred.generate(p, max_new_tokens=GREEDY_NEW)
                plain.append({'tokens': [int(t) for t in toks],
                              'margins': [_gaps(a, 1)[0] for a in rec],
                              'scales': [float(np.abs(a).max())
                                         for a in rec]})
            snap = pred.stats.snapshot()
        served[layout] = {'plain': plain, 'tier': snap['tier']}
    with open(os.path.join(root, 'served.json'), 'w') as f:
        json.dump(served, f)


@pytest.fixture(scope='module')
def jax_side(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('kv_quant_cross'))
    env = dict(os.environ, PTPU_ARTIFACT_AOT='0', PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with np.load(os.path.join(root, 'ops.npz')) as f:
        ops = dict(f)
    with open(os.path.join(root, 'served.json')) as f:
        served = json.load(f)
    return root, ops, served


def _params(root, layout):
    with np.load(os.path.join(root, 'params_%s.npz' % layout)) as f:
        return dict(f)


def _export(params, out_dir, **kw):
    """The port's spec (SPEC with kw) given `params` (a subset of its
    startup's persistables; the rest, the cache, as the startup makes
    them), exported to out_dir; returns the signature."""
    with ptt.unique_name.guard():
        spec = build_decode_spec(**dict(SPEC, **kw))
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(spec['startup'], scope=scope)
    for name, arr in params.items():
        scope.set(name, torch.from_numpy(arr.copy()))
    export_decode(spec, out_dir, scope=scope)
    with open(os.path.join(out_dir, 'decode_signature.json')) as f:
        return json.load(f)


@pytest.fixture(scope='module')
def port_arts(jax_side, tmp_path_factory):
    """{layout: artifact dir}: the port's int8 spec with the reference's
    weights, exported under <dir>/int8 (the tier's place in an artifact)."""
    root = tmp_path_factory.mktemp('kv_quant_port')
    out = {}
    for layout, kw in LAYOUTS.items():
        d = str(root / layout)
        _export(_params(jax_side[0], layout), os.path.join(d, 'int8'), **kw)
        out[layout] = d
    return out


@pytest.mark.parametrize('case', sorted(_op_cases()))
def test_op_matches_reference(jax_side, case):
    op, ins, attrs, trash = _op_cases()[case]
    t = {k: torch.from_numpy(v.copy()) for k, v in ins.items()}
    got = _outs({k: [v[0].numpy()] for k, v in registry.get(op).lower(
        _Ctx(attrs), {k: [v] for k, v in t.items()}).items()})
    for i, g in enumerate(got):
        want = jax_side[1]['%s|%d' % (case, i)]
        assert g.shape == want.shape and g.dtype == want.dtype
        if not trash:
            g, want = g[1:], want[1:]
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, want)
        elif 'write' in op:
            np.testing.assert_array_max_ulp(g, want, maxulp=1)
        else:
            np.testing.assert_allclose(g, want, rtol=0,
                                       atol=OP_TOL * np.abs(want).max())
    if 'write' in op:
        # in place: the op's outputs are its Cache and Scale tensors
        assert np.array_equal(t['Cache'].numpy(), got[0])
        assert np.array_equal(t['Scale'].numpy(), got[1])


def _ops(program):
    return [(op.type, {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()})
            for op in program.global_block().ops]


def test_programs_and_state(jax_side):
    """The int8 specs' step, verify and prefill programs op for op (types,
    inputs, outputs) against the reference's, and their state: the
    startup's persistables are the reference's, int8 pages and f32 scales
    at 1.0 ([S, T] or [num_blocks, block_size]), each layer's scales
    listed after its pages."""
    import paddle_tpu as fluid
    from models.transformer import build_decode_spec as jax_build
    for layout, kw in LAYOUTS.items():
        params = _params(jax_side[0], layout)
        with ptt.unique_name.guard():
            ts = build_decode_spec(**dict(SPEC, **kw))
        with fluid.unique_name.guard():
            js = jax_build(**dict(SPEC, **kw))
        assert ts['cache_vars'] == js['cache_vars']
        assert ts['cache_vars'][:4] == ['kv_k_0', 'kv_v_0', 'kv_ks_0',
                                        'kv_vs_0']
        assert {v.name for v in ts['startup'].list_vars()
                if v.persistable} == set(params)
        for n in ts['cache_vars']:
            scale = n.startswith(('kv_ks_', 'kv_vs_'))
            assert params[n].dtype.name == ('float32' if scale else 'int8')
            if scale:
                assert (params[n] == 1.0).all()
                assert list(params[n].shape) == (
                    [SPEC['max_slots'], SPEC['max_cache_len']]
                    if layout == 'slot' else
                    [ts['num_blocks'], BLOCK['block_size']])
        pairs = [(js['step'], ts['step']), (js['verify'], ts['verify'])]
        if layout == 'slot':
            pairs += [(js['prefill'][L], ts['prefill'][L])
                      for L in SPEC['prompt_buckets']]
        for je, te in pairs:
            assert _ops(te['program']) == _ops(je['program'])


def _rule(rec, got, label):
    """The margin rule: every reference step's gap first shown to exceed
    2*TOL of its largest |logit|, then the transcripts equal."""
    for i, r in enumerate(rec):
        small = [(t, m) for t, (m, s) in enumerate(zip(r['margins'],
                                                        r['scales']))
                 if m <= 2 * TOL * s]
        assert not small, ('%s prompt %d: reference top-two gaps at or '
                           'below 2*TOL at (step, gap) %s' % (label, i,
                                                               small))
    assert got == [r['tokens'] for r in rec], label


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_transcripts_under_margin_rule(jax_side, port_arts, layout):
    """Plain and n-gram-drafted greedy transcripts of the port's int8 tier,
    every prompt submitted at once, against the reference's plain ones."""
    want = jax_side[2][layout]
    assert want['tier'] == 'int8'
    for draft in (None, 'ngram'):
        with DecodingPredictor(port_arts[layout], place=ptt.CPUPlace(),
                               tier='int8', draft=draft) as pred:
            assert pred.layout == layout
            streams = [pred.submit(p, max_new_tokens=GREEDY_NEW)
                       for p in _prompts()]
            got = [s.result(120) for s in streams]
            snap = pred.stats.snapshot()
        assert snap['tier'] == 'int8'
        if draft:
            assert snap['verify_steps'] > 0 and snap['draft_errors'] == 0
            assert 0 < snap['accepted'] <= snap['drafted']
        _rule(want['plain'], got, '%s %s' % (layout, draft))


def test_block_beam_copies_on_write(port_arts):
    """A beam-3 request on the int8 block pool forks tables and copies
    blocks (pages and scales) on write; its hypotheses equal a second run
    of the same request beside greedy traffic."""
    p = _prompts()[0]
    with DecodingPredictor(port_arts['block'], place=ptt.CPUPlace(),
                           tier='int8') as pred:
        solo = pred.generate(p, max_new_tokens=8, beam=3)
        snap = pred.stats.snapshot()
        beam = pred.submit(p, max_new_tokens=8, beam=3)
        greedy = pred.submit(_prompts()[1], max_new_tokens=8)
        got = beam.result(120)
        greedy.result(120)
    assert snap['cow_blocks'] > 0
    np.testing.assert_array_equal(got[0], solo[0])
    np.testing.assert_array_equal(got[1], solo[1])


def test_int8_tier_against_fp_tier(jax_side, tmp_path):
    """The reference's fixed-bytes gate: the int8 cache at twice the slots
    takes fewer bytes than the fp one, and its transcripts on the same
    weights agree with the fp tier's in at least MATCH_GATE of their
    tokens."""
    params = _params(jax_side[0], 'slot')
    weights = {n: a for n, a in params.items() if not n.startswith('kv_')}
    fp_dir, q_dir = str(tmp_path / 'fp'), str(tmp_path / 'q')
    fp_sig = _export(weights, fp_dir, kv_cache_dtype='float32', max_slots=2)
    q_sig = _export(weights, q_dir, max_slots=4)
    assert (fp_sig['kv_cache_dtype'], q_sig['kv_cache_dtype']) == (
        'float32', 'int8')
    assert q_sig['max_slots'] == 2 * fp_sig['max_slots']
    assert q_sig['cache_bytes'] < fp_sig['cache_bytes']
    outs, tiers = [], []
    for d in (fp_dir, q_dir):
        with DecodingPredictor(d, place=ptt.CPUPlace()) as pred:
            outs.append([pred.generate(p, max_new_tokens=GREEDY_NEW)
                         for p in _prompts()])
            tiers.append(pred.stats.snapshot()['tier'])
    assert tiers == ['bf16', 'int8']
    match = np.mean([np.mean(np.asarray(a[:min(len(a), len(b))])
                             == np.asarray(b[:min(len(a), len(b))]))
                     for a, b in zip(*outs)])
    assert match >= MATCH_GATE, match


def test_decode_cli_tier(port_arts, tmp_path, monkeypatch, capsys):
    """`serve.py decode ... --tier int8` serves the artifact's int8 tree
    (on the CPU under PTPU_PLATFORM=cpu), and refuses an artifact without
    one."""
    from paddle_tpu_torch.inference import serve
    monkeypatch.setenv('PTPU_PLATFORM', 'cpu')
    prompts = str(tmp_path / 'prompts.npz')
    np.savez(prompts, prompts=np.stack([p[:2] for p in _prompts()]))
    out = str(tmp_path / 'out.npz')
    assert serve.main(['serve.py', 'decode', port_arts['slot'], prompts, out,
                       '4', '--tier', 'int8']) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line['tier'] == 'int8' and line['requests'] == len(_prompts())
    with np.load(out) as z:
        assert z['tokens'].shape == (len(_prompts()), 4)
    with pytest.raises(ValueError, match="no 'int8' tier"):
        serve.main(['serve.py', 'decode',
                    os.path.join(port_arts['slot'], 'int8'), prompts, out,
                    '4', '--tier', 'int8'])


def test_tier_resolution_and_dtype_check(port_arts, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="no 'int8' tier"):
        DecodingPredictor(os.path.join(port_arts['slot'], 'int8'),
                          place=ptt.CPUPlace(), tier='int8')
    # the env preference resolves the tree where there is one
    monkeypatch.setenv('PTPU_SERVE_TIER', 'int8')
    with DecodingPredictor(port_arts['slot'], place=ptt.CPUPlace()) as pred:
        assert pred.stats.snapshot()['tier'] == 'int8'
    monkeypatch.delenv('PTPU_SERVE_TIER')
    with ptt.unique_name.guard():
        spec = build_decode_spec(**dict(SPEC, kv_cache_dtype='float32'))
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(spec['startup'], scope=scope)
    with pytest.raises(ValueError, match='kv_cache_dtype'):
        export_decode(spec, str(tmp_path / 'a'), scope=scope,
                      kv_cache_dtype='int8')


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
