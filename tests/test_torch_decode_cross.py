"""Decode serving as a whole, the port held against paddle_tpu on the CPU:
build_decode_spec at tests/test_decode_serving.py's size (vocab 37, 4
slots, cache 64, buckets (4, 8), d_model 16, 2 heads, 2 layers, d_ff 32),
paddle_tpu's weights carried to the port with weights.params_from_numpy.

In this order:
1. the programs, op for op (types, inputs, outputs, attrs, var shapes);
2. the prefill logits of one prompt per bucket, and the step logits of 4
   slots decoding together, teacher-forced on the reference's own greedy
   tokens, each dispatch's logits within TOL of its largest |logit|
   (TOL = 1e-5: f32 on both sides, the sums in different orders);
3. the greedy and beam-3 transcripts of paddle_tpu's DecodingPredictor
   against the port's, compared in full. Two f32 stacks can pick
   different tokens only where the reference's choice is closer than
   their difference, so the test first asserts the margin condition:
   every greedy step's top-two logit gap in the reference exceeds 2·TOL of
   its largest |logit|, and every beam step's gaps between the W+1 best
   candidates exceed the error the scores can carry by then (4·TOL of the
   largest |logit| per step taken). A gap below that fails the test; the
   comparison is never shortened. Beam scores then agree within that
   error.

paddle_tpu's side runs once, in a fresh interpreter (this file run as a
script, with PTPU_ARTIFACT_AOT=0 so that its DecodingPredictor compiles
its programs with jit and loads no AOT sidecar: a sidecar compiled in
another process is where the "Expected ... 8 shards" failures come from).
It drives the step and prefill programs through fluid.Executor on one
scope for the logits, and serves its own export_decode artifact for the
transcripts, recording each step's margins.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import DecodingPredictor, export_decode
from paddle_tpu_torch.models.transformer import build_decode_spec

SPEC = dict(vocab=37, d_model=16, n_head=2, n_layer=2, d_ff=32,
            max_slots=4, max_cache_len=64, prompt_buckets=(4, 8), eos_id=1)
TOL = 1e-5
TF_STEPS = 12
GREEDY_NEW = 12
BEAM, BEAM_NEW = 3, 8


def _prompts(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, SPEC['vocab'], int(rng.randint(2, 9)))
            for _ in range(n)]


BUCKET_PROMPTS = {4: _prompts(20, 1)[0][:3],
                  8: np.concatenate(_prompts(21, 2))[:7]}
SLOT_PROMPTS = _prompts(22, SPEC['max_slots'])
GREEDY_PROMPTS = _prompts(23, 8)
BEAM_PROMPTS = _prompts(24, 2)


def _bucket(n):
    return min(b for b in SPEC['prompt_buckets'] if n <= b)


def _prefill_feed(prompt, slot):
    L = _bucket(len(prompt))
    padded = np.zeros((1, L), np.int64)
    padded[0, :len(prompt)] = prompt
    return L, {'prompt_ids': padded,
               'prompt_len': np.full((1, 1), len(prompt), np.int32),
               'slot': np.full((1, 1), slot, np.int32)}


def _dispatches(run_prefill, run_step, ref=None):
    """The logits of a fixed dispatch sequence: one prefill per bucket into
    slot 0, then SLOT_PROMPTS into slots 0..3 and TF_STEPS steps of all
    four. run_prefill(L, feed) and run_step(feed) run one program and
    return its logits. The tokens fed to each step are the argmax of the
    reference's logits of the dispatch before (`ref`, the reference's list,
    when given), else of this side's own: so the port's steps are
    teacher-forced on the reference's tokens. Returns the list of logits."""
    out = []
    S = SPEC['max_slots']

    def chosen(axis=None):
        src = ref[len(out) - 1] if ref is not None else out[-1]
        return np.argmax(src, axis=axis)
    for L, prompt in sorted(BUCKET_PROMPTS.items()):
        out.append(run_prefill(L, _prefill_feed(prompt, 0)[1]))
    last = []
    for s, prompt in enumerate(SLOT_PROMPTS):
        out.append(run_prefill(*_prefill_feed(prompt, s)))
        last.append(int(chosen()))
    lens = np.array([len(p) for p in SLOT_PROMPTS])
    for t in range(TF_STEPS):
        out.append(run_step({
            'tokens': np.asarray(last, np.int64).reshape(S, 1),
            'pos': (lens + t).astype(np.int32).reshape(S, 1)}))
        last = [int(i) for i in chosen(axis=1)]
    return out


def _gaps(values, k):
    """The gaps between the k+1 largest of `values`, best first."""
    top = np.sort(np.asarray(values, np.float64).ravel())[::-1][:k + 1]
    return [float(top[i] - top[i + 1]) for i in range(k)]


def _jax_reference(root):
    """paddle_tpu's side, written under root: params.npz (every persistable
    of the startup program), logits.npz (the dispatch sequence of
    _dispatches), and served.json (greedy and beam transcripts of its
    DecodingPredictor, each step's margin and largest |logit|)."""
    import paddle_tpu as fluid
    from paddle_tpu.inference import DecodingPredictor as JaxPredictor
    from paddle_tpu.inference import export_decode as jax_export
    from models.transformer import build_decode_spec as jax_build
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        with fluid.unique_name.guard():
            spec = jax_build(**SPEC)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(spec['startup'])
        params = {v.name: np.asarray(scope.find_var(v.name).get_tensor())
                  for v in spec['startup'].list_vars() if v.persistable}
        np.savez(os.path.join(root, 'params.npz'), **params)
        art = os.path.join(root, 'art')
        jax_export(spec, art, scope=scope, precompile=False)

        def run_prefill(L, feed):
            p = spec['prefill'][L]
            out, = exe.run(p['program'], feed=feed, fetch_list=p['fetches'])
            return np.asarray(out)

        def run_step(feed):
            out, = exe.run(spec['step']['program'], feed=feed,
                           fetch_list=spec['step']['fetches'])
            return np.asarray(out)
        logits = _dispatches(run_prefill, run_step)
        np.savez(os.path.join(root, 'logits.npz'),
                 **{'d%03d' % i: a for i, a in enumerate(logits)})

    served = {'greedy': [], 'beam': []}
    with JaxPredictor(art) as pred:
        seen = []
        orig_pre, orig_step = pred._dispatch_prefill, pred._dispatch_step

        def pre(*a):
            seen.append(orig_pre(*a)[None])
            return seen[-1][0]

        def step(*a):
            seen.append(orig_step(*a))
            return seen[-1]
        pred._dispatch_prefill, pred._dispatch_step = pre, step
        for p in GREEDY_PROMPTS:
            del seen[:]
            toks = pred.generate(p, max_new_tokens=GREEDY_NEW)
            # a lone request decodes in slot 0
            served['greedy'].append({
                'tokens': [int(t) for t in toks],
                'margins': [_gaps(a[0], 1)[0] for a in seen],
                'scales': [float(np.abs(a[0]).max()) for a in seen]})
        orig_score = pred._score_beam

        def score(req, logits):
            W, V = req.beam, pred._vocab
            cand = np.full((W, V), -np.inf, np.float64)
            for i in range(W):
                if req.finished[i]:
                    cand[i, pred._eos] = req.scores[i]
                else:
                    cand[i] = req.scores[i] + _log_softmax(
                        logits[req.slots[i]])
            gaps.append(min(_gaps(cand, W)))
            scales.append(float(max(np.abs(logits[s]).max()
                                    for s in req.slots)))
            return orig_score(req, logits)
        pred._score_beam = score
        for p in BEAM_PROMPTS:
            del seen[:]
            gaps, scales = [], []
            ids, scores = pred.generate(p, max_new_tokens=BEAM_NEW,
                                        beam=BEAM)
            first = seen[0][0]
            served['beam'].append({
                'ids': np.asarray(ids).tolist(),
                'scores': np.asarray(scores).tolist(),
                'margins': [min(_gaps(_log_softmax(first), BEAM))] + gaps,
                'scales': [float(np.abs(first).max())] + scales})
    with open(os.path.join(root, 'served.json'), 'w') as f:
        json.dump(served, f)


def _log_softmax(row):
    x = np.asarray(row, np.float64)
    x = x - x.max()
    return x - np.log(np.exp(x).sum())


@pytest.fixture(scope='module')
def jax_side(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('decode_cross'))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PTPU_ARTIFACT_AOT='0', PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get('PYTHONPATH')) if p))
    r = subprocess.run([sys.executable, os.path.abspath(__file__), root],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with np.load(os.path.join(root, 'params.npz')) as f:
        params = dict(f)
    with np.load(os.path.join(root, 'logits.npz')) as f:
        logits = [f['d%03d' % i] for i in range(len(f.files))]
    with open(os.path.join(root, 'served.json')) as f:
        served = json.load(f)
    return params, logits, served


@pytest.fixture(scope='module')
def port_side(jax_side, tmp_path_factory):
    """The port's spec with paddle_tpu's weights in a scope, and an
    artifact the port exports from it."""
    params = jax_side[0]
    with ptt.unique_name.guard():
        spec = build_decode_spec(**SPEC)
    scope = ptt.Scope()
    ptt.weights.params_from_numpy(params, spec['startup'], scope)
    art = str(tmp_path_factory.mktemp('decode_cross_port') / 'art')
    export_decode(spec, art, scope=scope)
    return spec, scope, art


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize('which', ['startup', 'step', 'prefill4',
                                   'prefill8'])
def test_programs_match_reference(which):
    import paddle_tpu as fluid
    from models.transformer import build_decode_spec as jax_build
    with fluid.unique_name.guard():
        js = jax_build(**SPEC)
    with ptt.unique_name.guard():
        ts = build_decode_spec(**SPEC)

    def prog(spec):
        if which in ('startup', 'step'):
            return spec[which] if which == 'startup' else \
                spec['step']['program']
        return spec['prefill'][int(which[len('prefill'):])]['program']

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
    assert ops(prog(ts)) == ops(prog(js))
    assert var_decls(prog(ts)) == var_decls(prog(js))
    if which == 'step':
        assert ts['step']['fetches'] == js['step']['fetches']


@pytest.mark.parametrize('bucket', sorted(SPEC['prompt_buckets']))
def test_prefill_logits_per_bucket(jax_side, port_side, bucket):
    """Each bucket's prefill program, on a prompt of that bucket, gives the
    reference's first-token logits within TOL of the largest |logit|."""
    _, ref, _ = jax_side
    spec, scope, _ = port_side
    exe = ptt.Executor(ptt.CPUPlace())
    L, feed = _prefill_feed(BUCKET_PROMPTS[bucket], 0)
    assert L == bucket
    p = spec['prefill'][L]
    got, = exe.run(p['program'], feed=feed, fetch_list=p['fetches'],
                   scope=scope)
    _close(got, ref[sorted(BUCKET_PROMPTS).index(bucket)])


def test_teacher_forced_step_logits(jax_side, port_side):
    """The whole dispatch sequence (one prefill per bucket, four slots
    prefilled, TF_STEPS steps of all four slots together, each step fed the
    reference's own greedy tokens) through the port's programs on one
    scope: every dispatch's logits within TOL of its largest |logit|."""
    _, ref, _ = jax_side
    spec, port_scope, _ = port_side
    scope = ptt.Scope()
    for v in spec['startup'].list_vars():
        scope.set(v.name, port_scope.get(v.name).clone())
    exe = ptt.Executor(ptt.CPUPlace())

    def run_prefill(L, feed):
        p = spec['prefill'][L]
        return exe.run(p['program'], feed=feed, fetch_list=p['fetches'],
                       scope=scope)[0]

    def run_step(feed):
        return exe.run(spec['step']['program'], feed=feed,
                       fetch_list=spec['step']['fetches'], scope=scope)[0]
    got = _dispatches(run_prefill, run_step, ref)
    assert len(got) == len(ref) == (len(BUCKET_PROMPTS) + len(SLOT_PROMPTS)
                                    + TF_STEPS)
    for g, r in zip(got, ref):
        _close(g, r)


def test_greedy_transcripts_under_margin_rule(jax_side, port_side):
    """The port's DecodingPredictor, all prompts submitted together,
    gives the reference's greedy transcripts (its requests served one at
    a time), in full; every reference step's top-two gap first shown to
    exceed 2·TOL of its largest |logit|."""
    _, _, served = jax_side
    for i, rec in enumerate(served['greedy']):
        small = [(t, m) for t, (m, s) in enumerate(zip(rec['margins'],
                                                        rec['scales']))
                 if m <= 2 * TOL * s]
        assert not small, ('prompt %d: reference top-two gaps at or below '
                           '2*TOL at (step, gap) %s' % (i, small))
        assert len(rec['margins']) == len(rec['tokens'])
    with DecodingPredictor(port_side[2], place=ptt.CPUPlace()) as pred:
        streams = [pred.submit(p, max_new_tokens=GREEDY_NEW)
                   for p in GREEDY_PROMPTS]
        got = [s.result(120) for s in streams]
    assert got == [rec['tokens'] for rec in served['greedy']]


def test_beam_transcripts_under_margin_rule(jax_side, port_side):
    """Beam-3 hypotheses equal the reference's exactly and their scores
    agree within the error a score can carry (4·TOL of the largest |logit|
    per step: a logit and its log-sum-exp off by TOL each); every step's
    gaps between the W+1 best reference candidates first shown to exceed
    that error, as it stands at that step."""
    _, _, served = jax_side
    with DecodingPredictor(port_side[2], place=ptt.CPUPlace()) as pred:
        streams = [pred.submit(p, max_new_tokens=BEAM_NEW, beam=BEAM)
                   for p in BEAM_PROMPTS]
        got = [s.result(120) for s in streams]
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


if __name__ == '__main__':
    _jax_reference(sys.argv[1])
