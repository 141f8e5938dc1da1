"""Block-paged and speculative decode serving on a card: the port's
DecodingPredictor on CUDAPlace(0) over tiny artifacts (block_size 4,
chunk sizes 4 and 8, draft_k 3; tests/test_torch_spec_decode.py's model
size).

Run on a machine with an NVIDIA GPU (no jax needed):

    python -m pytest --noconftest tests/test_torch_decode_block_cuda.py

Without a card the tests skip. TF32 is off, so the card's f32 logits
differ from the CPU's by the order of their sums only: a chunk slice's,
a step's and a verify dispatch's logits, teacher-forced from the same
state, are held within 1e-5 of the largest |logit|.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import DecodingPredictor, export_decode
from paddle_tpu_torch.models.transformer import build_decode_spec

SPEC = dict(vocab=37, d_model=16, n_head=2, n_layer=2, d_ff=32,
            max_slots=4, max_cache_len=64, prompt_buckets=(4, 8), eos_id=1,
            draft_k=3)
BS = 4
MAXB = SPEC['max_cache_len'] // BS


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: these tests serve on a card')
    torch.backends.cuda.matmul.allow_tf32 = False


def _build(out, **kw):
    scope = ptt.Scope()
    with ptt.unique_name.guard():
        spec = build_decode_spec(**dict(SPEC, **kw))
    ptt.Executor(ptt.CUDAPlace(0)).run(spec['startup'], scope=scope)
    export_decode(spec, out, scope=scope)
    return out


@pytest.fixture(scope='module')
def arts(tmp_path_factory):
    _need_card()
    t = tmp_path_factory.mktemp('decode_block_cuda')
    return {'block': _build(str(t / 'block'), block_size=BS),
            'slot': _build(str(t / 'slot'))}


def _prompts(seed, n):
    """Alternately self-repeating (the n-gram drafter fires) and random."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if i % 2 == 0:
            pat = rng.randint(2, SPEC['vocab'], 2)
            out.append(np.tile(pat, 5)[:int(rng.randint(4, 10))])
        else:
            out.append(rng.randint(2, SPEC['vocab'], int(rng.randint(2, 20))))
    return out


@pytest.mark.cuda
def test_card_block_serving_and_spec(arts):
    """On the card: the block pool lives there; continuous greedy equals
    sequential; a beam beside greedy traffic equals its solo run and
    copies blocks on write; n-gram speculative decode equals plain decode
    in both layouts (on prompts cut to the slot artifact's largest
    bucket)."""
    prompts = _prompts(11, 10)
    with DecodingPredictor(arts['block']) as pred:
        assert pred.place == ptt.CUDAPlace(0) and pred.layout == 'block'
        pool = pred._scope.get('kv_k_0')
        assert pool.is_cuda and tuple(pool.shape)[1] == BS
        seq = [pred.generate(p, max_new_tokens=10) for p in prompts]
        con = [s.result(120) for s in [pred.submit(p, max_new_tokens=10)
                                       for p in prompts]]
        solo = pred.generate(prompts[1], max_new_tokens=8, beam=3)
        beam = pred.submit(prompts[1], max_new_tokens=8, beam=3)
        greedy = pred.submit(prompts[2], max_new_tokens=8)
        ids, scores = beam.result(120)
        greedy.result(120)
        snap = pred.stats.snapshot()
        assert pred._scope.get('kv_k_0') is pool and pool.any()
    assert con == seq
    np.testing.assert_array_equal(ids, solo[0])
    np.testing.assert_array_equal(scores, solo[1])
    assert snap['cow_blocks'] > 0
    short = [p[:max(SPEC['prompt_buckets'])] for p in prompts]
    for name in ('block', 'slot'):
        with DecodingPredictor(arts[name]) as pp:
            want = [pp.generate(p, max_new_tokens=12) for p in short]
        with DecodingPredictor(arts[name], draft='ngram') as ps:
            got = [s.result(120) for s in [ps.submit(p, max_new_tokens=12)
                                           for p in short]]
            spec = ps.stats.snapshot()
        assert got == want, name
        assert spec['verify_steps'] > 0, name
        assert 0 < spec['accepted'] <= spec['drafted'], name
        assert spec['draft_errors'] == 0, name


def _teacher_forced(pred, ref=None):
    """Two prompts admitted through chunk slices into slots 0 and 1 (11
    and 3 tokens), 6 steps of both, a verify dispatch (slot 0 three draft
    tokens, slot 1 pad) and a step: the logits of each, each dispatch fed
    the argmax of `ref`'s (else its own) logits before it."""
    out = []
    tables = np.arange(1, 1 + SPEC['max_slots'] * MAXB, dtype=np.int32
                       ).reshape(SPEC['max_slots'], MAXB)
    prompts = [np.random.RandomState(20 + n).randint(2, SPEC['vocab'], n)
               for n in (11, 3)]
    S = SPEC['max_slots']

    def pick(axis=None):
        return np.argmax((ref if ref is not None else out)[len(out) - 1],
                         axis=axis)
    tok = np.zeros((S, 1), np.int64)
    for s, p in enumerate(prompts):
        start = 0
        while start < len(p):
            take = min(8, len(p) - start)
            size = 4 if take <= 4 else 8
            ids = np.zeros((1, size), np.int64)
            ids[0, :take] = p[start:start + take]
            out.append(pred._dispatch_chunk(size, ids, start, take,
                                            tables[s:s + 1])[None])
            start += take
        tok[s, 0] = int(pick())
    pos = np.zeros((S, 1), np.int32)
    pos[:2, 0] = [len(p) for p in prompts]
    for _ in range(6):
        out.append(pred._dispatch_step(tok, pos, tables))
        tok[:2, 0] = pick(axis=1)[:2]
        pos[:2, 0] += 1
    R = SPEC['draft_k'] + 1
    vt = np.zeros((S, R), np.int64)
    vp = np.full((S, R), MAXB * BS, np.int32)
    vt[0] = [tok[0, 0], 5, 6, 7]
    vp[0] = pos[0, 0] + np.arange(R)
    out.append(pred._dispatch_verify(vt, vp, tables))
    out.append(pred._dispatch_step(tok, pos, tables))
    return out


@pytest.mark.cuda
def test_card_block_matches_cpu(arts):
    with DecodingPredictor(arts['block'], place=ptt.CPUPlace()) as cpu:
        want = _teacher_forced(cpu)
    with DecodingPredictor(arts['block']) as gpu:
        got = _teacher_forced(gpu, want)
    assert len(got) == len(want) == 3 + 6 + 2
    for g, c in zip(got, want):
        assert g.shape == c.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, c, rtol=0,
                                   atol=1e-5 * np.abs(c).max())
