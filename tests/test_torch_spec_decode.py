"""Speculative decoding in the port, on the CPU: the cases of
tests/test_spec_decode.py run on paddle_tpu_torch's DecodingPredictor
(CPUPlace()) over draft_k artifacts the port exports itself (vocab 37, 4
slots, cache 64, d_model 16, 2 heads, 2 layers, d_ff 32, draft_k 4), in
the slot and the block layout (block_size 4).

Greedy transcripts of draft-and-verify decode equal plain decode's in
both layouts, with real acceptance happening; drafted, undrafted and beam
requests mix in one scheduler tick; an adversarial drafter's rejected
rows stay invisible and its blocks roll back to the pool; max_new_tokens
inside the draft window and eos stop where plain decode stops; the
acceptance statistics; a verify tick's tokens arrive as one batch; the
n-gram drafter's units; a draft-model drafter (the target itself); a
drafter that raises (counted, the request rides plain steps); and the
draft= / draft_k= validation. Both sides are the port's own
programs, so transcripts are compared exactly: a verify row's logits are
the plain step's up to the order of f32 sums, and the margins of these
prompts are far above that (tests/test_torch_decode_block_cross.py holds
the verify program's logits against the reference's).

Left out of the mirror: the int8 tiers (drafted in
tests/test_torch_kv_quant.py), the profiler's serving report (ROADMAP
queue 1 item 11) and the AOT warm start (the port compiles nothing).
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import (DecodingPredictor, DraftModelDrafter,
                                        NgramDrafter, export_decode)
from paddle_tpu_torch.inference import decoding
from paddle_tpu_torch.models.transformer import build_decode_spec

VOCAB, SLOTS, CACHE, K = 37, 4, 64, 4
CPU = ptt.CPUPlace()


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its programs are a few
    dozen rows wide, and torch's thread pool would only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(out, **kw):
    with ptt.unique_name.guard():
        spec = build_decode_spec(
            vocab=VOCAB, d_model=16, n_head=2, n_layer=2, d_ff=32,
            max_slots=SLOTS, max_cache_len=CACHE, eos_id=1, **kw)
    scope = ptt.Scope()
    ptt.Executor(CPU).run(spec['startup'], scope=scope)
    export_decode(spec, out, scope=scope)
    return out


@pytest.fixture(scope='module')
def arts(tmp_path_factory):
    """draft_k=K artifacts in both layouts, plus one without a verify
    program for the refusals."""
    t = tmp_path_factory.mktemp('torch_spec')
    return {
        'slot': _build(str(t / 'slot'), prompt_buckets=(4, 8), draft_k=K),
        'block': _build(str(t / 'block'), prompt_buckets=(4, 8),
                        block_size=4, draft_k=K),
        'plain': _build(str(t / 'plain'), prompt_buckets=(4,)),
    }


def _pred(art, **kw):
    return DecodingPredictor(art, place=CPU, **kw)


def _prompts(seed, n):
    """Alternately self-repeating (the n-gram drafter fires) and random
    (no draft: the slot rides the plain step)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if i % 2 == 0:
            pat = rng.randint(2, VOCAB, 2)
            plen = int(rng.randint(4, 9))
            out.append(np.tile(pat, plen)[:plen])
        else:
            out.append(rng.randint(2, VOCAB, int(rng.randint(2, 9))))
    return out


class _ScriptedDrafter(object):
    """Proposes a fixed sequence whatever the context: the adversary."""

    def __init__(self, toks):
        self._toks = [int(t) for t in toks]

    def draft(self, tokens, k):
        return self._toks[:k]


class _OracleDrafter(object):
    """Proposes the true continuation recorded from a plain run: full
    acceptance."""

    def __init__(self):
        self.full = {}

    def remember(self, prompt, out):
        key = tuple(int(t) for t in prompt)
        self.full[key] = list(key) + [int(t) for t in out]

    def draft(self, tokens, k):
        toks = [int(t) for t in tokens]
        for full in self.full.values():
            if full[:len(toks)] == toks:
                return full[len(toks):len(toks) + k]
        return []


def test_verify_artifact_layout(arts):
    for name in ('slot', 'block'):
        with open(os.path.join(arts[name], decoding._DECODE_SIGNATURE)) as f:
            sig = json.load(f)
        ver = sig['verify']
        assert ver['draft_k'] == K
        assert ([e['name'] for e in ver['feeds']] ==
                [e['name'] for e in sig['step']['feeds']])
        assert all(e['shape'][1] == K + 1 for e in ver['feeds']
                   if e['name'] != 'block_tables')
        assert os.path.exists(os.path.join(arts[name], decoding._VERIFY_DIR,
                                           decoding._PROGRAM_FILE))
    with open(os.path.join(arts['plain'], decoding._DECODE_SIGNATURE)) as f:
        assert 'verify' not in json.load(f)
    assert not os.path.exists(os.path.join(arts['plain'],
                                           decoding._VERIFY_DIR))


@pytest.mark.parametrize('name', ['slot', 'block'])
def test_spec_matches_plain(arts, name):
    """Speculative greedy transcripts equal plain decode's in both layouts,
    with drafts proposed and verified."""
    prompts = _prompts(17, 6)
    with _pred(arts[name]) as pp:
        want = [pp.generate(p, max_new_tokens=10) for p in prompts]
    with _pred(arts[name], draft='ngram') as ps:
        streams = [ps.submit(p, max_new_tokens=10) for p in prompts]
        got = [s.result(120) for s in streams]
        snap = ps.stats.snapshot()
    assert got == want
    assert snap['verify_steps'] > 0 and snap['drafted'] > 0


@pytest.mark.parametrize('name', ['slot', 'block'])
def test_mixed_draft_nodraft_and_beam_tick(arts, name):
    """Drafted slots ride the verify program, undrafted ones the plain
    step, and a beam request (never drafted) decodes beside them in the
    same scheduler loop, each equal to plain serving."""
    prompts = _prompts(23, 8)
    with _pred(arts[name]) as pp:
        want = [pp.generate(p, max_new_tokens=10) for p in prompts]
        want_ids, want_scores = pp.generate(prompts[1], max_new_tokens=8,
                                            beam=3)
    with _pred(arts[name], draft='ngram') as ps:
        streams = [ps.submit(p, max_new_tokens=10) for p in prompts[:5]]
        beam = ps.submit(prompts[1], max_new_tokens=8, beam=3)
        streams += [ps.submit(p, max_new_tokens=10) for p in prompts[5:]]
        got = [s.result(120) for s in streams]
        ids, scores = beam.result(120)
        snap = ps.stats.snapshot()
    assert got == want
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(scores, want_scores)
    assert snap['drafted'] > 0


def test_rejected_tail_invisible_and_rolled_back(arts):
    """An adversarial drafter forces rejections: the K/V written past the
    accepted frontier is never attended (transcripts equal plain), and
    the blocks grown for the rejected tail roll back to the pool."""
    prompts = _prompts(29, 5)
    with _pred(arts['block']) as pp:
        want = [pp.generate(p, max_new_tokens=12) for p in prompts]
    with _pred(arts['block'], draft=_ScriptedDrafter([2, 3, 4, 2])) as ps:
        got = [ps.generate(p, max_new_tokens=12) for p in prompts]
        # again, over the prefixes the first pass published
        again = [ps.generate(p, max_new_tokens=12) for p in prompts]
        snap = ps.stats.snapshot()
        bm = ps.block_manager
        bm.evict_all_prefixes()
        assert bm.in_use() == 0, 'speculative blocks leaked'
    assert got == want and again == want
    assert snap['drafted'] > 0
    assert snap['accepted'] < snap['drafted'], \
        'the adversarial drafter was never rejected'


def test_truncation_inside_draft_window(arts):
    """max_new_tokens below the draft window: emission stops where plain
    decode stops, never past it on accepted draft tokens."""
    prompts = _prompts(31, 6)
    with _pred(arts['slot']) as pp, _pred(arts['slot'], draft='ngram') as ps:
        for max_new in (1, 2, 3):
            want = [pp.generate(p, max_new_tokens=max_new) for p in prompts]
            got = [ps.generate(p, max_new_tokens=max_new) for p in prompts]
            assert got == want
            assert all(len(g) <= max_new for g in got)


def test_eos_semantics_match_plain(arts):
    """The eos moved to a token the tiny model emits often: speculative
    decode, an oracle drafter that proposes the eos inside the window
    included, stops where plain decode stops."""
    prompts = _prompts(43, 8)
    with _pred(arts['slot']) as pp:
        base = [pp.generate(p, max_new_tokens=12) for p in prompts]
        toks = [t for w in base for t in w]
        pp._eos = max(set(toks), key=toks.count)
        eos = pp._eos
        want = [pp.generate(p, max_new_tokens=12) for p in prompts]
    assert any(len(w) < 12 and w[-1] == eos for w in want), \
        'eos never ended a request early'
    oracle = _OracleDrafter()
    for p, w in zip(prompts, want):
        oracle.remember(p, w)
    for drafter in ('ngram', oracle):
        with _pred(arts['slot'], draft=drafter) as ps:
            ps._eos = eos
            assert [ps.generate(p, max_new_tokens=12)
                    for p in prompts] == want


def test_acceptance_stats(arts):
    oracle = _OracleDrafter()
    prompts = _prompts(37, 4)
    with _pred(arts['slot']) as pp:
        want = [pp.generate(p, max_new_tokens=10) for p in prompts]
        plain = pp.stats.snapshot()
    for p, w in zip(prompts, want):
        oracle.remember(p, w)
    # plain serving: no drafting, both ratios exactly 1.0
    assert plain['drafted'] == 0 and plain['accepted'] == 0
    assert plain['acc_rate'] == 1.0 and plain['tokens_per_dispatch'] == 1.0
    assert plain['draft_errors'] == 0
    with _pred(arts['slot'], draft=oracle) as ps:
        got = [ps.generate(p, max_new_tokens=10) for p in prompts]
        snap = ps.stats.snapshot()
    assert got == want
    assert snap['verify_steps'] > 0
    assert 0 < snap['accepted'] <= snap['drafted']
    assert snap['draft_errors'] == 0
    assert snap['acc_rate'] == round(snap['accepted'] / snap['drafted'], 4)
    if all(1 not in w for w in want):
        # an eos inside the window legitimately cuts acceptance
        assert snap['acc_rate'] == 1.0
    assert snap['tokens_per_dispatch'] > 1.0


def test_tokenstream_batches_coalesce(arts):
    """A verify tick's accepted tokens arrive as one batch on the stream;
    plain decode delivers singletons."""
    oracle = _OracleDrafter()
    prompt = np.asarray([3, 4, 5, 6, 3, 4], np.int64)
    with _pred(arts['slot']) as pp:
        want = pp.generate(prompt, max_new_tokens=10)
        plain_batches = list(pp.submit(prompt, max_new_tokens=10).batches())
    assert len(want) == 10, 'eos ended the transcript: nothing to draft'
    oracle.remember(prompt, want)
    assert all(len(b) == 1 for b in plain_batches)
    assert [t for b in plain_batches for t in b] == want
    with _pred(arts['slot'], draft=oracle) as ps:
        batches = list(ps.submit(prompt, max_new_tokens=10).batches())
    assert [t for b in batches for t in b] == want
    assert any(len(b) > 1 for b in batches)


def test_ngram_drafter_unit():
    d = NgramDrafter()
    assert d.draft([5, 6, 7, 5, 6], 3) == [7, 5, 6]      # longest suffix
    assert d.draft([1, 2, 9, 1, 2, 8, 1, 2], 1) == [8]   # most recent site
    assert d.draft([1, 2, 3, 1], 2) == [2, 3]            # 1-gram fallback
    assert d.draft([5, 6, 5, 6], 4) == [5, 6, 5, 6]      # periodic extension
    assert NgramDrafter(min_ngram=2).draft([1, 2, 3, 1], 2) == []
    assert d.draft([1, 2, 3, 4], 3) == []
    assert d.draft([7], 3) == []
    assert d.draft([5, 6, 7, 5, 6], 0) == []
    with pytest.raises(ValueError):
        NgramDrafter(min_ngram=0)
    with pytest.raises(ValueError):
        NgramDrafter(max_ngram=2, min_ngram=3)


def test_draft_model_drafter(arts):
    """A draft endpoint (here the target itself: proposals are the
    target's argmax, so acceptance is full) plugged in as the drafter."""
    prompts = _prompts(41, 4)
    with _pred(arts['block']) as pp:
        want = [pp.generate(p, max_new_tokens=8) for p in prompts]
    with _pred(arts['block']) as dp, \
            _pred(arts['block'], draft=DraftModelDrafter(dp)) as ps:
        got = [ps.generate(p, max_new_tokens=8) for p in prompts]
        snap = ps.stats.snapshot()
    assert got == want
    assert snap['accepted'] > 0 and snap['draft_errors'] == 0
    with pytest.raises(ValueError):
        DraftModelDrafter(object())


class _RaisingDrafter(object):
    def draft(self, tokens, k):
        raise RuntimeError('drafter down')


def test_drafter_errors_are_counted(arts):
    """A drafter that raises costs speed, never correctness: its request
    rides the plain step and the transcript is plain decode's; every raise
    counts in the stats' draft_errors. A DraftModelDrafter over a slot
    endpoint raises once the context outgrows that endpoint's largest
    prompt bucket (8): it drafts (and is accepted) before, not after."""
    prompt = np.tile([5, 9], 4)[:7]
    with _pred(arts['slot']) as pp:
        want = pp.generate(prompt, max_new_tokens=8)
    with _pred(arts['slot'], draft=_RaisingDrafter()) as ps:
        assert ps.generate(prompt, max_new_tokens=8) == want
        snap = ps.stats.snapshot()
    assert snap['draft_errors'] > 0
    assert snap['verify_steps'] == 0 and snap['drafted'] == 0
    with _pred(arts['slot']) as dp, \
            _pred(arts['slot'], draft=DraftModelDrafter(dp)) as ps:
        assert ps.generate(prompt, max_new_tokens=8) == want
        snap = ps.stats.snapshot()
    assert snap['accepted'] > 0 and snap['draft_errors'] > 0


def test_draft_validation(arts):
    with pytest.raises(ValueError, match='verify program'):
        _pred(arts['plain'], draft='ngram')
    for bad_k in (0, K + 1):
        with pytest.raises(ValueError, match='draft_k'):
            _pred(arts['slot'], draft='ngram', draft_k=bad_k)
    with pytest.raises(ValueError, match="'ngram'"):
        _pred(arts['slot'], draft=object())
    # draft_k below the artifact's K narrows the window
    prompt = np.tile([5, 9], 4)
    with _pred(arts['slot'], draft='ngram', draft_k=2) as ps:
        out = ps.generate(prompt, max_new_tokens=8)
        assert ps.stats.snapshot()['drafted'] > 0
    with _pred(arts['slot']) as pp:
        assert pp.generate(prompt, max_new_tokens=8) == out
