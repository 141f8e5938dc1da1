"""Continuous in-flight decode serving in the port, on the CPU: the cases
of tests/test_decode_serving.py, run by paddle_tpu_torch's
DecodingPredictor on CPUPlace() over an artifact the port exports itself
(build_decode_spec -> startup -> export_decode), at the same size (vocab
37, 4 slots, cache 64, buckets (4, 8), d_model 16, 2 heads, 2 layers, d_ff
32): the artifact's layout, greedy continuous == sequential (also with
staggered arrivals), beam identity beside greedy traffic, streaming,
prefill/step cache consistency, deadlines in the queue and mid-decode,
max_queue shedding and submit validation; plus the port's own left-outs
and its CPU/CUDA place rule.

Left out of the mirror: test_serving_report_decode_rows (the profiler's
serving report is not ported yet, ROADMAP queue 1 item 11) and
test_warm_fresh_subprocess_zero_compiles (AOT sidecars and XLA compiles
have no counterpart: the port interprets its programs and compiles
nothing). tests/test_torch_decode_cross.py holds the served transcripts
against paddle_tpu's.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import (DecodingPredictor, ServerOverloaded,
                                        DeadlineExceeded, export_decode,
                                        load_decoding)
from paddle_tpu_torch.inference import decoding
from paddle_tpu_torch.models.transformer import build_decode_spec

VOCAB, SLOTS, CACHE, BUCKETS = 37, 4, 64, (4, 8)
SPEC = dict(vocab=VOCAB, d_model=16, n_head=2, n_layer=2, d_ff=32,
            max_slots=SLOTS, max_cache_len=CACHE, prompt_buckets=BUCKETS,
            eos_id=1)
CPU = ptt.CPUPlace()


@pytest.fixture(scope='module')
def artifact(tmp_path_factory):
    """One tiny decoder-LM artifact per module, written by the port."""
    out = str(tmp_path_factory.mktemp('decode') / 'art')
    scope = ptt.Scope()
    with ptt.unique_name.guard():
        spec = build_decode_spec(**SPEC)
    ptt.Executor(CPU).run(spec['startup'], scope=scope)
    export_decode(spec, out, scope=scope)
    return out


def _prompts(seed, n, lo=2, hi=None):
    rng = np.random.RandomState(seed)
    return [rng.randint(lo, hi or VOCAB, int(rng.randint(2, 9)))
            for _ in range(n)]


def _pred(artifact, **kw):
    return DecodingPredictor(artifact, place=CPU, **kw)


def test_artifact_layout(artifact):
    with open(os.path.join(artifact, decoding._DECODE_SIGNATURE)) as f:
        sig = json.load(f)
    assert sig['kind'] == 'decode' and sig['layout'] == 'slot'
    assert sig['max_slots'] == SLOTS and sig['max_cache_len'] == CACHE
    assert sig['prompt_buckets'] == sorted(BUCKETS)
    assert sig['eos_id'] == 1 and sig['vocab'] == VOCAB
    assert len(sig['state']) == 4  # 2 layers x K/V
    for e in sig['state']:
        assert e['shape'] == [SLOTS, CACHE, 16] and e['dtype'] == 'float32'
    assert [e['name'] for e in sig['step']['feeds']] == ['tokens', 'pos']
    for d in ([decoding._STEP_DIR] +
              [decoding._PREFILL_DIR % b for b in BUCKETS]):
        assert os.path.exists(os.path.join(artifact, d,
                                           decoding._PROGRAM_FILE))
    params = os.listdir(os.path.join(artifact, decoding._PARAMS_DIR))
    # every parameter once, the cache left out
    assert 'pos_enc_w' in params and 'out_w' in params
    assert not [p for p in params if p.startswith('kv_')]
    assert sorted(sig['params']) == sorted(
        p for p in params if not p.startswith('.'))


def test_greedy_bit_identity_continuous_vs_sequential(artifact):
    """12 requests over 4 slots: transcripts equal those of serving each
    request alone, and slots recycle (more requests than slots all
    complete)."""
    prompts = _prompts(11, 12)
    with _pred(artifact) as pred:
        seq = [pred.generate(p, max_new_tokens=10) for p in prompts]
        snap_seq = pred.stats.snapshot()
        assert snap_seq['requests'] == 12
        pred.stats.reset()
        streams = [pred.submit(p, max_new_tokens=10) for p in prompts]
        con = [s.result(120) for s in streams]
        snap = pred.stats.snapshot()
    assert con == seq
    assert snap['requests'] == 12 and snap['prefills'] == 12
    # continuous batching packs several requests into a step
    assert snap['occupancy'] > snap_seq['occupancy']
    assert snap['steps'] < snap_seq['steps']


def test_greedy_bit_identity_staggered_arrivals(artifact):
    """Requests joining mid-decode change nothing about earlier requests'
    streams."""
    prompts = _prompts(12, 6)
    with _pred(artifact) as pred:
        seq = [pred.generate(p, max_new_tokens=12) for p in prompts]
        streams = []
        for p in prompts:
            streams.append(pred.submit(p, max_new_tokens=12))
            time.sleep(0.002)  # land inside the running batch
        con = [s.result(120) for s in streams]
    assert con == seq


def test_beam_bit_identity(artifact):
    """Fixed-width beam (3 slots a request) beside greedy traffic:
    hypotheses and scores equal solo runs bit for bit."""
    prompts = _prompts(13, 4)
    with _pred(artifact) as pred:
        solo = [pred.generate(p, max_new_tokens=8, beam=3) for p in prompts]
        beams = [pred.submit(p, max_new_tokens=8, beam=3)
                 for p in prompts[:2]]
        greedy = pred.submit(prompts[2], max_new_tokens=8)
        beams += [pred.submit(p, max_new_tokens=8, beam=3)
                  for p in prompts[2:]]
        got = [s.result(120) for s in beams]
        greedy.result(120)
        assert pred.stats.snapshot()['reorders'] > 0
    for (ids1, sc1), (ids2, sc2) in zip(solo, got):
        np.testing.assert_array_equal(ids1, ids2)
        np.testing.assert_array_equal(sc1, sc2)
        assert ids1.shape[0] == 3
        # best-first hypothesis ordering
        assert list(sc1) == sorted(sc1, reverse=True)


def test_token_streaming(artifact):
    """submit() yields tokens as steps complete; the iterated stream
    equals the final result."""
    with _pred(artifact) as pred:
        stream = pred.submit(_prompts(14, 1)[0], max_new_tokens=9)
        toks = list(stream)
        assert toks == stream.result(10)
        assert 1 <= len(toks) <= 9


def test_prefill_step_cache_consistency(artifact):
    """Teacher-forcing the generated tokens back through the (bucketed)
    prefill program reproduces the decode step's choices: the two
    programs agree on the cache contents."""
    prompt = _prompts(15, 1)[0][:3]
    with _pred(artifact) as pred:
        toks = pred.generate(prompt, max_new_tokens=6)
        for k in range(1, 4):
            forced = np.concatenate([prompt, toks[:k]])
            nxt = pred.generate(forced, max_new_tokens=1)
            assert nxt[0] == toks[k]


def test_deadline_expires_in_queue(artifact):
    with _pred(artifact) as pred:
        s = pred.submit(_prompts(16, 1)[0], max_new_tokens=4,
                        deadline_ms=0.0)
        with pytest.raises(DeadlineExceeded):
            s.result(30)
        assert pred.stats.snapshot()['expired'] == 1


def test_deadline_expiry_mid_decode_frees_slot(artifact):
    """A deadline elapsing during decode resolves the stream with
    DeadlineExceeded at the next step boundary and frees the slot;
    follow-up traffic is unaffected."""
    prompts = _prompts(17, 3)
    with _pred(artifact) as pred:
        want = pred.generate(prompts[1], max_new_tokens=5)
        s = pred.submit(prompts[0], max_new_tokens=57, deadline_ms=3.0)
        with pytest.raises(DeadlineExceeded):
            s.result(120)
        assert pred.stats.snapshot()['expired'] == 1
        # every slot is free again and serving continues bit-identically
        assert pred._free_slots() == list(range(SLOTS))
        assert pred.generate(prompts[1], max_new_tokens=5) == want


def test_max_queue_shedding(artifact):
    """Submissions beyond max_queue waiting requests fast-fail with
    ServerOverloaded before any device work; admitted requests finish."""
    prompts = _prompts(18, 16)
    with _pred(artifact, max_queue=4) as pred:
        streams = [pred.submit(p, max_new_tokens=30) for p in prompts]
        shed = served = 0
        for s in streams:
            try:
                s.result(120)
                served += 1
            except ServerOverloaded:
                shed += 1
        snap = pred.stats.snapshot()
    assert shed >= 1 and served >= 4
    assert snap['shed'] == shed and snap['requests'] == served


def test_submit_validation(artifact):
    with _pred(artifact) as pred:
        with pytest.raises(ValueError):
            pred.submit([], max_new_tokens=4).result(10)
        with pytest.raises(ValueError):  # longer than the largest bucket
            pred.submit(np.arange(2, 12), max_new_tokens=4).result(10)
        with pytest.raises(ValueError):  # beam wider than the slot pool
            pred.submit([3, 4], beam=SLOTS + 1).result(10)
    with pytest.raises(RuntimeError):
        pred.submit([3, 4])


def test_warmup_drain_and_load_decoding(artifact):
    """warmup() leaves a zero cache and zero counters; drain() lets the
    active stream finish and sheds what comes after it; load_decoding is
    the constructor."""
    prompt = _prompts(19, 1)[0]
    with load_decoding(artifact, place=CPU) as pred:
        want = pred.generate(prompt, max_new_tokens=6)
    with load_decoding(artifact, place=CPU) as pred:
        pred.warmup()
        assert pred.stats.snapshot()['steps'] == 0
        for e in pred._sig['state']:
            assert not pred._scope.get(e['name']).any()
        s = pred.submit(prompt, max_new_tokens=6)
        time.sleep(0.01)
        assert pred.drain(60)
        assert s.result(10) == want
        with pytest.raises(ServerOverloaded):
            pred.submit(prompt).result(10)
        assert pred.stats.snapshot()['drained'] == 1


@pytest.mark.parametrize('kw', [{'tier': 'int8'}, {'draft': 'ngram'},
                                {'draft_k': 2}])
def test_left_out_options_raise(artifact, kw):
    with pytest.raises(NotImplementedError):
        DecodingPredictor(artifact, place=CPU, **kw)


@pytest.mark.parametrize('kw', [{'kv_cache_dtype': 'int8'},
                                {'block_size': 8}, {'draft_k': 2},
                                {'mp_shard': 2}])
def test_build_decode_spec_left_out_tiers_raise(kw):
    with ptt.unique_name.guard(), pytest.raises(NotImplementedError):
        build_decode_spec(**dict(SPEC, **kw))


@pytest.mark.skipif(torch.cuda.is_available(), reason='a card is present')
def test_default_place_is_the_card(artifact):
    """Without a place the predictor runs on CUDAPlace(0); where torch
    sees no card that raises instead of falling back to the CPU."""
    with pytest.raises(RuntimeError, match='CUDAPlace'):
        DecodingPredictor(artifact)
