"""Decode serving on a card: the port's DecodingPredictor on CUDAPlace(0)
over a tiny artifact (tests/test_torch_decode_serving.py's size).

Run on a machine with an NVIDIA GPU (no jax needed):

    python -m pytest --noconftest tests/test_torch_decode_serving_cuda.py

Without a card the tests skip. TF32 is off, so the card's f32 logits
differ from the CPU's by the sums' order only: the greedy transcripts
must be equal wherever the CPU's top-two logit gap exceeds 1e-4 of the
largest |logit| (the logits are held within 1e-5 of it first).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import DecodingPredictor, export_decode
from paddle_tpu_torch.models.transformer import build_decode_spec

SPEC = dict(vocab=37, d_model=16, n_head=2, n_layer=2, d_ff=32,
            max_slots=4, max_cache_len=64, prompt_buckets=(4, 8), eos_id=1)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: these tests serve on a card')
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope='module')
def artifact(tmp_path_factory):
    _need_card()
    out = str(tmp_path_factory.mktemp('decode_cuda') / 'art')
    scope = ptt.Scope()
    with ptt.unique_name.guard():
        spec = build_decode_spec(**SPEC)
    ptt.Executor(ptt.CUDAPlace(0)).run(spec['startup'], scope=scope)
    export_decode(spec, out, scope=scope)
    return out


def _prompts(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, SPEC['vocab'], int(rng.randint(2, 9)))
            for _ in range(n)]


@pytest.mark.cuda
def test_card_continuous_equals_sequential_and_cache_in_place(artifact):
    prompts = _prompts(11, 12)
    with DecodingPredictor(artifact) as pred:
        assert pred.place == ptt.CUDAPlace(0)
        cache = pred._scope.get('kv_k_0')
        assert cache.is_cuda
        seq = [pred.generate(p, max_new_tokens=10) for p in prompts]
        streams = [pred.submit(p, max_new_tokens=10) for p in prompts]
        con = [s.result(120) for s in streams]
        beam_solo = pred.generate(prompts[0], max_new_tokens=8, beam=3)
        beam = pred.submit(prompts[0], max_new_tokens=8, beam=3)
        greedy = pred.submit(prompts[1], max_new_tokens=8)
        ids, scores = beam.result(120)
        greedy.result(120)
        # the steps wrote into the same buffer
        assert pred._scope.get('kv_k_0') is cache and cache.any()
    assert con == seq
    np.testing.assert_array_equal(ids, beam_solo[0])
    np.testing.assert_array_equal(scores, beam_solo[1])


@pytest.mark.cuda
def test_card_matches_cpu(artifact):
    """The same requests served one at a time on the CPU and on the card:
    every dispatch's logits within 1e-5 of the largest |logit|, every
    token's top-two gap in the CPU's run above 1e-4 of it, and so the same
    transcripts."""
    prompts = _prompts(12, 4)
    out = {}
    for name, place in (('cpu', ptt.CPUPlace()), ('gpu', ptt.CUDAPlace(0))):
        with DecodingPredictor(artifact, place=place) as pred:
            rec = []
            step, prefill = pred._dispatch_step, pred._dispatch_prefill

            def record_step(*a, _f=step, _rec=rec):
                logits = _f(*a)
                _rec.append(logits[:1])     # a lone request is in slot 0
                return logits

            def record_prefill(*a, _f=prefill, _rec=rec):
                logits = _f(*a)
                _rec.append(logits[None])
                return logits
            pred._dispatch_step = record_step
            pred._dispatch_prefill = record_prefill
            toks = []
            for p in prompts:
                toks.append(pred.generate(p, max_new_tokens=12))
            out[name] = (toks, rec)
    (cpu_toks, cpu_rows), (gpu_toks, gpu_rows) = out['cpu'], out['gpu']
    assert len(cpu_rows) == len(gpu_rows) == sum(len(t) for t in cpu_toks)
    for c, g in zip(cpu_rows, gpu_rows):
        scale = np.abs(c).max()
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-5 * scale)
        top = np.sort(c[0])[-2:]
        assert top[1] - top[0] > 1e-4 * scale, \
            'a CPU top-two gap at or below 1e-4 of the largest |logit|'
    assert gpu_toks == cpu_toks
