"""Dynamic batching on a card: the port's BatchingPredictor on
CUDAPlace(0) over a small multi-bucket artifact (the fc model of
tests/test_torch_batching.py).

Run on a machine with an NVIDIA GPU (no jax needed):

    python -m pytest --noconftest tests/test_torch_batching_cuda.py

Without a card the tests skip. Each coalesced batch is staged in pinned
host memory and copied with non_blocking=True; every request's outputs
equal CompiledPredictor.run of that request through the same bucket, bit
for bit.
"""
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import (BatchingPredictor, CompiledPredictor,
                                        Config, create_predictor,
                                        export_compiled)

DIM = 8


@pytest.fixture(scope='module')
def artifact(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: these tests serve on a card')
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = str(tmp_path_factory.mktemp('batching_cuda'))
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 7
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        h = ptt.layers.data(name='img', shape=[DIM], dtype='float32')
        for _ in range(3):
            h = ptt.layers.fc(h, 256, act='relu')
        out = ptt.layers.fc(h, 4, act='softmax')
    exe = ptt.Executor(ptt.CUDAPlace(0))
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        ptt.io.save_inference_model(os.path.join(tmp, 'model'), ['img'],
                                    [out], exe, main)
    pred = create_predictor(Config(os.path.join(tmp, 'model')))
    art = os.path.join(tmp, 'art')
    export_compiled(pred, [np.zeros((4, DIM), np.float32)], art,
                    batch_sizes=[1, 8, 32])
    return art


def _x(seed, rows):
    return np.random.RandomState(100 + seed).randn(
        rows, DIM).astype(np.float32)


@pytest.mark.cuda
def test_card_staging_is_pinned_and_non_blocking(artifact, monkeypatch):
    seen = []
    real_to = torch.Tensor.to

    def to(self, *args, **kwargs):
        if self.device.type == 'cpu':
            seen.append((self.is_pinned(), kwargs.get('non_blocking')))
        return real_to(self, *args, **kwargs)

    with BatchingPredictor(artifact, platform='gpu',
                           batch_timeout_ms=1.0) as batcher:
        assert batcher.place == ptt.CUDAPlace(0)
        batcher.warmup()
        monkeypatch.setattr(torch.Tensor, 'to', to)
        got, = batcher.run([_x(0, 3)], timeout=60)
        monkeypatch.undo()
    assert seen == [(True, True)]
    want, = CompiledPredictor(os.path.join(artifact, 'bucket_00008'),
                              platform='gpu').run([_x(0, 3)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_card_concurrent_requests_bit_identical(artifact):
    xs = [_x(10 + i, 1) for i in range(64)]
    seq = CompiledPredictor(os.path.join(artifact, 'bucket_00032'),
                            platform='gpu')
    want = [seq.run([x])[0] for x in xs]
    with BatchingPredictor(artifact, platform='gpu',
                           max_batch_size=32,
                           batch_timeout_ms=250.0) as batcher:
        batcher.warmup()
        results = [None] * 64
        gate = threading.Barrier(64)

        def client(i):
            gate.wait(timeout=60)
            results[i] = batcher.submit([xs[i]]).result(timeout=60)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = batcher.stats.snapshot()
    assert snap['requests'] == 64
    for i in range(64):
        assert np.array_equal(results[i][0], want[i]), i
