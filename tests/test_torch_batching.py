"""Dynamic batching on the port: BatchingPredictor over export_compiled
artifacts, the behavioural tests of tests/test_batching.py held on the
port's own CompiledPredictor and Predictor.

Determinism contract under test: a request's outputs equal an unbatched
CompiledPredictor.run through the SAME bucket bit for bit; across buckets
only closeness holds. No test here times the batcher against sequential
serving: that comparison runs on the card (chip_smoke.py).
"""
import json
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import (BatchingPredictor, CompiledPredictor,
                                        Config, DeadlineExceeded,
                                        ServerOverloaded, create_predictor,
                                        export_compiled)
from paddle_tpu_torch.inference.batching import select_bucket

DIM = 8


def _build_predictor(tmp, reduce_fetch=False, width=32, depth=1):
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 7
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        h = ptt.layers.data(name='img', shape=[DIM], dtype='float32')
        for _ in range(depth):
            h = ptt.layers.fc(h, width, act='relu')
        out = ptt.layers.fc(h, 4, act='softmax')
        fetches = [out] + ([ptt.layers.mean(out)] if reduce_fetch else [])
    exe = ptt.Executor(ptt.CPUPlace())
    model_dir = os.path.join(tmp, 'model')
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        ptt.io.save_inference_model(model_dir, ['img'], fetches, exe, main)
    return create_predictor(Config(model_dir).disable_gpu())


@pytest.fixture(scope='module')
def artifacts(tmp_path_factory):
    """One model, exported three ways: multi-bucket {1,8,32}, single
    bucket {16}, and a legacy v2 single-bucket artifact (no fetch shapes,
    no buckets key)."""
    tmp = str(tmp_path_factory.mktemp('batching'))
    pred = _build_predictor(tmp)
    sample = np.random.RandomState(0).randn(4, DIM).astype(np.float32)
    multi = os.path.join(tmp, 'multi')
    export_compiled(pred, [sample], multi, batch_sizes=[1, 8, 32])
    single = os.path.join(tmp, 'single')
    export_compiled(pred, [sample], single, batch_sizes=[16])
    legacy = os.path.join(tmp, 'legacy')
    export_compiled(pred, [np.resize(sample, (8, DIM))], legacy)
    sig_path = os.path.join(legacy, 'signature.json')
    with open(sig_path) as f:
        sig = json.load(f)
    sig['version'] = 2  # v2 artifacts carried no fetch shapes
    for e in sig['fetches']:
        e.pop('shape', None)
    with open(sig_path, 'w') as f:
        json.dump(sig, f)
    return {'multi': multi, 'single': single, 'legacy': legacy,
            'pred': pred}


def _x(seed, rows):
    return np.random.RandomState(100 + seed).randn(
        rows, DIM).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_multibucket_loads_in_old_and_new_entry_points(artifacts):
    multi, pred = artifacts['multi'], artifacts['pred']
    x = _x(0, 32)
    want, = pred.run([x])
    got, = CompiledPredictor(multi).run([x])
    _close(got, want)
    got8, = CompiledPredictor(os.path.join(multi, 'bucket_00008')).run(
        [x[:8]])
    _close(got8, want[:8])
    with BatchingPredictor(multi, batch_timeout_ms=1.0) as batcher:
        assert batcher.buckets == [1, 8, 32]
        assert batcher.get_input_names() == ['img']
        assert batcher.get_output_names() == pred.get_output_names()
        res, = batcher.run([x[:3]])
        _close(res, want[:3])


def test_v2_single_bucket_artifact_still_loads(artifacts):
    legacy, pred = artifacts['legacy'], artifacts['pred']
    x = _x(1, 8)
    want, = pred.run([x])
    with BatchingPredictor(legacy, batch_timeout_ms=1.0) as batcher:
        assert batcher.buckets == [8]
        res, = batcher.run([x[:2]])
        _close(res, want[:2])


def test_select_bucket_unsorted_prefers_smallest_fit():
    import random
    buckets = [1, 8, 32, 128]
    for seed in range(6):
        shuffled = list(buckets)
        random.Random(seed).shuffle(shuffled)
        for rows, want in ((1, 1), (2, 8), (8, 8), (9, 32), (33, 128),
                           (128, 128)):
            assert select_bucket(shuffled, rows) == want, shuffled
    with pytest.raises(ValueError, match='exceeds the largest'):
        select_bucket([128, 1, 32, 8], 129)


def test_batcher_routes_through_smallest_bucket_with_shuffled_sig(
        artifacts, tmp_path):
    shuffled_dir = str(tmp_path / 'shuffled')
    shutil.copytree(artifacts['multi'], shuffled_dir)
    sig_path = os.path.join(shuffled_dir, 'signature.json')
    with open(sig_path) as f:
        sig = json.load(f)
    sig['buckets'] = [32, 1, 8]
    with open(sig_path, 'w') as f:
        json.dump(sig, f)
    with BatchingPredictor(shuffled_dir, batch_timeout_ms=1.0) as b:
        assert b.buckets == [1, 8, 32]
        b.run([_x(77, 2)])
        # 2 rows padded into the 8-bucket (occupancy 2/8), never 32
        assert b.stats.snapshot()['occupancy'] == pytest.approx(0.25)


def test_coalescing_routes_results_to_the_right_caller(artifacts):
    pred = artifacts['pred']
    with BatchingPredictor(artifacts['multi'],
                           batch_timeout_ms=20.0) as batcher:
        reqs = [_x(10 + i, 1 + i % 3) for i in range(12)]
        futs = [batcher.submit([x]) for x in reqs]
        for x, fut in zip(reqs, futs):
            got, = fut.result(timeout=30)
            assert got.shape == (x.shape[0], 4)
            _close(got, pred.run([x])[0])
        snap = batcher.stats.snapshot()
        assert snap['requests'] == 12 and snap['queue_depth'] == 0
        assert 1 <= snap['batches'] <= 12


def test_timeout_flushes_lone_request(artifacts):
    # single bucket of 16: a lone 1-row request leaves the queue only
    # through the timeout flush
    with BatchingPredictor(artifacts['single'],
                           batch_timeout_ms=60.0) as batcher:
        t0 = time.perf_counter()
        got, = batcher.run([_x(20, 1)], timeout=30)
        dt = time.perf_counter() - t0
    assert got.shape == (1, 4)
    assert dt >= 0.055  # held for the coalescing window before the flush
    _close(got, artifacts['pred'].run([_x(20, 1)])[0])


def test_per_request_error_isolation(artifacts):
    with BatchingPredictor(artifacts['multi'],
                           batch_timeout_ms=20.0) as batcher:
        good1 = batcher.submit([_x(30, 2)])
        bad_shape = batcher.submit([_x(31, 2).reshape(2, 2, DIM // 2)])
        too_big = batcher.submit([_x(32, 64)])  # > largest bucket
        good2 = batcher.submit([_x(33, 3)])
        with pytest.raises(ValueError, match='per-request shape'):
            bad_shape.result(timeout=30)
        with pytest.raises(ValueError, match='exceeds max_batch_size'):
            too_big.result(timeout=30)
        for fut, seed, rows in ((good1, 30, 2), (good2, 33, 3)):
            got, = fut.result(timeout=30)
            _close(got, artifacts['pred'].run([_x(seed, rows)])[0])


def test_cancelled_future_does_not_poison_the_batch(artifacts):
    pred = artifacts['pred']
    with BatchingPredictor(artifacts['single'],
                           batch_timeout_ms=40.0) as batcher:
        doomed = batcher.submit([_x(80, 1)])
        assert doomed.cancel()
        live = batcher.submit([_x(81, 2)])
        got, = live.result(timeout=30)
        _close(got, pred.run([_x(81, 2)])[0])
        got2, = batcher.run([_x(82, 1)], timeout=30)  # the next batch too
        assert got2.shape == (1, 4)


def test_caller_buffer_reuse_does_not_corrupt_request(artifacts):
    pred = artifacts['pred']
    buf = _x(90, 2)
    want, = pred.run([buf.copy()])
    with BatchingPredictor(artifacts['multi'],
                           batch_timeout_ms=30.0) as batcher:
        fut = batcher.submit([buf])
        buf[:] = -1e9  # refill for the "next" request while in flight
        got, = fut.result(timeout=30)
    _close(got, want)


def test_submit_after_close_raises(artifacts):
    batcher = BatchingPredictor(artifacts['single'], batch_timeout_ms=1.0)
    batcher.run([_x(40, 1)], timeout=30)
    batcher.close()
    batcher.close()  # idempotent
    with pytest.raises(RuntimeError, match='closed'):
        batcher.submit([_x(40, 1)])


def test_batcher_rejects_lod_and_unaligned_artifacts(tmp_path, artifacts):
    pred = _build_predictor(str(tmp_path), reduce_fetch=True)
    art = str(tmp_path / 'artifact')
    export_compiled(pred, [_x(3, 8)], art)
    with pytest.raises(ValueError, match='not batch-aligned'):
        BatchingPredictor(art)
    # a LoD feed in the signature (the JAX package writes such artifacts;
    # the port's export refuses them) is refused before anything loads
    lod = str(tmp_path / 'lod')
    shutil.copytree(artifacts['single'], lod)
    sig_path = os.path.join(lod, 'signature.json')
    with open(sig_path) as f:
        sig = json.load(f)
    sig['feeds'][0]['lod_levels'] = 1
    with open(sig_path, 'w') as f:
        json.dump(sig, f)
    with pytest.raises(ValueError, match='carries lod'):
        BatchingPredictor(lod)


def test_64_concurrent_requests_bit_identical(tmp_path):
    """64 concurrent batch-1 requests through a single 32-row bucket: every
    output equals CompiledPredictor.run of that request through the same
    bucket, bit for bit, wherever the request landed in its batch."""
    pred = _build_predictor(str(tmp_path), width=256, depth=3)
    art = str(tmp_path / 'artifact')
    export_compiled(pred, [_x(49, 4)], art, batch_sizes=[32])
    xs = [_x(50 + i, 1) for i in range(64)]
    seq = CompiledPredictor(art)
    seq_out = [seq.run([x])[0] for x in xs]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # threads switch often: races show
    try:
        with BatchingPredictor(art, batch_timeout_ms=250.0) as batcher:
            batcher.warmup(timeout=60)
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
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            snap = batcher.stats.snapshot()
    finally:
        sys.setswitchinterval(interval)
    for i in range(64):
        got, = results[i]
        assert np.array_equal(got, seq_out[i]), (
            'request %d not bit-identical to its unbatched run' % i)
    assert snap['requests'] == 64 and snap['batches'] >= 2


def test_three_buckets_share_one_parameter_copy(artifacts):
    with BatchingPredictor(artifacts['multi'],
                           batch_timeout_ms=1.0) as batcher:
        models = {id(batcher._preds[b]._model) for b in batcher.buckets}
        assert len(models) == 1
        model = batcher._preds[1]._model
        params = sorted(n for n, v in model.scope._vars.items()
                        if v is not None)
        assert params == ['fc_0.b_0', 'fc_0.w_0', 'fc_1.b_0', 'fc_1.w_0']
        before = {n: model.scope.get(n) for n in params}
        batcher.warmup()
        batcher.run([_x(5, 9)])
        # an inference run writes no persistable: the same tensors
        assert all(model.scope.get(n) is before[n] for n in params)


def test_serving_stats_snapshot(artifacts):
    with BatchingPredictor(artifacts['multi'],
                           batch_timeout_ms=5.0) as batcher:
        for i in range(6):
            batcher.run([_x(60 + i, 2)], timeout=30)
        snap = batcher.stats.snapshot()
    assert sorted(snap) == ['batches', 'drained', 'expired', 'occupancy',
                            'p50_ms', 'p95_ms', 'p99_ms', 'queue_depth',
                            'requests', 'shed', 'tier']
    assert snap['requests'] == 6 and snap['queue_depth'] == 0
    assert 0.0 < snap['occupancy'] <= 1.0
    assert snap['p99_ms'] >= snap['p50_ms'] > 0.0


def test_overloaded_queue_sheds_requests_fast(artifacts):
    batcher = BatchingPredictor(artifacts['multi'], max_queue=2,
                                batch_timeout_ms=5.0)
    with batcher.stats._lock:
        batcher.stats.queue_depth = 2       # a standing backlog
    fut = batcher.submit([_x(0, 1)], request_id='r-7')
    with pytest.raises(ServerOverloaded, match='shed.*r-7'):
        fut.result(5)
    with batcher.stats._lock:
        batcher.stats.queue_depth = 0
    out, = batcher.run([_x(1, 1)], timeout=30)  # back under: serves fine
    assert out.shape[0] == 1
    assert batcher.stats.snapshot()['shed'] == 1
    batcher.close()


def test_overload_flood_all_requests_resolve(artifacts):
    batcher = BatchingPredictor(artifacts['multi'], max_queue=4,
                                batch_timeout_ms=1.0)
    batcher.warmup()
    futs = [batcher.submit([_x(i, 1)]) for i in range(64)]
    served = shed = 0
    for f in futs:
        try:
            f.result(60)
            served += 1
        except ServerOverloaded:
            shed += 1
    assert served + shed == 64 and served >= 1
    snap = batcher.stats.snapshot()
    assert snap['shed'] == shed and snap['requests'] == served
    assert snap['queue_depth'] == 0
    batcher.close()


def test_deadlines(artifacts):
    with BatchingPredictor(artifacts['multi'],
                           batch_timeout_ms=5.0) as batcher:
        batcher.warmup()
        fut = batcher.submit([_x(2, 1)], deadline_ms=0.0)
        with pytest.raises(DeadlineExceeded, match='expired'):
            fut.result(5)
        out, = batcher.run([_x(3, 1)], timeout=30)  # no-deadline peer
        assert out.shape[0] == 1
        out, = batcher.run([_x(4, 2)], timeout=30, deadline_ms=60000.0)
        assert out.shape[0] == 2
        snap = batcher.stats.snapshot()
    assert snap['expired'] == 1 and snap['queue_depth'] == 0
    assert snap['requests'] == 2   # the expired one never ran


def test_drain_sheds_the_backlog(artifacts):
    batcher = BatchingPredictor(artifacts['single'],
                                batch_timeout_ms=200.0)
    first = batcher.submit([_x(6, 16)])   # fills the bucket: runs at once
    time.sleep(0.05)
    queued = [batcher.submit([_x(7 + i, 1)]) for i in range(3)]
    batcher.drain()
    assert first.result(30)[0].shape == (16, 4)
    outcomes = []
    for f in queued:
        try:
            f.result(30)
            outcomes.append('served')
        except ServerOverloaded:
            outcomes.append('shed')
    snap = batcher.stats.snapshot()
    assert snap['drained'] == outcomes.count('shed')
    assert snap['queue_depth'] == 0
    with pytest.raises(RuntimeError, match='closed'):
        batcher.submit([_x(9, 1)])
