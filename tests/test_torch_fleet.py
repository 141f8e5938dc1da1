"""The port's serving fleet on the CPU (paddle_tpu_torch/inference/fleet.py,
fleet_worker.py, fleet_ctl.py): the counterpart of each of
tests/test_fleet.py's tests, with port replicas on platform='cpu'.

FleetRouter routing / failover / drain semantics, Autoscaler decisions,
RollingRollout promote + loud rollback, the predictors' drain() hooks, the
decode tier plumbing, fleet_snapshot()'s keys (the reference renders them
in its profiler's fleet table; the port has no profiler, ROADMAP.md queue
1 item 11), the port's fleet_ctl and the repository's tools/fleet_ctl.py
on the same fleet directory, and `serve fleet`.

Chaos contract under test: killing one of N replicas mid-stream loses
ONLY that replica's in-flight requests (every other request completes
bit-identical to a single-replica reference); a hung (SIGSTOP) replica
is detected by the heartbeat watchdog in bounded time and its queue
re-routes; scale-in drains with zero dropped in-flight streams.

Replicas are `python -m paddle_tpu_torch.inference.fleet_worker`
processes that inherit this process's environment: PTPU_PLATFORM=cpu
(tests/conftest.py) and OMP_NUM_THREADS=1 (set here for the module), so
each runs on one torch thread, as this file's tests do.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu_torch.inference import (Autoscaler, BatchingPredictor,
                                        CompiledPredictor, DeadlineExceeded,
                                        DecodingPredictor, FleetRouter,
                                        ReplicaFailed, RollingRollout,
                                        RolloutRolledBack, ServerOverloaded,
                                        export_compiled, export_decode)
from paddle_tpu_torch.inference import fleet as fleet_mod
from paddle_tpu_torch.inference import fleet_worker as worker_mod
from paddle_tpu_torch.models.transformer import build_decode_spec

from _fleet_reference import _calibration, port_dense_model, run_jax_side

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 8
VOCAB = 61
DECODE = dict(vocab=VOCAB, d_model=8, n_head=2, n_layer=1, d_ff=16,
              max_slots=4, max_cache_len=40, prompt_buckets=(4,), eos_id=1)
# the keys of the reference's status() and fleet_snapshot()
# (paddle_tpu/inference/fleet.py status, fleet_snapshot)
STATUS_KEYS = {'time', 'pid', 'artifact', 'tier', 'kind', 'closed',
               'serving', 'replicas', 'counters'}
SNAPSHOT_KEYS = {'submitted', 'completed', 'failed', 'rerouted', 'shed',
                 'expired', 'replica_deaths', 'scale_out', 'scale_in',
                 'p50_ms', 'p99_ms', 'ttft_p50_ms', 'ttft_p99_ms',
                 'rollout', 'events', 'kind', 'artifact', 'tier', 'serving',
                 'replicas', 'queue_depth'}
REPLICA_KEYS = {'state', 'pid', 'artifact', 'tier', 'layout', 'mesh',
                'outstanding', 'pending', 'hb_age_s', 'compiles',
                'spinup_s', 'occupancy', 'queue_depth', 'requests', 'shed',
                'stats'}


@pytest.fixture(scope='module', autouse=True)
def _one_thread_replicas():
    """Replicas spawned by this module run on one torch thread."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('OMP_NUM_THREADS', '1')
        mp.setenv('PTPU_PLATFORM', 'cpu')
        yield


from _torch_threads import one_thread  # noqa: E402,F401 (autouse)


def _patient(router):
    """Raise every fleet timeout that only exists to bound wall-clock:
    under a loaded host a busy (not hung) replica must never be declared
    dead by a test."""
    router.hb_timeout_s = 60.0
    return router


def _export_decode(art, **kw):
    with ptt.unique_name.guard():
        spec = build_decode_spec(**dict(DECODE, **kw))
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(spec['startup'], scope=scope)
    export_decode(spec, art, scope=scope)
    return art


@pytest.fixture(scope='module')
def dense_art(tmp_path_factory):
    """tests/test_fleet.py's classifier, with the JAX package's initial
    state (tests/_fleet_reference.py), exported single-bucket [8]
    (requests of exactly 8 rows run the same shape everywhere: strict
    bit-identity) with a calibrated int8 tier, plus the in-process
    predictor as reference."""
    tmp = str(tmp_path_factory.mktemp('fleet_dense'))
    run_jax_side(tmp, 'params')
    with np.load(os.path.join(tmp, 'dense_params.npz')) as z:
        pred = port_dense_model(dict(z), os.path.join(tmp, 'model'))
    with open(os.path.join(tmp, 'reference.json')) as f:
        ref_parity = json.load(f)['int8_top1_parity']
    calib = _calibration()
    art = os.path.join(tmp, 'art')
    export_compiled(pred, calib[0], art, batch_sizes=[8], quantize='int8',
                    calibration=calib)
    return {'art': art, 'pred': pred, 'calib': calib,
            'ref_parity': ref_parity}


@pytest.fixture(scope='module')
def decode_art(tmp_path_factory):
    return _export_decode(
        os.path.join(str(tmp_path_factory.mktemp('fleet_decode')), 'decode'))


@pytest.fixture(scope='module')
def block_art(tmp_path_factory):
    """Block-paged decode artifact: the same model as decode_art with the
    cache as a block pool and chunked prefill."""
    return _export_decode(
        os.path.join(str(tmp_path_factory.mktemp('fleet_block')), 'block'),
        block_size=4)


def _x(seed, rows=8):
    return np.random.RandomState(100 + seed).randn(
        rows, DIM).astype(np.float32)


def _prompts(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, VOCAB, rng.randint(2, 5)) for _ in range(n)]


def _cpu_decoder(art, **kw):
    return DecodingPredictor(art, place=ptt.CPUPlace(), **kw)


# -- wire protocol / routing units (no subprocesses) -------------------------

def test_frame_roundtrip_and_bounds():
    import socket as socketlib
    a, b = socketlib.socketpair()
    hdr = {'op': 'infer', 'id': 7, 'deadline_ms': 12.5}
    arrays = {'x': np.arange(12, dtype=np.float32).reshape(3, 4),
              'y': np.array([b'ab', b'cd'])}
    fleet_mod._send_frame(a, hdr, arrays)
    fleet_mod._send_frame(a, {'op': 'stop'})
    got_hdr, got_arrays = fleet_mod._recv_frame(b)
    assert got_hdr == hdr
    np.testing.assert_array_equal(got_arrays['x'], arrays['x'])
    np.testing.assert_array_equal(got_arrays['y'], arrays['y'])
    hdr2, arrays2 = fleet_mod._recv_frame(b)
    assert hdr2 == {'op': 'stop'} and arrays2 == {}
    a.close()
    assert fleet_mod._recv_frame(b) is None  # clean EOF
    b.close()
    # corrupt length prefix -> loud IOError, not a hang
    c, d = socketlib.socketpair()
    c.sendall(b'\xff' * 8 + b'junk')
    with pytest.raises(IOError):
        fleet_mod._recv_frame(d)
    c.close()
    d.close()


def test_frame_bytes_equal_reference():
    """The frame is the reference's byte for byte, so either package's
    router could read the other's replica frames."""
    import socket as socketlib
    from paddle_tpu.inference import fleet as ref_fleet
    hdr = {'op': 'result', 'id': 3, 'ok': True, 'n': 1, 'lod': [0]}
    arrays = {'o0': np.arange(6, dtype=np.float32).reshape(2, 3)}
    got = []
    for send in (fleet_mod._send_frame, ref_fleet._send_frame):
        a, b = socketlib.socketpair()
        send(a, hdr, arrays)
        a.close()
        got.append(b''.join(iter(lambda: b.recv(1 << 16), b'')))
        b.close()
    assert got[0] == got[1]


def test_detect_kind(dense_art, decode_art, tmp_path):
    assert fleet_mod.detect_kind(dense_art['art']) == 'batching'
    assert fleet_mod.detect_kind(decode_art) == 'decoding'
    with pytest.raises(ValueError):
        fleet_mod.detect_kind(str(tmp_path))


def test_agreement_measures():
    a = [np.arange(8, dtype=np.float32).reshape(2, 4)]
    assert fleet_mod.bit_agreement(a, [a[0].copy()]) == 1.0
    b = [a[0] + 1e-6]
    assert fleet_mod.bit_agreement(a, b) == 0.0
    assert fleet_mod.top1_agreement(a, b) == 1.0  # argmax unchanged
    c = [a[0][:, ::-1].copy()]
    assert fleet_mod.top1_agreement(a, c) == 0.0
    # greedy transcripts compare exactly, in BOTH measures
    assert fleet_mod.bit_agreement([3, 1, 2], [3, 1, 2]) == 1.0
    assert fleet_mod.bit_agreement([3, 1, 2], [3, 1]) == 0.0
    assert fleet_mod.top1_agreement([3, 1, 2], [3, 1, 2]) == 1.0
    assert fleet_mod.top1_agreement([3, 1, 2], [3, 1, 9]) == 0.0
    assert fleet_mod.top1_agreement([3, 1, 2], [3, 1]) == 0.0


# -- predictor drain() hooks (in-process, the fleet's scale-in lever) --------

def test_batching_drain_sheds_queue_finishes_inflight(dense_art):
    """drain(): queued requests shed loudly (shed+drained counters), the
    in-flight dispatch delivers, submit() afterwards raises. The first
    dispatch is gated on an Event so a real queue backlog exists at drain
    time."""
    batcher = BatchingPredictor(dense_art['art'], platform='cpu',
                                batch_timeout_ms=1.0, max_batch_size=8)
    batcher.warmup()
    gate = threading.Event()
    real = batcher._preds[8]._call_flat

    def gated(args):
        gate.wait(30)
        return real(args)
    batcher._preds[8]._call_flat = gated
    # full-bucket requests: each dispatches alone; r0 blocks in the gated
    # dispatch while r1..r4 sit QUEUED behind it
    futs = [batcher.submit([_x(i)]) for i in range(5)]
    drainer = threading.Thread(target=batcher.drain)
    time.sleep(0.2)
    drainer.start()
    time.sleep(0.2)
    gate.set()
    drainer.join(60)
    assert not drainer.is_alive()
    outs = futs[0].result(60)     # the in-flight dispatch delivered
    want, = dense_art['pred'].run([_x(0)])
    np.testing.assert_array_equal(outs[0], want)
    shed = 0
    for f in futs[1:]:
        with pytest.raises(ServerOverloaded, match='draining'):
            f.result(60)
        shed += 1
    snap = batcher.stats.snapshot()
    assert snap['drained'] == shed == 4
    assert snap['shed'] >= 4
    with pytest.raises(RuntimeError):
        batcher.submit([_x(0)])
    batcher.close()  # idempotent after drain


def test_decoding_drain_finishes_active_sheds_waiting(decode_art):
    """drain(): ACTIVE streams decode to completion (zero drops), the
    waiting queue sheds re-routably, new submissions shed."""
    with _cpu_decoder(decode_art) as ref:
        want = ref.generate(_prompts(1)[0], max_new_tokens=24)
    pred = _cpu_decoder(decode_art)
    try:
        # 4 slots: 4 active + 3 waiting
        streams = [pred.submit(_prompts(1)[0], max_new_tokens=24)
                   for _ in range(7)]
        deadline = time.monotonic() + 30
        while pred.stats.snapshot()['prefills'] < 4 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        assert pred.drain(timeout=120)
        results, shed = [], 0
        for s in streams:
            try:
                results.append(s.result(60))
            except ServerOverloaded:
                shed += 1
        assert len(results) >= 4 and shed == 7 - len(results)
        assert all(r == want for r in results)
        snap = pred.stats.snapshot()
        assert snap['drained'] == shed
        # a draining endpoint admits nothing, sheds loudly
        with pytest.raises(ServerOverloaded):
            pred.submit(_prompts(1)[0]).result(60)
        assert pred.stats.snapshot()['drained'] == shed + 1
    finally:
        pred.close()


def test_compiled_predictor_drain_hook(dense_art):
    p = CompiledPredictor(dense_art['art'], platform='cpu')
    assert p.drain() is p  # synchronous predictor: no queue, no-op


# -- decode tier plumbing ----------------------------------------------------

def test_decoding_tier_contract(decode_art, tmp_path):
    """DecodingPredictor(tier=): an explicit missing tier raises (the
    BatchingPredictor contract); a present tier subdirectory resolves; the
    env preference falls back silently."""
    with pytest.raises(ValueError, match="has no 'int8' tier"):
        _cpu_decoder(decode_art, tier='int8')
    tiered = str(tmp_path / 'tiered')
    shutil.copytree(decode_art, tiered)
    _export_decode(os.path.join(tiered, 'int8'), kv_cache_dtype='int8')
    p = _cpu_decoder(tiered, tier='int8')
    assert p.stats.tier == 'int8'
    p.close()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('PTPU_SERVE_TIER', 'int8')
        p = _cpu_decoder(tiered)
        assert p.stats.tier == 'int8'
        p.close()
        p = _cpu_decoder(decode_art)
        assert p.stats.tier == 'bf16'
        p.close()


def test_serve_decode_cli_tier_flag(decode_art, tmp_path, capsys):
    """serve decode --tier (serve.main, as `python -m
    paddle_tpu_torch.inference.serve` runs it): an explicit missing tier
    fails loudly."""
    from paddle_tpu_torch.inference import serve
    prompts = np.zeros((2, 4), np.int64)
    prompts[:, :2] = 5
    in_p = str(tmp_path / 'p.npz')
    np.savez(in_p, prompts=prompts, lens=np.array([2, 2], np.int64))
    out_p = str(tmp_path / 'o.npz')
    argv = ['serve.py', 'decode', decode_art, in_p, out_p, '4']
    with pytest.raises(ValueError, match="has no 'int8' tier"):
        serve.main(argv + ['--tier', 'int8'])
    assert not os.path.exists(out_p)
    capsys.readouterr()
    assert serve.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line['tier'] == 'bf16' and line['requests'] == 2
    assert os.path.exists(out_p)


# -- fleet end-to-end --------------------------------------------------------

@pytest.fixture(scope='module')
def dense_fleet(dense_art):
    """One 2-replica batching fleet shared by the read-only tests."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        router = _patient(FleetRouter(dense_art['art'], replicas=2,
                                      platform='cpu',
                                      inflight_per_replica=4))
        yield router
        router.close()


def test_fleet_routes_bit_identical(dense_fleet, dense_art):
    xs = [_x(i) for i in range(10)]
    futs = [dense_fleet.submit({'img': x}) for x in xs]
    res = [f.result(120) for f in futs]
    for x, r in zip(xs, res):
        want, = dense_art['pred'].run([x])
        np.testing.assert_array_equal(r[0], want)
    # replica-side serving counters flow back through the heartbeat files
    # (0.5 s interval): poll until they account for the work
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        st = dense_fleet.status()
        if sum(s['requests'] for s in st['replicas'].values()) >= 10:
            break
        time.sleep(0.2)
    served = [s['requests'] for s in st['replicas'].values()]
    assert sum(served) >= 10 and st['serving'] == 2


def test_fleet_warm_spinup_zero_compiles_framework_free(dense_fleet):
    """Every replica reports 0 nvcc builds at spin-up, serves on the CPU
    here, and holds neither jax nor paddle_tpu in its modules (while this
    process holds both)."""
    assert 'jax' in sys.modules and 'paddle_tpu' in sys.modules
    snap = dense_fleet.fleet_snapshot()
    for rid, s in snap['replicas'].items():
        assert s['compiles'] == 0, (rid, s)
        assert s['mesh'] is None
    for rep in dense_fleet._replicas.values():
        assert rep.hello.get('framework_free') is True
        assert rep.hello['device'] == 'cpu'


def test_fleet_deadline_propagates(dense_fleet):
    fut = dense_fleet.submit({'img': _x(0)}, deadline_ms=0.0)
    with pytest.raises(DeadlineExceeded):
        fut.result(120)
    assert dense_fleet.fleet_snapshot()['expired'] >= 1


def test_fleet_submit_validation(dense_fleet):
    with pytest.raises(ValueError):
        dense_fleet.submit({'img': _x(0)}, beam=2)  # not a decode fleet
    fut = dense_fleet.submit({'wrong_feed': _x(0)})
    with pytest.raises(Exception):  # replica-side validation, loudly
        fut.result(120)


def test_fleet_snapshot_has_reference_keys(dense_fleet):
    """The port has no profiler to render the fleet table
    (test_fleet_report_renders in the reference): fleet_snapshot(), what
    the table reads, carries the reference's keys, and status() too."""
    snap = dense_fleet.fleet_snapshot()
    assert set(snap) == SNAPSHOT_KEYS
    assert snap['serving'] == 2 and snap['kind'] == 'fleet'
    for s in snap['replicas'].values():
        assert set(s) == REPLICA_KEYS
    assert set(dense_fleet.status()) == STATUS_KEYS


def test_fleet_status_json_and_ctl_cli(dense_fleet, capsys):
    """The port's fleet_ctl (its main(), as `python -m
    paddle_tpu_torch.inference.fleet_ctl` runs it) and the repository's
    tools/fleet_ctl.py (a process of its own) read the same fleet
    directory."""
    from paddle_tpu_torch.inference import fleet_ctl
    st = dense_fleet.status()
    assert st['serving'] == 2 and st['kind'] == 'batching'
    status_path = os.path.join(dense_fleet.fleet_dir, 'status.json')
    deadline = time.monotonic() + 10
    while not os.path.exists(status_path) \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    tool = [sys.executable, os.path.join(REPO, 'tools', 'fleet_ctl.py')]

    def port(*args):
        rc = fleet_ctl.main(list(args))
        return rc, capsys.readouterr().out

    def ref(*args):
        r = subprocess.run(tool + list(args), capture_output=True,
                           text=True)
        return r.returncode, r.stdout
    for ctl in (port, ref):
        rc, out = ctl('status', dense_fleet.fleet_dir, '--json')
        assert rc == 0, out
        js = json.loads(out)
        assert js['healthy'] and js['status']['serving'] == 2
        rc, out = ctl('status', dense_fleet.fleet_dir)
        assert rc == 0 and 'OK (2 serving' in out, out
        # usage errors exit 2
        assert ctl('status', '/not/a/fleet')[0] == 2
        assert ctl('drain', dense_fleet.fleet_dir, '99')[0] == 2


def test_fleet_chaos_sigkill_loses_only_victim_inflight(decode_art):
    """SIGKILL one replica mid-stream: bounded-time detection, only its
    in-flight requests fail (loudly), everything else bit-identical, the
    fleet keeps serving."""
    prompts = _prompts(48, seed=5)
    with _cpu_decoder(decode_art) as ref:
        want = [ref.generate(p, max_new_tokens=24) for p in prompts]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with _patient(FleetRouter(decode_art, replicas=2,
                                  platform='cpu',
                                  inflight_per_replica=4)) as router:
            futs = [router.submit(p, max_new_tokens=24) for p in prompts]
            time.sleep(0.1)
            victim = max(router._replicas.values(),
                         key=lambda r: len(r.outstanding)).rid
            os.kill(router._replicas[victim].proc.pid, signal.SIGKILL)
            t0 = time.perf_counter()
            done, failed = {}, []
            for i, f in enumerate(futs):
                try:
                    done[i] = f.result(300)
                except ReplicaFailed:
                    failed.append(i)
            assert time.perf_counter() - t0 < 120
            assert router._replicas[victim].state == 'dead'
            assert len(failed) <= 4, failed       # inflight cap
            assert len(done) + len(failed) == len(prompts)
            for i, r in done.items():
                assert r == want[i], 'request %d diverged' % i
            snap = router.fleet_snapshot()
            assert snap['replica_deaths'] == 1
            # survivors keep serving
            assert router.run(prompts[0], max_new_tokens=24,
                              timeout=300) == want[0]


def test_mid_stream_eviction_is_not_requeueable():
    """A block-pool eviction of an IN-FLIGHT stream raises
    MidStreamEvicted: still a ServerOverloaded for local callers, but the
    worker's post-dispatch re-route decision must refuse it (tokens may
    already have streamed). Door sheds (base ServerOverloaded) stay
    re-routable."""
    door = worker_mod._batching.ServerOverloaded('queue full')
    mid = worker_mod._decoding.MidStreamEvicted('evicted mid-decode')
    assert isinstance(mid, worker_mod._batching.ServerOverloaded)
    assert worker_mod._stream_requeueable(door)
    assert not worker_mod._stream_requeueable(mid)
    assert not worker_mod._stream_requeueable(RuntimeError('dispatch failed'))


def test_fleet_block_paged_artifact_unchanged_protocol(block_art):
    """A block-paged decode artifact routes through FleetRouter and the
    worker UNCHANGED: transcripts (greedy and beam) bit-identical to a
    direct in-process serve, hello layout='block', and the heartbeats
    carry the block-cache gauges."""
    prompts = _prompts(12, seed=21)
    with _cpu_decoder(block_art) as ref:
        assert ref.layout == 'block'
        want = [ref.generate(p, max_new_tokens=12) for p in prompts]
        want_beam = ref.generate(prompts[0], max_new_tokens=8, beam=3)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with _patient(FleetRouter(block_art, replicas=2,
                                  platform='cpu')) as router:
            assert router.kind == 'decoding'
            futs = [router.submit(p, max_new_tokens=12) for p in prompts]
            got = [f.result(300) for f in futs]
            assert got == want
            ids, scores = router.run(prompts[0], max_new_tokens=8, beam=3,
                                     timeout=300)
            np.testing.assert_array_equal(ids, want_beam[0])
            np.testing.assert_array_equal(scores, want_beam[1])
            st = router.status()
            for s in st['replicas'].values():
                assert s['layout'] == 'block'
                assert s['mesh'] is None
            deadline = time.time() + 30
            while time.time() < deadline:
                stats = [s.get('stats', {})
                         for s in router.status()['replicas'].values()]
                if any('blocks_in_use' in x for x in stats):
                    break
                time.sleep(0.2)
            assert any('blocks_in_use' in x for x in stats)


def test_fleet_hung_replica_sigstop_watchdog(decode_art):
    """SIGSTOP (hung, not dead): no socket EOF — the heartbeat watchdog
    detects staleness in bounded time, SIGKILLs the replica, re-routes its
    queued work; the fleet keeps serving."""
    prompts = _prompts(8, seed=9)
    with _cpu_decoder(decode_art) as ref:
        want = ref.generate(prompts[0], max_new_tokens=12)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with FleetRouter(decode_art, replicas=2, platform='cpu',
                         hb_timeout_s=2.5, poll_s=0.1) as router:
            victim = router.serving_replicas()[0]
            os.kill(router._replicas[victim].proc.pid, signal.SIGSTOP)
            t0 = time.perf_counter()
            while router._replicas[victim].state != 'dead' \
                    and time.perf_counter() - t0 < 30:
                time.sleep(0.05)
            detect = time.perf_counter() - t0
            assert router._replicas[victim].state == 'dead'
            assert detect < 30, detect
            ev = [e for e in router.stats.events
                  if e['kind'] == 'replica_dead']
            assert ev and 'heartbeat stale' in ev[0]['reason']
            assert router.run(prompts[0], max_new_tokens=12,
                              timeout=300) == want


def test_fleet_scale_in_drains_zero_drops(decode_art):
    """scale_in: the victim finishes its in-flight streams and hands its
    queue back for re-routing; every submitted future resolves."""
    prompts = _prompts(24, seed=13)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with _patient(FleetRouter(decode_art, replicas=2,
                                  platform='cpu',
                                  inflight_per_replica=3)) as router:
            futs = [router.submit(p, max_new_tokens=16) for p in prompts]
            assert router.scale_in(timeout=300)
            results = [f.result(300) for f in futs]
            assert len(results) == len(prompts)
            snap = router.fleet_snapshot()
            assert snap['failed'] == 0 and snap['scale_in'] == 1
            assert len(router.serving_replicas()) == 1
            states = [r.state for r in router._replicas.values()]
            assert 'retired' in states


def test_autoscaler_decisions():
    """Autoscaler.step() against synthetic router metrics: out on queue
    pressure, out on failover below min, in after a sustained idle streak,
    bounded by min/max, cooldown respected."""

    class FakeRouter(object):
        def __init__(self):
            self.n = 1
            self.queue = 0
            self.shed = 0
            self.events = []
            self._closed = False
            self.stats = fleet_mod.FleetStats()

        def status(self):
            reps = {i: {'state': 'serving', 'pending': self.queue
                        if i == 0 else 0, 'outstanding': 0,
                        'queue_depth': 0, 'occupancy': 0.5,
                        'shed': self.shed}
                    for i in range(self.n)}
            return {'replicas': reps, 'counters': {'shed': 0}}

        def scale_out(self, reason=None):
            self.n += 1
            self.events.append('out')

        def scale_in(self, reason=None):
            self.n -= 1
            self.events.append('in')

    r = FakeRouter()
    a = Autoscaler(r, min_replicas=1, max_replicas=3,
                   high_queue_per_replica=4.0, idle_steps=2, cooldown_s=0.0)
    assert a.step() is None          # calm: no action
    r.queue = 10
    assert a.step() == 'out' and r.n == 2
    assert a.step() == 'out' and r.n == 3
    assert a.step() is None          # max_replicas bound
    r.queue = 0
    assert a.step() is None          # idle streak 1 < idle_steps
    assert a.step() == 'in' and r.n == 2
    a.cooldown_s = 3600.0
    assert a.step() is None          # cooldown gates further scale-in
    a.cooldown_s = 0.0
    r.n = 0
    assert a.step() == 'out'         # failover replacement below min
    r.queue = 1
    r.shed += 5
    a.step()
    assert a._idle_streak == 0       # sheds break the idle streak


def test_rolling_rollout_promote_and_loud_rollback(dense_art):
    """The int8 canary promotes on top-1 parity over the calibration set
    at an unchanged replica count; an injected parity failure (bit
    agreement across tiers) rolls back loudly and leaves the fleet
    untouched.

    The bar is the reference's own parity on this model and these probes,
    measured by the JAX package's serving in tests/_fleet_reference.py
    (31 of 32 rows: one row's top two f32 outputs lie 0.0014 apart, and
    int8 swaps them in both packages), and the canary must reach it
    exactly."""
    probes = [{'img': c[0]} for c in dense_art['calib']]
    bar = dense_art['ref_parity']
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with _patient(FleetRouter(dense_art['art'], replicas=2,
                                  platform='cpu')) as router:
            report = RollingRollout(
                router, tier='int8', probes=probes, agreement='top1',
                min_agreement=bar, latency_budget=100.0).run()
            assert report['promoted'] and report['deterministic']
            assert report['agreement'] == round(bar, 6)
            tiers = {rid: s['tier'] for rid, s in
                     router.fleet_snapshot()['replicas'].items()
                     if s['state'] == 'serving'}
            assert len(tiers) == 2 and set(tiers.values()) == {'int8'}
            assert router.stats.rollout['state'] == 'promoted'
            # injected failure: int8 outputs never bit-match the f32 tier's
            with pytest.raises(RolloutRolledBack, match='agreement'):
                RollingRollout(router, tier=None, probes=probes,
                               agreement='bit', latency_budget=100.0).run()
            tiers2 = {rid: s['tier'] for rid, s in
                      router.fleet_snapshot()['replicas'].items()
                      if s['state'] == 'serving'}
            assert tiers2 == tiers, 'rollback must not touch the fleet'
            assert router.stats.rollout['state'] == 'rolled_back'
            # the fleet still serves after the rollback
            router.run(probes[0], timeout=120)


def test_serve_fleet_cli_decode_artifact(decode_art, tmp_path, capsys):
    """serve fleet (serve.main) on a DECODE artifact: the prompts npz
    convention."""
    from paddle_tpu_torch.inference import serve
    prompts = np.zeros((3, 4), np.int64)
    prompts[:, :2] = [[5, 7], [9, 3], [2, 8]]
    in_p = str(tmp_path / 'p.npz')
    np.savez(in_p, prompts=prompts, lens=np.array([2, 2, 2], np.int64))
    capsys.readouterr()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        assert serve.main(['serve.py', 'fleet', decode_art, in_p, '6',
                           '2']) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line['requests'] == 6 and line['failed'] == 0
    assert all(s['compiles'] == 0 for s in line['per_replica'].values())


def test_fleet_submit_rejects_object_arrays(dense_fleet):
    """Object arrays need pickle, which the worker's np.load refuses: the
    request must fail at submit, not poison a replica's stream."""
    with pytest.raises(ValueError, match='object array'):
        dense_fleet.submit({'img': np.array([['a'], [None]], dtype=object)})


def test_fleet_bad_ctl_file_never_kills_watchdog(dense_fleet):
    """A malformed control file warns and is removed; the watchdog (the
    fleet's failure detector) keeps running."""
    ctl = os.path.join(dense_fleet.fleet_dir, 'ctl')
    bad = os.path.join(ctl, 'drain_x.json')
    with open(bad, 'w') as f:
        f.write('{"cmd": "drain", "replica": "abc"}')
    with open(os.path.join(ctl, 'noise.json'), 'w') as f:
        f.write('not json at all')
    deadline = time.monotonic() + 15
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        while os.listdir(ctl) and time.monotonic() < deadline:
            time.sleep(0.1)
    assert os.listdir(ctl) == []
    assert dense_fleet._watchdog_t.is_alive()
    # and the fleet still serves
    dense_fleet.run({'img': _x(3)}, timeout=120)


def test_fleet_spawn_failure_fails_fast(dense_art, tmp_path):
    """A replica that crashes during spin-up (broken artifact) raises
    within the watchdog poll, not after the full spin-up timeout."""
    broken = str(tmp_path / 'broken')
    os.makedirs(broken)
    shutil.copy(os.path.join(dense_art['art'], 'signature.json'),
                broken)  # looks like an artifact; the program is missing
    t0 = time.monotonic()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with pytest.raises(RuntimeError, match='failed to start'):
            FleetRouter(broken, replicas=1, platform='cpu',
                        spinup_timeout_s=300.0).close()
    assert time.monotonic() - t0 < 60


def test_fleet_close_fails_pending_loudly(dense_art):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        router = _patient(FleetRouter(dense_art['art'], replicas=1,
                                      platform='cpu'))
        fut = router.submit({'img': _x(0)})
        router.close()
        with pytest.raises(Exception):
            fut.result(30)
        with pytest.raises(RuntimeError):
            router.submit({'img': _x(1)})
        # idempotent
        router.close()
