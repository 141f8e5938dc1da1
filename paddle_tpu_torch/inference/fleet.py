"""Serving fleet control plane (ref: paddle_tpu/inference/fleet.py).

`FleetRouter` fronts N warm replicas of one of the port's predictors
(`BatchingPredictor`, `DecodingPredictor`, `CompiledPredictor`) behind one
`submit()` API:

1. **Replica subprocess workers**: each replica is a
   `python -m paddle_tpu_torch.inference.fleet_worker` process that loads
   the artifact onto its place (CUDAPlace(0) unless `platform='cpu'`),
   warms it up, and speaks a small length-prefixed frame protocol over a
   unix socket (JSON header + optional npz body; `_send_frame` /
   `_recv_frame` below are the whole wire format, byte-compatible with the
   reference's). N replicas on one card share it: each holds its own
   CUDA context, parameters and cache, and the card time-slices them.
2. **Least-outstanding-work routing with deadline propagation**: a
   request goes to the serving replica with the fewest outstanding +
   queued requests; at most `inflight_per_replica` frames are in a replica
   at once, the rest wait in a router-side per-replica queue
   (re-routable). A request's `deadline_ms` is re-computed to the
   REMAINING budget when the frame is actually written, so time spent
   queued at the router counts against the same deadline the replica
   enforces.
3. **Health-checked failover**: replicas write heartbeat files (atomic
   replace, mtime = liveness, payload = serving stats); the router's
   watchdog detects a dead replica (socket EOF / process exit) or a HUNG
   one (heartbeat stale -> SIGKILL) in bounded time. Its router-side
   queued requests re-route to healthy replicas; its in-flight requests
   fail LOUDLY with `ReplicaFailed`, never silently dropped.
   Replica-shed requests (`ServerOverloaded`, never dispatched to the
   device) re-route automatically.
4. **Autoscaler**: scales out/in on the occupancy / queue-depth /
   shed-rate counters the serving stats already measure; scale-in DRAINS:
   the victim stops admitting, finishes its in-flight decode streams /
   batch dispatches (predictor `drain()` hooks), hands its queue back for
   re-routing, then retires.
5. **RollingRollout**: canaries a new artifact tier (e.g. the int8 tier)
   on one replica, promotes on parity + latency-budget checks against the
   incumbent (canary determinism is checked BIT-exactly; incumbent
   agreement per tier policy: 'bit' for same-tier, 'top1' / transcript for
   quantized), then rolls the fleet one replica at a time
   (spawn-before-drain, capacity never dips). Any failed check rolls back
   LOUDLY (`RolloutRolledBack`).

`status()` and `fleet_snapshot()` carry the per-replica occupancy, queue
depth, reroutes, p50/p99 TTFT and latency, scale events and rollout state,
and `fleet_dir/status.json` holds the same for `fleet_ctl` (the port's
`python -m paddle_tpu_torch.inference.fleet_ctl`, or the repository's
`tools/fleet_ctl.py`: the file layout is the reference's).

Not ported yet: the profiler's fleet source (the reference registers
`fleet_snapshot` with `paddle_tpu.profiler`; the port has no profiler,
ROADMAP.md queue 1 item 11), so a router registers nothing.

The router imports the port's serving modules, and with them torch, but
touches no device: the replicas do the serving. It hands its process's
torch numerics settings (TF32, reduced-precision reductions, cuDNN's
determinism and benchmark switches) to every replica, so that a replica
computes what an in-process predictor of the router's process computes,
bit for bit.
"""
import io
import itertools
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future

import numpy as np

from . import batching as _batching
from . import decoding as _decoding
from . import serve as _serve

_percentiles = _decoding._percentiles
_resolve = _batching._resolve
ServerOverloaded = _batching.ServerOverloaded
DeadlineExceeded = _batching.DeadlineExceeded

class _Unset(object):
    """Keyword-default sentinel (tier=_UNSET means "keep the current
    tier", while tier=None means "the bf16 default tier"). Stable repr
    so API.spec stays reproducible across processes."""
    __slots__ = ()

    def __repr__(self):
        return '<keep-current>'


_UNSET = _Unset()
# wire sanity bound: a frame beyond this is protocol corruption, not data
_MAX_FRAME = 1 << 31


class ReplicaFailed(RuntimeError):
    """The replica serving this request died (or hung past the heartbeat
    timeout and was killed) while the request was IN FLIGHT. The request
    may or may not have produced device work; the fleet fails it loudly
    rather than retrying (a side-effect-free caller may resubmit)."""


class FleetUnavailable(RuntimeError):
    """No serving replica exists to route to (all dead/draining and the
    autoscaler has not replaced them)."""


class RolloutRolledBack(RuntimeError):
    """A rolling rollout failed a parity/latency check and was rolled
    back: the canary is retired, the incumbent fleet is untouched."""


# -- wire protocol -----------------------------------------------------------
# frame := u64 len | u32 header_len | header json | [npz body]
# The npz body carries every array of the message (numpy's own binary
# format — versioned, validated, no pickle). fleet_worker imports these
# two functions; together they are the complete wire format, the
# reference's byte for byte.

def _send_frame(sock, header, arrays=None):
    hb = json.dumps(header).encode('utf-8')
    body = b''
    if arrays:
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        body = buf.getvalue()
    payload = struct.pack('>I', len(hb)) + hb + body
    sock.sendall(struct.pack('>Q', len(payload)) + payload)


def _recv_exact(sock, n):
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            return None
        chunks.append(chunk)
        got += len(chunk)
    return b''.join(chunks)


def _recv_frame(sock):
    """One (header dict, {name: array}) message; None on clean EOF."""
    head = _recv_exact(sock, 8)
    if head is None:
        return None
    (n,) = struct.unpack('>Q', head)
    if not 4 <= n <= _MAX_FRAME:
        raise IOError('fleet protocol: bad frame length %d' % n)
    payload = _recv_exact(sock, n)
    if payload is None:
        return None
    (hn,) = struct.unpack('>I', payload[:4])
    header = json.loads(payload[4:4 + hn].decode('utf-8'))
    arrays = {}
    if len(payload) > 4 + hn:
        with np.load(io.BytesIO(payload[4 + hn:]),
                     allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    return header, arrays


# -- replica heartbeat files -------------------------------------------------

def write_heartbeat(path, payload):
    """Atomic heartbeat refresh: mtime is the liveness signal, the JSON
    payload carries the replica's serving stats (flock-free by design —
    a hung filesystem lock must never stall the writer)."""
    rec = dict(payload)
    rec['time'] = time.time()
    tmp = '%s.%d.tmp' % (path, os.getpid())
    with open(tmp, 'w') as f:
        f.write(json.dumps(rec))
    os.replace(tmp, path)
    return path


def read_heartbeat(path):
    """(payload, age_s); ({}, inf) when absent/unreadable."""
    try:
        age = time.time() - os.path.getmtime(path)
        with open(path) as f:
            return json.load(f), age
    except (OSError, ValueError):
        try:
            return {}, time.time() - os.path.getmtime(path)
        except OSError:
            return {}, float('inf')


def detect_kind(artifact_dir):
    """The worker kind an artifact serves through: 'decoding' for
    export_decode's two-program layout, 'batching' for (multi-bucket)
    dense compiled artifacts. 'compiled' (synchronous CompiledPredictor)
    is never auto-detected — request it explicitly."""
    if os.path.exists(os.path.join(artifact_dir,
                                   _decoding._DECODE_SIGNATURE)):
        return 'decoding'
    if os.path.exists(os.path.join(artifact_dir, _serve._SIGNATURE)):
        return 'batching'
    raise ValueError(
        '%s is not a serving artifact (no %s / %s)'
        % (artifact_dir, _decoding._DECODE_SIGNATURE, _serve._SIGNATURE))


_EXC_TYPES = {
    'DeadlineExceeded': DeadlineExceeded,
    'ServerOverloaded': ServerOverloaded,
    'ValueError': ValueError,
    'TimeoutError': TimeoutError,
}


def _rebuild_exc(header):
    cls = _EXC_TYPES.get(header.get('etype'), RuntimeError)
    return cls(header.get('error', 'replica error'))


class _FleetRequest(object):
    __slots__ = ('id', 'header', 'arrays', 'future', 't_submit',
                 'deadline', 'attempts', 'on_token', 't_first', 'replica',
                 'request_id')

    def __init__(self, rid, header, arrays, deadline_ms, on_token=None,
                 request_id=None):
        self.id = rid
        self.header = header        # op + per-op fields (no id/deadline)
        self.arrays = arrays
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = (self.t_submit + deadline_ms / 1e3
                         if deadline_ms is not None else None)
        self.attempts = 0
        self.on_token = on_token
        self.t_first = None         # first token/result arrival
        self.replica = None
        self.request_id = request_id  # caller trace id (gateway etc.)


def _rid_suffix(req):
    """' (request <id>)' when the caller tagged the request — every
    router-originated error names something the caller can correlate."""
    return ' (request %s)' % req.request_id if req.request_id else ''


class _Replica(object):
    """Router-side view of one replica subprocess."""

    def __init__(self, rid, spec):
        self.rid = rid
        self.spec = dict(spec)      # artifact/tier/kind/opts (+canary)
        self.proc = None
        self.sock = None
        self.state = 'starting'     # -> serving|canary -> draining ->
        #                              retiring -> retired; or dead
        self.outstanding = {}       # request id -> _FleetRequest
        self.pending = deque()      # router-side queue (re-routable)
        self.send_lock = threading.Lock()
        self.hello = {}
        self.hb = {}
        self.hb_age = float('inf')
        self.ready_evt = threading.Event()
        self.drained_evt = threading.Event()
        self.reader_t = None
        self.t_spawn = time.perf_counter()
        self.spinup_s = None

    @property
    def load(self):
        return len(self.outstanding) + len(self.pending)

    def snapshot(self):
        stats = self.hb.get('stats', {}) or {}
        return {'state': self.state,
                'pid': self.proc.pid if self.proc else None,
                # the artifact the worker REPORTS serving (hello, then
                # heartbeats): lets an operator map a wedged replica
                # row to a process + on-disk artifact
                'artifact': (self.hb.get('artifact')
                             or self.hello.get('artifact')
                             or self.spec.get('artifact')),
                'tier': self.hello.get('tier', self.spec.get('tier')
                                       or 'bf16'),
                # decode artifacts: cache layout + mesh tag the worker
                # actually loaded (the port has no mesh: None)
                'layout': self.hello.get('layout'),
                'mesh': self.hello.get('mesh'),
                'outstanding': len(self.outstanding),
                'pending': len(self.pending),
                'hb_age_s': (round(self.hb_age, 3)
                             if self.hb_age != float('inf') else None),
                'compiles': self.hello.get('compiles'),
                'spinup_s': self.spinup_s,
                'occupancy': stats.get('occupancy', 0.0),
                'queue_depth': stats.get('queue_depth', 0),
                'requests': stats.get('requests', 0),
                'shed': stats.get('shed', 0),
                'stats': stats}


class FleetStats(object):
    """Thread-safe fleet counters + latency/TTFT windows + a bounded
    event log (deaths, reroutes, scale and rollout transitions)."""

    def __init__(self, window=8192, max_events=512):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=window)
        self._ttft = deque(maxlen=window)
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rerouted = 0
        self.shed = 0
        self.expired = 0
        self.replica_deaths = 0
        self.scale_out = 0
        self.scale_in = 0
        self.events = deque(maxlen=max_events)
        self.rollout = {'state': 'idle'}

    def reset(self):
        """Zero the counters and latency/TTFT windows (the event log
        stays): separates a warmup/calibration phase from the measured
        run — the ServingStats.reset discipline."""
        with self._lock:
            self._lat.clear()
            self._ttft.clear()
            self.submitted = 0
            self.completed = 0
            self.failed = 0
            self.rerouted = 0
            self.shed = 0
            self.expired = 0

    def record_event(self, kind, replica=None, reason=None):
        with self._lock:
            self.events.append({'time': time.time(), 'kind': kind,
                                'replica': replica, 'reason': reason})

    def record_done(self, latency_s, ttft_s):
        with self._lock:
            self.completed += 1
            self._lat.append(latency_s)
            if ttft_s is not None:
                self._ttft.append(ttft_s)

    def snapshot(self):
        with self._lock:
            p50, p99 = _percentiles(list(self._lat), [50, 99])
            t50, t99 = _percentiles(list(self._ttft), [50, 99])
            return {'submitted': int(self.submitted),
                    'completed': int(self.completed),
                    'failed': int(self.failed),
                    'rerouted': int(self.rerouted),
                    'shed': int(self.shed),
                    'expired': int(self.expired),
                    'replica_deaths': int(self.replica_deaths),
                    'scale_out': int(self.scale_out),
                    'scale_in': int(self.scale_in),
                    'p50_ms': p50, 'p99_ms': p99,
                    'ttft_p50_ms': t50, 'ttft_p99_ms': t99,
                    'rollout': dict(self.rollout),
                    'events': list(self.events)[-8:]}


# the torch switches that choose how f32 and bf16 arithmetic rounds and
# which cuDNN algorithms run: a replica takes its router's, so that it
# computes what an in-process predictor of the router's process computes
_NUMERICS = (('cuda.matmul', 'allow_tf32'),
             ('cuda.matmul', 'allow_bf16_reduced_precision_reduction'),
             ('cuda.matmul', 'allow_fp16_reduced_precision_reduction'),
             ('cudnn', 'allow_tf32'),
             ('cudnn', 'deterministic'),
             ('cudnn', 'benchmark'))


def _backend(path):
    import torch
    obj = torch.backends
    for part in path.split('.'):
        obj = getattr(obj, part)
    return obj


def numerics():
    """This process's torch numerics switches, {'<backend>.<flag>': bool}
    (what a replica is given in its opts)."""
    return {'%s.%s' % (path, flag): bool(getattr(_backend(path), flag))
            for path, flag in _NUMERICS}


def apply_numerics(settings):
    """Set the switches `numerics()` read in another process."""
    for key, value in settings.items():
        path, flag = key.rsplit('.', 1)
        setattr(_backend(path), flag, bool(value))


def _worker_argv():
    """The replica's command: the worker run as a package module."""
    return [sys.executable, '-m', 'paddle_tpu_torch.inference.fleet_worker']


def _worker_env():
    """The router's environment with the directory that holds the
    paddle_tpu_torch package in front of PYTHONPATH, so that a replica
    imports the router's copy of the port wherever it starts."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (root, env.get('PYTHONPATH')) if p)
    return env


class FleetRouter(object):
    """Route requests across N warm replica subprocesses of one serving
    artifact.

    submit(...) -> Future        route one request (kind-dependent args)
    scale_out() / scale_in()     add a replica / drain + retire one
    drain_replica(rid)           draining stop: finish in-flight, retire
    status()                     full fleet view (also fleet_dir/status.json)
    fleet_snapshot()             status() as the reference's profiler
                                 fleet source reads it
    close()                      stop every replica and router thread

    `kind` ('auto' default) picks the worker endpoint: 'batching'
    (dense request/response through BatchingPredictor), 'decoding'
    (token streams through DecodingPredictor), or 'compiled'
    (synchronous CompiledPredictor, one request at a time).
    `tier` spawns every replica on that artifact tier (the
    BatchingPredictor(tier=) explicit-missing-raises contract applies
    in the worker). `platform` is where the replicas serve: None (or
    'gpu') is CUDAPlace(0) in every replica, 'cpu' the CPU (env
    PTPU_PLATFORM, inherited, counts as serve._place reads it); a replica
    that finds no card fails its spin-up. `fleet_dir` holds the control
    socket, heartbeat files, control files and status.json (a temp dir by
    default).
    """

    def __init__(self, artifact_dir, replicas=2, kind='auto', tier=None,
                 platform=None, fleet_dir=None, max_queue=None,
                 inflight_per_replica=8, hb_timeout_s=5.0, poll_s=0.2,
                 spinup_timeout_s=300.0, max_route_attempts=4,
                 worker_opts=None, warmup=True, stats_window=8192):
        self.artifact_dir = artifact_dir
        self.kind = detect_kind(artifact_dir) if kind == 'auto' else kind
        if self.kind not in ('batching', 'decoding', 'compiled'):
            raise ValueError('unknown fleet kind %r' % (self.kind,))
        self._spec = {'artifact': artifact_dir, 'tier': tier,
                      'kind': self.kind, 'platform': platform,
                      'warmup': bool(warmup),
                      'numerics': numerics(),
                      'opts': dict(worker_opts or {})}
        self._max_queue = int(max_queue) if max_queue else None
        self._inflight = max(1, int(inflight_per_replica))
        self.hb_timeout_s = float(hb_timeout_s)
        self._poll_s = float(poll_s)
        self._spinup_timeout_s = float(spinup_timeout_s)
        self._max_attempts = max(1, int(max_route_attempts))
        self._feed_names = self._load_feed_names(artifact_dir)
        self.stats = FleetStats(stats_window)
        self._replicas = {}
        self._next_rid = itertools.count()
        self._req_ids = itertools.count()
        self._lock = threading.RLock()
        self._closed = False
        if fleet_dir is None:
            fleet_dir = tempfile.mkdtemp(prefix='ptpu_fleet_')
        self.fleet_dir = fleet_dir
        os.makedirs(os.path.join(fleet_dir, 'hb'), exist_ok=True)
        os.makedirs(os.path.join(fleet_dir, 'ctl'), exist_ok=True)
        self._sock_path = self._make_sock_path(fleet_dir)
        self._listener = socket.socket(socket.AF_UNIX,
                                       socket.SOCK_STREAM)
        self._listener.bind(self._sock_path)
        self._listener.listen(64)
        self._accept_t = threading.Thread(
            target=self._accept_loop, name='ptpu-fleet-accept',
            daemon=True)
        self._accept_t.start()
        self._stop_evt = threading.Event()
        self._watchdog_t = threading.Thread(
            target=self._watchdog_loop, name='ptpu-fleet-watchdog',
            daemon=True)
        self._watchdog_t.start()
        try:
            rids = [self._spawn(self._spec, wait=False)
                    for _ in range(int(replicas))]
            for rid in rids:
                self._await_ready(rid)
        except Exception:
            self.close()
            raise
        self._write_status()

    # -- construction helpers ---------------------------------------------
    def _make_sock_path(self, fleet_dir):
        p = os.path.join(fleet_dir, 'router.sock')
        self._sock_tmpdir = None
        if len(p) > 96:  # AF_UNIX sun_path limit (~107); pytest tmp
            # paths routinely exceed it — fall back to a short /tmp dir
            # (remembered so close() can remove it)
            self._sock_tmpdir = tempfile.mkdtemp(prefix='ptpu_fl_')
            p = os.path.join(self._sock_tmpdir, 'router.sock')
        if os.path.exists(p):
            os.unlink(p)
        return p

    def _load_feed_names(self, artifact_dir):
        if self.kind == 'decoding':
            return None
        try:
            with open(os.path.join(artifact_dir, _serve._SIGNATURE)) as f:
                return [e['name'] for e in json.load(f)['feeds']]
        except Exception:
            return None

    # -- replica lifecycle -------------------------------------------------
    def _hb_path(self, rid):
        return os.path.join(self.fleet_dir, 'hb',
                            'replica_%d.json' % rid)

    def _spawn(self, spec, wait=True, canary=False):
        """Start one replica subprocess; returns its rid. With wait, the
        call blocks until the worker's hello (warm + ready) or raises."""
        with self._lock:
            if self._closed:
                raise RuntimeError('FleetRouter is closed')
            rid = next(self._next_rid)
            sp = dict(spec)
            sp['canary'] = bool(canary)
            rep = _Replica(rid, sp)
            self._replicas[rid] = rep
        hb = self._hb_path(rid)
        if os.path.exists(hb):
            os.unlink(hb)
        opts = dict(sp.get('opts') or {})
        opts.setdefault('kind', sp['kind'])
        if sp.get('tier'):
            opts.setdefault('tier', sp['tier'])
        if sp.get('platform'):
            opts.setdefault('platform', sp['platform'])
        opts.setdefault('warmup', sp.get('warmup', True))
        opts.setdefault('numerics', sp['numerics'])
        argv = _worker_argv() + [self._sock_path, str(rid),
                                 sp['artifact'], hb, json.dumps(opts)]
        # exec'd, never forked: the router's process may hold a CUDA
        # context and threads
        rep.proc = subprocess.Popen(
            argv, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            env=_worker_env(), start_new_session=True)
        self.stats.record_event('spawn', rid,
                                'tier=%s' % (sp.get('tier') or 'bf16'))
        if wait:
            self._await_ready(rid)
        return rid

    def _await_ready(self, rid):
        rep = self._replicas[rid]
        if not rep.ready_evt.wait(self._spinup_timeout_s) \
                or rep.state not in ('serving', 'canary'):
            self._on_replica_failure(rep, 'failed to start (state %r)'
                                     % rep.state)
            raise RuntimeError(
                'fleet replica %d failed to start within %.0fs '
                '(state %r) — see its stderr above'
                % (rid, self._spinup_timeout_s, rep.state))
        return rid

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(target=self._handshake, args=(conn,),
                             daemon=True).start()

    def _handshake(self, conn):
        try:
            conn.settimeout(self._spinup_timeout_s)
            fr = _recv_frame(conn)
            if fr is None:
                conn.close()
                return
            hdr, _ = fr
            if hdr.get('op') != 'hello':
                raise IOError('expected hello, got %r' % hdr.get('op'))
            rid = int(hdr['replica'])
            conn.settimeout(None)
            with self._lock:
                rep = self._replicas.get(rid)
                if rep is None or rep.state != 'starting':
                    conn.close()
                    return
                rep.sock = conn
                rep.hello = hdr
                rep.spinup_s = round(
                    time.perf_counter() - rep.t_spawn, 3)
                rep.state = ('canary' if rep.spec.get('canary')
                             else 'serving')
                rep.reader_t = threading.Thread(
                    target=self._reader_loop, args=(rep,),
                    name='ptpu-fleet-reader-%d' % rid, daemon=True)
                rep.reader_t.start()
            rep.ready_evt.set()
        except Exception as e:
            warnings.warn('fleet: replica handshake failed (%s: %s)'
                          % (type(e).__name__, e), RuntimeWarning)
            try:
                conn.close()
            except OSError:
                pass

    # -- request path ------------------------------------------------------
    def submit(self, inputs, deadline_ms=None, max_new_tokens=None,
               beam=None, on_token=None, request_id=None):
        """Route one request; returns a Future.

        batching/compiled fleets: `inputs` is a dict (or feed-order
        list) of per-request arrays, exactly as the underlying
        predictor's submit/run takes; the future resolves to the
        per-fetch output list. decoding fleets: `inputs` is the prompt
        id sequence; `max_new_tokens`/`beam` as DecodingPredictor; the
        future resolves to the transcript (greedy: token list, beam:
        (ids, scores)); `on_token(tok)` streams greedy tokens as they
        decode. `deadline_ms` propagates: router queue time counts
        against the same budget the replica enforces.

        `on_token` contract: called once per token, in transcript
        order, from the router's reader thread. Delivery granularity
        follows the replica's advance granularity — a speculatively
        decoding replica coalesces each verify tick's whole
        multi-token advance into ONE wire frame, and the router then
        fires `on_token` for each token of the batch back-to-back, so
        several calls may land with no network round-trip between them.
        Callbacks must not assume one frame (or one decode step) per
        call; exceptions are swallowed (a streaming callback can never
        kill the reader).

        `request_id` is an optional caller trace id: it rides the wire
        frame header into the replica's serving stats and is named in
        every shed/expiry/failure message for this request."""
        if self._closed:
            raise RuntimeError('FleetRouter is closed')
        header, arrays = self._encode_request(inputs, max_new_tokens,
                                              beam, on_token)
        req = _FleetRequest(next(self._req_ids), header, arrays,
                            deadline_ms, on_token, request_id=request_id)
        with self.stats._lock:
            self.stats.submitted += 1
        self._route(req)
        return req.future

    def run(self, inputs, timeout=None, **kw):
        """Synchronous convenience: submit + wait."""
        return self.submit(inputs, **kw).result(timeout)

    def _encode_request(self, inputs, max_new_tokens, beam, on_token):
        if self.kind == 'decoding':
            prompt = np.asarray(inputs, np.int64).reshape(-1)
            header = {'op': 'decode',
                      'stream': beam is None}
            if max_new_tokens is not None:
                header['max_new'] = int(max_new_tokens)
            if beam is not None:
                header['beam'] = int(beam)
            return header, {'prompt': prompt}
        if max_new_tokens is not None or beam is not None \
                or on_token is not None:
            raise ValueError('max_new_tokens/beam/on_token apply to '
                             'decoding fleets only')
        if isinstance(inputs, (list, tuple)):
            if self._feed_names is None \
                    or len(inputs) != len(self._feed_names):
                raise ValueError(
                    'fleet expects %s inputs, got %d'
                    % (self._feed_names, len(inputs)))
            inputs = dict(zip(self._feed_names, inputs))
        arrays = {}
        for name, value in inputs.items():
            if isinstance(value, tuple) and len(value) == 2:
                data, offs = value  # LoD pair -> npz convention
                if isinstance(offs, np.ndarray) and offs.ndim == 1:
                    offs = [offs]
                arrays[name] = np.asarray(data)
                for i, o in enumerate(offs):
                    arrays['%s.lod%d' % (name, i)] = np.asarray(
                        o, np.int32)
            else:
                arrays[name] = np.asarray(value)
        for name, arr in arrays.items():
            if arr.dtype.kind == 'O':
                # npz needs pickle for object arrays and the worker
                # loads with allow_pickle=False: fail THIS request at
                # submit instead of poisoning a replica's frame stream
                raise ValueError(
                    'feed %r is an object array (dtype=object) — the '
                    'fleet protocol carries numeric/bytes arrays only'
                    % name)
        return {'op': 'infer'}, arrays

    def _route(self, req):
        """Pick the serving replica with the least outstanding work;
        send now if it has frame capacity, else queue router-side
        (re-routable on replica death/drain)."""
        send_to = None
        with self._lock:
            if req.attempts >= self._max_attempts:
                self._fail_req(req, RuntimeError(
                    'request re-routed %d times without finding a '
                    'stable replica%s' % (req.attempts,
                                          _rid_suffix(req))))
                return
            candidates = [r for r in self._replicas.values()
                          if r.state == 'serving']
            if not candidates:
                self._fail_req(req, FleetUnavailable(
                    'no serving replicas (fleet %s)%s'
                    % ('closed' if self._closed else 'degraded',
                       _rid_suffix(req))))
                return
            if self._max_queue is not None and not req.attempts:
                depth = sum(len(r.pending) for r in candidates)
                if depth >= self._max_queue:
                    with self.stats._lock:
                        self.stats.shed += 1
                    self._fail_req(req, ServerOverloaded(
                        'fleet queue depth %d >= max_queue %d — '
                        'request shed%s' % (depth, self._max_queue,
                                            _rid_suffix(req))),
                        count_failed=False)
                    return
            rep = min(candidates, key=lambda r: (r.load, r.rid))
            req.attempts += 1
            req.replica = rep.rid
            if len(rep.outstanding) < self._inflight:
                rep.outstanding[req.id] = req
                send_to = rep
            else:
                rep.pending.append(req)
        if send_to is not None:
            self._send(send_to, req)

    def _send(self, rep, req):
        """Write the request frame (OUTSIDE the router lock: a wedged
        worker's full socket must never block the watchdog)."""
        remaining = None
        if req.deadline is not None:
            remaining = (req.deadline - time.perf_counter()) * 1e3
            if remaining <= 0:
                with self._lock:
                    rep.outstanding.pop(req.id, None)
                with self.stats._lock:
                    self.stats.expired += 1
                self._fail_req(req, DeadlineExceeded(
                    'request expired in the router queue%s'
                    % _rid_suffix(req)),
                    count_failed=False)
                # NO _pump here: _pump calls _send, and a burst of
                # simultaneously-expired queued requests would recurse
                # _pump->_send->_pump into a RecursionError inside the
                # reader thread. _pump's own while-loop (and the
                # watchdog tick) refills the freed slot iteratively.
                return
        hdr = dict(req.header)
        hdr['id'] = req.id
        if remaining is not None:
            hdr['deadline_ms'] = remaining
        if req.request_id is not None:
            hdr['request_id'] = req.request_id
        try:
            # no send timeout: a wedged worker's full socket buffer can
            # block sendall only until the watchdog SIGKILLs it
            # (hb_timeout_s) — the close unblocks the send with an error
            with rep.send_lock:
                _send_frame(rep.sock, hdr, req.arrays)
        except Exception as e:
            # the worker never received the frame: re-route this request
            # and declare the replica failed. Re-route ONLY if we still
            # own the entry — the watchdog may have declared the replica
            # dead concurrently and already failed this future with
            # ReplicaFailed (re-routing then would re-execute a request
            # the caller already saw fail)
            with self._lock:
                owned = rep.outstanding.pop(req.id, None) is not None
            self._on_replica_failure(rep, 'send failed: %s' % (e,))
            if owned and not req.future.done():
                with self.stats._lock:
                    self.stats.rerouted += 1
                self._route(req)

    def _pump(self, rep):
        """Move router-side queued requests into the replica as frame
        capacity frees up."""
        while True:
            with self._lock:
                if rep.state not in ('serving', 'canary') \
                        or not rep.pending \
                        or len(rep.outstanding) >= self._inflight:
                    return
                req = rep.pending.popleft()
                rep.outstanding[req.id] = req
            self._send(rep, req)

    def _fail_req(self, req, exc, count_failed=True):
        if count_failed:
            with self.stats._lock:
                self.stats.failed += 1
        if req.request_id is not None:
            # tagged requests leave a correlatable trace in the fleet
            # event log (surfaces in fleet_snapshot()['events'])
            self.stats.record_event(
                'request_failed', req.replica,
                '%s: %s' % (req.request_id, type(exc).__name__))
        _resolve(req.future, exc=exc)

    # -- replica -> router frames ------------------------------------------
    def _reader_loop(self, rep):
        sock = rep.sock
        while True:
            try:
                fr = _recv_frame(sock)
            except Exception as e:
                # EOF surfaces as None below; anything else (bad frame
                # length, unparseable header/body) means the stream is
                # desynced — the connection is unusable either way, and
                # the reader dying SILENTLY would strand every
                # outstanding future on a replica still marked serving
                if not isinstance(e, (OSError, IOError)):
                    warnings.warn(
                        'fleet: protocol error from replica %d (%s: '
                        '%s)' % (rep.rid, type(e).__name__, e),
                        RuntimeWarning)
                fr = None
            if fr is None:
                if rep.state not in ('retiring', 'retired', 'dead'):
                    self._on_replica_failure(rep, 'connection lost')
                return
            hdr, arrays = fr
            op = hdr.get('op')
            if op == 'result':
                self._on_result(rep, hdr, arrays)
            elif op == 'tok':
                self._on_tok(rep, hdr)
            elif op == 'toks':
                # coalesced multi-token frame: one frame per
                # speculative verify tick, on_token fired per token
                self._on_toks(rep, hdr)
            elif op == 'drained':
                rep.drained_evt.set()
            # 'bye' and unknown ops: nothing to do

    def _on_tok(self, rep, hdr):
        req = rep.outstanding.get(hdr.get('id'))
        if req is None:
            return
        now = time.perf_counter()
        if req.t_first is None:
            req.t_first = now
        if req.on_token is not None:
            try:
                req.on_token(int(hdr['tok']))
            except Exception:
                pass  # a streaming callback must never kill the reader

    def _on_toks(self, rep, hdr):
        """One coalesced frame per speculative verify tick:
        `on_token` fires per token, in order — the callback contract is
        unchanged, only the framing is batched."""
        req = rep.outstanding.get(hdr.get('id'))
        if req is None:
            return
        now = time.perf_counter()
        if req.t_first is None:
            req.t_first = now
        if req.on_token is not None:
            for t in hdr.get('toks', ()):
                try:
                    req.on_token(int(t))
                except Exception:
                    pass  # a streaming callback must never kill the reader

    def _on_result(self, rep, hdr, arrays):
        with self._lock:
            req = rep.outstanding.pop(hdr.get('id'), None)
        if req is not None:
            if hdr.get('ok'):
                now = time.perf_counter()
                result = self._decode_result(hdr, arrays)
                # TTFT is recorded only when a first token was actually
                # MEASURED (greedy decode streams): for request/response
                # kinds and beam decodes the column would silently
                # duplicate total latency
                ttft = (req.t_first - req.t_submit
                        if req.t_first is not None else None)
                self.stats.record_done(now - req.t_submit, ttft)
                _resolve(req.future, result)
            else:
                self._on_error_result(rep, hdr, req)
        self._pump(rep)

    def _on_error_result(self, rep, hdr, req):
        etype = hdr.get('etype')
        if hdr.get('requeue') and not self._closed \
                and req.attempts < self._max_attempts:
            # shed before any device work (overload / drain): safe to
            # re-route to another replica
            with self.stats._lock:
                self.stats.rerouted += 1
            self._route(req)
            return
        exc = _rebuild_exc(hdr)
        with self.stats._lock:
            if etype == 'DeadlineExceeded':
                self.stats.expired += 1
            elif etype == 'ServerOverloaded':
                self.stats.shed += 1
        self._fail_req(req, exc,
                       count_failed=etype not in ('DeadlineExceeded',
                                                  'ServerOverloaded'))

    @staticmethod
    def _decode_result(hdr, arrays):
        kind = hdr.get('kind')
        if kind == 'greedy':
            return [int(t) for t in arrays['tokens']]
        if kind == 'beam':
            return (arrays['ids'], arrays['scores'])
        outs = []
        for j in range(int(hdr.get('n', 0))):
            levels = (hdr.get('lod') or [])
            lv = int(levels[j]) if j < len(levels) else 0
            data = arrays['o%d' % j]
            if lv:
                outs.append((data, [arrays['o%d.lod%d' % (j, i)]
                                    for i in range(lv)]))
            else:
                outs.append(data)
        return outs

    # -- failure handling --------------------------------------------------
    def _on_replica_failure(self, rep, reason):
        """Declare one replica dead: SIGKILL what's left of it, fail its
        in-flight requests LOUDLY, re-route its router-side queue."""
        with self._lock:
            if rep.state in ('dead', 'retired'):
                return
            rep.state = 'dead'
            outstanding = list(rep.outstanding.values())
            rep.outstanding.clear()
            pending = list(rep.pending)
            rep.pending.clear()
        # a replica that died while STARTING must release _await_ready
        # immediately (state is already 'dead', so the waiter raises)
        # instead of letting it sit out the full spin-up timeout
        rep.ready_evt.set()
        with self.stats._lock:
            self.stats.replica_deaths += 1
        self.stats.record_event('replica_dead', rep.rid, reason)
        self._kill(rep)
        warnings.warn(
            'fleet replica %d FAILED (%s): %d in-flight request(s) '
            'failed loudly, %d queued re-routed'
            % (rep.rid, reason, len(outstanding), len(pending)),
            RuntimeWarning)
        for req in outstanding:
            self._fail_req(req, ReplicaFailed(
                'fleet replica %d died (%s) with this request in '
                'flight%s' % (rep.rid, reason, _rid_suffix(req))))
        if pending:
            # re-route in a THROWAWAY thread: this path runs on the
            # watchdog (and reader) threads, and _route -> _send can
            # block on a second wedged replica's full socket — the
            # watchdog must stay free to deliver the SIGKILL that
            # unblocks exactly that send
            def _reroute():
                for req in pending:
                    with self.stats._lock:
                        self.stats.rerouted += 1
                    self._route(req)
            threading.Thread(target=_reroute, daemon=True).start()
        self._write_status()

    def _kill(self, rep):
        try:
            if rep.proc is not None and rep.proc.poll() is None:
                rep.proc.kill()
                rep.proc.wait(timeout=10)
        except Exception:
            pass
        try:
            if rep.sock is not None:
                rep.sock.close()
        except OSError:
            pass

    # -- watchdog ----------------------------------------------------------
    def _watchdog_loop(self):
        last_status = 0.0
        while not self._stop_evt.wait(self._poll_s):
            now = time.perf_counter()
            with self._lock:
                reps = list(self._replicas.values())
            for rep in reps:
                if rep.state in ('retired', 'dead'):
                    continue
                hb, age = read_heartbeat(self._hb_path(rep.rid))
                rep.hb, rep.hb_age = hb, age
                if rep.proc is not None and rep.proc.poll() is not None \
                        and rep.state != 'retiring':
                    self._on_replica_failure(
                        rep, 'process exited rc=%s'
                        % rep.proc.returncode)
                    continue
                if rep.state in ('serving', 'canary', 'draining') \
                        and age > self.hb_timeout_s:
                    self._on_replica_failure(
                        rep, 'heartbeat stale %.1fs > %.1fs — '
                        'replica hung, SIGKILL' % (age,
                                                   self.hb_timeout_s))
                    continue
                self._reap_pending(rep)
                # backstop pump: a slot freed by an expired send (which
                # deliberately does not pump) refills within one poll.
                # In a THROWAWAY thread: _send can block on a wedged
                # replica's full socket, and the watchdog must stay
                # free to deliver the SIGKILL that unblocks it
                if rep.pending \
                        and len(rep.outstanding) < self._inflight:
                    threading.Thread(target=self._pump, args=(rep,),
                                     daemon=True).start()
            self._process_ctl()
            if time.time() - last_status > 1.0:
                self._write_status()
                last_status = time.time()

    def _reap_pending(self, rep):
        """Expire router-side queued requests whose deadline elapsed."""
        now = time.perf_counter()
        expired = []
        with self._lock:
            alive = deque()
            for req in rep.pending:
                if req.deadline is not None and now > req.deadline:
                    expired.append(req)
                else:
                    alive.append(req)
            rep.pending = alive
        for req in expired:
            with self.stats._lock:
                self.stats.expired += 1
            self._fail_req(req, DeadlineExceeded(
                'request expired in the router queue%s'
                % _rid_suffix(req)),
                count_failed=False)

    def _process_ctl(self):
        """tools/fleet_ctl.py drops {'cmd': 'drain', 'replica': rid}
        JSON files into fleet_dir/ctl/; execute and remove them."""
        ctl = os.path.join(self.fleet_dir, 'ctl')
        try:
            names = sorted(os.listdir(ctl))
        except OSError:
            return
        for name in names:
            if not name.endswith('.json'):
                continue  # fleet_ctl writes '*.tmp' then os.replace's:
                #           touching the tmp would race the rename
            path = os.path.join(ctl, name)
            # one malformed or racing command file must never kill the
            # watchdog thread — it is the fleet's failure detector
            try:
                with open(path) as f:
                    cmd = json.load(f)
                os.unlink(path)
                if cmd.get('cmd') == 'drain':
                    rid = int(cmd.get('replica', -1))
                    threading.Thread(target=self._ctl_drain,
                                     args=(rid,), daemon=True).start()
            except Exception as e:
                try:
                    os.unlink(path)
                except OSError:
                    pass
                warnings.warn('fleet: bad control file %s ignored '
                              '(%s: %s)' % (name, type(e).__name__, e),
                              RuntimeWarning)

    def _ctl_drain(self, rid):
        try:
            self.drain_replica(rid)
        except Exception as e:
            warnings.warn('fleet_ctl drain of replica %d failed: %s'
                          % (rid, e), RuntimeWarning)

    # -- scaling -----------------------------------------------------------
    def serving_replicas(self):
        with self._lock:
            return [r.rid for r in self._replicas.values()
                    if r.state == 'serving']

    def scale_out(self, tier=_UNSET, artifact=None, wait=True,
                  canary=False, reason='scale_out'):
        """Spawn one more replica (warm: it runs its programs once
        before its hello). Returns its rid."""
        spec = dict(self._spec)
        if tier is not _UNSET:
            spec['tier'] = tier
        if artifact is not None:
            spec['artifact'] = artifact
        rid = self._spawn(spec, wait=wait, canary=canary)
        if not canary:
            with self.stats._lock:
                self.stats.scale_out += 1
            self.stats.record_event('scale_out', rid, reason)
        self._write_status()
        return rid

    def scale_in(self, rid=None, reason='scale_in', timeout=120.0):
        """Drain + retire one replica (least-loaded by default). The
        drain finishes in-flight work and hands queued requests back
        for re-routing — zero dropped streams."""
        with self._lock:
            serving = [r for r in self._replicas.values()
                       if r.state == 'serving']
            if rid is None:
                if len(serving) <= 1:
                    raise RuntimeError(
                        'refusing to scale in the last serving replica')
                rid = min(serving, key=lambda r: (r.load, -r.rid)).rid
        ok = self.drain_replica(rid, timeout=timeout)
        with self.stats._lock:
            self.stats.scale_in += 1
        self.stats.record_event('scale_in', rid, reason)
        return ok

    def drain_replica(self, rid, timeout=120.0):
        """Draining stop for one replica: stop routing to it, hand its
        router-side queue back, let it finish in-flight work
        (predictor drain() hooks), then retire it. Returns True when
        the drain completed inside `timeout` (the replica is retired
        either way — by force if it would not drain)."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                raise ValueError('no replica %d' % rid)
            if rep.state not in ('serving', 'canary'):
                raise RuntimeError('replica %d is %r, not drainable'
                                   % (rid, rep.state))
            rep.state = 'draining'
            pending = list(rep.pending)
            rep.pending.clear()
        for req in pending:
            with self.stats._lock:
                self.stats.rerouted += 1
            self._route(req)
        ok = False
        try:
            with rep.send_lock:
                _send_frame(rep.sock, {'op': 'drain'})
            ok = rep.drained_evt.wait(timeout)
            # results may still be in the socket behind the drained
            # frame's send; give them a moment to resolve
            deadline = time.monotonic() + 5.0
            while rep.outstanding and time.monotonic() < deadline:
                time.sleep(0.01)
        except Exception as e:
            warnings.warn('fleet: drain of replica %d errored (%s) — '
                          'retiring by force' % (rid, e),
                          RuntimeWarning)
        if not ok:
            warnings.warn(
                'fleet replica %d did not finish draining in %.0fs — '
                'retiring by force; its in-flight requests fail loudly'
                % (rid, timeout), RuntimeWarning)
        self._retire(rep)
        return ok

    def _retire(self, rep):
        with self._lock:
            rep.state = 'retiring'
            # pending can be non-empty again here: submit_to() accepts a
            # DRAINING replica (rollout probes) and queues when the
            # frame window is full — those must fail loudly too, never
            # strand an unresolved future
            leftovers = (list(rep.outstanding.values())
                         + list(rep.pending))
            rep.outstanding.clear()
            rep.pending.clear()
        try:
            with rep.send_lock:
                _send_frame(rep.sock, {'op': 'stop'})
            rep.proc.wait(timeout=15)
        except Exception:
            self._kill(rep)
        with self._lock:
            rep.state = 'retired'
        if leftovers:
            for req in leftovers:
                self._fail_req(req, ReplicaFailed(
                    'fleet replica %d retired with this request still '
                    'in flight (drain timeout)%s'
                    % (rep.rid, _rid_suffix(req))))
        try:
            if rep.sock is not None:
                rep.sock.close()
        except OSError:
            pass
        self._write_status()

    # -- rollout / probe plumbing ------------------------------------------
    def submit_to(self, rid, inputs, deadline_ms=None,
                  max_new_tokens=None, beam=None, request_id=None):
        """Route one request to a SPECIFIC replica (rollout probes;
        bypasses least-work selection, still honors frame capacity)."""
        header, arrays = self._encode_request(inputs, max_new_tokens,
                                              beam, None)
        req = _FleetRequest(next(self._req_ids), header, arrays,
                            deadline_ms, request_id=request_id)
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.state not in ('serving', 'canary',
                                                'draining'):
                raise RuntimeError('replica %r not available' % rid)
            req.attempts = self._max_attempts  # never re-route a probe
            req.replica = rid
            if len(rep.outstanding) < self._inflight:
                rep.outstanding[req.id] = req
                send = True
            else:
                rep.pending.append(req)
                send = False
        if send:
            self._send(rep, req)
        return req.future

    def set_default_spec(self, tier=_UNSET, artifact=None):
        """Re-point the fleet's default artifact spec (rollout promote):
        future spawns — autoscaler included — use it."""
        with self._lock:
            if tier is not _UNSET:
                self._spec['tier'] = tier
            if artifact is not None:
                self._spec['artifact'] = artifact

    def promote_canary(self, rid):
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.state != 'canary':
                raise RuntimeError('replica %r is not a canary' % rid)
            rep.state = 'serving'
            rep.spec['canary'] = False
        self._write_status()

    # -- status / reporting ------------------------------------------------
    def status(self):
        with self._lock:
            reps = {r.rid: r.snapshot()
                    for r in self._replicas.values()}
            spec = dict(self._spec)
        snap = self.stats.snapshot()
        return {'time': time.time(), 'pid': os.getpid(),
                'artifact': spec['artifact'],
                'tier': spec.get('tier') or 'bf16',
                'kind': self.kind,
                'closed': self._closed,
                'serving': sum(1 for s in reps.values()
                               if s['state'] == 'serving'),
                'replicas': reps, 'counters': snap}

    def fleet_snapshot(self):
        """The reference's profiler fleet-source contract: status()'s
        counters at the top level, with the fleet's kind, artifact, tier,
        serving count, replicas and backlog."""
        st = self.status()
        snap = st['counters']
        snap.update(kind='fleet', artifact=st['artifact'],
                    tier=st['tier'], serving=st['serving'],
                    replicas=st['replicas'],
                    # backlog, not in-flight: a dispatched frame shows
                    # up in the worker's queue_depth already — adding
                    # outstanding would read ~2x the true queue
                    queue_depth=sum(s['pending'] + s['queue_depth']
                                    for s in st['replicas'].values()))
        return snap

    def _write_status(self):
        try:
            path = os.path.join(self.fleet_dir, 'status.json')
            tmp = '%s.%d.tmp' % (path, os.getpid())
            with open(tmp, 'w') as f:
                json.dump(self.status(), f, indent=1, default=str)
            os.replace(tmp, path)
        except OSError:
            pass

    # -- shutdown ----------------------------------------------------------
    def close(self):
        """Stop every replica and router thread. Outstanding requests
        fail with RuntimeError. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            reps = list(self._replicas.values())
        self._stop_evt.set()
        for rep in reps:
            with self._lock:
                outstanding = list(rep.outstanding.values())
                rep.outstanding.clear()
                pending = list(rep.pending)
                rep.pending.clear()
                if rep.state in ('serving', 'canary', 'draining'):
                    rep.state = 'retiring'
            exc = RuntimeError('FleetRouter closed')
            for req in outstanding + pending:
                self._fail_req(req, exc, count_failed=False)
            # bounded stop-send: the watchdog (which normally SIGKILLs
            # a wedged worker out of a blocked sendall) is already
            # stopping, so close() must not wait on a full socket or a
            # send_lock held by a blocked _send — the proc.wait/kill
            # loop below reaps workers that never saw the stop frame
            try:
                if rep.sock is not None \
                        and rep.send_lock.acquire(timeout=2.0):
                    try:
                        rep.sock.settimeout(2.0)
                        _send_frame(rep.sock, {'op': 'stop'})
                    finally:
                        rep.send_lock.release()
            except Exception:
                pass
        for rep in reps:
            try:
                if rep.proc is not None:
                    rep.proc.wait(timeout=10)
            except Exception:
                self._kill(rep)
            with self._lock:
                if rep.state != 'dead':
                    rep.state = 'retired'
        try:
            self._listener.close()
        except OSError:
            pass
        try:
            if self._watchdog_t is not None:
                self._watchdog_t.join(timeout=5)
        except Exception:
            pass
        try:
            os.unlink(self._sock_path)
        except OSError:
            pass
        if self._sock_tmpdir is not None:
            try:
                os.rmdir(self._sock_tmpdir)
            except OSError:
                pass
        self._write_status()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class Autoscaler(object):
    """Scale the fleet out/in on the occupancy / queue-depth / shed-rate
    counters the serving stats already measure.

    step() evaluates once (deterministic — tests drive it directly);
    start() runs it on a background interval. Scale-out spawns a warm
    replica when queue depth per replica or the shed rate since the
    last step crosses its threshold, or occupancy exceeds
    `high_occupancy` WITH a non-empty backlog (the occupancy gauges
    are lifetime-cumulative and freeze while idle — gating on backlog
    stops an idle post-surge fleet from ping-ponging), or serving
    replicas fell below `min_replicas` (failover replacement);
    scale-in DRAINS the least-loaded replica once the fleet has been
    IDLE — zero queued or outstanding work, zero sheds — for
    `idle_steps` consecutive evaluations (occupancy counters are
    cumulative, so sustained idleness is the reliable low-load
    signal). A cooldown separates consecutive scale events.
    """

    def __init__(self, router, min_replicas=1, max_replicas=8,
                 high_queue_per_replica=4.0, high_occupancy=0.85,
                 idle_steps=3, cooldown_s=5.0, interval_s=1.0):
        self.router = router
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.high_queue = float(high_queue_per_replica)
        self.high_occ = float(high_occupancy)
        self.idle_steps = max(1, int(idle_steps))
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self._last_scale = 0.0
        self._last_shed = None
        self._idle_streak = 0
        self._stop_evt = threading.Event()
        self._thread = None

    # -- one evaluation ----------------------------------------------------
    def metrics(self):
        st = self.router.status()
        reps = st['replicas'].values()
        serving = [s for s in reps if s['state'] == 'serving']
        n = len(serving)
        # backlog = router-side queues + worker-side predictor queues.
        # `outstanding` is deliberately EXCLUDED: a frame sent to the
        # worker shows up in its predictor's queue_depth already, and
        # counting it twice reads ~2x the true backlog (spurious
        # scale-outs at moderate load)
        queue = sum(s['pending'] + s['queue_depth'] for s in serving)
        # the IDLE signal still counts in-flight frames: a fleet whose
        # slots are all decoding has queue 0 but is not idle
        work = queue + sum(s['outstanding'] for s in serving)
        occ = (sum(s['occupancy'] for s in serving) / n) if n else 0.0
        # shed totals sum over EVERY replica (retired/dead included):
        # cumulative counters vanishing from the sum when a replica
        # retires would read as a negative shed delta
        shed = (st['counters']['shed']
                + sum(s['shed'] for s in reps))
        return {'serving': n, 'queue': queue, 'work': work,
                'queue_per_replica': queue / n if n else float('inf'),
                'occupancy': occ, 'shed_total': shed}

    def step(self):
        """Evaluate once; returns 'out', 'in', or None. Never raises on
        a scaling failure — the event is recorded and the next step
        retries."""
        m = self.metrics()
        shed_delta = (0 if self._last_shed is None
                      else max(0, m['shed_total'] - self._last_shed))
        self._last_shed = m['shed_total']
        if m['work'] == 0 and shed_delta == 0:
            self._idle_streak += 1
        else:
            self._idle_streak = 0
        now = time.monotonic()
        try:
            if m['serving'] < self.min_replicas:
                self.router.scale_out(reason='below min_replicas')
                self._last_scale = now
                self._idle_streak = 0
                return 'out'
            if now - self._last_scale < self.cooldown_s:
                return None
            # occupancy is a lifetime-cumulative gauge that freezes at
            # its last value while a replica idles (and, for batching,
            # measures batch PACKING): alone it would ping-pong an idle
            # post-surge fleet forever — it only counts alongside a
            # real backlog
            if m['serving'] < self.max_replicas and (
                    m['queue_per_replica'] > self.high_queue
                    or (m['occupancy'] > self.high_occ
                        and m['queue'] > 0)
                    or shed_delta > 0):
                self.router.scale_out(
                    reason='queue/replica %.1f occ %.2f shed +%d'
                    % (m['queue_per_replica'], m['occupancy'],
                       shed_delta))
                self._last_scale = now
                self._idle_streak = 0
                return 'out'
            if m['serving'] > self.min_replicas \
                    and self._idle_streak >= self.idle_steps:
                self.router.scale_in(
                    reason='idle for %d evaluations'
                    % self._idle_streak)
                self._last_scale = now
                self._idle_streak = 0
                return 'in'
        except Exception as e:
            self.router.stats.record_event('scale_error', None, str(e))
        return None

    # -- background mode ---------------------------------------------------
    def start(self):
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name='ptpu-fleet-autoscaler',
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _loop(self):
        while not self._stop_evt.wait(self.interval_s):
            if self.router._closed:
                return
            self.step()


def bit_agreement(a, b):
    """Exact agreement between two probe results (same-tier rollouts)."""
    an, bn = _flatten_result(a), _flatten_result(b)
    return 1.0 if len(an) == len(bn) and all(
        np.array_equal(x, y) for x, y in zip(an, bn)) else 0.0


def top1_agreement(a, b):
    """Quantized-tier parity measure: per-row argmax
    agreement on the FIRST fetch for classification probes; decode
    transcripts (1-D integer token sequences — logits never leave the
    replica) compare EXACTLY per probe, so the rollout's mean over
    probes is the transcript-agreement fraction."""
    x, y = _flatten_result(a)[0], _flatten_result(b)[0]
    x, y = np.asarray(x), np.asarray(y)
    if x.ndim < 2 or x.dtype.kind in 'iu':
        return 1.0 if x.shape == y.shape and np.array_equal(x, y) \
            else 0.0
    if x.shape != y.shape:
        return 0.0
    return float(np.mean(np.argmax(x, -1) == np.argmax(y, -1)))


def _flatten_result(res):
    if isinstance(res, tuple):        # beam (ids, scores)
        return [np.asarray(r) for r in res]
    if isinstance(res, list) and res and np.isscalar(res[0]):
        return [np.asarray(res)]      # greedy transcript
    flat = []
    for o in (res if isinstance(res, list) else [res]):
        if isinstance(o, tuple):
            flat.append(np.asarray(o[0]))
            flat.extend(np.asarray(x) for x in o[1])
        else:
            flat.append(np.asarray(o))
    return flat


_AGREEMENT = {'bit': bit_agreement, 'top1': top1_agreement}


class RollingRollout(object):
    """Canary -> check -> promote (or roll back loudly) a new artifact
    tier across the fleet.

    run() spawns ONE canary replica on the new tier/artifact, replays
    `probes` (per-request feed dicts, or prompts for decoding fleets)
    against it and an incumbent, and promotes only when ALL of:

      * canary determinism: two sweeps of the probe set on the canary
        are BIT-identical (an unstable artifact never ships);
      * incumbent agreement >= `min_agreement` under `agreement`
        ('bit' exact for same-tier artifacts — the default, 'top1'
        argmax for quantized tiers, or any callable(a, b) -> [0, 1]);
      * latency budget: canary probe p50 <= `latency_budget` x the
        incumbent's p50.

    Promotion is ROLLING: the canary joins the fleet, the default spec
    re-points (the autoscaler spawns the new tier from now on), then
    each incumbent is replaced spawn-before-drain — capacity never
    dips and no in-flight stream drops. Any failed check retires the
    canary, leaves the incumbents untouched, and raises
    `RolloutRolledBack` (set raise_on_rollback=False to inspect the
    returned report instead)."""

    def __init__(self, router, tier=_UNSET, artifact=None, probes=(),
                 agreement='bit', min_agreement=1.0,
                 latency_budget=3.0, probe_kwargs=None,
                 raise_on_rollback=True):
        if tier is _UNSET and artifact is None:
            raise ValueError('rollout needs a new tier= or artifact=')
        if not probes:
            raise ValueError('rollout needs probe requests to measure '
                             'parity and latency on')
        self.router = router
        self.tier = tier
        self.artifact = artifact
        self.probes = list(probes)
        self.agree_name = (agreement if isinstance(agreement, str)
                           else getattr(agreement, '__name__',
                                        'custom'))
        self.agreement = (_AGREEMENT[agreement]
                          if isinstance(agreement, str) else agreement)
        self.min_agreement = float(min_agreement)
        self.latency_budget = float(latency_budget)
        self.probe_kwargs = dict(probe_kwargs or {})
        self.raise_on_rollback = bool(raise_on_rollback)

    def _sweep(self, rid):
        results, lat = [], []
        for probe in self.probes:
            t0 = time.perf_counter()
            results.append(self.router.submit_to(
                rid, probe, **self.probe_kwargs).result(300))
            lat.append(time.perf_counter() - t0)
        return results, lat

    def _set_state(self, **kw):
        st = self.router.stats
        with st._lock:
            st.rollout.update(kw)
        self.router.stats.record_event('rollout', kw.get('canary'),
                                       kw.get('state'))
        self.router._write_status()

    def run(self):
        """Execute the rollout; returns the check report dict."""
        router = self.router
        new_desc = ('tier=%s' % self.tier if self.tier is not _UNSET
                    else 'artifact=%s' % self.artifact)
        self._set_state(state='canary', target=new_desc, canary=None)
        incumbents = router.serving_replicas()
        if not incumbents:
            raise RolloutRolledBack('no serving incumbent to roll from')
        inc = incumbents[0]
        canary = router.scale_out(tier=self.tier, artifact=self.artifact,
                                  canary=True, reason='rollout canary')
        self._set_state(state='checking', canary=canary)
        report = {'canary': canary, 'incumbent': inc,
                  'target': new_desc, 'probes': len(self.probes),
                  'agreement_mode': self.agree_name}
        try:
            inc_res, inc_lat = self._sweep(inc)
            can_res, can_lat = self._sweep(canary)
            can_res2, _ = self._sweep(canary)
            det = bit_agreement(_flat2(can_res), _flat2(can_res2))
            agree = float(np.mean([self.agreement(c, i) for c, i
                                   in zip(can_res, inc_res)]))
            p50c = float(np.percentile(can_lat, 50)) * 1e3
            p50i = float(np.percentile(inc_lat, 50)) * 1e3
            report.update(
                deterministic=det == 1.0, agreement=round(agree, 6),
                canary_p50_ms=round(p50c, 3),
                incumbent_p50_ms=round(p50i, 3),
                latency_ratio=round(p50c / p50i, 3) if p50i else None)
            failures = []
            if det != 1.0:
                failures.append('canary output not deterministic '
                                'across probe sweeps')
            if agree < self.min_agreement:
                failures.append(
                    'agreement %.4f < %.4f (%s parity)'
                    % (agree, self.min_agreement, self.agree_name))
            if p50i and p50c > self.latency_budget * p50i:
                failures.append(
                    'canary p50 %.1fms > %.1fx incumbent %.1fms'
                    % (p50c, self.latency_budget, p50i))
        except Exception as e:
            failures = ['probe sweep failed: %s: %s'
                        % (type(e).__name__, e)]
        if failures:
            return self._rollback(canary, report, failures)
        return self._promote(canary, report)

    def _rollback(self, canary, report, failures):
        report.update(promoted=False, failures=failures)
        self._set_state(state='rolled_back', canary=canary,
                        failures=failures)
        try:
            self.router.drain_replica(canary, timeout=60)
        except Exception:
            pass
        msg = ('ROLLOUT ROLLED BACK (%s): %s — canary replica %d '
               'retired, incumbent fleet untouched'
               % (report['target'], '; '.join(failures), canary))
        warnings.warn(msg, RuntimeWarning)
        if self.raise_on_rollback:
            raise RolloutRolledBack(msg)
        return report

    def _promote(self, canary, report):
        router = self.router
        self._set_state(state='promoting', canary=canary)
        router.set_default_spec(tier=self.tier, artifact=self.artifact)
        router.promote_canary(canary)
        replaced = []
        replace_failures = []
        first = True
        for rid in router.serving_replicas():
            if rid == canary or rid in replaced:
                continue
            rep = router._replicas[rid]
            if rep.spec.get('tier') == router._spec.get('tier') \
                    and rep.spec.get('artifact') \
                    == router._spec.get('artifact'):
                continue
            # an incumbent dying mid-roll (or a spawn failing) must not
            # abort a promotion that already happened: the default spec
            # is re-pointed, so the autoscaler heals capacity on the
            # new tier — record, warn, keep rolling
            try:
                if first:
                    # the canary itself replaces the first incumbent:
                    # the fleet ends the roll at its original count
                    first = False
                else:
                    new = router.scale_out(
                        reason='rollout replace %d' % rid)
                    replaced.append(new)
                router.drain_replica(rid)
            except Exception as e:
                replace_failures.append(
                    {'replica': rid, 'error': '%s: %s'
                     % (type(e).__name__, e)})
                warnings.warn(
                    'rollout: replacing incumbent %d failed (%s: %s) '
                    '— promotion stands; the autoscaler heals '
                    'capacity on the new spec' % (rid,
                                                  type(e).__name__, e),
                    RuntimeWarning)
        report.update(promoted=True, replaced=replaced,
                      replace_failures=replace_failures)
        self._set_state(state='promoted', canary=canary)
        return report


def _flat2(results):
    """Concatenate a probe sweep's per-result flat arrays (for the
    canary determinism bit-check)."""
    return [a for r in results for a in _flatten_result(r)]


def load_fleet(artifact_dir, **kwargs):
    return FleetRouter(artifact_dir, **kwargs)
