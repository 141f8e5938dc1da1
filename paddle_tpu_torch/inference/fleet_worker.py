"""One fleet replica subprocess (ref: paddle_tpu/inference/fleet_worker.py).

Spawned by `fleet.FleetRouter`, with the directory that holds the
paddle_tpu_torch package on PYTHONPATH:

    python -m paddle_tpu_torch.inference.fleet_worker SOCKET_PATH \\
        REPLICA_ID ARTIFACT_DIR HEARTBEAT_PATH OPTS_JSON

Loads the artifact through the port's serving stack onto its place
(`platform` through serve._place: CUDAPlace(0) unless it is 'cpu'; a
replica that finds no card raises before its hello, so its spin-up fails
loudly and never falls back to the CPU), runs every program once (warmup),
serves requests over fleet.py's length-prefixed frame protocol, and writes
a heartbeat file (atomic replace; mtime = liveness, payload = serving
stats, the kernel wrappers' launch counts and, on the card, the replica's
device memory) on an interval, which the
router's watchdog reads. A SIGSTOP'd (hung) worker stops heartbeating and
is detected in bounded time; a SIGKILL'd one drops the socket, and its
CUDA context goes with the process.

The hello frame reports what the replica loaded: the artifact tier the
endpoint ACTUALLY serves and, for decode artifacts, the cache layout
('slot' or 'block'; `mesh` is None: the port has no sharded decode).
`compiles` counts the nvcc builds the replica ran while it spun up
(kernels.nvcc_runs): the port compiles nothing else, so a replica whose
kernels were built before it started reports 0. `framework_free` says
that neither jax nor paddle_tpu is among its modules: the port's own
invariant, where the reference's worker means it loaded no framework.
The heartbeat's `launches` count from the end of the warmup.

OPTS keys: kind ('batching'|'decoding'|'compiled'), tier, platform,
warmup, numerics (the router's torch switches, fleet.apply_numerics),
hb_interval_s, max_queue, batch_timeout_ms, max_batch_size, inflight,
default_max_new, draft, draft_k.

Frames handled: infer / decode (per-request), drain (predictor drain()
hook: stop admitting, finish in-flight, shed the queue re-routably),
stop. Replies: result (ok or etype/error/requeue), tok / toks (greedy
decode streaming, one frame a delivery batch), drained, bye.
"""
import json
import os
import socket
import sys
import threading
import time

import numpy as np

from . import batching as _batching
from . import decoding as _decoding
from . import fleet as _fleet
from . import serve as _serve
from .. import kernels as _kernels
from ..ops import bn_apply as _bn
from ..ops import flash_attention as _fa
from ..ops import quant_ops as _quant

# the hand-written kernels' wrappers, whose launches a replica reports
_WRAPPERS = {'bn_apply': _bn.bn_apply,
             'flash_attn_fwd': _fa.flash_attn_fwd,
             'flash_attn_bwd_dkv': _fa.flash_attn_bwd_dkv,
             'flash_attn_bwd_dq': _fa.flash_attn_bwd_dq}


def _launches():
    """Each kernel wrapper's launches by dtype, and the int8 tier's integer
    GEMMs (torch._int_mm, a library call) by op type."""
    out = {name: dict(fn.launches_by_dtype) for name, fn in _WRAPPERS.items()}
    out['int8_gemm'] = dict(_quant.int8_gemm.launches_by_op)
    return out


def _memory(device):
    """The replica's device memory in bytes (allocated now, its peak, and
    what torch's caching allocator holds), None on the CPU."""
    if device.type != 'cuda':
        return None
    import torch
    return {'allocated': torch.cuda.memory_allocated(device),
            'peak_allocated': torch.cuda.max_memory_allocated(device),
            'reserved': torch.cuda.memory_reserved(device)}


def _reset_launches():
    for fn in _WRAPPERS.values():
        fn.launches = 0
        fn.launches_by_dtype = dict.fromkeys(fn.launches_by_dtype, 0)
        if hasattr(fn, 'launches_by_causal'):
            fn.launches_by_causal = dict.fromkeys(fn.launches_by_causal, 0)
    _quant.reset_launches()


class _Conn(object):
    """Socket with a send lock: results/toks/heartbeats come from
    predictor callback threads concurrently."""

    def __init__(self, sock):
        self.sock = sock
        self.lock = threading.Lock()

    def send(self, header, arrays=None):
        with self.lock:
            _fleet._send_frame(self.sock, header, arrays)

    def reply_err(self, req_id, exc, requeue=False):
        self.send({'op': 'result', 'id': req_id, 'ok': False,
                   'etype': type(exc).__name__, 'error': str(exc),
                   'requeue': bool(requeue)})


def _is_requeueable(exc, draining):
    """SUBMIT-SITE only: shed-at-the-door errors never cost device work
    — the router can safely re-route them; a draining/closed refusal
    raised by submit() itself is the same no-work case. Errors from a
    request that already DISPATCHED (delivery callbacks, stream pumps)
    must use _stream_requeueable instead — a mid-execution error may
    have cost device work and the fleet contract forbids blind retries
    of those."""
    return isinstance(exc, _batching.ServerOverloaded) or (
        draining and isinstance(exc, RuntimeError))


def _stream_requeueable(exc):
    """POST-DISPATCH (stream pump / delivery callback) re-route
    decision: only a shed that provably cost no device work may
    re-route. MidStreamEvicted is a ServerOverloaded whose victim
    already streamed tokens — re-routing would replay them to the
    client and blindly retry device work."""
    return (isinstance(exc, _batching.ServerOverloaded)
            and not isinstance(exc, _decoding.MidStreamEvicted))


class _BatchingEndpoint(object):
    kind = 'batching'

    def __init__(self, artifact, opts):
        kw = {}
        for k in ('tier', 'platform', 'max_queue', 'max_batch_size'):
            if opts.get(k) is not None:
                kw[k] = opts[k]
        kw['batch_timeout_ms'] = float(opts.get('batch_timeout_ms', 2.0))
        kw['inflight'] = int(opts.get('inflight', 2))
        self.pred = _batching.BatchingPredictor(artifact, **kw)
        if opts.get('warmup', True):
            self.pred.warmup()
        self.tier = self.pred.tier
        self.draining = False

    def submit(self, hdr, arrays, conn):
        req_id = hdr['id']
        lod_keys = [k for k in arrays if '.lod' in k]
        if lod_keys:
            # the batcher serves dense feeds only (its own load-time
            # contract): dropping offsets silently could return wrong
            # results — fail THIS request loudly instead
            conn.reply_err(req_id, ValueError(
                'batching fleet serves dense feeds only; request '
                'carries lod offsets %r' % lod_keys))
            return
        feed = dict(arrays)

        def _done(fut):
            exc = fut.exception()
            if exc is not None:
                # post-submit resolution: only a genuine shed (never
                # dispatched) is safe to re-route
                conn.reply_err(req_id, exc, _stream_requeueable(exc))
                return
            outs = fut.result()
            conn.send({'op': 'result', 'id': req_id, 'ok': True,
                       'n': len(outs), 'lod': [0] * len(outs)},
                      {'o%d' % j: o for j, o in enumerate(outs)})
        try:
            fut = self.pred.submit(feed,
                                   deadline_ms=hdr.get('deadline_ms'),
                                   request_id=hdr.get('request_id'))
        except Exception as e:
            conn.reply_err(req_id, e,
                           _is_requeueable(e, self.draining))
            return
        fut.add_done_callback(_done)

    def drain(self):
        self.draining = True
        self.pred.drain()

    def snapshot(self):
        return self.pred.stats.snapshot()

    def close(self):
        self.pred.close()


class _DecodingEndpoint(object):
    kind = 'decoding'

    def __init__(self, artifact, opts):
        kw = {'place': _serve._place(opts.get('platform'))}
        # 'draft': 'ngram' attaches the host-side prompt-lookup drafter,
        # the only drafter expressible in a spawn config; 'draft_k'
        # narrows the per-tick draft length
        for k in ('tier', 'max_queue', 'draft', 'draft_k'):
            if opts.get(k) is not None:
                kw[k] = opts[k]
        if opts.get('default_max_new') is not None:
            kw['default_max_new_tokens'] = int(opts['default_max_new'])
        self.pred = _decoding.DecodingPredictor(artifact, **kw)
        if opts.get('warmup', True):
            self.pred.warmup()
        self.tier = self.pred.stats.tier
        # block-paged artifacts load through the same endpoint: the
        # layout is surfaced so the router and fleet_ctl can audit which
        # tier a replica actually serves
        self.layout = self.pred.layout
        self.mesh = None
        self.draining = False

    def submit(self, hdr, arrays, conn):
        req_id = hdr['id']
        try:
            stream = self.pred.submit(
                arrays['prompt'], max_new_tokens=hdr.get('max_new'),
                beam=hdr.get('beam'),
                deadline_ms=hdr.get('deadline_ms'),
                request_id=hdr.get('request_id'))
        except Exception as e:
            conn.reply_err(req_id, e,
                           _is_requeueable(e, self.draining))
            return
        threading.Thread(target=self._pump,
                         args=(req_id, hdr, stream, conn),
                         daemon=True).start()

    def _pump(self, req_id, hdr, stream, conn):
        try:
            if stream.beam is None and hdr.get('stream'):
                # one frame per DELIVERY BATCH: a plain step sends the
                # singleton 'tok' frame, a speculative verify tick
                # coalesces its whole multi-token advance into one 'toks'
                # frame instead of K+1 round-trips
                for batch in stream.batches():
                    if len(batch) == 1:
                        conn.send({'op': 'tok', 'id': req_id,
                                   'tok': int(batch[0])})
                    else:
                        conn.send({'op': 'toks', 'id': req_id,
                                   'toks': [int(t) for t in batch]})
            res = stream.result(600)
        except Exception as e:
            # stream-side failure: the request may have decoded tokens
            # already — only a genuine shed re-routes
            conn.reply_err(req_id, e, _stream_requeueable(e))
            return
        if stream.beam is None:
            conn.send({'op': 'result', 'id': req_id, 'ok': True,
                       'kind': 'greedy'},
                      {'tokens': np.asarray(res, np.int64)})
        else:
            ids, scores = res
            conn.send({'op': 'result', 'id': req_id, 'ok': True,
                       'kind': 'beam'},
                      {'ids': np.asarray(ids, np.int64),
                       'scores': np.asarray(scores, np.float64)})

    def drain(self):
        self.draining = True
        self.pred.drain()

    def snapshot(self):
        return self.pred.stats.snapshot()

    def close(self):
        self.pred.close()


class _CompiledEndpoint(object):
    """Synchronous CompiledPredictor behind a one-thread queue. Requests
    execute in submit order; drain() sheds the queue (re-routable) and
    waits for the in-flight run to deliver. Dense feeds only: the port's
    CompiledPredictor serves no LoD yet (ROADMAP.md queue 1 item 8)."""

    kind = 'compiled'

    def __init__(self, artifact, opts):
        kw = {}
        if opts.get('tier') is not None:
            kw['tier'] = opts['tier']
        if opts.get('platform') is not None:
            kw['platform'] = opts['platform']
        self.pred = _serve.CompiledPredictor(artifact, **kw)
        self.tier = self.pred.tier
        self.draining = False
        self._lock = threading.Lock()
        self._queue = []
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stats = {'requests': 0, 'shed': 0, 'expired': 0}
        self._closed = False
        self._t = threading.Thread(target=self._loop,
                                   name='ptpu-torch-fleet-compiled',
                                   daemon=True)
        self._t.start()
        if opts.get('warmup', True):
            self.pred.run({e['name']: np.zeros(tuple(e['shape']),
                                               np.dtype(e['dtype']))
                           for e in self.pred._sig['feeds']},
                          pad_partial=False)

    def submit(self, hdr, arrays, conn):
        with self._lock:
            if self.draining or self._closed:
                conn.reply_err(hdr['id'],
                               _batching.ServerOverloaded(
                                   'replica draining'), requeue=True)
                return
            # deadline_ms is the REMAINING budget when the frame was
            # written: stamp arrival so endpoint queue time counts too
            self._queue.append((hdr, arrays, conn,
                                time.perf_counter()))
            self._idle.clear()
            self._wake.set()

    def _loop(self):
        while True:
            self._wake.wait()
            with self._lock:
                if not self._queue:
                    self._wake.clear()
                    self._idle.set()
                    if self._closed:
                        return
                    continue
                hdr, arrays, conn, t_in = self._queue.pop(0)
            self._run_one(hdr, arrays, conn, t_in)

    def _run_one(self, hdr, arrays, conn, t_in):
        req_id = hdr['id']
        dl = hdr.get('deadline_ms')
        try:
            if dl is not None and \
                    (time.perf_counter() - t_in) * 1e3 >= dl:
                raise _batching.DeadlineExceeded(
                    'deadline elapsed in the replica queue before '
                    'dispatch%s'
                    % (' (request %s)' % hdr['request_id']
                       if hdr.get('request_id') else ''))
            lod_keys = [k for k in arrays if '.lod' in k]
            if lod_keys:
                raise ValueError(
                    'request carries lod offsets %r: LoD feeds are not '
                    'ported yet (ROADMAP.md queue 1 item 8)' % lod_keys)
            outs = self.pred.run(dict(arrays))
        except Exception as e:
            with self._lock:
                if isinstance(e, _batching.DeadlineExceeded):
                    self._stats['expired'] += 1
            # the run may have dispatched: only sheds re-route
            conn.reply_err(req_id, e, _stream_requeueable(e))
            return
        with self._lock:
            self._stats['requests'] += 1
        conn.send({'op': 'result', 'id': req_id, 'ok': True,
                   'n': len(outs), 'lod': [0] * len(outs)},
                  {'o%d' % j: o for j, o in enumerate(outs)})

    def drain(self):
        with self._lock:
            self.draining = True
            shed = list(self._queue)
            self._queue[:] = []
            self._stats['shed'] += len(shed)
        for hdr, _arrays, conn, _t_in in shed:
            conn.reply_err(hdr['id'], _batching.ServerOverloaded(
                'request shed: replica draining for scale-in'),
                requeue=True)
        self._idle.wait(600)

    def snapshot(self):
        with self._lock:
            return {'tier': self.tier,
                    'queue_depth': len(self._queue),
                    'requests': self._stats['requests'],
                    'shed': self._stats['shed'],
                    'expired': self._stats['expired'],
                    'occupancy': 0.0 if self._idle.is_set() else 1.0}

    def close(self):
        with self._lock:
            self._closed = True
            self._wake.set()


_ENDPOINTS = {'batching': _BatchingEndpoint,
              'decoding': _DecodingEndpoint,
              'compiled': _CompiledEndpoint}


def _framework_free():
    """Neither jax nor the JAX package is loaded in this process."""
    return 'jax' not in sys.modules and 'paddle_tpu' not in sys.modules


def main():
    sock_path, rid, artifact, hb_path, opts_json = sys.argv[1:6]
    rid = int(rid)
    opts = json.loads(opts_json)
    _fleet.apply_numerics(opts.get('numerics') or {})
    # CUDAPlace.device() raises where torch sees no card: the replica
    # exits before its hello and the router's spin-up fails loudly
    device = _serve._place(opts.get('platform')).device()
    builds0 = _kernels.nvcc_runs
    kind = opts.get('kind') or _fleet.detect_kind(artifact)
    endpoint = _ENDPOINTS[kind](artifact, opts)
    compiles = _kernels.nvcc_runs - builds0
    _reset_launches()
    state = ['serving']

    hb_stop = threading.Event()

    def _hb_loop():
        interval = float(opts.get('hb_interval_s', 0.5))
        while True:
            try:
                _fleet.write_heartbeat(hb_path, {
                    'replica': rid, 'pid': os.getpid(),
                    'artifact': artifact,
                    'state': state[0], 'kind': kind,
                    'compiles': compiles,
                    'launches': _launches(),
                    'memory': _memory(device),
                    'stats': endpoint.snapshot()})
            except Exception:
                pass
            if hb_stop.wait(interval):
                return

    hb_t = threading.Thread(target=_hb_loop, name='ptpu-torch-fleet-hb',
                            daemon=True)
    hb_t.start()

    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(sock_path)
    conn = _Conn(sock)
    conn.send({'op': 'hello', 'replica': rid, 'pid': os.getpid(),
               'artifact': artifact,
               'kind': kind, 'tier': endpoint.tier,
               'layout': getattr(endpoint, 'layout', None),
               'mesh': getattr(endpoint, 'mesh', None),
               'device': str(device),
               'compiles': compiles,
               'framework_free': _framework_free()})

    def _drain_then_ack():
        try:
            endpoint.drain()
        finally:
            state[0] = 'drained'
            try:
                conn.send({'op': 'drained', 'replica': rid})
            except OSError:
                pass

    while True:
        try:
            fr = _fleet._recv_frame(sock)
        except Exception:
            fr = None  # EOF or desynced stream: exit; the router's
            #            reader sees the close and fails over
        if fr is None:
            break  # router gone
        hdr, arrays = fr
        op = hdr.get('op')
        if op in ('infer', 'decode'):
            try:
                endpoint.submit(hdr, arrays, conn)
            except Exception as e:
                conn.reply_err(hdr.get('id'), e)
        elif op == 'drain':
            state[0] = 'draining'
            threading.Thread(target=_drain_then_ack,
                             daemon=True).start()
        elif op == 'stop':
            break
    state[0] = 'stopped'
    try:
        endpoint.close()
    except Exception:
        pass
    hb_stop.set()
    hb_t.join(timeout=5)
    try:
        _fleet.write_heartbeat(hb_path, {
            'replica': rid, 'pid': os.getpid(), 'state': 'stopped',
            'compiles': compiles, 'launches': _launches()})
    except Exception:
        pass
    try:
        conn.send({'op': 'bye', 'replica': rid})
    except OSError:
        pass
    sock.close()


if __name__ == '__main__':
    main()
