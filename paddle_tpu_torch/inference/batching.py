"""Dynamic batching of stateless requests over a serving artifact (ref:
paddle_tpu/inference/batching.py), and the serving-tier helpers the
request schedulers share (the shedding exceptions, the max_queue check
and the bucket choice, which inference/decoding.py uses too).

`BatchingPredictor` keeps the reference's contract:

1. **Request queue and coalescing thread**: callers `submit()` requests
   (any row count); a worker thread coalesces them into one batch under a
   `max_batch_size` / `batch_timeout_ms` policy, runs the program once for
   the batch and slices each caller's rows back into its `Future`.
2. **Multi-bucket artifacts** (export_compiled(..., batch_sizes=[1, 8,
   32, 128])): a batch pads up to the SMALLEST bucket that fits.
3. **Double-buffered dispatch**: the coalescing thread hands each batch's
   fetches (device tensors, still being computed) to a delivery thread
   through a queue of depth `inflight`, and goes on to coalesce the next
   batch while the card computes; the delivery thread syncs once per
   batch. On the card a batch is staged in a fresh pinned host buffer and
   copied with non_blocking=True, so the coalescing thread does not wait
   for the card (torch's caching host allocator hands a pinned block out
   again only once the copy that reads it has finished; see
   serve._stack_to_device). The delivery thread waits for
   its batch's CUDA event and copies the fetches back on a stream of its
   own, not behind the next batch's kernels.
4. **Serving metrics**: queue depth, occupancy (filled rows / bucket
   rows) and p50/p95/p99 latency from `stats.snapshot()`, the reference's
   keys.

One difference by design: the batcher holds ONE device copy of the
parameters, shared by every bucket (one Executor and one Scope, the
program run at each bucket's batch), where each bucket of the reference
is a module with its parameters baked in.

Determinism contract: a request's outputs equal an unbatched
`CompiledPredictor.run` through the SAME bucket bit for bit (its row
position inside the batch does not matter); across buckets only closeness
holds.

Not ported: the profiler's serving source (ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from ..executor import _to_numpy
from . import serve as _serve

_STOP = object()


class ServerOverloaded(RuntimeError):
    """The request queue is beyond max_queue: this request was shed
    immediately (fast-fail) instead of being queued into unbounded
    latency. Back off and retry, or add capacity."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline_ms elapsed before it completed: while it
    waited in the queue (no device work was spent on it), or mid-decode
    (its slot was freed at the next step boundary)."""


def shed_if_overloaded(stats, max_queue, fail, request_id=None):
    """The load-shedding check. The caller holds stats._lock: the depth
    check and the enqueue's increment form one critical section, or N
    concurrent submits at depth max_queue-1 would all pass. Returns True
    when the request was shed (fail(exc) already called); `request_id` is
    named in the message and kept in the stats' failure trace."""
    if max_queue is not None and stats.queue_depth >= max_queue:
        stats.shed += 1
        if request_id is not None and hasattr(stats, '_failures'):
            stats._failures.append({'request_id': str(request_id),
                                    'kind': 'shed',
                                    'time': time.time()})
        fail(ServerOverloaded(
            'queue depth %d >= max_queue %d — request shed%s'
            % (stats.queue_depth, max_queue,
               ' (request %s)' % request_id if request_id else '')))
        return True
    return False


def select_bucket(buckets, rows):
    """The smallest bucket that fits `rows`, for any bucket order; raises
    if even the largest is too small."""
    fit = [b for b in buckets if rows <= b]
    if fit:
        return min(fit)
    raise ValueError(
        "batch of %d rows exceeds the largest compiled bucket %d"
        % (rows, max(buckets)))


def _resolve(future, result=None, exc=None):
    """Resolve a request future, tolerating caller-side cancel(): queued
    futures are never marked running, so a client may cancel at any time
    — set_result/set_exception then raise InvalidStateError, which must
    not kill a worker thread or strand the batch's other requests."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except Exception:
        pass


def _batch_rows(sig):
    """The artifact's batch dimension: the (required-uniform) leading dim
    of every feed."""
    lead = set()
    for e in sig['feeds']:
        if not e['shape']:
            raise ValueError(
                "feed %r has no batch dimension (shape []); the batcher "
                "needs batch-led dense feeds" % e['name'])
        lead.add(int(e['shape'][0]))
    if len(lead) != 1:
        raise ValueError(
            "artifact feeds disagree on the batch dimension (%s); the "
            "batcher needs one uniform leading batch dim" % sorted(lead))
    return lead.pop()


class _Warmup(object):
    """A queue item that runs every bucket once on the coalescing
    thread."""
    __slots__ = ('future',)

    def __init__(self, future):
        self.future = future


class _Request(object):
    __slots__ = ('arrays', 'rows', 'future', 't_submit', 'deadline')

    def __init__(self, arrays, rows, future, deadline_ms=None):
        self.arrays = arrays
        self.rows = rows
        self.future = future
        self.t_submit = time.perf_counter()
        self.deadline = (self.t_submit + deadline_ms / 1e3
                         if deadline_ms is not None else None)


class ServingStats(object):
    """Thread-safe serving counters: queue-depth gauge, cumulative batch
    occupancy, and a sliding window of per-request latencies for
    percentile reporting."""

    def __init__(self, window=8192):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=window)
        self.tier = 'bf16'   # serving tier of the source
        self.queue_depth = 0
        self.requests = 0
        self.batches = 0
        self.filled_rows = 0
        self.bucket_rows = 0
        self.shed = 0      # fast-failed at submit: queue beyond max_queue
        self.expired = 0   # deadline_ms elapsed while queued
        self.drained = 0   # shed by drain(): queued when scale-in began

    def reset(self):
        """Zero the counters and latency window (queue_depth is a live
        gauge and stays): separates a warmup phase from the measured
        run."""
        with self._lock:
            self._lat.clear()
            self.requests = 0
            self.batches = 0
            self.filled_rows = 0
            self.bucket_rows = 0
            self.shed = 0
            self.expired = 0
            self.drained = 0

    def record_batch(self, filled, bucket, latencies_s):
        with self._lock:
            self.batches += 1
            self.requests += len(latencies_s)
            self.filled_rows += filled
            self.bucket_rows += bucket
            self._lat.extend(latencies_s)

    def snapshot(self):
        """One consistent dict: queue_depth, requests, batches, occupancy
        (filled/bucket rows), p50/p95/p99_ms over the latency window."""
        with self._lock:
            lat = np.asarray(self._lat, np.float64) * 1e3
            snap = {'tier': self.tier,
                    'queue_depth': int(self.queue_depth),
                    'requests': int(self.requests),
                    'batches': int(self.batches),
                    'shed': int(self.shed),
                    'expired': int(self.expired),
                    'drained': int(self.drained),
                    'occupancy': round(self.filled_rows / self.bucket_rows, 4)
                    if self.bucket_rows else 0.0}
        if lat.size:
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            snap.update(p50_ms=round(float(p50), 3),
                        p95_ms=round(float(p95), 3),
                        p99_ms=round(float(p99), 3))
        else:
            snap.update(p50_ms=0.0, p95_ms=0.0, p99_ms=0.0)
        return snap


class BatchingPredictor(object):
    """Coalesce concurrent requests into batched runs over a
    (multi-bucket) serving artifact.

    submit(inputs) -> Future   enqueue one request (rows x feed shapes)
    run(inputs)                submit + wait (synchronous convenience)
    warmup()                   one run per bucket ahead of traffic
    stats.snapshot()           serving metrics
    drain()                    stop admitting, shed the queue, stop
    close()                    serve the queue, then stop the threads

    `inputs` is a list (feed order) or dict of arrays whose leading dim is
    this request's row count (1..max_batch_size); trailing dims must match
    the artifact's feeds. Dense feeds and batch-aligned fetches only.
    `platform` (or env PTPU_PLATFORM) as CompiledPredictor takes it.
    """

    def __init__(self, artifact_dir, platform=None, max_batch_size=None,
                 batch_timeout_ms=5.0, inflight=2, stats_window=8192,
                 max_queue=None, tier=None):
        artifact_dir = _serve.resolve_tier(artifact_dir, tier)
        top_sig = _serve._read_signature(artifact_dir)
        self.tier = top_sig.get('tier', 'bf16')
        # lod rejection first: _batch_rows on an all-lod artifact would
        # raise a misleading "feeds disagree" error
        for e in top_sig['feeds']:
            if int(e.get('lod_levels', 0)):
                raise ValueError(
                    "feed %r carries lod; the batcher serves dense feeds "
                    "only" % e['name'])
        sizes = top_sig.get('buckets')
        if sizes:
            dirs = {int(b): os.path.join(artifact_dir,
                                         _serve._BUCKET_DIR % int(b))
                    for b in sizes}
            first = _serve.CompiledPredictor(dirs[min(dirs)],
                                             platform=platform)
            # one program, one Scope, one copy of the parameters for all
            preds = {b: first if b == min(dirs) else _serve.CompiledPredictor(
                d, _model=first._model) for b, d in dirs.items()}
        else:  # single-bucket artifact
            pred = _serve.CompiledPredictor(artifact_dir, platform=platform)
            preds = {_batch_rows(pred._sig): pred}
        self._buckets = sorted(preds)
        self._preds = preds
        self._sig = preds[self._buckets[-1]]._sig
        self._device = preds[self._buckets[-1]]._device
        self.place = preds[self._buckets[-1]].place
        for b in self._buckets:
            for e in _serve._fetch_entries(preds[b]._sig):
                if int(e.get('lod_levels', 0)):
                    raise ValueError(
                        "fetch %r carries lod; the batcher cannot slice "
                        "per-request lod results" % e['name'])
                shape = e.get('shape')
                if shape is not None and (not shape or int(shape[0]) != b):
                    raise ValueError(
                        "fetch %r has shape %s in the %d-row bucket — not "
                        "batch-aligned, so per-request results cannot be "
                        "sliced back (e.g. a batch reduction); fetch "
                        "per-row outputs instead" % (e['name'], shape, b))
        _batch_rows(self._sig)  # validates uniform batch-led feeds
        self._feed_specs = [
            (e['name'], tuple(e['shape'][1:]), np.dtype(e['dtype']))
            for e in self._sig['feeds']]
        self._feed_names = [n for n, _, _ in self._feed_specs]
        self._fetch_entries = _serve._fetch_entries(self._sig)
        largest = self._buckets[-1]
        self._max_rows = min(max_batch_size or largest, largest)
        self._timeout_s = max(batch_timeout_ms, 0.0) / 1e3
        self._max_queue = int(max_queue) if max_queue else None
        self._cuda = self._device.type == 'cuda'
        self._copy_stream = (torch.cuda.Stream(self._device) if self._cuda
                             else None)
        self._queue = queue.Queue()
        self._inflight = queue.Queue(maxsize=max(1, int(inflight)))
        self.stats = ServingStats(stats_window)
        self.stats.tier = self.tier
        self._closed = False
        self._draining = False
        # orders submit()'s closed-check+enqueue against close()'s
        # closed-set+_STOP: no request can land behind the sentinel
        self._lifecycle = threading.Lock()
        self._coalesce_t = threading.Thread(
            target=self._coalesce_loop, name='ptpu-torch-batcher-coalesce',
            daemon=True)
        self._deliver_t = threading.Thread(
            target=self._deliver_loop, name='ptpu-torch-batcher-deliver',
            daemon=True)
        self._coalesce_t.start()
        self._deliver_t.start()

    # -- public API --------------------------------------------------------
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return [e['name'] for e in self._fetch_entries]

    @property
    def buckets(self):
        return list(self._buckets)

    def submit(self, inputs, deadline_ms=None, request_id=None):
        """Enqueue one request; returns a Future resolving to the list of
        per-fetch numpy arrays sliced to this request's rows. Validation
        errors fail THIS future only. With `deadline_ms`, a request still
        queued when the deadline elapses resolves to DeadlineExceeded
        instead of running late. Beyond `max_queue` the future resolves to
        ServerOverloaded at once. `request_id` is an optional caller trace
        id named in the shed message."""
        if self._closed:
            raise RuntimeError('BatchingPredictor is closed')
        fut = Future()

        def _shed_locked():
            return shed_if_overloaded(self.stats, self._max_queue,
                                      fut.set_exception,
                                      request_id=request_id)

        with self.stats._lock:     # fast-fail before validation work
            if _shed_locked():
                return fut
        try:
            arrays, rows = self._validate(inputs)
        except Exception as e:
            fut.set_exception(e)
            return fut
        with self._lifecycle:
            if self._closed:
                raise RuntimeError('BatchingPredictor is closed')
            with self.stats._lock:
                if _shed_locked():  # re-check atomically with the enqueue
                    return fut
                self.stats.queue_depth += 1
            self._queue.put(_Request(arrays, rows, fut, deadline_ms))
        return fut

    def run(self, inputs, timeout=None, deadline_ms=None):
        """Synchronous single-request path: submit + wait."""
        return self.submit(inputs, deadline_ms=deadline_ms).result(timeout)

    def warmup(self, timeout=None):
        """One run per bucket ahead of traffic, on the coalescing thread
        that serves them: the card picks its kernels and allocates, the
        pinned staging buffers are cached, and the thread's own caches (torch
        keeps cuDNN's execution plans per thread) are filled. Returns when
        every bucket has run."""
        fut = Future()
        with self._lifecycle:
            if self._closed:
                raise RuntimeError('BatchingPredictor is closed')
            self._queue.put(_Warmup(fut))
        fut.result(timeout)
        return self

    def _warm(self, fut):
        try:
            for b in self._buckets:
                for o in self._preds[b]._call_flat(self._stage([], 0, b)):
                    _to_numpy(o)
        except Exception as e:
            _resolve(fut, exc=e)
            return
        _resolve(fut, self)

    def drain(self):
        """Draining stop for scale-in: stop admitting (submit() raises),
        shed the queued backlog loudly (each queued request resolves to
        ServerOverloaded, counted in `shed` and `drained`), deliver the
        in-flight batches and stop the threads. close() serves the backlog
        instead. Idempotent."""
        with self._lifecycle:
            self._draining = True
        self.close()

    def close(self):
        """Serve queued requests, then stop the threads. Idempotent;
        submit() afterwards raises."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_STOP)
        self._coalesce_t.join()
        while True:  # safety net; the lifecycle lock should make this dead
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(req, _Warmup):
                _resolve(req.future,
                         exc=RuntimeError('BatchingPredictor closed'))
            elif req is not _STOP:
                with self.stats._lock:
                    self.stats.queue_depth -= 1
                _resolve(req.future,
                         exc=RuntimeError('BatchingPredictor closed'))
        self._inflight.put(_STOP)
        self._deliver_t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- internals ---------------------------------------------------------
    def _validate(self, inputs):
        if isinstance(inputs, (list, tuple)):
            if len(inputs) != len(self._feed_names):
                raise ValueError(
                    "batcher expects %d inputs (%s), got %d"
                    % (len(self._feed_names), self._feed_names, len(inputs)))
            feed = dict(zip(self._feed_names, inputs))
        else:
            feed = dict(inputs)
        missing = [n for n in self._feed_names if n not in feed]
        if missing:
            raise ValueError("missing feeds: %r (artifact expects %s)"
                             % (missing, self._feed_names))
        arrays, rows = [], None
        for name, trail, dtype in self._feed_specs:
            value = feed[name]
            arr = np.asarray(value, dtype=dtype)
            if arr is value:
                # snapshot the caller's own buffer: the run is async, and a
                # client reusing its buffer for the next request must not
                # corrupt this one (the bit-identity contract)
                arr = arr.copy()
            if arr.ndim != len(trail) + 1 or tuple(arr.shape[1:]) != trail:
                raise ValueError(
                    "feed %r: expected per-request shape [rows]+%s, got %s"
                    % (name, list(trail), list(arr.shape)))
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise ValueError(
                    "feeds disagree on request rows: %r has %d, expected %d"
                    % (name, arr.shape[0], rows))
            arrays.append(arr)
        if not rows:
            raise ValueError("empty request (0 rows)")
        if rows > self._max_rows:
            raise ValueError(
                "request of %d rows exceeds max_batch_size %d"
                % (rows, self._max_rows))
        return arrays, rows

    def _reap_expired(self, req):
        """Resolve a request whose deadline elapsed in the queue; True
        when reaped (it must not join a batch)."""
        if req.deadline is None or time.perf_counter() <= req.deadline:
            return False
        with self.stats._lock:
            self.stats.queue_depth -= 1
            self.stats.expired += 1
        _resolve(req.future, exc=DeadlineExceeded(
            'request expired after %.1f ms in queue (deadline_ms=%.1f)'
            % ((time.perf_counter() - req.t_submit) * 1e3,
               (req.deadline - req.t_submit) * 1e3)))
        return True

    def _shed_drained(self, req):
        """drain() in progress: a still-queued request sheds loudly
        instead of joining a batch."""
        with self.stats._lock:
            self.stats.queue_depth -= 1
            self.stats.shed += 1
            self.stats.drained += 1
        _resolve(req.future, exc=ServerOverloaded(
            'request shed: predictor draining for scale-in'))

    def _coalesce_loop(self):
        carry = None
        while True:
            req = carry if carry is not None else self._queue.get()
            carry = None
            if req is _STOP:
                return
            if isinstance(req, _Warmup):
                self._warm(req.future)
                continue
            if self._draining:
                self._shed_drained(req)
                continue
            if self._reap_expired(req):
                continue
            batch, rows = [req], req.rows
            deadline = time.perf_counter() + self._timeout_s
            while rows < self._max_rows:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP or isinstance(nxt, _Warmup):
                    carry = nxt  # dispatch this batch first
                    break
                if self._draining:
                    self._shed_drained(nxt)
                    continue
                if self._reap_expired(nxt):
                    continue
                if rows + nxt.rows > self._max_rows:
                    carry = nxt  # seed the next batch
                    break
                batch.append(nxt)
                rows += nxt.rows
            self._dispatch(batch, rows)

    def _stage(self, batch, rows, bs):
        """The batch's feeds at the bucket's rows, zero-padded, on the
        device: one host buffer (pinned on the card) and one non-blocking
        copy a feed. Warmup stages an empty batch: all zeros."""
        return [_serve._stack_to_device(
                    [r.arrays[i] for r in batch]
                    or [np.empty((0,) + trail, dtype)], self._device, rows=bs)
                for i, (_, trail, dtype) in enumerate(self._feed_specs)]

    def _dispatch(self, batch, rows):
        with self.stats._lock:
            self.stats.queue_depth -= len(batch)
        try:
            bs = select_bucket(self._buckets, rows)
            args = self._stage(batch, rows, bs)
            outs = self._preds[bs]._call_flat(args)  # async: no sync here
            done = None
            if self._cuda:
                done = torch.cuda.Event()
                done.record()
        except Exception as e:
            for r in batch:
                _resolve(r.future, exc=e)
            return
        # the bounded queue is the double buffer's backpressure: at most
        # `inflight` batches ahead of delivery
        self._inflight.put((batch, rows, bs, outs, done))

    def _fetch(self, outs, done):
        """The batch's fetches on the host: its one sync."""
        if done is None:
            return [_to_numpy(o) for o in outs]
        done.synchronize()
        with torch.cuda.stream(self._copy_stream):
            return [_to_numpy(o) for o in outs]

    def _deliver_loop(self):
        while True:
            item = self._inflight.get()
            if item is _STOP:
                return
            batch, rows, bs, outs, done = item
            try:
                outs = self._fetch(outs, done)
                for e, o in zip(self._fetch_entries, outs):
                    # for v2 signatures, which record no fetch shapes
                    if o.ndim < 1 or o.shape[0] != bs:
                        raise ValueError(
                            "fetch %r has shape %s from the %d-row bucket "
                            "— not batch-aligned, per-request slicing is "
                            "impossible" % (e['name'], list(o.shape), bs))
            except Exception as e:
                for r in batch:
                    _resolve(r.future, exc=e)
                continue
            # record stats BEFORE resolving: a caller reading
            # stats.snapshot() right after result() returns must see this
            # batch accounted
            now = time.perf_counter()
            self.stats.record_batch(rows, bs,
                                    [now - r.t_submit for r in batch])
            off = 0
            for r in batch:
                _resolve(r.future, [o[off:off + r.rows] for o in outs])
                off += r.rows


def load_batching(artifact_dir, **kwargs):
    return BatchingPredictor(artifact_dir, **kwargs)
