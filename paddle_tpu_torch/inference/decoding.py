"""Continuous in-flight batching for autoregressive decode (ref:
paddle_tpu/inference/decoding.py).

`DecodingPredictor` serves an `export_decode` artifact as a token-streaming
endpoint: iteration-level scheduling over a preallocated, slot-paged KV
cache.

1. **Fixed-shape programs.** A prefill program per prompt-length bucket
   (one request: writes the prompt's K/V rows into one cache slot and
   returns its first-token logits) and one decode-step program
   ([max_slots] requests advance one token each). Idle slots are masked by
   each slot's own attention window, so a partly full batch runs the same
   shapes.
2. **Iteration-level scheduling.** New requests join the running batch at
   step boundaries (one prefill dispatch, then their slot decodes with
   everyone else's); a finished sequence (eos or max_new_tokens) frees its
   slot at once for the next waiting request. Admission is strict FIFO.
3. **The cache in place.** The cache vars live in the predictor's Scope
   across programs; the KV ops write into them in place
   (ops/decode_ops.py). A beam reorder is an index copy over the slot axis.
4. **Streaming futures.** `submit()` returns a `TokenStream` that yields
   tokens as steps complete. Deadlines and max_queue shedding apply, and a
   deadline that passes mid-decode frees the slot at the next step
   boundary.

Each program runs through the port's Executor on the predictor's place
(CUDAPlace(0) unless the caller passes CPUPlace()), from the scheduler
thread; every tensor the programs make is on that explicit device.

Determinism contract: a request's token stream is the same whether it
decodes alone or beside any other requests: every per-slot computation is
row-independent and masked rows carry exactly-zero attention weight.
Greedy and fixed-width beam search run on the host over the fetched
logits, with float64 scores and stable tie-breaking.

Not ported yet (each raises or is left out): the block-paged layout and
its BlockManager (kv_blocks.py), the int8 KV tier and `tier=`, the verify
program and the drafters (`draft=`, `draft_k=`), mesh sharding, AOT
sidecars, and the profiler's serving source.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from .. import io as _io
from ..core.scope import Scope, scope_guard
from ..executor import Executor
from ..framework import to_torch_dtype
from .batching import (DeadlineExceeded, ServerOverloaded,  # noqa: F401
                       select_bucket, shed_if_overloaded)

_STOP = object()
_WAKE = object()   # no-op queue item: rouse an idle scheduler (drain)

# -- artifact layout (export.py export_decode writes exactly this) ----------
_FORMAT = 'paddle_tpu_torch'
_DECODE_SIGNATURE = 'decode_signature.json'
_STEP_DIR = 'decode_step'
_PREFILL_DIR = 'prefill_%05d'   # % prompt-length bucket
_PARAMS_DIR = 'params'
_PROGRAM_FILE = '__model__'


def _percentiles(values, qs):
    if not values:
        return [0.0 for _ in qs]
    arr = np.asarray(values, np.float64) * 1e3
    return [round(float(p), 3) for p in np.percentile(arr, qs)]


def _log_softmax(row):
    """Deterministic host log-softmax (float64): beam scoring must give
    the same bits for the same logits regardless of co-residency."""
    x = np.asarray(row, np.float64)
    x = x - x.max()
    return x - np.log(np.exp(x).sum())


class DecodeStats(object):
    """Thread-safe decode-serving counters: queue-depth gauge, token and
    dispatch totals, slot occupancy, and sliding windows of time to first
    token (TTFT) and inter-token latency (ITL) for percentiles.
    `snapshot()` returns them as one dict."""

    def __init__(self, window=8192):
        self._lock = threading.Lock()
        self._ttft = deque(maxlen=window)
        self._itl = deque(maxlen=window)
        # tagged-request failure trace (shed/expired requests that carried
        # a request_id)
        self._failures = deque(maxlen=16)
        self.tier = 'float32'    # KV-cache dtype
        self.queue_depth = 0
        self.reset()

    def reset(self):
        """Zero counters and latency windows (queue_depth is a live gauge
        and stays): separates warmup from the measured run."""
        with self._lock:
            self._ttft.clear()
            self._itl.clear()
            self._failures.clear()
            self.requests = 0        # completed requests
            self.tokens = 0          # tokens decoded (all beams)
            self.prefills = 0        # prefill dispatches
            self.steps = 0           # decode-step dispatches
            self.reorders = 0        # slot-row copies (beam fan-out/reorder)
            self.active_slot_steps = 0
            self.slot_steps = 0
            self.shed = 0
            self.expired = 0
            self.drained = 0         # shed by drain(): queued at scale-in
            self.busy_s = 0.0        # wall time with >= 1 active slot

    def record_failure(self, request_id, kind):
        """One tagged request's shed or expiry, kept in the bounded
        `recent_failures` list."""
        if request_id is None:
            return
        with self._lock:
            self._failures.append({'request_id': str(request_id),
                                   'kind': kind,
                                   'time': time.time()})

    def snapshot(self):
        with self._lock:
            ttft50, ttft99 = _percentiles(list(self._ttft), [50, 99])
            itl50, itl99 = _percentiles(list(self._itl), [50, 99])
            occ = (self.active_slot_steps / self.slot_steps
                   if self.slot_steps else 0.0)
            return {'kind': 'decode',
                    'tier': self.tier,
                    'queue_depth': int(self.queue_depth),
                    'requests': int(self.requests),
                    'tokens': int(self.tokens),
                    'prefills': int(self.prefills),
                    'steps': int(self.steps),
                    'reorders': int(self.reorders),
                    'occupancy': round(occ, 4),
                    'tokens_s': round(self.tokens / self.busy_s, 2)
                    if self.busy_s else 0.0,
                    'shed': int(self.shed),
                    'expired': int(self.expired),
                    'drained': int(self.drained),
                    'ttft_p50_ms': ttft50, 'ttft_p99_ms': ttft99,
                    'itl_p50_ms': itl50, 'itl_p99_ms': itl99,
                    'recent_failures': list(self._failures)}


class TokenStream(object):
    """Per-request streaming future. Greedy requests: iterate to receive
    tokens as decode steps complete (`for tok in stream: ...`), or call
    `result()` for the full generated id list (eos included when
    emitted). Beam requests: `result()` -> (ids [beam, n_tokens] int64,
    scores [beam] float64), hypotheses best first; iteration yields
    nothing until completion (beams reorder mid-flight)."""

    def __init__(self, beam=None):
        self.beam = beam
        self._q = queue.Queue()
        self._fut = Future()
        self._cancelled = False

    # -- consumer side ----------------------------------------------------
    def __iter__(self):
        for batch in self.batches():
            for tok in batch:
                yield tok

    def batches(self):
        """Yield token delivery batches: one list per decode step (a
        singleton)."""
        while True:
            kind, payload = self._q.get()
            if kind == 'tok':
                yield [payload]
            elif kind == 'end':
                return
            else:
                raise payload

    def result(self, timeout=None):
        return self._fut.result(timeout)

    def done(self):
        return self._fut.done()

    def exception(self, timeout=None):
        return self._fut.exception(timeout)

    def cancel(self):
        """Best effort: the scheduler frees the slot(s) at the next step
        boundary; tokens already streamed stay delivered."""
        self._cancelled = True

    # -- producer side (scheduler thread) ---------------------------------
    def _push(self, tok):
        self._q.put(('tok', int(tok)))

    def _finish(self, result):
        try:
            self._fut.set_result(result)
        except Exception:
            pass
        self._q.put(('end', None))

    def _fail(self, exc):
        try:
            self._fut.set_exception(exc)
        except Exception:
            pass
        self._q.put(('err', exc))


class _Request(object):
    __slots__ = ('prompt', 'max_new', 'beam', 'stream', 't_submit',
                 'deadline', 'slots', 'produced', 'tokens', 'last_tokens',
                 'scores', 'finished', 'hyps', 't_first', 't_last',
                 'request_id')

    def __init__(self, prompt, max_new, beam, stream, deadline_ms,
                 request_id=None):
        self.prompt = prompt
        self.request_id = request_id      # caller trace id
        self.max_new = max_new
        self.beam = beam                  # None = greedy
        self.stream = stream
        self.t_submit = time.perf_counter()
        self.deadline = (self.t_submit + deadline_ms / 1e3
                         if deadline_ms is not None else None)
        self.slots = []                   # slot indices, beam order
        self.produced = 0                 # tokens generated so far
        self.tokens = []                  # greedy transcript
        self.last_tokens = []             # per beam: next step's input
        self.scores = []                  # per beam accumulated logprob
        self.finished = []                # per beam: emitted eos
        self.hyps = []                    # per beam token lists
        self.t_first = None
        self.t_last = None


def _load_program(d):
    with open(os.path.join(d, _PROGRAM_FILE), 'rb') as f:
        desc = json.loads(f.read().decode())
    return _io.program_from_dict(desc), list(desc['fetch_names'])


class DecodingPredictor(object):
    """Token-streaming decode endpoint with continuous in-flight batching
    over an `export_decode` artifact.

    submit(prompt_ids, ...) -> TokenStream   enqueue one decode request
    generate(prompt_ids, ...)                submit + wait (synchronous)
    warmup()                                 run every program once ahead
                                             of traffic
    stats.snapshot()                         decode serving metrics
    drain()                                  stop admitting, finish the
                                             active streams
    close()                                  stop the scheduler; waiting
                                             and in-flight requests fail
                                             with RuntimeError

    `place` is where the programs run: CUDAPlace(0) unless the caller
    passes CPUPlace(); where torch sees no card, the CUDA place raises.
    `prompt_ids`: 1-D int sequence, 1 <= len <= the largest prompt bucket.
    `beam=` runs fixed-width beam search (the request occupies `beam`
    slots); default greedy. Admission is strict FIFO: a beam request at
    the head waits for enough free slots.

    `tier=`, `draft=` and `draft_k=` (the reference's int8 tier and
    speculative decoding) are not ported yet: anything but None raises
    NotImplementedError.
    """

    def __init__(self, artifact_dir, place=None, max_queue=None,
                 default_max_new_tokens=32, stats_window=8192,
                 tier=None, draft=None, draft_k=None):
        for name, val in (('tier', tier), ('draft', draft),
                          ('draft_k', draft_k)):
            if val is not None:
                raise NotImplementedError(
                    'DecodingPredictor(%s=...) is not ported yet: the port '
                    'serves the slot layout with an f32 cache, without '
                    'speculative decoding' % name)
        sig_path = os.path.join(artifact_dir, _DECODE_SIGNATURE)
        with open(sig_path) as f:
            self._sig = json.load(f)
        if self._sig.get('format') != _FORMAT:
            raise ValueError(
                '%s is not a paddle_tpu_torch decode artifact (the port '
                'cannot load jax.export modules); write one with '
                'paddle_tpu_torch.inference.export_decode' % sig_path)
        self._S = int(self._sig['max_slots'])
        self._T = int(self._sig['max_cache_len'])
        self._eos = int(self._sig['eos_id'])
        self._vocab = int(self._sig['vocab'])
        self._default_max_new = int(default_max_new_tokens)
        self._max_queue = int(max_queue) if max_queue else None
        self._exe = Executor(place)
        self.place = self._exe.place
        self._scope = Scope()
        self._step_prog, self._step_fetches = _load_program(
            os.path.join(artifact_dir, _STEP_DIR))
        # sorted once at load: select_bucket takes the smallest fit
        self._buckets = sorted(int(b) for b in self._sig['prompt_buckets'])
        self._max_prompt = self._buckets[-1]
        self._prefill_progs = {
            b: _load_program(os.path.join(artifact_dir, _PREFILL_DIR % b))
            for b in self._buckets}
        self._load_params(os.path.join(artifact_dir, _PARAMS_DIR))
        self._slots = [None] * self._S    # slot -> (request, beam index)
        self._closed = False
        self._draining = False
        self._idle_evt = threading.Event()
        self._lifecycle = threading.Lock()
        self._queue = queue.Queue()
        self.stats = DecodeStats(stats_window)
        self.stats.tier = self._sig['kv_cache_dtype']
        self._reset_state()
        self._sched_t = threading.Thread(
            target=self._sched_loop, name='ptpu-torch-decode-sched',
            daemon=True)
        self._sched_t.start()

    def _load_params(self, params_dir):
        """Every parameter the signature lists, into the predictor's scope
        on its device, each resolved in the first program that has it."""
        names = set(self._sig['params'])
        progs = [self._step_prog] + [p for p, _ in
                                     self._prefill_progs.values()]
        with scope_guard(self._scope):
            for prog in progs:
                todo = [v for v in prog.list_vars() if v.name in names
                        and self._scope.get(v.name) is None]
                if todo:
                    _io.load_vars(self._exe, params_dir, main_program=prog,
                                  vars=todo)

    # -- public API --------------------------------------------------------
    @property
    def max_slots(self):
        return self._S

    @property
    def prompt_buckets(self):
        return list(self._buckets)

    def submit(self, prompt_ids, max_new_tokens=None, beam=None,
               deadline_ms=None, request_id=None):
        """Enqueue one decode request; returns a TokenStream. Validation
        errors fail this stream only. With `deadline_ms`, a request still
        queued, or still decoding, when the deadline elapses resolves to
        DeadlineExceeded at the next step boundary and frees its slot(s).
        Beyond `max_queue` waiting requests, new submissions shed with
        ServerOverloaded before any device work. `request_id` is an
        optional caller trace id, named in every shed or expiry message
        and kept in stats `recent_failures`."""
        if self._closed:
            raise RuntimeError('DecodingPredictor is closed')
        beam = int(beam) if beam else None
        stream = TokenStream(beam=beam)
        rid_sfx = (' (request %s)' % request_id) if request_id else ''

        def _shed_drained():
            with self.stats._lock:
                self.stats.shed += 1
                self.stats.drained += 1
            self.stats.record_failure(request_id, 'drained')
            stream._fail(ServerOverloaded(
                'request shed: endpoint draining for scale-in%s' % rid_sfx))
            return stream

        if self._draining:
            return _shed_drained()

        def _shed_locked():
            return shed_if_overloaded(self.stats, self._max_queue,
                                      stream._fail, request_id=request_id)

        with self.stats._lock:          # fast-fail before validation work
            if _shed_locked():
                return stream
        try:
            prompt = np.asarray(prompt_ids, np.int64).reshape(-1).copy()
            if not prompt.size:
                raise ValueError('empty prompt')
            if prompt.size > self._max_prompt:
                raise ValueError(
                    'prompt of %d tokens exceeds the largest compiled prompt '
                    'bucket %d' % (prompt.size, self._max_prompt))
            max_new = int(max_new_tokens if max_new_tokens is not None
                          else self._default_max_new)
            # cache capacity: the last generated token writes position
            # len(prompt) + max_new - 2
            max_new = max(1, min(max_new, self._T - prompt.size + 1))
            if beam is not None and not 1 <= beam <= self._S:
                raise ValueError('beam width %d not in [1, max_slots=%d]'
                                 % (beam, self._S))
        except Exception as e:
            stream._fail(e)
            return stream
        req = _Request(prompt, max_new, beam, stream, deadline_ms,
                       request_id=request_id)
        with self._lifecycle:
            if self._closed:
                raise RuntimeError('DecodingPredictor is closed')
            if self._draining:
                return _shed_drained()
            with self.stats._lock:
                if _shed_locked():      # re-check atomically with enqueue
                    return stream
                self.stats.queue_depth += 1
            self._queue.put(req)
        return stream

    def generate(self, prompt_ids, max_new_tokens=None, beam=None,
                 deadline_ms=None, timeout=None):
        """Synchronous single-request decode: submit + wait."""
        return self.submit(prompt_ids, max_new_tokens=max_new_tokens,
                           beam=beam, deadline_ms=deadline_ms
                           ).result(timeout)

    def warmup(self):
        """Run every program once ahead of traffic (one dispatch per prompt
        bucket and one decode step: the card's first calls pick their
        kernels and allocate); the cache is zeroed afterwards. Must run
        before any submit(): it dispatches from the caller's thread, so it
        refuses once traffic has started."""
        if self.stats.queue_depth or any(s is not None for s in self._slots):
            raise RuntimeError(
                'warmup() must run before traffic: requests are queued or '
                'decoding, and a caller-thread dispatch would race the '
                'scheduler over the cache')
        for b in self._buckets:
            self._dispatch_prefill(b, np.zeros((1, b), np.int64), 1, 0)
        self._dispatch_step(np.zeros((self._S, 1), np.int64),
                            np.zeros((self._S, 1), np.int32))
        self._reset_state()
        self.stats.reset()   # warmup dispatches must not count as traffic
        return self

    def drain(self, timeout=None):
        """Draining stop for scale-in: stop admitting (new and waiting
        requests shed with ServerOverloaded, counted in shed and drained)
        while every active stream decodes to completion. Blocks until the
        last active slot frees (or `timeout`); returns True when fully
        drained. The endpoint stays open for stats and close()."""
        with self._lifecycle:
            if self._closed:
                return True
            self._draining = True
            self._idle_evt.clear()
            self._queue.put(_WAKE)  # rouse an idle scheduler
        return self._idle_evt.wait(timeout)

    def close(self):
        """Stop the scheduler thread. Waiting and in-flight requests
        resolve with RuntimeError. Idempotent; submit() afterwards raises.
        Also finalizes an endpoint that closed itself after a failed state
        rebuild."""
        with self._lifecycle:
            if not self._closed:
                self._closed = True
                self._queue.put(_STOP)
        self._idle_evt.set()   # never strand a drain() waiter
        if threading.current_thread() is not self._sched_t:
            self._sched_t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- device plumbing ---------------------------------------------------
    def _reset_state(self):
        """(Re)make the paged KV cache: zeros of each state entry's shape
        and dtype on the predictor's device, in its scope."""
        dev = self._exe.device
        for e in self._sig['state']:
            self._scope.set(e['name'], torch.zeros(
                tuple(e['shape']), dtype=to_torch_dtype(e['dtype']),
                device=dev))

    def _dispatch_step(self, tokens, pos):
        logits, = self._exe.run(self._step_prog,
                                feed={'tokens': tokens, 'pos': pos},
                                fetch_list=self._step_fetches,
                                scope=self._scope)
        with self.stats._lock:
            self.stats.steps += 1
        return logits                                      # [S, V] synced

    def _dispatch_prefill(self, bucket, padded, plen, slot):
        prog, fetches = self._prefill_progs[bucket]
        logits, = self._exe.run(
            prog, feed={'prompt_ids': padded,
                        'prompt_len': np.full((1, 1), plen, np.int32),
                        'slot': np.full((1, 1), slot, np.int32)},
            fetch_list=fetches, scope=self._scope)
        with self.stats._lock:
            self.stats.prefills += 1
        return logits[0]                                   # [V] synced

    def _dispatch_reorder(self, src):
        """Slot s of every cache var takes slot src[s]'s rows: only the
        rows that move are copied (the right side is gathered before the
        write, so a row read and written in one call is read first)."""
        src = np.asarray(src, np.int64)
        dst = np.nonzero(src != np.arange(self._S))[0]
        if dst.size:
            dev = self._exe.device
            dst_t = torch.as_tensor(dst, device=dev)
            src_t = torch.as_tensor(src[dst], device=dev)
            for e in self._sig['state']:
                cache = self._scope.get(e['name'])
                cache[dst_t] = cache[src_t]
        with self.stats._lock:
            self.stats.reorders += 1

    # -- scheduler ---------------------------------------------------------
    def _active_requests(self):
        seen = []
        for entry in self._slots:
            if entry is not None and entry[0] not in seen:
                seen.append(entry[0])
        return seen

    def _free_slots(self):
        return [i for i, s in enumerate(self._slots) if s is None]

    def _release(self, req):
        for s in req.slots:
            self._slots[s] = None

    def _sched_loop(self):
        waiting = deque()
        while True:
            have_work = waiting or any(s is not None for s in self._slots)
            try:
                item = self._queue.get(block=not have_work)
            except queue.Empty:
                item = None
            if item is _STOP:
                self._drain_on_close(waiting)
                return
            if item is _WAKE:
                item = None
            if item is not None:
                waiting.append(item)
                continue  # keep draining submissions before dispatching
            t0 = time.perf_counter()
            if self._draining:
                # scale-in drain: shed the waiting queue (never dispatched);
                # active streams keep stepping to completion below
                self._shed_waiting(waiting)
            self._expire(waiting)
            if not self._draining:
                self._admit(waiting)
            if any(s is not None for s in self._slots):
                try:
                    self._step()
                except Exception as e:
                    self._fail_all(e, waiting)
                with self.stats._lock:
                    self.stats.busy_s += time.perf_counter() - t0
            if self._draining and not waiting \
                    and not any(s is not None for s in self._slots):
                self._idle_evt.set()

    def _shed_waiting(self, waiting):
        """drain() in progress: fail every waiting request with
        ServerOverloaded (shed and drained counters); none reached a
        slot."""
        while waiting:
            req = waiting.popleft()
            with self.stats._lock:
                self.stats.queue_depth -= 1
                self.stats.shed += 1
                self.stats.drained += 1
            self.stats.record_failure(req.request_id, 'drained')
            req.stream._fail(ServerOverloaded(
                'request shed: endpoint draining for scale-in%s'
                % (' (request %s)' % req.request_id
                   if req.request_id else '')))

    def _drain_on_close(self, waiting):
        err = RuntimeError('DecodingPredictor closed')
        for req in self._active_requests():
            self._release(req)
            req.stream._fail(err)
        for req in waiting:
            with self.stats._lock:
                self.stats.queue_depth -= 1
            req.stream._fail(err)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not _STOP and req is not _WAKE:
                with self.stats._lock:
                    self.stats.queue_depth -= 1
                req.stream._fail(err)

    def _expire(self, waiting):
        now = time.perf_counter()
        # waiting requests: reap expired or cancelled ones before they cost
        # device work
        alive = deque()
        for req in waiting:
            cancelled = req.stream._cancelled
            if cancelled or (req.deadline is not None
                             and now > req.deadline):
                with self.stats._lock:
                    self.stats.queue_depth -= 1
                    if not cancelled:
                        self.stats.expired += 1
                if cancelled:
                    req.stream._fail(RuntimeError('request cancelled'))
                else:
                    self.stats.record_failure(req.request_id, 'expired')
                    req.stream._fail(DeadlineExceeded(
                        'request expired after %.1f ms in queue%s'
                        % ((now - req.t_submit) * 1e3,
                           ' (request %s)' % req.request_id
                           if req.request_id else '')))
            else:
                alive.append(req)
        waiting.clear()
        waiting.extend(alive)
        # active requests: a deadline that passes mid-decode frees the
        # slot(s) at this step boundary
        for req in self._active_requests():
            if req.stream._cancelled or (req.deadline is not None
                                         and now > req.deadline):
                self._release(req)
                if req.stream._cancelled:
                    req.stream._fail(RuntimeError('request cancelled'))
                else:
                    with self.stats._lock:
                        self.stats.expired += 1
                    self.stats.record_failure(req.request_id, 'expired')
                    req.stream._fail(DeadlineExceeded(
                        'deadline elapsed mid-decode after %d token(s); '
                        'slot freed%s'
                        % (req.produced,
                           ' (request %s)' % req.request_id
                           if req.request_id else '')))

    def _admit(self, waiting):
        """Strict-FIFO admission at the step boundary: one prefill
        dispatch per admitted request; a beam request waits for enough
        free slots."""
        while waiting:
            req = waiting[0]
            need = req.beam or 1
            free = self._free_slots()
            if len(free) < need:
                return
            waiting.popleft()
            with self.stats._lock:
                self.stats.queue_depth -= 1
            req.slots = free[:need]
            try:
                self._prefill(req)
            except Exception as e:
                # a failed dispatch may have left the cache half written:
                # recover as from a step failure (fail the co-resident
                # requests, rebuild a zero cache)
                self._release(req)
                req.stream._fail(e)
                self._fail_all(e, waiting)
                return

    def _prefill(self, req):
        plen = int(req.prompt.size)
        bucket = select_bucket(self._buckets, plen)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = req.prompt
        logits = self._dispatch_prefill(bucket, padded, plen, req.slots[0])
        for i, s in enumerate(req.slots):
            self._slots[s] = (req, i)
        self._first_token(req, logits)

    def _first_token(self, req, logits):
        """Emit a request's first token from its prompt logits: greedy
        argmax, or the top-W distinct tokens seeding a beam group (the
        standard first expansion; W*V candidates over identical beams would
        collapse onto one token). The beam's other slots take slot 0's
        cache rows by a reorder."""
        now = time.perf_counter()
        if req.beam is None:
            tok = int(np.argmax(logits))
            req.last_tokens = [tok]
            req.tokens = [tok]
            req.produced = 1
            self._record_emit(req, now)
            req.stream._push(tok)
            if tok == self._eos or req.produced >= req.max_new:
                self._finish_greedy(req)
            return
        if len(req.slots) > 1:
            src = np.arange(self._S, dtype=np.int64)
            for s in req.slots[1:]:
                src[s] = req.slots[0]
            self._dispatch_reorder(src)
        lp = _log_softmax(logits)
        order = np.argsort(-lp, kind='stable')[:req.beam]
        req.last_tokens = [int(t) for t in order]
        req.scores = [float(lp[t]) for t in order]
        req.finished = [int(t) == self._eos for t in order]
        req.hyps = [[int(t)] for t in order]
        req.produced = 1
        self._record_emit(req, now, count=req.beam)
        if all(req.finished) or req.produced >= req.max_new:
            self._finish_beam(req)

    def _advance_greedy(self, req, logits, now):
        """Emit the argmax token; finish on eos or max_new."""
        tok = int(np.argmax(logits[req.slots[0]]))
        req.last_tokens[0] = tok
        req.tokens.append(tok)
        req.produced += 1
        self._record_emit(req, now)
        req.stream._push(tok)
        if tok == self._eos or req.produced >= req.max_new:
            self._finish_greedy(req)

    def _score_beam(self, req, logits):
        """Fixed-width beam candidate scoring (a finished beam contributes
        one frozen eos candidate): updates scores, hyps, finished and
        last_tokens, and returns each new beam's parent."""
        W, V = req.beam, self._vocab
        cand = np.full((W, V), -np.inf, np.float64)
        for i in range(W):
            if req.finished[i]:
                cand[i, self._eos] = req.scores[i]
            else:
                cand[i] = req.scores[i] + _log_softmax(
                    logits[req.slots[i]])
        order = np.argsort(-cand, axis=None, kind='stable')[:W]
        parents = order // V
        toks = order % V
        req.scores = [float(cand[p, t]) for p, t in zip(parents, toks)]
        req.hyps = [req.hyps[p] + [int(t)]
                    for p, t in zip(parents, toks)]
        req.finished = [req.finished[p] or int(t) == self._eos
                        for p, t in zip(parents, toks)]
        req.last_tokens = [int(t) for t in toks]
        return parents

    def _record_emit(self, req, now, count=1):
        with self.stats._lock:
            self.stats.tokens += count
            if req.t_first is None:
                req.t_first = now
                self.stats._ttft.append(now - req.t_submit)
            else:
                self.stats._itl.append(now - req.t_last)
        req.t_last = now

    def _finish_greedy(self, req):
        self._release(req)
        with self.stats._lock:
            self.stats.requests += 1
        req.stream._finish(list(req.tokens))

    def _finish_beam(self, req):
        self._release(req)
        with self.stats._lock:
            self.stats.requests += 1
        ids = np.asarray(req.hyps, np.int64)
        scores = np.asarray(req.scores, np.float64)
        req.stream._finish((ids, scores))

    def _step(self):
        """One iteration of the continuous batch: every active slot
        advances one token through one fixed-shape dispatch. Idle slots
        feed token 0 at position 0 of their own rows, which the next
        prefill into that slot overwrites before any mask admits them."""
        tokens = np.zeros((self._S, 1), np.int64)
        pos = np.zeros((self._S, 1), np.int32)
        active = 0
        for s, entry in enumerate(self._slots):
            if entry is None:
                continue
            req, bi = entry
            active += 1
            tokens[s, 0] = req.last_tokens[bi]
            # this token writes at position len(prompt) + produced - 1
            pos[s, 0] = req.prompt.size + req.produced - 1
        with self.stats._lock:
            self.stats.active_slot_steps += active
            self.stats.slot_steps += self._S
        logits = self._dispatch_step(tokens, pos)
        now = time.perf_counter()
        src = np.arange(self._S, dtype=np.int64)
        for req in self._active_requests():
            if req.beam is None:
                self._advance_greedy(req, logits, now)
                continue
            parents = self._score_beam(req, logits)
            for i in range(req.beam):
                src[req.slots[i]] = req.slots[parents[i]]
            req.produced += 1
            self._record_emit(req, now, count=req.beam)
            if all(req.finished) or req.produced >= req.max_new:
                self._finish_beam(req)
                for s in req.slots:   # a finished group never reorders
                    src[s] = s
        if not np.array_equal(src, np.arange(self._S)):
            # one slot-row copy for every surviving beam group: each beam's
            # cache follows its parent before the next step writes
            self._dispatch_reorder(src)

    def _fail_all(self, exc, waiting=()):
        """A dispatch failure mid-step may have left the cache half
        written: fail every in-flight request loudly and rebuild a zero
        cache so the endpoint keeps serving. If even the rebuild fails,
        the endpoint closes itself: queued and later requests fail fast
        instead of hanging on a dead scheduler."""
        for req in self._active_requests():
            self._release(req)
            req.stream._fail(exc)
        try:
            self._reset_state()
        except Exception as e:
            warnings.warn(
                'DecodingPredictor: state rebuild after a dispatch failure '
                'itself failed (%s: %s) — closing the endpoint'
                % (type(e).__name__, e), RuntimeWarning)
            # on the scheduler thread: close() skips the self-join; the
            # loop fails the queued requests when it sees _STOP
            self.close()


def load_decoding(artifact_dir, **kwargs):
    return DecodingPredictor(artifact_dir, **kwargs)
