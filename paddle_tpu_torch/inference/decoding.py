"""Continuous in-flight batching for autoregressive decode (ref:
paddle_tpu/inference/decoding.py).

`DecodingPredictor` serves an `export_decode` artifact as a token-streaming
endpoint: iteration-level scheduling over a preallocated KV cache, in one
of two layouts.

1. **Fixed-shape programs.** Slot layout: a prefill program per
   prompt-length bucket (one request: writes the prompt's K/V rows into
   one cache slot and returns its first-token logits) and one decode-step
   program ([max_slots] requests advance one token each). Idle slots are
   masked by each slot's own attention window, so a partly full batch runs
   the same shapes. Block layout: the cache is a pool of blocks each slot
   addresses through a block table the scheduler feeds every dispatch
   (inference/kv_blocks.py keeps the refcounts); a prompt admits through
   chunked-prefill programs, one fixed-size slice a scheduler tick
   interleaved with the running batch's steps, up to the cache length.
2. **Iteration-level scheduling.** New requests join the running batch at
   step boundaries; a finished sequence (eos or max_new_tokens) frees its
   slot at once for the next waiting request. Admission is strict FIFO.
3. **The cache in place.** The cache vars live in the predictor's Scope
   across programs; the KV ops write into them in place
   (ops/decode_ops.py). A slot-layout beam reorder is an index copy over
   the slot axis. In the block layout a beam fork copies the parent's
   table and increfs it, a reorder permutes tables, and the first write
   into a shared block copies that block first (copy on write, an index
   copy over the pool's block axis); the full blocks of a prefilled prompt
   publish to a prefix cache, and a request with the same prefix maps
   them into its table and skips their prefill. When the pool runs out, a
   prompt that can never fit is shed with ServerOverloaded and, under
   pressure no waiting request can relieve, the youngest decoding request
   with MidStreamEvicted.
4. **Speculative decoding.** On an artifact with a verify program
   (build_decode_spec(draft_k=K)), `draft='ngram'` (NgramDrafter) or an
   object with a `draft(tokens, k)` method (e.g. DraftModelDrafter)
   proposes up to K tokens a greedy request each tick; one verify
   dispatch scores every drafted slot's K+1 rows, and longest-prefix
   acceptance against the target's argmax keeps the greedy transcript
   that of plain decode while advancing up to K+1 tokens a dispatch.
   Rejected rows sit above each slot's accepted frontier (the block layout
   also rolls its table back), so they are overwritten before any mask
   admits them. Undrafted slots ride the plain step in the same tick;
   beams never draft.
5. **Streaming futures.** `submit()` returns a `TokenStream` that yields
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

The int8 cache (an artifact of build_decode_spec(kv_cache_dtype='int8'))
serves through the same scheduler: its scale state rides beside the pages
as ordinary state vars, so every place the scheduler touches the state by
name (a slot reorder, a block copy on write, the reset) moves the scales
with their rows, and the block layout's scale pool shares the pages'
block ids (prefix sharing, rollback and the trash block need nothing
more). `tier=` picks an artifact tier (serve.resolve_tier).

Not ported yet (each raises or is left out): mesh sharding, AOT sidecars,
and the profiler's serving source.
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
from .kv_blocks import BlockManager, BlockPoolExhausted, TRASH_BLOCK
from . import serve as _serve

_STOP = object()
_WAKE = object()   # no-op queue item: rouse an idle scheduler (drain)

# -- artifact layout (export.py export_decode writes exactly this) ----------
_FORMAT = 'paddle_tpu_torch'
_DECODE_SIGNATURE = 'decode_signature.json'
_STEP_DIR = 'decode_step'
_PREFILL_DIR = 'prefill_%05d'   # % prompt-length bucket
_CHUNK_DIR = 'prefill_chunk_%05d'   # % chunk size (block layout)
_VERIFY_DIR = 'decode_verify'   # the [S, K+1] verify program
_PARAMS_DIR = 'params'
_PROGRAM_FILE = '__model__'


class MidStreamEvicted(ServerOverloaded):
    """Overload shed of a request that already dispatched device work: the
    block-pool preflight evicts the youngest decoding stream under pressure
    nothing else can relieve, after tokens may have streamed to the
    caller. A ServerOverloaded all the same, but a router must not re-route
    it blindly (a plain ServerOverloaded is shed at the door, before any
    device work)."""


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
    dispatch totals, slot occupancy, sliding windows of time to first
    token (TTFT) and inter-token latency (ITL) for percentiles, the block
    layout's gauges and the speculative acceptance counters.
    `snapshot()` returns them as one dict."""

    def __init__(self, window=8192):
        self._lock = threading.Lock()
        self._ttft = deque(maxlen=window)
        self._itl = deque(maxlen=window)
        # tagged-request failure trace (shed/expired requests that carried
        # a request_id)
        self._failures = deque(maxlen=16)
        self.tier = 'bf16'       # serving tier: 'int8' for an int8 cache
        self.queue_depth = 0
        # block layout: BlockManager.stats and reset_counters, merged into
        # snapshot() and reset(); None on slot artifacts
        self.block_source = None
        self.block_reset = None
        self.reset()

    def reset(self):
        """Zero counters and latency windows (queue_depth is a live gauge
        and stays): separates warmup from the measured run. The block
        manager's counters reset too (its pool state and prefixes stay)."""
        with self._lock:
            self._ttft.clear()
            self._itl.clear()
            self._failures.clear()
            self.requests = 0        # completed requests
            self.tokens = 0          # tokens decoded (all beams)
            self.prefills = 0        # prefill (and chunk) dispatches
            self.steps = 0           # decode-step dispatches
            self.reorders = 0        # beam reorders (slot-row copies, or
            #                          table permutations in the block layout)
            self.active_slot_steps = 0
            self.slot_steps = 0
            self.shed = 0
            self.expired = 0
            self.drained = 0         # shed by drain(): queued at scale-in
            self.busy_s = 0.0        # wall time with >= 1 active slot
            self.cow_blocks = 0      # blocks copied on write
            self.blockcopies = 0     # block-copy dispatches
            self.chunk_slices = 0    # chunked-prefill slice dispatches
            # speculative decoding; adv_* count the tokens a
            # request-advancing dispatch delivered (a prefill's first
            # token, a plain or beam step, a verify tick), so
            # tokens_per_dispatch is exactly 1.0 without drafting
            self.verify_steps = 0    # verify dispatches
            self.drafted = 0         # draft tokens proposed to the verifier
            self.accepted = 0        # draft tokens accepted
            self.draft_errors = 0    # drafter calls that raised (the
            #                          request rode a plain step instead)
            self.adv_tokens = 0
            self.adv_events = 0
            if self.block_reset is not None:
                self.block_reset()

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
            snap = {'kind': 'decode',
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
                    'verify_steps': int(self.verify_steps),
                    'drafted': int(self.drafted),
                    'accepted': int(self.accepted),
                    'draft_errors': int(self.draft_errors),
                    'acc_rate': round(self.accepted / self.drafted, 4)
                    if self.drafted else 1.0,
                    'tokens_per_dispatch':
                        round(self.adv_tokens / self.adv_events, 4)
                        if self.adv_events else 1.0,
                    'recent_failures': list(self._failures)}
            if self.block_source is None:
                return snap
            snap['cow_blocks'] = int(self.cow_blocks)
            snap['blockcopies'] = int(self.blockcopies)
            snap['chunk_slices'] = int(self.chunk_slices)
        # outside the stats lock: the BlockManager takes its own
        bs = self.block_source()
        snap['blocks_in_use'] = int(bs['blocks_in_use'])
        snap['blocks_peak'] = int(bs['blocks_peak'])
        snap['blocks_total'] = int(bs['num_blocks'])
        snap['prefix_hits'] = int(bs['prefix_hits'])
        snap['prefix_hit_rate'] = float(bs['prefix_hit_rate'])
        snap['prefix_tokens_reused'] = int(bs['prefix_tokens_reused'])
        snap['block_evictions'] = int(bs['evictions'])
        return snap


class TokenStream(object):
    """Per-request streaming future. Greedy requests: iterate to receive
    tokens as decode steps complete (`for tok in stream: ...`), or call
    `result()` for the full generated id list (eos included when
    emitted). Beam requests: `result()` -> (ids [beam, n_tokens] int64,
    scores [beam] float64), hypotheses best first; iteration yields
    nothing until completion (beams reorder mid-flight).

    A speculative verify tick can deliver several tokens at once; they
    queue as one batch: `__iter__` still yields a token at a time, and
    `batches()` one list a delivery."""

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
        """Yield token delivery batches: one list a delivery (a plain
        step's singleton, or every token a verify tick advanced)."""
        while True:
            kind, payload = self._q.get()
            if kind == 'tok':
                yield [payload]
            elif kind == 'toks':
                yield payload
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

    def _push_many(self, toks):
        """One queue entry for a verify tick's whole advance."""
        self._q.put(('toks', [int(t) for t in toks]))

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


class NgramDrafter(object):
    """Host-side n-gram (prompt-lookup) drafter: propose the continuation
    that followed the most recent earlier occurrence of the request's
    longest matching suffix, in its own transcript (prompt and generated
    tokens). No device work and no artifact of its own; on text that does
    not repeat it proposes nothing and the slot rides the plain step.
    `max_ngram` is the longest suffix tried (longest first), `min_ngram`
    the shortest worth trusting."""

    def __init__(self, max_ngram=3, min_ngram=1):
        if not 1 <= int(min_ngram) <= int(max_ngram):
            raise ValueError('need 1 <= min_ngram <= max_ngram')
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def draft(self, tokens, k):
        """tokens: 1-D int array, the transcript so far. Returns up to `k`
        proposed next tokens (possibly none)."""
        toks = np.asarray(tokens, np.int64).reshape(-1)
        n = toks.size
        if n < 2 or k < 1:
            return []
        for ng in range(min(self.max_ngram, n - 1),
                        self.min_ngram - 1, -1):
            suffix = toks[n - ng:]
            # hit[s] <=> toks[s:s+ng] == suffix, for every window start
            # before the suffix's own
            hit = toks[:n - ng] == suffix[0]
            for j in range(1, ng):
                hit = hit & (toks[j:n - ng + j] == suffix[j])
            starts = np.flatnonzero(hit)
            if starts.size:
                # past the transcript's end the proposal extends
                # periodically, so a transcript in a cycle gives full-k
                # proposals even when the match sits near the end
                s = int(starts[-1])
                d = (n - ng) - s
                out = []
                for i in range(k):
                    j = n + i - d
                    out.append(int(toks[j]) if j < n else out[i - d])
                return out
        return []


class DraftModelDrafter(object):
    """Draft-model drafter: propose continuations by greedy decode on a
    second decode endpoint (a `DecodingPredictor`, typically a smaller
    model with the same vocabulary: proposals are fed verbatim to the
    target's verify program; out-of-vocabulary ones are cut by the
    scheduler). `draft()` runs synchronously on the target's scheduler
    thread."""

    def __init__(self, predictor):
        if not callable(getattr(predictor, 'generate', None)):
            raise ValueError('DraftModelDrafter wraps a '
                             'DecodingPredictor-like object with '
                             'generate(prompt, max_new_tokens)')
        self._pred = predictor

    def draft(self, tokens, k):
        toks = np.asarray(tokens, np.int64)
        T = getattr(self._pred, '_T', None)
        if T is not None and toks.size >= int(T):
            # keep the most recent window the draft artifact can hold
            toks = toks[toks.size - int(T) + 1:]
        out = self._pred.generate(toks, max_new_tokens=int(k))
        return [int(t) for t in np.asarray(out).reshape(-1)[:k]]


class _Request(object):
    __slots__ = ('prompt', 'max_new', 'beam', 'stream', 't_submit',
                 'deadline', 'slots', 'produced', 'tokens', 'last_tokens',
                 'scores', 'finished', 'hyps', 't_first', 't_last',
                 'tables', 'next_start', 'prefilling', 'match',
                 'match_epoch', 'draft_strikes', 'draft_cooldown',
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
        # block layout
        self.tables = []                  # per beam: physical block ids
        self.next_start = 0               # next chunked-prefill position
        self.prefilling = False           # still admitting through chunks
        self.match = None                 # cached (shared blocks, covered)
        self.match_epoch = -1             # prefix_epoch the match saw
        # speculative decoding: back off after fully rejected drafts
        self.draft_strikes = 0            # consecutive all-rejected ticks
        self.draft_cooldown = 0           # plain ticks before re-drafting


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
    block_manager                            the block layout's allocator
    drain()                                  stop admitting, finish the
                                             active streams
    close()                                  stop the scheduler; waiting
                                             and in-flight requests fail
                                             with RuntimeError

    `place` is where the programs run: CUDAPlace(0) unless the caller
    passes CPUPlace(); where torch sees no card, the CUDA place raises.
    `prompt_ids`: 1-D int sequence, 1 <= len <= the largest prompt bucket
    (slot layout) or max_cache_len (block layout: chunked prefill). `beam=`
    runs fixed-width beam search (the request occupies `beam` slots);
    default greedy. Admission is strict FIFO: a beam request at the head
    waits for enough free slots (and, in the block layout, blocks).

    Speculative decoding, on an artifact exported with
    build_decode_spec(draft_k=K): `draft='ngram'` (NgramDrafter) or an
    object with a `draft(tokens, k)` method (e.g. DraftModelDrafter)
    serves greedy requests draft-and-verify with the transcripts of plain
    decode; `draft_k=` narrows the draft length a tick below K (unused
    rows ride as pads).

    `tier=` resolves an artifact tier as BatchingPredictor(tier=) does
    (serve.resolve_tier against decode_signature.json): 'int8' serves the
    int8-cache artifact exported under <artifact>/int8/; an explicit tier
    the artifact lacks raises ValueError, the PTPU_SERVE_TIER preference
    falls back to the top level. `stats.tier` is 'int8' for an int8 cache,
    else 'bf16' (the reference's name of the default tier).
    """

    def __init__(self, artifact_dir, place=None, max_queue=None,
                 default_max_new_tokens=32, stats_window=8192,
                 tier=None, draft=None, draft_k=None):
        artifact_dir = _serve.resolve_tier(artifact_dir, tier,
                                           signature=_DECODE_SIGNATURE)
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
        self._layout = self._sig.get('layout', 'slot')
        self._default_max_new = int(default_max_new_tokens)
        self._max_queue = int(max_queue) if max_queue else None
        # the verify program when the artifact has one; a drafter only on
        # request
        vsig = self._sig.get('verify')
        self._K = int(vsig['draft_k']) if vsig is not None else 0
        self._drafter = None
        self._draft_k = 0
        if draft is not None:
            if vsig is None:
                raise ValueError(
                    'draft= needs an artifact exported with a verify '
                    'program (build_decode_spec(draft_k=K)); this '
                    'artifact has none')
            self._drafter = NgramDrafter() if draft == 'ngram' else draft
            if not callable(getattr(self._drafter, 'draft', None)):
                raise ValueError("draft= must be 'ngram' or an object "
                                 "with a draft(tokens, k) method")
            self._draft_k = self._K
            if draft_k is not None:
                if not 1 <= int(draft_k) <= self._K:
                    raise ValueError('draft_k must be in [1, %d] (the '
                                     'exported verify width)' % self._K)
                self._draft_k = int(draft_k)
        self._exe = Executor(place)
        self.place = self._exe.place
        self._scope = Scope()
        self._step_prog, self._step_fetches = _load_program(
            os.path.join(artifact_dir, _STEP_DIR))
        progs = [self._step_prog]
        self._verify_prog = None
        if vsig is not None:
            self._verify_prog, self._verify_fetches = _load_program(
                os.path.join(artifact_dir, _VERIFY_DIR))
            progs.append(self._verify_prog)
        if self._layout == 'block':
            blk = self._sig['block']
            self._bs = int(blk['block_size'])
            self._nb = int(blk['num_blocks'])
            self._maxb = int(blk['max_blocks_per_slot'])
            self._trash = TRASH_BLOCK
            # prompts admit in fixed slices up to the cache length
            self._chunks = sorted(int(c) for c in self._sig['chunk_buckets'])
            self._max_prompt = self._T
            self._chunk_progs = {
                c: _load_program(os.path.join(artifact_dir, _CHUNK_DIR % c))
                for c in self._chunks}
            self._buckets = list(self._chunks)
            progs += [p for p, _ in self._chunk_progs.values()]
        else:
            # sorted once at load: select_bucket takes the smallest fit
            self._buckets = sorted(int(b)
                                   for b in self._sig['prompt_buckets'])
            self._max_prompt = self._buckets[-1]
            self._prefill_progs = {
                b: _load_program(os.path.join(artifact_dir,
                                              _PREFILL_DIR % b))
                for b in self._buckets}
            progs += [p for p, _ in self._prefill_progs.values()]
        self._load_params(os.path.join(artifact_dir, _PARAMS_DIR), progs)
        self._blocks = None
        self._slots = [None] * self._S    # slot -> (request, beam index)
        self._closed = False
        self._draining = False
        self._idle_evt = threading.Event()
        self._lifecycle = threading.Lock()
        self._queue = queue.Queue()
        self.stats = DecodeStats(stats_window)
        self.stats.tier = ('int8' if self._sig['kv_cache_dtype'] == 'int8'
                           else 'bf16')
        self._reset_state()
        self._sched_t = threading.Thread(
            target=self._sched_loop, name='ptpu-torch-decode-sched',
            daemon=True)
        self._sched_t.start()

    def _load_params(self, params_dir, progs):
        """Every parameter the signature lists, into the predictor's scope
        on its device, each resolved in the first program that has it."""
        names = set(self._sig['params'])
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

    @property
    def layout(self):
        """'slot' (contiguous rows, bucketed prefill) or 'block' (block
        pool, chunked prefill)."""
        return self._layout

    @property
    def block_manager(self):
        """The live BlockManager of a block-layout artifact (None on slot
        artifacts): its stats, and evict_all_prefixes() for an explicit
        prefix-cache clear."""
        return self._blocks

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
                    'prompt of %d tokens exceeds %s' % (
                        prompt.size,
                        'max_cache_len %d (chunked prefill admits up to '
                        'the cache length)' % self._max_prompt
                        if self._layout == 'block' else
                        'the largest compiled prompt bucket %d'
                        % self._max_prompt))
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
        """Run every program once ahead of traffic (one dispatch a prompt
        bucket or chunk size, one decode step, one all-pad verify
        dispatch: the card's first calls pick their kernels and
        allocate); the cache is zeroed afterwards. Must run before any
        submit(): it dispatches from the caller's thread, so it refuses
        once traffic has started."""
        if self.stats.queue_depth or any(s is not None for s in self._slots):
            raise RuntimeError(
                'warmup() must run before traffic: requests are queued or '
                'decoding, and a caller-thread dispatch would race the '
                'scheduler over the cache')
        tables = None
        if self._layout == 'block':
            tables = np.full((self._S, self._maxb), self._trash, np.int32)
            for c in self._chunks:
                self._dispatch_chunk(c, np.zeros((1, c), np.int64), 0, 1,
                                     tables[:1])
        else:
            for b in self._buckets:
                self._dispatch_prefill(b, np.zeros((1, b), np.int64), 1, 0)
        self._dispatch_step(np.zeros((self._S, 1), np.int64),
                            np.zeros((self._S, 1), np.int32), tables)
        if self._verify_prog is not None:
            # every row at the pad position: the writes drop (slot) or go
            # to the trash block (block)
            R = self._K + 1
            self._dispatch_verify(np.zeros((self._S, R), np.int64),
                                  np.full((self._S, R), self._pad_pos(),
                                          np.int32), tables)
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
    def _pad_pos(self):
        """A verify pad row's position: past the slot's cache (its write
        drops) or past the table's span (the trash block)."""
        return (self._maxb * self._bs if self._layout == 'block'
                else self._T)

    def _reset_state(self):
        """(Re)make the KV cache: zeros of each state entry's shape and
        dtype on the predictor's device, in its scope. The block layout
        also gets a fresh BlockManager (every table is dead by then)."""
        dev = self._exe.device
        for e in self._sig['state']:
            self._scope.set(e['name'], torch.zeros(
                tuple(e['shape']), dtype=to_torch_dtype(e['dtype']),
                device=dev))
        if self._layout == 'block':
            self._blocks = BlockManager(self._nb, self._bs)
            self.stats.block_source = self._blocks.stats
            self.stats.block_reset = self._blocks.reset_counters

    def _run(self, prog, fetches, feed):
        out, = self._exe.run(prog, feed=feed, fetch_list=fetches,
                             scope=self._scope)
        return out                                          # synced numpy

    def _dispatch_step(self, tokens, pos, tables=None):
        feed = {'tokens': tokens, 'pos': pos}
        if tables is not None:
            feed['block_tables'] = tables
        logits = self._run(self._step_prog, self._step_fetches, feed)
        with self.stats._lock:
            self.stats.steps += 1
        return logits                                      # [S, V]

    def _dispatch_verify(self, tokens, pos, tables=None):
        """One verify dispatch: tokens and pos [S, K+1] (row 0 a slot's
        pending last token, rows 1..k its draft; pad rows and slots at
        the pad position); logits [S, K+1, V]. The program writes every
        fed row's K/V; acceptance and rollback are the host's."""
        feed = {'tokens': tokens, 'pos': pos}
        if tables is not None:
            feed['block_tables'] = tables
        logits = self._run(self._verify_prog, self._verify_fetches, feed)
        with self.stats._lock:
            self.stats.verify_steps += 1
        return logits

    def _dispatch_prefill(self, bucket, padded, plen, slot):
        prog, fetches = self._prefill_progs[bucket]
        logits = self._run(prog, fetches, {
            'prompt_ids': padded,
            'prompt_len': np.full((1, 1), plen, np.int32),
            'slot': np.full((1, 1), slot, np.int32)})
        with self.stats._lock:
            self.stats.prefills += 1
        return logits[0]                                   # [V]

    def _dispatch_chunk(self, size, ids, start, take, table_row):
        """One chunked-prefill slice: `take` real rows of one prompt at
        positions start..start+take-1 (the rest of the `size` rows are
        pad) write through `table_row` [1, max_blocks]."""
        prog, fetches = self._chunk_progs[size]
        logits = self._run(prog, fetches, {
            'chunk_ids': ids,
            'start': np.full((1, 1), start, np.int32),
            'chunk_len': np.full((1, 1), take, np.int32),
            'block_table': np.asarray(table_row, np.int32)})
        with self.stats._lock:
            self.stats.prefills += 1
            self.stats.chunk_slices += 1
        return logits[0]                                   # [V]

    def _dispatch_blockcopy(self, pairs):
        """Copy on write's device half: block dst of every cache var takes
        block src's rows, for each (dst, src) physical-block pair. A dst is
        always a fresh block, never another pair's src."""
        if pairs:
            dev = self._exe.device
            dst = torch.as_tensor([d for d, _ in pairs], device=dev)
            src = torch.as_tensor([s for _, s in pairs], device=dev)
            for e in self._sig['state']:
                cache = self._scope.get(e['name'])
                cache[dst] = cache[src]
        with self.stats._lock:
            self.stats.blockcopies += 1
            self.stats.cow_blocks += len(pairs)

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
        if self._layout == 'block':
            # refcount-to-zero blocks return to the pool; blocks a prefix
            # entry (or another request) still references live on
            for t in req.tables:
                self._blocks.decref(t)
            req.tables = []
            self._drop_match(req)

    def _drop_match(self, req):
        """Release a waiting request's cached prefix-match refs (held from
        its first admission attempt, so the matched blocks cannot evict
        while it waits at the head of the queue)."""
        if req.match is not None:
            self._blocks.decref(req.match[0])
            req.match = None

    def _table_row(self, table):
        """One slot's block-table row, padded to max_blocks_per_slot with
        the trash block (pad entries are never read: attention masks j <=
        pos, and pos never reaches the pad span)."""
        row = np.full((1, self._maxb), self._trash, np.int32)
        row[0, :len(table)] = table
        return row

    def _sched_loop(self):
        waiting = deque()
        block = self._layout == 'block'
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
                (self._admit_block if block else self._admit)(waiting)
            if any(s is not None for s in self._slots):
                try:
                    if block:
                        # one prefill slice a prefilling request, then one
                        # step of the running batch: a long prompt
                        # interleaves instead of stalling every stream
                        self._prefill_tick()
                        if any(e is not None and not e[0].prefilling
                               for e in self._slots):
                            self._step_block(waiting)
                    else:
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
            self._drop_match(req)
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
            self._drop_match(req)
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
                self._drop_match(req)
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
        history: a reorder of its cache rows (slot layout), or a copy of
        its block table with an incref (block layout, no device work)."""
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
            if self._layout == 'block':
                base = req.tables[0]
                req.tables = [base] + [list(base) for _ in req.slots[1:]]
                for t in req.tables[1:]:
                    self._blocks.incref(t)
            else:
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

    # -- block layout ------------------------------------------------------
    def _admit_block(self, waiting):
        """Strict-FIFO block-layout admission: a request admits when a slot
        group and blocks for its whole prompt are available. A prefix-cache
        hit maps the shared blocks into the table and skips allocating (and
        prefilling) the covered span. The match is cached on the request
        across attempts, so its refs pin the matched blocks while the
        request waits at the head of the queue."""
        while waiting:
            req = waiting[0]
            need = req.beam or 1
            free = self._free_slots()
            if len(free) < need:
                return
            plen = int(req.prompt.size)
            if req.match is None or (not req.match[0] and req.match_epoch
                                     != self._blocks.prefix_epoch):
                # a cached hit's refs pin its blocks across attempts; a
                # cached miss holds none, so match again, but only once a
                # prefix was published since the last attempt (e.g. by the
                # in-flight request ahead of this one)
                req.match_epoch = self._blocks.prefix_epoch
                req.match = self._blocks.match_prefix(req.prompt)
            shared, covered = req.match
            try:
                fresh = self._blocks.alloc(
                    self._blocks.blocks_for(plen) - len(shared))
            except BlockPoolExhausted:
                if self._active_requests():
                    return   # the head waits for blocks to free
                # nothing running will ever free blocks: this prompt can
                # never fit, so shed it loudly instead of deadlocking
                waiting.popleft()
                self._drop_match(req)
                with self.stats._lock:
                    self.stats.queue_depth -= 1
                    self.stats.shed += 1
                self.stats.record_failure(req.request_id, 'shed')
                req.stream._fail(ServerOverloaded(
                    'KV block pool exhausted: prompt of %d token(s) needs '
                    'more blocks than the pool can free' % plen))
                continue
            waiting.popleft()
            req.match = None        # refs transferred into the table
            with self.stats._lock:
                self.stats.queue_depth -= 1
            req.tables = [list(shared) + list(fresh)]
            req.next_start = int(covered)
            req.prefilling = True
            req.slots = free[:need]
            for i, s in enumerate(req.slots):
                self._slots[s] = (req, i)

    def _prefill_tick(self):
        """One chunked-prefill slice a prefilling request: the uncovered
        prompt span (a prefix hit skips the covered span's compute and
        storage) admits in fixed-size slices, one a scheduler tick, between
        the running batch's steps. The last slice publishes the prompt's
        full blocks and emits the first token. A final slice's pad rows
        past max_cache_len write the trash block (the chunk program clamps
        their position-encoding index only)."""
        for req in self._active_requests():
            if not req.prefilling:
                continue
            plen = int(req.prompt.size)
            remaining = plen - req.next_start
            size = select_bucket(self._chunks,
                                 min(remaining, self._chunks[-1]))
            take = min(size, remaining)
            ids = np.zeros((1, size), np.int64)
            ids[0, :take] = req.prompt[req.next_start:req.next_start + take]
            logits = self._dispatch_chunk(size, ids, req.next_start, take,
                                          self._table_row(req.tables[0]))
            req.next_start += take
            if req.next_start < plen:
                continue
            req.prefilling = False
            # the partial tail block stays private: decode writes land there
            self._blocks.register_prefix(req.prompt, req.tables[0])
            self._first_token(req, logits)

    def _live_rows(self, skip=()):
        """(request, beam index, write position) of every slot that writes
        this step: decoding requests' unfinished beams (a finished beam's
        frozen candidate needs no cache write). Requests in `skip` (this
        tick's drafted ones, which advance through the verify dispatch)
        are left out."""
        rows = []
        for req in self._active_requests():
            if req.prefilling or req in skip:
                continue
            for bi in range(len(req.slots)):
                if req.beam is not None and req.finished[bi]:
                    continue
                rows.append((req, bi, int(req.prompt.size) + req.produced
                             - 1))
        return rows

    def _preflight_blocks(self, waiting, rows_fn):
        """Reserve this dispatch's exact fresh-block demand (one a block
        that must extend or copy on write across each row's write span)
        before building it, so building never unwinds half a step.
        Pressure resolves in order of severity: first release the waiting
        requests' cached prefix matches (their refs can keep prefix
        entries from evicting; a waiting request matches again when it
        admits), then shed the youngest decoding request with
        MidStreamEvicted. `rows_fn()` gives (req, beam index, position,
        span) rows; it is a callable because a shed victim's rows must
        drop out of the count."""
        while True:
            need = 0
            shared = {}
            for req, bi, p, span in rows_fn():
                table = req.tables[bi]
                for lblk in range(p // self._bs,
                                  (p + span - 1) // self._bs + 1):
                    if lblk >= len(table):
                        need += 1        # extension: always a fresh block
                    elif not self._blocks.writable(table[lblk]):
                        b = table[lblk]
                        shared[b] = shared.get(b, 0) + 1
            for b, k in shared.items():
                # k rows copy the same block in table order, each copy
                # decrefs it: the last sharer writes in place when no
                # reference beyond these k tables remains
                need += k if self._blocks.refcount(b) > k else k - 1
            if self._blocks.reserve(need):
                return
            dropped = False
            for req in waiting:
                if req.match is not None and req.match[0]:
                    self._drop_match(req)
                    dropped = True
            if dropped:
                continue     # pins released: entries may evict now
            victims = [r for r in self._active_requests()
                       if not r.prefilling]
            if not victims:
                return
            victim = max(victims, key=lambda r: r.t_submit)
            self._release(victim)
            with self.stats._lock:
                self.stats.shed += 1
            self.stats.record_failure(victim.request_id, 'evicted')
            victim.stream._fail(MidStreamEvicted(
                'evicted under KV block-pool pressure after %d token(s): '
                'pool fully pinned by older requests' % victim.produced))

    def _ensure_writable(self, req, bi, p, cow):
        """Make the block backing position p of beam `bi` exclusively owned
        before a dispatch writes it: extend the table when p enters a new
        block, copy on write when the block is shared (a beam fork or a
        prefix): the diverged block is the unit of copy, not the slot
        row. Appends the (dst, src) copy to `cow`."""
        table = req.tables[bi]
        lblk = p // self._bs
        while len(table) <= lblk:
            table.extend(self._blocks.alloc(1))
        b = table[lblk]
        if not self._blocks.writable(b):
            nb = self._blocks.alloc(1)[0]
            cow.append((nb, b))
            self._blocks.decref([b])
            table[lblk] = nb

    def _step_block(self, waiting):
        """One iteration of the continuous batch over the block pool: with
        a drafter, drafted slots ride one verify dispatch first; then the
        block copies of every copy on write dispatch together, every other
        live slot advances one token through the fixed-shape step, and a
        beam reorder is a permutation of block tables (incref and decref,
        no device work until a write diverges a shared block)."""
        drafted = self._collect_drafts()
        if drafted:
            self._verify_block(drafted, waiting)

        def rows():
            return [(r, b, p, 1) for r, b, p in self._live_rows(drafted)]
        self._preflight_blocks(waiting, rows)
        tokens = np.zeros((self._S, 1), np.int64)
        pos = np.zeros((self._S, 1), np.int32)
        tables = np.full((self._S, self._maxb), self._trash, np.int32)
        cow = []
        active = 0
        for req, bi, p in self._live_rows(drafted):
            self._ensure_writable(req, bi, p, cow)
            s = req.slots[bi]
            active += 1
            tokens[s, 0] = req.last_tokens[bi]
            pos[s, 0] = p
            table = req.tables[bi]
            tables[s, :len(table)] = table
        if not active:
            return   # every live stream drafted (or was shed)
        with self.stats._lock:
            self.stats.active_slot_steps += active
            self.stats.slot_steps += self._S
        if cow:
            self._dispatch_blockcopy(cow)
        logits = self._dispatch_step(tokens, pos, tables)
        now = time.perf_counter()
        for req in self._active_requests():
            if req.prefilling or req in drafted:
                continue
            if req.beam is None:
                self._advance_greedy(req, logits, now)
                continue
            parents = self._score_beam(req, logits)
            if any(int(p) != i for i, p in enumerate(parents)):
                old = req.tables
                new = [list(old[int(p)]) for p in parents]
                for t in new:
                    self._blocks.incref(t)
                for t in old:
                    self._blocks.decref(t)
                req.tables = new
                with self.stats._lock:
                    self.stats.reorders += 1
            req.produced += 1
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

    # -- speculative decoding ----------------------------------------------
    def _collect_drafts(self):
        """Draft collection at the tick boundary: every greedy, fully
        prefilled request asks the drafter for up to min(draft_k, its
        emission budget - 1, cache headroom) tokens. Returns {request:
        draft tokens}. An empty or failed draft rides the plain step: a
        broken drafter costs speed, never correctness (a drafter that
        raised is counted in the stats' draft_errors)."""
        if self._drafter is None:
            return {}
        drafted = {}
        for req in self._active_requests():
            if req.beam is not None or req.prefilling:
                continue
            if req.draft_cooldown > 0:
                # a request whose drafts keep being rejected rides plain
                # steps for exponentially longer stretches
                req.draft_cooldown -= 1
                continue
            p = int(req.prompt.size) + req.produced - 1
            # verify rows write positions p..p+k: p + k <= T-1, and a draft
            # of k can emit k+1 tokens, so k <= max_new - produced - 1
            k_max = min(self._draft_k, req.max_new - req.produced - 1,
                        self._T - 1 - p)
            if k_max < 1:
                continue
            ctx = np.concatenate([req.prompt,
                                  np.asarray(req.tokens, np.int64)])
            try:
                d = self._drafter.draft(ctx, k_max)
            except Exception:
                d = None
                with self.stats._lock:
                    self.stats.draft_errors += 1
            toks = []
            for t in list(d or [])[:k_max]:
                t = int(t)
                if not 0 <= t < self._vocab:
                    break   # an out-of-vocabulary proposal cannot be fed
                toks.append(t)
            if toks:
                drafted[req] = toks
        return drafted

    def _advance_spec(self, req, draft, row_logits, now):
        """Longest-prefix acceptance against the target's argmax: row i of
        `row_logits` [K+1, V] saw rows < i's tokens, so its logits are the
        plain step's while the draft prefix matches. Emit row by row until
        the draft diverges (the diverging row still gives its corrected
        token; full acceptance adds the bonus row's), or eos or max_new
        ends the request: the plain greedy transcript. Returns the emitted
        tokens."""
        k = len(draft)
        emitted = []
        for i in range(k + 1):
            g = int(np.argmax(row_logits[i]))
            emitted.append(g)
            if g == self._eos or req.produced + len(emitted) >= req.max_new:
                break
            if i == k or draft[i] != g:
                break   # row i+1 was fed a token that is not the greedy one
        accepted = sum(1 for i in range(min(len(emitted), k))
                       if draft[i] == emitted[i])
        if accepted == 0:
            req.draft_strikes += 1
            req.draft_cooldown = 1 << min(req.draft_strikes, 6)
        else:
            req.draft_strikes = 0
        req.last_tokens[0] = emitted[-1]
        req.tokens.extend(emitted)
        req.produced += len(emitted)
        with self.stats._lock:
            self.stats.drafted += k
            self.stats.accepted += accepted
        self._record_emit(req, now, count=len(emitted), events=1)
        req.stream._push_many(emitted)
        if emitted[-1] == self._eos or req.produced >= req.max_new:
            self._finish_greedy(req)
        return emitted

    def _verify_rows(self, rows, drafted, tokens, pos):
        """Fill the verify feeds of each drafted slot: row 0 its pending
        token at its write position p, rows 1..k the draft at p+1..p+k."""
        for req in rows:
            draft = drafted[req]
            s = req.slots[0]
            p = int(req.prompt.size) + req.produced - 1
            k = len(draft)
            tokens[s, 0] = req.last_tokens[0]
            tokens[s, 1:1 + k] = draft
            pos[s, :k + 1] = p + np.arange(k + 1, dtype=np.int32)
        with self.stats._lock:
            self.stats.active_slot_steps += len(rows)
            self.stats.slot_steps += self._S

    def _verify_slot(self, drafted):
        """Verify tick, slot layout: one [S, K+1] dispatch scores every
        drafted slot's pending token and draft; undrafted rows ride at pos
        = max_cache_len and write nothing. Rejected rows land above the
        accepted frontier (`produced` moves the next write back), where a
        later write overwrites them before any mask admits them."""
        R = self._K + 1
        live = self._active_requests()
        rows = [req for req in drafted if req in live]
        if not rows:
            return
        tokens = np.zeros((self._S, R), np.int64)
        pos = np.full((self._S, R), self._T, np.int32)
        self._verify_rows(rows, drafted, tokens, pos)
        logits = self._dispatch_verify(tokens, pos)
        now = time.perf_counter()
        for req in rows:
            self._advance_spec(req, drafted[req], logits[req.slots[0]], now)

    def _verify_block(self, drafted, waiting):
        """Verify tick, block layout: preflight, extend and copy on write
        every block of each drafted slot's speculative span, dispatch one
        verify program (undrafted rows ride as all-pad rows through
        trash-block tables), then roll each table back to the accepted
        frontier: blocks that cover only rejected positions free at once
        and the table extends again on demand."""
        R = self._K + 1

        def rows_fn():
            live = self._active_requests()
            return [(req, 0, int(req.prompt.size) + req.produced - 1,
                     len(d) + 1) for req, d in drafted.items()
                    if req in live]
        self._preflight_blocks(waiting, rows_fn)
        spans = rows_fn()
        if not spans:
            return   # the preflight shed every drafted stream
        cow = []
        tokens = np.zeros((self._S, R), np.int64)
        pos = np.full((self._S, R), self._pad_pos(), np.int32)
        tables = np.full((self._S, self._maxb), self._trash, np.int32)
        for req, bi, p, span in spans:
            for q in range(p, p + span):
                self._ensure_writable(req, bi, q, cow)
            table = req.tables[0]
            tables[req.slots[0], :len(table)] = table
        self._verify_rows([r for r, _, _, _ in spans], drafted, tokens, pos)
        if cow:
            self._dispatch_blockcopy(cow)
        logits = self._dispatch_verify(tokens, pos, tables)
        now = time.perf_counter()
        for req, _, _, _ in spans:
            s = req.slots[0]
            self._advance_spec(req, drafted[req], logits[s], now)
            if self._slots[s] is not None and self._slots[s][0] is req:
                # still decoding: positions 0..plen+produced-2 hold real
                # K/V (the newest token writes next tick); drop the wholly
                # speculative tail blocks
                self._blocks.rollback(
                    req.tables[0], int(req.prompt.size) + req.produced - 1)

    def _score_beam(self, req, logits):
        """Fixed-width beam candidate scoring (a finished beam contributes
        one frozen eos candidate): updates scores, hyps, finished and
        last_tokens, and returns each new beam's parent, for the layout's
        own history move (slot-row copy or block-table permutation)."""
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

    def _record_emit(self, req, now, count=1, events=None):
        """Count `count` delivered tokens over `events` advances (default
        `count`: a plain step, a beam step or a first token deliver one a
        row; a verify tick passes 1) and record TTFT or ITL."""
        with self.stats._lock:
            self.stats.tokens += count
            self.stats.adv_tokens += count
            self.stats.adv_events += count if events is None else events
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
        """One iteration of the continuous batch (slot layout): with a
        drafter, drafted slots ride one verify dispatch first, and idle in
        the plain step at the top cache position (above every active
        slot's frontier, so the garbage row is overwritten before any mask
        admits it); every other active slot advances one token through one
        fixed-shape dispatch. Idle slots feed token 0 at position 0 of
        their own rows, which the next prefill into that slot overwrites
        before any mask admits them."""
        drafted = self._collect_drafts()
        if drafted:
            self._verify_slot(drafted)
        tokens = np.zeros((self._S, 1), np.int64)
        pos = np.zeros((self._S, 1), np.int32)
        active = 0
        for s, entry in enumerate(self._slots):
            if entry is None:
                continue
            req, bi = entry
            if req in drafted:
                pos[s, 0] = self._T - 1   # advanced by the verify tick
                continue
            active += 1
            tokens[s, 0] = req.last_tokens[bi]
            # this token writes at position len(prompt) + produced - 1
            pos[s, 0] = req.prompt.size + req.produced - 1
        if not active:
            return   # every live stream drafted: no plain step
        with self.stats._lock:
            self.stats.active_slot_steps += active
            self.stats.slot_steps += self._S
        logits = self._dispatch_step(tokens, pos)
        now = time.perf_counter()
        src = np.arange(self._S, dtype=np.int64)
        for req in self._active_requests():
            if req in drafted:
                continue
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
        cache (and block manager) so the endpoint keeps serving. If even
        the rebuild fails, the endpoint closes itself: queued and later
        requests fail fast instead of hanging on a dead scheduler."""
        for req in self._active_requests():
            self._release(req)
            req.stream._fail(exc)
        for req in waiting:
            # a cached match holds block ids of the manager the rebuild
            # discards: match again against the new pool
            req.match = None
            req.match_epoch = -1
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
