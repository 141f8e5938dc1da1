"""Serving and training from an exported artifact (ref:
paddle_tpu/inference/serve.py).

`CompiledPredictor` serves an `export_compiled` artifact, `CompiledTrainer`
trains from an `export_train_step` artifact, and `main` is the command
line:

    python -m paddle_tpu_torch.inference.serve ARTIFACT_DIR IN.npz OUT.npz
    python -m paddle_tpu_torch.inference.serve loop ARTIFACT_DIR IN.npz \\
        OUT.npz [GROUP]
    python -m paddle_tpu_torch.inference.serve train ARTIFACT_DIR \\
        FEEDS.npz OUT.npz STEPS [CKPT.npz]
    python -m paddle_tpu_torch.inference.serve bench ARTIFACT_DIR IN.npz \\
        N_REQUESTS [TIMEOUT_MS]
    python -m paddle_tpu_torch.inference.serve decode ARTIFACT_DIR \\
        PROMPTS.npz OUT.npz [MAX_NEW [BEAM]]

Everything runs on CUDAPlace(0) unless `platform='cpu'` or the environment
sets PTPU_PLATFORM=cpu, as the reference reads it.

torch cannot load the reference's jax.export modules, and the port
compiles nothing: its artifacts hold the program as JSON and the
parameters once, and the Executor interprets the program
(export.py has the layout). So an artifact is not framework-free here,
there are no AOT warm-start sidecars, and every bucket of a multi-bucket
artifact runs the one program, at its own batch, over one device copy of
the parameters. Each format refuses the other package's artifacts.

Not ported yet: the int8 tier (ROADMAP.md queue 1 item 6), LoD feeds and
fetches (item 8), the profiler's serving and bulk-inference sources, and
the `fleet` and `gateway` commands (item 11).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .. import io as _io
from ..core.scope import Scope
from ..executor import Executor, _to_numpy
from ..framework import CPUPlace, CUDAPlace, to_torch_dtype

_FORMAT = 'paddle_tpu_torch'
_SIGNATURE = 'signature.json'
_PROGRAM_FILE = '__model__'
_PARAMS_DIR = 'params'
_BUCKET_DIR = 'bucket_%05d'  # per-bucket subdir of a multi-bucket artifact
_TRAIN_SIGNATURE = 'train_signature.json'
_TRAIN_PROGRAM = 'train_program.json'
_TRAIN_STATE0 = 'train_state0.npz'
# what an artifact of the JAX package holds in place of the program
_JAX_MODULES = ('module.jaxexport', 'train_module.jaxexport')


def resolve_tier(artifact_dir, tier=None, signature=_SIGNATURE):
    """The artifact directory that serves `tier` (or env PTPU_SERVE_TIER):
    'bf16' (the reference's name of the default, unquantized tier; the
    default) serves the top level; another tier its subdirectory. An
    explicit tier the artifact lacks raises; the env preference falls back
    to the default tier. The port writes no int8 tier yet (ROADMAP.md
    queue 1 item 6)."""
    req = tier or os.environ.get('PTPU_SERVE_TIER')
    if not req or req == 'bf16':
        return artifact_dir
    sub = os.path.join(artifact_dir, req)
    if os.path.isdir(sub) and os.path.exists(os.path.join(sub, signature)):
        return sub
    if tier:
        raise ValueError(
            "artifact %s has no %r tier (tiers: ['bf16']) — the port's "
            "export_compiled writes the default tier only; quantize='int8' "
            "is ROADMAP.md queue 1 item 6" % (artifact_dir, req))
    return artifact_dir


def _place(platform=None):
    """CUDAPlace(0) unless `platform` (or env PTPU_PLATFORM) is 'cpu'."""
    platform = platform or os.environ.get('PTPU_PLATFORM')
    if platform in (None, '', 'gpu', 'cuda'):
        return CUDAPlace(0)
    if platform == 'cpu':
        return CPUPlace()
    raise ValueError("platform must be 'cpu' or 'gpu' (the port runs on an "
                     "NVIDIA card or the CPU), got %r" % (platform,))


def _read_signature(artifact_dir, name=_SIGNATURE):
    """The artifact's signature; a directory the JAX package exported, or
    one that is not the port's, raises saying so."""
    for module in _JAX_MODULES:
        if os.path.exists(os.path.join(artifact_dir, module)):
            raise ValueError(
                "%s is a jax.export artifact of paddle_tpu (%s): the port "
                "interprets programs and cannot load jax.export modules; "
                "export with paddle_tpu_torch.inference.%s"
                % (artifact_dir, module, 'export_train_step'
                   if module.startswith('train') else 'export_compiled'))
    with open(os.path.join(artifact_dir, name)) as f:
        sig = json.load(f)
    if sig.get('format') != _FORMAT:
        raise ValueError("%s is not a paddle_tpu_torch artifact (format %r)"
                         % (os.path.join(artifact_dir, name),
                            sig.get('format')))
    return sig


def _load_params(params_dir, program, scope, device):
    """Every persistable of `program` that params_dir holds, into `scope`
    on `device`, checked against the save manifest. It reads the files
    directly rather than through io.load_vars, whose global-scope swap a
    serving thread must not race."""
    manifest = _io._load_manifest(params_dir)
    held = set(manifest['files']) if manifest is not None else None
    for v in program.list_vars():
        if not v.persistable or (held is not None and v.name not in held):
            continue
        raw = _io._read_verified(params_dir, v.name, manifest)
        scope.set(v.name, _io._deserialize_tensor(raw, device)[0])


class _Model(object):
    """An artifact's program and parameters, loaded once onto a place: the
    one Executor and Scope that every bucket of the artifact runs on."""

    def __init__(self, root, place):
        with open(os.path.join(root, _PROGRAM_FILE), 'rb') as f:
            desc = json.loads(f.read().decode())
        self.program = _io.program_from_dict(desc)
        self.exe = Executor(place)
        self.scope = Scope()
        _load_params(os.path.join(root, _PARAMS_DIR), self.program,
                     self.scope, self.exe.device)

    def run(self, feed, fetch_names):
        """Device tensors of the fetches, no host sync."""
        return self.exe.run(self.program, feed=feed, fetch_list=fetch_names,
                            scope=self.scope, return_numpy=False)


def _build_args(sig_feeds, feed_names, inputs, allow_pad=False):
    """Normalize list-or-dict inputs against the artifact signature:
    feed-order list of numpy arrays, dtype cast, fixed-shape check. Shared
    by CompiledPredictor.run and CompiledTrainer.step.

    With allow_pad, a PARTIAL dense batch — every feed arriving with the
    same rows r below the artifact's (uniform) leading batch dim B — is
    zero-padded up to B. Returns (args, pad) where pad is None or (rows,
    B), so the caller can slice batch-led fetches back to r (and error
    loudly on row-count-dependent fetches)."""
    if isinstance(inputs, (list, tuple)):
        if len(inputs) != len(feed_names):
            raise ValueError("artifact expects %d inputs (%s), got %d"
                             % (len(feed_names), feed_names, len(inputs)))
        feed = dict(zip(feed_names, inputs))
    else:
        feed = dict(inputs)
    missing = [e['name'] for e in sig_feeds if e['name'] not in feed]
    if missing:
        raise ValueError("missing feeds: %r (artifact expects %s)"
                         % (missing, feed_names))
    arrs = [np.asarray(feed[e['name']], dtype=np.dtype(e['dtype']))
            for e in sig_feeds]
    pad = None
    if allow_pad and arrs and all(
            e['shape'] and a.ndim == len(e['shape'])
            and list(a.shape[1:]) == e['shape'][1:]
            for e, a in zip(sig_feeds, arrs)):
        expect = {int(e['shape'][0]) for e in sig_feeds}
        got = {int(a.shape[0]) for a in arrs}
        if len(expect) == 1 and len(got) == 1:
            bucket, rows = expect.pop(), got.pop()
            if 0 < rows < bucket:
                pad = (rows, bucket)
    args = []
    for e, arr in zip(sig_feeds, arrs):
        if pad is not None and arr.shape[0] == pad[0]:
            arr = np.concatenate(
                [arr, np.zeros((pad[1] - pad[0],) + arr.shape[1:],
                               arr.dtype)], axis=0)
        if list(arr.shape) != e['shape']:
            raise ValueError(
                "feed %r: expected shape %s (artifacts serve fixed shapes), "
                "got %s" % (e['name'], e['shape'], list(arr.shape)))
        args.append(arr)
    return args, pad


def _fetch_entries(sig):
    """Fetch signature entries across artifact versions: v1 stored plain
    names, v2 {name, lod_levels}, v3 adds the shape."""
    return [{'name': f, 'lod_levels': 0} if isinstance(f, str) else f
            for f in sig['fetches']]


def _stack_to_device(arrays, device, rows=None):
    """`arrays` in one host buffer and one host-to-device copy: stacked on
    a new leading axis, or, given `rows`, concatenated along axis 0 and
    zero-padded to `rows` rows (the batcher's coalesced batch). On a card
    the buffer is pinned and copies with non_blocking=True; torch's caching
    host allocator keeps it until that copy is done, so every call takes a
    fresh one."""
    first = arrays[0]
    if rows is None:
        shape = (len(arrays),) + first.shape
    else:
        shape = (rows,) + first.shape[1:]
    pin = device.type == 'cuda'
    buf = torch.empty(shape, dtype=torch.from_numpy(first[:0]).dtype,
                      pin_memory=pin)
    view = buf.numpy()
    if rows is None:
        np.stack(arrays, out=view)
    else:
        filled = sum(a.shape[0] for a in arrays)
        np.concatenate(arrays, out=view[:filled])
        view[filled:] = 0
    return buf.to(device, non_blocking=True) if pin else buf


class CompiledPredictor(object):
    """PaddlePredictor-shaped API over an exported artifact: the port's
    counterpart of paddle_tpu/inference/serve.py:491.

    `platform` (or env PTPU_PLATFORM) picks the device: the card unless
    it is 'cpu'. A bucket directory of a multi-bucket artifact loads on
    its own; its program and parameters are the artifact root's."""

    def __init__(self, artifact_dir, platform=None, tier=None, _model=None):
        artifact_dir = resolve_tier(artifact_dir, tier)
        self._sig = _read_signature(artifact_dir)
        self.tier = self._sig.get('tier', 'bf16')
        for e in self._sig['feeds']:
            if int(e.get('lod_levels', 0)):
                raise NotImplementedError(
                    "feed %r carries a LoD: LoD artifacts are not ported "
                    "yet (ROADMAP.md queue 1 item 8)" % e['name'])
        self._feed_names = [e['name'] for e in self._sig['feeds']]
        self._fetch_names = [e['name'] for e in _fetch_entries(self._sig)]
        root = os.path.normpath(os.path.join(artifact_dir,
                                             self._sig.get('root', '.')))
        self._model = _model if _model is not None else _Model(
            root, _place(platform))
        self.place = self._model.exe.place
        self._device = self._model.exe.device
        self._bulk = {'dispatches': 0, 'batches': 0, 'tail_flushes': 0,
                      'stage_s': 0.0, 'dispatch_s': 0.0, 'total_s': 0.0}
        self._artifact_dir = artifact_dir

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def drain(self):
        """Scale-in hook: a CompiledPredictor holds no queue and no work
        beyond the caller's own run(), so draining is a no-op."""
        return self

    def _call_flat(self, args):
        """Run the program on args (feed order; numpy arrays or tensors,
        on the device or not); returns the fetches as device tensors
        without a host sync, so an async serving loop (the batcher's
        delivery thread) syncs once."""
        return self._model.run(dict(zip(self._feed_names, args)),
                               self._fetch_names)

    def run(self, inputs, pad_partial=True):
        """inputs: list (feed order) or dict name -> array. Returns a list
        with a numpy array per fetch.

        A PARTIAL batch (every feed with the same rows r below the
        artifact's batch dim B) is zero-padded up to B and batch-led
        fetches are sliced back to r; fetches whose leading dim is NOT the
        batch (a batch reduction: their value depends on the padded row
        count) error loudly, ahead of the run when the signature records
        fetch shapes (v3) and after it otherwise. A shape-preserving
        cross-row op (x - mean(x, axis=0)) cannot be seen from shapes:
        pass pad_partial=False for the strict fixed-shape rejection."""
        args, pad = _build_args(self._sig['feeds'], self._feed_names,
                                inputs, allow_pad=pad_partial)
        if pad is not None:
            self._check_pad_fetches(pad)
        outs = [_to_numpy(t) for t in self._call_flat(args)]
        if pad is None:
            return outs
        return self._slice_pad(outs, pad)

    def _check_pad_fetches(self, pad):
        """Rejection of row-count-dependent fetches ahead of the run, where
        the signature records fetch shapes (v3)."""
        for e in _fetch_entries(self._sig):
            shape = e.get('shape')
            if shape is not None and (not shape or int(shape[0]) != pad[1]):
                raise ValueError(
                    "feed rows were padded %d->%d but fetch %r (shape "
                    "%s in the signature) is not batch-aligned — its "
                    "value would depend on the padded rows; run with "
                    "the exact batch" % (pad + (e['name'], shape)))

    def _slice_pad(self, outs, pad):
        """Batch-led fetches of a padded partial batch sliced back to the
        caller's rows; the check after the run for v2 signatures."""
        rows, bucket = pad
        sliced = []
        for e, o in zip(_fetch_entries(self._sig), outs):
            if o.ndim < 1 or o.shape[0] != bucket:
                raise ValueError(
                    "feed rows were padded %d->%d but fetch %r has shape "
                    "%s — not batch-aligned, its value depends on the "
                    "padded row count (e.g. a batch reduction); run with "
                    "the exact batch" % (rows, bucket, e['name'],
                                         list(o.shape)))
            sliced.append(o[:rows])
        return sliced

    # -- bulk inference: K batches a group ---------------------------------
    def bulk_stats(self):
        """Bulk-inference counters, the reference's keys: dispatches,
        batches, batches_per_dispatch, tail_flushes, host_stall_ms
        (staging: stacking and enqueueing the host-to-device copy),
        occupancy (the runs' share of run_batches wall time)."""
        st = self._bulk
        d = max(st['dispatches'], 1)
        return {'dispatches': st['dispatches'], 'batches': st['batches'],
                'batches_per_dispatch': st['batches'] / d,
                'tail_flushes': st['tail_flushes'],
                'host_stall_ms': st['stage_s'] * 1e3,
                'occupancy': (st['dispatch_s'] / st['total_s']
                              if st['total_s'] else 0.0)}

    def run_batches(self, batches, group=None, pad_partial=True):
        """Bulk offline/eval inference over K batches, each a list (feed
        order) or dict as `run()` takes it (a partial batch pads under
        `pad_partial`, as in run()). Each group of at most `group` batches
        (default: all K) is staged once — one np.stack per feed and one
        host-to-device copy — then runs through Executor.run_steps, and
        its fetches come back with one sync. Per-batch results equal K
        `run()` calls bit for bit. Returns K per-batch fetch lists."""
        t_all = time.perf_counter()
        batches = list(batches)
        if not batches:
            return []
        k = len(batches)
        g = k if group is None else int(group)
        if g < 1:
            raise ValueError("run_batches: group must be >= 1, got %d" % g)
        st = self._bulk
        t0 = time.perf_counter()
        flat, pads = [], []
        for b in batches:
            args, pad = _build_args(self._sig['feeds'], self._feed_names,
                                    b, allow_pad=pad_partial)
            if pad is not None:
                self._check_pad_fetches(pad)
            flat.append(args)
            pads.append(pad)
        st['stage_s'] += time.perf_counter() - t0
        try:
            return self._run_chunks(flat, pads, k, g)
        finally:
            # total accrues even when a chunk raises, so occupancy stays
            # <= 1
            st['total_s'] += time.perf_counter() - t_all

    def _run_chunks(self, flat, pads, k, g):
        st = self._bulk
        model = self._model
        results = []
        for off in range(0, k, g):
            chunk = flat[off:off + g]
            m = len(chunk)
            t0 = time.perf_counter()
            staged = {n: _stack_to_device([c[j] for c in chunk],
                                          self._device)
                      for j, n in enumerate(self._feed_names)}
            t1 = time.perf_counter()
            ys = model.exe.run_steps(model.program, feed=staged,
                                     fetch_list=self._fetch_names,
                                     scope=model.scope, fetch_policy='stack',
                                     return_numpy=False)
            ys = [_to_numpy(y) for y in ys]  # one sync per group
            t2 = time.perf_counter()
            st['dispatches'] += 1
            st['batches'] += m
            if m < g and off > 0:
                st['tail_flushes'] += 1
            st['stage_s'] += t1 - t0
            st['dispatch_s'] += t2 - t1
            for i in range(m):
                outs = [y[i] for y in ys]
                pad = pads[off + i]
                results.append(outs if pad is None
                               else self._slice_pad(outs, pad))
        return results


def load_compiled(artifact_dir, tier=None, platform=None):
    return CompiledPredictor(artifact_dir, platform=platform, tier=tier)


class CompiledTrainer(object):
    """Training from an export_train_step artifact (ref:
    paddle_tpu/inference/serve.py:785). The state lives in the trainer's
    Scope on its device between steps (never through numpy), and a step
    counter feeds the per-step random draws as the Executor's own counter
    does, so losses and state equal Executor.run steps on the exported
    program bit for bit. `seed` overrides the artifact's."""

    def __init__(self, artifact_dir, platform=None, seed=None):
        self._sig = _read_signature(artifact_dir, _TRAIN_SIGNATURE)
        with open(os.path.join(artifact_dir, _TRAIN_PROGRAM), 'rb') as f:
            self._program = _io.program_from_dict(
                json.loads(f.read().decode()))
        # the AMP mark and the seed root are not in the program's JSON
        self._program._amp_bf16 = bool(self._sig['amp_bf16'])
        self._seed = int(self._sig['rng']['seed'] if seed is None else seed)
        self._program.random_seed = self._seed
        self._exe = Executor(_place(platform))
        self.place = self._exe.place
        self._scope = Scope()
        self._state_names = [e['name'] for e in self._sig['state']]
        self._feed_names = [e['name'] for e in self._sig['feeds']]
        with np.load(os.path.join(artifact_dir, _TRAIN_STATE0)) as z:
            self._set_state(z)
        self._step_count = 0

    def _set_state(self, z):
        dev = self._exe.device
        for e in self._sig['state']:
            self._scope.set(e['name'], torch.from_numpy(
                np.array(z[e['name']])).to(
                    device=dev, dtype=to_torch_dtype(e['dtype'])))

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._sig['fetches'])

    @property
    def state(self):
        """The current state as {name: numpy array} (a checkpoint)."""
        return {n: _to_numpy(self._scope.get(n)) for n in self._state_names}

    def step(self, inputs):
        """Run one train step. inputs: list (feed order) or dict. Advances
        the carried state and the step counter; returns numpy fetches.
        Strict shapes: a train step never pads (padded rows would corrupt
        the loss and every batch statistic)."""
        args, _ = _build_args(self._sig['feeds'], self._feed_names, inputs)
        self._exe._step_counters[self._program._uid] = self._step_count
        outs = self._exe.run(self._program,
                             feed=dict(zip(self._feed_names, args)),
                             fetch_list=self.get_output_names(),
                             scope=self._scope)
        self._step_count += 1
        return outs

    def save_state(self, path):
        """Checkpoint the state and the step counter (a resumed trainer
        continues the same random stream), in train_state0.npz's format."""
        np.savez(path, __step_count__=np.int64(self._step_count),
                 **self.state)

    def load_state(self, path):
        with np.load(path) as z:
            missing = [n for n in self._state_names if n not in z.files]
            if missing:
                raise ValueError("checkpoint missing state vars: %r"
                                 % missing)
            self._set_state(z)
            # a checkpoint without a counter (train_state0.npz) restarts
            # at step 0: keeping the old counter would shift the random
            # stream off the trajectory
            self._step_count = (int(z['__step_count__'])
                                if '__step_count__' in z.files else 0)


def load_trainer(artifact_dir, platform=None, seed=None):
    return CompiledTrainer(artifact_dir, platform=platform, seed=seed)


# -- command line -------------------------------------------------------------
def _bench_cli(argv):
    # bench ARTIFACT_DIR IN.npz N_REQUESTS [TIMEOUT_MS]: IN.npz replayed N
    # times through the batcher, beside a sequential one-run-per-request
    # arm; prints throughput and latency percentiles, the last line JSON
    if len(argv) not in (5, 6):
        print("usage: serve.py bench ARTIFACT_DIR IN.npz N_REQUESTS "
              "[TIMEOUT_MS]", file=sys.stderr)
        return 2
    from . import batching
    artifact_dir, in_path, n = argv[2], argv[3], int(argv[4])
    timeout_ms = float(argv[5]) if len(argv) == 6 else 5.0
    with np.load(in_path) as z:
        feed = {k: z[k] for k in z.files}
    rows = int(next(iter(feed.values())).shape[0])

    batcher = batching.BatchingPredictor(artifact_dir,
                                         batch_timeout_ms=timeout_ms)
    batcher.warmup()
    seq = CompiledPredictor(artifact_dir)
    k = min(n, 8)
    seq.run(feed)  # warm
    t0 = time.perf_counter()
    for _ in range(k):
        seq.run(feed)
    seq_req_s = k / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    futs = [batcher.submit(feed) for _ in range(n)]
    for f in futs:
        f.result()
    wall = time.perf_counter() - t0
    snap = batcher.stats.snapshot()
    batcher.close()
    req_s = n / wall
    print("buckets=%s requests=%d rows/request=%d" %
          (batcher.buckets, n, rows))
    print("batched:    %10.1f req/s  %10.1f rows/s  (%d batches, "
          "occupancy %.2f)" % (req_s, req_s * rows, snap['batches'],
                               snap['occupancy']))
    print("sequential: %10.1f req/s  %10.1f rows/s  (CompiledPredictor."
          "run per request)" % (seq_req_s, seq_req_s * rows))
    print("latency ms: p50=%.2f p95=%.2f p99=%.2f" %
          (snap['p50_ms'], snap['p95_ms'], snap['p99_ms']))
    print(json.dumps({'req_s': round(req_s, 2),
                      'rows_s': round(req_s * rows, 2),
                      'seq_req_s': round(seq_req_s, 2),
                      'speedup': round(req_s / seq_req_s, 2),
                      'occupancy': snap['occupancy'],
                      'p50_ms': snap['p50_ms'], 'p95_ms': snap['p95_ms'],
                      'p99_ms': snap['p99_ms']}))
    return 0


def _loop_cli(argv):
    # loop ARTIFACT_DIR IN.npz OUT.npz [GROUP]: IN.npz arrays carry a
    # leading K batch axis; the K batches run through run_batches and
    # OUT.npz holds each fetch stacked over the same K axis
    if len(argv) not in (5, 6):
        print("usage: serve.py loop ARTIFACT_DIR IN.npz OUT.npz [GROUP]",
              file=sys.stderr)
        return 2
    artifact_dir, in_path, out_path = argv[2:5]
    group = int(argv[5]) if len(argv) == 6 else None
    pred = CompiledPredictor(artifact_dir)
    with np.load(in_path) as data:
        raw = {k: data[k] for k in data.files}
    k = int(next(iter(raw.values())).shape[0])
    batches = [{n: raw[n][i] for n in pred.get_input_names()}
               for i in range(k)]
    results = pred.run_batches(batches, group=group)
    np.savez(out_path, **{n: np.stack([r[j] for r in results])
                          for j, n in enumerate(pred.get_output_names())})
    return 0


def _train_cli(argv):
    # train ARTIFACT_DIR FEEDS.npz OUT.npz STEPS [CKPT.npz]: STEPS steps
    # on the (fixed) feeds; OUT.npz holds each fetch stacked over the
    # steps, CKPT.npz (optional) the final state
    if len(argv) not in (6, 7):
        print("usage: serve.py train ARTIFACT_DIR FEEDS.npz OUT.npz STEPS "
              "[CKPT.npz]", file=sys.stderr)
        return 2
    artifact_dir, in_path, out_path, steps = argv[2:6]
    trainer = CompiledTrainer(artifact_dir)
    with np.load(in_path) as data:
        feed = {k: data[k] for k in data.files}
    per_step = [trainer.step(feed) for _ in range(int(steps))]
    np.savez(out_path, **{
        n: np.stack([s[i] for s in per_step])
        for i, n in enumerate(trainer.get_output_names())})
    if len(argv) == 7:
        trainer.save_state(argv[6])
    return 0


def _decode_cli(argv):
    # decode ARTIFACT_DIR PROMPTS.npz OUT.npz [MAX_NEW [BEAM]]:
    # PROMPTS.npz 'prompts' [N, L] int64 (0-padded) and optionally 'lens'
    # [N]; OUT.npz 'tokens' [N, MAX_NEW] (-1 after each transcript) and
    # 'n_tokens' [N], with BEAM the best hypothesis and 'scores' [N]
    if len(argv) not in (5, 6, 7):
        print("usage: serve.py decode ARTIFACT_DIR PROMPTS.npz OUT.npz "
              "[MAX_NEW [BEAM]]", file=sys.stderr)
        return 2
    from .decoding import DecodingPredictor
    artifact_dir, in_path, out_path = argv[2:5]
    max_new = int(argv[5]) if len(argv) >= 6 else 32
    beam = int(argv[6]) if len(argv) == 7 else None
    with np.load(in_path) as z:
        prompts = np.asarray(z['prompts'], np.int64)
        lens = (np.asarray(z['lens'], np.int64) if 'lens' in z.files
                else np.full(prompts.shape[0], prompts.shape[1], np.int64))
    with DecodingPredictor(artifact_dir, place=_place()) as pred:
        streams = [pred.submit(prompts[i, :lens[i]], max_new_tokens=max_new,
                               beam=beam) for i in range(prompts.shape[0])]
        results = [s.result() for s in streams]
        snap = pred.stats.snapshot()
    toks = np.full((len(results), max_new), -1, np.int64)
    n_tok = np.zeros(len(results), np.int64)
    scores = np.zeros(len(results), np.float64)
    for i, r in enumerate(results):
        ids = r[0][0] if beam else np.asarray(r, np.int64)
        if beam:
            scores[i] = r[1][0]
        n_tok[i] = len(ids)
        toks[i, :len(ids)] = ids
    save = {'tokens': toks, 'n_tokens': n_tok}
    if beam:
        save['scores'] = scores
    np.savez(out_path, **save)
    print(json.dumps({'requests': len(results), 'tokens': int(snap['tokens']),
                      'tokens_s': snap['tokens_s'],
                      'occupancy': snap['occupancy'],
                      'ttft_p50_ms': snap['ttft_p50_ms'],
                      'ttft_p99_ms': snap['ttft_p99_ms']}))
    return 0


def _run_cli(argv):
    artifact_dir, in_path, out_path = argv[1:]
    pred = CompiledPredictor(artifact_dir)
    with np.load(in_path) as data:
        feed = {k: data[k] for k in data.files}
    np.savez(out_path, **dict(zip(pred.get_output_names(), pred.run(feed))))
    return 0


_USAGE = ("usage: serve.py ARTIFACT_DIR IN.npz OUT.npz\n"
          "       serve.py loop ARTIFACT_DIR IN.npz OUT.npz [GROUP]\n"
          "       serve.py train ARTIFACT_DIR FEEDS.npz OUT.npz STEPS "
          "[CKPT.npz]\n"
          "       serve.py bench ARTIFACT_DIR IN.npz N_REQUESTS "
          "[TIMEOUT_MS]\n"
          "       serve.py decode ARTIFACT_DIR PROMPTS.npz OUT.npz "
          "[MAX_NEW [BEAM]]")


def main(argv):
    cmd = argv[1] if len(argv) >= 2 else None
    if cmd in ('fleet', 'gateway'):
        print("serve.py %s: the replica fleet and the HTTP gateway are not "
              "ported yet (ROADMAP.md queue 1 item 11)" % cmd,
              file=sys.stderr)
        return 2
    commands = {'bench': _bench_cli, 'loop': _loop_cli, 'train': _train_cli,
                'decode': _decode_cli}
    if cmd in commands:
        return commands[cmd](argv)
    if len(argv) != 4:
        print(_USAGE, file=sys.stderr)
        return 2
    return _run_cli(argv)


if __name__ == '__main__':
    sys.exit(main(sys.argv))
