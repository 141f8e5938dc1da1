"""Executor: runs a Program's block 0 with torch on one device.

The counterpart of paddle_tpu/executor.py:208 `Executor.run`, with the same
feed/fetch contract. Where the JAX executor traces the block into a jitted
step function, this one interprets it eagerly (core/lowering.py):

1. gather the program's persistable vars present in the Scope,
2. convert the feeds to tensors of the declared dtypes on the device,
3. run the ops of block 0 in order, inside core.amp.scope(True) when the
   program is marked for bf16 (`program._amp_bf16`, set by
   contrib.mixed_precision), as paddle_tpu/executor.py:1160,1181 traces
   its step; with gradient merge (`program._grad_accum_k` > 1, set by
   contrib.gradient_merge) as k microbatches and one update (`_ga_step`),
4. commit the persistable vars the block wrote back to the Scope,
5. return the fetches as numpy arrays, or as device tensors with
   return_numpy=False (a serving loop then syncs once, not per request).

Each Executor counts its runs of each program (by `Program._uid`, as
paddle_tpu/executor.py:270-282 does); the count seeds the ops' random
draws, so dropout draws fresh masks at every step.

Threads: each `run` builds its own interpreter and environment, and the
AMP switch is per thread, so several threads may run programs through one
Executor at once (the serving batcher's worker and a caller's
CompiledPredictor.run do) as long as those programs write no persistable
and draw no random numbers: the step counter's increment is not atomic.

`run_steps` (paddle_tpu/executor.py:373) runs K steps from one call on a
group of K stacked or listed feeds. Where the JAX executor scans the
traced step K times in one dispatch, this one calls `run` K times, so the
steps share `run`'s counter and are `run`'s steps bit for bit.

Before a run the program is linted (`_verify_before_run`,
paddle_tpu/executor.py:131-152): a warn-only `level='fast'` verify, one
RuntimeWarning per (program, build epoch, feed set, fetch set), and
PTPU_STRICT_VERIFY=1 raises ProgramVerifyError instead.

Freeing dead values: where the JAX package's jitted step gets its memory
back from XLA's buffer assignment, this interpreter drops each value
from the environment right after its last reader or writer
(core/lowering.py `free_plan`, from the def-use chains of
passes/dataflow.py, one plan per program uid, build epoch, op list and
fetch set). Persistables, fetch targets and, under gradient merge, the
carried values stay; a name a later op reads through a sub-block counts
as read by that op. There is no switch: a plan that dropped a name too
early fails the run with the interpreter's "has no value" TraceError.
"""
from __future__ import annotations

import numpy as np
import torch

from .backward import OP_ROLE_BACKWARD, OP_ROLE_OPTIMIZE
from .framework import (CUDAPlace, Variable, default_main_program,
                        to_torch_dtype)
from .core import amp
from .core.lowering import Interpreter, TraceError, free_plan
from .core.scope import global_scope
from .core.selected_rows import SelectedRowsVal


_verify_cache = {}   # uid -> (build_epoch, {(feeds, fetches): errors})


def _verify_before_run(program, feed_names, fetch_names):
    """Fast static lint before a run (passes/verifier.py): warn-only by
    default — one RuntimeWarning per (program epoch, feed, fetch)
    signature — while PTPU_STRICT_VERIFY=1 raises ProgramVerifyError
    instead of letting the interpreter fail in the middle of the run."""
    from .passes import verifier as _verifier
    uid, epoch = program._uid, program._build_epoch
    sig = (frozenset(feed_names), tuple(fetch_names))
    cached = _verify_cache.get(uid)
    if cached is None or cached[0] != epoch:   # epoch turned: old sigs die
        cached = (epoch, {})
        _verify_cache[uid] = cached
    errs = cached[1].get(sig)
    if errs is None:
        diags = _verifier.verify_program(program, feed_names=feed_names,
                                         fetch_names=fetch_names,
                                         level='fast')
        errs = [d for d in diags if d.level == 'error']
        cached[1][sig] = errs
    if errs:
        _verifier.maybe_raise_or_warn(errs, warned_key=(uid, epoch) + sig)


def _fetch_name(f):
    if isinstance(f, Variable):
        return f.name
    if isinstance(f, str):
        return f
    raise TypeError("fetch_list entries must be Variable or str, got %r" % (f,))


def _to_numpy(t):
    if isinstance(t, SelectedRowsVal):  # rows and values as numpy arrays
        return t.numpy()
    if t.dtype == torch.bfloat16:
        raise TypeError("numpy has no bfloat16: fetch %s tensors with "
                        "return_numpy=False" % t.dtype)
    return t.detach().cpu().numpy()


class Executor(object):
    """Runs programs on `place`: CUDAPlace(0) unless the caller passes
    CPUPlace(). A CUDA place where torch sees no card raises here."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        self._step_counters = {}

    def _feed_tensor(self, value, var):
        dtype = to_torch_dtype(var.dtype) if var is not None else None
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        return value.to(device=self.device, dtype=dtype)

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True):
        program = program if program is not None else default_main_program()
        fetch_list = fetch_list or []
        if isinstance(fetch_list, (Variable, str)):
            fetch_list = [fetch_list]
        fetch_names = [_fetch_name(f) for f in fetch_list]
        scope = scope if scope is not None else global_scope()
        block = program.global_block()
        k = int(getattr(program, '_grad_accum_k', 1) or 1)
        feed = feed or {}
        if k > 1:
            _check_ga_feeds(feed, k)

        state = {}
        persist = {v.name for v in program.list_vars() if v.persistable}
        for name in persist:
            val = scope.get(name)
            if val is not None:
                state[name] = val.to(self.device)
        feeds = {name: self._feed_tensor(value,
                                         block._find_var_recursive(name))
                 for name, value in feed.items()}
        _verify_before_run(program, set(feeds), fetch_names)
        step = self._step_counters.get(program._uid, 0)
        self._step_counters[program._uid] = step + 1

        bf16 = getattr(program, '_amp_bf16', False)
        with torch.no_grad(), amp.scope(bf16):
            if k > 1:
                interp = self._ga_step(program, state, feeds, step, k,
                                       fetch_names)
            else:
                state.update(feeds)
                interp = Interpreter(program, self.device, state, step)
                interp.run_block(block, free=free_plan(
                    program, block, block.ops, persist | set(fetch_names),
                    ('run', tuple(fetch_names))))
        env = interp.env
        for name in persist & interp.written:
            scope.set(name, env[name])

        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise ValueError("fetch targets %r have no value after the run: "
                             "not computed by the program and not fed"
                             % missing)
        # a program's own fetch ops (the reference's protobuf format keeps
        # them) are not returned: fetch_list names the outputs, as
        # paddle_tpu/executor.py returns them
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [_to_numpy(t) for t in fetches]
        return fetches

    def run_steps(self, program=None, reader=None, fetch_list=None,
                  steps=None, feed=None, scope=None, return_numpy=True,
                  fetch_policy='final', checkpoint=None):
        """Run K training steps (or inference batches) from one call, as
        paddle_tpu/executor.py:373-470 `run_steps` does, with its feed and
        fetch contract: `feed` maps each name to a stacked [K, ...] array
        or tensor, or to a list or tuple of K per-step values; `steps`,
        where given, must equal K. Step i runs `run` on the i-th entry of
        every feed, so the steps take the same per-step counter as `run`
        (the same dropout masks, Momentum state and gradient merge) and
        the two interleave freely: run_steps(K) is K `run` calls bit for
        bit.

        fetch_policy: 'final' returns the last step's fetches; 'stack'
        returns each fetch stacked over a leading K axis.

        Not ported yet: the `reader=` feed source and `checkpoint=`
        (their modules, reader/ and core/checkpoint.py, are not in the
        port) raise NotImplementedError."""
        if fetch_policy not in ('final', 'stack'):
            raise ValueError("fetch_policy must be 'final' or 'stack', "
                             "got %r" % (fetch_policy,))
        if steps is not None and int(steps) < 1:
            raise ValueError("run_steps: steps must be >= 1, got %d"
                             % int(steps))
        program = program if program is not None else default_main_program()
        if reader is not None or checkpoint is not None:
            raise NotImplementedError(
                "run_steps: the reader= feed source and checkpoint= are not "
                "ported yet (reader/ and core/checkpoint.py: ROADMAP.md "
                "queue 1 item 11); pass feed= as stacked [K, ...] values or "
                "K-lists")
        if not feed:
            raise ValueError(
                "run_steps needs a feed source: pass feed= (stacked arrays "
                "or K-lists)")
        k = _step_count(feed, steps)
        outs = []
        for i in range(k):
            outs.append(self.run(program, feed={n: v[i]
                                                for n, v in feed.items()},
                                 fetch_list=fetch_list, scope=scope,
                                 return_numpy=False))
        if fetch_policy == 'final':
            fetches = outs[-1]
        else:
            fetches = [torch.stack([o[j] for o in outs])
                       for j in range(len(outs[0]))]
        if return_numpy:
            return [_to_numpy(t) for t in fetches]
        return fetches

    # -- gradient merge (contrib/gradient_merge.py) ------------------------
    @staticmethod
    def _ga_partition(program, fetch_names):
        """Split block 0 for gradient merge, as paddle_tpu/executor.py:
        1003-1050 does (ref multi_batch_merge_pass). The excluded ops are
        the optimize-role ones and the gradient transforms (the clip and
        weight-decay ops of clip.py and regularizer.py, tagged
        `_grad_transform`): they run once, on the merged gradients. The
        microbatch cone is the ancestor set of the raw gradients, the
        excluded ops' inputs that a backward op outside them writes; so
        the learning-rate schedule (forward-role ops over the step
        counter) stays out of it and ticks once a step, not k times. The
        outer ops are the excluded ones plus those reachable backward from
        the fetches and persistable writes that the cone does not hold.
        Returns (ops, cone indices, outer indices, carried names: what the
        outer ops and the fetches read from the cone, cone outputs)."""
        ops = list(program.global_block().ops)
        excl = {i for i, op in enumerate(ops)
                if int(op.attrs.get('op_role', 0)) == OP_ROLE_OPTIMIZE
                or op.attrs.get('_grad_transform')}
        bwd_out = {o for i, op in enumerate(ops) if i not in excl
                   and int(op.attrs.get('op_role', 0)) & OP_ROLE_BACKWARD
                   for o in op.output_arg_names() if o}
        needed = {n for i in excl for n in ops[i].input_arg_names()
                  if n in bwd_out}
        cone = set()
        for i in range(len(ops) - 1, -1, -1):
            if i in excl or ops[i].type == 'feed':
                continue
            if any(o in needed for o in ops[i].output_arg_names()):
                cone.add(i)
                needed |= {n for n in ops[i].input_arg_names() if n}
        cone_idx = sorted(cone)
        cone_outs = {n for i in cone_idx
                     for n in ops[i].output_arg_names() if n}
        keep_out = set(fetch_names) | {v.name for v in program.list_vars()
                                       if v.persistable}
        outer = set()
        for i in range(len(ops) - 1, -1, -1):
            if i in cone or ops[i].type == 'feed':
                continue
            if i in excl or any(o in keep_out
                                for o in ops[i].output_arg_names()):
                outer.add(i)
                keep_out |= {n for n in ops[i].input_arg_names() if n}
        outer_idx = sorted(outer)
        outer_reads = {n for i in outer_idx
                       for n in ops[i].input_arg_names() if n}
        carried = sorted((outer_reads | set(fetch_names)) & cone_outs)
        return ops, cone_idx, outer_idx, carried, cone_outs

    def _ga_step(self, program, state, feeds, step, k, fetch_names):
        """One gradient-merge step (paddle_tpu/executor.py:1058 `_ga_step`,
        whose lax.scan is a Python loop here): the fed batch in k
        microbatches, the cone run on each with microbatch index i, every
        carried value accumulated as `acc + a/k` from zeros (so a merged
        gradient is the mean of the microbatches' gradients), persistables
        the cone writes carried from one microbatch to the next; then the
        outer ops (the optimizer) once, on the merged values. Each
        microbatch's environment is released before the next starts.
        Returns the outer phase's Interpreter."""
        ops, cone_idx, outer_idx, carried, cone_outs = \
            self._ga_partition(program, fetch_names)
        persist = {v.name for v in program.list_vars() if v.persistable}
        pers_names = sorted(persist & cone_outs)
        carried = [n for n in carried if n not in pers_names]
        outer_reads = {n for i in outer_idx
                       for n in ops[i].input_arg_names() if n}
        block = program.global_block()
        cone_ops = [ops[j] for j in cone_idx]
        outer_ops = [ops[j] for j in outer_idx]
        cone_free = free_plan(program, block, cone_ops,
                              persist | set(carried) | set(pers_names)
                              | set(fetch_names),
                              ('cone', tuple(fetch_names)))
        outer_free = free_plan(program, block, outer_ops,
                               persist | set(fetch_names),
                               ('outer', tuple(fetch_names)))
        acc, pers, written = None, {}, set()
        for i in range(k):
            mb = {n: t.reshape((k, t.shape[0] // k) + tuple(t.shape[1:]))[i]
                  for n, t in feeds.items()}
            env = dict(state)
            env.update(pers)
            env.update(mb)
            interp = Interpreter(program, self.device, env, step, micro=i)
            interp.run_block(block, cone_ops, cone_free)
            vals = {n: interp.env[n] for n in carried if n in interp.env}
            if acc is None:
                _check_ga_carried(vals, fetch_names, outer_reads)
                acc = {n: torch.zeros_like(v) for n, v in vals.items()}
            acc = {n: acc[n] + vals[n] / k for n in acc}
            pers = {n: interp.env[n] for n in pers_names if n in interp.env}
            written |= interp.written & persist
            del interp, env, vals, mb
        env = dict(state)
        env.update(acc)
        env.update(pers)
        del acc
        outer = Interpreter(program, self.device, env, step)
        outer.run_block(block, outer_ops, outer_free)
        outer.written |= written
        missing = [n for n in fetch_names if n not in outer.env]
        if missing:
            raise TraceError(
                "fetch %r is computed inside the gradient-merge microbatch "
                "loop and is not a carried output; fetch the loss or a "
                "persistable instead" % (missing,))
        return outer


def _step_count(feed, steps):
    """K of a run_steps feed group: the length of each list or tuple, the
    leading dim of each stacked value (paddle_tpu/executor.py:546-576).
    Raises unless every feed gives the same K and `steps`, where given,
    equals it."""
    ks = set()
    for name, value in feed.items():
        if isinstance(value, (list, tuple)):
            ks.add(len(value))
            continue
        shape = tuple(getattr(value, 'shape', None) or np.shape(value))
        if not shape:
            raise ValueError("run_steps feed %r has no leading step "
                             "dimension" % name)
        ks.add(int(shape[0]))
    if len(ks) != 1:
        raise ValueError("run_steps: feeds disagree on the step dimension: "
                         "%s" % sorted(ks))
    k = ks.pop()
    if k < 1:
        raise ValueError("run_steps: the feed carries no step")
    if steps is not None and int(steps) != k:
        raise ValueError("run_steps(steps=%d) but the feed carries %d "
                         "stacked steps" % (int(steps), k))
    return k


def _check_ga_feeds(feed, k):
    """paddle_tpu/executor.py:1068-1075: LoD feeds and batches that k does
    not divide are refused."""
    for n, v in feed.items():
        lod = getattr(v, 'lod', None)
        if callable(lod):
            lod = lod()
        if lod:
            raise TypeError("gradient merge does not support LoD feeds "
                            "(pad/bucket first): %r" % n)
        batch = tuple(getattr(v, 'shape', None) or np.shape(v))[0]
        if batch % k:
            raise ValueError(
                "gradient merge: batch %d of feed %r is not divisible by "
                "num_microbatches=%d" % (batch, n, k))


def _check_ga_carried(vals, fetch_names, outer_reads):
    """paddle_tpu/executor.py:1097-1112: only float values average across
    microbatches, and a fetch only the microbatches compute must be a
    scalar."""
    for n, v in vals.items():
        if not v.is_floating_point():
            raise TraceError(
                "gradient merge cannot carry %r (dtype %s) out of the "
                "microbatch loop: only float values average across "
                "microbatches. Fetch the loss or a persistable instead."
                % (n, v.dtype))
        if n in fetch_names and n not in outer_reads and v.numel() != 1:
            raise TraceError(
                "fetch %r has per-microbatch shape %s under gradient "
                "merge; only scalar (loss-like) fetches are well-defined — "
                "per-example outputs of a microbatch loop would silently "
                "average. Fetch the loss, or run without gradient merge."
                % (n, tuple(v.shape)))
