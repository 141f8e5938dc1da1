"""Serving-tier helpers shared by the request schedulers (ref:
paddle_tpu/inference/batching.py:66-72,91,115): the shedding exceptions,
the max_queue check and the prompt/batch bucket choice.

The reference's BatchingPredictor (dynamic batching of stateless
requests) is not ported yet; the port's DecodingPredictor
(inference/decoding.py) uses what is here.
"""
from __future__ import annotations

import time


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
