"""LoD (level-of-detail) tensors: variable-length sequences packed into one
dense tensor plus per-level row-split offsets (the reference's LoDTensor,
paddle/fluid/framework/lod_tensor.h:58,110; the port's copy of
paddle_tpu/core/lod.py:1-230).

The JAX package keeps offsets in two modes: static (host tuples in the
pytree structure, folded into each compiled program) and traced (device
arrays, so one compiled program serves every batch of a bucket). The
port compiles nothing, so it keeps one form: offsets are host tuples,
always. A lowering reads them as Python ints and builds its gathers and
masks from them on the host; nothing syncs the card to learn where a
sequence starts. `traced=` and `bucket_rows=` exist for the JAX package's
bucketing discipline, which the port's ops do not need: they raise
NotImplementedError (ROADMAP.md queue 1 item 8).
"""
from __future__ import annotations

import numpy as np
import torch


def _freeze(lod):
    return tuple(tuple(int(v) for v in np.asarray(l).reshape(-1))
                 for l in lod)


def _not_ported(what):
    raise NotImplementedError(
        "%s: traced (device) LoD offsets and bucket padding are not ported "
        "(ROADMAP.md queue 1 item 8); the port keeps offsets on the host, "
        "so every batch needs no bucket" % what)


class LoDArray(object):
    """A dense tensor (`data`, rows first) and its offsets, one tuple of
    ints per level (`lod`)."""

    __slots__ = ('data', '_lod')

    def __init__(self, data, lod=()):
        self.data = data
        self._lod = _freeze(lod)

    @classmethod
    def traced(cls, data, offsets):
        _not_ported('LoDArray.traced')

    @property
    def lod(self):
        """Host offsets (a tuple of tuples of ints)."""
        return self._lod

    def with_lod_of(self, data):
        """A new LoDArray around `data` with this one's offsets."""
        return LoDArray(data, self._lod)

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def offsets(self, level=0):
        return np.asarray(self._lod[level], dtype=np.int64)

    def lengths(self, level=0):
        off = self.offsets(level)
        return off[1:] - off[:-1]

    def recursive_sequence_lengths(self):
        return [list(self.lengths(i)) for i in range(len(self._lod))]

    def __array__(self, dtype=None, copy=None):
        a = self.data.detach().cpu().numpy() \
            if isinstance(self.data, torch.Tensor) else np.asarray(self.data)
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return "LoDArray(shape=%s, lod=%s)" % (
            tuple(self.data.shape), [list(l)[:8] for l in self._lod])


def unwrap(x):
    return x.data if isinstance(x, LoDArray) else x


def lod_of(x):
    return x.lod if isinstance(x, LoDArray) else ()


def lengths_to_offsets(lengths):
    lengths = np.asarray(lengths, dtype=np.int64)
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)


def create_lod_array(data, recursive_seq_lens=None, lod=None, traced=False,
                     bucket_rows=None):
    """A LoDArray from dense data (numpy, or a tensor, which keeps its
    device) and nested lengths or offsets. The last level's offsets must
    end at the data's row count."""
    if traced or bucket_rows is not None:
        _not_ported('create_lod_array(traced=, bucket_rows=)')
    if lod is None:
        lod = [lengths_to_offsets(lens) for lens in recursive_seq_lens or ()]
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(np.asarray(data))
    lod = _freeze(lod)
    if lod and lod[-1][-1] != data.shape[0]:
        raise ValueError("LoD offsets end at row %d but the data has %d rows"
                         % (lod[-1][-1], data.shape[0]))
    return LoDArray(data, lod)


def segment_ids_from_offsets(offsets):
    """Host int64 [offsets[-1]]: each row's sequence index."""
    off = np.asarray(offsets, dtype=np.int64)
    return np.repeat(np.arange(len(off) - 1), off[1:] - off[:-1])


# -- LoD rows padded, unpadded and reversed (paddle_tpu/ops/rnn_ops.py:40-80)
_INDEX_CACHE = {}


def device_index(kind, off, n_rows, device, build, dtype=torch.int64):
    """A cached tensor (int64 unless `dtype` says otherwise) on `device`,
    built on the host by build() for these offsets (a tuple), so that a
    lowering neither copies nor reads offsets on the card twice; the cache
    is bounded (cleared at 256)."""
    key = (kind, off, n_rows, str(device), dtype)
    t = _INDEX_CACHE.get(key)
    if t is None:
        if len(_INDEX_CACHE) >= 256:
            _INDEX_CACHE.clear()
        t = torch.as_tensor(build(), dtype=dtype).to(device)
        _INDEX_CACHE[key] = t
    return t


def _lens(off):
    off = np.asarray(off, np.int64)
    return off[1:] - off[:-1]


def _uniform(off, n_rows):
    """Every sequence has one length and the rows are exactly theirs."""
    lens = _lens(off)
    return (len(lens) > 0 and off[0] == 0 and off[-1] == n_rows
            and bool((lens == lens[0]).all()))


def pad_from_lod(x, off):
    """[T, ...] rows and host offsets -> ([N, L, ...], mask [N, L] or None
    where no position is padding)."""
    off = tuple(int(v) for v in off)
    lens = _lens(off)
    n, maxlen = len(lens), int(lens.max()) if len(lens) else 0
    if _uniform(off, x.shape[0]):
        return x.reshape((n, maxlen) + tuple(x.shape[1:])), None

    def build():
        j = np.arange(maxlen, dtype=np.int64)
        return np.minimum(np.asarray(off[:-1])[:, None] + j[None, :],
                          max(x.shape[0] - 1, 0)).reshape(-1)
    rows = x.index_select(0, device_index('pad', off, x.shape[0], x.device,
                                          build))
    mask = device_index('mask', off, maxlen, x.device,
                        lambda: np.arange(maxlen)[None, :] < lens[:, None],
                        torch.bool)
    return rows.reshape((n, maxlen) + tuple(x.shape[1:])), mask


def unpad_to_lod(y, off):
    """[N, L, ...] -> the LoD rows of the valid positions."""
    off = tuple(int(v) for v in off)
    flat = y.reshape((-1,) + tuple(y.shape[2:]))
    if _uniform(off, flat.shape[0]):
        return flat
    maxlen = y.shape[1]

    def build():
        lens = _lens(off)
        ends = np.cumsum(lens)
        base = np.repeat(np.arange(len(lens), dtype=np.int64) * maxlen
                         - (ends - lens), lens)
        return np.arange(int(ends[-1]) if len(lens) else 0) + base
    return flat.index_select(0, device_index('unpad', off, maxlen,
                                             y.device, build))


def reverse_lod_rows(x, off):
    """Each sequence's rows in reverse order; rows past the last offset
    stay where they are."""
    off = tuple(int(v) for v in off)

    def build():
        o = np.asarray(off, np.int64)
        seg = segment_ids_from_offsets(o)
        valid = int(o[-1])
        idx = np.arange(x.shape[0], dtype=np.int64)
        idx[:valid] = o[seg] + o[seg + 1] - 1 - np.arange(valid)
        return idx
    return x.index_select(0, device_index('reverse', off, x.shape[0],
                                          x.device, build))
