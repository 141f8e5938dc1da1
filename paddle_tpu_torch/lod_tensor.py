"""Host-side LoDTensor construction (ref: python/paddle/fluid/lod_tensor.py;
the port's copy of paddle_tpu/lod_tensor.py). A fed or fetched LoD tensor
is a core.lod.LoDArray: a tensor and its host offsets."""
from __future__ import annotations

import numpy as np

from .core.lod import LoDArray, create_lod_array

LoDTensor = LoDArray


def create_lod_tensor(data, recursive_seq_lens, place=None, traced=False,
                      bucket_rows=None):
    """A LoDTensor from numpy data (or a list of sequences, or a LoDTensor)
    and nested sequence lengths. `place` is accepted for the reference's
    signature: the Executor moves a feed to its own device."""
    if isinstance(data, LoDArray):
        return create_lod_tensor(np.asarray(data), recursive_seq_lens,
                                 place, traced=traced,
                                 bucket_rows=bucket_rows)
    if isinstance(data, list):
        flat = np.concatenate([np.asarray(s).reshape(len(s), -1)
                               for s in data])
        seq_lens = [len(s) for s in data]
        assert recursive_seq_lens is None or [seq_lens] == recursive_seq_lens
        return create_lod_tensor(flat, [seq_lens], place, traced=traced,
                                 bucket_rows=bucket_rows)
    return create_lod_array(np.asarray(data),
                            recursive_seq_lens=recursive_seq_lens,
                            traced=traced, bucket_rows=bucket_rows)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low,
                                high):
    """Random int64 data in [low, high] under the given lengths, drawn from
    numpy's global generator, as the reference draws it."""
    assert isinstance(base_shape, list), "base_shape should be a list"
    offsets = [np.cumsum([0] + l).tolist() for l in recursive_seq_lens]
    total = offsets[-1][-1]
    data = np.random.randint(low, high + 1, size=[total] + base_shape,
                             dtype='int64')
    return create_lod_tensor(data, recursive_seq_lens, place)
