"""SelectedRows: sparse row-set gradients (ref: framework/selected_rows.h:32;
the port's copy of paddle_tpu/core/selected_rows.py).

An embedding looked up with is_sparse=True gets its table gradient as
`SelectedRowsVal`: rows [N] (int64 row ids, may repeat; id == height
means an empty slot) and values [N, *tail], plus the table's row count
`height`. N is the number of lookups in the batch, fixed by the ids'
shape, as in the reference:

  - the sparse optimizer branches (ops/optimizer_ops.py) apply `values`
    at `rows`, merging duplicate ids first where they read a row;
  - `merged()` sorts and segment-sums duplicates, parking the freed
    slots at row == height, so N stays what it was;
  - densifying (`to_dense`) is explicit, never implicit.

Where the reference drops an out-of-range row in a scatter (mode='drop'),
the port writes into one extra row past the table and slices it off
(`rows_add`, `rows_set`, `rows_get` below): no boolean mask, so no host
sync on the card. On a CUDA tensor `index_add_` adds duplicate rows in no
fixed order, so a merged row's sum may differ from the CPU's in its last
bits; on the CPU it adds them in slot order, as XLA's scatter does.
"""
from __future__ import annotations

import numpy as np
import torch


class SelectedRowsVal(object):
    """rows: [N] int64 row ids (may repeat; id == height is an empty slot).
    values: [N, *tail] per-row data. height: the table's row count."""

    __slots__ = ('rows', 'values', 'height')

    def __init__(self, rows, values, height):
        self.rows = rows
        self.values = values
        self.height = int(height)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def shape(self):
        """The dense table's shape."""
        return (self.height,) + tuple(self.values.shape[1:])

    def to(self, device):
        return SelectedRowsVal(self.rows.to(device), self.values.to(device),
                               self.height)

    def to_dense(self):
        """The full [height, *tail] table, duplicate rows added."""
        dense = self.values.new_zeros(self.shape)
        return rows_add(dense, self.rows, self.values)

    def merged(self):
        """Duplicate rows summed: sort by row id (stable), segment-sum each
        run of equal ids into the run's slot, park the rest at row ==
        height. N stays; scatters drop the parked slots."""
        rows, order = torch.sort(self.rows, stable=True)
        vals = self.values[order]
        n = rows.shape[0]
        first = torch.ones(n, dtype=torch.bool, device=rows.device)
        first[1:] = rows[1:] != rows[:-1]
        seg = torch.cumsum(first.long(), 0) - 1  # [N] run index
        sums = vals.new_zeros(vals.shape).index_add_(0, seg, vals)
        run_rows = torch.full((n,), self.height, dtype=rows.dtype,
                              device=rows.device).scatter_(0, seg, rows)
        return SelectedRowsVal(run_rows, sums, self.height)

    def scale(self, s):
        return SelectedRowsVal(self.rows, self.values * s, self.height)

    def numpy(self):
        """The same value with numpy rows and values (fetches, state)."""
        return SelectedRowsVal(self.rows.detach().cpu().numpy(),
                               self.values.detach().cpu().numpy(),
                               self.height)

    def __repr__(self):
        return "SelectedRowsVal(n=%s, height=%d, tail=%s)" % (
            self.rows.shape[0], self.height, tuple(self.values.shape[1:]))


def concat_rows(srs):
    """Several SelectedRows over one table added (the `sum` op on sparse
    grads): for a scatter consumer, concatenation is addition."""
    height = srs[0].height
    for s in srs:
        if s.height != height:
            raise ValueError("SelectedRows height mismatch: %d vs %d"
                             % (s.height, height))
    return SelectedRowsVal(torch.cat([s.rows for s in srs]),
                           torch.cat([s.values for s in srs]), height)


def from_numpy(v, device):
    """A SelectedRowsVal of numpy arrays (SelectedRowsVal.numpy) back on
    `device`."""
    return SelectedRowsVal(torch.as_tensor(np.asarray(v.rows)).to(device),
                           torch.as_tensor(np.asarray(v.values)).to(device),
                           v.height)


def _extended(t):
    """t with one zero row past its last: the slot that takes the rows a
    scatter drops (row == height)."""
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def rows_add(t, rows, values):
    """t.at[rows].add(values, mode='drop'): rows in [0, height] (height
    drops), duplicates added. A new tensor."""
    return _extended(t).index_add_(0, rows, values.to(t.dtype))[:t.shape[0]]


def rows_set(t, rows, values):
    """t.at[rows].set(values, mode='drop') for rows that are unique but for
    the parked slots (row == height). A new tensor."""
    ext = _extended(t)
    ext[rows] = values.to(t.dtype)
    return ext[:t.shape[0]]


def rows_get(t, rows):
    """t.at[rows].get(mode='fill', fill_value=0): row == height reads 0."""
    return _extended(t)[rows]
