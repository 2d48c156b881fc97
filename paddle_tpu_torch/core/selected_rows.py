"""SelectedRows: a row-sparse gradient — port of
``paddle_tpu/core/selected_rows.py``.

``lookup_table_grad`` with ``is_sparse=True`` emits one (rows = the
batch's ids, values = the output grads); ``sum``, ``scale``, the clip ops
and the elementwise ops that the clip and the regularizers append combine
it; the sparse branches of ``sgd``, ``momentum``, ``adam`` and
``adagrad`` consume it with row-wise updates, so no table-shaped grad is
ever built. Where the JAX package makes it a pytree, here it is a plain
class over torch tensors that lives inside one run of a block: the engine
densifies it wherever it leaves the block (a fetch, a state write-back).

Everything here keeps static shapes and never reads a device value on
the host, so a CUDA graph holds a sparse step like any other:

- ``merged()`` deduplicates with a sort (the reference's
  ``scatter::MergeAdd``): sort the rows, flag each first occurrence, take
  a running count of the flags as each slot's segment, and scatter into
  ``full(n, height)``. It gives the JAX package's layout: the unique rows
  ascending, then sentinel rows equal to ``height`` carrying zeros.
  ``torch.unique`` has no static size and waits for the card.
- JAX drops out-of-range scatters (``mode="drop"``); torch asserts on the
  device. So a sentinel slot never reaches an index op: ``set_rows`` and
  ``gather_rows`` point it at the first slot's row with the first slot's
  value (two writes of one value to one row agree in any order), and
  ``add_rows`` of unmerged rows at row 0 with a value of -0.0 (x + -0.0
  is x, bit for bit).
- A sum into unmerged rows is ``index_put_(accumulate=True)``, whose CUDA
  path sorts the indices and adds each row's values in a fixed order;
  ``index_add_`` adds with float atomics, in an order that changes from
  run to run. That path adds a row's duplicates one after another, so
  merged rows (unique, the sentinels all one row) are added as a gather,
  an add and a set instead.
"""

import torch


class SelectedRows:
    """rows: int64 [N]; values: [N, *dims]; height: the table's rows."""

    def __init__(self, rows, values, height, merged=False):
        self.rows = rows
        self.values = values
        self.height = int(height)
        # True when the rows are known unique (or sentinel); lets
        # consumers skip a second merge
        self.is_merged = bool(merged)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    def to(self, dtype):
        """The values cast to ``dtype`` (the AMP casts, ``amp_cast``)."""
        return SelectedRows(self.rows, self.values.to(dtype), self.height,
                            merged=self.is_merged)

    def map_values(self, fn):
        """Apply a row-wise elementwise ``fn`` to the values (valid for
        transforms that keep zero rows zero, like scaling)."""
        return SelectedRows(self.rows, fn(self.values), self.height,
                            merged=self.is_merged)

    def _valid(self):
        """[N, 1, ...] mask of the slots holding a real row."""
        valid = self.rows < self.height
        return valid.reshape((-1,) + (1,) * (self.values.ndim - 1))

    def to_dense(self):
        """The dense view. The zeros have one row more than the table, for
        the sentinel slots to land in; the result is a view of the first
        ``height`` rows."""
        dense = torch.zeros((self.height + 1,) + tuple(self.values.shape[1:]),
                            dtype=self.values.dtype, device=self.device)
        # merged rows are unique but for the sentinels' zeros
        dense.index_put_((self.rows,), self.values,
                         accumulate=not self.is_merged)
        return dense[: self.height]

    def merged(self):
        """Deduplicate rows: duplicate rows' values are summed; the unique
        rows come first, ascending, then sentinel rows equal to ``height``
        with zero values. Static shapes, no host read."""
        if self.is_merged:
            return self
        srt, perm = torch.sort(self.rows, stable=True)
        first = torch.cat([torch.ones_like(srt[:1], dtype=torch.bool),
                           srt[1:] != srt[:-1]])
        seg = torch.cumsum(first, 0) - 1
        # every slot of one segment writes the same row
        uniq = torch.full_like(self.rows, self.height).index_put_(
            (seg,), srt)
        vals = torch.zeros_like(self.values).index_put_(
            (seg,), self.values[perm], accumulate=True)
        return SelectedRows(uniq, vals, self.height, merged=True)

    # -- row-wise access for the sparse updates (merged rows) --------------
    def _first_slot_rows(self):
        """The rows with each sentinel replaced by the first slot's row
        (a real row once merged: the smallest)."""
        return torch.where(self.rows < self.height, self.rows,
                           self.rows[:1])

    def gather_rows(self, dense):
        """``dense``'s rows at each slot; a sentinel slot reads the first
        slot's row."""
        return dense.index_select(0, self._first_slot_rows())

    def set_rows(self, dense, vals):
        """``dense`` with each real slot's row set to its ``vals`` (a new
        tensor). Call on merged rows: two slots of one row would write two
        values in an undefined order. A sentinel slot writes the first
        slot's value to the first slot's row."""
        vals = torch.where(self._valid(), vals, vals[:1])
        return dense.index_put((self._first_slot_rows(),), vals)

    def add_rows(self, dense, vals):
        """``dense`` plus ``vals`` at each slot's row (a new tensor);
        duplicate rows sum in a fixed order, a sentinel slot adds
        nothing."""
        if self.is_merged:
            return self.set_rows(dense, self.gather_rows(dense) + vals)
        rows = torch.where(self.rows < self.height, self.rows,
                           torch.zeros_like(self.rows))
        vals = torch.where(self._valid(), vals, torch.full_like(vals, -0.0))
        return dense.index_put((rows,), vals, accumulate=True)


def densify(x):
    """Dense view of ``x``, sparse or already dense."""
    return x.to_dense() if isinstance(x, SelectedRows) else x


def add_to_dense(dense, sr):
    """dense + sr without materializing sr densely."""
    return sr.add_rows(dense, sr.values.to(dense.dtype))
