"""Distributed lookup-table ops — port of
``paddle_tpu/ops/distributed_ops.py`` (reference:
paddle/fluid/operators/distributed_ops/ — prefetch via
parameter_prefetch.cc, split_ids_op.cc, merge_ids_op.cc; wired by
python/paddle/fluid/distribute_lookup_table.py:56).

The reference splits ids per pserver shard, RPCs a row prefetch, and
merges rows back in id order. Here the network half lives in
``paddle_tpu_torch.distributed`` (``DistTrainer`` prefetches before the
step and sends the sparse grads after it); these ops are the in-graph
halves:

* ``distributed_lookup``  — turn the prefetched per-position rows back
  into the lookup output (the merge_ids step);
* ``distributed_lookup_grad`` — per-position row gradients out (rows are
  the batch's ids, recorded host-side);
* ``make_selected_rows``  — pserver-side: assemble a ``SelectedRows``
  grad from the (rows, values) arrays received off the wire, feeding the
  unchanged optimizer op lowering. Its rows are int32, as the
  reference's.
"""

import torch

from paddle_tpu_torch.core.registry import register_no_grad_op, register_op
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.ops.common import flatten_lookup_ids, single


def _zero_padding_rows(flat_ids, x, padding_idx):
    """Zero the rows of ``x`` (one per id in ``flat_ids``, leading dims
    aligned) whose id equals padding_idx (reference:
    ``ops/common.py`` ``zero_padding_rows``)."""
    if padding_idx is None or padding_idx < 0:
        return x
    return torch.where((flat_ids == padding_idx).unsqueeze(-1),
                       torch.zeros_like(x), x)


@register_op("distributed_lookup", no_grad_inputs=("Ids",))
def distributed_lookup(ctx, ins, attrs):
    """Prefetched: [n_flat, D] rows fetched for the flattened ids (in id
    order); output has lookup_table's shape semantics incl. trailing-1
    squeeze and padding_idx zeroing."""
    pref = single(ins, "Prefetched")
    flat_ids = flatten_lookup_ids(single(ins, "Ids"))
    out = pref.reshape(tuple(flat_ids.shape) + (pref.shape[-1],))
    out = _zero_padding_rows(flat_ids, out, attrs.get("padding_idx", -1))
    return {"Out": [out]}


@register_no_grad_op("distributed_lookup_grad")
def distributed_lookup_grad(ctx, ins, attrs):
    og = single(ins, "Out@GRAD")
    flat_ids = flatten_lookup_ids(single(ins, "Ids"))
    og = _zero_padding_rows(flat_ids, og, attrs.get("padding_idx", -1))
    vals = og.reshape((-1, og.shape[-1]))
    return {"Prefetched@GRAD": [vals]}


@register_no_grad_op("make_selected_rows")
def make_selected_rows(ctx, ins, attrs):
    rows = single(ins, "Rows").reshape(-1).to(torch.int32)
    values = single(ins, "Values")
    return {"Out": [SelectedRows(rows, values, attrs["height"])]}
