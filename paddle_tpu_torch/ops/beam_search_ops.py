"""Beam search ops — port of ``paddle_tpu/ops/beam_search_ops.py``:
``beam_search`` (:21) and ``beam_search_decode`` (:84).

As in the JAX package the beams stay a fixed [batch * beam] block of
rows: a finished row (its previous id is ``end_id``) offers only a
virtual end column carrying its frozen score, so the beam never shrinks.
A step ranks each group's candidates with ``top_k``'s rule (ties lowest
index first, ``ops/common.py`` ``topk_lowest_index_first``), so equal
beams pick the same parents as the JAX package's.
"""

import torch

from paddle_tpu_torch.core.registry import register_no_grad_op
from paddle_tpu_torch.ops.common import single, topk_lowest_index_first

_NEG = -1e9


@register_no_grad_op("beam_search")
def beam_search(ctx, ins, attrs):
    """One beam step over [batch * beam, V] scores: ``pre_ids`` and
    ``pre_scores`` [BW, 1], ``scores`` [BW, V] (accumulated log-probs, or
    with ``is_accumulated`` False per-step probabilities, whose log is
    added to ``pre_scores`` here), ``ids`` [BW, V] optionally mapping the
    score columns to token ids. With ``first_step`` only the first beam
    of each group is live. Returns ``selected_ids`` and
    ``selected_scores`` [BW, 1] and ``parent_idx`` [BW], the row of the
    previous layout each beam extends (int64)."""
    pre_ids = single(ins, "pre_ids").reshape(-1)
    pre_scores = single(ins, "pre_scores").reshape(-1)
    scores = single(ins, "scores")
    w = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    bw, v = scores.shape
    b = bw // w
    dev = scores.device

    finished = pre_ids == end_id
    if attrs.get("is_accumulated", True):
        acc = scores
    else:
        acc = pre_scores[:, None] + torch.log(scores.clamp_min(1e-30))
    cand = torch.where(finished[:, None], _NEG, acc)
    end_col = torch.where(finished, pre_scores, _NEG)[:, None]
    cand = torch.cat([cand, end_col.to(cand.dtype)], 1)    # [BW, V+1]
    if attrs.get("first_step", False):
        first = (torch.arange(bw, device=dev) % w == 0)[:, None]
        cand = torch.where(first, cand, _NEG)
    top_scores, top_flat = topk_lowest_index_first(cand.reshape(b, -1), w)
    col = (top_flat % (v + 1)).reshape(-1)
    parent = (torch.arange(b, device=dev)[:, None] * w
              + top_flat // (v + 1)).reshape(-1)
    cand_ids = single(ins, "ids")
    if cand_ids is not None:
        ids_mat = cand_ids.reshape(bw, v).long()
    else:
        ids_mat = torch.arange(v, device=dev).expand(bw, v)
    ids_ext = torch.cat([ids_mat, torch.full((bw, 1), end_id,
                                             dtype=torch.int64, device=dev)],
                        1)
    return {"selected_ids": [ids_ext[parent, col].reshape(-1, 1)],
            "selected_scores": [top_scores.reshape(-1, 1)],
            "parent_idx": [parent]}


@register_no_grad_op("beam_search_decode")
def beam_search_decode(ctx, ins, attrs):
    """The decode's sentences backtracked through the parent pointers of
    the ``Ids``, ``ParentIdx`` and ``Scores`` tensor arrays: every one of
    the arrays' entries, from the last back, a row frozen (``end_id``, its
    own row) at the entries past the arrays' length. The length stays on
    the device: each step compares with it there. Returns
    ``sentence_ids`` [BW, capacity] (int64) and ``sentence_scores`` [BW,
    1], the ``Scores`` entry at length - 1."""
    ids_arr = single(ins, "Ids")
    ids = ids_arr["buf"]                       # [cap, BW, 1]
    parents = single(ins, "ParentIdx")["buf"]  # [cap, BW]
    length = ids_arr["len"]
    end_id = int(attrs["end_id"])
    cap, bw = ids.shape[0], ids.shape[1]
    ids = ids.reshape(cap, bw).long()
    parents = parents.reshape(cap, bw).long()
    rows = torch.arange(bw, device=ids.device)
    end = torch.full((bw,), end_id, dtype=torch.int64, device=ids.device)
    toks = []
    for t in range(cap - 1, -1, -1):
        live = t < length
        toks.append(torch.where(live, ids[t][rows], end))
        rows = torch.where(live, parents[t][rows], rows)
    last = (length.long() - 1).clamp_min(0).reshape(1)
    scores = single(ins, "Scores")["buf"].index_select(0, last)
    return {"sentence_ids": [torch.stack(toks[::-1], 1)],
            "sentence_scores": [scores.reshape(bw, 1)]}
