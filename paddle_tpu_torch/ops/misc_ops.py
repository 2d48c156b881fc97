"""Miscellaneous ops — port of ``paddle_tpu/ops/misc_ops.py`` for the
sequence ops and step cells of the file: ``row_conv`` (:254),
``lstm_unit`` (:347), ``gru_unit`` (:361), ``linear_chain_crf`` (:486),
``crf_decoding`` (:543), ``sequence_reshape`` (:669),
``sequence_scatter`` (:679) and ``tensor_array_to_tensor`` (:739). The
file's other ops are a later slice (ROADMAP Queue 1, step 5e).

The CRF's two loops over time are Python loops over the steps, where the
JAX package scans: the likelihood's grad is ``torch.func.vjp`` of the
loop (the engine's generic grad), as the JAX package's is the vjp of
``lax.scan``.
"""

import torch

from paddle_tpu_torch.core.registry import register_no_grad_op, register_op
from paddle_tpu_torch.ops.common import single


@register_op("row_conv", no_grad_inputs=())
def row_conv(ctx, ins, attrs):
    """Lookahead convolution: out[b, t] = sum_k x[b, t+k] * Filter[k]
    over the future window, zero past T."""
    x = single(ins, "X")                      # [B, T, D]
    filt = single(ins, "Filter")              # [future_len, D]
    out = torch.zeros_like(x)
    for i in range(filt.shape[0]):
        shifted = torch.cat([x[:, i:], x.new_zeros(
            (x.shape[0], min(i, x.shape[1])) + tuple(x.shape[2:]))], 1)
        out = out + shifted * filt[i][None, None, :]
    return {"Out": [out]}


@register_op("lstm_unit")
def lstm_unit(ctx, ins, attrs):
    """One LSTM step from [B, 4H] pre-computed gates in the order i, f,
    c_hat, o."""
    i, f, c_hat, o = torch.chunk(single(ins, "X"), 4, dim=1)
    c = (torch.sigmoid(f + attrs.get("forget_bias", 0.0))
         * single(ins, "C_prev") + torch.sigmoid(i) * torch.tanh(c_hat))
    return {"C": [c], "H": [torch.sigmoid(o) * torch.tanh(c)]}


@register_op("gru_unit")
def gru_unit(ctx, ins, attrs):
    """One GRU step from the [B, 3H] projected input (``Bias`` added to
    it first): ``Gate`` is the [B, 2H] update and reset pre-activation,
    as in the JAX package."""
    x = single(ins, "Input")
    h_prev = single(ins, "HiddenPrev")        # [B, H]
    w = single(ins, "Weight")                 # [H, 3H]
    bias = single(ins, "Bias")
    if bias is not None:
        x = x + bias
    hsz = h_prev.shape[1]
    gates = x[:, :2 * hsz] + h_prev @ w[:, :2 * hsz]
    u = torch.sigmoid(gates[:, :hsz])
    r = torch.sigmoid(gates[:, hsz:])
    c = torch.tanh(x[:, 2 * hsz:] + (r * h_prev) @ w[:, 2 * hsz:])
    h = u * h_prev + (1.0 - u) * c
    return {"Hidden": [h], "ResetHiddenPrev": [r * h_prev], "Gate": [gates]}


def _crf_operands(ins):
    """(emissions [B, T, C] float32, transitions [C+2, C] float32, the
    row lengths [B] int64: T where no ``Length`` is given)."""
    em = single(ins, "Emission").float()
    trans = single(ins, "Transition").float()
    lens = single(ins, "Length")
    if lens is None:
        lens = torch.full((em.shape[0],), em.shape[1], dtype=torch.int64,
                          device=em.device)
    return em, trans, lens.reshape(-1).long()


def _labels(label):
    """[B, T] int64 labels, a trailing dim of 1 squeezed."""
    if label.ndim == 3 and label.shape[-1] == 1:
        label = label[..., 0]
    return label.long()


@register_op("linear_chain_crf", no_grad_inputs=("Label", "Length"))
def linear_chain_crf(ctx, ins, attrs):
    """The log-likelihood of each row's label path under a linear-chain
    CRF over padded [B, T, C] emissions: the gold path's score less the
    log-partition, both over the row's first ``Length`` steps. The
    transitions are the reference's layout: row 0 the start scores, row 1
    the end scores, rows 2.. the [C, C] transitions. ``LogLikelihood`` is
    the likelihood (a training program minimises its negative);
    ``Alpha`` is the last step's [B, C] forward scores."""
    em, trans, lens = _crf_operands(ins)
    label = _labels(single(ins, "Label"))
    b, t = em.shape[0], em.shape[1]
    start, end, tr = trans[0], trans[1], trans[2:]
    rows = torch.arange(b, device=em.device)

    prev = label[:, 0]
    gold = start[prev] + em[rows, 0, prev]
    alpha = start[None, :] + em[:, 0]
    for s in range(1, t):
        valid = s < lens
        lab = label[:, s]
        gold = torch.where(valid, gold + (tr[prev, lab] + em[rows, s, lab]),
                           gold)
        prev = torch.where(valid, lab, prev)
        new = torch.logsumexp(alpha[:, :, None] + tr[None], dim=1) + em[:, s]
        alpha = torch.where(valid[:, None], new, alpha)
    gold = gold + end[prev]
    logz = torch.logsumexp(alpha + end[None, :], dim=1)
    return {"LogLikelihood": [(gold - logz).reshape(b, 1)],
            "Alpha": [alpha], "EmissionExps": [torch.exp(em)],
            "TransitionExps": [torch.exp(trans)]}


@register_no_grad_op("crf_decoding")
def crf_decoding(ctx, ins, attrs):
    """The Viterbi path [B, T] (int64; zero past each row's length): the
    back-pointers take the first best previous label, and a step past
    the row's length points each label at itself. With ``Label``, 1
    where the path equals the label and 0 elsewhere."""
    em, trans, lens = _crf_operands(ins)
    b, t, c = em.shape
    start, end, tr = trans[0], trans[1], trans[2:]
    rows = torch.arange(b, device=em.device)
    same = torch.arange(c, device=em.device).expand(b, c)
    score = start[None] + em[:, 0]
    ptrs = []
    for s in range(1, t):
        valid = (s < lens)[:, None]
        cand = score[:, :, None] + tr[None]            # [B, C, C]
        score = torch.where(valid, cand.amax(1) + em[:, s], score)
        ptrs.append(torch.where(valid, cand.argmax(1), same))
    lab = (score + end[None]).argmax(1)
    path = [lab]
    for ptr in reversed(ptrs):
        lab = ptr[rows, lab]
        path.append(lab)
    path = torch.stack(path[::-1], 1)
    mask = torch.arange(t, device=em.device)[None, :] < lens[:, None]
    label = single(ins, "Label")
    if label is not None:
        path = path == _labels(label)
    return {"ViterbiPath": [torch.where(mask, path.long(),
                                        torch.zeros_like(path.long()))]}


@register_op("sequence_reshape", no_grad_inputs=())
def sequence_reshape(ctx, ins, attrs):
    """[B, T, D] refolded to [B, T*D/new_dim, new_dim]."""
    x = single(ins, "X")
    new_dim = int(attrs["new_dim"])
    b, t, d = x.shape
    return {"Out": [x.reshape(b, t * d // new_dim, new_dim)]}


@register_op("sequence_scatter", no_grad_inputs=("Ids", "Length"))
def sequence_scatter(ctx, ins, attrs):
    """``Updates`` [B, T] added into ``X`` [B, N] at row b's ``Ids`` [B,
    T]. A negative id counts from the row's end, and an id outside [-N,
    N) is dropped, as the JAX package's ``.at[].add(mode="drop")`` does.
    The adds go through ``index_put_(accumulate=True)`` into one spare
    slot past the end (the dropped ones), which the card sums in a fixed
    order."""
    x = single(ins, "X")
    ids = single(ins, "Ids").long()
    upd = single(ins, "Updates")
    b, n = x.shape
    ids = torch.where(ids < 0, ids + n, ids)
    rows = torch.arange(b, device=x.device).reshape(-1, 1)
    flat = torch.where((ids >= 0) & (ids < n), rows * n + ids,
                       torch.full_like(ids, b * n))
    base = torch.cat([x.reshape(-1), x.new_zeros(1)])
    out = torch.index_put(base, (flat.reshape(-1),),
                          upd.reshape(-1).to(x.dtype), accumulate=True)
    return {"Out": [out[:-1].reshape(b, n)]}


@register_no_grad_op("tensor_array_to_tensor")
def tensor_array_to_tensor(ctx, ins, attrs):
    """A tensor array's whole buffer, its entries concatenated along
    ``axis`` (the capacity's entries, zeros past the live length), and
    ``OutIndex`` [len] (int64)."""
    arr = single(ins, "X")
    axis = int(attrs.get("axis", 1))
    out = torch.cat(list(arr["buf"].unbind(0)), dim=axis)
    return {"Out": [out], "OutIndex": [arr["len"].reshape(1).long()]}
