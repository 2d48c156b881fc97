"""Miscellaneous ops — port of ``paddle_tpu/ops/misc_ops.py``, the
whole file: the elementwise, shape and loss ops (``cos_sim`` :13 ..
``dice_loss_op`` :161, ``selu`` :380, ``add_position_encoding`` :222,
``data_norm`` :690), the ops without a grad (``mean_iou`` :173, ``hash``
:236, ``ctc_greedy_decoder`` :324, ``isinf``/``isnan``/
``isfinite_reduce``/``is_empty`` :389-405), the samplers
(``grid_sampler`` :268, ``affine_grid`` :301, ``psroi_pool`` :755,
``tree_conv`` :908), the 3-D ops (``conv3d`` :412, ``conv3d_transpose``
:430, ``pool3d`` :457), the sampled heads (``nce`` :599,
``hierarchical_sigmoid`` :631), the random ops (``sampling_id`` :191,
``random_crop`` :201, ``uniform_random_batch_size_like`` :705,
``gaussian_random_batch_size_like`` :718), the host ops (``print_op``
:730, ``py_func`` :818, ``py_func_grad`` :841, ``load_value`` :898), and
the sequence ops and step cells of the file: ``row_conv`` (:254),
``lstm_unit`` (:347), ``gru_unit`` (:361), ``linear_chain_crf`` (:486),
``crf_decoding`` (:543), ``sequence_reshape`` (:669),
``sequence_scatter`` (:679) and ``tensor_array_to_tensor`` (:739).

The CRF's two loops over time are Python loops over the steps, where the
JAX package scans: the likelihood's grad is ``torch.func.vjp`` of the
loop (the engine's generic grad), as the JAX package's is the vjp of
``lax.scan``. Every gather whose grad adds rows back (``multiplex``,
``bpr_loss``, ``grid_sampler``, ``psroi_pool``, ``nce``,
``hierarchical_sigmoid``) goes through ``ops/common.py`` ``take``, so
the grad is a sorted ``index_put_`` that the card repeats bit for bit.

The random ops and ``nce`` draw from the op's entry of the run's seed
table (``LowerContext.seed``) through the counter-based hash of
``ops/common.py`` (``uniform_ints``, ``uniform_floats``), as dropout
does: their bits are the port's own, not threefry's; a captured graph
holds them and draws anew at each replay, and the card draws what the
CPU draws for the same seed. The host ops (``print_op``, ``py_func``,
``py_func_grad``) cannot be captured, so a block that holds one runs
eagerly; ``affine_grid`` reads an ``OutputShape`` tensor on the host
when no ``output_shape`` attr is given, and only then.
"""

import itertools
import math

import numpy as np
import torch

import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_no_grad_op, register_op
from paddle_tpu_torch.ops.common import (
    hash_bits, hash_op_bits, single, take, uniform_floats, uniform_ints,
)

SEED_HIGH = 2 ** 32


def _seed_range(attrs):
    """The random ops and ``nce`` draw one seed a run, in [0, 2**32)."""
    return SEED_HIGH


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


# -- elementwise, shape and loss ops ----------------------------------------


@register_op("cos_sim")
def cos_sim(ctx, ins, attrs):
    """The cosine of each row pair of X and Y ([B, 1]), with the rows'
    norms."""
    x, y = single(ins, "X"), single(ins, "Y")
    xn = torch.sqrt((x * x).sum(-1, keepdim=True))
    yn = torch.sqrt((y * y).sum(-1, keepdim=True))
    out = (x * y).sum(-1, keepdim=True) / torch.clamp(xn * yn, min=1e-12)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


def _per_channel(v, ndim):
    return v.reshape((1, -1) + (1,) * (ndim - 2))


@register_op("affine_channel")
def affine_channel(ctx, ins, attrs):
    """NCHW ``x * Scale + Bias``, one scale and bias a channel."""
    x = single(ins, "X")
    return {"Out": [x * _per_channel(single(ins, "Scale"), x.ndim)
                    + _per_channel(single(ins, "Bias"), x.ndim)]}


@register_op("shuffle_channel", no_grad_inputs=())
def shuffle_channel(ctx, ins, attrs):
    """The channels' [group, C / group] grid transposed."""
    x = single(ins, "X")
    g = int(attrs.get("group", 1))
    n, c, h, w = x.shape
    return {"Out": [x.reshape(n, g, c // g, h, w).transpose(1, 2)
                    .reshape(x.shape)]}


@register_op("space_to_depth")
def space_to_depth(ctx, ins, attrs):
    """Each ``blocksize`` x ``blocksize`` block of pixels moved into the
    channels, the block's offsets outermost."""
    x = single(ins, "X")
    bs = int(attrs.get("blocksize", 1))
    n, c, h, w = x.shape
    return {"Out": [x.reshape(n, c, h // bs, bs, w // bs, bs)
                    .permute(0, 3, 5, 1, 2, 4)
                    .reshape(n, c * bs * bs, h // bs, w // bs)]}


@register_op("crop", no_grad_inputs=("Offsets", "Y"))
def crop(ctx, ins, attrs):
    """The block of X of ``Y``'s shape (else the ``shape`` attr) at the
    ``offsets`` attr, or at the ``Offsets`` tensor: then one ``take`` a
    dim from its start clamped into range, as ``lax.dynamic_slice``
    clamps, read on the device (the grad of each is a sorted add of the
    dim's few slices, not of every element)."""
    x = single(ins, "X")
    y = single(ins, "Y")
    shape = list(y.shape) if y is not None else attrs.get("shape")
    off = single(ins, "Offsets")
    if off is not None:
        off = off.reshape(-1).long()
        out = x
        for i, s in enumerate(shape):
            start = off[i].clamp(0, x.shape[i] - s)
            out = take(out, start + torch.arange(s, device=x.device), i)
        return {"Out": [out]}
    offsets = attrs.get("offsets") or [0] * x.ndim
    return {"Out": [x[tuple(slice(o, o + s)
                            for o, s in zip(offsets, shape))]]}


@register_op("pad_constant_like", no_grad_inputs=("X",))
def pad_constant_like(ctx, ins, attrs):
    """Y padded at the end of each dim up to X's shape with
    ``pad_value``."""
    x, y = single(ins, "X"), single(ins, "Y")
    pads = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        pads += [0, xs - ys]
    return {"Out": [F.pad(y, pads, value=attrs.get("pad_value", 0.0))]}


@register_op("multiplex", no_grad_inputs=("Ids",))
def multiplex(ctx, ins, attrs):
    """Row i of ``X[Ids[i]]``: a ``take`` from the stacked inputs."""
    xs = torch.stack(ins.get("X", []))        # [K, B, D]
    ids = single(ins, "Ids").reshape(-1).long()
    k, b = xs.shape[0], xs.shape[1]
    rows = ids * b + torch.arange(b, device=xs.device)
    return {"Out": [take(xs.reshape((k * b,) + tuple(xs.shape[2:])),
                         rows)]}


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(ctx, ins, attrs):
    """out[b, k] = x[b] @ Weight[k] @ y[b] + Bias[k]."""
    x, y, w = single(ins, "X"), single(ins, "Y"), single(ins, "Weight")
    out = torch.einsum("bm,kmn,bn->bk", x, w, y)
    bias = single(ins, "Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return {"Out": [out]}


@register_op("rank_loss", no_grad_inputs=("Label",))
def rank_loss(ctx, ins, attrs):
    """RankNet's pairwise loss: ``log(1 + e^d) - Label * d``, d = Left -
    Right."""
    d = single(ins, "Left") - single(ins, "Right")
    return {"Out": [torch.log1p(torch.exp(d)) - single(ins, "Label") * d]}


@register_op("margin_rank_loss", no_grad_inputs=("Label",))
def margin_rank_loss(ctx, ins, attrs):
    """``max(0, -Label * (X1 - X2) + margin)`` and where it is positive
    (``torch.maximum``, whose grad splits a tie as the JAX package's
    does)."""
    x1 = single(ins, "X1")
    z = -single(ins, "Label") * (x1 - single(ins, "X2")) + attrs.get(
        "margin", 0.0)
    act = torch.maximum(torch.zeros_like(z), z)
    return {"Out": [act], "Activated": [(act > 0).to(x1.dtype)]}


@register_op("bpr_loss", no_grad_inputs=("Label",))
def bpr_loss(ctx, ins, attrs):
    """Bayesian personalised ranking: ``-mean_j log sigmoid(x[label] -
    x[j])`` over the other C - 1 classes, [B, 1]. The label's logit is a
    ``take``."""
    x = single(ins, "X")                      # [B, C]
    label = single(ins, "Label").reshape(-1).long()
    b, c = x.shape
    cols = torch.arange(c, device=x.device)
    pos = take(x.reshape(-1), torch.arange(b, device=x.device) * c
               + label).reshape(b, 1)
    lsig = -torch.log1p(torch.exp(-(pos - x)))
    mask = cols[None, :] != label[:, None]
    return {"Y": [-torch.where(mask, lsig, 0.0).sum(1, keepdim=True)
                  / (c - 1)]}


@register_op("teacher_student_sigmoid_loss", no_grad_inputs=("Label",))
def teacher_student_sigmoid_loss(ctx, ins, attrs):
    """The sigmoid loss of the clipped logit: against the label as a soft
    target where it lies outside [0, 1] (a teacher's score), as a hard
    click label inside."""
    x = single(ins, "X").reshape(-1)
    label = single(ins, "Label").reshape(-1)
    z = torch.clamp(x, attrs.get("soft_max_lower_bound", -15.0),
                    attrs.get("soft_max_up_bound", 15.0))
    sp = torch.log1p(torch.exp(z))
    hard = sp - torch.where(label > 0.0, z, 0.0)
    soft = sp - label * z
    loss = torch.where((label < 0.0) | (label > 1.0), soft, hard)
    return {"Y": [loss.reshape(-1, 1)]}


@register_op("dice_loss_op", no_grad_inputs=("Label",))
def dice_loss_op(ctx, ins, attrs):
    """The batch mean of ``1 - (2 |X.L| + eps) / (|X| + |L| + eps)``, the
    sums over each sample."""
    x = single(ins, "X")
    label = single(ins, "Label").to(x.dtype)
    eps = attrs.get("epsilon", 1e-5)
    dims = tuple(range(1, x.ndim))
    inter = (x * label).sum(dims)
    union = x.sum(dims) + label.sum(dims)
    return {"Out": [(1.0 - (2 * inter + eps) / (union + eps)).mean()]}


@register_op("selu")
def selu(ctx, ins, attrs):
    x = single(ins, "X")
    scale = attrs.get("scale", 1.0507009873554805)
    alpha = attrs.get("alpha", 1.6732632423543772)
    return {"Out": [scale * torch.where(x > 0, x, alpha * torch.expm1(x))]}


@register_op("add_position_encoding")
def add_position_encoding(ctx, ins, attrs):
    """``alpha * X + beta * PE`` over [B, T, D], PE the sinusoids:
    ``sin(t / 10000^(i / (D/2)))`` in the first half of the features,
    ``cos`` in the second. An odd D raises, as the JAX package's
    broadcast of the [T, D-1] table fails."""
    x = single(ins, "X")
    b, t, d = x.shape
    if d % 2:
        raise ValueError(
            "add_position_encoding: an odd width %d: the [%d, %d] table "
            "does not broadcast against [%d, %d, %d]"
            % (d, t, d - 1, b, t, d))
    half = d // 2
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    div = torch.pow(10000.0, torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    pe = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], 1)
    return {"Out": [attrs.get("alpha", 1.0) * x
                    + attrs.get("beta", 1.0) * pe[None].to(x.dtype)]}


@register_op("data_norm", no_grad_inputs=())
def data_norm(ctx, ins, attrs):
    """X normalised by the accumulated statistics: mean ``BatchSum /
    BatchSize``, scale ``1 / sqrt(BatchSquareSum / BatchSize -
    mean^2)``."""
    x = single(ins, "X")
    bsize = torch.clamp(single(ins, "BatchSize"), min=1e-4)
    mean = single(ins, "BatchSum") / bsize
    var = single(ins, "BatchSquareSum") / bsize - mean * mean
    scale = 1.0 / torch.sqrt(torch.clamp(var, min=1e-4))
    return {"Y": [(x - mean[None]) * scale[None]], "Means": [mean],
            "Scales": [scale]}


# -- ops without a grad ------------------------------------------------------


@register_no_grad_op("mean_iou")
def mean_iou(ctx, ins, attrs):
    """The mean over present classes of intersection over union of the
    predicted and true class ids: ``OutMeanIou`` float32,
    ``OutWrong`` the predictions of each class that were wrong,
    ``OutCorrect`` those right (int64)."""
    pred = single(ins, "Predictions").reshape(-1).long()
    label = single(ins, "Labels").reshape(-1).long()
    cls = torch.arange(int(attrs["num_classes"]), device=pred.device)[:, None]
    is_p, is_l = pred[None, :] == cls, label[None, :] == cls
    inter = (is_p & is_l).sum(1).float()
    union = (is_p | is_l).sum(1).float()
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp(union, min=1.0), 0.0)
    mean = iou.sum() / torch.clamp(valid.sum(), min=1)
    return {"OutMeanIou": [mean], "OutWrong": [(is_p & ~is_l).sum(1)],
            "OutCorrect": [inter.long()]}


@register_no_grad_op("hash")
def hash_op(ctx, ins, attrs):
    """``num_hash`` hashes of each id modulo ``mod_by``, stacked on the
    second-to-last dim (int64). The hash is the JAX package's
    splitmix-style mix (``ops/common.py`` ``hash_op_bits``), not the
    reference's xxhash; from ``num_hash`` 3 on it raises
    ``OverflowError``, as the JAX package does."""
    x = single(ins, "X").long()
    mod_by = int(attrs.get("mod_by", 100000))
    return {"Out": [torch.stack(
        [hash_op_bits(x, k) % mod_by
         for k in range(int(attrs.get("num_hash", 1)))], dim=-2)]}


@register_no_grad_op("ctc_greedy_decoder")
def ctc_greedy_decoder(ctx, ins, attrs):
    """Greedy CTC decoding of [B, T, C] scores: each step's first best
    class, repeats collapsed and blanks dropped, the kept ids moved to
    the front of the row and -1 after them (int64), with each row's
    count. The kept ids scatter to distinct columns; the dropped ones to
    a spare column past T, which is cut."""
    x = single(ins, "Input")
    blank = int(attrs.get("blank", 0))
    ids = x.argmax(-1)                        # [B, T], first best
    b, t = ids.shape
    prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype,
                                 device=ids.device), ids[:, :-1]], 1)
    keep = (ids != blank) & (ids != prev)
    col = torch.where(keep, keep.long().cumsum(1) - 1, t)
    out = torch.full((b, t + 1), -1, dtype=torch.int64, device=ids.device)
    out = out.scatter(1, col, torch.where(keep, ids, -1))
    return {"Out": [out[:, :t]], "OutLength": [keep.sum(1)]}


@register_no_grad_op("isinf")
def isinf(ctx, ins, attrs):
    return {"Out": [torch.isinf(single(ins, "X")).any().reshape(1)]}


@register_no_grad_op("isnan")
def isnan(ctx, ins, attrs):
    return {"Out": [torch.isnan(single(ins, "X")).any().reshape(1)]}


@register_no_grad_op("isfinite_reduce")
def isfinite_reduce(ctx, ins, attrs):
    return {"Out": [torch.isfinite(single(ins, "X")).all().reshape(1)]}


@register_no_grad_op("is_empty")
def is_empty(ctx, ins, attrs):
    """[1] bool, a fill on the device (no host copy)."""
    x = single(ins, "X")
    return {"Out": [torch.full((1,), x.numel() == 0, dtype=torch.bool,
                               device=x.device)]}


# -- samplers ---------------------------------------------------------------


@register_op("grid_sampler", no_grad_inputs=())
def grid_sampler(ctx, ins, attrs):
    """Bilinear sampling of NCHW X at the [N, H', W', 2] grid's (x, y) in
    [-1, 1], the JAX package's composition (not ``F.grid_sample``): the
    corner indices clipped into the image, the weights taken from the
    clipped lower corner, so a point past the border weighs its nearest
    pixels as no padding mode of ``F.grid_sample`` does. The corners are
    rows of the [N*H*W, C] image gathered by ``take``."""
    x = single(ins, "X")
    grid = single(ins, "Grid")
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.clamp(torch.floor(gx).long(), 0, w - 1)
    y0 = torch.clamp(torch.floor(gy).long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = (gx - x0.to(gx.dtype))[:, None]
    wy = (gy - y0.to(gy.dtype))[:, None]
    pixels = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    base = (torch.arange(n, device=x.device) * (h * w)).reshape(n, 1, 1)

    def gather(yi, xi):
        return take(pixels, base + yi * w + xi).reshape(
            tuple(yi.shape) + (c,)).permute(0, 3, 1, 2)

    v00, v01 = gather(y0, x0), gather(y0, x1)
    v10, v11 = gather(y1, x0), gather(y1, x1)
    out = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
           + v10 * wy * (1 - wx) + v11 * wy * wx)
    return {"Output": [out]}


def _affine_grid_capturable(op):
    """The shape comes from the attr, or from a tensor read on the
    host."""
    return bool(op.attrs.get("output_shape")) or not any(
        op.inputs.get("OutputShape", []))


@register_op("affine_grid", no_grad_inputs=(),
             capturable=_affine_grid_capturable)
def affine_grid(ctx, ins, attrs):
    """Theta [N, 2, 3] applied to the [H, W] grid of (x, y, 1) spanning
    [-1, 1]: the [N, H, W, 2] sampling grid. The output shape is the
    ``output_shape`` attr; without it the ``OutputShape`` tensor, read on
    the host (a device sync, so such an op is not captured)."""
    theta = single(ins, "Theta")
    out_shape = attrs.get("output_shape")
    if not out_shape:
        shape_in = single(ins, "OutputShape")
        if shape_in is None or shape_in.device.type == "meta":
            raise ValueError("affine_grid needs output_shape as an attr, "
                             "or an OutputShape tensor to read at run time")
        out_shape = [int(v) for v in shape_in.reshape(-1).tolist()]
    _, _, h, w = out_shape
    kw = {"dtype": torch.float32, "device": theta.device}
    gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, **kw),
                            torch.linspace(-1.0, 1.0, w, **kw),
                            indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)  # [H, W, 3]
    return {"Output": [torch.einsum("hwk,njk->nhwj", base, theta)]}


@register_op("psroi_pool", no_grad_inputs=("ROIs", "RoisBatchIdx"))
def psroi_pool(ctx, ins, attrs):
    """Position-sensitive RoI pooling: bin (i, j) of output channel o is
    the mean of input channel ``o * ph * pw + i * pw + j`` at 4 x 4
    sample points of the bin, each point's coordinate clipped into the
    image and truncated to a pixel, as the JAX package samples. Only
    the channel each bin reads is gathered (``take`` of the flat input,
    R x oc x ph x pw x 16 values), not every channel at every point."""
    x = single(ins, "X")                      # [N, oc*ph*pw, H, W]
    rois = single(ins, "ROIs")                # [R, 4] x1, y1, x2, y2
    bidx = single(ins, "RoisBatchIdx")
    n_roi = rois.shape[0]
    dev = x.device
    bidx = (torch.zeros(n_roi, dtype=torch.int64, device=dev)
            if bidx is None else bidx.reshape(-1).long())
    oc, ph, pw = (int(attrs[k]) for k in (
        "output_channels", "pooled_height", "pooled_width"))
    _, c, h, w = x.shape
    ratio = 4
    x1, y1, x2, y2 = (rois * attrs.get("spatial_scale", 1.0)).unbind(1)
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)

    def points(lo, extent, bins, size):
        at = torch.arange(bins * ratio, dtype=rois.dtype, device=dev) + 0.5
        return torch.clamp(lo[:, None] + at[None] * extent[:, None]
                           / (bins * ratio), 0, size - 1).long()

    gy = points(y1, rh, ph, h).reshape(n_roi, 1, ph, ratio, 1, 1)
    gx = points(x1, rw, pw, w).reshape(n_roi, 1, 1, 1, pw, ratio)
    ch = (torch.arange(oc, device=dev).reshape(oc, 1, 1) * (ph * pw)
          + torch.arange(ph, device=dev).reshape(1, ph, 1) * pw
          + torch.arange(pw, device=dev).reshape(1, 1, pw)).reshape(
              1, oc, ph, 1, pw, 1)
    flat = ((bidx.reshape(n_roi, 1, 1, 1, 1, 1) * c + ch) * h + gy) * w + gx
    vals = take(x.reshape(-1), flat).reshape(flat.shape)
    return {"Out": [vals.mean(dim=(3, 5))]}


@register_op("tree_conv", no_grad_inputs=("EdgeSet",))
def tree_conv(ctx, ins, attrs):
    """Tree-based convolution (TBCNN) over NodesVector [B, N, F] and
    1-based parent->child EdgeSet [B, E, 2] (read up to the first pair
    with a 0), Filter [F, 3, O, M]: each node's patch (the nodes within
    ``max_depth - 1`` steps below it) weighted by the continuous binary
    tree's eta_l, eta_r and eta_t, as three dense [N+1, N+1] coefficient
    matrices a sample contracted with the features, batched over the
    samples. Out [B, N, O, M], zero past each sample's node count.

    Invalid edges write node 0's row, column and entries, which are
    cut, so which of several writes lands there does not matter; a
    node's index and sibling count are written once, by its one parent's
    edge."""
    feats = single(ins, "NodesVector")
    edges = single(ins, "EdgeSet").long()
    wf = single(ins, "Filter")
    max_depth = int(attrs.get("max_depth", 2))
    b, n, _ = feats.shape
    dev, dt = feats.device, feats.dtype
    u, v = edges[..., 0], edges[..., 1]
    valid = torch.cumprod(((u != 0) & (v != 0)).long(), dim=1).bool()
    node_count = valid.sum(1) + 1
    # a node past N is dropped, as the JAX package's .at[] drop mode:
    # here it lands on node 0
    uu = torch.where(valid & (u <= n), u, 0)
    vv = torch.where(valid & (v <= n), v, 0)
    bi = torch.arange(b, device=dev)[:, None].expand_as(uu)
    adj = torch.zeros((b, n + 1, n + 1), dtype=dt, device=dev).index_put(
        (bi, uu, vv), torch.ones((), dtype=dt, device=dev))
    real = torch.arange(n + 1, device=dev) > 0
    adj = adj * (real[:, None] & real[None, :]).to(dt)
    # each edge's place among its parent's edges, in edge order
    same = ((u[:, None, :] == u[:, :, None]) & valid[:, None, :]
            & valid[:, :, None])
    earlier = torch.tril(torch.ones((u.shape[1],) * 2, dtype=torch.bool,
                                    device=dev), diagonal=-1)
    index_n = torch.zeros((b, n + 1), dtype=dt, device=dev).index_put(
        (bi, vv), (1 + (same & earlier).sum(2)).to(dt))
    pclen_n = torch.zeros((b, n + 1), dtype=dt, device=dev).index_put(
        (bi, vv), same.sum(2).to(dt))
    # depth(root u, node v): the first power of adj reaching v, below
    # max_depth
    md = float(max_depth)
    eye = torch.eye(n + 1, dtype=torch.bool, device=dev)
    depth = torch.where(eye, 0.0, md).expand(b, n + 1, n + 1)
    reach = adj
    for d in range(1, max_depth):
        depth = torch.where((depth >= md) & (reach > 0), float(d), depth)
        if d + 1 < max_depth:
            reach = ((reach @ adj) > 0).to(dt)
    nodes = torch.arange(n + 1, device=dev)
    valid_node = (nodes[None] >= 1) & (nodes[None] <= node_count[:, None])
    in_patch = ((depth < md) & valid_node[:, :, None]
                & valid_node[:, None, :])
    idx = torch.where(eye, 1.0, index_n[:, None, :])
    pcl = torch.where(eye, 1.0, pclen_n[:, None, :])
    eta_t = (md - depth) / md
    frac = torch.where(pcl == 1, 0.5,
                       (idx - 1.0) / torch.clamp(pcl - 1.0, min=1.0))
    eta_l = (1.0 - eta_t) * frac
    eta_r = (1.0 - eta_t) * (1.0 - eta_l)
    coef = torch.where(in_patch[:, None],
                       torch.stack([eta_l, eta_r, eta_t], 1),
                       0.0)[:, :, 1:, 1:]
    patch = torch.einsum("bcuv,bvf->bucf", coef.to(dt), feats)
    return {"Out": [torch.einsum("bucf,fcom->buom", patch, wf)]}


# -- 3-D convolution and pooling --------------------------------------------


@register_op("conv3d")
def conv3d(ctx, ins, attrs):
    """NCDHW convolution with an OIDHW filter, symmetric padding, on
    cuDNN (the engine selects its deterministic algorithms); float32
    accumulates in float32 and the output takes the input's dtype."""
    x, w = single(ins, "Input"), single(ins, "Filter")
    out = F.conv3d(x, w, stride=tuple(attrs.get("strides", [1, 1, 1])),
                   padding=tuple(attrs.get("paddings", [0, 0, 0])),
                   dilation=tuple(attrs.get("dilations", [1, 1, 1])),
                   groups=int(attrs.get("groups", 1)))
    return {"Output": [out.to(x.dtype)]}


@register_op("conv3d_transpose")
def conv3d_transpose(ctx, ins, attrs):
    """The transposed convolution of an NCDHW input with an IODHW filter
    (I = C_in, O = C_out / groups), (D - 1) * s - 2p + d * (k - 1) + 1
    deep, summed in float64 and rounded once, as ``conv2d_transpose``
    sums (``ops/nn_ops.py``): one GEMM lays each input voxel's kd x kh x
    kw patch of every output channel, and each of the k^3 filter taps
    adds its strided slab of the patches into the output in a fixed
    order (``F.fold`` has no 3-D form; one ``F.conv_transpose3d`` on
    float64 operands sums alike but took about 100x this forward's time
    on an H100, PERF.md §7). A float32 transposed convolution
    sums C_in * k^3 / s^3 products a voxel in one float32 register; a
    norm after it magnifies that rounding (PERF.md, Findings). The grad
    is the slabs' slices and a GEMM, float64 and deterministic."""
    x, w = single(ins, "Input"), single(ins, "Filter")
    s = list(attrs.get("strides", [1, 1, 1]))
    p = list(attrs.get("paddings", [0, 0, 0]))
    d = list(attrs.get("dilations", [1, 1, 1]))
    g = int(attrs.get("groups", 1))
    n, c_in = x.shape[:2]
    sp = list(x.shape[2:])
    o_g, ks = w.shape[1], list(w.shape[2:])
    taps = ks[0] * ks[1] * ks[2]
    cols = torch.matmul(
        w.double().reshape(g, c_in // g, o_g * taps).transpose(1, 2),
        x.double().reshape(n, g, c_in // g, sp[0] * sp[1] * sp[2]))
    cols = cols.reshape([n, g * o_g] + ks + sp)
    full = [(sp[i] - 1) * s[i] + d[i] * (ks[i] - 1) + 1 for i in range(3)]
    out = cols.new_zeros([n, g * o_g] + full)
    both = (slice(None), slice(None))
    for tap in itertools.product(*(range(k) for k in ks)):
        out[both + tuple(slice(t * d[i], t * d[i] + (sp[i] - 1) * s[i] + 1,
                               s[i]) for i, t in enumerate(tap))] += \
            cols[both + tap]
    out = out[both + tuple(slice(p[i], full[i] - p[i]) for i in range(3))]
    return {"Output": [out.to(torch.result_type(x, w))]}


@register_op("pool3d")
def pool3d(ctx, ins, attrs):
    """Max or average pooling over NCDHW windows, as ``pool2d``
    (``ops/nn_ops.py``): the input padded explicitly (-inf for max, 0
    for average), the windows run unpadded, so a tie's grad goes where
    the JAX package's goes (the first maximum of the window); average
    pooling divides by the window's in-input count (``exclusive``) or
    its size. Global pooling takes the whole volume."""
    x = single(ins, "X")
    ksize = list(attrs.get("ksize", [1, 1, 1]))
    strides = list(attrs.get("strides", ksize))
    pads = list(attrs.get("paddings", [0, 0, 0]))
    if attrs.get("global_pooling", False):
        ksize = list(x.shape[2:])
        strides, pads = ksize, [0, 0, 0]
    pad = (pads[2], pads[2], pads[1], pads[1], pads[0], pads[0])
    if attrs.get("pooling_type", "max") == "max":
        return {"Out": [F.max_pool3d(F.pad(x, pad, value=float("-inf")),
                                     ksize, strides)]}
    summed = F.avg_pool3d(F.pad(x, pad), ksize, strides, divisor_override=1)
    if attrs.get("exclusive", True):
        ones = F.pad(torch.ones_like(x[:1, :1]), pad)
        return {"Out": [summed / F.avg_pool3d(ones, ksize, strides,
                                              divisor_override=1)]}
    return {"Out": [summed / float(ksize[0] * ksize[1] * ksize[2])]}


# -- the sampled heads -------------------------------------------------------


@register_op("nce", no_grad_inputs=("Label", "SampleWeight"),
             needs_rng=True, seed_range=_seed_range)
def nce(ctx, ins, attrs):
    """Noise-contrastive estimation with uniform noise: the label and
    ``num_neg_samples`` negatives a row, drawn on the device from the
    op's seed (``uniform_ints``, so a captured step draws anew at each
    replay and the card draws the CPU's ids), scored against their
    ``Weight`` rows (and ``Bias``) less ``log(k) - log(C)``. The rows are
    one ``take`` of the [B, 1 + k] ids, so the weight grad is one sorted
    ``index_put_``."""
    x = single(ins, "Input")                  # [B, D]
    label = single(ins, "Label").reshape(-1).long()
    w = single(ins, "Weight")                 # [C, D]
    bias = single(ins, "Bias")
    k = int(attrs.get("num_neg_samples", 10))
    n_cls = int(attrs.get("num_total_classes", w.shape[0]))
    b = x.shape[0]
    neg = uniform_ints(ctx.seed(SEED_HIGH), (b, k), n_cls, x.device)
    ids = torch.cat([label[:, None], neg], 1)  # [B, 1 + k]
    logits = torch.einsum("bd,bkd->bk", x, take(w, ids).reshape(
        b, k + 1, w.shape[1]))
    if bias is not None:
        logits = logits + take(bias.reshape(-1), ids).reshape(b, k + 1)
    logits = logits - (math.log(k) - math.log(n_cls))
    loss = (-F.logsigmoid(logits[:, 0])
            - F.logsigmoid(-logits[:, 1:]).sum(1))
    return {"Cost": [loss.reshape(b, 1)], "SampleLogits": [logits],
            "SampleLabels": [ids]}


@register_op("hierarchical_sigmoid", no_grad_inputs=("Label",))
def hierarchical_sigmoid(ctx, ins, attrs):
    """Hierarchical sigmoid over the complete binary tree of
    ``num_classes`` leaves: class c walks from node c + C up to the root,
    ``ceil(log2 C)`` levels at most; internal node m scores with weight
    row m - 1, and each step's loss is ``softplus(s) - bit * s``, the bit
    1 for a right child (the reference's sign). All the levels' rows are
    one ``take`` of [B, levels] ids, so the weight grad is one sorted
    ``index_put_`` over them (the root's row is in every example's
    path). ``PreOut`` is zeros, as in the JAX package."""
    x = single(ins, "X")                      # [B, D]
    w = single(ins, "W")                      # [C - 1, D]
    label = single(ins, "Label").reshape(-1).long()
    bias = single(ins, "Bias")
    n_cls = int(attrs["num_classes"])
    b = x.shape[0]
    levels = max(1, math.ceil(math.log2(n_cls)))
    node = label + n_cls
    rows, bits, valid = [], [], []
    for _ in range(levels):
        valid.append(node > 1)
        bits.append(node % 2)
        node = torch.clamp(node // 2, 1, 2 * n_cls - 1)
        rows.append(torch.clamp(node - 1, 0, w.shape[0] - 1))
    rows = torch.stack(rows, 1)               # [B, levels]
    s = torch.einsum("bd,bld->bl", x, take(w, rows).reshape(
        b, levels, w.shape[1]))
    if bias is not None:
        s = s + take(bias.reshape(-1), rows).reshape(b, levels)
    step = (torch.logaddexp(torch.zeros_like(s), s)
            - torch.stack(bits, 1).to(torch.float32) * s)
    loss = torch.where(torch.stack(valid, 1), step, 0.0).sum(1)
    return {"Out": [loss.reshape(b, 1)],
            "PreOut": [torch.zeros((b, levels), dtype=x.dtype,
                                   device=x.device)]}


# -- random ops ----------------------------------------------------------------


@register_no_grad_op("sampling_id", needs_rng=True, seed_range=_seed_range)
def sampling_id(ctx, ins, attrs):
    """One id a row of the [B, C] probabilities (each clipped below at
    1e-20, as the JAX package's ``log(max(x, 1e-20))`` weights): the
    first class whose running sum passes a uniform draw from the op's
    seed scaled to the row's total (int64 [B]). Captured, since the draw
    is the counter hash of the seed table's entry."""
    x = single(ins, "X")
    cdf = torch.clamp(x, min=1e-20).cumsum(-1)
    u = uniform_floats(ctx.seed(SEED_HIGH), (x.shape[0], 1), x.device)
    ids = torch.searchsorted(cdf, u * cdf[:, -1:], right=True)
    return {"Out": [ids.reshape(-1).clamp(max=x.shape[-1] - 1)]}


@register_no_grad_op("random_crop", needs_rng=True, seed_range=_seed_range)
def random_crop(ctx, ins, attrs):
    """A crop of the trailing dims of X to the ``shape`` attr, at one
    offset for the whole batch, each dim's drawn uniformly in [0, size -
    crop] from the op's seed; a gather at device offsets, captured (the
    offsets' ranges stay Python ints: a host-to-device copy cannot be
    captured)."""
    x = single(ins, "X")
    shape = list(attrs["shape"])
    lead = x.ndim - len(shape)
    h = hash_bits(ctx.seed(SEED_HIGH), len(shape), x.device)
    starts = [(h[i] * (max(x.shape[lead + i] - s, 0) + 1)) >> 32
              for i, s in enumerate(shape)]
    idx = tuple((starts[i] + torch.arange(s, device=x.device)).reshape(
        [-1 if j == i else 1 for j in range(len(shape))])
        for i, s in enumerate(shape))
    return {"Out": [x[(slice(None),) * lead + idx]]}


def _batch_size_like_shape(ins, attrs):
    ref = single(ins, "Input")
    shape = list(attrs["shape"])
    shape[int(attrs.get("output_dim_idx", 0))] = ref.shape[
        int(attrs.get("input_dim_idx", 0))]
    return shape, ref.device


@register_no_grad_op("uniform_random_batch_size_like", needs_rng=True,
                     seed_range=_seed_range)
def uniform_random_batch_size_like(ctx, ins, attrs):
    """Float32 uniforms in [min, max) of the attrs' shape with the
    batch dim of ``Input`` (the dtype attr is not read, as in the JAX
    package); counter-hash draws from the op's seed, captured."""
    shape, dev = _batch_size_like_shape(ins, attrs)
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = uniform_floats(ctx.seed(SEED_HIGH), shape, dev)
    return {"Out": [lo + u * (hi - lo)]}


@register_no_grad_op("gaussian_random_batch_size_like", needs_rng=True,
                     seed_range=_seed_range)
def gaussian_random_batch_size_like(ctx, ins, attrs):
    """Float32 normals (``mean``, ``std``) of the attrs' shape with the
    batch dim of ``Input``: Box-Muller over two counter-hash uniform
    draws from the op's seed, captured."""
    shape, dev = _batch_size_like_shape(ins, attrs)
    seed = ctx.seed(SEED_HIGH)
    u1 = uniform_floats(seed, shape, dev, stream=0)
    u2 = uniform_floats(seed, shape, dev, stream=1)
    z = torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(2.0 * math.pi * u2)
    return {"Out": [z * attrs.get("std", 1.0) + attrs.get("mean", 0.0)]}


# -- host ops ------------------------------------------------------------------


def _host_readable(x):
    """Whether ``x`` has values the host can read: not a ``meta`` tensor
    (build-time shape inference) nor a function transform's wrapper (the
    generic grad running the lowering under ``torch.func.vjp``)."""
    return (x.device.type != "meta"
            and not torch._C._functorch.is_functorch_wrapped_tensor(x))


@register_op("print_op", capturable=False)
def print_op(ctx, ins, attrs):
    """Prints ``message`` and X's values on the host and passes X through
    (a device sync, so its block runs eagerly)."""
    x = single(ins, "X")
    if _host_readable(x):
        print("%s %s" % (attrs.get("message", ""),
                         x.detach().cpu().numpy()), flush=True)
    return {"Out": [x]}


# py_func: arbitrary Python in the graph. The callables are kept here by
# id, in the order the layers register them, from 0 as in the JAX
# package, so a desc built the same way in each package names the same
# ids. The op copies its inputs to the host, calls the function on numpy
# arrays and copies the results to the op's device.
_PY_FUNC_REGISTRY = {}
_PY_FUNC_IDS = {}


def register_py_func(fn):
    """The id of ``fn``, registering it once: a program rebuilt with the
    same callable reuses its id (the registry keeps ``fn`` alive, so its
    ``id`` stays its own)."""
    fid = _PY_FUNC_IDS.get(id(fn))
    if fid is not None and _PY_FUNC_REGISTRY.get(fid) is fn:
        return fid
    fid = len(_PY_FUNC_REGISTRY)
    _PY_FUNC_REGISTRY[fid] = fn
    _PY_FUNC_IDS[id(fn)] = fid
    return fid


def _to_device(arrays, dtypes, device):
    """Host results (one array or a list) as tensors on ``device``, each
    in its numpy dtype of ``dtypes``."""
    arrays = arrays if isinstance(arrays, (list, tuple)) else [arrays]
    return [torch.as_tensor(np.asarray(a, dtype=d)).to(device)
            for a, d in zip(arrays, dtypes)]


@register_op("py_func", capturable=False)
def py_func_op(ctx, ins, attrs):
    """Calls the registered ``func_id`` on the inputs' values as numpy
    arrays; its results, of the ``out_shapes``/``out_dtypes`` attrs, come
    back on the op's device."""
    xs = ins.get("X", [])
    if ctx.device.type == "meta":
        # build-time shape inference: the outputs keep the shapes and
        # dtypes their vars were declared with (the attrs')
        return {}
    out = _PY_FUNC_REGISTRY[int(attrs["func_id"])](
        *[x.detach().cpu().numpy() for x in xs])
    return {"Out": _to_device(out, attrs["out_dtypes"], ctx.device)}


@register_no_grad_op("py_func_grad", capturable=False)
def py_func_grad(ctx, ins, attrs):
    """Calls the registered ``backward_func_id`` on the forward inputs
    and then the output grads, as numpy arrays; an output grad that is
    absent (an output outside the loss) is zeros, so the function's
    arguments never shift. The input grads come back in the inputs'
    dtypes."""
    xs = ins.get("X", [])
    if ctx.device.type == "meta":
        return {"X@GRAD": [torch.empty_like(x) for x in xs]}
    ogs = [g.detach().cpu().numpy() if g is not None
           else np.zeros(tuple(s), d)
           for g, s, d in zip(ins.get("Out@GRAD", []), attrs["out_shapes"],
                              attrs["out_dtypes"])]
    host = [x.detach().cpu().numpy() for x in xs]
    grads = _PY_FUNC_REGISTRY[int(attrs["backward_func_id"])](*host, *ogs)
    return {"X@GRAD": _to_device(grads, [h.dtype for h in host],
                                 ctx.device)}


# load(): the array is read from its file at the op's first run on a
# device and kept there by (file_path, fp16, device), so the warm-up run
# before a capture fills it and a captured replay reads no file and
# copies nothing from the host. The output is a copy of the kept array.
_LOAD_ON_DEVICE = {}


def load_from_file(file_path, fp16):
    """A saved array: ``.npy``, else the reference's tensor stream
    (``compat.load_reference_var``; a BF16 stream is a torch tensor); as
    float16 with ``fp16``."""
    with open(file_path, "rb") as f:
        magic = f.read(6)
    if magic.startswith(b"\x93NUMPY"):
        arr = np.load(file_path)
    else:
        from paddle_tpu_torch import compat

        arr = compat.load_reference_var(file_path)
        if isinstance(arr, torch.Tensor):
            return arr.half() if fp16 else arr
    return arr.astype(np.float16) if fp16 else arr


@register_no_grad_op("load_value")
def load_value(ctx, ins, attrs):
    key = (attrs["file_path"], bool(attrs.get("load_as_fp16", False)),
           str(ctx.device))
    if key not in _LOAD_ON_DEVICE:
        _LOAD_ON_DEVICE[key] = torch.as_tensor(
            load_from_file(*key[:2])).to(ctx.device)
    return {"Out": [_LOAD_ON_DEVICE[key].clone()]}
