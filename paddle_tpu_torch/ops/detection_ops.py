"""Detection ops — port of ``paddle_tpu/ops/detection_ops.py``, the whole
file: the priors and anchors (``prior_box`` :31, ``density_prior_box``
:90, ``anchor_generator`` :141), the box ops (``box_coder`` :179,
``iou_similarity`` :269, ``box_clip`` :277, ``polygon_box_transform``
:297), matching (``bipartite_match`` :311, ``target_assign`` :360,
``gather_encoded`` :534), NMS (``multiclass_nms`` :380,
``generate_proposals`` :672), the RoI ops (``roi_align`` :452,
``roi_pool`` :503, ``roi_perspective_transform`` :949), the samplers
(``rpn_target_assign`` :750, ``generate_proposal_labels`` :822,
``generate_mask_labels`` :1065), ``yolov3_loss`` :547 and
``similarity_focus`` :913, with their shared helpers.

Every output has a static shape: kept detections are fixed-capacity rows
padded as the reference pads them (label -1 rows, zero rows, and count
outputs). The greedy procedures the reference runs as ``fori_loop``s
(the bipartite match, both NMS scans, similarity_focus) are one Python
loop over the step index here, with every image and class batched into
the tensors of that loop; no step reads a value on the host, so a CUDA
graph captures them. Rankings take ties as the reference does:
``topk_lowest_index_first`` for ``lax.top_k``, stable sorts for
``jnp.argsort``, and ``argmax``'s first index. The scatter-max updates
are written as a maximum over a one-hot comparison (no atomics), and the
scatters that drop out-of-range ids drop them here too. Every gather
whose grad adds rows back goes through ``ops/common.py`` ``take``, whose
grad is a sorted ``index_put_`` that the card repeats bit for bit. The
two samplers draw their priorities from the op's entry of the run's seed
table (``uniform_floats``), as ``nce`` draws its negatives, so a step
that samples is captured and the card draws what the CPU draws.

Constants built from attrs (prior sizes, anchors, weights) are written
by fills, never copied from the host, so a captured step may hold them.
"""

import math

import torch

from paddle_tpu_torch.core.registry import register_no_grad_op, register_op
from paddle_tpu_torch.ops.common import (
    single, take, topk_lowest_index_first, uniform_floats,
)

SEED_HIGH = 2 ** 32


def _seed_range(attrs):
    """The samplers draw one seed a run, in [0, 2**32)."""
    return SEED_HIGH


def _const(values, device):
    """A float32 tensor of the Python numbers ``values``, written by fills
    on ``device`` (no host-to-device copy)."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        out[i].fill_(float(v))
    return out


def _steps(n, t):
    """``range(n)`` for a scan over ``t``'s steps; none on ``meta`` (at
    build-time shape inference, where a scan's state keeps its shape and
    a batch dim of -1 would make it thousands of steps long)."""
    return range(0 if t.device.type == "meta" else n)


def _div(x, k):
    """``x / k`` for a Python number ``k``, divided as by a tensor: CUDA
    multiplies by the reciprocal of a host scalar, which rounds otherwise
    than the CPU's division and moves a sample across a pixel or a quad's
    edge."""
    return x / torch.full((), float(k), dtype=x.dtype, device=x.device)


# -- priors / anchors -------------------------------------------------------

def _expand_aspect_ratios(aspect_ratios, flip):
    out = [1.0]
    for ar in aspect_ratios:
        if any(abs(ar - e) < 1e-6 for e in out):
            continue
        out.append(float(ar))
        if flip:
            out.append(1.0 / float(ar))
    return out


def _grid_boxes(cx, cy, bw, bh, h, w, device):
    """[H, W, P, 4] corner boxes of the per-prior centres ``cx`` [W, P] /
    ``cy`` [H, P] (or [W] / [H]) and half sizes ``bw``/``bh`` [P]."""
    p = bw.shape[0]
    cx = cx.reshape(1, w, -1).expand(h, w, p)
    cy = cy.reshape(h, 1, -1).expand(h, w, p)
    bw = bw.reshape(1, 1, p).expand(h, w, p)
    bh = bh.reshape(1, 1, p).expand(h, w, p)
    return cx, cy, bw, bh


def _prior_outputs(cx, cy, bw, bh, img_w, img_h, clip, variances, device):
    boxes = torch.stack([_div(cx - bw, img_w), _div(cy - bh, img_h),
                         _div(cx + bw, img_w), _div(cy + bh, img_h)], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = _const(variances, device).expand(boxes.shape)
    return {"Boxes": [boxes], "Variances": [var]}


@register_no_grad_op("prior_box")
def prior_box(ctx, ins, attrs):
    """SSD prior boxes, [H, W, P, 4] normalized corners in the reference's
    ordering (``min_max_aspect_ratios_order`` included)."""
    feat = single(ins, "Input")   # [N, C, H, W]
    image = single(ins, "Image")  # [N, C, IH, IW]
    h, w = feat.shape[2], feat.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    ars = _expand_aspect_ratios(attrs.get("aspect_ratios", [1.0]),
                                attrs.get("flip", False))
    step_w = attrs.get("step_w", 0.0) or img_w / w
    step_h = attrs.get("step_h", 0.0) or img_h / h
    offset = attrs.get("offset", 0.5)
    mm_order = attrs.get("min_max_aspect_ratios_order", False)

    half = []   # (box_w / 2, box_h / 2) per prior
    for s, m in enumerate(min_sizes):
        if mm_order:
            half.append((m / 2.0, m / 2.0))
            if max_sizes:
                sq = math.sqrt(m * max_sizes[s]) / 2.0
                half.append((sq, sq))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                half.append((m * math.sqrt(ar) / 2.0,
                             m / math.sqrt(ar) / 2.0))
        else:
            for ar in ars:
                half.append((m * math.sqrt(ar) / 2.0,
                             m / math.sqrt(ar) / 2.0))
            if max_sizes:
                sq = math.sqrt(m * max_sizes[s]) / 2.0
                half.append((sq, sq))
    dev = feat.device
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offset) * step_w
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offset) * step_h
    parts = _grid_boxes(cx, cy, _const([a for a, _ in half], dev),
                        _const([b for _, b in half], dev), h, w, dev)
    return _prior_outputs(*parts, img_w, img_h, attrs.get("clip", False),
                          attrs.get("variances", [0.1, 0.1, 0.2, 0.2]), dev)


@register_no_grad_op("density_prior_box")
def density_prior_box(ctx, ins, attrs):
    """Densified priors: each fixed size sampled on a density x density
    sub-grid of its cell."""
    feat = single(ins, "Input")
    image = single(ins, "Image")
    h, w = feat.shape[2], feat.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    fixed_sizes = [float(s) for s in attrs.get("fixed_sizes", [])]
    fixed_ratios = [float(r) for r in attrs.get("fixed_ratios", [1.0])]
    densities = [int(d) for d in attrs.get("densities", [])]
    step_w = attrs.get("step_w", 0.0) or img_w / w
    step_h = attrs.get("step_h", 0.0) or img_h / h
    offset = attrs.get("offset", 0.5)

    rel = []   # (shift_x, shift_y, w / 2, h / 2) from the cell centre
    for size, density in zip(fixed_sizes, densities):
        shift = size / density
        for ar in fixed_ratios:
            bw = size * math.sqrt(ar) / 2.0
            bh = size / math.sqrt(ar) / 2.0
            for di in range(density):
                for dj in range(density):
                    rel.append((-size / 2.0 + shift / 2.0 + dj * shift,
                                -size / 2.0 + shift / 2.0 + di * shift,
                                bw, bh))
    dev = feat.device
    sx, sy, bw, bh = (_const([r[k] for r in rel], dev) for k in range(4))
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offset) * step_w
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offset) * step_h
    cx = cx[:, None] + sx[None, :]
    cy = cy[:, None] + sy[None, :]
    parts = _grid_boxes(cx, cy, bw, bh, h, w, dev)
    return _prior_outputs(*parts, img_w, img_h, attrs.get("clip", False),
                          attrs.get("variances", [0.1, 0.1, 0.2, 0.2]), dev)


@register_no_grad_op("anchor_generator")
def anchor_generator(ctx, ins, attrs):
    """RPN anchors, sizes x ratios at the image-scale stride, not
    normalized: [H, W, A, 4]."""
    feat = single(ins, "Input")
    h, w = feat.shape[2], feat.shape[3]
    sizes = [float(s) for s in attrs.get("anchor_sizes", [64., 128., 256.])]
    ratios = [float(r) for r in attrs.get("aspect_ratios", [0.5, 1.0, 2.0])]
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    stride = attrs.get("stride", [16.0, 16.0])
    offset = attrs.get("offset", 0.5)

    half = []
    for r in ratios:
        for s in sizes:
            area = stride[0] * stride[1]
            base_w = round(math.sqrt(area / r))
            base_h = round(base_w * r)
            half.append((s / stride[0] * base_w / 2.0,
                         s / stride[1] * base_h / 2.0))
    dev = feat.device
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offset) \
        * stride[0]
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offset) \
        * stride[1]
    cx, cy, bw, bh = _grid_boxes(cx, cy, _const([a for a, _ in half], dev),
                                 _const([b for _, b in half], dev), h, w,
                                 dev)
    anchors = torch.stack([cx - bw, cy - bh, cx + bw, cy + bh], dim=-1)
    var = _const(variances, dev).expand(anchors.shape)
    return {"Anchors": [anchors], "Variances": [var]}


# -- box arithmetic ---------------------------------------------------------

@register_op("box_coder", no_grad_inputs=("PriorBox", "PriorBoxVar"))
def box_coder(ctx, ins, attrs):
    """Encode targets against priors (``encode_center_size``: [N, 4]
    targets to [N, M, 4] offsets) or decode offsets into boxes
    (``decode_center_size``; ``axis`` picks the TargetBox dim the priors
    pair with)."""
    prior = single(ins, "PriorBox").reshape(-1, 4)        # [M, 4]
    pvar = single(ins, "PriorBoxVar")
    tb = single(ins, "TargetBox")
    code_type = attrs.get("code_type", "encode_center_size")
    one = 0.0 if attrs.get("box_normalized", True) else 1.0

    pw = prior[:, 2] - prior[:, 0] + one
    ph = prior[:, 3] - prior[:, 1] + one
    pcx = prior[:, 0] + pw / 2.0
    pcy = prior[:, 1] + ph / 2.0
    if pvar is not None:
        pvar = pvar.reshape(-1, 4)

    if code_type.lower().startswith("encode"):
        tw = (tb[:, 2] - tb[:, 0] + one)[:, None]
        th = (tb[:, 3] - tb[:, 1] + one)[:, None]
        tcx = (tb[:, 0] + (tb[:, 2] - tb[:, 0] + one) / 2.0)[:, None]
        tcy = (tb[:, 1] + (tb[:, 3] - tb[:, 1] + one) / 2.0)[:, None]
        ox = (tcx - pcx[None, :]) / pw[None, :]
        oy = (tcy - pcy[None, :]) / ph[None, :]
        ow = torch.log(torch.abs(tw / pw[None, :]))
        oh = torch.log(torch.abs(th / ph[None, :]))
        out = torch.stack([ox, oy, ow, oh], dim=-1)
        if pvar is not None:
            out = out / pvar[None, :, :]
        return {"OutputBox": [out]}

    axis = int(attrs.get("axis", 0))

    def ax(v):
        return v[None, :] if axis == 0 else v[:, None]

    if pvar is not None:
        tb = tb * (pvar[None, :, :] if axis == 0 else pvar[:, None, :])
    dcx = tb[..., 0] * ax(pw) + ax(pcx)
    dcy = tb[..., 1] * ax(ph) + ax(pcy)
    dw = torch.exp(tb[..., 2]) * ax(pw)
    dh = torch.exp(tb[..., 3]) * ax(ph)
    out = torch.stack([dcx - dw / 2.0, dcy - dh / 2.0,
                       dcx + dw / 2.0 - one, dcy + dh / 2.0 - one], dim=-1)
    return {"OutputBox": [out]}


def _encode_center_size(rois, gts, weights=None):
    """Center-size encoding of ``gts`` against ``rois`` ([R, 4] each) with
    the +1 pixel convention, divided by ``weights`` when given."""
    rw = torch.clamp(rois[:, 2] - rois[:, 0] + 1.0, min=1.0)
    rh = torch.clamp(rois[:, 3] - rois[:, 1] + 1.0, min=1.0)
    rcx, rcy = rois[:, 0] + rw / 2.0, rois[:, 1] + rh / 2.0
    gw = torch.clamp(gts[:, 2] - gts[:, 0] + 1.0, min=1.0)
    gh = torch.clamp(gts[:, 3] - gts[:, 1] + 1.0, min=1.0)
    gcx, gcy = gts[:, 0] + gw / 2.0, gts[:, 1] + gh / 2.0
    cols = [(gcx - rcx) / rw, (gcy - rcy) / rh,
            torch.log(gw / rw), torch.log(gh / rh)]
    if weights is not None:
        cols = [c / float(wt) for c, wt in zip(cols, weights)]
    return torch.stack(cols, dim=1)


def _subsample(mask, cap, priority):
    """Keep at most ``cap`` True entries of ``mask`` (last dim), chosen by
    ascending ``priority``, ties by index (the reference's
    shuffle-and-truncate sampler)."""
    key = torch.where(mask, priority, torch.full_like(priority, 2.0))
    rank = torch.argsort(torch.argsort(key, dim=-1, stable=True), dim=-1,
                         stable=True)
    return mask & (rank < cap)


def _pairwise_iou(x, y, normalized=True):
    """x: [..., N, 4], y: [..., M, 4] -> [..., N, M] IoU, zero where the
    union is not positive."""
    one = 0.0 if normalized else 1.0
    area_x = (x[..., 2] - x[..., 0] + one) * (x[..., 3] - x[..., 1] + one)
    area_y = (y[..., 2] - y[..., 0] + one) * (y[..., 3] - y[..., 1] + one)
    lt = torch.maximum(x[..., :, None, :2], y[..., None, :, :2])
    rb = torch.minimum(x[..., :, None, 2:], y[..., None, :, 2:])
    wh = torch.clamp(rb - lt + one, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_x[..., :, None] + area_y[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-10),
                       torch.zeros_like(inter))


@register_no_grad_op("iou_similarity")
def iou_similarity(ctx, ins, attrs):
    x = single(ins, "X")
    y = single(ins, "Y")
    return {"Out": [_pairwise_iou(x.reshape(-1, 4), y.reshape(-1, 4),
                                  attrs.get("box_normalized", True))]}


@register_no_grad_op("box_clip")
def box_clip(ctx, ins, attrs):
    """Clip [B, M, 4] (or [M, 4]) boxes to the image; ImInfo rows are
    (height, width, scale)."""
    boxes = single(ins, "Input")
    im_info = single(ins, "ImInfo")
    squeeze = boxes.ndim == 2
    if squeeze:
        boxes = boxes[None]
    h = (im_info[:, 0] / im_info[:, 2])[:, None] - 1.0
    w = (im_info[:, 1] / im_info[:, 2])[:, None] - 1.0

    def clip(v, hi):
        return torch.minimum(torch.clamp(v, min=0.0), hi)

    out = torch.stack([clip(boxes[..., 0], w), clip(boxes[..., 1], h),
                       clip(boxes[..., 2], w), clip(boxes[..., 3], h)],
                      dim=-1)
    return {"Output": [out[0] if squeeze else out]}


@register_no_grad_op("polygon_box_transform")
def polygon_box_transform(ctx, ins, attrs):
    """For each cell, the geometry channels' offsets become absolute vertex
    coordinates: 4 x (w, h) of the cell less the offset."""
    x = single(ins, "Input")  # [N, geo_channels, H, W]
    _, c, h, w = x.shape
    idx_w = torch.arange(w, dtype=x.dtype, device=x.device)[None, :] \
        .expand(h, w)
    idx_h = torch.arange(h, dtype=x.dtype, device=x.device)[:, None] \
        .expand(h, w)
    grid = torch.stack([idx_w, idx_h] * (c // 2), dim=0) * 4.0
    return {"Output": [grid[None] - x]}


# -- matching / assignment --------------------------------------------------

@register_no_grad_op("bipartite_match")
def bipartite_match(ctx, ins, attrs):
    """Greedy bipartite matching: min(N, M) steps, each taking the largest
    entry left (its first index on ties) and retiring its row and column;
    with ``match_type`` 'per_prediction', an unmatched column at or above
    ``dist_threshold`` also takes its best row. One loop for the whole
    batch."""
    dist = single(ins, "DistMat")
    if dist.ndim == 2:
        dist = dist[None]
    b, n, m = dist.shape
    dev = dist.device
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    row_free = torch.ones((b, n), dtype=torch.bool, device=dev)
    col_idx = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    col_dist = torch.zeros((b, m), dtype=dist.dtype, device=dev)
    neg = torch.full_like(dist, -1.0)
    for _ in _steps(min(n, m), dist):
        masked = torch.where(row_free[:, :, None] & (col_idx[:, None, :] < 0),
                             dist, neg).reshape(b, -1)
        best, flat = masked.max(dim=1)
        r, c = flat // m, flat % m
        ok = (best > 0)[:, None]
        row_free = row_free & ~((rows[None] == r[:, None]) & ok)
        hit = (cols[None] == c[:, None]) & ok
        col_idx = torch.where(hit, r[:, None].to(torch.int32), col_idx)
        col_dist = torch.where(hit, best[:, None], col_dist)
    if attrs.get("match_type", "bipartite") == "per_prediction":
        best_d, best_r = dist.max(dim=1)
        extra = (col_idx < 0) & (best_d >= attrs.get("dist_threshold", 0.5))
        col_idx = torch.where(extra, best_r.to(torch.int32), col_idx)
        col_dist = torch.where(extra, best_d, col_dist)
    return {"ColToRowMatchIndices": [col_idx],
            "ColToRowMatchDist": [col_dist]}


@register_no_grad_op("target_assign")
def target_assign(ctx, ins, attrs):
    """Rows of X ([N, D] per ground truth, or [B, N, D]) gathered by match
    index, ``mismatch_value`` where unmatched; OutWeight 1 where
    matched."""
    x = single(ins, "X")
    match = single(ins, "MatchIndices")                  # [B, M]
    if x.ndim == 2:
        x = x[None].expand((match.shape[0],) + tuple(x.shape))
    idx = torch.clamp(match, min=0).long()
    gathered = torch.gather(
        x, 1, idx[..., None].expand(idx.shape + (x.shape[-1],)))
    matched = (match >= 0)[..., None]
    out = torch.where(matched, gathered,
                      torch.full_like(gathered, attrs.get("mismatch_value",
                                                          0)))
    return {"Out": [out], "OutWeight": [matched.to(torch.float32)]}


@register_op("gather_encoded", no_grad_inputs=("MatchIndices",))
def gather_encoded(ctx, ins, attrs):
    """Encoded [N_gt, M, 4] and a [1, M] match -> the per-prior target
    [M, 4] (zero where unmatched) and the matched weight [M, 1]: the
    gather of ``layers.ssd_loss``."""
    enc = single(ins, "Encoded")
    match = single(ins, "MatchIndices").reshape(-1)      # [M]
    m = enc.shape[1]
    idx = torch.clamp(match, min=0).long() * m + torch.arange(
        m, device=enc.device)
    gathered = take(enc.reshape(-1, enc.shape[-1]), idx)   # [M, 4]
    w = (match >= 0).to(torch.float32)[:, None]
    return {"Out": [torch.where(w > 0, gathered, torch.zeros_like(gathered))],
            "OutWeight": [w]}


# -- NMS --------------------------------------------------------------------

def greedy_keep(over, valid):
    """The greedy NMS scan: ``keep[..., i]`` is ``valid[..., i]`` and no
    kept ``j < i`` with ``over[..., i, j]`` (the pair's IoU over the
    threshold). One step an index, every leading dim (image, class) in
    the same tensors; bits at and past ``i`` are still False when step
    ``i`` reads them, as in the reference's loop."""
    keep = torch.zeros_like(valid)
    for i in _steps(valid.shape[-1], valid):
        keep[..., i] = valid[..., i] & ~(over[..., i, :] & keep).any(-1)
    return keep


def _drop_class(t, bg, dim):
    """``t`` without index ``bg`` along ``dim`` (slices, no index copy)."""
    if not 0 <= bg < t.shape[dim]:
        return t
    return torch.cat([t.narrow(dim, 0, bg),
                      t.narrow(dim, bg + 1, t.shape[dim] - bg - 1)], dim)


@register_no_grad_op("multiclass_nms")
def multiclass_nms(ctx, ins, attrs):
    """Multi-class NMS: per image and class the ``nms_top_k`` best
    candidates, greedy suppression over ``nms_threshold``, then the
    ``keep_top_k`` best of all classes as [B, keep_top_k, 6] rows (label,
    score, x1, y1, x2, y2); a suppressed candidate scores -1 and a row
    under ``score_threshold`` has label -1; NmsRoisNum [B] counts the
    rows over it. ``nms_eta`` is not applied."""
    boxes = single(ins, "BBoxes")    # [B, M, 4]
    scores = single(ins, "Scores")   # [B, C, M]
    bg = attrs.get("background_label", 0)
    score_thr = attrs.get("score_threshold", 0.0)
    nms_thr = attrs.get("nms_threshold", 0.3)
    nms_top_k = int(attrs.get("nms_top_k", 400))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    normalized = attrs.get("normalized", True)
    b, c, m = scores.shape
    nms_top_k = min(nms_top_k if nms_top_k > 0 else m, m)
    keep_top_k = keep_top_k if keep_top_k > 0 else c * nms_top_k
    if all(k == bg for k in range(c)):
        raise ValueError(
            "multiclass_nms: every class is the background label (%d of "
            "%d); no detections are possible" % (bg, c))
    dev = scores.device
    sc = _drop_class(scores, bg, 1)                       # [B, C', M]
    labels = _drop_class(torch.arange(c, dtype=torch.float32, device=dev),
                         bg, 0)                           # [C']
    s, order = topk_lowest_index_first(sc, nms_top_k)     # [B, C', K]
    img = torch.arange(b, device=dev)[:, None, None]
    cand = boxes[img, order]                              # [B, C', K, 4]
    over = _pairwise_iou(cand, cand, normalized) > nms_thr
    keep = greedy_keep(over, s > score_thr)
    scs = torch.where(keep, s, torch.full_like(s, -1.0)).reshape(b, -1)
    lab = labels[None, :, None].expand(s.shape).reshape(b, -1)
    bxs = cand.reshape(b, -1, 4)
    k = min(keep_top_k, scs.shape[1])
    top_s, top_i = topk_lowest_index_first(scs, k)        # [B, k]
    row = torch.arange(b, device=dev)[:, None]
    kept = top_s > score_thr
    out = torch.cat([
        torch.where(kept, lab[row, top_i],
                    torch.full_like(top_s, -1.0))[..., None],
        top_s[..., None], bxs[row, top_i]], dim=-1)
    if k < keep_top_k:
        out = torch.cat([out, torch.full((b, keep_top_k - k, 6), -1.0,
                                         dtype=out.dtype, device=dev)], 1)
    count = kept.sum(dim=1).to(torch.int32)
    return {"Out": [out], "NmsRoisNum": [count]}


# -- RoI ops ----------------------------------------------------------------

def _roi_batch_idx(ins, n_rois, device):
    bidx = single(ins, "RoisBatchIdx")
    if bidx is None:
        return torch.zeros((n_rois,), dtype=torch.int64, device=device)
    return bidx.reshape(-1).long()


def _pixels(x):
    """[N, C, H, W] as [N*H*W, C] rows, one a pixel."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n * h * w, c)


def _gather_pixels(rows, shape, bi, ys, xs):
    """The [.., C] channel rows of ``rows`` (``_pixels`` of an [N, C, H,
    W] map of ``shape``) at image ``bi``, row ``ys`` and column ``xs``
    (broadcast together), by ``take``."""
    _, _, h, w = shape
    idx = (bi * h + ys) * w + xs
    return take(rows, idx).reshape(tuple(idx.shape) + (rows.shape[1],))


@register_op("roi_align", no_grad_inputs=("ROIs", "RoisBatchIdx"))
def roi_align(ctx, ins, attrs):
    """RoI Align: ROIs [R, 4] at image scale, each bin the mean of
    ratio x ratio bilinear samples; RoisBatchIdx [R] names each roi's
    image (the reference's LoD). Out [R, C, ph, pw]."""
    x = single(ins, "X")             # [N, C, H, W]
    rois = single(ins, "ROIs")       # [R, 4]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = attrs.get("spatial_scale", 1.0)
    ratio = int(attrs.get("sampling_ratio", -1))
    if ratio <= 0:
        ratio = 2
    _, c, h, w = x.shape
    r_n = rois.shape[0]
    dev = x.device
    bi = _roi_batch_idx(ins, r_n, dev)[:, None, None]
    roi = rois * scale
    x1, y1, x2, y2 = (roi[:, k:k + 1] for k in range(4))
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    gy = y1 + _div((torch.arange(ph * ratio, device=dev) + 0.5) * rh,
                   ph * ratio)
    gx = x1 + _div((torch.arange(pw * ratio, device=dev) + 0.5) * rw,
                   pw * ratio)
    gy = torch.clamp(gy, 0.0, h - 1.0)
    gx = torch.clamp(gx, 0.0, w - 1.0)
    y0 = torch.floor(gy).long()
    x0 = torch.floor(gx).long()
    y1i = torch.clamp(y0 + 1, max=h - 1)
    x1i = torch.clamp(x0 + 1, max=w - 1)
    wy = (gy - y0)[:, :, None, None]                 # [R, PH, 1, 1]
    wx = (gx - x0)[:, None, :, None]                 # [R, 1, PW, 1]
    y0, y1i = y0[:, :, None], y1i[:, :, None]
    x0, x1i = x0[:, None, :], x1i[:, None, :]
    rows = _pixels(x)
    v00 = _gather_pixels(rows, x.shape, bi, y0, x0)  # [R, PH, PW, C]
    v01 = _gather_pixels(rows, x.shape, bi, y0, x1i)
    v10 = _gather_pixels(rows, x.shape, bi, y1i, x0)
    v11 = _gather_pixels(rows, x.shape, bi, y1i, x1i)
    samp = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)
    samp = samp.reshape(r_n, ph, ratio, pw, ratio, c).mean(dim=(2, 4))
    return {"Out": [samp.permute(0, 3, 1, 2)]}


@register_op("roi_pool", no_grad_inputs=("ROIs", "RoisBatchIdx"))
def roi_pool(ctx, ins, attrs):
    """RoI max pooling as a dense-sampled max over each bin (4 x 4
    samples): the max's grad is shared among tied samples, as the
    reference's reduction shares it."""
    x = single(ins, "X")
    rois = single(ins, "ROIs")
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = attrs.get("spatial_scale", 1.0)
    _, c, h, w = x.shape
    ratio = 4  # samples per bin edge
    r_n = rois.shape[0]
    dev = x.device
    bi = _roi_batch_idx(ins, r_n, dev)[:, None, None]
    roi = torch.round(rois * scale)
    x1, y1, x2, y2 = (roi[:, k:k + 1] for k in range(4))
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0)
    rh = torch.clamp(y2 - y1 + 1.0, min=1.0)
    gy = torch.clamp(y1 + _div((torch.arange(ph * ratio, device=dev) + 0.5)
                               * rh, ph * ratio), 0, h - 1).long()
    gx = torch.clamp(x1 + _div((torch.arange(pw * ratio, device=dev) + 0.5)
                               * rw, pw * ratio), 0, w - 1).long()
    samp = _gather_pixels(_pixels(x), x.shape, bi, gy[:, :, None],
                          gx[:, None, :])
    samp = samp.reshape(r_n, ph, ratio, pw, ratio, c).amax(dim=(2, 4))
    return {"Out": [samp.permute(0, 3, 1, 2)]}


@register_op("yolov3_loss", no_grad_inputs=("GTBox", "GTLabel"))
def yolov3_loss(ctx, ins, attrs):
    """YOLOv3 loss, term for term as the reference: a cell whose best IoU
    with a valid ground truth passes ``ignore_thresh`` drops its negative
    objectness term; each valid ground truth takes its best anchor by
    shape, and where that anchor is in ``anchor_mask`` its cell takes the
    location (sigmoid CE on x/y, L2 on w/h, scaled by 2 - w*h), class and
    positive objectness losses. The grad is the engine's vjp of this
    lowering. ObjectnessMask is 0 negative, -1 ignored, 1 positive: a
    scatter-max, so a padding row that shares a positive's cell never
    clears it."""
    x = single(ins, "X")                           # [N, M*(5+C), H, W]
    gtbox = single(ins, "GTBox").float()           # [N, B, 4] cx cy w h
    gtlabel = single(ins, "GTLabel")
    if gtlabel.ndim == 3 and gtlabel.shape[-1] == 1:
        gtlabel = gtlabel[..., 0]
    gtlabel = gtlabel.long()                       # [N, B]
    anchors = [int(a) for a in attrs["anchors"]]
    anchor_mask = [int(a) for a in attrs.get(
        "anchor_mask", list(range(len(anchors) // 2)))]
    class_num = int(attrs["class_num"])
    ignore_thresh = float(attrs.get("ignore_thresh", 0.7))
    downsample = int(attrs.get("downsample_ratio", 32))

    n, _, h, w = x.shape
    m = len(anchor_mask)
    nb = gtbox.shape[1]
    dev = x.device
    input_size = downsample * h
    xr = x.reshape(n, m, 5 + class_num, h, w).float()
    px, py = xr[:, :, 0], xr[:, :, 1]
    pw, ph = xr[:, :, 2], xr[:, :, 3]
    pobj = xr[:, :, 4]
    pcls = xr[:, :, 5:]                            # [N, M, C, H, W]

    def sce(logit, label):
        return (torch.clamp(logit, min=0.0) - logit * label
                + torch.log1p(torch.exp(-torch.abs(logit))))

    aw = _const([anchors[2 * a] for a in anchor_mask], dev)
    ah = _const([anchors[2 * a + 1] for a in anchor_mask], dev)
    gi_grid = torch.arange(w, dtype=torch.float32, device=dev)[
        None, None, None, :]
    gj_grid = torch.arange(h, dtype=torch.float32, device=dev)[
        None, None, :, None]
    bx = _div(gi_grid + torch.sigmoid(px), h)   # the reference's grid h
    by = _div(gj_grid + torch.sigmoid(py), h)
    bw = _div(torch.exp(pw) * aw[None, :, None, None], input_size)
    bh = _div(torch.exp(ph) * ah[None, :, None, None], input_size)

    valid = (gtbox[..., 2] > 1e-6) & (gtbox[..., 3] > 1e-6)   # [N, B]

    def center_iou(ax, ay, aw_, ah_, bx_, by_, bw_, bh_):
        iw = (torch.minimum(ax + aw_ / 2, bx_ + bw_ / 2)
              - torch.maximum(ax - aw_ / 2, bx_ - bw_ / 2))
        ih = (torch.minimum(ay + ah_ / 2, by_ + bh_ / 2)
              - torch.maximum(ay - ah_ / 2, by_ - bh_ / 2))
        inter = torch.where((iw > 0) & (ih > 0), iw * ih,
                            torch.zeros_like(iw))
        union = aw_ * ah_ + bw_ * bh_ - inter
        return inter / torch.clamp(union, min=1e-10)

    # per-prediction best IoU against the valid ground truths
    g = gtbox[:, None, None, None, :, :]           # [N,1,1,1,B,4]
    iou_all = center_iou(
        bx[..., None], by[..., None], bw[..., None], bh[..., None],
        g[..., 0], g[..., 1], g[..., 2], g[..., 3])   # [N,M,H,W,B]
    iou_all = torch.where(valid[:, None, None, None, :], iou_all,
                          torch.zeros_like(iou_all))
    ignored = iou_all.amax(dim=-1) > ignore_thresh  # [N, M, H, W]

    # per ground truth, its best anchor by shape IoU over all anchors
    an_w = _div(_const(anchors[0::2], dev), input_size)
    an_h = _div(_const(anchors[1::2], dev), input_size)
    zero = torch.zeros((), device=dev)
    shape_iou = center_iou(
        zero, zero, an_w[None, None, :], an_h[None, None, :],
        zero, zero, gtbox[..., 2:3], gtbox[..., 3:4])  # [N, B, anchors]
    best_n = shape_iou.argmax(dim=-1)                  # [N, B]
    mask_idx = torch.full_like(best_n, -1)
    for mi, a in enumerate(anchor_mask):
        mask_idx = torch.where(best_n == a, torch.full_like(best_n, mi),
                               mask_idx)
    matched = valid & (mask_idx >= 0)

    gi = torch.clamp((gtbox[..., 0] * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((gtbox[..., 1] * h).to(torch.int32), 0, h - 1).long()
    mi_safe = torch.clamp(mask_idx, min=0)
    n_idx = torch.arange(n, device=dev)[:, None].expand(n, nb)
    cell = ((n_idx * m + mi_safe) * h + gj) * w + gi   # [N, B]

    def gat(t):                                    # [N, M, H, W] -> [N, B]
        return take(t.reshape(-1), cell).reshape(n, nb)

    tx = gtbox[..., 0] * w - gi
    ty = gtbox[..., 1] * h - gj
    aw_g = _const(anchors[0::2], dev)[best_n]
    ah_g = _const(anchors[1::2], dev)[best_n]
    tw = torch.log(torch.clamp(gtbox[..., 2] * input_size, min=1e-9) / aw_g)
    th = torch.log(torch.clamp(gtbox[..., 3] * input_size, min=1e-9) / ah_g)
    scale = 2.0 - gtbox[..., 2] * gtbox[..., 3]
    loc = (sce(gat(px), tx) + sce(gat(py), ty)
           + 0.5 * (gat(pw) - tw) ** 2 + 0.5 * (gat(ph) - th) ** 2)
    loc_loss = torch.where(matched, loc * scale,
                           torch.zeros_like(loc)).sum(dim=1)

    classes = torch.arange(class_num, device=dev)
    onehot = (gtlabel[..., None] == classes).to(torch.float32)  # [N, B, C]
    cls_cell = ((((n_idx * m + mi_safe)[..., None] * class_num + classes)
                 * h + gj[..., None]) * w + gi[..., None])      # [N, B, C]
    cls_logits = take(pcls.reshape(-1), cls_cell).reshape(n, nb, class_num)
    cls = sce(cls_logits, onehot).sum(dim=-1)
    cls_loss = torch.where(matched, cls, torch.zeros_like(cls)).sum(dim=1)

    # objectness: the scatter-max of +1 (matched) / -1 over the cells,
    # a maximum over a one-hot comparison of every ground truth's cell
    flat = torch.where(ignored, -1.0, 0.0).reshape(n, -1)
    pos_flat = (mi_safe * h + gj) * w + gi                      # [N, B]
    hits = pos_flat[..., None] == torch.arange(m * h * w, device=dev)
    upd = torch.where(hits, torch.where(matched, 1.0, -1.0)[..., None],
                      torch.full_like(hits, float("-inf"),
                                      dtype=torch.float32)).amax(dim=1)
    obj_mask = torch.maximum(flat, upd).reshape(n, m, h, w)
    obj_loss = torch.where(
        obj_mask > 0.5, sce(pobj, 1.0),
        torch.where(obj_mask > -0.5, sce(pobj, 0.0),
                    torch.zeros_like(pobj))).sum(dim=(1, 2, 3))

    loss = loc_loss + cls_loss + obj_loss
    return {"Loss": [loss.to(x.dtype)],
            "ObjectnessMask": [obj_mask],
            "GTMatchMask": [torch.where(valid, mask_idx,
                                        torch.full_like(mask_idx, -1))
                            .to(torch.int32)]}


@register_no_grad_op("generate_proposals")
def generate_proposals(ctx, ins, attrs):
    """RPN proposals: per image the ``pre_nms_topN`` best anchors, their
    deltas decoded (variances applied, dw/dh clipped at log(1000/16)),
    clipped to the image, boxes under ``min_size`` at image scale
    dropped, greedy NMS at ``nms_thresh``, the ``post_nms_topN`` best
    kept. RpnRois [N, post, 4] and RpnRoiProbs [N, post, 1] are
    zero-padded past RpnRoisNum [N]. ``eta`` is not applied."""
    scores = single(ins, "Scores")        # [N, A, H, W]
    deltas = single(ins, "BboxDeltas")    # [N, 4A, H, W]
    im_info = single(ins, "ImInfo")       # [N, 3] (h, w, scale)
    anchors = single(ins, "Anchors").reshape(-1, 4)     # [A*H*W, 4]
    variances = single(ins, "Variances").reshape(-1, 4)
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    nms_thresh = float(attrs.get("nms_thresh", 0.5))
    min_size = float(attrs.get("min_size", 0.1))
    n, a, h, w = scores.shape
    total = a * h * w
    pre_n = min(pre_n, total)
    dev = scores.device

    # anchors are [H, W, A, 4]: scores and deltas follow that order
    sc = scores.permute(0, 2, 3, 1).reshape(n, total)
    dl = deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2) \
        .reshape(n, total, 4)
    top_s, idx = topk_lowest_index_first(sc, pre_n)     # [N, pre_n]
    anc = anchors[idx]
    var = variances[idx]
    d = dl[torch.arange(n, device=dev)[:, None], idx] * var
    aw = anc[..., 2] - anc[..., 0] + 1.0
    ah = anc[..., 3] - anc[..., 1] + 1.0
    acx = anc[..., 0] + aw / 2.0
    acy = anc[..., 1] + ah / 2.0
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    clip_wh = math.log(1000.0 / 16.0)
    bw = torch.exp(torch.clamp(d[..., 2], max=clip_wh)) * aw
    bh = torch.exp(torch.clamp(d[..., 3], max=clip_wh)) * ah
    img_h = im_info[:, 0:1] - 1.0
    img_w = im_info[:, 1:2] - 1.0

    def clip(v, hi):
        return torch.minimum(torch.clamp(v, min=0.0), hi)

    x1 = clip(cx - bw / 2.0, img_w)
    y1 = clip(cy - bh / 2.0, img_h)
    x2 = clip(cx + bw / 2.0 - 1.0, img_w)
    y2 = clip(cy + bh / 2.0 - 1.0, img_h)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)       # [N, pre_n, 4]
    ms = min_size * im_info[:, 2:3]
    keep_size = ((x2 - x1 + 1.0) >= ms) & ((y2 - y1 + 1.0) >= ms)
    s_kept = torch.where(keep_size, top_s,
                         torch.full_like(top_s, float("-inf")))
    over = _pairwise_iou(boxes, boxes, normalized=False) > nms_thresh
    keep = greedy_keep(over, torch.isfinite(s_kept))
    final_s = torch.where(keep, s_kept, torch.full_like(s_kept,
                                                        float("-inf")))
    k = min(post_n, pre_n)
    sel_s, sel_i = topk_lowest_index_first(final_s, k)
    ok = torch.isfinite(sel_s)
    rois = torch.where(ok[..., None],
                       boxes[torch.arange(n, device=dev)[:, None], sel_i],
                       torch.zeros((), device=dev))
    probs = torch.where(ok, sel_s, torch.zeros_like(sel_s))[..., None]
    if k < post_n:
        pad = post_n - k
        rois = torch.cat([rois, rois.new_zeros((n, pad, 4))], 1)
        probs = torch.cat([probs, probs.new_zeros((n, pad, 1))], 1)
    return {"RpnRois": [rois], "RpnRoiProbs": [probs],
            "RpnRoisNum": [ok.sum(dim=1).to(torch.int32)]}


def _priority(ctx, n, use_random, device):
    """The samplers' [n] priorities: the seed table's counter-hash
    uniforms, or index / n without ``use_random``."""
    if use_random:
        return uniform_floats(ctx.seed(SEED_HIGH), (n,), device)
    return torch.arange(n, dtype=torch.float32, device=device) / n


@register_no_grad_op("rpn_target_assign", needs_rng=True,
                     seed_range=_seed_range)
def rpn_target_assign(ctx, ins, attrs):
    """RPN training targets for one image: anchors at or over
    ``rpn_positive_overlap`` IoU (and each valid ground truth's best
    overlapping anchor) are positives, under ``rpn_negative_overlap``
    negatives, anchors straddling the image past the threshold neither;
    at most ``rpn_fg_fraction`` of ``rpn_batch_size_per_im`` positives
    kept, the rest of the budget negatives, by the drawn priorities.
    Per-anchor ScoreTarget (1, 0, -1 ignore), BboxTarget and weights."""
    anchors = single(ins, "Anchor").reshape(-1, 4)      # [M, 4]
    gt_boxes = single(ins, "GtBoxes")                   # [G, 4]
    is_crowd = single(ins, "IsCrowd")
    im_info = single(ins, "ImInfo")
    batch_per_im = int(attrs.get("rpn_batch_size_per_im", 256))
    fg_frac = float(attrs.get("rpn_fg_fraction", 0.5))
    pos_thresh = float(attrs.get("rpn_positive_overlap", 0.7))
    neg_thresh = float(attrs.get("rpn_negative_overlap", 0.3))
    straddle = float(attrs.get("rpn_straddle_thresh", 0.0))
    use_random = bool(attrs.get("use_random", True))
    m = anchors.shape[0]
    dev = anchors.device
    valid_gt = (gt_boxes[:, 2] > gt_boxes[:, 0]) & (
        gt_boxes[:, 3] > gt_boxes[:, 1])
    if is_crowd is not None:
        valid_gt = valid_gt & (is_crowd.reshape(-1) == 0)

    inside = torch.ones((m,), dtype=torch.bool, device=dev)
    if im_info is not None and straddle >= 0:
        info = im_info.reshape(-1)
        inside = ((anchors[:, 0] >= -straddle)
                  & (anchors[:, 1] >= -straddle)
                  & (anchors[:, 2] < info[1] + straddle)
                  & (anchors[:, 3] < info[0] + straddle))

    zero = torch.zeros((), device=dev)
    iou = _pairwise_iou(anchors, gt_boxes, normalized=False)  # [M, G]
    iou = torch.where(valid_gt[None, :], iou, zero)
    iou = torch.where(inside[:, None], iou, zero)
    best_iou, best_gt = iou.max(dim=1)
    pos = (best_iou >= pos_thresh) & inside
    # each valid ground truth's best anchor is positive too, where it
    # overlaps at all: a scatter-max of bools, as an OR over a one-hot
    # comparison of the anchors' ids
    gt_best, gt_best_anchor = iou.max(dim=0)            # [G]
    promote = valid_gt & (gt_best > 0.0)
    pos = pos | ((gt_best_anchor[None, :] == torch.arange(
        m, device=dev)[:, None]) & promote[None, :]).any(dim=1)
    neg = (best_iou < neg_thresh) & ~pos & inside

    priority = _priority(ctx, m, use_random, dev)
    pos = _subsample(pos, int(batch_per_im * fg_frac), priority)
    neg = _subsample(neg, batch_per_im - pos.sum(), priority)

    one = torch.ones((), dtype=torch.int32, device=dev)
    score_target = torch.where(pos, one, torch.where(neg, 0 * one, -one))
    tgt = _encode_center_size(anchors, gt_boxes[best_gt])
    ids = torch.arange(m, device=dev)
    return {"ScoreTarget": [score_target],
            "BboxTarget": [torch.where(pos[:, None], tgt, zero)],
            "BboxWeight": [pos[:, None].to(torch.float32)],
            "LocationIndex": [torch.where(pos, ids, -1)],
            "ScoreIndex": [torch.where(pos | neg, ids, -1)]}


@register_no_grad_op("generate_proposal_labels", needs_rng=True,
                     seed_range=_seed_range)
def generate_proposal_labels(ctx, ins, attrs):
    """Second-stage RoI sampling for one image: the ground truths join
    the proposals (past RpnRoisNum and degenerate boxes never sampled);
    IoU at or over ``fg_thresh`` is foreground, labelled by its best
    ground truth, IoU in [``bg_thresh_lo``, ``bg_thresh_hi``) background;
    at most ``fg_fraction`` of ``batch_size_per_im`` foregrounds by the
    drawn priorities, the rest of the budget backgrounds. Exactly
    ``batch_size_per_im`` rows, foregrounds first, padding rows label -1
    with zero weights; BboxTargets in the label's 4 columns."""
    rois = single(ins, "RpnRois").reshape(-1, 4)        # [R, 4]
    gt_classes = single(ins, "GtClasses").reshape(-1).long()
    gt_boxes = single(ins, "GtBoxes").reshape(-1, 4)    # [G, 4]
    is_crowd = single(ins, "IsCrowd")
    im_info = single(ins, "ImInfo")
    rois_num = single(ins, "RpnRoisNum")
    if im_info is not None:
        # proposals at the scaled image, ground truths at the original
        rois = rois / im_info.reshape(-1)[2]
    batch = int(attrs.get("batch_size_per_im", 512))
    fg_frac = float(attrs.get("fg_fraction", 0.25))
    fg_thresh = float(attrs.get("fg_thresh", 0.5))
    bg_hi = float(attrs.get("bg_thresh_hi", 0.5))
    bg_lo = float(attrs.get("bg_thresh_lo", 0.0))
    weights = attrs.get("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2])
    class_nums = int(attrs.get("class_nums", 81))
    use_random = bool(attrs.get("use_random", True))
    dev = rois.device

    valid_gt = (gt_boxes[:, 2] > gt_boxes[:, 0]) & (
        gt_boxes[:, 3] > gt_boxes[:, 1])
    if is_crowd is not None:
        valid_gt = valid_gt & (is_crowd.reshape(-1) == 0)
    roi_valid = (rois[:, 2] > rois[:, 0]) & (rois[:, 3] > rois[:, 1])
    if rois_num is not None:
        roi_valid = roi_valid & (torch.arange(rois.shape[0], device=dev)
                                 < rois_num.reshape(()))
    cand = torch.cat([rois, gt_boxes], dim=0)
    cand_valid = torch.cat([roi_valid, valid_gt])
    n_real = cand.shape[0]
    if n_real < batch:
        cand = torch.cat([cand, torch.full((batch - n_real, 4), -1.0,
                                           dtype=cand.dtype, device=dev)])
        cand_valid = torch.cat([cand_valid, torch.zeros(
            (batch - n_real,), dtype=torch.bool, device=dev)])
    r_n = cand.shape[0]
    zero = torch.zeros((), device=dev)
    iou = _pairwise_iou(cand, gt_boxes, normalized=False)
    iou = torch.where(valid_gt[None, :], iou, zero)
    best_iou, best_gt = iou.max(dim=1)
    fg = (best_iou >= fg_thresh) & cand_valid
    bg = (best_iou < bg_hi) & (best_iou >= bg_lo) & ~fg & cand_valid

    priority = _priority(ctx, r_n, use_random, dev)
    fg = _subsample(fg, int(batch * fg_frac), priority)
    bg = _subsample(bg, batch - fg.sum(), priority)

    # foregrounds first, then backgrounds, then padding
    order_key = torch.where(fg, 0.0, torch.where(bg, 1.0, 2.0)) + priority
    sel = torch.argsort(order_key, stable=True)[:batch]
    sel_fg = fg[sel]
    sel_bg = bg[sel]
    gt_sel = best_gt[sel]
    out_rois = torch.where((sel_fg | sel_bg)[:, None], cand[sel], zero)
    labels = torch.where(sel_fg, gt_classes[gt_sel],
                         torch.where(sel_bg, 0, -1)).to(torch.int32)

    # the targets in the label's 4 columns; a label past class_nums
    # writes nowhere (the reference's dropped scatter)
    tgt = _encode_center_size(cand[sel], gt_boxes[gt_sel], weights)
    cls = torch.clamp(labels, min=0).long()
    hot = (cls[:, None] == torch.arange(class_nums, device=dev)) \
        & sel_fg[:, None]                                # [P, classes]
    bbox_targets = torch.where(hot[..., None], tgt[:, None, :], zero) \
        .reshape(batch, 4 * class_nums)
    inside_w = hot[..., None].expand(batch, class_nums, 4).to(
        torch.float32).reshape(batch, 4 * class_nums)
    return {"Rois": [out_rois],
            "LabelsInt32": [labels],
            "BboxTargets": [bbox_targets],
            "BboxInsideWeights": [inside_w],
            "BboxOutsideWeights": [inside_w]}


@register_op("similarity_focus", no_grad_inputs=())
def similarity_focus(ctx, ins, attrs):
    """For each selected channel, greedily pick maxima so that every row
    and column is used once (min(H, W) steps); the union of the picked
    positions, as a {0, 1} mask, across all channels. One loop for every
    image and selected channel."""
    x = single(ins, "X")                     # [N, C, H, W]
    axis = int(attrs.get("axis", 1))
    indexes = [int(i) for i in attrs["indexes"]]
    if axis != 1:
        raise NotImplementedError("similarity_focus supports axis=1")
    n, c, h, w = x.shape
    dev = x.device
    planes = torch.stack([x[:, i] for i in indexes], dim=1)   # [N, K, H, W]
    k = planes.shape[1]
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    cells = torch.arange(h * w, device=dev)
    row_used = torch.zeros((n, k, h), dtype=torch.bool, device=dev)
    col_used = torch.zeros((n, k, w), dtype=torch.bool, device=dev)
    mask = torch.zeros((n, k, h * w), dtype=torch.bool, device=dev)
    ninf = torch.full_like(planes, float("-inf"))
    for _ in _steps(min(h, w), x):
        avail = ~row_used[..., :, None] & ~col_used[..., None, :]
        flat = torch.where(avail, planes, ninf).reshape(n, k, -1) \
            .argmax(dim=-1)
        mask = mask | (cells == flat[..., None])
        row_used = row_used | (rows == (flat // w)[..., None])
        col_used = col_used | (cols == (flat % w)[..., None])
    out = mask.any(dim=1).reshape(n, 1, h, w).expand(n, c, h, w)
    return {"Out": [out.to(x.dtype)]}


def _in_quad(px, py, qx, qy, eps):
    """px/py [R, G] points, qx/qy [R, 4] quads: the even-odd crossing
    count, with the reference's on-boundary cases."""
    on = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    cross = torch.zeros(px.shape, dtype=torch.int32, device=px.device)
    for i in range(4):
        xs, ys = qx[:, i:i + 1], qy[:, i:i + 1]
        xe, ye = qx[:, (i + 1) % 4:(i + 1) % 4 + 1], \
            qy[:, (i + 1) % 4:(i + 1) % 4 + 1]
        horiz = torch.abs(ys - ye) < eps
        ix = torch.where(horiz, 0.0,
                         (py - ys) * (xe - xs)
                         / torch.where(horiz, 1.0, ye - ys) + xs)
        on_h = (horiz & (torch.abs(py - ys) < eps)
                & (torch.abs(py - ye) < eps)
                & (px >= torch.minimum(xs, xe) - eps)
                & (px <= torch.maximum(xs, xe) + eps))
        on_e = (~horiz & (torch.abs(ix - px) < eps)
                & (py >= torch.minimum(ys, ye) - eps)
                & (py <= torch.maximum(ys, ye) + eps))
        on = on | on_h | on_e
        countable = (~horiz
                     & ~(py <= torch.minimum(ys, ye) + eps)
                     & ~(py - torch.maximum(ys, ye) > eps)
                     & (ix - px > eps))
        cross = cross + countable.to(torch.int32)
    return on | (cross % 2 == 1)


@register_op("roi_perspective_transform",
             no_grad_inputs=("ROIs", "RoisBatchIdx"))
def roi_perspective_transform(ctx, ins, attrs):
    """Each quadrilateral RoI (ROIs [R, 8], x1..y4 clockwise from the top
    left) warped through its projective matrix onto a [th, tw] grid and
    bilinearly sampled; points outside the quad or the map are zero.
    Differentiable in X through the sampling's gathers."""
    x = single(ins, "X")                 # [N, C, H, W]
    rois = single(ins, "ROIs").reshape(-1, 8)
    th = int(attrs["transformed_height"])
    tw = int(attrs["transformed_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    _, c, h, w = x.shape
    r_n = rois.shape[0]
    dev = x.device
    bi = _roi_batch_idx(ins, r_n, dev)[:, None]
    eps = 1e-4

    gh, gw = torch.meshgrid(torch.arange(th, dtype=torch.float32, device=dev),
                            torch.arange(tw, dtype=torch.float32, device=dev),
                            indexing="ij")
    gh, gw = gh.reshape(1, -1), gw.reshape(1, -1)        # [1, G]
    qx = rois[:, 0::2] * scale                            # [R, 4]
    qy = rois[:, 1::2] * scale
    x0, x1, x2, x3 = (qx[:, k:k + 1] for k in range(4))
    y0, y1, y2, y3 = (qy[:, k:k + 1] for k in range(4))
    len1 = torch.sqrt((x0 - x1) ** 2 + (y0 - y1) ** 2)
    len2 = torch.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
    len3 = torch.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
    len4 = torch.sqrt((x3 - x0) ** 2 + (y3 - y0) ** 2)
    est_h = (len2 + len4) / 2.0
    est_w = (len1 + len3) / 2.0
    nh = float(th)
    nw = torch.clamp(torch.round(est_w * (nh - 1.0)
                                 / torch.clamp(est_h, min=eps)) + 1.0,
                     max=float(tw))
    dx1, dx2, dx3 = x1 - x2, x3 - x2, x0 - x1 + x2 - x3
    dy1, dy2, dy3 = y1 - y2, y3 - y2, y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    m6 = (dx3 * dy2 - dx2 * dy3) / den / (nw - 1.0)
    m7 = _div((dx1 * dy3 - dx3 * dy1) / den, nh - 1.0)
    m3 = (y1 - y0 + m6 * (nw - 1.0) * y1) / (nw - 1.0)
    m4 = _div(y3 - y0 + m7 * (nh - 1.0) * y3, nh - 1.0)
    m0 = (x1 - x0 + m6 * (nw - 1.0) * x1) / (nw - 1.0)
    m1 = _div(x3 - x0 + m7 * (nh - 1.0) * x3, nh - 1.0)
    u = m0 * gw + m1 * gh + x0
    v = m3 * gw + m4 * gh + y0
    wq = m6 * gw + m7 * gh + 1.0
    in_w = u / wq                                         # [R, G]
    in_h = v / wq
    inside = _in_quad(in_w, in_h, qx, qy, eps)
    inb = (~(-0.5 - in_w > eps) & ~(in_w - (w - 0.5) > eps)
           & ~(-0.5 - in_h > eps) & ~(in_h - (h - 0.5) > eps))
    sw = torch.clamp(in_w, min=0.0)
    sh = torch.clamp(in_h, min=0.0)
    wf = torch.floor(sw)
    hf = torch.floor(sh)
    at_right = wf - (w - 1.0) > -eps
    at_bottom = hf - (h - 1.0) > -eps
    wf = torch.where(at_right, float(w - 1), wf)
    hf = torch.where(at_bottom, float(h - 1), hf)
    sw = torch.where(at_right, wf, sw)
    sh = torch.where(at_bottom, hf, sh)
    wc = torch.where(at_right, wf, wf + 1.0)
    hc = torch.where(at_bottom, hf, hf + 1.0)
    fw, fh = (sw - wf)[..., None], (sh - hf)[..., None]

    def ix(t, hi):
        # a gather clamps its ids (a point whose warp is not finite)
        return torch.clamp(t.long(), 0, hi)

    iwf, iwc = ix(wf, w - 1), ix(wc, w - 1)
    ihf, ihc = ix(hf, h - 1), ix(hc, h - 1)
    rows = _pixels(x)
    v1 = _gather_pixels(rows, x.shape, bi, ihf, iwf)     # [R, G, C]
    v2 = _gather_pixels(rows, x.shape, bi, ihc, iwf)
    v3 = _gather_pixels(rows, x.shape, bi, ihc, iwc)
    v4 = _gather_pixels(rows, x.shape, bi, ihf, iwc)
    samp = ((1 - fw) * (1 - fh) * v1 + (1 - fw) * fh * v2
            + fw * fh * v3 + (1 - fh) * fw * v4)
    samp = torch.where((inside & inb)[..., None], samp,
                       torch.zeros((), dtype=samp.dtype, device=dev))
    return {"Out": [samp.permute(0, 2, 1).reshape(r_n, c, th, tw)]}


@register_no_grad_op("generate_mask_labels")
def generate_mask_labels(ctx, ins, attrs):
    """Mask R-CNN mask targets for one image: foreground rois (label > 0)
    take the foreground ground truth whose polygons' box overlaps most
    (+1 convention), whose polygons are rasterised at ``resolution`` M
    inside the roi's box by an even-odd point test of the M x M grid
    (the reference walks COCO's run-length form). GtSegms [G, P, V, 2]
    are zero-padded polygons with GtPolyLens [G, P] vertex counts. All R
    rows kept, foregrounds first (MaskRoisNum of them, at least 1: with
    none, the first background roi with class 0 and an all -1 mask);
    padding rows RoiHasMaskInt32 -1 and all -1 targets."""
    im_info = single(ins, "ImInfo").reshape(-1)
    gt_classes = single(ins, "GtClasses").reshape(-1).long()
    is_crowd = single(ins, "IsCrowd").reshape(-1).long()
    segms = single(ins, "GtSegms")            # [G, P, V, 2]
    pl = single(ins, "GtPolyLens")
    poly_lens = (pl.long() if pl is not None
                 else torch.full(segms.shape[:2], segms.shape[2],
                                 dtype=torch.int64, device=segms.device))
    rois = single(ins, "Rois").reshape(-1, 4)
    labels = single(ins, "LabelsInt32").reshape(-1).long()
    k_n = int(attrs["num_classes"])
    m_res = int(attrs["resolution"])
    _, p_n, v_n, _ = segms.shape
    r_n = rois.shape[0]
    dev = rois.device

    gt_fg = (gt_classes > 0) & (is_crowd == 0)
    # the box of every vertex of every polygon of a ground truth
    vmask = torch.arange(v_n, device=dev)[None, None, :] < poly_lens[
        :, :, None]
    big = 1e10
    gx0 = torch.where(vmask, segms[..., 0], big).amin(dim=(1, 2))
    gy0 = torch.where(vmask, segms[..., 1], big).amin(dim=(1, 2))
    gx1 = torch.where(vmask, segms[..., 0], -big).amax(dim=(1, 2))
    gy1 = torch.where(vmask, segms[..., 1], -big).amax(dim=(1, 2))
    gt_boxes = torch.stack([gx0, gy0, gx1, gy1], dim=-1)    # [G, 4]

    fg = labels > 0
    rois_img = rois / im_info[2]
    iou = _pairwise_iou(rois_img, gt_boxes, normalized=False)
    iou = torch.where(gt_fg[None, :], iou, -1.0)
    best_gt = iou.argmax(dim=1)                             # [R]

    gy, gxg = torch.meshgrid(
        torch.arange(m_res, dtype=torch.float32, device=dev),
        torch.arange(m_res, dtype=torch.float32, device=dev), indexing="ij")
    gy, gxg = gy.reshape(1, -1), gxg.reshape(1, -1)        # [1, M*M]

    # the union of each roi's ground-truth polygons, every roi at once
    bw = torch.clamp(rois_img[:, 2] - rois_img[:, 0], min=1.0)[:, None]
    bh = torch.clamp(rois_img[:, 3] - rois_img[:, 1], min=1.0)[:, None]
    polys = segms[best_gt]                                  # [R, P, V, 2]
    cnts = poly_lens[best_gt]                               # [R, P]
    r_idx = torch.arange(r_n, device=dev)
    masks = torch.zeros((r_n, m_res * m_res), dtype=torch.bool, device=dev)
    for p in range(p_n):
        cnt = cnts[:, p]
        px = (polys[:, p, :, 0] - rois_img[:, 0:1]) * m_res / bw  # [R, V]
        py = (polys[:, p, :, 1] - rois_img[:, 1:2]) * m_res / bh
        inside = torch.zeros_like(masks)
        for j in range(v_n):
            # the next vertex, wrapping at the count (a gather clamps
            # past the last one, an edge the count masks off)
            jn = torch.clamp(torch.where(cnt - 1 == j, 0, j + 1),
                             max=v_n - 1)
            x1, y1 = px[:, j:j + 1], py[:, j:j + 1]
            x2, y2 = px[r_idx, jn][:, None], py[r_idx, jn][:, None]
            crosses = (y1 > gy) != (y2 > gy)
            denom = torch.where(y2 == y1, 1.0, y2 - y1)
            xi = (x2 - x1) * (gy - y1) / denom + x1
            inside = inside ^ ((j < cnt)[:, None] & crosses & (gxg < xi))
        masks = masks | (inside & (cnt >= 3)[:, None])

    n_fg = fg.sum()
    # foregrounds first, by their index
    key = torch.where(fg, 0, 1) * r_n + r_idx
    perm = torch.argsort(key, stable=True)
    has_fg = n_fg > 0
    bg_first = (labels == 0).to(torch.int32).argmax()
    row_src = torch.where(has_fg, perm, bg_first)
    keep = r_idx < torch.clamp(n_fg, min=1)
    out_rois = torch.where(keep[:, None], rois[row_src],
                           torch.zeros((), device=dev))
    out_has = torch.where(keep, row_src, -1).to(torch.int32)
    cls = torch.where(has_fg, labels[row_src], 0)
    sel_masks = masks[row_src].to(torch.int32)
    # the class's slice of each written row; a class past num_classes
    # writes nowhere (the reference's dropped scatter)
    write = keep & (cls > 0) & has_fg
    hot = (cls[:, None] == torch.arange(k_n, device=dev)) & write[:, None]
    tgt = torch.where(hot[..., None], sel_masks[:, None, :],
                      torch.full((), -1, dtype=torch.int32, device=dev))
    return {"MaskRois": [out_rois],
            "RoiHasMaskInt32": [out_has.reshape(-1, 1)],
            "MaskInt32": [tgt.reshape(r_n, k_n * m_res * m_res)],
            "MaskRoisNum": [torch.clamp(n_fg, min=1).to(torch.int32)]}
