"""Detection layers — port of ``paddle_tpu/layers/detection.py``, its 22
public builders (:11-34), each building the reference's desc: NMS and
matching return fixed-capacity tensors with -1 padding, RoI ops take an
explicit per-roi batch index in place of the LoD
(``ops/detection_ops.py``). ``ssd_loss`` takes one image and weights
every negative (no hard-negative mining), as the reference's does;
``detection_map`` computes the mAP on the host through ``py_func``, with
its own copy of the reference's ``_np_map`` (:442).
"""

from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.ops.detection_ops import _expand_aspect_ratios

__all__ = [
    "prior_box",
    "density_prior_box",
    "anchor_generator",
    "box_coder",
    "iou_similarity",
    "box_clip",
    "polygon_box_transform",
    "bipartite_match",
    "target_assign",
    "multiclass_nms",
    "roi_align",
    "roi_pool",
    "detection_output",
    "ssd_loss",
    "multi_box_head",
    "yolov3_loss",
    "detection_map",
    "generate_proposals",
    "rpn_target_assign",
    "generate_proposal_labels",
    "roi_perspective_transform",
    "generate_mask_labels",
]


def _out(helper, dtype="float32"):
    return helper.create_variable_for_type_inference(dtype=dtype)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    """(reference: layers/detection.py:1108)"""
    helper = LayerHelper("prior_box", name=name)
    boxes, var = _out(helper), _out(helper)
    helper.append_op(
        type="prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [var]},
        attrs={
            "min_sizes": list(min_sizes),
            "max_sizes": list(max_sizes or []),
            "aspect_ratios": list(aspect_ratios),
            "variances": list(variance),
            "flip": flip,
            "clip": clip,
            "step_w": steps[0],
            "step_h": steps[1],
            "offset": offset,
            "min_max_aspect_ratios_order": min_max_aspect_ratios_order,
        })
    return boxes, var


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, steps=(0.0, 0.0), offset=0.5,
                      flatten_to_2d=False, name=None):
    """(reference: layers/detection.py:1228)"""
    helper = LayerHelper("density_prior_box", name=name)
    boxes, var = _out(helper), _out(helper)
    helper.append_op(
        type="density_prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [var]},
        attrs={
            "densities": list(densities or []),
            "fixed_sizes": list(fixed_sizes or []),
            "fixed_ratios": list(fixed_ratios or [1.0]),
            "variances": list(variance),
            "clip": clip,
            "step_w": steps[0],
            "step_h": steps[1],
            "offset": offset,
            "flatten_to_2d": flatten_to_2d,
        })
    return boxes, var


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None, offset=0.5,
                     name=None):
    """(reference: layers/detection.py:1600)"""
    helper = LayerHelper("anchor_generator", name=name)
    anchors, var = _out(helper), _out(helper)
    helper.append_op(
        type="anchor_generator",
        inputs={"Input": [input]},
        outputs={"Anchors": [anchors], "Variances": [var]},
        attrs={
            "anchor_sizes": list(anchor_sizes or [64.0, 128.0, 256.0]),
            "aspect_ratios": list(aspect_ratios or [0.5, 1.0, 2.0]),
            "variances": list(variance),
            "stride": list(stride or [16.0, 16.0]),
            "offset": offset,
        })
    return anchors, var


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    """(reference: layers/detection.py:345)"""
    helper = LayerHelper("box_coder", name=name)
    out = _out(helper)
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op(
        type="box_coder", inputs=inputs, outputs={"OutputBox": [out]},
        attrs={"code_type": code_type, "box_normalized": box_normalized,
               "axis": axis})
    return out


def iou_similarity(x, y, box_normalized=True, name=None):
    """(reference: layers/detection.py:317)"""
    helper = LayerHelper("iou_similarity", name=name)
    out = _out(helper)
    helper.append_op(type="iou_similarity",
                     inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"box_normalized": box_normalized})
    return out


def box_clip(input, im_info, name=None):
    """(reference: layers/detection.py:2059)"""
    helper = LayerHelper("box_clip", name=name)
    out = _out(helper)
    helper.append_op(type="box_clip",
                     inputs={"Input": [input], "ImInfo": [im_info]},
                     outputs={"Output": [out]})
    return out


def polygon_box_transform(input, name=None):
    """(reference: layers/detection.py:482)"""
    helper = LayerHelper("polygon_box_transform", name=name)
    out = _out(helper)
    helper.append_op(type="polygon_box_transform",
                     inputs={"Input": [input]},
                     outputs={"Output": [out]})
    return out


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    """(reference: layers/detection.py:702)"""
    helper = LayerHelper("bipartite_match", name=name)
    match_idx = _out(helper, "int32")
    match_dist = _out(helper)
    helper.append_op(
        type="bipartite_match",
        inputs={"DistMat": [dist_matrix]},
        outputs={"ColToRowMatchIndices": [match_idx],
                 "ColToRowMatchDist": [match_dist]},
        attrs={"match_type": match_type or "bipartite",
               "dist_threshold": dist_threshold or 0.5})
    return match_idx, match_dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    """(reference: layers/detection.py:788)"""
    helper = LayerHelper("target_assign", name=name)
    out = _out(helper, input.dtype)
    out_weight = _out(helper)
    helper.append_op(
        type="target_assign",
        inputs={"X": [input], "MatchIndices": [matched_indices]},
        outputs={"Out": [out], "OutWeight": [out_weight]},
        attrs={"mismatch_value": mismatch_value})
    return out, out_weight


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None):
    """(reference: layers/detection.py:2107). Static-shape output:
    [B, keep_top_k, 6] rows (label, score, x1, y1, x2, y2) padded with
    label -1, plus a [B] kept-count tensor."""
    helper = LayerHelper("multiclass_nms", name=name)
    out = _out(helper)
    count = _out(helper, "int32")
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [out], "NmsRoisNum": [count]},
        attrs={
            "score_threshold": score_threshold,
            "nms_top_k": nms_top_k,
            "keep_top_k": keep_top_k,
            "nms_threshold": nms_threshold,
            "normalized": normalized,
            "nms_eta": nms_eta,
            "background_label": background_label,
        })
    return out, count


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_batch_idx=None,
              name=None):
    """(reference: layers/roi_align; rois_batch_idx replaces the LoD)"""
    helper = LayerHelper("roi_align", name=name)
    out = _out(helper, input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_idx is not None:
        inputs["RoisBatchIdx"] = [rois_batch_idx]
    helper.append_op(
        type="roi_align", inputs=inputs, outputs={"Out": [out]},
        attrs={"pooled_height": pooled_height,
               "pooled_width": pooled_width,
               "spatial_scale": spatial_scale,
               "sampling_ratio": sampling_ratio})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_batch_idx=None, name=None):
    """(reference: layers/roi_pool)"""
    helper = LayerHelper("roi_pool", name=name)
    out = _out(helper, input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_idx is not None:
        inputs["RoisBatchIdx"] = [rois_batch_idx]
    helper.append_op(
        type="roi_pool", inputs=inputs, outputs={"Out": [out]},
        attrs={"pooled_height": pooled_height,
               "pooled_width": pooled_width,
               "spatial_scale": spatial_scale})
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     name=None):
    """Decode + NMS (reference: layers/detection.py:204 — box_coder
    decode_center_size followed by multiclass_nms)."""
    from paddle_tpu_torch.layers import nn as nn_layers

    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    scores_t = nn_layers.transpose(scores, perm=[0, 2, 1])  # [B, C, M]
    out, count = multiclass_nms(
        decoded, scores_t, score_threshold=score_threshold,
        nms_top_k=nms_top_k, keep_top_k=keep_top_k,
        nms_threshold=nms_threshold, nms_eta=nms_eta,
        background_label=background_label, name=name)
    return out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mismatch_value=0, normalize=True, sample_size=None,
             mining_type="max_negative"):
    """SSD multibox loss (reference: layers/detection.py:874): match
    priors to ground truths (bipartite + per-prediction), smooth-L1 on
    matched locations, softmax CE with matched/background label targets.
    Hard negative mining is replaced by full negative weighting (static
    shapes); sample_size/neg_pos_ratio are accepted for API parity.
    Single-image form: location [M, 4], confidence
    [M, C], gt_box [N_gt, 4], gt_label [N_gt, 1], prior_box [M, 4]."""
    from paddle_tpu_torch.layers import loss as loss_layers
    from paddle_tpu_torch.layers import nn as nn_layers

    if mining_type != "max_negative":
        # same guard as the reference (layers/detection.py ssd_loss:
        # "Only mining_type == max_negative is supported")
        raise ValueError("ssd_loss: only mining_type == 'max_negative' "
                         "is supported")
    iou = iou_similarity(gt_box, prior_box)            # [N_gt, M]
    match_idx, _ = bipartite_match(iou, match_type,
                                   overlap_threshold)  # [1, M]
    match_idx.stop_gradient = True
    # per-prior location target: enc[match[m], m] (zeros unmatched)
    enc = box_coder(prior_box, prior_box_var, gt_box)  # [N_gt, M, 4]
    loc_target, loc_w = _gather_encoded(enc, match_idx)   # [M, 4], [M, 1]
    loc_target.stop_gradient = True
    # conf target: gt label where matched, background elsewhere
    conf_target, _ = target_assign(
        gt_label, match_idx, mismatch_value=background_label)  # [1, M, 1]
    conf_target = nn_layers.reshape(conf_target, shape=[-1, 1])
    conf_target.stop_gradient = True

    loc_loss = nn_layers.reduce_sum(
        nn_layers.elementwise_mul(
            loss_layers.smooth_l1(location, loc_target), loc_w))
    conf_loss = nn_layers.reduce_sum(
        loss_layers.softmax_with_cross_entropy(
            logits=confidence, label=conf_target))
    total = nn_layers.elementwise_add(
        nn_layers.scale(loc_loss, scale=loc_loss_weight),
        nn_layers.scale(conf_loss, scale=conf_loss_weight))
    if normalize:
        denom = nn_layers.scale(nn_layers.reduce_sum(loc_w), scale=1.0,
                                bias=1e-6)
        total = nn_layers.elementwise_div(total, denom)
    return total


def _gather_encoded(enc, match_idx):
    """enc [N_gt, M, 4] -> per-prior target [M, 4] + matched weight
    [M, 1] via the match index (the gather the reference fuses into its
    ssd_loss Python composition)."""
    helper = LayerHelper("gather_encoded")
    out = helper.create_variable_for_type_inference(dtype=enc.dtype)
    wt = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type="gather_encoded",
        inputs={"Encoded": [enc], "MatchIndices": [match_idx]},
        outputs={"Out": [out], "OutWeight": [wt]})
    return out, wt


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD detection head (reference: layers/detection.py:1354): per
    feature map, generate priors and 3x3/1x1 conv loc+conf predictions,
    reshape and concat across maps. Returns
    (mbox_locs, mbox_confs, boxes, variances)."""
    from paddle_tpu_torch.layers import nn as nn_layers
    from paddle_tpu_torch.layers import tensor as tensor_layers

    n_maps = len(inputs)
    if min_sizes is None:
        # the reference's ratio interpolation
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_maps - 2)) \
            if n_maps > 2 else 0
        for ratio in range(min_ratio, max_ratio + 1, max(step, 1)):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes[:n_maps - 1]
        max_sizes = [base_size * 0.20] + max_sizes[:n_maps - 1]

    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        ms = min_sizes[i]
        ms_list = ms if isinstance(ms, (list, tuple)) else [ms]
        mx = max_sizes[i] if max_sizes else None
        mx_list = (mx if isinstance(mx, (list, tuple)) else [mx]) \
            if mx is not None else None
        ar = aspect_ratios[i]
        ar_list = ar if isinstance(ar, (list, tuple)) else [ar]
        st = steps[i] if steps else (
            (step_w[i] if step_w else 0.0, step_h[i] if step_h else 0.0))
        if not isinstance(st, (list, tuple)):
            st = (st, st)  # canonical SSD configs give one scalar per map
        box, var = prior_box(
            feat, image, min_sizes=ms_list, max_sizes=mx_list,
            aspect_ratios=ar_list, variance=variance, flip=flip,
            clip=clip, steps=list(st), offset=offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        num_priors = (len(ms_list) * len(_expand_aspect_ratios(
            ar_list, flip)) + (len(mx_list) if mx_list else 0))
        loc = nn_layers.conv2d(feat, num_filters=num_priors * 4,
                               filter_size=kernel_size, padding=pad,
                               stride=stride)
        conf = nn_layers.conv2d(feat, num_filters=num_priors * num_classes,
                                filter_size=kernel_size, padding=pad,
                                stride=stride)
        # NCHW -> [B, H*W*priors, 4 / num_classes]
        loc = nn_layers.transpose(loc, perm=[0, 2, 3, 1])
        loc = nn_layers.reshape(loc, shape=[-1 if loc.shape[0] in (None, -1)
                                            else loc.shape[0],
                                            _numel(loc.shape[1:]) // 4, 4])
        conf = nn_layers.transpose(conf, perm=[0, 2, 3, 1])
        conf = nn_layers.reshape(
            conf, shape=[-1 if conf.shape[0] in (None, -1)
                         else conf.shape[0],
                         _numel(conf.shape[1:]) // num_classes,
                         num_classes])
        box = nn_layers.reshape(box, shape=[-1, 4])
        var = nn_layers.reshape(var, shape=[-1, 4])
        locs.append(loc)
        confs.append(conf)
        boxes_all.append(box)
        vars_all.append(var)

    mbox_locs = tensor_layers.concat(locs, axis=1) if len(locs) > 1 else locs[0]
    mbox_confs = tensor_layers.concat(confs, axis=1) \
        if len(confs) > 1 else confs[0]
    boxes = tensor_layers.concat(boxes_all, axis=0) \
        if len(boxes_all) > 1 else boxes_all[0]
    variances = tensor_layers.concat(vars_all, axis=0) \
        if len(vars_all) > 1 else vars_all[0]
    return mbox_locs, mbox_confs, boxes, variances


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def yolov3_loss(x, gtbox, gtlabel, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, name=None):
    """(reference: layers/detection.py:508)"""
    helper = LayerHelper("yolov3_loss", name=name)
    loss = _out(helper)
    obj_mask = _out(helper)
    match_mask = _out(helper, "int32")
    helper.append_op(
        type="yolov3_loss",
        inputs={"X": [x], "GTBox": [gtbox], "GTLabel": [gtlabel]},
        outputs={"Loss": [loss], "ObjectnessMask": [obj_mask],
                 "GTMatchMask": [match_mask]},
        attrs={"anchors": list(anchors),
               "anchor_mask": list(anchor_mask),
               "class_num": class_num,
               "ignore_thresh": ignore_thresh,
               "downsample_ratio": downsample_ratio})
    return loss


def _np_map(dets, gts, overlap_threshold, ap_version,
            background_label=0, evaluate_difficult=True):
    """Host-side mAP (the computation of the reference's detection_map
    op, operators/detection/detection_map_op.h): greedy IoU matching per
    class, AP by 'integral' or '11point', background class excluded.
    dets: [B, K, 6] rows (label, score, x1, y1, x2, y2) padded label<0;
    gts: [B, G, 5] rows (label, x1, y1, x2, y2) — or [B, G, 6] with a
    trailing is_difficult flag honored when evaluate_difficult=False
    (difficult gts neither count as positives nor penalize matches)."""
    import numpy as np

    def iou(a, b):
        ix = min(a[2], b[2]) - max(a[0], b[0])
        iy = min(a[3], b[3]) - max(a[1], b[1])
        if ix <= 0 or iy <= 0:
            return 0.0
        inter = ix * iy
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / max(ua, 1e-10)

    has_difficult = gts.shape[-1] >= 6
    classes = sorted({int(g[0]) for img in gts for g in img
                      if g[0] >= 0 and int(g[0]) != background_label})
    aps = []
    for c in classes:
        records = []   # (score, is_tp)
        n_gt = 0
        for b in range(len(gts)):
            rows = [g for g in gts[b] if int(g[0]) == c]
            gt_c = [g[1:5] for g in rows]
            diff = [bool(g[5]) if has_difficult else False for g in rows]
            n_gt += sum(1 for d_ in diff if evaluate_difficult or not d_)
            used = [False] * len(gt_c)
            det_c = sorted([d for d in dets[b] if int(d[0]) == c],
                           key=lambda d: -d[1])
            for d in det_c:
                best, best_i = 0.0, -1
                for i, g in enumerate(gt_c):
                    o = iou(d[2:], g)
                    if o > best:
                        best, best_i = o, i
                if (best > overlap_threshold and best_i >= 0
                        and not evaluate_difficult and diff[best_i]):
                    continue  # difficult match: neither TP nor FP
                tp = best > overlap_threshold and not used[best_i]
                if tp:
                    used[best_i] = True
                records.append((float(d[1]), tp))
        if n_gt == 0:
            continue
        records.sort(key=lambda r: -r[0])
        tps = np.cumsum([1.0 if r[1] else 0.0 for r in records]) \
            if records else np.zeros(0)
        fps = np.cumsum([0.0 if r[1] else 1.0 for r in records]) \
            if records else np.zeros(0)
        recall = tps / n_gt if len(tps) else np.zeros(0)
        precision = tps / np.maximum(tps + fps, 1e-10) \
            if len(tps) else np.zeros(0)
        if ap_version == "11point":
            ap = 0.0
            for t in np.arange(0.0, 1.01, 0.1):
                p = precision[recall >= t].max() \
                    if np.any(recall >= t) else 0.0
                ap += p / 11.0
        else:  # integral
            ap, prev_r = 0.0, 0.0
            for p, r in zip(precision, recall):
                ap += p * (r - prev_r)
                prev_r = r
        aps.append(ap)
    return np.float32(np.mean(aps) if aps else 0.0)


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral"):
    """mAP metric (reference: layers/detection.py:610 → detection_map
    op). Runs host-side through py_func on the static-shape detection
    format; returns a [1] float map value."""
    from paddle_tpu_torch.layers import nn as nn_layers

    if input_states is not None or out_states is not None:
        raise NotImplementedError(
            "detection_map: streaming state accumulation "
            "(input_states/out_states) is not supported — compute mAP "
            "per evaluation pass or accumulate detections host-side "
            "(metrics.DetectionMAP does this)")
    del has_state
    helper = LayerHelper("detection_map")
    out = helper.create_variable_for_type_inference("float32")
    out.desc.shape = [1]

    def compute(dets, gts):
        import numpy as np

        return _np_map(np.asarray(dets), np.asarray(gts),
                       overlap_threshold, ap_version,
                       background_label=background_label,
                       evaluate_difficult=evaluate_difficult).reshape(1)

    nn_layers.py_func(compute, [detect_res, label], [out])
    return out


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None,
                       return_rois_num=False):
    """(reference: layers/detection.py:1972). Static-shape outputs:
    (rpn_rois [N, post, 4], rpn_roi_probs [N, post, 1]) zero-padded past
    each image's proposal count — pass return_rois_num=True to also get
    the [N] per-image count and mask the padding downstream. ``eta``
    (adaptive NMS) is accepted but unsupported under static shapes."""
    helper = LayerHelper("generate_proposals", name=name)
    rois = _out(helper)
    probs = _out(helper)
    count = _out(helper, "int32")
    helper.append_op(
        type="generate_proposals",
        inputs={"Scores": [scores], "BboxDeltas": [bbox_deltas],
                "ImInfo": [im_info], "Anchors": [anchors],
                "Variances": [variances]},
        outputs={"RpnRois": [rois], "RpnRoiProbs": [probs],
                 "RpnRoisNum": [count]},
        attrs={"pre_nms_topN": pre_nms_top_n,
               "post_nms_topN": post_nms_top_n,
               "nms_thresh": nms_thresh, "min_size": min_size,
               "eta": eta})
    if return_rois_num:
        return rois, probs, count
    return rois, probs


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """(reference: layers/detection.py:57). With bbox_pred/cls_logits
    given, returns the REFERENCE 5-tuple (score_pred [M, 1],
    loc_pred [M, 4], score_target [M, 1] in {1, 0, -1(ignore)},
    loc_target [M, 4], bbox_inside_weight [M, 1]) in dense per-anchor
    form — mask score terms where score_target < 0 and weight location
    terms by bbox_inside_weight, instead of the reference's gathered
    subsets. With preds omitted, returns the raw per-anchor targets
    (score_target, bbox_target, bbox_weight, loc_index, score_index)."""
    helper = LayerHelper("rpn_target_assign")
    score_t = _out(helper, "int32")
    bbox_t = _out(helper)
    bbox_w = _out(helper)
    loc_i = _out(helper, "int64")
    score_i = _out(helper, "int64")
    inputs = {"Anchor": [anchor_box], "GtBoxes": [gt_boxes]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd]
    if im_info is not None:
        inputs["ImInfo"] = [im_info]
    helper.append_op(
        type="rpn_target_assign", inputs=inputs,
        outputs={"ScoreTarget": [score_t], "BboxTarget": [bbox_t],
                 "BboxWeight": [bbox_w], "LocationIndex": [loc_i],
                 "ScoreIndex": [score_i]},
        attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
               "rpn_fg_fraction": rpn_fg_fraction,
               "rpn_positive_overlap": rpn_positive_overlap,
               "rpn_negative_overlap": rpn_negative_overlap,
               "rpn_straddle_thresh": rpn_straddle_thresh,
               "use_random": use_random})
    if bbox_pred is not None and cls_logits is not None:
        from paddle_tpu_torch.layers import nn as nn_layers

        score_pred = nn_layers.reshape(cls_logits, shape=[-1, 1])
        loc_pred = nn_layers.reshape(bbox_pred, shape=[-1, 4])
        score_tgt = nn_layers.reshape(score_t, shape=[-1, 1])
        return score_pred, loc_pred, score_tgt, bbox_t, bbox_w
    return score_t, bbox_t, bbox_w, loc_i, score_i


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info=None, rpn_rois_num=None,
                             batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True):
    """(reference: layers/detection.py:1743). Static single-image form:
    returns (rois [P, 4], labels_int32 [P], bbox_targets
    [P, 4*class_nums], bbox_inside_weights, bbox_outside_weights) with
    P = batch_size_per_im; padding rows carry label -1, zero weights."""
    helper = LayerHelper("generate_proposal_labels")
    rois = _out(helper)
    labels = _out(helper, "int32")
    tgts = _out(helper)
    in_w = _out(helper)
    out_w = _out(helper)
    inputs = {"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
              "GtBoxes": [gt_boxes]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd]
    if im_info is not None:
        inputs["ImInfo"] = [im_info]
    if rpn_rois_num is not None:
        inputs["RpnRoisNum"] = [rpn_rois_num]
    helper.append_op(
        type="generate_proposal_labels", inputs=inputs,
        outputs={"Rois": [rois], "LabelsInt32": [labels],
                 "BboxTargets": [tgts], "BboxInsideWeights": [in_w],
                 "BboxOutsideWeights": [out_w]},
        attrs={"batch_size_per_im": batch_size_per_im,
               "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
               "bg_thresh_hi": bg_thresh_hi, "bg_thresh_lo": bg_thresh_lo,
               "bbox_reg_weights": list(bbox_reg_weights),
               "class_nums": class_nums or 81,
               "use_random": use_random})
    return rois, labels, tgts, in_w, out_w


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              rois_batch_idx=None, name=None):
    """Warp quadrilateral RoIs ([R, 8] clockwise quads) to a fixed
    [transformed_height, transformed_width] grid (reference:
    layers/detection.py:1695 + detection/roi_perspective_transform_op.cc).
    ``rois_batch_idx`` replaces the reference's LoD."""
    helper = LayerHelper("roi_perspective_transform", name=name)
    out = _out(helper, input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_idx is not None:
        inputs["RoisBatchIdx"] = [rois_batch_idx]
    helper.append_op(
        type="roi_perspective_transform", inputs=inputs,
        outputs={"Out": [out]},
        attrs={"transformed_height": transformed_height,
               "transformed_width": transformed_width,
               "spatial_scale": spatial_scale})
    return out


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution,
                         gt_poly_lens=None):
    """Mask-RCNN mask targets (reference: layers/detection.py:1838 +
    detection/generate_mask_labels_op.cc). Static-shape form: ``gt_segms``
    is a padded [G, P, V, 2] polygon tensor with ``gt_poly_lens`` [G, P]
    vertex counts standing in for the reference's level-3 LoD. Returns
    (mask_rois, roi_has_mask_int32, mask_int32) with all R rows kept,
    foreground first; padding rows carry -1."""
    helper = LayerHelper("generate_mask_labels")
    mask_rois = _out(helper, "float32")
    roi_has_mask = _out(helper, "int32")
    mask_int32 = _out(helper, "int32")
    num = _out(helper, "int32")
    inputs = {"ImInfo": [im_info], "GtClasses": [gt_classes],
              "IsCrowd": [is_crowd], "GtSegms": [gt_segms],
              "Rois": [rois], "LabelsInt32": [labels_int32]}
    if gt_poly_lens is not None:
        inputs["GtPolyLens"] = [gt_poly_lens]
    helper.append_op(
        type="generate_mask_labels", inputs=inputs,
        outputs={"MaskRois": [mask_rois],
                 "RoiHasMaskInt32": [roi_has_mask],
                 "MaskInt32": [mask_int32],
                 "MaskRoisNum": [num]},
        attrs={"num_classes": num_classes, "resolution": resolution})
    return mask_rois, roi_has_mask, mask_int32
