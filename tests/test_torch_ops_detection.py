"""The detection and CTC op families' lowerings (ROADMAP Queue 1, step
5f) against the JAX package's, on the same random inputs (numpy,
seeded), through each package's registry and LowerContext: the 20
``detection_ops`` and ``warpctc``/``edit_distance``, forward and vjp
grads.

The cases follow the JAX package's ``tests/test_detection_ctc.py``, at
tiny sizes, with the points where the two could part: tied scores in the
top-k rankings (``multiclass_nms``, ``generate_proposals``), tied
priorities in the samplers' stable ranking (``_subsample``), duplicate
ids in the scatter-max updates (two ground truths on one anchor in
``rpn_target_assign``, a padding row on a positive's cell in
``yolov3_loss``), ties in ``roi_pool``'s max and in the greedy scans'
argmax (``bipartite_match``, ``similarity_focus``).

Tolerance: each float output and grad within 1e-5 of the reference's
largest element (``test_torch_ops_misc``'s ``_close``); integer and
boolean outputs exact, by value (the JAX package's int64 outputs come
back int32). The two samplers draw their priorities from the port's
counter hash: with ``use_random`` the JAX lowering's draw is patched to
return the port's priorities, then everything is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import (LowerContext as JLowerContext,
                                      OpRegistry as JOpRegistry)
from paddle_tpu.ops import detection_ops as j_det
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)

from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry)
from paddle_tpu_torch.ops import detection_ops as t_det
from paddle_tpu_torch.ops.common import uniform_floats
import paddle_tpu_torch.ops  # noqa: F401  (registers the torch lowerings)

from test_torch_ops_misc import _close, _compare, _run, _vjp_pair


def _f(shape, seed, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _u(shape, seed, low=0.0, high=1.0):
    return np.random.RandomState(seed).uniform(low, high, shape).astype(
        np.float32)


def _i(values, dtype=np.int64):
    return np.asarray(values, dtype)


def _boxes(n, seed, extent=1.0, min_wh=0.05):
    """[n, 4] corner boxes inside [0, extent]^2, each side at least
    ``min_wh * extent``."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0.0, 0.7 * extent, (n, 2))
    wh = rng.uniform(min_wh * extent, 0.3 * extent, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _anchors(h, w, sizes, stride):
    """[h, w, len(sizes), 4] square anchors at the image-scale stride."""
    cy, cx = np.meshgrid((np.arange(h) + 0.5) * stride,
                         (np.arange(w) + 0.5) * stride, indexing="ij")
    half = np.asarray(sizes, np.float32) / 2.0
    out = np.stack([cx[..., None] - half, cy[..., None] - half,
                    cx[..., None] + half, cy[..., None] + half], -1)
    return out.astype(np.float32)


def _quads(r, seed, size):
    """[r, 8] convex clockwise quads inside a size x size map."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(r):
        x0, y0 = rng.uniform(0.5, size / 3, 2)
        w, h = rng.uniform(size / 4, size / 2, 2)
        j = rng.uniform(-0.8, 0.8, 4)
        out.append([x0 + j[0], y0, x0 + w, y0 + j[1],
                    x0 + w + j[2], y0 + h, x0, y0 + h + j[3]])
    return np.asarray(out, np.float32)


def _polys(g, p, v, seed, extent):
    """[g, p, v, 2] zero-padded polygons and [g, p] vertex counts."""
    rng = np.random.RandomState(seed)
    segms = np.zeros((g, p, v, 2), np.float32)
    lens = np.zeros((g, p), np.int32)
    for i in range(g):
        cx, cy = rng.uniform(0.3 * extent, 0.7 * extent, 2)
        for k in range(p):
            n = rng.randint(3, v + 1)
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            rad = rng.uniform(0.1 * extent, 0.25 * extent, n)
            segms[i, k, :n, 0] = cx + rad * np.cos(ang)
            segms[i, k, :n, 1] = cy + rad * np.sin(ang)
            lens[i, k] = n
    return segms, lens


_NMS_BOXES = np.stack([_boxes(12, 1), _boxes(12, 2)])
_NMS_SCORES = _u((2, 3, 12), 3)
# ties: scores on a 0.1 grid, so many candidates rank equal
_NMS_TIED = np.round(_u((2, 4, 10), 4) * 5) / 5
_GP_ANCHORS = _anchors(4, 4, [12.0, 20.0, 28.0], 8.0)
_GP_INFO = np.array([[32.0, 32.0, 1.0], [30.0, 28.0, 2.0]], np.float32)
_RPN_ANCHORS = _anchors(4, 4, [10.0, 18.0, 26.0], 8.0).reshape(-1, 4)
# two ground truths whose best anchor is the same one
_RPN_GT = np.array([[4.0, 4.0, 14.0, 14.0], [5.0, 5.0, 13.0, 13.0],
                    [18.0, 2.0, 30.0, 20.0], [0.0, 0.0, 0.0, 0.0]],
                   np.float32)
_SEGMS, _POLY_LENS = _polys(3, 2, 6, 40, 60.0)
_YOLO_GT = np.array([[[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.4, 0.2],
                      [0.31, 0.41, 0.05, 0.04], [0.0, 0.0, 0.0, 0.0]],
                     [[0.5, 0.5, 0.6, 0.7], [0.1, 0.8, 0.1, 0.1],
                      [0.55, 0.52, 0.3, 0.3], [0.0, 0.0, 0.0, 0.0]]],
                    np.float32)
_CTC_LABELS = _i([[1, 3, 3], [2, 4, 0], [4, 1, 2]])
# max pooling's ties: relu'd integers
_POOL_X = np.maximum(np.round(_f((2, 3, 8, 8), 50)), 0.0).astype(np.float32)

# (id, op type, {slot: [numpy arrays]}, attrs)
CASES = [
    ("prior_box", "prior_box",
     {"Input": [_f((1, 4, 3, 3), 0)], "Image": [_f((1, 3, 24, 24), 1)]},
     {"min_sizes": [4.0, 8.0], "max_sizes": [9.0, 12.0],
      "aspect_ratios": [2.0, 3.0], "variances": [0.1, 0.1, 0.2, 0.2],
      "flip": True, "clip": True, "step_w": 0.0, "step_h": 0.0,
      "offset": 0.5, "min_max_aspect_ratios_order": False}),
    ("prior_box_min_max_order_steps", "prior_box",
     {"Input": [_f((1, 4, 2, 3), 2)], "Image": [_f((1, 3, 20, 30), 3)]},
     {"min_sizes": [6.0], "max_sizes": [10.0], "aspect_ratios": [2.0],
      "variances": [0.1, 0.1, 0.2, 0.2], "flip": False, "clip": False,
      "step_w": 9.0, "step_h": 11.0, "offset": 0.3,
      "min_max_aspect_ratios_order": True}),
    ("density_prior_box", "density_prior_box",
     {"Input": [_f((1, 4, 3, 2), 4)], "Image": [_f((1, 3, 24, 16), 5)]},
     {"densities": [2, 1], "fixed_sizes": [8.0, 16.0],
      "fixed_ratios": [1.0, 2.0], "variances": [0.1, 0.1, 0.2, 0.2],
      "clip": True, "step_w": 0.0, "step_h": 0.0, "offset": 0.5}),
    ("anchor_generator", "anchor_generator",
     {"Input": [_f((1, 4, 3, 4), 6)]},
     {"anchor_sizes": [16.0, 32.0], "aspect_ratios": [0.5, 1.0, 2.0],
      "variances": [0.1, 0.1, 0.2, 0.2], "stride": [8.0, 8.0],
      "offset": 0.5}),
    ("box_coder_encode", "box_coder",
     {"PriorBox": [_boxes(6, 7)], "PriorBoxVar": [np.full(
         (6, 4), 0.1, np.float32) + _u((6, 4), 8, 0.0, 0.1)],
      "TargetBox": [_boxes(3, 9)]},
     {"code_type": "encode_center_size", "box_normalized": True}),
    ("box_coder_encode_pixels_no_var", "box_coder",
     {"PriorBox": [_boxes(5, 10, 40.0)], "TargetBox": [_boxes(4, 11, 40.0)]},
     {"code_type": "encode_center_size", "box_normalized": False}),
    ("box_coder_decode_axis0", "box_coder",
     {"PriorBox": [_boxes(6, 12)], "PriorBoxVar": [np.full(
         (6, 4), 0.2, np.float32)], "TargetBox": [_f((2, 6, 4), 13, 0.5)]},
     {"code_type": "decode_center_size", "box_normalized": True, "axis": 0}),
    ("box_coder_decode_axis1", "box_coder",
     {"PriorBox": [_boxes(6, 14, 30.0)], "PriorBoxVar": [np.full(
         (6, 4), 0.1, np.float32)], "TargetBox": [_f((6, 3, 4), 15, 0.5)]},
     {"code_type": "decode_center_size", "box_normalized": False,
      "axis": 1}),
    ("iou_similarity", "iou_similarity",
     {"X": [_boxes(5, 16)], "Y": [_boxes(7, 17)]}, {"box_normalized": True}),
    ("iou_similarity_pixels", "iou_similarity",
     {"X": [_boxes(4, 18, 20.0)],
      "Y": [np.concatenate([_boxes(3, 19, 20.0), np.zeros((1, 4),
                                                          np.float32)])]},
     {"box_normalized": False}),
    ("box_clip", "box_clip",
     {"Input": [_f((2, 5, 4), 20, 30.0)],
      "ImInfo": [np.array([[20.0, 30.0, 1.0], [40.0, 24.0, 2.0]],
                          np.float32)]}, {}),
    ("box_clip_2d", "box_clip",
     {"Input": [_f((5, 4), 21, 30.0)],
      "ImInfo": [np.array([[20.0, 30.0, 1.5]], np.float32)]}, {}),
    ("polygon_box_transform", "polygon_box_transform",
     {"Input": [_f((2, 8, 3, 4), 22)]}, {}),
    ("bipartite_match", "bipartite_match", {"DistMat": [_u((5, 7), 23)]},
     {"match_type": "bipartite", "dist_threshold": 0.5}),
    ("bipartite_match_per_prediction_batched", "bipartite_match",
     {"DistMat": [_u((2, 4, 6), 24)]},
     {"match_type": "per_prediction", "dist_threshold": 0.3}),
    # equal entries (the first index wins) and an all-zero row
    ("bipartite_match_ties", "bipartite_match",
     {"DistMat": [np.array([[0.5, 0.5, 0.2], [0.5, 0.5, 0.2],
                            [0.0, 0.0, 0.0]], np.float32)]},
     {"match_type": "per_prediction", "dist_threshold": 0.1}),
    ("target_assign_rows", "target_assign",
     {"X": [_f((4, 3), 25)], "MatchIndices": [_i([[0, -1, 3, 1, -1, 2],
                                                 [2, 2, -1, 0, 1, -1]],
                                                np.int32)]},
     {"mismatch_value": 0}),
    ("target_assign_labels", "target_assign",
     {"X": [_i([[3], [1], [2], [5]])],
      "MatchIndices": [_i([[0, -1, 3, 1, -1, 2]], np.int32)]},
     {"mismatch_value": 0}),
    ("gather_encoded", "gather_encoded",
     {"Encoded": [_f((3, 6, 4), 26)],
      "MatchIndices": [_i([[1, -1, 0, 2, 2, -1]], np.int32)]}, {}),
    ("multiclass_nms", "multiclass_nms",
     {"BBoxes": [_NMS_BOXES], "Scores": [_NMS_SCORES]},
     {"score_threshold": 0.1, "nms_top_k": 6, "keep_top_k": 8,
      "nms_threshold": 0.3, "normalized": True, "nms_eta": 1.0,
      "background_label": 0}),
    # tied scores, padding past the candidates, background last
    ("multiclass_nms_ties_padded", "multiclass_nms",
     {"BBoxes": [np.stack([_boxes(10, 27), _boxes(10, 28)])],
      "Scores": [_NMS_TIED]},
     {"score_threshold": 0.25, "nms_top_k": 4, "keep_top_k": 16,
      "nms_threshold": 0.2, "normalized": True, "nms_eta": 1.0,
      "background_label": 3}),
    ("multiclass_nms_pixels_all_k", "multiclass_nms",
     {"BBoxes": [np.stack([_boxes(9, 29, 50.0)])],
      "Scores": [_u((1, 3, 9), 30)]},
     {"score_threshold": 0.0, "nms_top_k": -1, "keep_top_k": -1,
      "nms_threshold": 0.5, "normalized": False, "nms_eta": 1.0,
      "background_label": -1}),
    ("roi_align", "roi_align",
     {"X": [_f((2, 3, 8, 8), 31)],
      "ROIs": [_boxes(4, 32, 14.0)],
      "RoisBatchIdx": [_i([0, 1, 1, 0], np.int32)]},
     {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5,
      "sampling_ratio": -1}),
    ("roi_align_no_batch_idx", "roi_align",
     {"X": [_f((1, 2, 6, 7), 33)], "ROIs": [_boxes(3, 34, 6.0)]},
     {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0,
      "sampling_ratio": 3}),
    ("roi_pool_ties", "roi_pool",
     {"X": [_POOL_X], "ROIs": [_boxes(4, 35, 14.0)],
      "RoisBatchIdx": [_i([1, 0, 1, 0], np.int32)]},
     {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 0.5}),
    ("roi_perspective_transform", "roi_perspective_transform",
     {"X": [_f((2, 2, 10, 10), 36)], "ROIs": [_quads(3, 37, 10.0)],
      "RoisBatchIdx": [_i([0, 1, 1], np.int32)]},
     {"transformed_height": 3, "transformed_width": 5,
      "spatial_scale": 1.0}),
    ("yolov3_loss", "yolov3_loss",
     {"X": [_f((2, 27, 4, 4), 38, 0.5)], "GTBox": [_YOLO_GT],
      "GTLabel": [_i([[1, 2, 3, 0], [0, 3, 1, 0]])]},
     {"anchors": [10, 13, 16, 30, 33, 23, 30, 61, 62, 45],
      "anchor_mask": [0, 1, 2], "class_num": 4, "ignore_thresh": 0.5,
      "downsample_ratio": 8}),
    ("generate_proposals", "generate_proposals",
     {"Scores": [_f((2, 3, 4, 4), 39)],
      "BboxDeltas": [_f((2, 12, 4, 4), 41, 0.3)], "ImInfo": [_GP_INFO],
      "Anchors": [_GP_ANCHORS],
      "Variances": [np.full(_GP_ANCHORS.shape, 0.5, np.float32)]},
     {"pre_nms_topN": 20, "post_nms_topN": 8, "nms_thresh": 0.5,
      "min_size": 2.0, "eta": 1.0}),
    # tied scores; fewer proposals than post_nms_topN, so zero rows
    ("generate_proposals_ties_padded", "generate_proposals",
     {"Scores": [np.round(_f((1, 3, 4, 4), 42)) / 2],
      "BboxDeltas": [_f((1, 12, 4, 4), 43, 0.3)], "ImInfo": [_GP_INFO[:1]],
      "Anchors": [_GP_ANCHORS],
      "Variances": [np.full(_GP_ANCHORS.shape, 1.0, np.float32)]},
     {"pre_nms_topN": 30, "post_nms_topN": 40, "nms_thresh": 0.3,
      "min_size": 4.0, "eta": 1.0}),
    ("rpn_target_assign_shared_best_anchor", "rpn_target_assign",
     {"Anchor": [_RPN_ANCHORS], "GtBoxes": [_RPN_GT],
      "IsCrowd": [_i([0, 0, 0, 0], np.int32)],
      "ImInfo": [np.array([[32.0, 32.0, 1.0]], np.float32)]},
     {"rpn_batch_size_per_im": 16, "rpn_fg_fraction": 0.25,
      "rpn_positive_overlap": 0.6, "rpn_negative_overlap": 0.3,
      "rpn_straddle_thresh": 0.0, "use_random": False}),
    ("rpn_target_assign_crowd_no_info", "rpn_target_assign",
     {"Anchor": [_RPN_ANCHORS], "GtBoxes": [_RPN_GT],
      "IsCrowd": [_i([0, 1, 0, 0], np.int32)]},
     {"rpn_batch_size_per_im": 12, "rpn_fg_fraction": 0.5,
      "rpn_positive_overlap": 0.5, "rpn_negative_overlap": 0.2,
      "rpn_straddle_thresh": -1.0, "use_random": False}),
    ("generate_proposal_labels", "generate_proposal_labels",
     {"RpnRois": [np.concatenate([_boxes(8, 44, 40.0), _RPN_GT[:1],
                                  np.zeros((2, 4), np.float32)])],
      "GtClasses": [_i([[3], [1], [2]])], "GtBoxes": [_RPN_GT[:3]],
      "IsCrowd": [_i([[0], [0], [1]], np.int32)],
      "ImInfo": [np.array([[40.0, 40.0, 1.0]], np.float32)],
      "RpnRoisNum": [_i([9], np.int32)]},
     {"batch_size_per_im": 16, "fg_fraction": 0.25, "fg_thresh": 0.5,
      "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0,
      "bbox_reg_weights": [0.1, 0.1, 0.2, 0.2], "class_nums": 4,
      "use_random": False}),
    ("generate_mask_labels", "generate_mask_labels",
     {"ImInfo": [np.array([[60.0, 60.0, 2.0]], np.float32)],
      "GtClasses": [_i([[2], [0], [3]], np.int32)],
      "IsCrowd": [_i([[0], [0], [0]], np.int32)],
      "GtSegms": [_SEGMS], "GtPolyLens": [_POLY_LENS],
      "Rois": [_boxes(5, 45, 120.0)],
      "LabelsInt32": [_i([0, 2, 3, 0, 3], np.int32)]},
     {"num_classes": 4, "resolution": 6}),
    ("generate_mask_labels_no_foreground", "generate_mask_labels",
     {"ImInfo": [np.array([[60.0, 60.0, 1.0]], np.float32)],
      "GtClasses": [_i([[2], [1], [3]], np.int32)],
      "IsCrowd": [_i([[0], [1], [0]], np.int32)],
      "GtSegms": [_SEGMS], "Rois": [_boxes(4, 46, 60.0)],
      "LabelsInt32": [_i([-1, 0, -1, 0], np.int32)]},
     {"num_classes": 4, "resolution": 5}),
    ("similarity_focus", "similarity_focus", {"X": [_f((2, 3, 4, 5), 47)]},
     {"axis": 1, "indexes": [0, 2]}),
    ("similarity_focus_ties", "similarity_focus",
     {"X": [np.round(_u((1, 2, 3, 3), 48) * 2)]},
     {"axis": 1, "indexes": [1]}),
    ("warpctc", "warpctc",
     {"Logits": [_f((3, 8, 5), 49)], "Label": [_CTC_LABELS],
      "LogitsLength": [_i([8, 6, 7])], "LabelLength": [_i([3, 2, 3])]},
     {"blank": 0, "norm_by_times": False}),
    ("warpctc_blank_last_norm_by_times", "warpctc",
     {"Logits": [_f((2, 7, 4), 51)], "Label": [_i([[[0], [2]], [[1], [1]]])]},
     {"blank": 3, "norm_by_times": True}),
    ("edit_distance", "edit_distance",
     {"Hyps": [_i([[1, 2, 3, 4, 0], [5, 6, 7, 0, 0], [1, 1, 2, 2, 3]])],
      "Refs": [_i([[1, 3, 3, 0], [5, 6, 7, 8], [2, 2, 1, 0]])],
      "HypsLength": [_i([4, 3, 5])], "RefsLength": [_i([3, 4, 0])]},
     {"normalized": False, "ignored_tokens": []}),
    ("edit_distance_normalized_ignored", "edit_distance",
     {"Hyps": [_i([[[1], [9], [2], [3]], [[9], [4], [9], [5]]])],
      "Refs": [_i([[[1], [2], [9]], [[4], [5], [6]]])]},
     {"normalized": True, "ignored_tokens": [9]}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_lowering_matches_reference(case):
    _, op_type, ins, attrs = case
    _compare(_run("jax", op_type, ins, attrs),
             _run("torch", op_type, ins, attrs))


VJP_CASES = [c for c in CASES
             if TOpRegistry.get(c[1]).grad_maker is not None]


@pytest.mark.parametrize("case", VJP_CASES, ids=[c[0] for c in VJP_CASES])
def test_vjp_grad_matches_reference(case):
    """The grads the engine derives (``torch.func.vjp`` of the port's
    lowering) against ``jax.vjp`` of the reference's."""
    _, op_type, ins, attrs = case
    primals, want, got = _vjp_pair(op_type, ins, attrs)
    assert primals
    for (s, i), g, w in zip(primals, got, want):
        _close(g, w, "%s@GRAD" % s)


# -- the samplers through the port's priorities --------------------------------

_SAMPLER_CASES = {c[1]: c for c in CASES if c[1] in (
    "rpn_target_assign", "generate_proposal_labels")}


def _port_priorities(op_type, ins, attrs):
    """The priorities the port's lowering draws for ``ins`` (its seed from
    ``_run``'s context)."""
    names = {s: ["x"] * len(v) for s, v in ins.items()}
    ctx = TLowerContext(TOpDesc(op_type, names, {}, attrs), None, "cpu",
                        rng_seed=(0, 1), op_index=0)
    if op_type == "rpn_target_assign":
        n = ins["Anchor"][0].reshape(-1, 4).shape[0]
    else:
        real = ins["RpnRois"][0].shape[0] + ins["GtBoxes"][0].shape[0]
        n = max(real, attrs["batch_size_per_im"])
    return uniform_floats(ctx.seed(t_det.SEED_HIGH), (n,), "cpu").numpy()


@pytest.mark.parametrize("op_type", sorted(_SAMPLER_CASES))
def test_sampler_matches_reference_through_the_ports_priorities(op_type):
    """With ``use_random``, the port's outputs against the JAX lowering's
    with ``jax.random.uniform`` returning the port's priorities (its file
    untouched)."""
    _, _, ins, attrs = _SAMPLER_CASES[op_type]
    attrs = dict(attrs, use_random=True)
    prio = _port_priorities(op_type, ins, attrs)
    got = _run("torch", op_type, ins, attrs)
    real = jax.random.uniform
    jax.random.uniform = lambda key, shape: jnp.asarray(prio)
    try:
        want = _run("jax", op_type, ins, attrs, jit=False)
    finally:
        jax.random.uniform = real
    _compare(want, got)


def test_subsample_ranks_tied_priorities_by_index():
    """Tied priorities (and the masked entries' 2.0) rank by index in
    both packages' ``_subsample``."""
    rng = np.random.RandomState(60)
    for _ in range(5):
        mask = rng.rand(40) < 0.6
        prio = (rng.randint(0, 4, 40) / 4.0).astype(np.float32)
        for cap in (0, 3, 10, 40):
            want = np.asarray(j_det._subsample(
                jnp.asarray(mask), cap, jnp.asarray(prio)))
            got = t_det._subsample(torch.from_numpy(mask), cap,
                                   torch.from_numpy(prio)).numpy()
            np.testing.assert_array_equal(got, want)


def test_scatter_max_keeps_each_shared_anchor_positive():
    """Two valid ground truths whose best anchor is the same one, and the
    zero box whose argmax lands on anchor 0: the anchor is positive once,
    anchor 0 stays negative (the reference's ``.at[].max``)."""
    _, op_type, ins, attrs = _SAMPLER_CASES["rpn_target_assign"]
    attrs = dict(attrs, rpn_positive_overlap=0.99,
                 rpn_batch_size_per_im=64)
    got = _run("torch", op_type, ins, attrs)
    want = _run("jax", op_type, ins, attrs)
    _compare(want, got)
    iou = t_det._pairwise_iou(torch.from_numpy(_RPN_ANCHORS),
                              torch.from_numpy(_RPN_GT),
                              normalized=False)
    best = iou.argmax(0).numpy()
    assert best[0] == best[1]
    target = got["ScoreTarget"][0]
    assert target[best[0]] == 1 and target[best[2]] == 1
    assert (target == 1).sum() == 2


def test_yolov3_padding_row_never_clears_a_positive():
    """The padding rows of GTBox clamp to the cell (0, 0) of anchor 0;
    a positive there stays positive."""
    gt = _YOLO_GT.copy()
    gt[0, 0] = [0.05, 0.05, 0.03, 0.04]   # cell (0, 0), anchor 0
    _, op_type, ins, attrs = [c for c in CASES if c[1] == "yolov3_loss"][0]
    ins = dict(ins, GTBox=[gt])
    got = _run("torch", op_type, ins, attrs)
    _compare(_run("jax", op_type, ins, attrs), got)
    assert got["ObjectnessMask"][0][0, 0, 0, 0] == 1.0


def test_greedy_scans_capture_nothing_from_the_host():
    """The scans and rankings (both NMS, the match, the samplers,
    similarity_focus, CTC) dispatch no op that a CUDA graph capture
    refuses: no read of a device value on the host, no shape that
    depends on the data, no tensor built from host data."""
    from torch.utils._python_dispatch import TorchDispatchMode

    bad_prefixes = ("aten.lift_fresh", "aten._local_scalar_dense",
                    "aten.nonzero", "aten.item")

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    for _, op_type, ins, attrs in CASES:
        names = {s: ["x"] * len(v) for s, v in ins.items()}
        ctx = TLowerContext(TOpDesc(op_type, names, {}, attrs), None, "cpu",
                            seeds={0: torch.tensor(99, dtype=torch.int64)})
        tins = {s: [torch.from_numpy(np.array(a)) for a in v]
                for s, v in ins.items()}
        with Record() as rec:
            TOpRegistry.get(op_type).lower(ctx, tins, dict(
                attrs, **({"use_random": True}
                          if "use_random" in attrs else {})))
        bad = [n for n in rec.names if n.startswith(bad_prefixes)]
        assert not bad, (op_type, bad)


def test_gathers_add_their_grads_back_by_take():
    """``roi_align``'s and ``warpctc``'s grads add their rows back through
    ``take`` (a sorted ``index_put_``), never ``index_add_`` or
    ``scatter_add_``, whose CUDA forms add with atomics."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    for op_type in ("roi_align", "roi_pool", "roi_perspective_transform",
                    "warpctc", "gather_encoded", "yolov3_loss"):
        _, _, ins, attrs = [c for c in CASES if c[1] == op_type][0]
        with Record() as rec:
            _vjp_pair(op_type, ins, attrs)
        names = " ".join(rec.names)
        assert "index_put" in names, op_type
        assert "index_add" not in names and "scatter_add" not in names, \
            op_type


# every lowering this file holds
SLICE_OPS = {c[1] for c in CASES}


def test_slice_holds_the_twenty_two_ops():
    assert len(SLICE_OPS) == 22
    assert SLICE_OPS == set(TOpRegistry.all_types()) & (
        set(JOpRegistry.all_types())) & {c[1] for c in CASES}


def test_registration_matches_the_reference():
    """The ops the JAX package registers without a grad have none in the
    port either; those with one have the same ``no_grad_inputs``; the
    samplers draw random numbers in both, the port's from the seed
    table."""
    for op_type in SLICE_OPS:
        j, t = JOpRegistry.get(op_type), TOpRegistry.get(op_type)
        assert (j.grad_maker is None) == (t.grad_maker is None), op_type
        assert j.needs_rng == t.needs_rng, op_type
        if t.grad_maker is not None:
            assert j.no_grad_inputs == t.no_grad_inputs, op_type
        assert t.capturable is True, op_type
    for op_type in ("rpn_target_assign", "generate_proposal_labels"):
        assert TOpRegistry.get(op_type).seed_range({}) == 2 ** 32


def test_multiclass_nms_raises_when_every_class_is_background():
    ins = {"BBoxes": [_NMS_BOXES[:, :3]], "Scores": [_NMS_SCORES[:, :1, :3]]}
    attrs = {"background_label": 0, "nms_top_k": 2, "keep_top_k": 2}
    for side in ("jax", "torch"):
        with pytest.raises(ValueError, match="background"):
            _run(side, "multiclass_nms", ins, attrs, jit=False)


def test_ctc_matches_torch_ctc_loss():
    """``warpctc`` and its grad against ``F.ctc_loss`` (the JAX package's
    own oracle in tests/test_detection_ctc.py)."""
    import torch.nn.functional as F

    _, _, ins, attrs = CASES[[c[0] for c in CASES].index("warpctc")]
    logits = torch.from_numpy(ins["Logits"][0]).requires_grad_(True)
    op = TOpDesc("warpctc", {s: ["x"] for s in ins}, {}, attrs)
    ctx = TLowerContext(op, None, "cpu")
    loss = TOpRegistry.get("warpctc").lower(ctx, {
        "Logits": [logits], "Label": [torch.from_numpy(ins["Label"][0])],
        "LogitsLength": [torch.from_numpy(ins["LogitsLength"][0])],
        "LabelLength": [torch.from_numpy(ins["LabelLength"][0])]},
        attrs)["Loss"][0]
    (g,) = torch.autograd.grad(loss.sum(), logits)
    ref_logits = logits.detach().transpose(0, 1).requires_grad_(True)
    ref = F.ctc_loss(ref_logits.log_softmax(-1),
                     torch.from_numpy(ins["Label"][0]),
                     torch.from_numpy(ins["LogitsLength"][0]),
                     torch.from_numpy(ins["LabelLength"][0]), blank=0,
                     reduction="none")
    (rg,) = torch.autograd.grad(ref.sum(), ref_logits)
    torch.testing.assert_close(loss.reshape(-1), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g, rg.transpose(0, 1), rtol=1e-4, atol=1e-5)
