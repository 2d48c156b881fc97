"""The detection and CTC layers (ROADMAP Queue 1, step 5f; item 6) in
the port against the JAX package's, on the CPU: the 22 builders of
``layers/detection.py``, ``warpctc`` and ``edit_distance``
(``layers/loss.py``) and ``similarity_focus`` (``layers/nn.py``). Each
builds a main and a startup desc byte-identical to the reference's
(ops, slots, attrs and the shapes inferred at build time), a training
program's backward included where the layer has a grad; both packages
export them alike, ``fluid.layers.detection`` too, and the layers that
raise in the JAX package raise in the port.
"""

import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as j_program_guard
from paddle_tpu.layers import detection as j_det
from paddle_tpu.layers import loss as j_loss
from paddle_tpu.layers import nn as j_nn

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.layers import detection as t_det
from paddle_tpu_torch.layers import loss as t_loss
from paddle_tpu_torch.layers import nn as t_nn

from torch_py_func_ids import _align_py_func_registries

FRONT_ENDS = ((jfluid, JProgram, j_program_guard, j_unique_name),
              (tfluid, tfluid.Program, tfluid.program_guard, t_unique_name))


def _data(layers, name, shape, dtype="float32", **kw):
    return layers.data(name=name, shape=shape, dtype=dtype, **kw)


def _train(fluid, loss):
    """A mean of ``loss`` minimized by SGD: the backward and update ops
    join the desc."""
    fluid.optimizer.SGD(learning_rate=0.1).minimize(
        fluid.layers.mean(loss))


def _program(fluid, name):
    """One small program calling layer ``name`` of ``fluid`` (either
    package's)."""
    layers = fluid.layers
    feat = _data(layers, "feat", [8, 3, 4])
    img = _data(layers, "img", [3, 24, 32])
    if name == "prior_box":
        return list(layers.prior_box(
            feat, img, min_sizes=[4.0, 8.0], max_sizes=[9.0, 12.0],
            aspect_ratios=[2.0, 3.0], flip=True, clip=True))
    if name == "density_prior_box":
        return list(layers.density_prior_box(
            feat, img, densities=[2, 1], fixed_sizes=[8.0, 16.0],
            fixed_ratios=[1.0, 2.0], clip=True, steps=[8.0, 8.0]))
    if name == "anchor_generator":
        return list(layers.anchor_generator(
            feat, anchor_sizes=[16.0, 32.0], aspect_ratios=[0.5, 1.0],
            stride=[8.0, 8.0]))
    priors = _data(layers, "priors", [4])
    pvar = _data(layers, "pvar", [4])
    if name == "box_coder":
        gt = _data(layers, "gt", [4])
        deltas = _data(layers, "deltas", [6, 4], append_batch_size=True)
        fixed = _data(layers, "fixed", [6, 4], append_batch_size=False)
        return [layers.box_coder(priors, pvar, gt),
                layers.box_coder(fixed, None, deltas,
                                 code_type="decode_center_size",
                                 box_normalized=False)]
    if name == "iou_similarity":
        return layers.iou_similarity(priors, pvar, box_normalized=False)
    if name == "box_clip":
        info = _data(layers, "info", [3])
        boxes = _data(layers, "boxes", [5, 4])
        return layers.box_clip(boxes, info)
    if name == "polygon_box_transform":
        return layers.polygon_box_transform(_data(layers, "geo", [8, 3, 4]))
    if name == "bipartite_match":
        dist = _data(layers, "dist", [5, 7], append_batch_size=False)
        return list(layers.bipartite_match(dist, "per_prediction", 0.3))
    if name == "target_assign":
        x = _data(layers, "x", [3])
        match = _data(layers, "match", [2, 6], dtype="int32",
                      append_batch_size=False)
        return list(layers.target_assign(x, match, mismatch_value=0))
    if name == "multiclass_nms":
        boxes = _data(layers, "boxes", [12, 4])
        scores = _data(layers, "scores", [3, 12])
        return list(layers.multiclass_nms(boxes, scores, 0.1, 6, 8,
                                          nms_threshold=0.4))
    if name in ("roi_align", "roi_pool", "roi_perspective_transform"):
        x = layers.conv2d(feat, num_filters=4, filter_size=1)
        bidx = _data(layers, "bidx", [1], dtype="int32")
        if name == "roi_align":
            rois = _data(layers, "rois", [4])
            out = layers.roi_align(x, rois, 2, 2, 0.5, rois_batch_idx=bidx)
        elif name == "roi_pool":
            rois = _data(layers, "rois", [4])
            out = layers.roi_pool(x, rois, 2, 3, 0.5, rois_batch_idx=bidx)
        else:
            rois = _data(layers, "rois", [8])
            out = layers.roi_perspective_transform(x, rois, 2, 3,
                                                   rois_batch_idx=bidx)
        _train(fluid, out)
        return out
    if name == "detection_output":
        loc = _data(layers, "loc", [12, 4])
        scores = layers.softmax(_data(layers, "conf", [12, 3]))
        fixed = _data(layers, "fixed", [12, 4], append_batch_size=False)
        return layers.detection_output(loc, scores, fixed, fixed,
                                       nms_top_k=6, keep_top_k=5)
    if name == "ssd_loss":
        f = _data(layers, "f", [16])
        gt = _data(layers, "gt", [4])
        gl = _data(layers, "gl", [1], dtype="int64")
        loc = layers.fc(input=f, size=4)
        conf = layers.fc(input=f, size=5)
        loss = layers.ssd_loss(loc, conf, gt, gl, priors,
                               prior_box_var=pvar)
        _train(fluid, loss)
        return loss
    if name == "multi_box_head":
        maps = [layers.conv2d(img, num_filters=4, filter_size=3, stride=s,
                              padding=1) for s in (4, 8, 16)]
        return list(layers.multi_box_head(
            maps, img, base_size=32, num_classes=3,
            aspect_ratios=[[2.0], [2.0, 3.0], [2.0]], min_ratio=20,
            max_ratio=90, flip=True, clip=True))
    if name == "yolov3_loss":
        x = layers.conv2d(feat, num_filters=27, filter_size=1)
        gtbox = _data(layers, "gtbox", [5, 4])
        gtlabel = _data(layers, "gtlabel", [5], dtype="int32")
        loss = layers.yolov3_loss(x, gtbox, gtlabel,
                                  anchors=[10, 13, 16, 30, 33, 23],
                                  anchor_mask=[0, 1, 2], class_num=4,
                                  ignore_thresh=0.7, downsample_ratio=8)
        _train(fluid, loss)
        return loss
    if name == "detection_map":
        dets = _data(layers, "dets", [10, 6])
        gts = _data(layers, "gts", [4, 6])
        return layers.detection_map(dets, gts, class_num=4,
                                    evaluate_difficult=False,
                                    ap_version="11point")
    if name == "generate_proposals":
        scores = _data(layers, "scores", [3, 4, 5])
        deltas = _data(layers, "deltas", [12, 4, 5])
        info = _data(layers, "info", [3])
        anchors, var = layers.anchor_generator(
            scores, anchor_sizes=[16.0, 32.0, 64.0], aspect_ratios=[1.0],
            stride=[8.0, 8.0])
        return list(layers.generate_proposals(
            scores, deltas, info, anchors, var, pre_nms_top_n=30,
            post_nms_top_n=10, return_rois_num=True))
    if name == "rpn_target_assign":
        anchors = _data(layers, "anchors", [4])
        gt = _data(layers, "gt", [4])
        crowd = _data(layers, "crowd", [1], dtype="int32")
        info = _data(layers, "info", [3])
        cls_logits = layers.conv2d(feat, num_filters=1, filter_size=1)
        bbox_pred = layers.conv2d(feat, num_filters=4, filter_size=1)
        return (list(layers.rpn_target_assign(
            bbox_pred, cls_logits, anchors, None, gt, is_crowd=crowd,
            im_info=info, rpn_batch_size_per_im=16))
            + list(layers.rpn_target_assign(None, None, anchors, None, gt,
                                            use_random=False)))
    if name == "generate_proposal_labels":
        rois = _data(layers, "rois", [4])
        gc = _data(layers, "gc", [1], dtype="int32")
        crowd = _data(layers, "crowd", [1], dtype="int32")
        gt = _data(layers, "gt", [4])
        info = _data(layers, "info", [3])
        num = _data(layers, "num", [1], dtype="int32",
                    append_batch_size=False)
        return list(layers.generate_proposal_labels(
            rois, gc, crowd, gt, im_info=info, rpn_rois_num=num,
            batch_size_per_im=16, class_nums=5))
    if name == "generate_mask_labels":
        info = _data(layers, "info", [1, 3], append_batch_size=False)
        gc = _data(layers, "gc", [3, 1], dtype="int32",
                   append_batch_size=False)
        crowd = _data(layers, "crowd", [3, 1], dtype="int32",
                      append_batch_size=False)
        segms = _data(layers, "segms", [3, 2, 6, 2],
                      append_batch_size=False)
        lens = _data(layers, "lens", [3, 2], dtype="int32",
                     append_batch_size=False)
        rois = _data(layers, "rois", [5, 4], append_batch_size=False)
        labels = _data(layers, "labels", [5], dtype="int32",
                       append_batch_size=False)
        return list(layers.generate_mask_labels(
            info, gc, crowd, segms, rois, labels, num_classes=4,
            resolution=6, gt_poly_lens=lens))
    if name == "warpctc":
        x = _data(layers, "x", [8, 6])
        label = _data(layers, "label", [3], dtype="int64")
        in_len = _data(layers, "in_len", [1], dtype="int64")
        lab_len = _data(layers, "lab_len", [1], dtype="int64")
        h = layers.fc(input=x, size=5, num_flatten_dims=2)
        loss = layers.warpctc(h, label, blank=0, norm_by_times=True,
                              input_length=in_len, label_length=lab_len)
        _train(fluid, loss)
        return loss
    if name == "edit_distance":
        hyp = _data(layers, "hyp", [5], dtype="int64")
        ref = _data(layers, "ref", [4], dtype="int64")
        return list(layers.edit_distance(hyp, ref, normalized=False,
                                         ignored_tokens=[0]))
    if name == "similarity_focus":
        x = layers.conv2d(feat, num_filters=3, filter_size=1)
        out = layers.similarity_focus(x, axis=1, indexes=[0, 2])
        _train(fluid, layers.elementwise_mul(out, x))
        return out
    raise AssertionError(name)


DETECTION = list(j_det.__all__)
LAYERS = DETECTION + ["warpctc", "edit_distance", "similarity_focus"]


def _descs(build):
    out = []
    for fluid_mod, prog_cls, guard, unique in FRONT_ENDS:
        main, startup = prog_cls(), prog_cls()
        with unique.guard(), guard(main, startup):
            build(fluid_mod)
        out.append((main.desc.serialize_to_string(),
                    startup.desc.serialize_to_string()))
    return out


@pytest.mark.parametrize("name", LAYERS)
def test_layer_desc_matches_reference(name):
    """Each layer appends the reference's ops, slots, attrs and vars (with
    the shapes inferred at build time), and its startup program the same
    initializers."""
    _align_py_func_registries()
    want, got = _descs(lambda fluid: _program(fluid, name))
    assert got == want


def test_layers_exported_as_in_reference():
    assert len(DETECTION) == 22 and len(LAYERS) == 25
    assert t_det.__all__ == j_det.__all__
    for n in DETECTION:
        assert hasattr(jfluid.layers, n) and hasattr(tfluid.layers, n), n
    for n in ("warpctc", "edit_distance"):
        assert n in j_loss.__all__ and n in t_loss.__all__, n
    assert "similarity_focus" in j_nn.__all__
    assert "similarity_focus" in t_nn.__all__
    assert tfluid.layers.detection is t_det
    assert jfluid.layers.detection is j_det


def test_layers_that_raise_in_the_reference_raise():
    """``ssd_loss`` with another mining type, ``detection_map`` with
    streaming states, ``multiclass_nms`` with every class background
    (at build time, in shape inference's best effort, it only leaves
    the shapes)."""
    for fluid, prog_cls, guard, unique in FRONT_ENDS:
        layers = fluid.layers
        with unique.guard(), guard(prog_cls(), prog_cls()):
            loc = _data(layers, "loc", [4])
            conf = _data(layers, "conf", [3])
            gt = _data(layers, "gt", [4])
            gl = _data(layers, "gl", [1], dtype="int64")
            with pytest.raises(ValueError, match="max_negative"):
                layers.ssd_loss(loc, conf, gt, gl, loc,
                                mining_type="hard_example")
            dets = _data(layers, "dets", [6])
            with pytest.raises(NotImplementedError, match="streaming"):
                layers.detection_map(dets, gt, class_num=3,
                                     input_states=[dets])
