"""Metric layers — port of ``paddle_tpu/layers/metric_op.py`` for
``accuracy`` (:7) and ``auc`` (:39)."""

from paddle_tpu_torch.initializer import ConstantInitializer
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy: appends ``top_k`` then ``accuracy``; returns the
    float32 [1] accuracy."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    topk_indices = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(
        type="top_k",
        inputs={"X": [input]},
        outputs={"Out": [topk_out], "Indices": [topk_indices]},
        attrs={"k": k},
    )
    acc_out = helper.create_variable_for_type_inference(dtype="float32")
    if correct is None:
        correct = helper.create_variable_for_type_inference(dtype="int32")
    if total is None:
        total = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(
        type="accuracy",
        inputs={
            "Out": [topk_out],
            "Indices": [topk_indices],
            "Label": [label],
        },
        outputs={
            "Accuracy": [acc_out],
            "Correct": [correct],
            "Total": [total],
        },
    )
    acc_out.stop_gradient = True
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming AUC over ``input`` [N, 2] (the second column the positive
    probability): two persistable int64 histograms of ``num_thresholds +
    1`` buckets, ``<name>.stat_pos`` and ``<name>.stat_neg``, zeroed by the
    startup program and written back by the op under the same names.
    Returns (the float32 AUC, [stat_pos, stat_neg])."""
    helper = LayerHelper("auc")
    stats = []
    for tag in ("stat_pos", "stat_neg"):
        stat = helper.create_global_variable(
            persistable=True, name=helper.name + "." + tag,
            shape=[num_thresholds + 1], dtype="int64")
        helper.set_variable_initializer(stat, ConstantInitializer(0))
        stats.append(stat)
    stat_pos, stat_neg = stats
    auc_out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds},
    )
    auc_out.stop_gradient = True
    return auc_out, [stat_pos, stat_neg]
