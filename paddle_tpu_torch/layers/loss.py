"""Loss layers — port of ``paddle_tpu/layers/loss.py`` for
``cross_entropy`` (loss.py:21), ``softmax_with_cross_entropy`` (:33),
``square_error_cost`` (:54), ``sigmoid_cross_entropy_with_logits``
(:65), ``log_loss`` (:78), ``huber_loss`` (:90), ``smooth_l1`` (:104),
``kldiv_loss`` (:118), ``hinge_loss`` (:130), and the CTC layers ``warpctc`` (:141)
and ``edit_distance`` (:159)."""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "square_error_cost",
           "sigmoid_cross_entropy_with_logits", "log_loss", "huber_loss",
           "smooth_l1", "kldiv_loss", "hinge_loss", "warpctc",
           "edit_distance"]


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(dtype=logits.dtype)
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={
            "soft_label": soft_label,
            "ignore_index": ignore_index,
            "numeric_stable_mode": numeric_stable_mode,
        },
    )
    if return_softmax:
        return loss, softmax_out
    return loss


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="square_error_cost",
        inputs={"X": [input], "Y": [label]},
        outputs={"Out": [out]},
    )
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]},
        outputs={"Out": [out]},
        attrs={"ignore_index": ignore_index, "normalize": normalize},
    )
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="log_loss",
        inputs={"Predicted": [input], "Labels": [label]},
        outputs={"Loss": [out]},
        attrs={"epsilon": epsilon},
    )
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    residual = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                         stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="huber_loss",
        inputs={"X": [input], "Y": [label]},
        outputs={"Residual": [residual], "Out": [out]},
        attrs={"delta": float(delta)},
    )
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    """The weights are not applied (nor are they in the reference)."""
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="smooth_l1_loss",
        inputs={"X": [x], "Y": [y]},
        outputs={"Diff": [diff], "Out": [out]},
        attrs={"sigma": sigma if sigma is not None else 1.0},
    )
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="kldiv_loss",
        inputs={"X": [x], "Target": [target]},
        outputs={"Loss": [out]},
        attrs={"reduction": reduction},
    )
    return out


def hinge_loss(input, label, name=None):
    helper = LayerHelper("hinge_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="hinge_loss",
        inputs={"Logits": [input], "Labels": [label]},
        outputs={"Loss": [out]},
    )
    return out


def warpctc(input, label, blank=0, norm_by_times=False, use_cudnn=False,
            input_length=None, label_length=None):
    """CTC loss of [B, T, C] unnormalized logits (the batch-major padded
    form of the reference's LoD logits); returns the [B, 1] loss."""
    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference(dtype=input.dtype)
    inputs = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        inputs["LogitsLength"] = [input_length]
    if label_length is not None:
        inputs["LabelLength"] = [label_length]
    helper.append_op(
        type="warpctc", inputs=inputs, outputs={"Loss": [loss]},
        attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance; returns (distance [B, 1], sequence_num
    [1])."""
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_variable_for_type_inference(dtype="float32")
    seq_num = helper.create_variable_for_type_inference(dtype="int64")
    inputs = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        inputs["HypsLength"] = [input_length]
    if label_length is not None:
        inputs["RefsLength"] = [label_length]
    helper.append_op(
        type="edit_distance", inputs=inputs,
        outputs={"Out": [out], "SequenceNum": [seq_num]},
        attrs={"normalized": normalized,
               "ignored_tokens": list(ignored_tokens or [])})
    return out, seq_num
