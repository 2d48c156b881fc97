"""Loss layers — port of ``paddle_tpu/layers/loss.py`` for
``softmax_with_cross_entropy`` (loss.py:33)."""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["softmax_with_cross_entropy"]


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
