"""Weight-decay regularizers appended as grad-modifying ops.

Port of ``paddle_tpu/regularizer.py`` (reference:
python/paddle/fluid/regularizer.py), unchanged but for its imports. It
works on the desc: ``L2Decay`` appends ``scale`` and ``sum``, ``L1Decay``
also ``sign``, all lowered in ``ops/``.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay", block=block)
        decay = helper.create_variable_for_type_inference(dtype=param.dtype)
        block.append_op(
            type="scale",
            inputs={"X": [param]},
            outputs={"Out": [decay]},
            attrs={"scale": self._coeff},
        )
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay", block=block)
        sign = helper.create_variable_for_type_inference(dtype=param.dtype)
        block.append_op(
            type="sign", inputs={"X": [param]}, outputs={"Out": [sign]}
        )
        decay = helper.create_variable_for_type_inference(dtype=param.dtype)
        block.append_op(
            type="scale",
            inputs={"X": [sign]},
            outputs={"Out": [decay]},
            attrs={"scale": self._coeff},
        )
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """Add decay terms into gradients
    (reference: regularizer.py append_regularization_ops)."""
    out = []
    for param, grad in parameters_and_grads:
        if grad is None:
            out.append((param, grad))
            continue
        regularizer = getattr(param, "regularizer", None) or regularization
        if regularizer is None:
            out.append((param, grad))
            continue
        block = grad.block
        decay = regularizer(param, grad, block)
        helper = LayerHelper("regularized_grad", block=block)
        new_grad = helper.create_variable_for_type_inference(dtype=param.dtype)
        block.append_op(
            type="sum",
            inputs={"X": [grad, decay]},
            outputs={"Out": [new_grad]},
        )
        out.append((param, new_grad))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
