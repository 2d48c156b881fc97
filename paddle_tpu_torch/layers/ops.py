"""Generated unary activation layers — port of
``paddle_tpu/layers/ops.py`` (reference: python/paddle/fluid/layers/ops.py
via layer_function_generator.py): the 30 layers of ``_UNARY_OPS``, each
appending its op with ``X``/``Out``, the parameterised ones with the
explicit signature of ``_UNARY_ATTRS``, and ``uniform_random``."""

import inspect

from paddle_tpu_torch.core.types import convert_np_dtype_to_dtype_
from paddle_tpu_torch.layer_helper import LayerHelper

_UNARY_OPS = [
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "softshrink",
    "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin", "round",
    "reciprocal", "square", "softplus", "softsign", "hard_sigmoid",
    "swish", "relu6", "elu", "gelu", "brelu", "soft_relu", "hard_shrink",
    "thresholded_relu", "stanh", "sign", "log",
]

__all__ = list(_UNARY_OPS) + ["uniform_random"]

# Attr names and reference defaults of the parameterised activations
# (reference: the op makers in paddle/fluid/operators/activation_op.cc).
_UNARY_ATTRS = {
    "elu": (("alpha", 1.0),),
    "relu6": (("threshold", 6.0),),
    "stanh": (("scale_a", 2.0 / 3.0), ("scale_b", 1.7159)),
    "hard_sigmoid": (("slope", 0.2), ("offset", 0.5)),
    "swish": (("beta", 1.0),),
    "brelu": (("t_min", 0.0), ("t_max", 24.0)),
    "soft_relu": (("threshold", 40.0),),
    "hard_shrink": (("threshold", 0.5),),
    "thresholded_relu": (("threshold", 1.0),),
}


def _append(op_type, x, name, attrs):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def _make_unary(op_type):
    attr_spec = _UNARY_ATTRS.get(op_type)
    if attr_spec is None:
        def layer(x, name=None, **kwargs):
            return _append(op_type, x, name, kwargs)

        layer.__name__ = op_type
        return layer

    P = inspect.Parameter
    sig = inspect.Signature(
        [P("x", P.POSITIONAL_OR_KEYWORD)]
        + [P(k, P.POSITIONAL_OR_KEYWORD, default=v) for k, v in attr_spec]
        + [P("name", P.POSITIONAL_OR_KEYWORD, default=None)])

    def layer(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        x = bound.arguments.pop("x")
        name = bound.arguments.pop("name")
        return _append(op_type, x, name, dict(bound.arguments))

    layer.__name__ = op_type
    layer.__signature__ = sig
    return layer


for _op in _UNARY_OPS:
    globals()[_op] = _make_unary(_op)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="uniform_random",
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "dtype": int(convert_np_dtype_to_dtype_(dtype)),
            "min": float(min),
            "max": float(max),
            "seed": seed,
        },
    )
    return out
