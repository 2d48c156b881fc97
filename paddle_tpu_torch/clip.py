"""Gradient clipping (reference: python/paddle/fluid/clip.py —
GradientClipByValue, GradientClipByNorm, GradientClipByGlobalNorm,
ErrorClipByValue; set via set_gradient_clip or ParamAttr.gradient_clip).

Port of ``paddle_tpu/clip.py``, unchanged but for its imports. It works on
the desc; the ops it appends (``clip``, ``clip_by_norm``,
``squared_l2_norm``, ``sqrt``, ``elementwise_max``/``div``/``mul``) are
lowered in ``ops/``. With no clip set, nothing is appended.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "ErrorClipByValue",
    "set_gradient_clip",
    "append_gradient_clip_ops",
]

_clip_attr = None


class BaseGradientClipAttr:
    def _process(self, params_grads):
        raise NotImplementedError


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip_one(self, param, grad):
        block = grad.block
        helper = LayerHelper("clip_grad", block=block)
        out = helper.create_variable_for_type_inference(dtype=grad.dtype)
        block.append_op(
            type="clip",
            inputs={"X": [grad]},
            outputs={"Out": [out]},
            attrs={"min": self.min, "max": self.max},
        )
        return out

    def _process(self, params_grads):
        return [
            (p, self._clip_one(p, g) if g is not None else None)
            for p, g in params_grads
        ]


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_one(self, param, grad):
        block = grad.block
        helper = LayerHelper("clip_grad_norm", block=block)
        out = helper.create_variable_for_type_inference(dtype=grad.dtype)
        block.append_op(
            type="clip_by_norm",
            inputs={"X": [grad]},
            outputs={"Out": [out]},
            attrs={"max_norm": self.clip_norm},
        )
        return out

    def _process(self, params_grads):
        return [
            (p, self._clip_one(p, g) if g is not None else None)
            for p, g in params_grads
        ]


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process(self, params_grads):
        live = [(p, g) for p, g in params_grads if g is not None]
        if not live:
            return params_grads
        block = live[0][1].block
        helper = LayerHelper("global_norm_clip", block=block)
        sq_norms = []
        for _, g in live:
            sq = helper.create_variable_for_type_inference(dtype=g.dtype)
            block.append_op(
                type="squared_l2_norm",
                inputs={"X": [g]},
                outputs={"Out": [sq]},
            )
            sq_norms.append(sq)
        total = helper.create_variable_for_type_inference(dtype="float32")
        block.append_op(
            type="sum", inputs={"X": sq_norms}, outputs={"Out": [total]}
        )
        global_norm = helper.create_variable_for_type_inference(dtype="float32")
        block.append_op(
            type="sqrt", inputs={"X": [total]}, outputs={"Out": [global_norm]}
        )
        # scale = clip_norm / max(global_norm, clip_norm)
        clipped = helper.create_variable_for_type_inference(dtype="float32")
        block.append_op(
            type="clip",
            inputs={"X": [global_norm]},
            outputs={"Out": [clipped]},
            attrs={"min": self.clip_norm, "max": 3.4e38},
        )
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            scaled = helper.create_variable_for_type_inference(dtype=g.dtype)
            num = helper.create_variable_for_type_inference(dtype=g.dtype)
            block.append_op(
                type="scale",
                inputs={"X": [g]},
                outputs={"Out": [num]},
                attrs={"scale": self.clip_norm},
            )
            block.append_op(
                type="elementwise_div",
                inputs={"X": [num], "Y": [clipped]},
                outputs={"Out": [scaled]},
                attrs={"axis": -1},
            )
            out.append((p, scaled))
        return out


def set_gradient_clip(clip, param_list=None, program=None):
    global _clip_attr
    _clip_attr = clip
    if param_list is not None:
        for p in param_list:
            if hasattr(p, "gradient_clip_attr"):
                p.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads):
    # Per-param clip attrs take priority; else the global one.
    global_clip = _clip_attr
    per_param = {}
    for p, g in params_grads:
        attr = getattr(p, "gradient_clip_attr", None)
        clip = attr or global_clip
        per_param.setdefault(id(clip), (clip, []))[1].append((p, g))
    out = []
    for clip, pg in per_param.values():
        if clip is None:
            out.extend(pg)
        else:
            out.extend(clip._process(pg))
    return out
