"""LayerHelper (reference: python/paddle/fluid/layer_helper.py) — shared
machinery for layers: parameter creation (with startup-program init ops),
temp-variable creation, op appending, bias/activation tails.

Port of ``paddle_tpu/layer_helper.py``, unchanged but for its imports, so
parameters get the same names (``fc_0.w_0``, ``layer_norm_0.b_0``) and the
same startup init ops in both packages."""

import copy

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.framework import (
    default_main_program,
    default_startup_program,
    Variable,
)
from paddle_tpu_torch.initializer import ConstantInitializer, XavierInitializer
from paddle_tpu_torch.param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type, block=None, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        self._block = block
        if kwargs.get("name") is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return self._block.program if self._block is not None else default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self._block if self._block is not None else self.main_program.current_block()

    def append_op(self, *args, **kwargs):
        return self.block.append_op(*args, **kwargs)

    # -- params ------------------------------------------------------------
    def param_attr_or_default(self, attr, default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            attr = ParamAttr()
        if attr.initializer is None:
            attr.initializer = default_initializer or XavierInitializer()
        return attr

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            attr = ParamAttr()
        else:
            attr = copy.copy(attr)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "w_0" if not is_bias else "b_0"]))
        if attr.initializer is None:
            attr.initializer = (
                ConstantInitializer(0.0)
                if is_bias
                else (default_initializer or XavierInitializer())
            )

        startup_block = self.startup_program.global_block()
        # A shared parameter (same ParamAttr name, e.g. word2vec's
        # "shared_w") is created once per referencing layer; only the
        # first creation appends an init op, or the startup program would
        # initialize the var N times (reference: framework.py
        # Block.create_parameter skips an already-inited param).
        already_inited = any(
            attr.name in op.output_arg_names()
            for op in startup_block.desc.ops
        )
        sv = startup_block.create_var(
            name=attr.name, shape=shape, dtype=dtype, persistable=True
        )
        if not already_inited:
            attr.initializer(sv, startup_block)

        param = self.main_program.global_block().create_parameter(
            name=attr.name,
            shape=shape,
            dtype=dtype,
            trainable=attr.trainable,
            regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
        )
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        return param

    # -- temps -------------------------------------------------------------
    def create_variable_for_type_inference(self, dtype="float32", stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype,
            shape=None,
            stop_gradient=stop_gradient,
        )

    create_tmp_variable = create_variable_for_type_inference

    def create_variable(self, *args, **kwargs):
        return self.block.create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, stop_gradient=True, **kwargs
        )

    def set_variable_initializer(self, var, initializer):
        startup_block = self.startup_program.global_block()
        sv = startup_block.create_var(
            name=var.name,
            shape=var.shape,
            dtype=var.dtype,
            persistable=True,
        )
        initializer(sv, startup_block)

    # -- tails -------------------------------------------------------------
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        bias = self.create_parameter(
            bias_attr if bias_attr not in (None, True) else ParamAttr(),
            shape=size,
            dtype=input_var.dtype,
            is_bias=True,
        )
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [bias]},
            outputs={"Out": [out]},
            attrs={"axis": dim_start},
        )
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = copy.copy(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type=act_type,
            inputs={"X": [input_var]},
            outputs={"Out": [out]},
            attrs=act,
        )
        return out

    def input_dtype(self, input_param_name="input"):
        v = self.kwargs.get(input_param_name)
        if isinstance(v, (list, tuple)):
            v = v[0]
        return v.dtype
