"""NN layers — port of ``paddle_tpu/layers/nn.py`` (reference:
python/paddle/fluid/layers/nn.py), for the layer functions the BERT,
ResNet, MNIST, Transformer and CTR models need.
Each function appends the same op, slots and attrs as its JAX-package
counterpart (cited beside it), so the two front ends build identical
descs."""

import math

import numpy as np

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.initializer import ConstantInitializer, NormalInitializer
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = [
    "fc",
    "embedding",
    "conv2d",
    "depthwise_conv2d",
    "pool2d",
    "batch_norm",
    "sync_batch_norm",
    "layer_norm",
    "dropout",
    "softmax",
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_max",
    "elementwise_min",
    "elementwise_pow",
    "reshape",
    "transpose",
    "slice",
    "reduce_sum",
    "relu",
    "mean",
    "scale",
    "sum",
    "one_hot",
    "label_smooth",
    "merge_selected_rows",
    "get_tensor_from_selected_rows",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected layer (nn.py:167; reference layers/nn.py:193):
    per-input mul ops, summed, plus bias and activation."""
    helper = LayerHelper("fc", input=input, name=name, act=act,
                         bias_attr=bias_attr)
    dtype = helper.input_dtype()
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = param_attr if isinstance(param_attr, (list, tuple)) else [
        param_attr
    ] * len(inputs)

    mul_results = []
    for inp, pattr in zip(inputs, param_attrs):
        in_features = 1
        for d in inp.shape[num_flatten_dims:]:
            in_features *= d
        w = helper.create_parameter(
            attr=pattr, shape=[in_features, size], dtype=dtype
        )
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="mul",
            inputs={"X": [inp], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)

    if len(mul_results) != 1:
        raise NotImplementedError(
            "fc over several inputs appends a `sum` op, which this port "
            "does not lower yet (ROADMAP Queue 1: the remaining op families)")
    pre_act = helper.append_bias_op(mul_results[0], dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """Embedding lookup (nn.py:208; reference layers/nn.py:302)."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(
        attr=param_attr, shape=size, dtype=dtype, is_bias=False
    )
    out = helper.create_variable_for_type_inference(dtype)
    padding_idx = (
        -1 if padding_idx is None
        else padding_idx if padding_idx >= 0
        else size[0] + padding_idx
    )
    helper.append_op(
        type="lookup_table",
        inputs={"Ids": [input], "W": [w]},
        outputs={"Out": [out]},
        attrs={
            "is_sparse": is_sparse,
            "is_distributed": is_distributed,
            "padding_idx": padding_idx,
        },
    )
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """2-D convolution, NCHW (nn.py:240); the filter's default init is
    N(0, 2 / fan_in)."""
    helper = LayerHelper("conv2d", name=name, act=act, bias_attr=bias_attr)
    dtype = input.dtype
    num_channels = input.shape[1]
    if groups is None:
        groups = 1
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]

    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        attr=param_attr,
        shape=filter_shape,
        dtype=dtype,
        default_initializer=NormalInitializer(0.0, math.sqrt(2.0 / fan_in)),
    )
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={
            "strides": stride,
            "paddings": padding,
            "dilations": dilation,
            "groups": groups,
            "use_cudnn": use_cudnn,
        },
    )
    pre_act = _conv_bias(helper, pre_bias)
    return helper.append_activation(pre_act)


def _conv_bias(helper, pre_bias):
    """(nn.py:290)."""
    bias_attr = helper.kwargs.get("bias_attr")
    if bias_attr is False:
        return pre_bias
    num_filters = pre_bias.shape[1]
    bias = helper.create_parameter(
        bias_attr if bias_attr not in (None, True) else ParamAttr(),
        shape=[num_filters],
        dtype=pre_bias.dtype,
        is_bias=True,
    )
    out = helper.create_variable_for_type_inference(dtype=pre_bias.dtype)
    helper.append_op(
        type="elementwise_add",
        inputs={"X": [pre_bias], "Y": [bias]},
        outputs={"Out": [out]},
        attrs={"axis": 1},
    )
    return out


def depthwise_conv2d(input, num_filters, filter_size, stride=1, padding=0,
                     dilation=1, param_attr=None, bias_attr=None, act=None,
                     name=None):
    """(nn.py:311)."""
    return conv2d(input, num_filters, filter_size, stride, padding, dilation,
                  groups=input.shape[1], param_attr=param_attr,
                  bias_attr=bias_attr, act=act, name=name)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    """(nn.py:353)."""
    helper = LayerHelper("pool2d", name=name)
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    if isinstance(pool_stride, int):
        pool_stride = [pool_stride, pool_stride]
    if isinstance(pool_padding, int):
        pool_padding = [pool_padding, pool_padding]
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": pool_size,
            "strides": pool_stride,
            "paddings": pool_padding,
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        },
    )
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               fuse_with_relu=False, use_global_stats=False):
    """Batch normalization (nn.py:381) with persistable moving mean and
    variance, which the op itself updates: ``MeanOut`` and
    ``VarianceOut`` are the same variables as ``Mean`` and
    ``Variance``."""
    return _batch_norm_layer(
        "batch_norm", input, act=act, is_test=is_test, momentum=momentum,
        epsilon=epsilon, param_attr=param_attr, bias_attr=bias_attr,
        data_layout=data_layout, name=name,
        moving_mean_name=moving_mean_name,
        moving_variance_name=moving_variance_name,
        use_global_stats=use_global_stats)


def sync_batch_norm(input, act=None, is_test=False, momentum=0.9,
                    epsilon=1e-5, param_attr=None, bias_attr=None,
                    data_layout="NCHW", name=None, moving_mean_name=None,
                    moving_variance_name=None, use_global_stats=False):
    """Cross-device batch normalization (nn.py:397); on one device it
    lowers as ``batch_norm``."""
    return _batch_norm_layer(
        "sync_batch_norm", input, act=act, is_test=is_test,
        momentum=momentum, epsilon=epsilon, param_attr=param_attr,
        bias_attr=bias_attr, data_layout=data_layout, name=name,
        moving_mean_name=moving_mean_name,
        moving_variance_name=moving_variance_name,
        use_global_stats=use_global_stats)


def _batch_norm_layer(op_type, input, act=None, is_test=False, momentum=0.9,
                      epsilon=1e-5, param_attr=None, bias_attr=None,
                      data_layout="NCHW", name=None, moving_mean_name=None,
                      moving_variance_name=None, use_global_stats=False):
    """(nn.py:416)."""
    helper = LayerHelper(op_type, name=name, act=act)
    dtype = input.dtype
    if data_layout == "NCHW":
        channel_num = input.shape[1]
    else:
        channel_num = input.shape[-1]
    param_shape = [channel_num]

    scale = helper.create_parameter(
        attr=param_attr, shape=param_shape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0),
    )
    bias = helper.create_parameter(
        attr=bias_attr, shape=param_shape, dtype=dtype, is_bias=True,
    )
    mean = helper.create_global_variable(
        name=moving_mean_name or unique_name.generate(helper.name + ".mean"),
        shape=param_shape, dtype=dtype, persistable=True,
    )
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    variance = helper.create_global_variable(
        name=moving_variance_name or unique_name.generate(
            helper.name + ".var"),
        shape=param_shape, dtype=dtype, persistable=True,
    )
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))

    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_variance = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)

    helper.append_op(
        type=op_type,
        inputs={
            "X": [input],
            "Scale": [scale],
            "Bias": [bias],
            "Mean": [mean],
            "Variance": [variance],
        },
        outputs={
            "Y": [out],
            "MeanOut": [mean],
            "VarianceOut": [variance],
            "SavedMean": [saved_mean],
            "SavedVariance": [saved_variance],
        },
        attrs={
            "momentum": momentum,
            "epsilon": epsilon,
            "is_test": is_test,
            "data_layout": data_layout,
            "use_global_stats": use_global_stats,
        },
    )
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """(nn.py:480)."""
    helper = LayerHelper("layer_norm", name=name, act=act)
    dtype = input.dtype
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            attr=param_attr, shape=norm_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0),
        )
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(
            attr=bias_attr, shape=norm_shape, dtype=dtype, is_bias=True
        )
        inputs["Bias"] = [b]
    mean_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """(nn.py:540)."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed if seed is not None else 0,
            "dropout_implementation": dropout_implementation,
        },
    )
    return out


def softmax(input, use_cudnn=True, name=None, axis=-1):
    """(nn.py:560)."""
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="softmax",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return out


def _elementwise_layer(op_type):
    """(nn.py:612)."""

    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(
            type=op_type,
            inputs={"X": [x], "Y": [y]},
            outputs={"Out": [out]},
            attrs={"axis": axis},
        )
        return helper.append_activation(out)

    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise_layer("elementwise_add")
elementwise_sub = _elementwise_layer("elementwise_sub")
elementwise_mul = _elementwise_layer("elementwise_mul")
elementwise_div = _elementwise_layer("elementwise_div")
elementwise_max = _elementwise_layer("elementwise_max")
elementwise_min = _elementwise_layer("elementwise_min")
elementwise_pow = _elementwise_layer("elementwise_pow")


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    """(nn.py:637)."""
    helper = LayerHelper("reshape2", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    helper.append_op(
        type="reshape2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"shape": list(shape)},
    )
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    """(nn.py:651)."""
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    helper.append_op(
        type="transpose2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"axis": list(perm)},
    )
    return out


def slice(input, axes, starts, ends):
    """(nn.py:759)."""
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="slice",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    """(nn.py:794 ``_reduce_layer``)."""
    helper = LayerHelper("reduce_sum", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    if dim is None:
        dim_attr, reduce_all = [0], True
    else:
        dim_attr = dim if isinstance(dim, (list, tuple)) else [dim]
        reduce_all = False
    helper.append_op(
        type="reduce_sum",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"dim": list(dim_attr), "keep_dim": keep_dim,
               "reduce_all": reduce_all},
    )
    return out


def relu(x, name=None):
    """(nn.py:917)."""
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def mean(x, name=None):
    """(nn.py:1032)."""
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    """(nn.py:1048)."""
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="scale",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={
            "scale": float(scale),
            "bias": float(bias),
            "bias_after_scale": bias_after_scale,
        },
    )
    return helper.append_activation(out)


def sum(x):
    """(nn.py:1064)."""
    helper = LayerHelper("sum")
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype)
    helper.append_op(type="sum", inputs={"X": x}, outputs={"Out": [out]})
    return out


def one_hot(input, depth):
    """(nn.py:837)."""
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type="one_hot",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"depth": depth},
    )
    out.stop_gradient = True
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    """(nn.py:864)."""
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="label_smooth",
        inputs={"X": [label]},
        outputs={"Out": [out]},
        attrs={"epsilon": float(epsilon)},
    )
    return out


def merge_selected_rows(x, name=None):
    """(nn.py:2238) The identity: a sparse grad is merged inside the
    lowerings that need unique rows (``core/selected_rows.py``)."""
    return x


def get_tensor_from_selected_rows(x, name=None):
    """(nn.py:2245) The identity: whatever a run fetches is already
    dense (``engine/lowering.py``)."""
    return x


def fused_attention(q, k, v, causal=False, scale=None, seq_lens=None,
                    dropout_rate=0.0, name=None, sequence_parallel=False,
                    sp_axis="sp", sp_batch_axis=None):
    """Whole-attention fusion over [B, H, T, D] inputs (nn.py:2430): the
    hand-written CUDA flash-attention kernel on the card, its plain torch
    version on the CPU. ``seq_lens`` ([B] or [B, 1] int) masks keys past
    each sequence's length; ``causal`` is a static flag; ``dropout_rate``
    is attention-weight dropout executed inside the kernel. Kept out of
    ``__all__`` as in the JAX package; models reach it via this module."""
    if sequence_parallel:
        raise NotImplementedError(
            "sequence_parallel attention (ring attention) is not ported "
            "yet (ROADMAP Queue 1: multi-GPU, the sequence axis)")
    helper = LayerHelper("fused_attention", name=name)
    out = helper.create_variable_for_type_inference(dtype=q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    outputs = {"Out": [out]}
    if seq_lens is not None:
        inputs["SeqLens"] = [seq_lens]
    attrs = {"causal": bool(causal), "dropout_rate": float(dropout_rate)}
    # softmax residual (per-row logsumexp) the backward kernels read
    outputs["Lse"] = [
        helper.create_variable_for_type_inference(dtype="float32")]
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op(type="fused_attention", inputs=inputs,
                     outputs=outputs, attrs=attrs)
    return out
