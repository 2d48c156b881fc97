"""NN layers — port of ``paddle_tpu/layers/nn.py`` (reference:
python/paddle/fluid/layers/nn.py), for the layer functions the BERT,
ResNet, MNIST, Transformer, CTR, LSTM and image models need, the
compare and logical layers of the control-flow programs, and the
recurrent layers (``dynamic_lstm``, ``dynamic_gru``, ``dynamic_lstmp``,
``lstm``), the layers of the book programs (``matmul``, the reduce
family, ``unsqueeze``, ``expand``...), the unfused attention's mask
(``attention_bias_from_lens``), and the dense families' layers: the
image layers (``conv2d_transpose``, ``group_norm``, ``lrn``, ``prelu``,
``maxout``, the resizes, ``adaptive_pool2d``), the tensor layers
(``squeeze``, ``stack``, ``gather``, ``scatter``, ``pad``, ``cumsum``,
``shape``, ``flatten``...), ``dot_product_attention`` and
``chunk_eval``; the sequence and beam-search slice's: the
``sequence_*`` layers, ``im2sequence``, ``beam_search``,
``beam_search_decode``, the CRF (``linear_chain_crf``, ``crf_decoding``),
the step cells (``lstm_unit``, ``gru_unit``), ``row_conv`` and
``tensor_array_to_tensor``; and the misc family's (nn.py:1497-2524):
the losses (``rank_loss``, ``bpr_loss``, ``dice_loss``...), the 3-D
layers (``conv3d``, ``conv3d_transpose``, ``pool3d``,
``adaptive_pool3d``), the sampled heads (``nce``, ``hsigmoid``), the
samplers (``grid_sampler``, ``affine_grid``, ``psroi_pool``,
``tree_conv``), the random layers, ``Print``, ``py_func`` and ``load``.
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
    "log_softmax",
    "matmul",
    "mul",
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_max",
    "elementwise_min",
    "elementwise_pow",
    "reshape",
    "transpose",
    "unsqueeze",
    "expand",
    "slice",
    "reduce_sum",
    "reduce_mean",
    "reduce_max",
    "reduce_min",
    "reduce_prod",
    "topk",
    "leaky_relu",
    "clip",
    "clip_by_norm",
    "sequence_mask",
    "gaussian_random",
    "pow",
    "autoincreased_step_counter",
    "relu",
    "mean",
    "scale",
    "sum",
    "one_hot",
    "label_smooth",
    "merge_selected_rows",
    "get_tensor_from_selected_rows",
    "split",
    "equal",
    "not_equal",
    "less_than",
    "less_equal",
    "greater_than",
    "greater_equal",
    "logical_and",
    "logical_or",
    "logical_xor",
    "logical_not",
    "where",
    "dynamic_lstm",
    "dynamic_gru",
    "dynamic_lstmp",
    "lstm",
    "sequence_pool",
    "sequence_last_step",
    "conv2d_transpose",
    "group_norm",
    "squeeze",
    "stack",
    "unstack",
    "gather",
    "scatter",
    "l2_normalize",
    "pad",
    "pad2d",
    "lrn",
    "prelu",
    "maxout",
    "image_resize",
    "resize_bilinear",
    "resize_nearest",
    "shape",
    "cumsum",
    "dot_product_attention",
    "flatten",
    "adaptive_pool2d",
    "image_resize_short",
    "create_parameter",
    "chunk_eval",
    "sequence_softmax",
    "sequence_expand",
    "sequence_reverse",
    "sequence_concat",
    "sequence_slice",
    "sequence_first_step",
    "sequence_expand_as",
    "sequence_pad",
    "sequence_unpad",
    "sequence_conv",
    "sequence_enumerate",
    "beam_search",
    "beam_search_decode",
    "row_conv",
    "lstm_unit",
    "gru_unit",
    "linear_chain_crf",
    "crf_decoding",
    "sequence_reshape",
    "sequence_scatter",
    "im2sequence",
    "tensor_array_to_tensor",
    "Print",
    "adaptive_pool3d",
    "add_position_encoding",
    "affine_channel",
    "affine_grid",
    "bilinear_tensor_product",
    "bpr_loss",
    "conv3d",
    "conv3d_transpose",
    "cos_sim",
    "crop",
    "ctc_greedy_decoder",
    "data_norm",
    "dice_loss",
    "gaussian_random_batch_size_like",
    "grid_sampler",
    "has_inf",
    "has_nan",
    "hash",
    "hsigmoid",
    "is_empty",
    "isfinite",
    "load",
    "lod_reset",
    "margin_rank_loss",
    "mean_iou",
    "multiplex",
    "nce",
    "pad_constant_like",
    "pool3d",
    "psroi_pool",
    "py_func",
    "random_crop",
    "rank_loss",
    "reorder_lod_tensor_by_rank",
    "sampling_id",
    "selu",
    "shuffle_channel",
    "space_to_depth",
    "teacher_student_sigmoid_loss",
    "tree_conv",
    "uniform_random_batch_size_like",
    "similarity_focus",
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

    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="sum", inputs={"X": mul_results}, outputs={"Out": [pre_bias]}
        )
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
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


def log_softmax(input, axis=-1, name=None):
    """(nn.py:572)."""
    helper = LayerHelper("log_softmax", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="log_softmax",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    """(nn.py:584)."""
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="matmul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={
            "transpose_X": transpose_x,
            "transpose_Y": transpose_y,
            "alpha": float(alpha),
        },
    )
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """(nn.py:600)."""
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="mul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"x_num_col_dims": x_num_col_dims,
               "y_num_col_dims": y_num_col_dims},
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


def _reduce_layer(op_type):
    """(nn.py:794)."""
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=input.dtype)
        if dim is None:
            dim_attr, reduce_all = [0], True
        else:
            dim_attr = dim if isinstance(dim, (list, tuple)) else [dim]
            reduce_all = False
        helper.append_op(
            type=op_type,
            inputs={"X": [input]},
            outputs={"Out": [out]},
            attrs={"dim": list(dim_attr), "keep_dim": keep_dim,
                   "reduce_all": reduce_all},
        )
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")


def unsqueeze(input, axes, name=None):
    """(nn.py:703)."""
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                       stop_gradient=True)
    helper.append_op(
        type="unsqueeze2",
        inputs={"X": [input]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"axes": axes},
    )
    return out


def expand(x, expand_times, name=None):
    """(nn.py:747)."""
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="expand",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"expand_times": list(expand_times)},
    )
    return out


def topk(input, k, name=None):
    """(nn.py:823)."""
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(dtype=input.dtype)
    indices = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(
        type="top_k",
        inputs={"X": [input]},
        outputs={"Out": [values], "Indices": [indices]},
        attrs={"k": k},
    )
    indices.stop_gradient = True
    return values, indices


def relu(x, name=None):
    """(nn.py:917)."""
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def leaky_relu(x, alpha=0.02, name=None):
    """(nn.py:946)."""
    helper = LayerHelper("leaky_relu", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="leaky_relu",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"alpha": alpha},
    )
    return out


def clip(x, min, max, name=None):
    """(nn.py:1008)."""
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="clip",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"min": float(min), "max": float(max)},
    )
    return out


def clip_by_norm(x, max_norm, name=None):
    """(nn.py:1020)."""
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="clip_by_norm",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"max_norm": float(max_norm)},
    )
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


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
        n_out = num
    else:
        num = 0
        sections = list(num_or_sections)
        n_out = len(sections)
    outs = [
        helper.create_variable_for_type_inference(dtype=input.dtype)
        for _ in range(n_out)
    ]
    helper.append_op(
        type="split",
        inputs={"X": [input]},
        outputs={"Out": outs},
        attrs={"axis": dim, "num": num, "sections": sections},
    )
    return outs


def _cmp_layer(op_type):
    def layer(x, y, force_cpu=None, cond=None):
        del force_cpu  # a placement knob; the op runs where its inputs are
        helper = LayerHelper(op_type)
        if cond is None:
            cond = helper.create_variable_for_type_inference(dtype="bool")
        cond.stop_gradient = True
        helper.append_op(
            type=op_type,
            inputs={"X": [x], "Y": [y]},
            outputs={"Out": [cond]},
        )
        return cond

    layer.__name__ = op_type
    return layer


equal = _cmp_layer("equal")
not_equal = _cmp_layer("not_equal")
less_than = _cmp_layer("less_than")
less_equal = _cmp_layer("less_equal")
greater_than = _cmp_layer("greater_than")
greater_equal = _cmp_layer("greater_equal")


def _logical_layer(op_type, unary=False):
    def layer(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, name=name)
        if out is None:
            out = helper.create_variable_for_type_inference(dtype="bool")
        inputs = {"X": [x]}
        if not unary:
            inputs["Y"] = [y]
        helper.append_op(type=op_type, inputs=inputs,
                         outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    return layer


logical_and = _logical_layer("logical_and")
logical_or = _logical_layer("logical_or")
logical_xor = _logical_layer("logical_xor")
logical_not = _logical_layer("logical_not", unary=True)


def where(condition, x, y):
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="where",
        inputs={"Condition": [condition], "X": [x], "Y": [y]},
        outputs={"Out": [out]},
    )
    return out


def dynamic_lstm(input, size, h_0=None, c_0=None, seq_len=None,
                 param_attr=None, bias_attr=None, use_peepholes=False,
                 is_reverse=False, gate_activation="sigmoid",
                 cell_activation="tanh", candidate_activation="tanh",
                 dtype="float32", name=None):
    """LSTM over a padded [B, T, 4H] pre-projected input (reference:
    layers/nn.py:370 — the LoD-batched form becomes padded+masked via
    ``seq_len``). Returns (hidden [B,T,H], cell [B,T,H])."""
    helper = LayerHelper("dynamic_lstm", name=name, param_attr=param_attr,
                         bias_attr=bias_attr)
    hidden_size = size // 4
    weight = helper.create_parameter(
        attr=param_attr, shape=[hidden_size, 4 * hidden_size], dtype=dtype)
    n_bias = 7 * hidden_size if use_peepholes else 4 * hidden_size
    bias = helper.create_parameter(
        attr=bias_attr if bias_attr not in (None, True) else None,
        shape=[1, n_bias], dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(
        type="dynamic_lstm",
        inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell]},
        attrs={
            "use_peepholes": use_peepholes,
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
        },
    )
    return hidden, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False,
                seq_len=None, dtype="float32", name=None):
    """GRU over a padded [B, T, 3H] pre-projected input (reference:
    layers/nn.py dynamic_gru). Returns hidden [B, T, H]."""
    helper = LayerHelper("dynamic_gru", name=name, param_attr=param_attr,
                         bias_attr=bias_attr)
    weight = helper.create_parameter(
        attr=param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(
        attr=bias_attr if bias_attr not in (None, True) else None,
        shape=[1, 3 * size], dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(
        type="dynamic_gru",
        inputs=inputs,
        outputs={"Hidden": [hidden]},
        attrs={
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "activation": candidate_activation,
            "origin_mode": origin_mode,
        },
    )
    return hidden


def dynamic_lstmp(input, size, proj_size, h_0=None, c_0=None, seq_len=None,
                  param_attr=None, bias_attr=None, use_peepholes=False,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", dtype="float32", name=None):
    """LSTM with a recurrent projection (reference: layers/nn.py
    dynamic_lstmp → lstmp_op.cc): hidden H projected to P before the
    recurrence. Built as dynamic_lstm + a learned projection applied to
    the hidden sequence (the projected state feeds forward, matching the
    reference's output contract; the recurrent path uses H)."""
    hidden, cell = dynamic_lstm(
        input, size, h_0=h_0, c_0=c_0, seq_len=seq_len,
        param_attr=param_attr, bias_attr=bias_attr,
        use_peepholes=use_peepholes, is_reverse=is_reverse,
        gate_activation=gate_activation, cell_activation=cell_activation,
        candidate_activation=candidate_activation, dtype=dtype, name=name)
    proj = fc(input=hidden, size=proj_size, num_flatten_dims=2,
              bias_attr=False, act=proj_activation)
    return proj, cell


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """Multi-layer (optionally bidirectional) LSTM (reference:
    layers/nn.py lstm → cudnn_lstm_op; here stacked dynamic_lstm scans).
    Returns (output, last_h, last_c) like the reference."""
    x = input
    for layer in range(num_layers):
        fw_in = fc(input=x, size=4 * hidden_size, num_flatten_dims=2,
                   bias_attr=False)
        # initial states apply to the first layer (the reference threads
        # per-layer init states; one shared pair covers the common case)
        h0 = init_h if layer == 0 else None
        c0 = init_c if layer == 0 else None
        fw, fc_state = dynamic_lstm(fw_in, 4 * hidden_size, h_0=h0,
                                    c_0=c0)
        if is_bidirec:
            bw_in = fc(input=x, size=4 * hidden_size, num_flatten_dims=2,
                       bias_attr=False)
            bw, _ = dynamic_lstm(bw_in, 4 * hidden_size, is_reverse=True)
            x = _concat_last(fw, bw)
        else:
            x = fw
        if dropout_prob and not is_test:
            x = dropout(x, dropout_prob)
    last_h = sequence_last_step(x)
    last_c = sequence_last_step(fc_state)
    return x, last_h, last_c


def _concat_last(a, b):
    helper = LayerHelper("concat")
    out = helper.create_variable_for_type_inference(a.dtype)
    helper.append_op(type="concat", inputs={"X": [a, b]},
                     outputs={"Out": [out]}, attrs={"axis": 2})
    return out


def sequence_pool(input, pool_type, is_test=False, length=None):
    # ``is_test`` only gates the reference kernel's MaxIndex scratch
    # output (sequence_pool_op.cc); the functional lowering derives the
    # backward from the forward, so it needs no flag
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    inputs = {"X": [input]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="sequence_pool",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={"pooltype": pool_type.upper()},
    )
    return out


def sequence_last_step(input, length=None):
    """Last valid timestep of each sequence (reference: layers/nn.py
    sequence_last_step = sequence_pool LAST)."""
    return sequence_pool(input, "last", length=length)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """(nn.py:1132) The op's output is float32 whatever ``dtype`` says,
    as in the JAX package."""
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type="sequence_mask",
        inputs={"X": [x]},
        outputs={"Y": [out]},
        attrs={"maxlen": maxlen if maxlen is not None else -1},
    )
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    """(nn.py:1806)."""
    from paddle_tpu_torch.core.types import convert_np_dtype_to_dtype_

    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "mean": mean,
                            "std": std, "seed": seed,
                            "dtype": int(convert_np_dtype_to_dtype_(dtype))})
    out.stop_gradient = True
    return out


def pow(x, factor=1.0, name=None):
    """(nn.py:2111)."""
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pow", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"factor": factor})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """(nn.py:2158) A persistable int64 counter, incremented once a run
    of the program."""
    helper = LayerHelper("global_step_counter")
    counter = helper.block.program.global_block().create_var(
        name=counter_name or "@STEP_COUNTER@",
        dtype="int64", shape=[1], persistable=True)
    helper.block.program.global_block().vars[counter.name].desc.attrs[
        "init_value"] = float(begin - step)
    helper.append_op(
        type="increment", inputs={"X": [counter.name]},
        outputs={"Out": [counter.name]}, attrs={"step": float(step)})
    counter.stop_gradient = True
    return counter


# Additive mask magnitude: large enough that softmax zeroes the masked
# keys in every float dtype, small enough not to overflow float16
# (nn.py:2475).
_ATTN_MASK_BIG = 1e9


def attention_bias_from_lens(seq_lens, max_len, name=None):
    """(nn.py:2478) Additive key-padding bias [B, 1, 1, max_len] from a
    lengths vector: 0 for valid keys, -1e9 past each sequence's length.
    The unfused attention's mask, built from exactly the ops
    (sequence_mask -> scale -> reshape2) that the fuse-attention pass
    (``analysis/transforms.py``) recognizes, so the lengths become the
    fused op's ``SeqLens`` when the rewrite fires. Every intermediate is
    stop_gradient: the mask is data."""
    mask = sequence_mask(seq_lens, maxlen=int(max_len))  # [B, T] of 0/1
    mask.stop_gradient = True
    bias = scale(mask, scale=_ATTN_MASK_BIG, bias=-_ATTN_MASK_BIG,
                 name=name)  # 1 -> 0, 0 -> -BIG
    bias.stop_gradient = True
    bias = reshape(bias, shape=[-1, 1, 1, int(max_len)])
    bias.stop_gradient = True
    return bias


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """(nn.py:319) Transposed 2-D convolution, NCHW, filter IOHW [C_in,
    num_filters / groups, kh, kw]."""
    helper = LayerHelper("conv2d_transpose", name=name, act=act,
                         bias_attr=bias_attr)
    dtype = input.dtype
    num_channels = input.shape[1]
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    filter_shape = [num_channels, num_filters // (groups or 1)] + list(
        filter_size)
    w = helper.create_parameter(attr=param_attr, shape=filter_shape,
                                dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={
            "strides": stride,
            "paddings": padding,
            "dilations": dilation,
            "groups": groups or 1,
        },
    )
    pre_act = _conv_bias(helper, pre_bias)
    return helper.append_activation(pre_act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    """(nn.py:511) Scale initialised to 1, bias to 0; ``False`` drops
    either."""
    helper = LayerHelper("group_norm", name=name, act=act)
    dtype = input.dtype
    channel_num = input.shape[1]
    inputs = {"X": [input]}
    if param_attr is not False:
        inputs["Scale"] = [helper.create_parameter(
            attr=param_attr, shape=[channel_num], dtype=dtype,
            default_initializer=ConstantInitializer(1.0))]
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=bias_attr, shape=[channel_num], dtype=dtype, is_bias=True)]
    mean_out = helper.create_variable_for_type_inference(dtype,
                                                         stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(dtype,
                                                        stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="group_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"groups": groups, "epsilon": epsilon},
    )
    return helper.append_activation(out)


def squeeze(input, axes, name=None):
    """(nn.py:689)."""
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                       stop_gradient=True)
    helper.append_op(
        type="squeeze2",
        inputs={"X": [input]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"axes": axes},
    )
    return out


def stack(x, axis=0):
    """(nn.py:717)."""
    helper = LayerHelper("stack")
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    """(nn.py:730)."""
    helper = LayerHelper("unstack")
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(dtype=x.dtype)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]},
                     outputs={"Y": outs}, attrs={"axis": axis, "num": num})
    return outs


def gather(input, index):
    """(nn.py:771)."""
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="gather",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    """(nn.py:782)."""
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]},
        attrs={"overwrite": overwrite},
    )
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """(nn.py:850)."""
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    norm = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     stop_gradient=True)
    helper.append_op(
        type="l2_normalize",
        inputs={"X": [x]},
        outputs={"Out": [out], "Norm": [norm]},
        attrs={"axis": axis, "epsilon": epsilon},
    )
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    """(nn.py:877)."""
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="pad",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"paddings": list(paddings), "pad_value": float(pad_value)},
    )
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    """(nn.py:889)."""
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="pad2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"paddings": list(paddings), "mode": mode,
               "pad_value": float(pad_value)},
    )
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """(nn.py:903)."""
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    mid = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                    stop_gradient=True)
    helper.append_op(
        type="lrn",
        inputs={"X": [input]},
        outputs={"Out": [out], "MidOut": [mid]},
        attrs={"n": n, "k": k, "alpha": alpha, "beta": beta},
    )
    return out


def prelu(x, mode, param_attr=None, name=None):
    """(nn.py:924) ``alpha`` initialised to 0.25: [1] (``all``), [1, C, 1,
    1] (``channel``) or [1] + the sample's shape (``element``)."""
    helper = LayerHelper("prelu", name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [1, x.shape[1], 1, 1]
    else:
        alpha_shape = [1] + list(x.shape[1:])
    alpha = helper.create_parameter(
        attr=param_attr, shape=alpha_shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25),
    )
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="prelu",
        inputs={"X": [x], "Alpha": [alpha]},
        outputs={"Out": [out]},
        attrs={"mode": mode},
    )
    return out


def maxout(x, groups, name=None):
    """(nn.py:958)."""
    helper = LayerHelper("maxout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="maxout", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"groups": groups})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None, align_corners=True,
                 align_mode=1):
    """(nn.py:970) ``bilinear_interp`` or ``nearest_interp`` to
    ``out_shape``, else the input's size times ``scale``. A shape fed at
    run time (``actual_shape``) raises: the output's shape is fixed when
    the program is built."""
    if actual_shape is not None:
        raise NotImplementedError(
            "image_resize: actual_shape (an output shape fed at run time) "
            "is not supported; pass out_shape or scale")
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale), int(input.shape[3] * scale)]
    op_type = "bilinear_interp" if resample == "BILINEAR" else "nearest_interp"
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type=op_type,
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"out_h": int(out_shape[0]), "out_w": int(out_shape[1]),
               "align_corners": bool(align_corners),
               "align_mode": int(align_mode)},
    )
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None, align_corners=True, align_mode=1):
    """(nn.py:993)."""
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        actual_shape=actual_shape,
                        align_corners=align_corners, align_mode=align_mode)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None, align_corners=True):
    """(nn.py:1001)."""
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        actual_shape=actual_shape,
                        align_corners=align_corners)


def shape(input):
    """(nn.py:1039) The input's shape, int32."""
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def cumsum(x, axis=None, exclusive=None, reverse=None):
    """(nn.py:1072) Only the attrs given are set."""
    helper = LayerHelper("cumsum")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    attrs = {}
    if axis is not None:
        attrs["axis"] = axis
    if exclusive is not None:
        attrs["exclusive"] = exclusive
    if reverse is not None:
        attrs["reverse"] = reverse
    helper.append_op(type="cumsum", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def dot_product_attention(querys, keys, values):
    """(nn.py:1275) Scaled dot-product attention from ``matmul`` and
    ``softmax``; returns (context, weights)."""
    product = matmul(querys, keys, transpose_y=True,
                     alpha=1.0 / math.sqrt(querys.shape[-1]))
    weights = softmax(product)
    return matmul(weights, values), weights


def flatten(x, axis=1, name=None):
    """(nn.py:1484) [-1, product of the dims from ``axis``]; those dims
    must be known when the program is built."""
    trail = 1
    for d in x.shape[axis:]:
        if d is None or d < 0:
            raise ValueError(
                "flatten needs static dims after axis=%d; got shape %s"
                % (axis, (x.shape,)))
        trail *= d
    return reshape(x, shape=[-1, trail], name=name)


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """(nn.py:1933) A ``pool2d`` whose window and stride tile the input
    into ``pool_size``; the output size must divide the input's."""
    h, w = input.shape[2], input.shape[3]
    oh, ow = ((pool_size, pool_size) if isinstance(pool_size, int)
              else pool_size)
    if h % oh or w % ow:
        raise ValueError(
            "adaptive_pool2d needs output size dividing the input "
            "spatial dims (%dx%d -> %dx%d)" % (h, w, oh, ow))
    return pool2d(input, pool_size=[h // oh, w // ow], pool_type=pool_type,
                  pool_stride=[h // oh, w // ow], name=name)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """(nn.py:1948) Resized so that the short side is ``out_short_len``."""
    h, w = input.shape[2], input.shape[3]
    short = min(h, w)
    out_shape = [int(h * out_short_len / short),
                 int(w * out_short_len / short)]
    return image_resize(input, out_shape=out_shape, resample=resample)


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """(nn.py:2174)."""
    helper = LayerHelper("create_parameter")
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias=is_bias,
                                   default_initializer=default_initializer)


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """(nn.py:2329) Returns (precision, recall, f1, num_infer_chunks,
    num_label_chunks, num_correct_chunks)."""
    helper = LayerHelper("chunk_eval")
    precision = helper.create_variable_for_type_inference("float32")
    recall = helper.create_variable_for_type_inference("float32")
    f1 = helper.create_variable_for_type_inference("float32")
    n_inf = helper.create_variable_for_type_inference("int64")
    n_lab = helper.create_variable_for_type_inference("int64")
    n_cor = helper.create_variable_for_type_inference("int64")
    inputs = {"Inference": [input], "Label": [label]}
    if seq_length is not None:
        inputs["SeqLength"] = [seq_length]
    helper.append_op(
        type="chunk_eval", inputs=inputs,
        outputs={"Precision": [precision], "Recall": [recall],
                 "F1-Score": [f1], "NumInferChunks": [n_inf],
                 "NumLabelChunks": [n_lab], "NumCorrectChunks": [n_cor]},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": num_chunk_types,
               "excluded_chunk_types": excluded_chunk_types or []})
    return precision, recall, f1, n_inf, n_lab, n_cor


# -- the sequence and beam-search slice (nn.py:1107-2212) ---------------


def sequence_softmax(input, use_cudnn=False, name=None, length=None):
    del use_cudnn  # the lowering is the same either way
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    inputs = {"X": [input]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="sequence_softmax", inputs=inputs, outputs={"Out": [out]}
    )
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="sequence_expand",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"ref_level": ref_level},
    )
    return out


def sequence_reverse(x, length=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    inputs = {"X": [x]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="sequence_reverse", inputs=inputs, outputs={"Y": [out]}
    )
    return out


def sequence_concat(input, lengths=None, name=None):
    """Per-row concat of ragged sequences (reference: layers/nn.py
    sequence_concat → sequence_concat_op.cc). ``input`` is a list of
    padded [B, T_k, D] tensors, ``lengths`` the matching [B] length
    tensors; the result is left-compacted. The output's lengths are
    elementwise sums of ``lengths`` (compute via elementwise_add)."""
    helper = LayerHelper("sequence_concat", name=name)
    xs = input if isinstance(input, (list, tuple)) else [input]
    out = helper.create_variable_for_type_inference(dtype=xs[0].dtype)
    inputs = {"X": list(xs)}
    if lengths is not None:
        inputs["Length"] = list(lengths)
    helper.append_op(type="sequence_concat", inputs=inputs,
                     outputs={"Out": [out]})
    return out


def sequence_slice(input, offset, length, name=None):
    """Per-row subsequence (reference: layers/nn.py sequence_slice)."""
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="sequence_slice",
        inputs={"X": [input], "Offset": [offset], "Length": [length]},
        outputs={"Out": [out]})
    return out


def sequence_first_step(input, length=None):
    """First timestep of each sequence (reference: layers/nn.py
    sequence_first_step = sequence_pool FIRST)."""
    return sequence_pool(input, "first", length=length)


def sequence_expand_as(x, y, name=None):
    """Broadcast x rows along y's time dim (reference: layers/nn.py
    sequence_expand_as)."""
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="sequence_expand_as",
                     inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    """Pad each row to maxlen with pad_value; returns (Out, Length)
    (reference: layers/nn.py sequence_pad)."""
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    len_out = helper.create_variable_for_type_inference(dtype="int64")
    inputs = {"X": [x], "PadValue": [pad_value]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="sequence_pad", inputs=inputs,
        outputs={"Out": [out], "Length": [len_out]},
        attrs={"padded_length": maxlen if maxlen is not None else -1})
    return out, len_out


def sequence_unpad(x, length, name=None):
    """Strip pad values back to the zero-padded convention (reference:
    layers/nn.py sequence_unpad)."""
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="sequence_unpad",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  length=None, name=None):
    """Context-window convolution over time (reference: layers/nn.py
    sequence_conv → sequence_conv_op.cc)."""
    helper = LayerHelper("sequence_conv", name=name, act=act,
                         bias_attr=bias_attr, param_attr=param_attr)
    dtype = input.dtype
    d = input.shape[-1]
    filter_shape = [filter_size * d, num_filters]
    filter_param = helper.create_parameter(
        attr=param_attr, shape=filter_shape, dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [input], "Filter": [filter_param]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="sequence_conv", inputs=inputs, outputs={"Out": [out]},
        attrs={"contextLength": filter_size,
               "contextStart": -((filter_size - 1) // 2),
               "contextStride": filter_stride})
    pre_act = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(pre_act)


def sequence_enumerate(input, win_size, pad_value=0, length=None,
                       name=None):
    """Sliding id windows (reference: layers/nn.py sequence_enumerate);
    ``length`` bounds windows per row like the reference's LoD."""
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    inputs = {"X": [input]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="sequence_enumerate", inputs=inputs,
        outputs={"Out": [out]},
        attrs={"win_size": win_size, "pad_value": pad_value})
    return out


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False, first_step=False):
    """One beam-search step (reference: layers/nn.py:3873 — fixed
    batch*beam rows instead of LoD shrinking). ``ids`` optionally maps
    score columns to token ids (None means column index IS the id, the
    common vocab-scores case); ``level`` (the reference's LoD level) is
    meaningless in the padded form; with ``is_accumulated=False`` the
    scores are per-step probabilities and are log-accumulated onto
    pre_scores here, as the reference op does. Returns (selected_ids,
    selected_scores), or a 3-tuple including parent_idx when
    ``return_parent_idx=True``."""
    del level
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference("int64")
    sel_scores = helper.create_variable_for_type_inference(scores.dtype)
    parent = helper.create_variable_for_type_inference("int64")
    inputs = {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
              "scores": [scores]}
    if ids is not None:
        inputs["ids"] = [ids]
    helper.append_op(
        type="beam_search",
        inputs=inputs,
        outputs={"selected_ids": [sel_ids],
                 "selected_scores": [sel_scores],
                 "parent_idx": [parent]},
        attrs={"beam_size": beam_size, "end_id": end_id,
               "is_accumulated": bool(is_accumulated),
               "first_step": first_step},
    )
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, beam_size, end_id, name=None,
                       parent_array=None):
    """Backtrack a finished beam decode from the step arrays (reference:
    layers beam_search_decode). Returns (sentence_ids [BW, max_len],
    sentence_scores [BW, 1]). The padded representation needs the
    parent-pointer array our beam_search emits (the reference recovers
    parents from LoD; here they are explicit)."""
    ids_array, scores_array = ids, scores
    if parent_array is None:
        raise ValueError(
            "beam_search_decode needs parent_array= (the parent_idx "
            "array collected from beam_search steps); the padded beam "
            "representation stores parent pointers explicitly where the "
            "reference recovers them from LoD")
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_variable_for_type_inference("int64")
    sent_scores = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids_array], "Scores": [scores_array],
                "ParentIdx": [parent_array]},
        outputs={"sentence_ids": [sent_ids],
                 "sentence_scores": [sent_scores]},
        attrs={"beam_size": beam_size, "end_id": end_id},
    )
    return sent_ids, sent_scores


def row_conv(input, future_context_size, param_attr=None, act=None):
    """(reference: layers/nn.py row_conv)"""
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    d = input.shape[-1]
    filt = helper.create_parameter(
        attr=param_attr, shape=[future_context_size + 1, d],
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="row_conv",
                     inputs={"X": [input], "Filter": [filt]},
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """(reference: layers/nn.py lstm_unit) — fc of [x, h] then one cell
    step."""
    helper = LayerHelper("lstm_unit", name=name)
    hsz = hidden_t_prev.shape[1]
    gates = fc(input=[x_t, hidden_t_prev], size=4 * hsz,
               param_attr=param_attr, bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(type="lstm_unit",
                     inputs={"X": [gates], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": forget_bias})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """(reference: layers/nn.py gru_unit); size = 3*hidden_dim."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    hsz = size // 3
    w = helper.create_parameter(attr=param_attr, shape=[hsz, 3 * hsz],
                                dtype=input.dtype)
    inputs = {"Input": [input], "HiddenPrev": [hidden], "Weight": [w]}
    if bias_attr is not False:
        bias = helper.create_parameter(
            attr=bias_attr if bias_attr not in (None, True) else ParamAttr(),
            shape=[1, 3 * hsz], dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [bias]
    h = helper.create_variable_for_type_inference(input.dtype)
    r = helper.create_variable_for_type_inference(input.dtype)
    g = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gru_unit", inputs=inputs,
                     outputs={"Hidden": [h], "ResetHiddenPrev": [r],
                              "Gate": [g]})
    return h, r, g


def linear_chain_crf(input, label, param_attr=None, length=None):
    """(reference: layers/nn.py linear_chain_crf). Padded [B, T, C]
    emissions + optional lengths; returns per-sequence log-likelihood."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    num_tags = input.shape[-1]
    trans = helper.create_parameter(
        attr=param_attr, shape=[num_tags + 2, num_tags], dtype=input.dtype)
    ll = helper.create_variable_for_type_inference(input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    eexp = helper.create_variable_for_type_inference(input.dtype)
    texp = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Emission": [input], "Transition": [trans],
              "Label": [label]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="linear_chain_crf", inputs=inputs,
        outputs={"LogLikelihood": [ll], "Alpha": [alpha],
                 "EmissionExps": [eexp], "TransitionExps": [texp]})
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    """(reference: layers/nn.py crf_decoding)"""
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    # the transition parameter is shared with linear_chain_crf by name
    trans = helper.main_program.global_block().var(param_attr.name)
    out = helper.create_variable_for_type_inference("int64")
    inputs = {"Emission": [input], "Transition": [trans]}
    if label is not None:
        inputs["Label"] = [label]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [out]})
    return out


def sequence_reshape(input, new_dim):
    """(reference: layers/nn.py sequence_reshape)"""
    helper = LayerHelper("sequence_reshape")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_reshape", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"new_dim": new_dim})
    return out


def sequence_scatter(input, index, updates, name=None):
    """(reference: layers/nn.py sequence_scatter)"""
    helper = LayerHelper("sequence_scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]})
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, input_image_size=None,
                out_stride=1, name=None):
    """(reference: layers/nn.py im2sequence; op in ops/sequence_ops.py)"""
    helper = LayerHelper("im2sequence", name=name)
    to2 = lambda v: [v, v] if isinstance(v, int) else list(v)
    fs, st = to2(filter_size), to2(stride)
    pd = padding if isinstance(padding, (list, tuple)) and len(padding) == 4 \
        else to2(padding) * 2
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="im2sequence", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"kernels": fs, "strides": st,
                            "paddings": list(pd)})
    return out


def tensor_array_to_tensor(input, axis=1, name=None):
    """(reference: layers/tensor.py tensor_array_to_tensor) — stack the
    live prefix of a tensor array."""
    helper = LayerHelper("tensor_array_to_tensor", name=name)
    out = helper.create_variable_for_type_inference("float32")
    out_idx = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="tensor_array_to_tensor",
                     inputs={"X": [input]},
                     outputs={"Out": [out], "OutIndex": [out_idx]},
                     attrs={"axis": axis})
    return out, out_idx


# -- the misc family (nn.py:1497-2524) ----------------------------------------


def cos_sim(X, Y):
    """(nn.py:1497)"""
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xn], "YNorm": [yn]})
    return out


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None):
    """(nn.py:1508)"""
    helper = LayerHelper("affine_channel", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="affine_channel",
                     inputs={"X": [x], "Scale": [scale], "Bias": [bias]},
                     outputs={"Out": [out]},
                     attrs={"data_layout": data_layout})
    return out


def shuffle_channel(x, group, name=None):
    """(nn.py:1519)"""
    helper = LayerHelper("shuffle_channel", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="shuffle_channel", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"group": group})
    return out


def space_to_depth(x, blocksize, name=None):
    """(nn.py:1528)"""
    helper = LayerHelper("space_to_depth", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="space_to_depth", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"blocksize": blocksize})
    return out


def crop(x, shape=None, offsets=None, name=None):
    """(nn.py:1538): ``shape`` a list or a var whose shape is taken,
    ``offsets`` a list or a var read at run time."""
    helper = LayerHelper("crop", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x]}
    attrs = {}
    if hasattr(shape, "name"):
        inputs["Y"] = [shape]
    else:
        attrs["shape"] = list(shape)
    if offsets is not None:
        if hasattr(offsets, "name"):
            inputs["Offsets"] = [offsets]
        else:
            attrs["offsets"] = list(offsets)
    helper.append_op(type="crop", inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """(nn.py:1558)"""
    helper = LayerHelper("pad_constant_like", name=name)
    out = helper.create_variable_for_type_inference(y.dtype)
    helper.append_op(type="pad_constant_like",
                     inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
                     attrs={"pad_value": float(pad_value)})
    return out


def multiplex(inputs, index):
    """(nn.py:1568)"""
    helper = LayerHelper("multiplex")
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(type="multiplex",
                     inputs={"X": list(inputs), "Ids": [index]},
                     outputs={"Out": [out]})
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """(nn.py:1578)"""
    helper = LayerHelper("bilinear_tensor_product", name=name, act=act,
                         bias_attr=bias_attr)
    w = helper.create_parameter(
        attr=param_attr, shape=[size, x.shape[1], y.shape[1]],
        dtype=x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if bias_attr is not False:
        bias = helper.create_parameter(
            attr=bias_attr if bias_attr not in (None, True) else ParamAttr(),
            shape=[1, size], dtype=x.dtype, is_bias=True)
        inputs["Bias"] = [bias]
    helper.append_op(type="bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def rank_loss(label, left, right, name=None):
    """(nn.py:1600)"""
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="rank_loss",
                     inputs={"Label": [label], "Left": [left],
                             "Right": [right]},
                     outputs={"Out": [out]})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    """(nn.py:1611)"""
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference("float32")
    act = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="margin_rank_loss",
                     inputs={"Label": [label], "X1": [left], "X2": [right]},
                     outputs={"Out": [out], "Activated": [act]},
                     attrs={"margin": margin})
    return out


def bpr_loss(input, label, name=None):
    """(nn.py:1623)"""
    helper = LayerHelper("bpr_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="bpr_loss",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]})
    return out


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """(nn.py:1633)"""
    helper = LayerHelper("teacher_student_sigmoid_loss")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="teacher_student_sigmoid_loss",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_max_up_bound": soft_max_up_bound,
               "soft_max_lower_bound": soft_max_lower_bound})
    return out


def dice_loss(input, label, epsilon=1e-5):
    """(nn.py:1647)"""
    helper = LayerHelper("dice_loss")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="dice_loss_op",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"epsilon": epsilon})
    return out


def mean_iou(input, label, num_classes):
    """(nn.py:1658): (mean IoU, wrong counts, correct counts)."""
    helper = LayerHelper("mean_iou")
    miou = helper.create_variable_for_type_inference("float32")
    wrong = helper.create_variable_for_type_inference("int64")
    correct = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="mean_iou",
                     inputs={"Predictions": [input], "Labels": [label]},
                     outputs={"OutMeanIou": [miou], "OutWrong": [wrong],
                              "OutCorrect": [correct]},
                     attrs={"num_classes": num_classes})
    return miou, wrong, correct


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):
    """(nn.py:1672)"""
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="sampling_id", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"seed": seed})
    return out


def random_crop(x, shape, seed=None):
    """(nn.py:1681)"""
    helper = LayerHelper("random_crop")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="random_crop", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"shape": list(shape)})
    return out


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    """(nn.py:1690)"""
    helper = LayerHelper("add_position_encoding", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="add_position_encoding",
                     inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"alpha": alpha, "beta": beta})
    return out


def hash(input, hash_size, num_hash=1, name=None):
    """(nn.py:1700; the hash is the JAX package's mix, not the
    reference's xxhash: ``ops/misc_ops.py``)"""
    helper = LayerHelper("hash", name=name)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="hash", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"num_hash": num_hash, "mod_by": hash_size})
    return out


def grid_sampler(x, grid, name=None):
    """(nn.py:1725)"""
    helper = LayerHelper("grid_sampler", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="grid_sampler",
                     inputs={"X": [x], "Grid": [grid]},
                     outputs={"Output": [out]})
    return out


def affine_grid(theta, out_shape, name=None):
    """(nn.py:1735): ``out_shape`` a list (an attr) or a var, read on the
    host at run time."""
    helper = LayerHelper("affine_grid", name=name)
    out = helper.create_variable_for_type_inference(theta.dtype)
    inputs = {"Theta": [theta]}
    attrs = {}
    if hasattr(out_shape, "name"):
        inputs["OutputShape"] = [out_shape]
    else:
        attrs["output_shape"] = list(out_shape)
    helper.append_op(type="affine_grid", inputs=inputs,
                     outputs={"Output": [out]}, attrs=attrs)
    return out


def ctc_greedy_decoder(input, blank, name=None):
    """(nn.py:1750): (decoded [B, T] padded with -1, lengths [B])."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    out = helper.create_variable_for_type_inference("int64")
    out_len = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="ctc_greedy_decoder",
                     inputs={"Input": [input]},
                     outputs={"Out": [out], "OutLength": [out_len]},
                     attrs={"blank": blank})
    return out, out_len


def selu(x, scale=None, alpha=None, name=None):
    """(nn.py:1820)"""
    helper = LayerHelper("selu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="selu", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"scale": scale if scale is not None
               else 1.0507009873554805,
               "alpha": alpha if alpha is not None
               else 1.6732632423543772})
    return out


def _reduce_flag(layer, op_type, x):
    helper = LayerHelper(layer)
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def has_inf(x):
    """(nn.py:1833)"""
    return _reduce_flag("has_inf", "isinf", x)


def has_nan(x):
    """(nn.py:1842)"""
    return _reduce_flag("has_nan", "isnan", x)


def isfinite(x):
    """(nn.py:1851)"""
    return _reduce_flag("isfinite", "isfinite_reduce", x)


def is_empty(x, cond=None):
    """(nn.py:1860)"""
    helper = LayerHelper("is_empty")
    out = cond or helper.create_variable_for_type_inference("bool")
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def _to3(v):
    return [v, v, v] if isinstance(v, int) else list(v)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None):
    """(nn.py:1869), NCDHW."""
    helper = LayerHelper("conv3d", name=name, act=act, bias_attr=bias_attr)
    dtype = input.dtype
    w = helper.create_parameter(
        attr=param_attr,
        shape=[num_filters, input.shape[1] // groups] + _to3(filter_size),
        dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv3d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _to3(stride), "paddings": _to3(padding),
               "dilations": _to3(dilation), "groups": groups})
    return helper.append_activation(_conv_bias(helper, pre_bias))


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """(nn.py:1892): like the JAX package, no ``dilations`` attr and
    ``output_size`` not read."""
    helper = LayerHelper("conv3d_transpose", name=name, act=act,
                         bias_attr=bias_attr)
    dtype = input.dtype
    w = helper.create_parameter(
        attr=param_attr,
        shape=[input.shape[1], num_filters // groups] + _to3(filter_size),
        dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv3d_transpose",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _to3(stride), "paddings": _to3(padding),
               "groups": groups})
    return helper.append_activation(_conv_bias(helper, pre_bias))


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    """(nn.py:1917): ``ceil_mode`` not read, as in the JAX package."""
    helper = LayerHelper("pool3d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool3d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"ksize": _to3(pool_size), "strides": _to3(pool_stride),
               "paddings": _to3(pool_padding), "pooling_type": pool_type,
               "global_pooling": global_pooling,
               "exclusive": exclusive})
    return out


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """(nn.py:1995) with uniform noise, whatever ``sampler`` says (the
    JAX package's cut); ``is_sparse`` is not read: the weight grad is
    dense."""
    helper = LayerHelper("nce", name=name, bias_attr=bias_attr)
    w = helper.create_parameter(
        attr=param_attr, shape=[num_total_classes, input.shape[1]],
        dtype=input.dtype)
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if bias_attr is not False:
        b = helper.create_parameter(
            attr=bias_attr if bias_attr not in (None, True) else ParamAttr(),
            shape=[num_total_classes, 1], dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [b]
    cost = helper.create_variable_for_type_inference(input.dtype)
    logits = helper.create_variable_for_type_inference(input.dtype)
    labels = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="nce", inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [logits],
                 "SampleLabels": [labels]},
        attrs={"num_total_classes": num_total_classes,
               "num_neg_samples": num_neg_samples, "seed": seed})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None,
             is_custom=False, is_sparse=False):
    """(nn.py:2022) over the complete binary tree; a custom tree raises,
    as in the JAX package."""
    if is_custom or path_table is not None:
        raise NotImplementedError(
            "hsigmoid custom trees are not supported; the default "
            "complete binary tree matches the reference default")
    helper = LayerHelper("hsigmoid", name=name, bias_attr=bias_attr)
    w = helper.create_parameter(
        attr=param_attr, shape=[num_classes - 1, input.shape[1]],
        dtype=input.dtype)
    inputs = {"X": [input], "Label": [label], "W": [w]}
    if bias_attr is not False:
        b = helper.create_parameter(
            attr=bias_attr if bias_attr not in (None, True) else ParamAttr(),
            shape=[num_classes - 1, 1], dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(input.dtype)
    pre = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="hierarchical_sigmoid", inputs=inputs,
        outputs={"Out": [out], "PreOut": [pre]},
        attrs={"num_classes": num_classes})
    return out


def lod_reset(x, y=None, target_lod=None):
    """(nn.py:2070): the identity. A padded batch carries its lengths as
    a separate tensor, which the caller passes on."""
    return x


def data_norm(input, act=None, epsilon=1e-05, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False, use_mkldnn=False):
    """(nn.py:2078): normalization by accumulated batch statistics, held
    as parameters."""
    helper = LayerHelper("data_norm", name=name, act=act)
    d = input.shape[-1]

    def stat(suffix, value):
        return helper.create_parameter(
            attr=ParamAttr(name=name and name + suffix,
                           initializer=ConstantInitializer(value)),
            shape=[d], dtype=input.dtype)

    bsize = stat(".batch_size", 1e4)
    bsum = stat(".batch_sum", 0.0)
    bsq = stat(".batch_square_sum", 1e4)
    out = helper.create_variable_for_type_inference(input.dtype)
    means = helper.create_variable_for_type_inference(input.dtype)
    scales = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="data_norm",
        inputs={"X": [input], "BatchSize": [bsize], "BatchSum": [bsum],
                "BatchSquareSum": [bsq]},
        outputs={"Y": [out], "Means": [means], "Scales": [scales]})
    return helper.append_activation(out)


def _random_batch_size_like(op_type, input, shape, dtype, attrs):
    from paddle_tpu_torch.core.types import convert_np_dtype_to_dtype_

    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type=op_type, inputs={"Input": [input]}, outputs={"Out": [out]},
        attrs=dict({"shape": list(shape)}, **attrs,
                   dtype=int(convert_np_dtype_to_dtype_(dtype))))
    out.stop_gradient = True
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    """(nn.py:2120)"""
    return _random_batch_size_like(
        "uniform_random_batch_size_like", input, shape, dtype,
        {"input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx,
         "min": min, "max": max, "seed": seed})


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    """(nn.py:2139)"""
    return _random_batch_size_like(
        "gaussian_random_batch_size_like", input, shape, dtype,
        {"input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx,
         "mean": mean, "std": std, "seed": seed})


def Print(input, first_n=-1, message=None, summarize=-1, print_tensor_name=True,
          print_tensor_type=True, print_tensor_shape=True,
          print_tensor_lod=True, print_phase="both"):
    """(nn.py:2199): prints ``message`` (default the var's name) and the
    values on the host when the op runs; the value passes through."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="print_op", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"message": message or input.name})
    return out


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """(nn.py:2225): a ``pool3d`` whose windows tile the volume; raises
    where a dim does not divide, as the JAX package does."""
    d, h, w = input.shape[2], input.shape[3], input.shape[4]
    od, oh, ow = ((pool_size,) * 3 if isinstance(pool_size, int)
                  else pool_size)
    if d % od or h % oh or w % ow:
        raise ValueError("adaptive_pool3d needs divisible spatial dims")
    k = [d // od, h // oh, w // ow]
    return pool3d(input, pool_size=k, pool_type=pool_type, pool_stride=k,
                  name=name)


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, rois_batch_idx=None, name=None):
    """(nn.py:2311)"""
    helper = LayerHelper("psroi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_idx is not None:
        inputs["RoisBatchIdx"] = [rois_batch_idx]
    helper.append_op(
        type="psroi_pool", inputs=inputs, outputs={"Out": [out]},
        attrs={"output_channels": output_channels,
               "spatial_scale": spatial_scale,
               "pooled_height": pooled_height,
               "pooled_width": pooled_width})
    return out


def similarity_focus(input, axis, indexes, name=None):
    """(nn.py:2420): the {0, 1} mask of each selected channel's greedy
    row- and column-distinct maxima, across all channels."""
    helper = LayerHelper("similarity_focus", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="similarity_focus", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"axis": axis, "indexes": list(indexes)})
    return out


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """(nn.py:2354): runs ``func`` on the inputs' values as numpy arrays
    on the host; ``out`` vars need static shapes. With
    ``backward_func(x..., dout...) -> dx...`` the op has a grad: as in
    the JAX package, it gets the forward inputs and then the output
    grads (not the forward outputs), and ``skip_vars_in_backward_input``
    raises."""
    from paddle_tpu_torch.core.types import convert_dtype_to_np
    from paddle_tpu_torch.ops.misc_ops import register_py_func

    if skip_vars_in_backward_input is not None:
        raise NotImplementedError(
            "py_func: skip_vars_in_backward_input is not supported — "
            "backward_func receives (inputs..., out_grads...) here")
    helper = LayerHelper("py_func")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    attrs = {
        "func_id": register_py_func(func),
        "out_shapes": [list(o.shape) for o in outs],
        "out_dtypes": [str(convert_dtype_to_np(o.dtype)) for o in outs],
    }
    if backward_func is not None:
        attrs["backward_func_id"] = register_py_func(backward_func)
    helper.append_op(type="py_func", inputs={"X": list(xs)},
                     outputs={"Out": list(outs)}, attrs=attrs)
    if backward_func is None:
        for o in outs:
            o.stop_gradient = True
    return out


def load(out, file_path, load_as_fp16=None):
    """(nn.py:2391): the file (``.npy`` or the reference's tensor stream)
    is read once when the layer is built, so errors surface then, and
    not kept; the ``load_value`` op reads it by path at its first run on
    a device."""
    from paddle_tpu_torch.ops.misc_ops import load_from_file

    load_from_file(file_path, bool(load_as_fp16))
    helper = LayerHelper("load")
    helper.append_op(
        type="load_value", inputs={},
        outputs={"Out": [out]},
        attrs={"file_path": file_path,
               "load_as_fp16": bool(load_as_fp16)})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    """(nn.py:2412): the identity. A padded batch is never reordered by
    length (masked loops make it unnecessary)."""
    return x


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    """(nn.py:2497): nodes_vector [B, N, F], edge_set [B, E, 2] 1-based
    parent->child edges; [B, N, output_size, num_filters]."""
    helper = LayerHelper("tree_conv", **locals())
    dtype = nodes_vector.dtype
    w = helper.create_parameter(
        attr=param_attr,
        shape=[nodes_vector.shape[2], 3, output_size, num_filters],
        dtype=dtype, is_bias=False)
    if name is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    else:
        out = helper.create_variable(name=name, dtype=dtype)
    helper.append_op(
        type="tree_conv",
        inputs={"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
                "Filter": [w]},
        outputs={"Out": [out]},
        attrs={"max_depth": max_depth})
    if bias_attr:
        out = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(out)
