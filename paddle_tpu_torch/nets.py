"""Composite network blocks — port of ``paddle_tpu/nets.py`` (reference:
python/paddle/fluid/nets.py): ``simple_img_conv_pool`` (nets.py:13),
``img_conv_group`` (:31), ``glu`` (:75) and
``scaled_dot_product_attention`` (:80), compositions of ``fluid.layers``
that build the reference's descs. The attention splits and merges heads
around one ``fused_attention`` op, so it runs on the flash kernels on
the card. ``sequence_conv_pool`` (:67) needs ``sequence_conv``, which is
not ported yet."""

from paddle_tpu_torch import layers
from paddle_tpu_torch.layers.nn import fused_attention

__all__ = ["simple_img_conv_pool", "sequence_conv_pool", "glu",
           "scaled_dot_product_attention", "img_conv_group"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None,
                         use_cudnn=True):
    """``conv2d`` then ``pool2d``."""
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """The VGG block: a ``conv2d`` for each entry of ``conv_num_filter``,
    each optionally followed by ``batch_norm`` and ``dropout``, then one
    ``pool2d``. A scalar option applies to every conv."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _expand(v):
        return (v if isinstance(v, (list, tuple))
                else [v] * len(conv_num_filter))

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    raise NotImplementedError(
        "sequence_conv_pool needs the sequence_conv op, which is not "
        "ported yet (ROADMAP Queue 1, step 5d: sequence_ops)")


def glu(input, dim=-1):
    """The gated linear unit: the first half of ``dim`` times the sigmoid
    of the second."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(x=a, y=layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over [B, T, D] inputs: the
    heads split by ``reshape``/``transpose``, one ``fused_attention``
    (the flash kernels on the card), the heads merged back."""
    if queries.shape[-1] % num_heads != 0:
        raise ValueError("hidden size must divide num_heads")
    d_model = queries.shape[-1]
    d_head = d_model // num_heads

    def split_heads(x):
        x = layers.reshape(x, shape=[0, 0, num_heads, d_head])
        return layers.transpose(x, perm=[0, 2, 1, 3])

    ctx = fused_attention(split_heads(queries), split_heads(keys),
                          split_heads(values), scale=d_head ** -0.5,
                          dropout_rate=dropout_rate)
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    return layers.reshape(ctx, shape=[0, 0, d_model])
