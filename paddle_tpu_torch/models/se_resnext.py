"""SE-ResNeXt (reference: benchmark/fluid/models/se_resnext.py and
tests/unittests/test_parallel_executor_seresnext.py SE_ResNeXt50Small)."""

import paddle_tpu_torch.fluid as fluid


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_train=True):
    conv = fluid.layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act=act,
                                   is_test=not is_train)


def squeeze_excitation(input, num_channels, reduction_ratio):
    pool = fluid.layers.pool2d(input=input, pool_type="avg",
                               global_pooling=True)
    squeeze = fluid.layers.fc(input=pool,
                              size=max(num_channels // reduction_ratio, 1),
                              act="relu")
    excitation = fluid.layers.fc(input=squeeze, size=num_channels,
                                 act="sigmoid")
    excitation = fluid.layers.reshape(excitation,
                                      shape=[-1, num_channels, 1, 1])
    return fluid.layers.elementwise_mul(input, excitation)


def shortcut(input, ch_in, ch_out, stride, is_train=True):
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, is_train=is_train)
    return input


def bottleneck_block(input, ch_in, num_filters, stride, cardinality,
                     reduction_ratio, is_train=True):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          is_train=is_train)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu", is_train=is_train)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          is_train=is_train)
    scaled = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = shortcut(input, ch_in, num_filters * 2, stride,
                     is_train=is_train)
    return fluid.layers.relu(fluid.layers.elementwise_add(scaled, short))


def se_resnext(input, depth=50, cardinality=32, reduction_ratio=16,
               is_train=True, small=False):
    if small:
        # the test-suite "small" variant: one stage, few blocks, cheap input
        conv = conv_bn_layer(input, 16, 3, stride=2, act="relu",
                             is_train=is_train)
        ch_in = 16
        block_cfg = [(16, 2, 1)]
        cardinality = 8
    else:
        conv = conv_bn_layer(input, 64, 7, stride=2, act="relu",
                             is_train=is_train)
        conv = fluid.layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                                   pool_padding=1, pool_type="max")
        ch_in = 64
        depth_cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
                     152: [3, 8, 36, 3]}[depth]
        block_cfg = [
            (128 * (2 ** i), n, 1 if i == 0 else 2)
            for i, n in enumerate(depth_cfg)
        ]
    h = conv
    for num_filters, count, stride in block_cfg:
        for j in range(count):
            h = bottleneck_block(h, ch_in, num_filters,
                                 stride if j == 0 else 1,
                                 cardinality, reduction_ratio, is_train)
            ch_in = num_filters * 2
    pool = fluid.layers.pool2d(input=h, pool_type="avg", global_pooling=True)
    return pool


def get_model(class_num=1000, image_shape=(3, 224, 224), lr=0.01,
              is_train=True, small=False):
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=list(image_shape),
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        feat = se_resnext(img, is_train=is_train, small=small)
        drop = fluid.layers.dropout(x=feat, dropout_prob=0.2,
                                    is_test=not is_train)
        logits = fluid.layers.fc(input=drop, size=class_num, act=None)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits=logits, label=label))
        acc = fluid.layers.accuracy(
            input=fluid.layers.softmax(logits), label=label)
        if is_train:
            opt = fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9)
            opt.minimize(loss)
    return main, startup, {"img": img, "label": label, "loss": loss,
                           "acc": acc, "logits": logits}
