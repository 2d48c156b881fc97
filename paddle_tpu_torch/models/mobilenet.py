"""MobileNet-V1 (reference: the fork's INT8 headline model,
python/paddle/fluid/contrib/int8_inference/README.md; architecture per
depthwise-separable conv stack)."""

import paddle_tpu_torch.fluid as fluid


def conv_bn(input, num_filters, filter_size, stride=1, padding=0, groups=1,
            depthwise=False, is_train=True):
    layer = (fluid.layers.depthwise_conv2d if depthwise
             else fluid.layers.conv2d)
    conv = layer(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=padding,
        **({"groups": groups} if not depthwise else {}),
        act=None, bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act="relu",
                                   is_test=not is_train)


def depthwise_separable(input, ch_in, ch_out, stride, scale=1.0,
                        is_train=True):
    dw = conv_bn(input, int(ch_in * scale), 3, stride=stride, padding=1,
                 depthwise=True, is_train=is_train)
    return conv_bn(dw, int(ch_out * scale), 1, is_train=is_train)


def mobilenet_v1(input, scale=1.0, is_train=True):
    h = conv_bn(input, int(32 * scale), 3, stride=2, padding=1,
                is_train=is_train)
    cfg = [
        (32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
        (256, 256, 1), (256, 512, 2),
        (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
        (512, 512, 1),
        (512, 1024, 2), (1024, 1024, 1),
    ]
    for ch_in, ch_out, stride in cfg:
        h = depthwise_separable(h, ch_in, ch_out, stride, scale, is_train)
    return fluid.layers.pool2d(input=h, pool_type="avg", global_pooling=True)


def get_model(class_num=1000, image_shape=(3, 224, 224), scale=1.0, lr=0.01,
              is_train=True):
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=list(image_shape),
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        feat = mobilenet_v1(img, scale=scale, is_train=is_train)
        logits = fluid.layers.fc(input=feat, size=class_num, act=None)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits=logits, label=label))
        acc = fluid.layers.accuracy(
            input=fluid.layers.softmax(logits), label=label)
        if is_train:
            opt = fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9)
            opt.minimize(loss)
    return main, startup, {"img": img, "label": label, "loss": loss,
                           "acc": acc, "logits": logits}
