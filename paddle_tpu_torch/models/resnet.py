"""ResNet for CIFAR-10 and ImageNet — port of ``paddle_tpu/models/resnet.py``
(reference: benchmark/fluid/models/resnet.py — resnet_cifar10:108 /
resnet_imagenet:89, get_model:171), copied with the imports switched to
the port. ``get_model(is_train=True)`` builds the Momentum training
program; ``is_train=False`` the inference program, whose batch norms use
their running statistics."""

import paddle_tpu_torch.fluid as fluid


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_train=True):
    conv = fluid.layers.conv2d(
        input=input, num_filters=ch_out, filter_size=filter_size,
        stride=stride, padding=padding, act=None, bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act=act, is_test=not is_train)


def shortcut(input, ch_in, ch_out, stride, is_train=True):
    # derive the true input width from the tensor, like the reference
    # (benchmark/fluid/models/resnet.py:112 shortcut) — the bookkeeping
    # ch_in is wrong for bottleneck loop blocks (input is ch_out*4 wide),
    # and a spurious projection conv on every identity shortcut both
    # deviates from ResNet-50 and costs ~12 extra conv+BN pairs
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_train=is_train)
    return input


def basicblock(input, ch_in, ch_out, stride, is_train=True):
    s = shortcut(input, ch_in, ch_out, stride, is_train)
    c1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_train=is_train)
    c2 = conv_bn_layer(c1, ch_out, 3, 1, 1, act=None, is_train=is_train)
    return fluid.layers.relu(fluid.layers.elementwise_add(c2, s))


def bottleneck(input, ch_in, ch_out, stride, is_train=True):
    s = shortcut(input, ch_in, ch_out * 4, stride, is_train)
    c1 = conv_bn_layer(input, ch_out, 1, 1, 0, is_train=is_train)
    c2 = conv_bn_layer(c1, ch_out, 3, stride, 1, is_train=is_train)
    c3 = conv_bn_layer(c2, ch_out * 4, 1, 1, 0, act=None, is_train=is_train)
    return fluid.layers.relu(fluid.layers.elementwise_add(c3, s))


def layer_warp(block_func, input, ch_in, ch_out, count, stride,
               is_train=True):
    res = block_func(input, ch_in, ch_out, stride, is_train)
    for _ in range(1, count):
        res = block_func(res, ch_out, ch_out, 1, is_train)
    return res


def resnet_cifar10(input, depth=32, is_train=True):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, 16, 3, 1, 1, is_train=is_train)
    r1 = layer_warp(basicblock, conv1, 16, 16, n, 1, is_train)
    r2 = layer_warp(basicblock, r1, 16, 32, n, 2, is_train)
    r3 = layer_warp(basicblock, r2, 32, 64, n, 2, is_train)
    pool = fluid.layers.pool2d(input=r3, pool_size=8, pool_type="avg",
                               global_pooling=True)
    return pool


def resnet_imagenet(input, depth=50, is_train=True):
    cfg = {
        18: ([2, 2, 2, 1], basicblock),
        34: ([3, 4, 6, 3], basicblock),
        50: ([3, 4, 6, 3], bottleneck),
        101: ([3, 4, 23, 3], bottleneck),
        152: ([3, 8, 36, 3], bottleneck),
    }
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, 64, 7, 2, 3, is_train=is_train)
    pool1 = fluid.layers.pool2d(input=conv1, pool_size=3, pool_stride=2,
                                pool_padding=1, pool_type="max")
    expansion = 4 if block_func is bottleneck else 1
    res = pool1
    ch_in = 64
    for i, count in enumerate(stages):
        ch_out = 64 * (2 ** i)
        stride = 1 if i == 0 else 2
        res = layer_warp(block_func, res, ch_in, ch_out, count, stride,
                         is_train)
        ch_in = ch_out * expansion
    pool2 = fluid.layers.pool2d(input=res, pool_size=7, pool_type="avg",
                                global_pooling=True)
    return pool2


def get_model(batch_size=32, dataset="cifar10", depth=None, class_num=None,
              lr=0.01, is_train=True):
    """(reference: benchmark/fluid/models/resnet.py:171 get_model)."""
    if dataset == "cifar10":
        shape, builder = [3, 32, 32], resnet_cifar10
        depth = depth or 32
        class_num = class_num or 10
    else:
        shape, builder = [3, 224, 224], resnet_imagenet
        depth = depth or 50
        class_num = class_num or 1000

    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=shape, dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        feat = builder(img, depth=depth, is_train=is_train)
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
