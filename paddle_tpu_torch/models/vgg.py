"""VGG-16 (reference: benchmark/fluid/models/vgg.py vgg16_bn_drop)."""

import paddle_tpu_torch.fluid as fluid


def conv_block(input, num_filter, groups, dropouts, is_train=True):
    h = input
    for i in range(groups):
        h = fluid.layers.conv2d(input=h, num_filters=num_filter,
                                filter_size=3, padding=1, act=None)
        h = fluid.layers.batch_norm(input=h, act="relu",
                                    is_test=not is_train)
        if dropouts[i] > 0:
            h = fluid.layers.dropout(x=h, dropout_prob=dropouts[i],
                                     is_test=not is_train)
    return fluid.layers.pool2d(input=h, pool_size=2, pool_stride=2,
                               pool_type="max")


def vgg16_bn_drop(input, is_train=True):
    c1 = conv_block(input, 64, 2, [0.3, 0], is_train)
    c2 = conv_block(c1, 128, 2, [0.4, 0], is_train)
    c3 = conv_block(c2, 256, 3, [0.4, 0.4, 0], is_train)
    c4 = conv_block(c3, 512, 3, [0.4, 0.4, 0], is_train)
    c5 = conv_block(c4, 512, 3, [0.4, 0.4, 0], is_train)
    d1 = fluid.layers.dropout(x=c5, dropout_prob=0.5, is_test=not is_train)
    fc1 = fluid.layers.fc(input=d1, size=512, act=None)
    bn = fluid.layers.batch_norm(input=fc1, act="relu",
                                 is_test=not is_train)
    d2 = fluid.layers.dropout(x=bn, dropout_prob=0.5, is_test=not is_train)
    fc2 = fluid.layers.fc(input=d2, size=512, act=None)
    return fc2


def get_model(batch_size=32, class_num=10, image_shape=(3, 32, 32), lr=0.01,
              is_train=True):
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=list(image_shape),
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        feat = vgg16_bn_drop(img, is_train=is_train)
        logits = fluid.layers.fc(input=feat, size=class_num, act=None)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits=logits, label=label))
        acc = fluid.layers.accuracy(
            input=fluid.layers.softmax(logits), label=label)
        if is_train:
            opt = fluid.optimizer.Adam(learning_rate=lr)
            opt.minimize(loss)
    return main, startup, {"img": img, "label": label, "loss": loss,
                           "acc": acc, "logits": logits}
