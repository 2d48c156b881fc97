"""MNIST models — port of ``paddle_tpu/models/mnist.py`` (reference:
benchmark/fluid/models/mnist.py and tests/book/test_recognize_digits.py),
copied with the imports switched to the port."""

import paddle_tpu_torch.fluid as fluid


def mlp(img, label, hidden=(128, 64)):
    h = img
    for size in hidden:
        h = fluid.layers.fc(input=h, size=size, act="relu")
    logits = fluid.layers.fc(input=h, size=10, act=None)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits=logits, label=label))
    acc = fluid.layers.accuracy(
        input=fluid.layers.softmax(logits), label=label)
    return loss, acc, logits


def conv_net(img, label):
    """LeNet-style conv net (reference: benchmark/fluid/models/mnist.py
    cnn_model)."""
    c1 = fluid.layers.conv2d(input=img, num_filters=20, filter_size=5,
                             act="relu")
    p1 = fluid.layers.pool2d(input=c1, pool_size=2, pool_stride=2,
                             pool_type="max")
    c2 = fluid.layers.conv2d(input=p1, num_filters=50, filter_size=5,
                             act="relu")
    p2 = fluid.layers.pool2d(input=c2, pool_size=2, pool_stride=2,
                             pool_type="max")
    logits = fluid.layers.fc(input=p2, size=10, act=None)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits=logits, label=label))
    acc = fluid.layers.accuracy(
        input=fluid.layers.softmax(logits), label=label)
    return loss, acc, logits


def get_model(batch_size=64, use_conv=False, lr=0.01):
    """Build main/startup programs for an MNIST classifier."""
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        if use_conv:
            img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                    dtype="float32")
        else:
            img = fluid.layers.data(name="img", shape=[784], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc, logits = (conv_net if use_conv else mlp)(img, label)
        opt = fluid.optimizer.Adam(learning_rate=lr)
        opt.minimize(loss)
    return main, startup, {"img": img, "label": label, "loss": loss,
                           "acc": acc, "logits": logits}
