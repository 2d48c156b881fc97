"""The book programs — port of the builders of
``tests/book/test_book_models.py`` (:23-79): fit_a_line (linear
regression), recognize_digits (conv + pool + softmax, ``cross_entropy``),
word2vec (4-gram next word, shared embeddings, ``cross_entropy``) and
machine_translation (a mean-pooled encoder tiled over the target with
``reduce_mean``, ``unsqueeze`` and ``expand``). Each builder returns
(feed names, fetch var, loss var) and runs inside a ``program_guard``.

``get_model(name)`` builds one with its Adam step, as the reference's
``_train_save_load`` does; ``make_batch(name, batch, rng)`` draws a
seeded batch of the program's feeds (no dataset, no download).
"""

import numpy as np

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.framework import Program, program_guard

WORD2VEC_DICT = 200
MT_DICT, MT_SEQ = 120, 14


def build_fit_a_line():
    x = fluid.layers.data(name="x", shape=[13], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    y_predict = fluid.layers.fc(input=x, size=1, act=None)
    cost = fluid.layers.square_error_cost(input=y_predict, label=y)
    avg_cost = fluid.layers.mean(cost)
    return ["x", "y"], y_predict, avg_cost


def build_recognize_digits():
    img = fluid.layers.data(name="img", shape=[1, 28, 28],
                            dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    conv = fluid.layers.conv2d(img, num_filters=8, filter_size=5,
                               act="relu")
    pool = fluid.layers.pool2d(conv, pool_size=2, pool_stride=2)
    pred = fluid.layers.fc(input=pool, size=10, act="softmax")
    cost = fluid.layers.cross_entropy(input=pred, label=label)
    return ["img", "label"], pred, fluid.layers.mean(cost)


WORD2VEC_FEEDS = ["firstw", "secondw", "thirdw", "forthw", "nextw"]


def build_word2vec(dict_size=WORD2VEC_DICT):
    words = [fluid.layers.data(name=n, shape=[1], dtype="int64")
             for n in WORD2VEC_FEEDS]
    embeds = [fluid.layers.embedding(
        input=w, size=[dict_size, 32], dtype="float32",
        param_attr="shared_w") for w in words[:4]]
    concat = fluid.layers.concat(input=embeds, axis=1)
    hidden1 = fluid.layers.fc(input=concat, size=64, act="sigmoid")
    predict = fluid.layers.fc(input=hidden1, size=dict_size,
                              act="softmax")
    cost = fluid.layers.cross_entropy(input=predict, label=words[4])
    return list(WORD2VEC_FEEDS), predict, fluid.layers.mean(cost)


def build_machine_translation(dict_size=MT_DICT, seq_len=MT_SEQ):
    s = fluid.layers.data(name="src", shape=[seq_len], dtype="int64")
    t = fluid.layers.data(name="trg", shape=[seq_len], dtype="int64")
    n = fluid.layers.data(name="nxt", shape=[seq_len], dtype="int64")
    semb = fluid.layers.embedding(input=s, size=[dict_size, 32],
                                  dtype="float32")
    # encoder: mean over time of embedded source
    enc = fluid.layers.reduce_mean(semb, dim=1)
    temb = fluid.layers.embedding(input=t, size=[dict_size, 32],
                                  dtype="float32")
    enc_tiled = fluid.layers.expand(
        fluid.layers.unsqueeze(enc, axes=[1]),
        expand_times=[1, seq_len, 1])
    dec_in = fluid.layers.concat([temb, semb, enc_tiled], axis=2)
    hidden = fluid.layers.fc(input=dec_in, size=64, act="tanh",
                             num_flatten_dims=2)
    logits = fluid.layers.fc(input=hidden, size=dict_size,
                             num_flatten_dims=2)
    loss = fluid.layers.softmax_with_cross_entropy(
        logits=logits, label=fluid.layers.unsqueeze(n, axes=[2]))
    return ["src", "trg", "nxt"], logits, fluid.layers.mean(loss)


BOOK_BUILDERS = {
    "fit_a_line": build_fit_a_line,
    "recognize_digits": build_recognize_digits,
    "word2vec": build_word2vec,
    "machine_translation": build_machine_translation,
}

# the feeds each saved inference model keeps (the label feeds go)
SAVE_NAMES = {
    "fit_a_line": ["x"],
    "recognize_digits": ["img"],
    "word2vec": WORD2VEC_FEEDS[:4],
    "machine_translation": ["src", "trg"],
}

# the reference's learning rates (test_book_models.py:131-227)
LR = {"fit_a_line": 2e-1, "recognize_digits": 5e-3, "word2vec": 5e-3,
      "machine_translation": 5e-3}


def get_model(name, lr=None):
    """(main, startup, feed names, fetch var, loss var) of one book
    program, with Adam at the reference's learning rate."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        feeds, fetch, loss = BOOK_BUILDERS[name]()
        fluid.optimizer.Adam(
            learning_rate=LR[name] if lr is None else lr).minimize(loss)
    return main, startup, feeds, fetch, loss


def make_batch(name, batch, rng):
    """A seeded batch of ``name``'s feeds, the dtypes and ranges its
    data layers and embedding tables take."""
    if name == "fit_a_line":
        x = rng.randn(batch, 13).astype(np.float32)
        w = np.linspace(-1.0, 1.0, 13, dtype=np.float32)
        y = (x @ w + 0.1 * rng.randn(batch)).astype(np.float32)
        return {"x": x, "y": y.reshape(-1, 1)}
    if name == "recognize_digits":
        return {"img": rng.rand(batch, 1, 28, 28).astype(np.float32),
                "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}
    if name == "word2vec":
        return {n: rng.randint(0, WORD2VEC_DICT, (batch, 1)).astype(np.int64)
                for n in WORD2VEC_FEEDS}
    return {n: rng.randint(0, MT_DICT, (batch, MT_SEQ)).astype(np.int64)
            for n in ("src", "trg", "nxt")}
