"""Word2vec CBOW-style model — port of ``paddle_tpu/models/word2vec.py``
(reference: tests/book/test_word2vec.py, tests/unittests/dist_word2vec.py:
N-gram context words, embedding concat, hidden, softmax over the vocab),
imports switched. The context words' lookups share one table, so its
dense grad is the ``sum`` of theirs."""

import numpy as np

import paddle_tpu_torch.fluid as fluid


def ngram_net(context_words, next_word, dict_size, embed_dim=32,
              hidden_size=256, is_train=True):
    """context_words: list of [B,1] int64 vars (N-gram context)."""
    embeds = [
        fluid.layers.embedding(
            input=w, size=[dict_size, embed_dim],
            param_attr=fluid.ParamAttr(name="shared_w"))
        for w in context_words
    ]
    embeds = [
        fluid.layers.reshape(e, shape=[-1, embed_dim]) for e in embeds
    ]
    concat = fluid.layers.concat(input=embeds, axis=1)
    hidden = fluid.layers.fc(input=concat, size=hidden_size, act="sigmoid")
    logits = fluid.layers.fc(input=hidden, size=dict_size, act=None)
    loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
        logits=logits, label=next_word))
    return loss, logits


def get_model(dict_size=1000, embed_dim=32, hidden_size=128, window=4,
              lr=0.01, is_train=True):
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        ctx_vars = [
            fluid.layers.data(name="w%d" % i, shape=[1], dtype="int64")
            for i in range(window)
        ]
        nxt = fluid.layers.data(name="next_word", shape=[1], dtype="int64")
        loss, logits = ngram_net(ctx_vars, nxt, dict_size, embed_dim,
                                 hidden_size, is_train)
        if is_train:
            fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    feeds = {v.name: v for v in ctx_vars}
    feeds["next_word"] = nxt
    return main, startup, {"feeds": feeds, "loss": loss, "logits": logits}


def make_fake_batch(batch_size, dict_size, window, rng=None):
    rng = rng or np.random.RandomState(0)
    ctx = rng.randint(0, dict_size, (batch_size, window)).astype(np.int64)
    # next word = deterministic function of context → learnable
    nxt = (ctx.sum(axis=1) % dict_size).astype(np.int64).reshape(-1, 1)
    feed = {"w%d" % i: ctx[:, i:i + 1] for i in range(window)}
    feed["next_word"] = nxt
    return feed
