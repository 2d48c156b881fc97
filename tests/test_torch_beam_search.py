"""Beam-search decoding and the contrib decoder API in the port against
the JAX package, on the CPU, program for program:

- ``tests/test_rnn_beam.py::test_full_decode_loop_with_backtrack``'s
  ``While`` decode over a toy language model (a transition table): the
  descs byte-identical, the backtracked sentences equal, the scores
  within 1e-5 (float32 sums of the same log-probabilities).
- ``tests/test_contrib_api.py``'s ``BeamSearchDecoder`` program (a
  ``StateCell`` over an ``fc``, batch 2 x beam 3, 4 steps) and
  ``TrainingDecoder`` program (a ``DynamicRNN`` next-token model with
  Adam): descs byte-identical; from the reference's startup state the
  decoded ids equal and the scores within 1e-5; the training losses
  within rtol 1e-5 over 3 steps. The decoder's parents array is seeded
  with zeros and ``decode`` never sets ``first_step`` in both packages:
  with equal initial scores every beam of a group holds the same
  candidates and the same state.

The ``While`` decode also runs a table whose best tokens tie: there the
parents and ids are equal only because both packages rank ties lowest
index first (``torch.topk`` in their place fails the test).
"""

import numpy as np

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as j_program_guard

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name

FRONT_ENDS = ((jfluid, JProgram, j_program_guard, j_unique_name),
              (tfluid, tfluid.Program, tfluid.program_guard, t_unique_name))
SCORE_ATOL = 1e-5
LOSS_RTOL = 1e-5


def _build(build):
    """``build(fluid)`` in each package: [(fluid, main, startup,
    fetches)], the reference's first; their descs byte-identical."""
    out = []
    for fluid_mod, prog_cls, guard, unique in FRONT_ENDS:
        main, startup = prog_cls(), prog_cls()
        with unique.guard(), guard(main, startup):
            fetches = build(fluid_mod)
        out.append((fluid_mod, main, startup, fetches))
    (_, jm, js, _), (_, tm, ts, _) = out
    assert tm.desc.serialize_to_string() == jm.desc.serialize_to_string()
    assert ts.desc.serialize_to_string() == js.desc.serialize_to_string()
    return out


def _run_both(built, feeds):
    """Each package's executor on the CPU, the port's scope carried from
    the reference's startup state by name: [reference's, port's] lists
    of fetched values, one per feed."""
    (jf, j_main, j_startup, j_fetch), (tf, t_main, _, t_fetch) = built
    scope = jf.Scope()
    runs = [[], []]
    with jf.scope_guard(scope):
        exe = jf.Executor(jf.CPUPlace())
        exe.run(j_startup)
        state = {v.name: np.array(scope.get(v.name))
                 for v in j_main.list_vars() if v.persistable}
        for feed in feeds:
            runs[0].append([np.asarray(v) for v in exe.run(
                j_main, feed=feed, fetch_list=list(j_fetch))])
    t_scope = tf.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    with tf.scope_guard(t_scope):
        exe = tf.Executor(tf.CPUPlace())
        for feed in feeds:
            runs[1].append([np.asarray(v) for v in exe.run(
                t_main, feed=feed, fetch_list=list(t_fetch))])
    return runs


V, W, MAX_T, END = 6, 2, 4, 0


def _while_decode(fluid):
    """test_rnn_beam.py's decode: step 0 with ``first_step`` outside the
    loop, the rest under ``While``, then ``beam_search_decode``."""
    layers = fluid.layers
    bw = W
    table_v = layers.data(name="table", shape=[V, V], dtype="float32",
                          append_batch_size=False)
    start = layers.fill_constant(shape=[bw, 1], dtype="int64", value=1)
    zero_scores = layers.fill_constant(shape=[bw, 1], dtype="float32",
                                       value=0.0)
    i = layers.fill_constant(shape=[1], dtype="int64", value=0)
    limit = layers.fill_constant(shape=[1], dtype="int64", value=MAX_T)
    ids_arr = layers.create_array("int64", capacity=MAX_T)
    par_arr = layers.create_array("int64", capacity=MAX_T)
    score_arr = layers.create_array("float32", capacity=MAX_T)
    cur = layers.gather(table_v, layers.reshape(start, shape=[-1]))
    acc0 = layers.elementwise_add(cur, zero_scores, axis=0)
    ids0, scores0, par0 = layers.beam_search(
        start, zero_scores, None, acc0, beam_size=W, end_id=END,
        return_parent_idx=True, first_step=True)
    layers.array_write(ids0, i, array=ids_arr)
    layers.array_write(par0, i, array=par_arr)
    layers.array_write(scores0, i, array=score_arr)
    pre_ids = layers.assign(ids0)
    pre_scores = layers.assign(scores0)
    layers.increment(i, value=1, in_place=True)
    cond = layers.less_than(x=i, y=limit)
    with fluid.While(cond=cond).block():
        cur = layers.gather(table_v, layers.reshape(pre_ids, shape=[-1]))
        acc = layers.elementwise_add(cur, pre_scores, axis=0)
        ids_t, scores_t, par_t = layers.beam_search(
            pre_ids, pre_scores, None, acc, beam_size=W, end_id=END,
            return_parent_idx=True)
        layers.array_write(ids_t, i, array=ids_arr)
        layers.array_write(par_t, i, array=par_arr)
        layers.array_write(scores_t, i, array=score_arr)
        layers.assign(ids_t, output=pre_ids)
        layers.assign(scores_t, output=pre_scores)
        layers.increment(i, value=1, in_place=True)
        layers.less_than(x=i, y=limit, cond=cond)
    return layers.beam_search_decode(ids_arr, score_arr, beam_size=W,
                                     end_id=END, parent_array=par_arr)


def test_while_decode_matches_reference():
    rng = np.random.RandomState(5)
    table = np.log(rng.dirichlet(np.ones(V), V)).astype(np.float32)
    # a tied table: every row the same, two equal best tokens
    tied = np.tile(np.log(np.array([[0.1, 0.3, 0.3, 0.1, 0.1, 0.1]],
                                   np.float32)), (V, 1))
    want, got = _run_both(_build(_while_decode),
                          [{"table": table}, {"table": tied}])
    for (w_ids, w_scores), (g_ids, g_scores) in zip(want, got):
        assert g_ids.shape == (W, MAX_T)
        np.testing.assert_array_equal(g_ids, w_ids)
        np.testing.assert_allclose(g_scores, w_scores, rtol=0,
                                   atol=SCORE_ATOL)


DV, DD, DH, BW = 10, 6, 8, 6   # vocabulary, word dim, state, batch 2 x 3


def _beam_decoder(fluid):
    """test_contrib_api.py's ``BeamSearchDecoder`` program."""
    layers = fluid.layers
    init_ids = layers.data(name="init_ids", shape=[1], dtype="int64")
    init_scores = layers.data(name="init_scores", shape=[1],
                              dtype="float32")
    boot_h = layers.data(name="boot_h", shape=[DH], dtype="float32")
    cell = fluid.contrib.StateCell(
        inputs={"x": None}, states={"h": fluid.contrib.InitState(
            init=boot_h)}, out_state="h")

    @cell.state_updater
    def updater(c):
        c.set_state("h", layers.fc(input=[c.get_input("x"),
                                          c.get_state("h")],
                                   size=DH, act="tanh"))

    decoder = fluid.contrib.BeamSearchDecoder(
        state_cell=cell, init_ids=init_ids, init_scores=init_scores,
        target_dict_dim=DV, word_dim=DD, topk_size=DV, sparse_emb=False,
        max_len=4, beam_size=3, end_id=0)
    decoder.decode()
    return decoder()


def test_beam_search_decoder_matches_reference():
    rng = np.random.RandomState(0)
    boot = rng.randn(BW, DH).astype(np.float32)
    feeds = [{"init_ids": np.ones((BW, 1), np.int64),
              "init_scores": np.zeros((BW, 1), np.float32),
              "boot_h": boot},
             # beams 1-2 of each group start at -1e9, so they differ
             {"init_ids": np.ones((BW, 1), np.int64),
              "init_scores": np.where(np.arange(BW) % 3 == 0, 0.0, -1e9)
              .astype(np.float32).reshape(BW, 1),
              "boot_h": rng.randn(BW, DH).astype(np.float32)}]
    built = _build(_beam_decoder)
    want, got = _run_both(built, feeds)
    for (w_ids, w_scores), (g_ids, g_scores) in zip(want, got):
        assert g_ids.shape == (BW, 256)
        np.testing.assert_array_equal(g_ids, w_ids)
        np.testing.assert_allclose(g_scores, w_scores, rtol=0,
                                   atol=SCORE_ATOL)


TV, TD, TH, TT, TB = 12, 8, 16, 5, 8


def _training_decoder(fluid):
    """test_contrib_api.py's ``TrainingDecoder`` program."""
    layers = fluid.layers
    src = layers.data(name="src", shape=[TT], dtype="int64")
    trg = layers.data(name="trg", shape=[TT], dtype="int64")
    enc = layers.reduce_mean(layers.embedding(src, size=[TV, TD],
                                              dtype="float32"), dim=1)
    cell = fluid.contrib.StateCell(
        inputs={"x": None}, states={"h": fluid.contrib.InitState(
            init=layers.fc(input=enc, size=TH, act="tanh"))},
        out_state="h")

    @cell.state_updater
    def updater(c):
        c.set_state("h", layers.fc(input=[c.get_input("x"),
                                          c.get_state("h")],
                                   size=TH, act="tanh"))

    trg_emb = layers.embedding(trg, size=[TV, TD], dtype="float32")
    lens = layers.data(name="lens", shape=[1], dtype="int64")
    decoder = fluid.contrib.TrainingDecoder(cell)
    with decoder.block():
        cur = decoder.step_input(trg_emb, length=lens)
        decoder.state_cell.compute_state(inputs={"x": cur})
        score = layers.fc(input=decoder.state_cell.get_state("h"), size=TV,
                          act="softmax")
        decoder.state_cell.update_states()
        decoder.output(score)
    probs = decoder()
    label = layers.data(name="label", shape=[TT], dtype="int64")
    loss = layers.mean(layers.cross_entropy(
        input=layers.reshape(probs, shape=[-1, TV]),
        label=layers.reshape(label, shape=[-1, 1])))
    fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return [loss]


def test_training_decoder_matches_reference():
    rng = np.random.RandomState(0)
    src = rng.randint(0, TV, (TB, TT)).astype(np.int64)
    trg = rng.randint(0, TV, (TB, TT)).astype(np.int64)
    feed = {"src": src, "trg": trg, "label": (trg + 1) % TV,
            "lens": rng.randint(2, TT + 1, (TB, 1)).astype(np.int64)}
    want, got = _run_both(_build(_training_decoder), [feed] * 3)
    losses = [float(w[0].reshape(-1)[0]) for w in want]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose([float(g[0].reshape(-1)[0]) for g in got],
                               losses, rtol=LOSS_RTOL)
