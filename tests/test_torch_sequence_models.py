"""chip_smoke.py's three sequence programs at tiny widths, built by the
same builder with each package's ``fluid``, on the CPU:

- ``nmt_beam`` (the book's chapter-8 encoder-decoder under
  ``contrib.BeamSearchDecoder``): descs byte-identical; one decode from
  the reference's startup state: the sentences, the lattice's ids and
  parents and the length equal, the scores and the encoder's and
  decoder's states within 1e-5.
- ``sentiment_conv`` (chapter 6's ``convolution_net``): the port's
  ``nets.sequence_conv_pool`` with the rows' lengths builds the desc the
  reference builds from ``layers.sequence_conv`` and
  ``layers.sequence_pool`` (its own ``nets.sequence_conv_pool`` takes no
  lengths); 3 Adagrad steps over sparse embedding grads, losses rtol
  1e-5.
- ``srl_crf`` (chapter 7's ``db_lstm`` under a CRF): descs
  byte-identical; 2 SGD steps, losses rtol 1e-5; then on the ``for_test``
  clone the Viterbi paths and the chunk counts equal, the emissions
  within 1e-5.

The port's scope is carried from the reference's startup state by name
(``convert.load_numpy_state``).
"""

import importlib.util
import os

import numpy as np

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as j_program_guard

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                               "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ATOL = 1e-5
LOSS_RTOL = 1e-5

FRONT_ENDS = ((jfluid, JProgram, j_program_guard, j_unique_name),
              (tfluid, tfluid.Program, tfluid.program_guard, t_unique_name))


def _build(build):
    """[(fluid, main, startup, handles)] of ``build(fluid)``, the
    reference's first; the two packages' descs byte-identical."""
    out = []
    for fluid_mod, prog_cls, guard, unique in FRONT_ENDS:
        main, startup = prog_cls(), prog_cls()
        with unique.guard(), guard(main, startup):
            handles = build(fluid_mod)
        out.append((fluid_mod, main, startup, handles))
    (_, jm, js, _), (_, tm, ts, _) = out
    assert tm.desc.serialize_to_string() == jm.desc.serialize_to_string()
    assert ts.desc.serialize_to_string() == js.desc.serialize_to_string()
    return out


def _executors(built):
    """Each package's CPU executor and scope, the port's holding the
    reference's startup state."""
    (jf, j_main, j_startup, _), (tf, t_main, _, _) = built
    j_scope = jf.Scope()
    exe = jf.Executor(jf.CPUPlace())
    with jf.scope_guard(j_scope):
        exe.run(j_startup)
    state = {v.name: np.array(j_scope.get(v.name))
             for v in j_main.list_vars() if v.persistable}
    t_scope = tf.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    return [(jf, exe, j_scope), (tf, tf.Executor(tf.CPUPlace()), t_scope)]


def _run(runner, program, feed, fetch):
    fluid, exe, scope = runner
    with fluid.scope_guard(scope):
        return [np.asarray(v) for v in exe.run(program, feed=feed,
                                               fetch_list=fetch)]


NMT = dict(src_dict=20, trg_dict=15, word_dim=8, hidden=8, beam_size=2,
           max_length=5, start_id=0, end_id=1)


def test_nmt_beam_decode_matches_reference():
    built = _build(lambda fluid: chip_smoke.nmt_beam(fluid, src_len=6,
                                                     **NMT))
    feed = chip_smoke.nmt_beam_feed(2, 6, 3, seed=3, **NMT)
    outs = []
    for runner, (_, main, _, h) in zip(_executors(built), built):
        fetch = [h["ids"], h["scores"], h["encoded"], h["steps"]] \
            + h["lattice"]
        outs.append(_run(runner, main, feed, [v.name for v in fetch]))
    want, got = outs
    names = ["ids", "scores", "encoded", "steps", "lattice_ids",
             "lattice_scores", "parents", "states"]
    for n, g, w in zip(names, got, want):
        assert g.shape == w.shape, n
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=n)
        else:
            np.testing.assert_array_equal(g, w, err_msg=n)
    assert int(got[3].reshape(-1)[0]) == NMT["max_length"] + 1


SENTIMENT = dict(dict_dim=30, emb_dim=8, hid_dim=6, class_dim=2, lr=0.05)


def _reference_conv_pool(input, num_filters, filter_size, act, pool_type,
                         length):
    """The reference's ``sequence_conv`` and ``sequence_pool`` over the
    rows' lengths, the ops the port's ``nets.sequence_conv_pool(length=)``
    appends."""
    conv = jfluid.layers.sequence_conv(
        input=input, num_filters=num_filters, filter_size=filter_size,
        act=act, length=length)
    return jfluid.layers.sequence_pool(conv, pool_type, length=length)


def test_sentiment_conv_steps_match_reference():
    built = _build(lambda fluid: chip_smoke.sentiment_conv(
        fluid, seq_len=9, conv_pool=(
            _reference_conv_pool if fluid is jfluid else None),
        **SENTIMENT))
    feed = chip_smoke.sentiment_feed(4, 9, 3, seed=4, **SENTIMENT)
    losses = []
    for runner, (_, main, _, h) in zip(_executors(built), built):
        losses.append([float(_run(runner, main, feed, [h["loss"].name])[0]
                             .reshape(-1)[0]) for _ in range(3)])
    assert losses[0][-1] < losses[0][0]
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL)


SRL = dict(word_dict=25, pred_dict=12, mark_dict=2, label_dict=7,
           word_dim=4, mark_dim=3, hidden_dim=16, depth=3, lr=0.01)


def test_srl_crf_steps_and_decode_match_reference():
    built = _build(lambda fluid: chip_smoke.srl_crf(fluid, seq_len=6,
                                                    **SRL))
    feed = chip_smoke.srl_feed(3, 6, 2, seed=5, **SRL)
    runners = _executors(built)
    outs = []
    for runner, (_, main, _, h) in zip(runners, built):
        losses = [float(_run(runner, main, feed, [h["loss"].name])[0]
                        .reshape(-1)[0]) for _ in range(2)]
        test_prog = main.clone(for_test=True)
        fetch = [h["feature"], h["path"]] + h["chunks"]
        outs.append((losses, _run(runner, test_prog, feed,
                                  [v.name for v in fetch])))
    (j_losses, want), (t_losses, got) = outs
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2:5], want[2:5], rtol=1e-6)
    for g, w in zip(got[5:], want[5:]):
        np.testing.assert_array_equal(g.reshape(-1), w.reshape(-1))


def test_nmt_beam_probes_replay_the_decode():
    """chip_smoke.py's probes of the decode, on the CPU: the flat program
    of one loop step (``nmt_beam_step`` over ``decoder_params``) fed a
    step's operands from the lattice gives the lattice's next entries,
    and ``beam_search_decode`` over the lattice's arrays gives the
    decode's sentences."""
    import torch

    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard(), tfluid.program_guard(main, startup):
        h = chip_smoke.nmt_beam(tfluid, src_len=6, **NMT)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = chip_smoke.nmt_beam_feed(2, 6, 3, seed=3, **NMT)
    with tfluid.scope_guard(scope):
        exe.run(startup)
        ids, scores, steps, *lattice = exe.run(
            main, feed=feed, fetch_list=[h["ids"], h["scores"], h["steps"]]
            + h["lattice"])
    names = chip_smoke.decoder_params(main)
    assert sorted(names) == ["cell_w", "gru_b", "gru_w", "out_b", "out_w",
                             "trg_emb"]
    step_main, step_startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard(), tfluid.program_guard(step_main,
                                                     step_startup):
        step_out = chip_smoke.nmt_beam_step(tfluid, names, **NMT)
    rows = 2 * NMT["beam_size"]
    for k in (0, 3):
        step_feed, want = chip_smoke.lattice_step(lattice, k, rows)
        with tfluid.scope_guard(scope):
            got = exe.run(step_main, feed=step_feed, fetch_list=step_out)
        for part, g, w in zip(("ids", "scores", "parents", "state"), got,
                              want):
            np.testing.assert_allclose(g.reshape(w.shape), w, rtol=0,
                                       atol=1e-6, err_msg=part)
    cap = lattice[0].shape[1]
    n = torch.tensor(int(steps.reshape(-1)[0]), dtype=torch.int32)
    arrays = {"Ids": lattice[0].T.reshape(cap, rows, 1),
              "ParentIdx": lattice[2].reshape(cap, rows),
              "Scores": lattice[1].T.reshape(cap, rows, 1)}
    out = chip_smoke.lower_op("beam_search_decode", {
        s: [{"buf": torch.as_tensor(np.ascontiguousarray(a)), "len": n}]
        for s, a in arrays.items()}, {"beam_size": 2, "end_id": 1}, "cpu")
    np.testing.assert_array_equal(out["sentence_ids"][0].numpy(), ids)
    np.testing.assert_array_equal(out["sentence_scores"][0].numpy(), scores)
