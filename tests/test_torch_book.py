"""The book programs (``tests/book/test_book_models.py`` :23-79) in the
port (``paddle_tpu_torch/models/book.py``) against the JAX package's
builders, on the CPU, on seeded numpy batches (no dataset).

- Both front ends build the same main and startup descs, with Adam, byte
  for byte.
- The JAX package runs its startup; its scope is carried into the port by
  name (``convert.load_numpy_state``); both take 3 Adam steps on the same
  batches: losses rtol 1e-5, float32 on both sides (the same formulas
  summed in other orders).
- The reference's round trip (``_train_save_load`` :94-127): the trained
  program saved with ``io.save_inference_model``, loaded back and run,
  answers as the training program's ``for_test`` clone does (rtol 1e-4,
  atol 1e-5, the reference's), and the JAX package serves the port's
  directory with the same answers.
"""

import tempfile

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as j_program_guard

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.models import book

from book.test_book_models import BOOK_BUILDERS as J_BUILDERS

STEPS = 3
BATCH = 8
LOSS_RTOL = 1e-5
NAMES = sorted(book.BOOK_BUILDERS)


def _j_model(name):
    main, startup = JProgram(), JProgram()
    with j_unique_name.guard(), j_program_guard(main, startup):
        feeds, fetch, loss = J_BUILDERS[name]()
        jfluid.optimizer.Adam(learning_rate=book.LR[name]).minimize(loss)
    return main, startup, feeds, fetch, loss


def _t_model(name):
    with t_unique_name.guard():
        return book.get_model(name)


def _batches(name):
    rng = np.random.RandomState(sorted(book.BOOK_BUILDERS).index(name))
    return [book.make_batch(name, BATCH, rng) for _ in range(STEPS)]


@pytest.mark.parametrize("name", NAMES)
def test_book_descs_match_reference(name):
    j_main, j_startup, j_feeds, _, _ = _j_model(name)
    t_main, t_startup, t_feeds, _, _ = _t_model(name)
    assert t_feeds == j_feeds
    assert t_main.desc.serialize_to_string() == \
        j_main.desc.serialize_to_string()
    assert t_startup.desc.serialize_to_string() == \
        j_startup.desc.serialize_to_string()


@pytest.mark.parametrize("name", NAMES)
def test_book_steps_match_reference_and_round_trip(name):
    j_main, j_startup, _, j_fetch, j_loss = _j_model(name)
    batches = _batches(name)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    names = sorted(v.name for v in j_main.list_vars() if v.persistable)
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
        state = {n: np.array(scope.get(n)) for n in names}
        want = [float(np.asarray(exe.run(
            j_main, feed=b, fetch_list=[j_loss])[0]).reshape(()))
            for b in batches]

    t_main, _, _, t_fetch, t_loss = _t_model(name)
    t_scope = tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    t_exe = tfluid.Executor(tfluid.CPUPlace())
    save_names = book.SAVE_NAMES[name]
    with tfluid.scope_guard(t_scope), \
            tempfile.TemporaryDirectory(prefix="book_") as d:
        got = [float(np.asarray(t_exe.run(
            t_main, feed=b, fetch_list=[t_loss])[0]).reshape(()))
            for b in batches]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)

        tfluid.io.save_inference_model(d, save_names, [t_fetch], t_exe,
                                       main_program=t_main)
        prog, feed_names, fetches = tfluid.io.load_inference_model(d, t_exe)
        assert feed_names == save_names
        feed = batches[0]
        infer_feed = {k: feed[k] for k in save_names}
        (out,) = t_exe.run(prog, feed=infer_feed, fetch_list=fetches)
        (ref,) = t_exe.run(t_main.clone(for_test=True), feed=feed,
                           fetch_list=[t_fetch])
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)

        # the JAX package serves the port's directory alike
        j_scope = jfluid.Scope()
        with jfluid.scope_guard(j_scope):
            j_prog, _, j_fetches = jfluid.io.load_inference_model(d, exe)
            (j_out,) = exe.run(j_prog, feed=infer_feed,
                               fetch_list=j_fetches)
        np.testing.assert_allclose(out, np.asarray(j_out), rtol=1e-4,
                                   atol=1e-5)


def _layer_programs(layers, name):
    """One small program calling layer ``name`` of ``layers`` (either
    package's ``fluid.layers``)."""
    x = layers.data(name="x", shape=[4, 6], dtype="float32")
    if name == "matmul":
        y = layers.data(name="y", shape=[6, 3], dtype="float32")
        return layers.matmul(x, y, transpose_x=False, alpha=0.5)
    if name == "matmul_t":
        return layers.matmul(x, x, transpose_y=True)
    if name == "mul":
        y = layers.data(name="y", shape=[6, 3], dtype="float32")
        return layers.mul(x, y, x_num_col_dims=2)
    if name == "log_softmax":
        return layers.log_softmax(x, axis=1)
    if name == "unsqueeze":
        return layers.unsqueeze(x, axes=[1, 3])
    if name == "expand":
        return layers.expand(x, expand_times=[1, 2, 3])
    if name.startswith("reduce_"):
        return [getattr(layers, name)(x),
                getattr(layers, name)(x, dim=[1, -1], keep_dim=True),
                getattr(layers, name)(x, dim=2)]
    if name == "topk":
        return layers.topk(x, k=2)
    if name == "leaky_relu":
        return layers.leaky_relu(x, alpha=0.1)
    if name == "clip":
        return layers.clip(x, -1, 2)
    if name == "clip_by_norm":
        return layers.clip_by_norm(x, max_norm=1.5)
    if name == "pow":
        return layers.pow(x, factor=3.0)
    if name == "gaussian_random":
        return layers.gaussian_random([3, 5], mean=0.5, std=2.0, seed=7)
    if name == "autoincreased_step_counter":
        return layers.autoincreased_step_counter(begin=3, step=2)
    if name == "sums":
        return layers.sums([x, layers.scale(x, scale=2.0)])
    lens = layers.data(name="lens", shape=[1], dtype="int64")
    if name == "sequence_mask":
        return layers.sequence_mask(lens, maxlen=9)
    if name == "attention_bias_from_lens":
        return layers.nn.attention_bias_from_lens(lens, 9)
    probs = layers.softmax(x)
    label = layers.data(name="label", shape=[4, 1], dtype="int64")
    return layers.cross_entropy(probs, label)


LAYERS = ["matmul", "matmul_t", "mul", "log_softmax", "unsqueeze", "expand",
          "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
          "reduce_prod", "topk", "leaky_relu", "clip", "clip_by_norm",
          "pow", "gaussian_random", "autoincreased_step_counter", "sums",
          "sequence_mask", "attention_bias_from_lens", "cross_entropy"]


@pytest.mark.parametrize("name", LAYERS)
def test_layer_desc_matches_reference(name):
    """Each layer this slice adds appends the reference's ops, slots,
    attrs and vars (shapes inferred at build time), and is exported."""
    descs = []
    for fluid_mod, prog_cls, guard, unique in (
            (jfluid, JProgram, j_program_guard, j_unique_name),
            (tfluid, tfluid.Program, tfluid.program_guard, t_unique_name)):
        main, startup = prog_cls(), prog_cls()
        with unique.guard(), guard(main, startup):
            _layer_programs(fluid_mod.layers, name)
        descs.append((main.desc.serialize_to_string(),
                      startup.desc.serialize_to_string()))
    assert descs[0] == descs[1]
    base = "matmul" if name == "matmul_t" else name
    if base not in ("attention_bias_from_lens",):
        assert hasattr(tfluid.layers, base)
