"""``metrics.py`` and ``nets.py`` of the port against the JAX package's,
and the streaming ``auc`` layer in a training program, on the CPU.

- Each host-side accumulator (``Accuracy``, ``Precision``, ``Recall``,
  ``Auc``, ``EditDistance``, ``ChunkEvaluator``, ``CompositeMetric``)
  gives the reference's values, exactly, on the same seeded updates, and
  ``reset`` empties both alike.
- Each ``nets`` function builds a main and a startup desc byte-identical
  to the reference's; ``scaled_dot_product_attention`` is one
  ``fused_attention`` op in both, and the port runs it on the CPU as the
  reference does (rtol 1e-5 / atol 1e-6). ``sequence_conv_pool`` raises
  until ``sequence_conv`` is ported.
- A tiny DeepFM (``models.deepfm``) with ``layers.auc`` on its
  predictions: the same descs; 3 Adam steps on each executor from the
  reference's startup state: the histograms equal, the AUC rtol 1e-5 and
  the loss rtol 1e-5 at every step. The port's own startup program fills
  the histograms as int64, the layer's dtype (the JAX package runs them
  as int32, its 64-bit types being off), and a step keeps them so.
"""

import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import metrics as j_metrics
from paddle_tpu import nets as j_nets
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as j_program_guard
from paddle_tpu.models import deepfm as j_deepfm

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import metrics as t_metrics
from paddle_tpu_torch import nets as t_nets
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.models import deepfm as t_deepfm

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                               "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

RTOL, ATOL = 1e-5, 1e-6


def _updates(name, rng):
    """Three seeded update argument tuples for metric ``name``."""
    out = []
    for _ in range(3):
        if name == "Accuracy":
            out.append((float(rng.rand()), int(rng.randint(1, 9))))
        elif name in ("Precision", "Recall"):
            out.append((rng.rand(16), rng.randint(0, 2, 16)))
        elif name == "Auc":
            p = rng.rand(32)
            out.append((np.stack([1 - p, p], 1), rng.randint(0, 2, (32, 1))))
        elif name == "EditDistance":
            out.append((rng.randint(0, 3, (6, 1)).astype(np.float32), 6))
        else:
            n_inf, n_lab = rng.randint(1, 20, 2)
            out.append((n_inf, n_lab, rng.randint(0, min(n_inf, n_lab))))
    return out


METRICS = ["Accuracy", "Precision", "Recall", "Auc", "EditDistance",
           "ChunkEvaluator"]


@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_reference(name):
    rng = np.random.RandomState(METRICS.index(name))
    j_m, t_m = getattr(j_metrics, name)(), getattr(t_metrics, name)()
    for args in _updates(name, rng):
        j_m.update(*args)
        t_m.update(*args)
        assert t_m.eval() == j_m.eval()
    j_m.reset()
    t_m.reset()
    if name == "Auc":
        assert t_m.eval() == j_m.eval() == 0.0
    else:
        assert vars(t_m) == vars(j_m)


def test_composite_metric_matches_reference():
    rng = np.random.RandomState(7)
    metrics = []
    for mod in (j_metrics, t_metrics):
        m = mod.CompositeMetric()
        m.add_metric(mod.Precision())
        m.add_metric(mod.Recall())
        metrics.append(m)
    for args in _updates("Precision", rng):
        for m in metrics:
            m.update(*args)
    assert metrics[1].eval() == metrics[0].eval()
    assert t_metrics.__all__ == j_metrics.__all__


def _nets_program(fluid, name):
    layers, nets = fluid.layers, fluid.nets
    img = layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    if name == "simple_img_conv_pool":
        return nets.simple_img_conv_pool(img, num_filters=4, filter_size=3,
                                         pool_size=2, pool_stride=2,
                                         act="relu")
    if name == "img_conv_group":
        return nets.img_conv_group(img, conv_num_filter=[4, 4],
                                   pool_size=2, conv_act="relu",
                                   conv_with_batchnorm=[True, False],
                                   conv_batchnorm_drop_rate=0.2,
                                   pool_stride=2)
    seq = layers.data(name="seq", shape=[5, 8], dtype="float32")
    if name == "glu":
        return nets.glu(seq, dim=-1)
    return nets.scaled_dot_product_attention(seq, seq, seq, num_heads=2)


NETS = ["simple_img_conv_pool", "img_conv_group", "glu",
        "scaled_dot_product_attention"]
FRONT_ENDS = ((jfluid, JProgram, j_program_guard, j_unique_name),
              (tfluid, tfluid.Program, tfluid.program_guard, t_unique_name))


@pytest.mark.parametrize("name", NETS)
def test_nets_desc_matches_reference(name):
    descs = []
    for fluid_mod, prog_cls, guard, unique in FRONT_ENDS:
        main, startup = prog_cls(), prog_cls()
        with unique.guard(), guard(main, startup):
            _nets_program(fluid_mod, name)
        descs.append((main.desc.serialize_to_string(),
                      startup.desc.serialize_to_string()))
        if name == "scaled_dot_product_attention":
            types = [op.type for op in main.desc.global_block().ops]
            assert types.count("fused_attention") == 1, types
    assert descs[0] == descs[1]
    assert t_nets.__all__ == j_nets.__all__


def test_nets_attention_runs_as_the_reference():
    """``scaled_dot_product_attention`` answers as the reference's on the
    same state and input (both at the default opt level)."""
    outs = []
    feed = {"seq": np.random.RandomState(3).randn(2, 5, 8).astype(
        np.float32)}
    for fluid_mod, prog_cls, guard, unique in FRONT_ENDS:
        main, startup = prog_cls(), prog_cls()
        with unique.guard(), guard(main, startup):
            out = _nets_program(fluid_mod, "scaled_dot_product_attention")
        with fluid_mod.scope_guard(fluid_mod.Scope()):
            exe = fluid_mod.Executor(fluid_mod.CPUPlace())
            exe.run(startup)
            outs.append(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[out])[0]))
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)


def test_sequence_conv_pool_raises_until_sequence_conv():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        seq = tfluid.layers.data(name="seq", shape=[5, 8], dtype="float32")
        with pytest.raises(NotImplementedError, match="5d"):
            t_nets.sequence_conv_pool(seq, num_filters=4, filter_size=3)


CTR = dict(batch_size=16, num_features=200, num_fields=5, embed_dim=4,
           lr=0.05)


def _ctr_auc(fluid_mod, deepfm, unique):
    with unique.guard():
        main, startup, h = deepfm.get_model(**CTR)
        value, _, stats = chip_smoke.with_auc(fluid_mod, main, startup,
                                              h["pred"], h["label"])
    return main, startup, h["loss"], value, stats


def test_deepfm_auc_matches_reference():
    j_main, j_startup, j_loss, j_auc, j_stats = _ctr_auc(
        jfluid, j_deepfm, j_unique_name)
    t_main, t_startup, t_loss, t_auc, t_stats = _ctr_auc(
        tfluid, t_deepfm, t_unique_name)
    assert t_main.desc.serialize_to_string() == \
        j_main.desc.serialize_to_string()
    assert t_startup.desc.serialize_to_string() == \
        j_startup.desc.serialize_to_string()
    rng = np.random.RandomState(9)
    batches = [t_deepfm.make_fake_batch(CTR["batch_size"],
                                        CTR["num_features"],
                                        CTR["num_fields"], rng)
               for _ in range(3)]
    fetch = [j_loss.name, j_auc.name] + [v.name for v in j_stats]

    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    names = sorted(v.name for v in j_main.list_vars() if v.persistable)
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
        state = {n: np.array(scope.get(n)) for n in names}
        want = [exe.run(j_main, feed=b, fetch_list=fetch) for b in batches]
    # the reference's scope holds the histograms as int32, as the desc
    # says after its build-time inference; the port's own startup makes
    # them int64 (test_auc_stats_start_int64)
    t_scope = tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    t_exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(t_scope):
        got = [t_exe.run(t_main, feed=b, fetch_list=fetch) for b in batches]
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g[0]).reshape(()),
                                   np.asarray(w[0]).reshape(()), rtol=RTOL,
                                   err_msg="loss, step %d" % step)
        np.testing.assert_allclose(np.asarray(g[1]), np.asarray(w[1]),
                                   rtol=RTOL, err_msg="auc, step %d" % step)
        for gs, ws in zip(g[2:], w[2:]):
            np.testing.assert_array_equal(gs, np.asarray(ws))
    assert int(np.asarray(got[-1][2]).sum() + np.asarray(got[-1][3]).sum()) \
        == 3 * CTR["batch_size"]


def test_auc_stats_start_int64():
    """The startup program of a program with ``layers.auc`` fills both
    histograms as int64 zeros, and a step keeps them int64."""
    main, startup, loss, _, stats = _ctr_auc(tfluid, t_deepfm,
                                             t_unique_name)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    batch = t_deepfm.make_fake_batch(CTR["batch_size"], CTR["num_features"],
                                     CTR["num_fields"],
                                     np.random.RandomState(4))
    with tfluid.scope_guard(scope):
        exe.run(startup)
        for v in stats:
            assert str(scope.get(v.name).dtype) == "torch.int64"
            assert int(scope.get(v.name).sum()) == 0
        exe.run(main, feed=batch, fetch_list=[loss])
        for v in stats:
            assert str(scope.get(v.name).dtype) == "torch.int64"
        assert sum(int(scope.get(v.name).sum()) for v in stats) == \
            CTR["batch_size"]


def _attention_program(fluid_mod, prog_cls, guard, unique, which):
    main, startup = prog_cls(), prog_cls()
    with unique.guard(), guard(main, startup):
        if which == "dot_product_attention":
            q = fluid_mod.layers.data(name="q", shape=[2, 6, 8],
                                      dtype="float32")
            out, _ = fluid_mod.layers.dot_product_attention(q, q, q)
        else:
            q = fluid_mod.layers.data(name="q", shape=[6, 8],
                                      dtype="float32")
            out = fluid_mod.nets.scaled_dot_product_attention(
                q, q, q, num_heads=2)
    return main, out


@pytest.mark.parametrize("which", ["dot_product_attention",
                                   "scaled_dot_product_attention"])
def test_attention_blocks_transform_as_the_reference(which):
    """At ``opt_level`` 1 both packages' transforms give the same desc and
    the same rewrites for the two attention blocks (``nets``' is one
    ``fused_attention`` op as built; ``dot_product_attention`` is the
    matmul-softmax-matmul chain)."""
    from paddle_tpu.analysis import optimize_program as j_optimize
    from paddle_tpu_torch.analysis import optimize_program as t_optimize

    out = []
    for fe, optimize in zip(FRONT_ENDS, (j_optimize, t_optimize)):
        main, fetch = _attention_program(*fe, which)
        desc, report = optimize(main, level=1, feed_names=["q"],
                                fetch_names=[fetch.name])
        out.append((desc.serialize_to_string(), report.rewrites))
    assert out[1] == out[0]
