"""The port's transform framework and its level-1 attention fuse
(``paddle_tpu_torch/analysis/transforms.py``) against the JAX package's,
on the CPU, at a tiny size (2 layers, d_model 32, 2 heads, seq 16,
batch 2).

- The ``fuse-attention`` cases of ``tests/test_transforms.py``: the pass
  rewrites its composition and leaves a near miss alone, fires on the
  BERT and Transformer training programs, and returns the ORIGINAL desc
  object for a hand-fused BERT.
- Parity: on unfused BERT (training, its ``for_test`` clone, the serving
  program) and Transformer programs both packages' ``optimize_program``
  give byte-identical descs and the same report (rewrites and pruned
  ops); every transformed desc passes the port's verifier with no error,
  and the engine's dead-code elimination drops no op from it.
- ``Executor.run`` at level 1 (the default) against the JAX package's
  level 1, from the JAX package's startup state carried by name, at
  dropout 0 (each package draws its dropout from its own RNG): losses and
  fetches rtol 1e-5, float32 on both sides. The port at level 0 (the
  composition: ``matmul``, ``softmax``, the lengths mask) against its own
  level 1: losses rtol 1e-5.
- Levels 2 and 3 run: their transformed descs are the reference's.
"""

import json
import tempfile

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.analysis import optimize_program as j_optimize_program
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.models import bert as j_bert
from paddle_tpu.models import transformer as j_transformer

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert, inference
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.analysis import optimize_program, verify_program
from paddle_tpu_torch.analysis.transforms import AttentionFusePass
from paddle_tpu_torch.engine.lowering import BlockProgram
from paddle_tpu_torch.framework import Program
from paddle_tpu_torch.models import bert as t_bert
from paddle_tpu_torch.models import transformer as t_transformer

BERT = dict(batch_size=2, seq_len=16, vocab_size=100, d_model=32,
            n_layers=2, n_heads=2, d_inner=64, lr=1e-3, max_position=64)
NMT = dict(batch_size=2, seq_len=16, vocab_size=100, d_model=32, n_heads=2,
           d_inner=64, n_layers=2, lr=1e-3)
STEPS = 3
LOSS_RTOL = 1e-5
SERVE_FEEDS = ["src_ids", "pos_ids", "sent_ids", "seq_lens"]


def _op_types(desc):
    return [op.type for op in desc.block(0).ops]


def _build_unfused_attention(program_cls, extra_scores_reader=False):
    """The raw inference composition the pass targets (the reference
    test's builder, against either package's Program)."""
    prog = program_cls()
    b = prog.global_block()
    for name in ("q", "k", "v"):
        b.create_var(name=name, shape=[2, 2, 8, 4], dtype="float32")
    b.create_var(name="scores", shape=[2, 2, 8, 8], dtype="float32")
    b.create_var(name="probs", shape=[2, 2, 8, 8], dtype="float32")
    b.create_var(name="out", shape=[2, 2, 8, 4], dtype="float32")
    b.append_op(type="matmul", inputs={"X": ["q"], "Y": ["k"]},
                outputs={"Out": ["scores"]},
                attrs={"transpose_X": False, "transpose_Y": True,
                       "alpha": 0.5})
    b.append_op(type="softmax", inputs={"X": ["scores"]},
                outputs={"Out": ["probs"]}, attrs={"axis": -1})
    b.append_op(type="matmul", inputs={"X": ["probs"], "Y": ["v"]},
                outputs={"Out": ["out"]},
                attrs={"transpose_X": False, "transpose_Y": False,
                       "alpha": 1.0})
    fetches = ["out"]
    if extra_scores_reader:
        b.create_var(name="peek", shape=[2, 2, 8, 8], dtype="float32")
        b.append_op(type="scale", inputs={"X": ["scores"]},
                    outputs={"Out": ["peek"]}, attrs={"scale": 1.0})
        fetches.append("peek")
    return prog, fetches


def test_attention_fuse_must_rewrite():
    prog, fetches = _build_unfused_attention(Program)
    desc, report = optimize_program(
        prog, level=1, feed_names=["q", "k", "v"], fetch_names=fetches)
    assert report.rewrites.get("fuse-attention") == 1
    types = _op_types(desc)
    assert types.count("fused_attention") == 1
    assert "softmax" not in types and "matmul" not in types
    fused = [op for op in desc.block(0).ops
             if op.type == "fused_attention"][0]
    assert fused.attrs["scale"] == 0.5
    assert fused.output("Out") == ["out"]  # fetch name preserved
    rep = verify_program(desc, feed_names=["q", "k", "v"],
                         fetch_names=fetches)
    assert not rep.errors
    j_prog, _ = _build_unfused_attention(JProgram)
    j_desc, _ = j_optimize_program(
        j_prog, level=1, feed_names=["q", "k", "v"], fetch_names=fetches)
    assert desc.serialize_to_string() == j_desc.serialize_to_string()


def test_attention_fuse_near_miss_extra_reader():
    # scores feeds a second consumer -> fusing would lose its value
    prog, fetches = _build_unfused_attention(Program, True)
    desc, report = optimize_program(
        prog, level=1, feed_names=["q", "k", "v"], fetch_names=fetches)
    assert report.rewrites.get("fuse-attention", 0) == 0
    assert "fused_attention" not in _op_types(desc)
    assert desc is prog.desc


def test_attention_fuse_crash_discards_clone(monkeypatch):
    """A pass that raises is recorded and its clone dropped: the original
    desc comes back untouched."""
    prog, fetches = _build_unfused_attention(Program)
    before = prog.desc.serialize_to_string()

    def boom(self, desc, ctx):
        desc.block(0).ops.clear()
        raise RuntimeError("boom")

    monkeypatch.setattr(AttentionFusePass, "apply", boom)
    desc, report = optimize_program(prog, level=1, fetch_names=fetches)
    assert desc is prog.desc
    assert "fuse-attention" in report.crashed
    assert prog.desc.serialize_to_string() == before


def _bert(package, dropout=0.0, fused=False, is_train=True):
    guard, mod = ((j_unique_name.guard, j_bert) if package == "jax"
                  else (t_unique_name.guard, t_bert))
    with guard():
        return mod.get_model(dropout=dropout, is_train=is_train,
                             use_fused_attention=fused, **BERT)


def _nmt(package, dropout=0.0, fused=False):
    guard, mod = ((j_unique_name.guard, j_transformer) if package == "jax"
                  else (t_unique_name.guard, t_transformer))
    with guard():
        return mod.get_model(dropout=dropout, use_fused_attention=fused,
                             **NMT)


def _programs(package, kind, dropout):
    """(program, feed names, fetch names) of one kind of program."""
    if kind == "bert_train":
        main, _, h = _bert(package, dropout)
        feeds = sorted(t_bert.make_fake_batch(2, 16, 100, 2))
        return main, feeds, [h["loss"].name]
    if kind == "bert_for_test":
        main, _, h = _bert(package, dropout)
        feeds = sorted(t_bert.make_fake_batch(2, 16, 100, 2))
        return main.clone(for_test=True), feeds, [h["loss"].name]
    if kind == "bert_serve":
        main, _, h = _bert(package, dropout, is_train=False)
        return main, SERVE_FEEDS, [h["enc_out"].name]
    main, _, h = _nmt(package, dropout)
    feeds = sorted(t_transformer.make_fake_batch(2, 16, 100))
    return main, feeds, [h["loss"].name]


# rewrites a program: 2 BERT layers; the Transformer's 2 encoder self- and
# 2 decoder cross-attentions (its 2 causal self-attentions are emitted
# fused whatever is asked: the composition has no causal mask)
REWRITES = {"bert_train": 2, "bert_for_test": 2, "bert_serve": 2,
            "nmt_train": 4}


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("kind", sorted(REWRITES))
def test_transformed_desc_matches_reference(kind, dropout):
    """The transformed desc is the reference's byte for byte, with the
    same report, and the port's verifier finds no error in it."""
    t_prog, feeds, fetches = _programs("torch", kind, dropout)
    j_prog, _, _ = _programs("jax", kind, dropout)
    assert t_prog.desc.serialize_to_string() == \
        j_prog.desc.serialize_to_string()
    t_desc, t_rep = optimize_program(t_prog, level=1, feed_names=feeds,
                                     fetch_names=fetches)
    j_desc, j_rep = j_optimize_program(j_prog, level=1, feed_names=feeds,
                                       fetch_names=fetches)
    assert t_rep.rewrites == j_rep.rewrites == {
        "fuse-attention": REWRITES[kind]}
    assert t_rep.pruned == j_rep.pruned and not t_rep.crashed
    assert json.loads(t_desc.serialize_to_string()) == json.loads(
        j_desc.serialize_to_string())
    assert t_desc.serialize_to_string() == j_desc.serialize_to_string()
    types = _op_types(t_desc)
    fused = REWRITES[kind] + (2 if kind == "nmt_train" else 0)
    assert types.count("fused_attention") == fused
    assert types.count("fused_attention_grad") == (
        fused if kind.endswith("train") else 0)
    assert "softmax" not in types and "sequence_mask" not in types
    rep = verify_program(t_desc, feed_names=feeds, fetch_names=fetches)
    assert not rep.errors, rep.render()
    # the transform's pruning and the engine's dead-code elimination
    # agree: the engine drops nothing more from the desc that runs
    ops = [op for op in t_desc.block(0).ops
           if op.type not in ("feed", "fetch")]
    assert BlockProgram(t_desc.block(0), feeds, fetches).ops == ops
    # the original desc is never mutated
    assert t_prog.desc.serialize_to_string() == \
        j_prog.desc.serialize_to_string()


def test_level1_is_identity_on_hand_fused_bert():
    main, _, h = _bert("torch", fused=True)
    desc, report = optimize_program(main, level=1,
                                    fetch_names=[h["loss"].name])
    assert report.total == 0
    assert desc is main.desc


@pytest.mark.parametrize("level", [2, 3])
def test_unported_levels_raise(level):
    """Levels 2 and 3 raised until the level-2 passes and the memory
    planner were ported; now neither ``optimize_program`` nor the
    executor raises there: the transformed desc and the report are the
    reference's, and a step runs (tests/test_torch_transforms_level2.py
    holds the levels in full)."""
    main, _, h = _bert("torch")
    j_main, _, j_h = _bert("jax")
    desc, report = optimize_program(main, level=level,
                                    fetch_names=[h["loss"].name])
    j_desc, j_report = j_optimize_program(j_main, level=level,
                                          fetch_names=[j_h["loss"].name])
    assert desc.serialize_to_string() == j_desc.serialize_to_string()
    assert report.rewrites == j_report.rewrites and not report.crashed
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    _, startup, _ = _bert("torch")
    with tfluid.scope_guard(scope):
        exe.run(startup)
        (loss,) = exe.run(main, feed=t_bert.make_fake_batch(2, 16, 100, 2),
                          fetch_list=[h["loss"]], opt_level=level)
    assert np.isfinite(loss).all()


def _feed(kind):
    rng = np.random.RandomState(3)
    if kind == "nmt_train":
        return t_transformer.make_fake_batch(2, 16, 100, rng=rng,
                                             varlen=True)
    return t_bert.make_fake_batch(2, 16, 100, rng=rng, varlen=True)


def _jax_steps(kind):
    """The JAX package's startup, then STEPS runs at its level 1:
    (startup state, fetches of each step)."""
    build = _nmt if kind == "nmt_train" else _bert
    main, startup, h = build("jax")
    feed = _feed(kind)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    fetch = [h["loss"].name]
    if kind == "bert_train":
        fetch.append(h["enc_out"].name)
    outs = []
    with jfluid.scope_guard(scope):
        exe.run(startup)
        state = {n: np.array(scope.get(n)) for n in names}
        for _ in range(STEPS):
            outs.append([np.asarray(o) for o in exe.run(
                main, feed=feed, fetch_list=fetch, opt_level=1)])
    return feed, state, fetch, outs


def _port_steps(kind, feed, state, fetch, opt_level=None):
    build = _nmt if kind == "nmt_train" else _bert
    main, _, _ = build("torch")
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, state, "cpu", program=main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        return exe, [exe.run(main, feed=feed, fetch_list=fetch,
                             opt_level=opt_level) for _ in range(STEPS)]


@pytest.mark.parametrize("kind", ["bert_train", "nmt_train"])
def test_level1_steps_match_reference(kind):
    """Losses (and BERT's encoder output) of 3 Adam steps at the default
    level against the JAX package's level 1; then the port's level 0
    against its level 1."""
    feed, state, fetch, want = _jax_steps(kind)
    obs.set_enabled(True)
    obs.reset()
    try:
        exe, got = _port_steps(kind, feed, state, fetch)
        counters = obs.snapshot()["counters"]
    finally:
        obs.reset()
        obs.set_enabled(None)
    assert counters["transform.fuse-attention.rewrites"] == REWRITES[kind]
    assert counters["transform.pruned_ops"] > 0
    (bp,) = exe.engine._blocks.values()
    types = [op.type for op in bp.ops]
    assert "matmul" not in types and "softmax" not in types
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=1e-6)
    _, level0 = _port_steps(kind, feed, state, fetch[:1], opt_level=0)
    np.testing.assert_allclose([s[0] for s in level0],
                               [s[0] for s in got], rtol=LOSS_RTOL)


def test_for_test_clone_matches_reference():
    """The ``for_test`` clone of an unfused training program at dropout
    0.1, run at level 1 in both packages: the dropout ops are off and
    the loss agrees."""
    j_main, j_startup, j_h = _bert("jax", 0.1)
    feed = _feed("bert_train")
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    names = sorted(v.name for v in j_main.list_vars() if v.persistable)
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
        state = {n: np.array(scope.get(n)) for n in names}
        (want,) = exe.run(j_main.clone(for_test=True), feed=feed,
                          fetch_list=[j_h["loss"]], opt_level=1)
    t_main, _, t_h = _bert("torch", 0.1)
    t_scope = tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    with tfluid.scope_guard(t_scope):
        (got,) = tfluid.Executor(tfluid.CPUPlace()).run(
            t_main.clone(for_test=True), feed=feed,
            fetch_list=[t_h["loss"]])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_predictor_switch_ir_optim():
    """A served unfused BERT runs fused at the default level (through
    ``run`` and the continuous-batching server) and as the composition
    after ``switch_ir_optim(False)``; the answers agree (dropout is off
    when serving)."""
    main, startup, h = _bert("torch", 0.1, is_train=False)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    batch = t_bert.make_fake_batch(2, 16, 100, varlen=True)
    feed = {k: batch[k] for k in SERVE_FEEDS}
    answers = {}
    with tfluid.scope_guard(scope), \
            tempfile.TemporaryDirectory(prefix="bert_") as d:
        exe.run(startup)
        tfluid.io.save_inference_model(d, SERVE_FEEDS, [h["enc_out"]], exe,
                                       main_program=main)
        for ir_optim in (True, False):
            cfg = inference.AnalysisConfig(d)
            cfg.disable_gpu()
            cfg.switch_ir_optim(ir_optim)
            pred = inference.create_paddle_predictor(cfg)
            (out,) = pred.run(feed)
            (bp,) = pred._exe.engine._blocks.values()
            types = [op.type for op in bp.ops]
            assert ("fused_attention" in types) == ir_optim
            assert ("matmul" in types) != ir_optim
            with pred.serve(buckets=(2,), max_wait_ms=1.0) as srv:
                assert srv.opt_level == (None if ir_optim else 0)
                (served,) = srv.run(feed)
            np.testing.assert_allclose(served, out.data, rtol=1e-5,
                                       atol=1e-6)
            answers[ir_optim] = out.data
    np.testing.assert_allclose(answers[True], answers[False], rtol=1e-4,
                               atol=1e-5)
