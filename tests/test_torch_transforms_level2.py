"""The port's transforms at levels 2 to 4 (``paddle_tpu_torch/analysis/
transforms.py``: fuse-elemwise-act, fold-constants, cse; level 3's
pipeline and level 4's, whose layout pass needs a scope and is held by
tests/test_torch_layout.py) against the JAX package's, on the CPU, at a
tiny size (a 2-layer BERT at hidden size 64, seq 16, batch 2; LeNet at 8
and 16 filters, batch 4).

- Each level-2 pass's must-rewrite case and its near miss
  (tests/test_transforms.py), built the same way in both packages:
  byte-identical transformed descs, the same rewrite counts, and the
  same fetched values (exactly: the fused op runs the registered
  component lowerings, the fold the port's own).
- BERT (training, its serving program) and LeNet (training, its
  ``for_test`` clone) at levels 2, 3 and 4: byte-identical descs and
  reports in both packages, and no crashed pass.
- Outputs at level 2 against the JAX package's level 2 from the same
  state: BERT served (``enc_out``, where the elementwise fusion fires)
  and one LeNet Adam step (loss), rtol 1e-5.
- The ``fused_elemwise_activation`` lowering against the JAX one, for
  each fusable activation: rtol 1e-6, atol 1e-6 (the two erf's round
  otherwise near 0); against the port's own unfused add + activation:
  exactly equal.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import nets as j_nets
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.analysis import optimize_program as j_optimize
from paddle_tpu.core.registry import OpRegistry as JOpRegistry
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import convert_np_dtype_to_dtype_ as j_dtype
from paddle_tpu.models import bert as j_bert

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import nets as t_nets
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.analysis import optimize_program, verify_program
from paddle_tpu_torch.core.registry import OpRegistry
from paddle_tpu_torch.framework import Program
from paddle_tpu_torch.framework import convert_np_dtype_to_dtype_ as t_dtype
from paddle_tpu_torch.models import bert as t_bert

OUT_RTOL = 1e-5
# the lowerings this file holds against the JAX package's
SLICE_OPS = {"fused_elemwise_activation"}
BERT = dict(batch_size=2, seq_len=16, vocab_size=100, d_model=64,
            n_layers=2, n_heads=2, d_inner=128, lr=1e-3, max_position=64,
            dropout=0.0)
SERVE_FEEDS = ["src_ids", "pos_ids", "sent_ids", "seq_lens"]


def _pkg(pkg):
    if pkg == "jax":
        return jfluid, JProgram, j_dtype, j_optimize
    return tfluid, Program, t_dtype, optimize_program


def _fill(block, dtype_of, name, shape=(4,), value=0.0, persistable=False,
          dtype="float32"):
    block.create_var(name=name, shape=list(shape), dtype=dtype,
                     persistable=persistable)
    block.append_op(
        type="fill_constant", outputs={"Out": [name]},
        attrs={"shape": list(shape), "dtype": int(dtype_of(dtype)),
               "value": value})


def _add_act(pkg, extra_sum_reader=False):
    _, prog_cls, dtype_of, _ = _pkg(pkg)
    prog = prog_cls()
    b = prog.global_block()
    _fill(b, dtype_of, "x", value=1.0)
    _fill(b, dtype_of, "y", value=-2.0)
    b.create_var(name="s", shape=[4], dtype="float32")
    b.create_var(name="out", shape=[4], dtype="float32")
    b.append_op(type="elementwise_add", inputs={"X": ["x"], "Y": ["y"]},
                outputs={"Out": ["s"]}, attrs={"axis": -1})
    b.append_op(type="relu", inputs={"X": ["s"]}, outputs={"Out": ["out"]})
    fetches = ["out"]
    if extra_sum_reader:
        b.create_var(name="peek", shape=[4], dtype="float32")
        b.append_op(type="scale", inputs={"X": ["s"]},
                    outputs={"Out": ["peek"]}, attrs={"scale": 1.0})
        fetches.append("peek")
    return prog, fetches


def _fold_chain(pkg, persistable=False):
    """fill_constant -> add -> scale; the near miss writes a persistable."""
    _, prog_cls, dtype_of, _ = _pkg(pkg)
    prog = prog_cls()
    b = prog.global_block()
    _fill(b, dtype_of, "a", value=2.0)
    if persistable:
        b.create_var(name="r", shape=[4], dtype="float32", persistable=True)
        b.append_op(type="scale", inputs={"X": ["a"]},
                    outputs={"Out": ["r"]}, attrs={"scale": 2.0, "bias": 0.0})
        return prog, ["r"]
    _fill(b, dtype_of, "c", value=3.0)
    b.create_var(name="s", shape=[4], dtype="float32")
    b.create_var(name="r", shape=[4], dtype="float32")
    b.append_op(type="elementwise_add", inputs={"X": ["a"], "Y": ["c"]},
                outputs={"Out": ["s"]})
    b.append_op(type="scale", inputs={"X": ["s"]}, outputs={"Out": ["r"]},
                attrs={"scale": 2.0, "bias": 0.0})
    return prog, ["r"]


def _fold_int64(pkg):
    """Two int64 fill_constants into an elementwise_add: the fold writes
    the reference's INT32 fill (the desc rule), the value stays int64 in
    the port."""
    _, prog_cls, dtype_of, _ = _pkg(pkg)
    prog = prog_cls()
    b = prog.global_block()
    _fill(b, dtype_of, "a", value=2, dtype="int64")
    _fill(b, dtype_of, "c", value=3, dtype="int64")
    b.create_var(name="s", shape=[4], dtype="int64")
    b.append_op(type="elementwise_add", inputs={"X": ["a"], "Y": ["c"]},
                outputs={"Out": ["s"]})
    return prog, ["s"]


def _cse(pkg, second_scale=2.0):
    _, prog_cls, dtype_of, _ = _pkg(pkg)
    prog = prog_cls()
    b = prog.global_block()
    _fill(b, dtype_of, "x", value=1.5)
    for name in ("a", "b", "c"):
        b.create_var(name=name, shape=[4], dtype="float32")
    b.append_op(type="scale", inputs={"X": ["x"]}, outputs={"Out": ["a"]},
                attrs={"scale": 2.0, "bias": 0.0})
    b.append_op(type="scale", inputs={"X": ["x"]}, outputs={"Out": ["b"]},
                attrs={"scale": second_scale, "bias": 0.0})
    b.append_op(type="elementwise_add", inputs={"X": ["a"], "Y": ["b"]},
                outputs={"Out": ["c"]})
    return prog, ["c"]


_CASES = {
    "fuse_act": (lambda pkg: _add_act(pkg), "fuse-elemwise-act", 1),
    "fuse_act_near_miss": (lambda pkg: _add_act(pkg, True),
                           "fuse-elemwise-act", 0),
    "fold": (lambda pkg: _fold_chain(pkg), "fold-constants", 2),
    "fold_near_miss": (lambda pkg: _fold_chain(pkg, True),
                       "fold-constants", 0),
    "fold_int64": (_fold_int64, "fold-constants", 1),
    "cse": (lambda pkg: _cse(pkg), "cse", 1),
    "cse_near_miss": (lambda pkg: _cse(pkg, 3.0), "cse", 0),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_level2_pass_matches_reference(case):
    build, name, n = _CASES[case]
    outs = {}
    for pkg in ("jax", "torch"):
        fluid, _, _, optimize = _pkg(pkg)
        prog, fetches = build(pkg)
        desc, report = optimize(prog, level=2, fetch_names=fetches)
        assert report.rewrites.get(name, 0) == n, report.render()
        assert not report.crashed
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            vals = exe.run(prog, fetch_list=fetches, opt_level=2)
        outs[pkg] = (desc.serialize_to_string(), report.rewrites,
                     [np.asarray(v) for v in vals])
    assert outs["torch"][0] == outs["jax"][0]
    assert outs["torch"][1] == outs["jax"][1]
    for got, want in zip(outs["torch"][2], outs["jax"][2]):
        np.testing.assert_array_equal(got, want)
    prog, fetches = build("torch")
    desc, _ = optimize_program(prog, level=2, fetch_names=fetches)
    assert not verify_program(desc, fetch_names=fetches).errors
    # the port's folded program fetches the dtypes its unfolded one does
    with tfluid.scope_guard(tfluid.Scope()):
        plain = tfluid.Executor(tfluid.CPUPlace()).run(
            prog, fetch_list=fetches, opt_level=0)
    assert [v.dtype for v in outs["torch"][2]] == [v.dtype for v in plain]


def _bert(pkg, is_train=True):
    guard, mod = ((j_unique_name.guard, j_bert) if pkg == "jax"
                  else (t_unique_name.guard, t_bert))
    with guard():
        return mod.get_model(is_train=is_train, use_fused_attention=False,
                             **BERT)


def _lenet(pkg):
    fluid, nets, guard = ((jfluid, j_nets, j_unique_name.guard)
                          if pkg == "jax" else
                          (tfluid, t_nets, t_unique_name.guard))
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        c1 = nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=8, pool_size=2,
            pool_stride=2, act="relu")
        c2 = nets.simple_img_conv_pool(
            input=c1, filter_size=5, num_filters=16, pool_size=2,
            pool_stride=2, act="relu")
        pred = fluid.layers.fc(input=c2, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=2e-3).minimize(loss)
    return main, startup, test, pred, loss


def _programs(pkg, kind):
    if kind == "bert_train":
        main, _, h = _bert(pkg)
        return main, sorted(t_bert.make_fake_batch(2, 16, 100, 2)), \
            [h["loss"].name]
    if kind == "bert_serve":
        main, _, h = _bert(pkg, is_train=False)
        return main, SERVE_FEEDS, [h["enc_out"].name]
    main, _, test, pred, loss = _lenet(pkg)
    if kind == "lenet_train":
        return main, ["img", "label"], [loss.name]
    return test, ["img"], [pred.name]


@pytest.mark.parametrize("level", [2, 3, 4])
@pytest.mark.parametrize("kind", ["bert_train", "bert_serve", "lenet_train",
                                  "lenet_test"])
def test_model_descs_match_reference(kind, level):
    j_prog, feeds, fetches = _programs("jax", kind)
    t_prog, _, _ = _programs("torch", kind)
    j_desc, j_rep = j_optimize(j_prog, level=level, feed_names=feeds,
                               fetch_names=fetches)
    t_desc, t_rep = optimize_program(t_prog, level=level, feed_names=feeds,
                                     fetch_names=fetches)
    assert not t_rep.crashed and not j_rep.crashed
    assert t_rep.rewrites == j_rep.rewrites
    assert t_rep.pruned == j_rep.pruned
    assert t_desc.serialize_to_string() == j_desc.serialize_to_string()
    if kind == "bert_serve":
        assert t_rep.rewrites.get("fuse-elemwise-act", 0) > 0


def _jax_state(main, startup):
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    return {v.name: np.array(scope.get(v.name))
            for v in main.list_vars() if v.persistable}


def test_level2_outputs_match_reference():
    """BERT served and one LeNet Adam step at level 2 in both packages
    from the JAX package's startup state."""
    rng = np.random.RandomState(3)
    batch = t_bert.make_fake_batch(2, 16, 100, rng=rng, varlen=True)
    serve_feed = {k: batch[k] for k in SERVE_FEEDS}
    lenet_feed = {"img": rng.rand(4, 1, 28, 28).astype(np.float32),
                  "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    cases = [("bert", serve_feed), ("lenet", lenet_feed)]
    for kind, feed in cases:
        if kind == "bert":
            j_main, j_startup, j_h = _bert("jax", is_train=False)
            t_main, _, t_h = _bert("torch", is_train=False)
            fetch = [j_h["enc_out"].name]
        else:
            j_main, j_startup, _, _, j_loss = _lenet("jax")
            t_main, _, _, _, _ = _lenet("torch")
            fetch = [j_loss.name]
        state = _jax_state(j_main, j_startup)
        j_scope = jfluid.Scope()
        for n, v in state.items():
            j_scope.set(n, v)
        with jfluid.scope_guard(j_scope):
            (want,) = jfluid.Executor(jfluid.CPUPlace()).run(
                j_main, feed=feed, fetch_list=fetch, opt_level=2)
        t_scope = tfluid.Scope()
        convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
        with tfluid.scope_guard(t_scope):
            (got,) = tfluid.Executor(tfluid.CPUPlace()).run(
                t_main, feed=feed, fetch_list=fetch, opt_level=2)
        np.testing.assert_allclose(got, np.asarray(want), rtol=OUT_RTOL,
                                   atol=1e-6, err_msg=kind)


@pytest.mark.parametrize("act", ["relu", "gelu", "tanh", "sigmoid"])
def test_fused_elemwise_activation_matches_reference(act):
    import jax

    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 8).astype(np.float32)
    y = rng.randn(8).astype(np.float32)
    attrs = {"functor_list": ["elementwise_add", act], "axis": -1}
    want = JOpRegistry.get("fused_elemwise_activation").lower(
        None, {"X": [jax.numpy.asarray(x)], "Y": [jax.numpy.asarray(y)]},
        attrs)["Out"][0]
    got = OpRegistry.get("fused_elemwise_activation").lower(
        None, {"X": [torch.from_numpy(x)], "Y": [torch.from_numpy(y)]},
        attrs)["Out"][0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    unfused = OpRegistry.get(act).lower(None, {"X": [
        torch.from_numpy(x) + torch.from_numpy(y)]}, {})["Out"][0]
    np.testing.assert_array_equal(got.numpy(), unfused.numpy())
