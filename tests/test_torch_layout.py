"""The port's layout pass (``paddle_tpu_torch/analysis/layout.py``), its
NHWC lowerings (``ops/nn_ops.py``: conv2d, depthwise_conv2d and their
grads, pool2d, batch_norm; ``quantized_conv2d``) and the engine's layout
key, against the JAX package's, on the CPU, at a tiny size: a ResNet of 2
basic blocks at width 8 on 16x16 at batch 4 (with a depthwise conv in
the stem), LeNet at 8 filters, and a conv -> relu -> pool chain; it
mirrors tests/test_layout.py.

- ``resolved_layout_mode``'s gating, and ``auto_layout``, which changes
  nothing off a TPU in either package (the same descs and losses with it
  on and off).
- ``plan_layout`` (colors, NHWC vars, seams, weights to bake) equal to
  the JAX package's; ``apply_layout`` on the same desc and state:
  byte-identical rewritten descs and the same baked HWIO values
  (exactly), idempotent on a second apply.
- Training at ``layout=nhwc`` against NCHW in the port (losses rtol
  2e-4 for the ResNet, cuDNN-free reassociation on the CPU; 1e-5 for
  LeNet), and against the JAX package's NHWC run from the same state
  (rtol 1e-5); the filter and its optimizer twins baked together.
- The NHWC lowerings, each against its NCHW self on permuted operands:
  exactly equal (forward and grads).
- A bake puts NEW tensors into the scope (no captured graph can replay
  against the old ones: on the card the entry captures anew) and the
  cache key holds (mode, id(scope)) with the scope pinned by the entry;
  when the pass is discarded (its self-verification raises) the weights
  go back to OIHW.
- A checkpoint written under ``nhwc`` holds HWIO values: the port's,
  restored by the JAX package, and the JAX package's, restored by the
  port, train on with the same loss (rtol 1e-5).
- The INT8 program at NHWC predicts what it predicts at NCHW
  (``quantized_conv2d`` flips to NHWC; rtol 1e-5).
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import flags as j_flags
from paddle_tpu import io as j_io
from paddle_tpu import nets as j_nets
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.analysis import apply_layout as j_apply_layout
from paddle_tpu.analysis import plan_layout as j_plan_layout

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert, flags
from paddle_tpu_torch import io as t_io
from paddle_tpu_torch import nets as t_nets
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.analysis import (
    apply_layout, layout, plan_layout, resolved_layout_mode,
)
from paddle_tpu_torch.core.registry import OpRegistry

RESNET_RTOL = 2e-4
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    for f in (flags, j_flags):
        for name in ("opt_level", "layout", "auto_layout", "metrics"):
            f.reset_flag(name)


def _pkg(pkg):
    if pkg == "jax":
        return jfluid, j_nets, j_unique_name.guard, j_flags
    return tfluid, t_nets, t_unique_name.guard, flags


def _conv_bn(fluid, x, filters, stride=1, act="relu", groups=1):
    c = fluid.layers.conv2d(x, num_filters=filters, filter_size=3,
                            stride=stride, padding=1, groups=groups,
                            bias_attr=False)
    return fluid.layers.batch_norm(c, act=act)


def _resnet2(pkg):
    """A stem conv-bn-relu and a depthwise conv-bn-relu at width 8, then
    2 basic blocks (the second strided, with a 1x1 projection), global
    average pool, fc, Momentum."""
    fluid, _, guard, _ = _pkg(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 16, 16],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        x = _conv_bn(fluid, img, 8)
        x = _conv_bn(fluid, x, 8, groups=8)
        for stride in (1, 2):
            y = _conv_bn(fluid, x, 8, stride=stride)
            y = _conv_bn(fluid, y, 8, act=None)
            if stride != 1:
                x = fluid.layers.batch_norm(fluid.layers.conv2d(
                    x, num_filters=8, filter_size=1, stride=stride,
                    bias_attr=False))
            x = fluid.layers.relu(fluid.layers.elementwise_add(x, y))
        pool = fluid.layers.pool2d(x, pool_type="avg", global_pooling=True)
        pred = fluid.layers.fc(input=pool, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(loss)
    return main, startup, {"loss": loss, "pred": pred}


def _resnet_feed(rng):
    return {"img": rng.randn(4, 3, 16, 16).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}


def _lenet(pkg):
    fluid, nets, guard, _ = _pkg(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        c1 = nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=8, pool_size=2,
            pool_stride=2, act="relu")
        pred = fluid.layers.fc(input=c1, size=10, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Adam(learning_rate=2e-3).minimize(loss)
    return main, startup, {"loss": loss, "pred": pred}


def _lenet_feed(rng):
    return {"img": rng.randn(4, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}


def _chain(pkg):
    fluid, _, guard, _ = _pkg(pkg)
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3, 8, 8], dtype="float32")
        c = fluid.layers.conv2d(x, num_filters=4, filter_size=3,
                                padding=1, act="relu")
        p = fluid.layers.pool2d(c, pool_size=2, pool_type="max")
    return main, startup, {"loss": p}


_MODELS = {"resnet": (_resnet2, _resnet_feed, ["img", "label"]),
           "lenet": (_lenet, _lenet_feed, ["img", "label"]),
           "chain": (_chain, None, ["x"])}


def _jax_state(main, startup):
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    return {v.name: np.array(scope.get(v.name))
            for v in main.list_vars() if v.persistable}


def _scopes(kind):
    """The same startup state in a JAX and a port scope."""
    build = _MODELS[kind][0]
    j_main, j_startup, h = build("jax")
    t_main, _, _ = build("torch")
    state = _jax_state(j_main, j_startup)
    j_scope = jfluid.Scope()
    for n, v in state.items():
        j_scope.set(n, v)
    t_scope = tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    return j_main, t_main, h, j_scope, t_scope


def test_resolved_layout_mode_gating():
    flags.set_flags({"layout": "off"})
    assert resolved_layout_mode(4) is None
    flags.set_flags({"layout": "nhwc"})
    assert resolved_layout_mode(0) == "nhwc"
    flags.set_flags({"layout": "auto"})
    assert resolved_layout_mode(3) is None
    assert resolved_layout_mode(4) == "nhwc"
    flags.set_flags({"layout": "nchw4c"})
    assert resolved_layout_mode(4) is None


@pytest.mark.parametrize("kind", ["resnet", "lenet", "chain"])
def test_plan_matches_reference(kind):
    _, _, feeds = _MODELS[kind]
    j_main, _, h = _MODELS[kind][0]("jax")
    t_main, _, _ = _MODELS[kind][0]("torch")
    fetch = [h["loss"].name]
    a = plan_layout(t_main.desc, feed_names=feeds, fetch_names=fetch)
    b = j_plan_layout(j_main.desc, feed_names=feeds, fetch_names=fetch)
    assert a.colors == b.colors
    assert sorted(a.nhwc_vars) == sorted(b.nhwc_vars)
    assert a.seams == b.seams and a.transpose_count == b.transpose_count
    assert a.weights == b.weights and a.n_nhwc_ops == b.n_nhwc_ops
    assert a.n_nhwc_ops > 0


@pytest.mark.parametrize("kind", ["resnet", "lenet", "chain"])
def test_apply_matches_reference(kind):
    _, _, feeds = _MODELS[kind]
    j_main, t_main, h, j_scope, t_scope = _scopes(kind)
    fetch = [h["loss"].name]
    j_work, t_work = j_main.desc.clone(), t_main.desc.clone()
    jn, j_plan = j_apply_layout(j_work, feed_names=feeds,
                                fetch_names=fetch, scope=j_scope)
    tn, t_plan = apply_layout(t_work, feed_names=feeds, fetch_names=fetch,
                              scope=t_scope)
    assert tn == jn > 0
    assert t_work.serialize_to_string() == j_work.serialize_to_string()
    assert sorted(t_plan.baked_now) == sorted(j_plan.baked_now)
    assert sorted(t_scope._layout_hwio) == sorted(j_scope._layout_hwio)
    for name in t_scope._layout_hwio:
        np.testing.assert_array_equal(t_scope.get(name).numpy(),
                                      np.asarray(j_scope.get(name)))
    # idempotent against the baked scope
    _, again = apply_layout(t_main.desc.clone(), feed_names=feeds,
                            fetch_names=fetch, scope=t_scope)
    assert not again.baked_now


def _train(pkg, kind, layout_mode, steps=3, state=None, scope=None,
           auto_layout=False):
    fluid, _, _, f = _pkg(pkg)
    build, feed_fn, _ = _MODELS[kind]
    f.set_flags({"opt_level": 2, "layout": layout_mode,
                 "auto_layout": auto_layout})
    main, startup, h = build(pkg)
    exe = fluid.Executor(fluid.CPUPlace())
    if scope is None:
        scope = fluid.Scope()
        if pkg == "jax":
            for n, v in state.items():
                scope.set(n, v)
        else:
            convert.load_numpy_state(scope, state, "cpu", program=main)
    rng = np.random.RandomState(0)
    losses = []
    with fluid.scope_guard(scope):
        for _ in range(steps):
            (v,) = exe.run(main, feed=feed_fn(rng), fetch_list=[h["loss"]])
            losses.append(float(np.asarray(v).reshape(-1)[0]))
    return losses, scope, main, exe


@pytest.mark.parametrize("kind", ["resnet", "lenet"])
def test_nhwc_training_matches_nchw_and_reference(kind):
    j_main, j_startup, _ = _MODELS[kind][0]("jax")
    state = _jax_state(j_main, j_startup)
    base, _, _, _ = _train("torch", kind, "off", state=state)
    nhwc, scope, main, exe = _train("torch", kind, "nhwc", state=state)
    j_nhwc, j_scope, _, _ = _train("jax", kind, "nhwc", state=state)
    rtol = RESNET_RTOL if kind == "resnet" else LOSS_RTOL
    np.testing.assert_allclose(nhwc, base, rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(nhwc, j_nhwc, rtol=LOSS_RTOL, atol=1e-6)
    assert sorted(scope._layout_hwio) == sorted(j_scope._layout_hwio)
    filters = {op.input("Filter")[0] for op in main.desc.block(0).ops
               if op.type in ("conv2d", "depthwise_conv2d")}
    assert filters <= scope._layout_hwio
    for w in filters:
        twins = [n for n in scope._layout_hwio if n != w
                 and n.startswith(w)]
        assert twins  # Momentum velocity / Adam moments
        for t in twins:
            assert scope.get(t).shape == scope.get(w).shape


def test_auto_layout_changes_nothing_off_tpu():
    """auto_layout is a TPU-only lever in the reference (engine/
    executor.py ``_auto_layout_format``); on the CPU, as on the card, it
    changes nothing in either package."""
    from paddle_tpu.engine.executor import _auto_layout_format

    j_flags.set_flags({"auto_layout": True})
    assert _auto_layout_format() is None
    j_main, j_startup, _ = _lenet("jax")
    state = _jax_state(j_main, j_startup)
    off, _, _, exe_off = _train("torch", "lenet", "off", steps=2,
                                state=state)
    on, _, _, exe_on = _train("torch", "lenet", "off", steps=2, state=state,
                              auto_layout=True)
    assert on == off
    assert [k for k in exe_on.engine._cache] == \
        [k for k in exe_off.engine._cache]
    assert "TPU backend only" in flags.describe()["auto_layout"][2]


@pytest.mark.parametrize("op", ["conv2d", "depthwise_conv2d", "pool2d",
                                "batch_norm"])
def test_nhwc_lowerings_match_nchw(op):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 4, 7, 7).astype(np.float32))
    xh = x.permute(0, 2, 3, 1).contiguous()
    if op in ("conv2d", "depthwise_conv2d"):
        cin = 1 if op == "depthwise_conv2d" else 4
        w = torch.from_numpy(rng.randn(4, cin, 3, 3).astype(np.float32))
        attrs = {"strides": [2, 2], "paddings": [1, 1],
                 "groups": 4 if op == "depthwise_conv2d" else 1}
        a = OpRegistry.get(op).lower(None, {"Input": [x], "Filter": [w]},
                                     attrs)["Output"][0]
        b = OpRegistry.get(op).lower(
            None, {"Input": [xh], "Filter": [w.permute(2, 3, 1, 0)
                                             .contiguous()]},
            dict(attrs, data_format="NHWC"))["Output"][0]
        np.testing.assert_array_equal(b.numpy(),
                                      a.permute(0, 2, 3, 1).numpy())
        g = torch.from_numpy(rng.randn(*a.shape).astype(np.float32))
        ga = OpRegistry.get(op + "_grad").lower(
            None, {"Input": [x], "Filter": [w], "Output@GRAD": [g]}, attrs)
        gb = OpRegistry.get(op + "_grad").lower(
            None, {"Input": [xh], "Filter": [w.permute(2, 3, 1, 0)
                                             .contiguous()],
                   "Output@GRAD": [g.permute(0, 2, 3, 1).contiguous()]},
            dict(attrs, data_format="NHWC"))
        np.testing.assert_allclose(
            gb["Input@GRAD"][0].numpy(),
            ga["Input@GRAD"][0].permute(0, 2, 3, 1).numpy(), rtol=1e-6,
            atol=1e-6)
        np.testing.assert_allclose(
            gb["Filter@GRAD"][0].numpy(),
            ga["Filter@GRAD"][0].permute(2, 3, 1, 0).numpy(), rtol=1e-6,
            atol=1e-6)
        return
    if op == "pool2d":
        for attrs in ({"pooling_type": "max", "ksize": [3, 3],
                       "strides": [2, 2], "paddings": [1, 1]},
                      {"pooling_type": "avg", "ksize": [2, 2],
                       "strides": [2, 2], "ceil_mode": True},
                      {"pooling_type": "avg", "global_pooling": True}):
            a = OpRegistry.get("pool2d").lower(None, {"X": [x]},
                                               attrs)["Out"][0]
            b = OpRegistry.get("pool2d").lower(
                None, {"X": [xh]}, dict(attrs, data_format="NHWC"))["Out"][0]
            np.testing.assert_allclose(b.numpy(),
                                       a.permute(0, 2, 3, 1).numpy(),
                                       rtol=1e-6, atol=1e-7)
        return

    class _Ctx:
        is_test = False

    p = [torch.from_numpy(rng.rand(4).astype(np.float32) + 0.5)
         for _ in range(4)]
    ins = {"Scale": [p[0]], "Bias": [p[1]], "Mean": [p[2]],
           "Variance": [p[3]]}
    a = OpRegistry.get("batch_norm").lower(_Ctx(), dict(ins, X=[x]), {})
    b = OpRegistry.get("batch_norm").lower(_Ctx(), dict(ins, X=[xh]),
                                           {"data_layout": "NHWC"})
    np.testing.assert_allclose(b["Y"][0].numpy(),
                               a["Y"][0].permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b["MeanOut"][0].numpy(),
                               a["MeanOut"][0].numpy(), rtol=1e-6)


def test_bake_replaces_tensors_and_keys_the_cache():
    """The bake sets NEW tensors of the HWIO shape under the filters'
    names: a graph captured against the old tensors can not replay (the
    card's entry captures anew when the scope holds another tensor); the
    NHWC entry's key holds (mode, id(scope)) and pins the scope."""
    j_main, j_startup, _ = _lenet("jax")
    state = _jax_state(j_main, j_startup)
    _, scope, main, exe = _train("torch", "lenet", "off", steps=1,
                                 state=state)
    w = [op.input("Filter")[0] for op in main.desc.block(0).ops
         if op.type == "conv2d"][0]
    before = scope.get(w)
    _train("torch", "lenet", "nhwc", steps=1, scope=scope)
    after = scope.get(w)
    assert after is not before
    assert tuple(after.shape) == tuple(before.shape[i] for i in (2, 3, 1, 0))
    flags.set_flags({"layout": "nhwc"})
    main2, _, h = _lenet("torch")
    exe2 = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        exe2.run(main2, feed=_lenet_feed(np.random.RandomState(1)),
                 fetch_list=[h["loss"]])
    (entry,) = [c for c in exe2.engine._cache.values()]
    assert entry._cache_key[-1] == ("nhwc", id(scope))
    assert entry._layout_scope is scope


def test_unbake_when_the_pass_is_discarded(monkeypatch):
    from paddle_tpu_torch.analysis import passes, optimize_program

    def fail(*a, **k):
        raise RuntimeError("seeded verification failure")

    monkeypatch.setattr(passes, "verify_program", fail)
    _, t_main, h, _, t_scope = _scopes("lenet")
    w = [op.input("Filter")[0] for op in t_main.desc.block(0).ops
         if op.type == "conv2d"][0]
    shape = tuple(t_scope.get(w).shape)
    flags.set_flags({"layout": "nhwc"})
    desc, report = optimize_program(t_main, level=2,
                                    feed_names=["img", "label"],
                                    fetch_names=[h["loss"].name],
                                    scope=t_scope)
    assert "layout-assign" in report.crashed
    assert tuple(t_scope.get(w).shape) == shape
    assert w not in t_scope._layout_hwio
    assert all(op.attrs.get("data_format", "NCHW") == "NCHW"
               for op in desc.block(0).ops if op.type == "conv2d")


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_nhwc_checkpoint_across_packages(writer, tmp_path):
    """One NHWC step in the writer's package, a checkpoint (HWIO
    values), restored in the other package, one more NHWC step there,
    against the writer's own next step."""
    j_main, j_startup, _ = _resnet2("jax")
    state = _jax_state(j_main, j_startup)
    reader = "jax" if writer == "torch" else "torch"
    _, w_scope, w_main, _ = _train(writer, "resnet", "nhwc", steps=1,
                                   state=state)
    if writer == "torch":
        mgr = t_io.CheckpointManager(str(tmp_path))
        t_io.save_checkpoint_async(mgr, 1, main_program=w_main,
                                   scope=w_scope, blocking=True)
        mgr.wait()
    else:
        mgr = j_io.CheckpointManager(str(tmp_path))
        j_io.save_checkpoint_async(mgr, 1, main_program=w_main,
                                   scope=w_scope, blocking=True)
        mgr.wait()
    r_fluid, _, _, _ = _pkg(reader)
    r_main, _, _ = _resnet2(reader)
    r_scope = r_fluid.Scope()
    if reader == "jax":
        j_io.load_checkpoint(j_io.CheckpointManager(str(tmp_path)),
                             main_program=r_main, scope=r_scope)
    else:
        t_io.load_checkpoint(t_io.CheckpointManager(str(tmp_path)),
                             main_program=r_main, scope=r_scope,
                             place=tfluid.CPUPlace())
    w = [op.input("Filter")[0] for op in r_main.desc.block(0).ops
         if op.type == "conv2d"][0]
    declared = tuple(r_main.desc.block(0).find_var_recursive(w).shape)
    assert tuple(r_scope.get(w).shape) == tuple(declared[i]
                                                for i in (2, 3, 1, 0))
    want, _, _, _ = _train(writer, "resnet", "nhwc", steps=1,
                           scope=w_scope)
    got, _, _, _ = _train(reader, "resnet", "nhwc", steps=1, scope=r_scope)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-6)


def test_int8_program_at_nhwc_matches_nchw():
    from paddle_tpu_torch.inference import post_training_quantize

    j_main, j_startup, _ = _lenet("jax")
    state = _jax_state(j_main, j_startup)
    _, scope, main, exe = _train("torch", "lenet", "off", steps=2,
                                 state=state)
    _, _, h = _lenet("torch")
    rng = np.random.RandomState(5)
    with tfluid.scope_guard(scope):
        batches = [{"img": _lenet_feed(rng)["img"]} for _ in range(2)]
        int8_prog, _, rep = post_training_quantize(
            main, batches, feed_names=["img"], fetch_names=[h["pred"].name],
            executor=exe, freeze_first=True)
        assert rep.quantized
        x = {"img": _lenet_feed(rng)["img"]}
        (p_nchw,) = exe.run(int8_prog, feed=x, fetch_list=[h["pred"].name])
        flags.set_flags({"layout": "nhwc"})
        (p_nhwc,) = exe.run(int8_prog, feed=x, fetch_list=[h["pred"].name])
    assert any(op.type == "quantized_conv2d"
               for op in int8_prog.desc.block(0).ops)
    np.testing.assert_allclose(p_nhwc, p_nchw, rtol=1e-5, atol=1e-6)
    assert p_nhwc.argmax(-1).tolist() == p_nchw.argmax(-1).tolist()
    assert layout.resolved_layout_mode(2) == "nhwc"
