"""The port's INT8 path (``paddle_tpu_torch/inference/{freeze,quantize}.py``,
``ops/quant_ops.py``, ``io.save_frozen_model``/``load_frozen_model``,
the predictor's ``enable_mkldnn`` switch and ``contrib``'s quantization
surface) against the JAX package's, on the CPU, at a tiny size: LeNet at
8 and 16 filters on 28x28, batch 8.

- ``freeze_program``, ``calibrate_program`` and ``quantize_program`` on
  the same LeNet state: byte-identical frozen and quantized descs (both
  quantized with the JAX package's calibrated ranges, so the scales are
  the same floats), int8 and folded weights bitwise equal, calibrated
  ranges rtol 1e-6, and under the float32 emulation the INT8 program's
  int8 activations exactly equal, its logits and softmax rtol 1e-6.
- The 7 ``quant_ops`` lowerings against the JAX lowerings on the same
  operands: exactly equal (the fake ops' straight-through grads are the
  upstream grad, exactly), ``quantized_conv2d`` in NCHW and NHWC with
  scalar and per-channel scales.
- The native int8 path's im2col + ``torch._int_mm`` (which the card
  runs; the CPU has ``_int_mm`` too) exactly equal to the emulation, with
  the padding the card needs (M = 1, K = 25, N = 20).
- ``int8_native='1'`` raises on a CPU tensor.
- ``enable_mkldnn`` swaps the quantized program in after
  ``serving_calibration_batches`` requests.
- A frozen INT8 model saved by either package loads in the other, int8
  dtypes kept, and gives the same logits (rtol 1e-6).
- The contrib ``Calibrator``, ``QuantizeTranspiler`` and slim
  ``QuantizationTransformPass``/``QuantizationFreezePass`` against the
  JAX package's: the same descs and int8 weights.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import nets as j_nets
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.registry import OpRegistry as JOpRegistry
from paddle_tpu.inference import (
    calibrate_program as j_calibrate, freeze_program as j_freeze,
    quantize_program as j_quantize,
)

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert, flags, inference
from paddle_tpu_torch import nets as t_nets
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.core.registry import OpRegistry
from paddle_tpu_torch.inference import (
    calibrate_program, freeze_program, quantize_program,
)
from paddle_tpu_torch.ops import quant_ops

BATCH = 8
# the lowerings this file holds against the JAX package's
SLICE_OPS = {"fake_quantize_abs_max", "fake_quantize_moving_average_abs_max",
             "fake_dequantize_max_abs", "quantize", "dequantize",
             "quantized_matmul", "quantized_conv2d"}
RANGE_RTOL = 1e-6
LOGITS_RTOL = 1e-6


def _lenet(pkg, train=True):
    """The LeNet of tests/test_int8_accuracy.py at 8 and 16 filters."""
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
        if train:
            fluid.optimizer.Adam(learning_rate=2e-3).minimize(loss)
    return main, startup, pred, loss


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"img": rng.rand(BATCH, 1, 28, 28).astype(np.float32),
             "label": rng.randint(0, 10, (BATCH, 1)).astype(np.int64)}
            for _ in range(n)]


def _jax_trained(steps=2):
    """JAX LeNet after ``steps`` Adam steps: (main, pred, scope, state)."""
    main, startup, pred, loss = _lenet("jax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for b in _batches(steps, seed=1):
            exe.run(main, feed=b, fetch_list=[loss])
    state = {v.name: np.array(scope.get(v.name))
             for v in main.list_vars() if v.persistable}
    return main, pred, exe, scope, state


def _port_scope(main, state):
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, state, "cpu", program=main)
    return scope


def _logits_name(desc):
    """The quantized fc's output: the input of the final softmax."""
    (sm,) = [op for op in desc.block(0).ops if op.type == "softmax"]
    return sm.input("X")[0]


@pytest.fixture(scope="module")
def pipeline():
    """Both packages' freeze -> calibrate -> quantize on one LeNet state."""
    j_main, j_pred, j_exe, j_scope, state = _jax_trained()
    t_main, _, t_pred, _ = _lenet("torch")
    t_scope = _port_scope(t_main, state)
    t_exe = tfluid.Executor(tfluid.CPUPlace())
    calib = [{"img": b["img"]} for b in _batches(3, seed=2)]
    with jfluid.scope_guard(j_scope):
        j_frozen, j_rep = j_freeze(j_main, ["img"], [j_pred.name],
                                   scope=j_scope)
        j_stats = j_calibrate(j_frozen, calib, scope=j_scope,
                              executor=j_exe, max_batches=3)
        with j_unique_name.guard():
            j_int8, j_qrep = j_quantize(j_frozen, j_stats, scope=j_scope)
    with tfluid.scope_guard(t_scope):
        t_frozen, t_rep = freeze_program(t_main, ["img"], [t_pred.name],
                                         scope=t_scope)
        t_stats = calibrate_program(t_frozen, calib, scope=t_scope,
                                    executor=t_exe, max_batches=3)
        with t_unique_name.guard():
            t_int8, t_qrep = quantize_program(t_frozen, j_stats.ranges(),
                                              scope=t_scope)
    return dict(j_frozen=j_frozen, t_frozen=t_frozen, j_rep=j_rep,
                t_rep=t_rep, j_stats=j_stats, t_stats=t_stats,
                j_int8=j_int8, t_int8=t_int8, j_qrep=j_qrep, t_qrep=t_qrep,
                j_scope=j_scope, t_scope=t_scope, j_exe=j_exe, t_exe=t_exe,
                pred=t_pred.name, calib=calib)


def test_frozen_and_quantized_descs_match_reference(pipeline):
    p = pipeline
    assert p["t_frozen"].desc.serialize_to_string() == \
        p["j_frozen"].desc.serialize_to_string()
    assert p["t_rep"].render() == p["j_rep"].render()
    assert p["t_int8"].desc.serialize_to_string() == \
        p["j_int8"].desc.serialize_to_string()
    assert p["t_qrep"].render() == p["j_qrep"].render()
    types = [op.type for op in p["t_int8"].desc.block(0).ops]
    assert types.count("quantized_conv2d") == 2
    assert types.count("quantized_matmul") == 1


def test_calibrated_ranges_match_reference(pipeline):
    j, t = pipeline["j_stats"].ranges(), pipeline["t_stats"].ranges()
    assert sorted(j) == sorted(t) and pipeline["t_stats"].batches == 3
    for name in j:
        np.testing.assert_allclose(t[name], j[name], rtol=RANGE_RTOL,
                                   err_msg=name)


def test_baked_weights_bitwise_equal(pipeline):
    p = pipeline
    baked = [n for n, vd in p["t_int8"].desc.block(0).vars.items()
             if vd.persistable and (".int8" in n or ".bnfold" in n
                                    or n.endswith(".b_0"))]
    assert any(".int8" in n for n in baked)
    for name in baked:
        t_val = p["t_scope"].get(name)
        t_val = (t_val.numpy() if isinstance(t_val, torch.Tensor)
                 else np.asarray(t_val))
        j_val = np.asarray(p["j_scope"].get(name))
        assert t_val.dtype == j_val.dtype, name
        np.testing.assert_array_equal(t_val, j_val, err_msg=name)


def test_int8_outputs_equal_under_emulation(pipeline):
    """Every int8 activation (each ``quantize`` output) exactly equal;
    the rescaled float outputs to ``LOGITS_RTOL``: the lowerings agree
    exactly when run op by op (test_quant_op_matches_reference), but
    XLA, under the JAX engine's jit, rewrites the division by the
    constant scale, which moves a float32 result by an ulp."""
    p = pipeline
    ops = p["t_int8"].desc.block(0).ops
    codes = [op.output("Output")[0] for op in ops if op.type == "quantize"]
    logits = _logits_name(p["t_int8"].desc)
    fetch = codes + [logits, p["pred"]]
    feed = {"img": _batches(1, seed=5)[0]["img"]}
    with jfluid.scope_guard(p["j_scope"]):
        j_out = p["j_exe"].run(p["j_int8"], feed=feed, fetch_list=fetch)
    with tfluid.scope_guard(p["t_scope"]):
        t_out = p["t_exe"].run(p["t_int8"], feed=feed, fetch_list=fetch)
    assert len(codes) == 3
    for name, t, j in zip(fetch, t_out, j_out):
        if name in codes:
            assert t.dtype == np.int8
            np.testing.assert_array_equal(t, np.asarray(j), err_msg=name)
        else:
            np.testing.assert_allclose(t, np.asarray(j), rtol=LOGITS_RTOL,
                                       atol=1e-6, err_msg=name)


class _Ctx:
    def __init__(self, is_test=False):
        self.is_test = is_test


def _op_case(op_type, rng):
    """(inputs, attrs) of one quant op on small operands."""
    x = rng.randn(2, 3, 6, 6).astype(np.float32)
    if op_type == "fake_quantize_abs_max":
        return {"X": [x]}, {"bit_length": 8}
    if op_type == "fake_quantize_moving_average_abs_max":
        return ({"X": [x], "InScale": [np.array([1.5], np.float32)]},
                {"bit_length": 8, "moving_rate": 0.9})
    if op_type == "fake_dequantize_max_abs":
        return ({"X": [np.round(x * 40)],
                 "Scale": [np.array([2.5], np.float32)]},
                {"max_range": 127.0})
    if op_type == "quantize":
        return {"Input": [x]}, {"Scale": 37.3}
    if op_type == "dequantize":
        q = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
        return {"Input": [q]}, {"Scale": 37.3}
    q = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
    if op_type == "quantized_matmul":
        y = rng.randint(-127, 128, (108, 5)).astype(np.int8)
        return ({"X": [q], "Y": [y]},
                {"scale_x": 40.0, "x_num_col_dims": 1,
                 "scale_y": [float(v) for v in rng.rand(5) * 90 + 10]})
    w = rng.randint(-127, 128, (4, 3, 3, 3)).astype(np.int8)
    return ({"Input": [q], "Filter": [w]},
            {"scale_x": 40.0, "strides": [2, 1], "paddings": [1, 0],
             "dilations": [1, 1], "groups": 1,
             "scale_w": [float(v) for v in rng.rand(4) * 90 + 10]})


_QUANT_OPS = ["fake_quantize_abs_max", "fake_quantize_moving_average_abs_max",
              "fake_dequantize_max_abs", "quantize", "dequantize",
              "quantized_matmul", "quantized_conv2d"]


@pytest.mark.parametrize("op_type", _QUANT_OPS)
def test_quant_op_matches_reference(op_type):
    import jax

    rng = np.random.RandomState(_QUANT_OPS.index(op_type))
    ins, attrs = _op_case(op_type, rng)
    j_outs = JOpRegistry.get(op_type).lower(
        _Ctx(), {k: [jax.numpy.asarray(a) for a in v]
                 for k, v in ins.items()}, attrs)
    t_outs = OpRegistry.get(op_type).lower(
        _Ctx(), {k: [torch.from_numpy(a) for a in v]
                 for k, v in ins.items()}, attrs)
    assert sorted(j_outs) == sorted(t_outs)
    for slot in j_outs:
        want = np.asarray(j_outs[slot][0])
        got = t_outs[slot][0].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, slot
        np.testing.assert_array_equal(got, want, err_msg=slot)
    if op_type.startswith("fake_quantize"):
        # the straight-through grad: d out / d x is the identity
        x = torch.from_numpy(ins["X"][0]).requires_grad_(True)
        t_ins = dict({k: [torch.from_numpy(a) for a in v]
                      for k, v in ins.items()}, X=[x])
        out = OpRegistry.get(op_type).lower(_Ctx(), t_ins, attrs)["Out"][0]
        g = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
        (dx,) = torch.autograd.grad(out, x, g)

        def j_fn(xx):
            j_ins = {k: [jax.numpy.asarray(a) for a in v]
                     for k, v in ins.items()}
            j_ins["X"] = [xx]
            return JOpRegistry.get(op_type).lower(_Ctx(), j_ins,
                                                  attrs)["Out"][0]

        _, vjp = jax.vjp(j_fn, jax.numpy.asarray(ins["X"][0]))
        (j_dx,) = vjp(jax.numpy.asarray(g.numpy()))
        np.testing.assert_array_equal(dx.numpy(), np.asarray(j_dx))
        np.testing.assert_array_equal(dx.numpy(), g.numpy())


@pytest.mark.parametrize("scale", ["scalar", "per_channel"])
def test_quantized_conv2d_nhwc_matches_reference(scale):
    import jax

    rng = np.random.RandomState(11)
    ins, attrs = _op_case("quantized_conv2d", rng)
    if scale == "scalar":
        attrs["scale_w"] = 55.0
    x = np.transpose(ins["Input"][0], (0, 2, 3, 1)).copy()
    w = np.transpose(ins["Filter"][0], (2, 3, 1, 0)).copy()
    attrs = dict(attrs, data_format="NHWC")
    want = JOpRegistry.get("quantized_conv2d").lower(
        _Ctx(), {"Input": [jax.numpy.asarray(x)],
                 "Filter": [jax.numpy.asarray(w)]}, attrs)["Output"][0]
    got = OpRegistry.get("quantized_conv2d").lower(
        _Ctx(), {"Input": [torch.from_numpy(x)],
                 "Filter": [torch.from_numpy(w)]}, attrs)["Output"][0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", [
    # (x shape NCHW, filter OIHW, stride, pad, dilation, groups, nhwc)
    ((1, 1, 28, 28), (20, 1, 5, 5), 1, 0, 1, 1, False),   # K = 25, N = 20
    ((2, 3, 9, 9), (8, 3, 7, 7), 2, 3, 1, 1, False),      # K = 147
    ((1, 8, 7, 7), (16, 8, 1, 1), 1, 0, 1, 1, True),      # 1x1 GEMM, M = 49
    ((2, 4, 8, 8), (8, 4, 3, 3), 1, 2, 2, 1, True),       # dilated
    ((2, 4, 6, 6), (8, 2, 3, 3), 1, 1, 1, 2, False),      # grouped
])
def test_native_int8_conv_equals_emulation(case):
    """The card's path (im2col, zero padding, ``torch._int_mm``) run on
    CPU tensors against the float32 emulation: int32 sums exact, so
    equal."""
    xs, ws, stride, pad, dil, groups, nhwc = case
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randint(-127, 128, xs).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, ws).astype(np.int8))
    want = torch.nn.functional.conv2d(
        x.float(), w.float(), stride=stride, padding=pad, dilation=dil,
        groups=groups)
    if nhwc:
        x, w = x.permute(0, 2, 3, 1).contiguous(), \
            w.permute(2, 3, 1, 0).contiguous()
    acc, (n, oh, ow) = quant_ops._conv_int8(
        x, w, [stride] * 2, [pad] * 2, [dil] * 2, groups, nhwc)
    assert acc.dtype == torch.int32
    got = acc.reshape(n, oh, ow, -1).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(got.float().numpy(), want.numpy())
    a = torch.from_numpy(rng.randint(-127, 128, (1, 500)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-127, 128, (500, 10)).astype(np.int8))
    np.testing.assert_array_equal(quant_ops._int_mm(a, b).numpy(),
                                  a.int().numpy() @ b.int().numpy())


def test_int8_native_one_raises_on_cpu():
    x = torch.zeros(2, 4, dtype=torch.int8)
    y = torch.zeros(4, 8, dtype=torch.int8)
    flags.set_flags({"int8_native": "1"})
    try:
        with pytest.raises(RuntimeError, match="no CPU int8 GEMM"):
            OpRegistry.get("quantized_matmul").lower(
                _Ctx(), {"X": [x], "Y": [y]}, {})
    finally:
        flags.reset_flag("int8_native")
    flags.set_flags({"int8_native": "0"})
    try:
        (out,) = OpRegistry.get("quantized_matmul").lower(
            _Ctx(), {"X": [x], "Y": [y]}, {})["Out"]
        assert out.shape == (2, 8)
    finally:
        flags.reset_flag("int8_native")


def _save_lenet_inference(pkg, dirname, state):
    fluid = jfluid if pkg == "jax" else tfluid
    main, _, pred, _ = _lenet(pkg, train=False)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    names = [v.name for v in main.list_vars() if v.persistable]
    if pkg == "jax":
        for n in names:
            scope.set(n, state[n])
    else:
        convert.load_numpy_state(scope, {n: state[n] for n in names}, "cpu",
                                 program=main)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(dirname, ["img"], [pred], exe,
                                      main_program=main)
    return pred.name


def test_enable_mkldnn_swaps_after_calibration(tmp_path):
    *_, state = _jax_trained(steps=1)
    pred = _save_lenet_inference("torch", str(tmp_path), state)
    config = inference.AnalysisConfig(str(tmp_path))
    config.disable_gpu()
    config.enable_mkldnn()
    plain = inference.AnalysisConfig(str(tmp_path))
    plain.disable_gpu()
    fp32 = inference.create_paddle_predictor(plain)
    flags.set_flags({"serving_calibration_batches": 2})
    try:
        predictor = inference.create_paddle_predictor(config)
        feeds = [{"img": b["img"]} for b in _batches(3, seed=7)]
        for i, feed in enumerate(feeds):
            (out,) = predictor.run(feed)
            types = [op.type for op in predictor._program.desc.block(0).ops]
            assert ("quantized_conv2d" in types) == (i >= 1), (i, types)
            (want,) = fp32.run(feed)
            assert out.name == pred
            np.testing.assert_allclose(out.data, want.data, atol=0.05)
    finally:
        flags.reset_flag("serving_calibration_batches")
    assert len(predictor.quant_report.quantized) == 3


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_frozen_int8_model_loads_across_packages(writer, tmp_path,
                                                 pipeline):
    from paddle_tpu import io as j_io

    from paddle_tpu_torch import io as t_io

    p = pipeline
    logits = _logits_name(p["t_int8"].desc)
    if writer == "jax":
        j_io.save_frozen_model(str(tmp_path), p["j_int8"], ["img"],
                               [p["pred"]], scope=p["j_scope"])
    else:
        t_io.save_frozen_model(str(tmp_path), p["t_int8"], ["img"],
                               [p["pred"]], scope=p["t_scope"])
    feed = {"img": _batches(1, seed=9)[0]["img"]}
    j_scope, t_scope = jfluid.Scope(), tfluid.Scope()
    j_prog, _, j_fetch, j_meta = j_io.load_frozen_model(str(tmp_path),
                                                        scope=j_scope)
    t_prog, t_feeds, t_fetch, t_meta = t_io.load_frozen_model(
        str(tmp_path), scope=t_scope)
    assert t_meta == j_meta and t_fetch == j_fetch == [p["pred"]]
    int8 = [n for n, vd in t_prog.desc.block(0).vars.items()
            if vd.persistable and ".int8" in n]
    assert int8 and all(np.asarray(t_scope.get(n)).dtype == np.int8
                        for n in int8)
    with jfluid.scope_guard(j_scope):
        (want,) = jfluid.Executor(jfluid.CPUPlace()).run(
            j_prog, feed=feed, fetch_list=[logits])
    predictor = inference.AnalysisPredictor.from_frozen(
        program=t_prog, feed_names=t_feeds, fetch_names=[logits],
        scope=t_scope, config=_cpu_config())
    (got,) = predictor.run(feed)
    np.testing.assert_allclose(got.data, np.asarray(want), rtol=LOGITS_RTOL,
                               atol=1e-6)


def _cpu_config():
    config = inference.AnalysisConfig()
    config.disable_gpu()
    return config


def _assert_desc_close(got, want, rtol):
    """Two serialized descs equal, their float attrs to ``rtol``."""
    import json

    def walk(a, b, path):
        if isinstance(a, float) or isinstance(b, float):
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=path)
        elif isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                walk(a[k], b[k], path + "/" + str(k))
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, "%s[%d]" % (path, i))
        else:
            assert a == b, (path, a, b)

    walk(json.loads(got), json.loads(want), "")


def _contrib_flow(pkg, state, batches):
    """Calibrator over the for_test LeNet; QuantizeTranspiler's QAT
    transpile, freeze and convert_to_int8 on the training program."""
    fluid = jfluid if pkg == "jax" else tfluid
    guard = j_unique_name.guard if pkg == "jax" else t_unique_name.guard
    main, startup, pred, loss = _lenet(pkg, train=False)
    test_prog = main.clone(for_test=True)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    names = [v.name for v in main.list_vars() if v.persistable]
    for n in names:
        scope.set(n, state[n] if pkg == "jax"
                  else torch.from_numpy(np.array(state[n])))
    with guard(), fluid.scope_guard(scope):
        calib = fluid.contrib.Calibrator(
            program=test_prog, exe=exe, scope=scope, feed_names=["img"],
            fetch_list=[pred], algo="direct")
        calib.sample_data(batches)
        frozen = calib.save_int8_model()
        qt = fluid.contrib.QuantizeTranspiler()
        qat = main.clone(for_test=True)
        qt.training_transpile(qat)
        qat_desc = qat.desc.serialize_to_string()
        exe.run(qat, feed=batches[0], fetch_list=[pred])
        qt.freeze_program(qat, fluid.CPUPlace(), scope=scope)
        converted = qt.convert_to_int8(qat, fluid.CPUPlace(), scope=scope)
    weights = {n: np.asarray(scope.get(n)) if pkg == "jax"
               else scope.get(n).numpy()
               for n in converted}
    int8 = {n + "@INT8": np.asarray(scope.get(n + "@INT8"))
            for n in converted}
    return (frozen.desc.serialize_to_string(), qat_desc,
            qat.desc.serialize_to_string(), weights, int8)


def test_contrib_quantization_matches_reference():
    *_, state = _jax_trained(steps=1)
    batches = [{"img": b["img"]} for b in _batches(2, seed=4)]
    j = _contrib_flow("jax", state, batches)
    t = _contrib_flow("torch", state, batches)
    # the Calibrator's INT8 program: its scales come from each package's
    # own calibration run, equal to rtol RANGE_RTOL
    _assert_desc_close(t[0], j[0], RANGE_RTOL)
    assert t[1] == j[1]      # the QAT program
    assert t[2] == j[2]      # the frozen QAT program
    assert sorted(t[3]) == sorted(j[3]) and t[3]
    for n in j[4]:
        np.testing.assert_array_equal(t[4][n], j[4][n], err_msg=n)
