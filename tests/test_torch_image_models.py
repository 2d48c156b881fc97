"""The VGG-16, MobileNet-V1 and SE-ResNeXt builders of the port against
the JAX package's, on the CPU, at the JAX tests' small sizes
(``tests/test_models.py``: VGG at 3x32x32, MobileNet at scale 0.25 and
64x64, SE-ResNeXt ``small=True`` at 16x16).

- Descs: the training program (Adam or Momentum), the ``is_train=False``
  program and the training program's ``for_test`` clone, main and
  startup, byte for byte.
- Training: 2 steps at batch 4, with every dropout's rate set to 0 in
  both programs (their masks are drawn differently, ROADMAP Queue 3
  "Dropout seeds"). Each step starts from the JAX package's state (its
  startup, then its state after step 1) in both packages. The JAX package
  runs the step and returns every var it writes; the port runs the
  step's ops one by one on the operands the JAX package computed, and
  each output must lie within 1e-4 * max|want| + 1e-7 + 3e-5 * (the
  largest incoming grad of the op), integers equal. The last term is for
  grads that sum many terms and cancel to near 0: a conv bias grad before
  a batch norm, a batch norm's scale grad over a 4096-element map (up to
  6.6e-6 of the incoming grad seen, 2.5 % of the result's max). The
  port's executor runs the whole step, its loss rtol 1e-5.

Why op by op, as for ResNet-50 (``tests/test_torch_resnet50.py``): these
nets at random init amplify float32 rounding on the way down and back,
and in MobileNet a relu input within rounding of 0 decides otherwise
(a batch-4 batch norm over 2x2 maps): end to end, one step's grads lie
up to 6 % of their max apart from the JAX package's, while the loss
agrees to 1e-5; VGG's conv biases, which batch norm cancels, have grads
of rounding noise only, which Adam turns into steps of the full
learning rate in either direction.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import models as j_models
from paddle_tpu import unique_name as j_unique_name

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import models as t_models
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.engine import lowering as tlowering
from torch_threads import one_torch_thread  # noqa: F401

MODELS = {
    "vgg": (dict(class_num=10, lr=0.002), (3, 32, 32)),
    "mobilenet": (dict(class_num=10, image_shape=(3, 64, 64), scale=0.25),
                  (3, 64, 64)),
    "se_resnext": (dict(class_num=10, image_shape=(3, 16, 16), small=True,
                        lr=0.05), (3, 16, 16)),
}
STEPS = 2
BATCH = 4
OP_REL, OP_ABS, COT_REL = 1e-4, 1e-7, 3e-5
LOSS_RTOL = 1e-5


def _models(name, **kw):
    cfg = dict(MODELS[name][0], **kw)
    with j_unique_name.guard():
        j = getattr(j_models, name).get_model(**cfg)
    with t_unique_name.guard():
        t = getattr(t_models, name).get_model(**cfg)
    return j, t


@pytest.mark.parametrize("which", ["train", "infer", "for_test"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_desc_parity(name, which):
    (j_main, j_startup, _), (t_main, t_startup, _) = _models(
        name, is_train=which != "infer")
    if which == "for_test":
        j_main, t_main = j_main.clone(for_test=True), \
            t_main.clone(for_test=True)
    for j_prog, t_prog in ((j_main, t_main), (j_startup, t_startup)):
        assert json.loads(t_prog.desc.serialize_to_string()) == \
            json.loads(j_prog.desc.serialize_to_string())
        assert t_prog.desc.serialize_to_string() == \
            j_prog.desc.serialize_to_string()


def _no_dropout(program):
    for op in program.desc.global_block().ops:
        if op.type in ("dropout", "dropout_grad"):
            op.attrs["dropout_prob"] = 0.0
    program._bump_version()


def _step_op_by_op(j_main, t_main, state, feed):
    """One step of both packages from ``state``: the JAX package runs it
    and returns every var it writes; the port runs its ops one by one,
    each on the operands the JAX package computed, and every output must
    agree (a grad the backward accumulates into later is held at its
    last write). Returns the JAX package's state after the step and its
    loss fetch names' values."""
    block = t_main.desc.global_block()
    ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
    last_write = {}
    for i, op in enumerate(ops):
        for n in op.output_arg_names():
            if n != tlowering.EMPTY_VAR_NAME:
                last_write[n] = i
    written = sorted(last_write)
    temps = [n for n in written if not block.find_var_recursive(n).persistable]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    for n, v in state.items():
        scope.set(n, v.copy())
    with jfluid.scope_guard(scope):
        want = dict(zip(temps, (np.asarray(v) for v in exe.run(
            j_main, feed=feed, fetch_list=temps))))
        after = {n: np.array(scope.get(n)) for n in state}
    want.update((n, after[n]) for n in written if n not in want)

    cur = dict(state, **feed)
    held = set()
    for i, op in enumerate(ops):
        env = {n: torch.from_numpy(np.array(cur[n]))
               for n in op.input_arg_names()
               if n != tlowering.EMPTY_VAR_NAME}
        tlowering.run_op(op, block, env, "cpu", (0, 1), i, False)
        for n in op.output_arg_names():
            if n == tlowering.EMPTY_VAR_NAME:
                continue
            g = env[n].numpy()
            if last_write[n] != i:  # accumulated into later
                cur[n] = g
                continue
            w = cur[n] = want[n]
            assert g.shape == w.shape, (op.type, n, g.shape, w.shape)
            held.add(op.type)
            if not np.issubdtype(w.dtype, np.floating):
                np.testing.assert_array_equal(g, w, err_msg=n)
                continue
            peak = float(np.abs(w).max()) if w.size else 0.0
            d = float(np.abs(g - w).max()) if w.size else 0.0
            cot = max([float(np.abs(cur[m]).max())
                       for m in op.input_arg_names()
                       if m.endswith("@GRAD") and m in cur] or [0.0])
            assert d <= OP_REL * peak + OP_ABS + COT_REL * cot, (
                op.type, n, d, peak, cot)
    return after, want, held


@pytest.mark.parametrize("name", sorted(MODELS))
def test_two_steps_match_jax(name):
    (j_main, j_startup, j_h), (t_main, _, t_h) = _models(name)
    _no_dropout(j_main)
    _no_dropout(t_main)
    rng = np.random.RandomState(0)
    feeds = [{"img": rng.randn(BATCH, *MODELS[name][1]).astype(np.float32),
              "label": rng.randint(0, 10, (BATCH, 1)).astype(np.int64)}
             for _ in range(STEPS)]
    names = sorted(v.name for v in j_main.list_vars() if v.persistable)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
        state = {n: np.array(scope.get(n)) for n in names}
    t_exe = tfluid.Executor(tfluid.CPUPlace())
    loss = t_h["loss"].name
    for feed in feeds:
        after, want, held = _step_op_by_op(j_main, t_main, state, feed)
        t_scope = tfluid.Scope()
        convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
        with tfluid.scope_guard(t_scope):
            (got,) = t_exe.run(t_main, feed=feed, fetch_list=[loss])
        np.testing.assert_allclose(float(got.reshape(-1)[0]),
                                   float(want[loss].reshape(-1)[0]),
                                   rtol=LOSS_RTOL)
        state = after
    assert {"conv2d", "conv2d_grad", "batch_norm", "batch_norm_grad",
            "pool2d", "pool2d_grad"} <= held
    assert {"mobilenet": {"relu_grad", "momentum"},
            "se_resnext": {"dropout", "dropout_grad", "momentum"},
            "vgg": {"dropout", "dropout_grad", "adam"}}[name] <= held
