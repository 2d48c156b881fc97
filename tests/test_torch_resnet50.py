"""One ResNet-50 training step (``models.resnet.get_model(dataset=
"imagenet", depth=50, class_num=100)``, Momentum, 64x64 images, batch 2)
in the port against the JAX package, on the CPU.

Both front ends build the same desc. From one state (the port's startup,
set into both scopes), the JAX package runs the step and returns every
var the step writes. Then the step's ops run one by one through the
port's ``run_op``, each on the operands the reference computed: every
output of every op (forward, grads, Momentum) must agree with the
reference's. A grad var that the backward writes and then accumulates
into (``relu_*@GRAD``: a first contribution, then ``sum``) is held at its
last write, and the port's own first value feeds the ops between. Last,
the port's executor runs the whole step, and its loss must agree.

Why the grads are held op by op and not end to end: at random init this
50-layer network amplifies float32 rounding by about 1e5 on the way down
and back, so two float32 evaluations of the same step that only round in
another order give grads several percent apart, while their losses
agree to about 1e-5: the JAX package's own jitted step and the same step
run op by op do so, and so do the port's step on an H100 and on the CPU
(``chip_smoke.py`` ``resnet50_train`` prints both: every op within
1.5e-5 of its largest element, the first conv filter's grad 2.8 % apart
end to end). Held op by op, on identical operands, every grad lies
within the tolerance below.

Tolerances, float32 on both sides:
- each op's outputs: |d| <= 1e-4 * max|want| + 1e-7, integer outputs
  equal. The largest relative difference is batch norm's saved variance
  (2.4e-5 measured): the reference's ``E[x^2] - mean^2`` magnifies the
  rounding of a 512-element sum by E[x^2] / var, up to 27 here; the
  convs, GEMMs and grads agree to 4e-6 or better.
- the step's loss: rtol 1e-4.
"""

import numpy as np
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.models import resnet as j_resnet

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.engine import lowering as tlowering
from paddle_tpu_torch.models import resnet as t_resnet

CFG = dict(dataset="imagenet", depth=50, class_num=100, lr=0.1)
OP_REL, OP_ABS = 1e-4, 1e-7
LOSS_RTOL = 1e-4


def test_resnet50_step_matches_jax_op_by_op():
    with j_unique_name.guard():
        j_main = j_resnet.get_model(**CFG)[0]
    with t_unique_name.guard():
        main, startup, handles = t_resnet.get_model(**CFG)
    assert main.desc.serialize_to_string() == \
        j_main.desc.serialize_to_string()
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(2, 3, 64, 64).astype(np.float32),
            "label": rng.randint(0, 100, (2, 1)).astype(np.int64)}
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
    state = {v.name: scope.get(v.name).numpy().copy()
             for v in main.list_vars() if v.persistable}

    block = main.desc.global_block()
    ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
    last_write = {}
    for i, op in enumerate(ops):
        for n in op.output_arg_names():
            if n != tlowering.EMPTY_VAR_NAME:
                last_write[n] = i
    written = sorted(last_write)
    temps = [n for n in written if not block.find_var_recursive(n).persistable]
    j_exe, j_scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    for n, v in state.items():
        j_scope.set(n, v.copy())
    with jfluid.scope_guard(j_scope):
        want = dict(zip(temps, (np.asarray(v) for v in j_exe.run(
            j_main, feed=feed, fetch_list=temps))))
        want.update({n: np.asarray(j_scope.get(n)) for n in written
                     if n not in want})

    cur = dict(state, **feed)
    held = set()
    for i, op in enumerate(ops):
        got = {n: torch.from_numpy(np.array(cur[n]))
               for n in op.input_arg_names()
               if n != tlowering.EMPTY_VAR_NAME}
        tlowering.run_op(op, None, got, "cpu", (0, 1), i, False)
        for n in op.output_arg_names():
            if n == tlowering.EMPTY_VAR_NAME:
                continue
            g = got[n].numpy()
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
            assert d <= OP_REL * peak + OP_ABS, (op.type, n, d, peak)
    assert len(ops) > 500
    assert {"conv2d", "conv2d_grad", "batch_norm", "batch_norm_grad",
            "pool2d", "pool2d_grad", "sum", "momentum"} <= held

    loss = handles["loss"].name
    with tfluid.scope_guard(scope):
        convert.load_numpy_state(scope, state, "cpu", program=main)
        (got_loss,) = exe.run(main, feed=feed, fetch_list=[loss])
    np.testing.assert_allclose(float(got_loss.reshape(-1)[0]),
                               float(want[loss].reshape(-1)[0]),
                               rtol=LOSS_RTOL)
