"""ResNet-50's loss on one repeated batch at the JAX package's bench
settings (Momentum 0.9, lr 0.1; ``bench.py`` ``bench_resnet50``), in the
JAX package and in the port, on the CPU, from one state.

``chip_smoke.py`` trains full-size ResNet-50 this way on the card and
checks only that the first step lowers the loss: after it the loss
climbs (on an H100: 7.28, 5.98, 14.90, 30.12, 38.12 at 224x224, batch
32). This test shows that the reference does the same at a small size:
32x32 images, batch 8, 1000 classes, 3 steps from one state (the port's
startup, set into both scopes). In both packages the second loss is
below the first and the third above it. Measured: JAX 8.111, 6.063,
24.116; the port 8.111, 6.194, 24.582. The first losses agree within rtol
1e-4 (BERT's step tolerance); later ones part ways, since float32
rounding differences grow through this network
(tests/test_torch_resnet50.py).
"""

import numpy as np

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.models import resnet as j_resnet

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.models import resnet as t_resnet

CFG = dict(dataset="imagenet", depth=50, class_num=1000, lr=0.1)
STEPS = 3


def test_resnet50_loss_climbs_after_the_first_step_in_both_packages():
    with j_unique_name.guard():
        j_main, _, jh = j_resnet.get_model(**CFG)
    with t_unique_name.guard():
        t_main, t_startup, th = t_resnet.get_model(**CFG)
    rng = np.random.RandomState(11)
    feed = {"img": rng.randn(8, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 1000, (8, 1)).astype(np.int64)}
    t_exe, t_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(t_scope):
        t_exe.run(t_startup)
    j_exe, j_scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    for v in j_main.list_vars():
        if v.persistable:
            j_scope.set(v.name, t_scope.get(v.name).numpy().copy())
    with jfluid.scope_guard(j_scope):
        want = [float(np.asarray(j_exe.run(
            j_main, feed=feed, fetch_list=[jh["loss"]])[0]).reshape(()))
            for _ in range(STEPS)]
    with tfluid.scope_guard(t_scope):
        got = [float(t_exe.run(t_main, feed=feed, fetch_list=[th["loss"]])[
            0].reshape(())) for _ in range(STEPS)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    for losses in (want, got):
        assert np.isfinite(losses).all()
        assert losses[1] < losses[0] < losses[2], losses
