"""The port's ResNet and MNIST builders and programs against the JAX
package's, on the CPU.

- Descs: ResNet cifar10 (depth 8) and ImageNet (depth 50), train and
  inference programs and the train program's ``for_test`` clone, and the
  MNIST ``mlp`` and ``conv_net`` programs, main and startup, byte for
  byte.
- Training: 3 Momentum steps (lr 0.1) of ResNet cifar10 depth 8 at batch
  4, and 3 Adam steps of MNIST ``conv_net`` at batch 8, from the JAX
  package's startup state (``convert.load_numpy_state``): losses and
  accuracies per step, and every persistable var after the steps (the
  parameters, Momentum's velocities, batch norm's running mean and
  variance).
- Serving: a ResNet cifar10 inference model that the JAX package saved,
  with running statistics away from their init, is served by the port's
  predictor, against the JAX predictor.
- The ``for_test`` clone of a batch-norm model is deterministic and reads
  the running statistics without writing them.

Tolerances, float32 on both sides, the same formulas summed in other
orders (the convs, the batch statistics): losses rtol 1e-5 (measured
4.3e-7); every persistable after 3 steps |d| <= 1e-5 * max|want| + 1e-6
(measured: ResNet 6.1e-6 * max, a batch norm scale's velocity; MNIST
9.5e-6 * max, a conv filter after Adam, which moves an element whose grad
is near rounding noise by a different fraction of the learning rate);
served logits |d| <= 1e-5 * max|want| + 1e-6 (measured 2.0e-7 * max).
"""

import json

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.inference import predictor as j_predictor
from paddle_tpu.models import mnist as j_mnist
from paddle_tpu.models import resnet as j_resnet

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import inference as t_inference
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.models import mnist as t_mnist
from paddle_tpu_torch.models import resnet as t_resnet

LOSS_RTOL = 1e-5
STATE_REL, STATE_ABS = 1e-5, 1e-6

BUILDERS = {
    "resnet_cifar8_train": ("resnet", dict(dataset="cifar10", depth=8,
                                           lr=0.1)),
    "resnet_cifar8_test": ("resnet", dict(dataset="cifar10", depth=8,
                                          is_train=False)),
    "resnet50_imagenet_train": ("resnet", dict(dataset="imagenet",
                                               depth=50)),
    "resnet50_imagenet_test": ("resnet", dict(dataset="imagenet", depth=50,
                                              is_train=False)),
    "mnist_mlp": ("mnist", dict()),
    "mnist_conv_net": ("mnist", dict(use_conv=True)),
}


def _build(name):
    """(JAX package's (main, startup, handles), the port's)."""
    model, kwargs = BUILDERS[name]
    j_mod, t_mod = {"resnet": (j_resnet, t_resnet),
                    "mnist": (j_mnist, t_mnist)}[model]
    with j_unique_name.guard():
        j = j_mod.get_model(**kwargs)
    with t_unique_name.guard():
        t = t_mod.get_model(**kwargs)
    return j, t


def _same_desc(j_prog, t_prog):
    j_desc = j_prog.desc.serialize_to_string()
    t_desc = t_prog.desc.serialize_to_string()
    if t_desc != j_desc:  # name the first op or var that differs
        jd, td = json.loads(j_desc), json.loads(t_desc)
        assert [o["type"] for o in td["blocks"][0]["ops"]] == \
            [o["type"] for o in jd["blocks"][0]["ops"]]
        assert td == jd
    assert t_desc == j_desc


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_desc_parity(name):
    (j_main, j_startup, _), (t_main, t_startup, _) = _build(name)
    _same_desc(j_main, t_main)
    _same_desc(j_startup, t_startup)
    types = {op.type for op in t_main.desc.global_block().ops}
    assert {"top_k", "accuracy", "softmax"} <= types
    if name.startswith("resnet"):
        assert {"conv2d", "batch_norm", "pool2d"} <= types
        assert (any(op.type == "conv2d_grad"
                    for op in t_main.desc.global_block().ops)
                == name.endswith("train"))


@pytest.mark.parametrize("name", ["resnet_cifar8_train",
                                  "resnet50_imagenet_train"])
def test_for_test_clone_desc_parity(name):
    (j_main, _, _), (t_main, _, _) = _build(name)
    _same_desc(j_main.clone(for_test=True), t_main.clone(for_test=True))


def _close(got, want, what):
    peak = float(np.abs(want).max())
    d = float(np.abs(np.asarray(got) - want).max())
    assert d <= STATE_REL * peak + STATE_ABS, (what, d, peak)


def _steps_match(name, feed, steps=3):
    (j_main, j_startup, jh), (t_main, _, th) = _build(name)
    names = sorted(v.name for v in j_main.list_vars() if v.persistable)
    fetch = [jh["loss"].name, jh["acc"].name]
    j_exe, j_scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(j_scope):
        j_exe.run(j_startup)
        state = {n: np.array(j_scope.get(n)) for n in names}
        want = [[float(np.asarray(v).reshape(-1)[0])
                 for v in j_exe.run(j_main, feed=feed, fetch_list=fetch)]
                for _ in range(steps)]
        want_state = {n: np.array(j_scope.get(n)) for n in names}
    t_exe, t_scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    with tfluid.scope_guard(t_scope):
        got = [[float(np.asarray(v).reshape(-1)[0])
                for v in t_exe.run(t_main, feed=feed, fetch_list=fetch)]
               for _ in range(steps)]
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=LOSS_RTOL)
    assert [g[1] for g in got] == [w[1] for w in want]
    for n in names:
        _close(t_scope.get(n).numpy(), want_state[n], n)
    return got, names


def test_resnet_cifar8_three_momentum_steps_match_jax():
    """Momentum 0.9 at lr 0.1 on one repeated batch: the losses fall (the
    batch is memorised) and every parameter, velocity and running
    statistic agrees after each package's 3 steps."""
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(4, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    got, names = _steps_match("resnet_cifar8_train", feed)
    assert got[-1][0] < got[0][0]
    assert sum(n.endswith((".mean_0", ".var_0")) for n in names) == 18


def test_mnist_conv_net_three_adam_steps_match_jax():
    rng = np.random.RandomState(1)
    feed = {"img": rng.randn(8, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    _steps_match("mnist_conv_net", feed)


def test_jax_saved_resnet_served_by_port(tmp_path):
    """The JAX package initialises ResNet cifar10 depth 8, its running
    statistics are set away from their init (mean 0, variance 1), and it
    saves the inference program (``img`` -> ``logits``); both predictors
    serve the directory."""
    (j_infer, j_startup, jih), _ = _build("resnet_cifar8_test")
    rng = np.random.RandomState(2)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
        for op in j_infer.desc.global_block().ops:
            if op.type == "batch_norm":
                (mean,), (var,) = op.input("Mean"), op.input("Variance")
                c = np.asarray(scope.get(mean)).shape
                scope.set(mean, rng.randn(*c).astype(np.float32))
                scope.set(var, rng.rand(*c).astype(np.float32) + 0.5)
        jfluid.io.save_inference_model(str(tmp_path), ["img"],
                                       [jih["logits"]], exe,
                                       main_program=j_infer)
    feed = {"img": rng.randn(3, 3, 32, 32).astype(np.float32)}
    cfg = j_predictor.AnalysisConfig(str(tmp_path))
    cfg.disable_gpu()
    cfg.switch_ir_optim(False)  # opt level 0: the desc as saved
    want = j_predictor.create_paddle_predictor(cfg).run(feed)[0].data
    cfg = t_inference.AnalysisConfig(str(tmp_path))
    cfg.disable_gpu()
    got = t_inference.create_paddle_predictor(cfg).run(feed)[0].data
    assert got.shape == want.shape == (3, 10)
    _close(got, want, "logits")


def test_for_test_clone_is_deterministic_and_reads_running_stats():
    """(the JAX package's ``tests/test_models.py:212``) The clone runs
    without labels, answers twice alike, and leaves every persistable as
    the training step left it."""
    _, (main, startup, h) = _build("resnet_cifar8_train")
    test_prog = main.clone(for_test=True)
    assert all(op.attrs["is_test"] for op in test_prog.desc.global_block().ops
               if op.type == "batch_norm")
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, (4, 1)).astype(np.int64)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    names = [v.name for v in main.list_vars() if v.persistable]
    with tfluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed={"img": x, "label": y}, fetch_list=[h["loss"]])
        before = {n: scope.get(n).clone() for n in names}
        (p1,) = exe.run(test_prog, feed={"img": x},
                        fetch_list=[h["logits"]])
        (p2,) = exe.run(test_prog, feed={"img": x},
                        fetch_list=[h["logits"]])
    assert np.array_equal(p1, p2)
    assert all(bool((scope.get(n) == before[n]).all()) for n in names)
    assert not np.allclose(before["batch_norm_0.mean_0"].numpy(), 0.0)
