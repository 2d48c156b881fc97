"""The dense families' layers (ROADMAP Queue 1, step 5c; item 6) in the
port against the JAX package's, on the CPU.

- Each new layer of ``layers/nn.py``, ``layers/tensor.py``,
  ``layers/loss.py`` and ``layers/metric_op.py`` builds a main and a
  startup desc byte-identical to the reference's (ops, slots, attrs and
  the shapes inferred at build time), and both packages export it alike.
- chip_smoke.py's ``upsample_head`` program (conv2d_transpose,
  group_norm, prelu, conv2d, resize_bilinear, softmax cross entropy,
  Momentum) at [2, 64, 4, 4]: the same descs from both front ends; one
  step on each executor from the reference's startup state (carried into
  the port by name): loss rtol 1e-5, every parameter grad within 1e-4 of
  its largest element (float32 on both sides, summed in other orders).
"""

import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as j_program_guard
from paddle_tpu.layers import loss as j_loss
from paddle_tpu.layers import nn as j_nn
from paddle_tpu.layers import tensor as j_tensor

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.layers import loss as t_loss
from paddle_tpu_torch.layers import nn as t_nn
from paddle_tpu_torch.layers import tensor as t_tensor

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                               "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LOSS_RTOL = 1e-5
GRAD_REL_TO_MAX = 1e-4

FRONT_ENDS = ((jfluid, JProgram, j_program_guard, j_unique_name),
              (tfluid, tfluid.Program, tfluid.program_guard, t_unique_name))


def _program(layers, name):
    """One small program calling layer ``name`` of ``layers`` (either
    package's ``fluid.layers``)."""
    x = layers.data(name="x", shape=[4, 6], dtype="float32")
    img = layers.data(name="img", shape=[4, 6, 5], dtype="float32")
    ids = layers.data(name="ids", shape=[1], dtype="int64")
    if name == "conv2d_transpose":
        return layers.conv2d_transpose(img, num_filters=6, filter_size=3,
                                       stride=2, padding=1, act="relu")
    if name == "conv2d_transpose_grouped":
        return layers.conv2d_transpose(img, num_filters=4, filter_size=[3, 2],
                                       dilation=2, groups=2, bias_attr=False)
    if name == "group_norm":
        return layers.group_norm(img, groups=2, act="relu")
    if name == "group_norm_noaffine":
        return layers.group_norm(img, groups=4, param_attr=False,
                                 bias_attr=False, epsilon=1e-3)
    if name == "squeeze":
        y = layers.data(name="y", shape=[4, 1, 6], dtype="float32")
        return layers.squeeze(y, axes=[2])
    if name == "stack":
        return layers.stack([x, x, x], axis=1)
    if name == "unstack":
        return layers.unstack(x, axis=1)
    if name == "gather":
        return layers.gather(x, layers.reshape(ids, shape=[-1]))
    if name == "scatter":
        table = layers.data(name="table", shape=[6], dtype="float32",
                            append_batch_size=False)
        rows = layers.data(name="rows", shape=[3], dtype="int64",
                           append_batch_size=False)
        upd = layers.data(name="upd", shape=[3], dtype="float32",
                          append_batch_size=False)
        return layers.scatter(table, rows, upd, overwrite=False)
    if name == "l2_normalize":
        return layers.l2_normalize(x, axis=1, epsilon=1e-6)
    if name == "pad":
        return layers.pad(x, paddings=[0, 0, 1, 2, 0, 3], pad_value=0.5)
    if name == "pad2d":
        return layers.pad2d(img, paddings=[1, 0, 2, 1], mode="reflect")
    if name == "lrn":
        return layers.lrn(img, n=3, alpha=1e-3)
    if name.startswith("prelu_"):
        return layers.prelu(img, mode=name[len("prelu_"):])
    if name == "maxout":
        return layers.maxout(img, groups=2)
    if name == "image_resize":
        return layers.image_resize(img, scale=2.0, resample="NEAREST")
    if name == "resize_bilinear":
        return layers.resize_bilinear(img, out_shape=[9, 7],
                                      align_corners=False, align_mode=0)
    if name == "resize_nearest":
        return layers.resize_nearest(img, out_shape=[3, 10])
    if name == "image_resize_short":
        return layers.image_resize_short(img, 10)
    if name == "shape":
        return layers.shape(img)
    if name == "cumsum":
        return [layers.cumsum(x, axis=1, exclusive=True),
                layers.cumsum(x)]
    if name == "dot_product_attention":
        return layers.dot_product_attention(x, x, x)
    if name == "flatten":
        return layers.flatten(img, axis=2)
    if name == "adaptive_pool2d":
        y = layers.data(name="y", shape=[3, 4, 6], dtype="float32")
        return layers.adaptive_pool2d(y, pool_size=[2, 3], pool_type="avg")
    if name == "create_parameter":
        return layers.create_parameter([3, 4], "float32", name="p")
    if name == "chunk_eval":
        tags = layers.data(name="tags", shape=[7], dtype="int64")
        lens = layers.data(name="lens", shape=[1], dtype="int64")
        return layers.chunk_eval(tags, tags, "IOB", 3,
                                 excluded_chunk_types=[1], seq_length=lens)
    if name == "create_tensor":
        return layers.create_tensor("float32", persistable=True)
    if name == "create_global_var":
        return layers.create_global_var([2, 3], 1.5, "float32",
                                        persistable=True)
    if name in ("zeros", "ones"):
        return getattr(layers, name)([2, 3], "int64")
    if name == "reverse":
        return [layers.reverse(x, axis=1), layers.reverse(x, axis=[0, 2])]
    if name in ("argmax", "argmin"):
        return getattr(layers, name)(x, axis=2)
    if name == "argsort":
        return layers.argsort(x, axis=1)
    label = layers.data(name="label", shape=[6], dtype="float32")
    if name == "log_loss":
        return layers.log_loss(layers.sigmoid(x), label, epsilon=1e-3)
    if name == "huber_loss":
        return layers.huber_loss(x, label, delta=0.5)
    if name == "smooth_l1":
        return layers.smooth_l1(x, label, sigma=2.0)
    if name == "kldiv_loss":
        return layers.kldiv_loss(layers.log_softmax(x), label,
                                 reduction="batchmean")
    if name == "hinge_loss":
        return layers.hinge_loss(x, label)
    assert name == "auc"
    probs = layers.softmax(layers.fc(input=x, size=2))
    return layers.auc(probs, ids, num_thresholds=31)


NN_LAYERS = ["conv2d_transpose", "conv2d_transpose_grouped", "group_norm",
             "group_norm_noaffine", "squeeze", "stack", "unstack", "gather",
             "scatter", "l2_normalize", "pad", "pad2d", "lrn", "prelu_all",
             "prelu_channel", "prelu_element", "maxout", "image_resize",
             "resize_bilinear", "resize_nearest", "image_resize_short",
             "shape", "cumsum", "dot_product_attention", "flatten",
             "adaptive_pool2d", "create_parameter", "chunk_eval"]
TENSOR_LAYERS = ["create_tensor", "create_global_var", "zeros", "ones",
                 "reverse", "argmax", "argmin", "argsort"]
LOSS_LAYERS = ["log_loss", "huber_loss", "smooth_l1", "kldiv_loss",
               "hinge_loss"]
LAYERS = NN_LAYERS + TENSOR_LAYERS + LOSS_LAYERS + ["auc"]


def _descs(build):
    out = []
    for fluid_mod, prog_cls, guard, unique in FRONT_ENDS:
        main, startup = prog_cls(), prog_cls()
        with unique.guard(), guard(main, startup):
            build(fluid_mod)
        out.append((main.desc.serialize_to_string(),
                    startup.desc.serialize_to_string()))
    return out


@pytest.mark.parametrize("name", LAYERS)
def test_layer_desc_matches_reference(name):
    """Each layer appends the reference's ops, slots, attrs and vars (with
    the shapes inferred at build time), and its startup program the same
    initializers."""
    want, got = _descs(lambda fluid: _program(fluid.layers, name))
    assert got == want


@pytest.mark.parametrize("module,names", [
    ((j_nn, t_nn), [n.split("_grouped")[0].split("_noaffine")[0]
                    for n in NN_LAYERS if not n.startswith("prelu_")]
     + ["prelu"]),
    ((j_tensor, t_tensor), TENSOR_LAYERS),
    ((j_loss, t_loss), LOSS_LAYERS)], ids=["nn", "tensor", "loss"])
def test_layers_exported_as_in_reference(module, names):
    """The new names stand in the module's ``__all__`` and in
    ``fluid.layers`` of both packages."""
    j_mod, t_mod = module
    for n in names:
        assert n in j_mod.__all__ and n in t_mod.__all__, n
        assert hasattr(jfluid.layers, n) and hasattr(tfluid.layers, n), n
    assert hasattr(tfluid.layers, "auc")


def test_image_resize_refuses_a_fed_shape():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name="img", shape=[2, 4, 4],
                                 dtype="float32")
        shape = tfluid.layers.data(name="s", shape=[2], dtype="int32")
        with pytest.raises(NotImplementedError, match="actual_shape"):
            tfluid.layers.resize_bilinear(img, out_shape=[8, 8],
                                          actual_shape=shape)


HEAD = dict(channels=64, hw=4, widths=(32, 16), groups=4, classes=21,
            out_hw=32, lr=0.01)


def _head(fluid_mod, prog_cls, guard, unique):
    main, startup = prog_cls(), prog_cls()
    with unique.guard(), guard(main, startup):
        loss = chip_smoke.upsample_head(fluid_mod, **HEAD)
    return main, startup, loss


def test_upsample_head_step_matches_reference():
    """The FCN decoder of chip_smoke.py at [2, 64, 4, 4]: the same descs,
    and one Momentum step on each executor from the same state."""
    (j_main, j_startup, j_loss_v), (t_main, t_startup, t_loss_v) = (
        _head(*fe) for fe in FRONT_ENDS)
    assert t_main.desc.serialize_to_string() == \
        j_main.desc.serialize_to_string()
    assert t_startup.desc.serialize_to_string() == \
        j_startup.desc.serialize_to_string()
    feed = chip_smoke.upsample_feed(2, seed=5, **HEAD)
    grads = [p.name + "@GRAD" for p in t_main.all_parameters()]
    assert len(grads) == 10

    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    names = sorted(v.name for v in j_main.list_vars() if v.persistable)
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
        state = {n: np.array(scope.get(n)) for n in names}
        want = exe.run(j_main, feed=feed,
                       fetch_list=[j_loss_v.name] + grads)
    t_scope = tfluid.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    with tfluid.scope_guard(t_scope):
        got = tfluid.Executor(tfluid.CPUPlace()).run(
            t_main, feed=feed, fetch_list=[t_loss_v.name] + grads)
    np.testing.assert_allclose(np.asarray(got[0]).reshape(()),
                               np.asarray(want[0]).reshape(()),
                               rtol=LOSS_RTOL)
    for n, g, w in zip(grads, got[1:], want[1:]):
        w = np.asarray(w)
        assert g.shape == w.shape, n
        np.testing.assert_allclose(g, w, rtol=0, err_msg=n,
                                   atol=GRAD_REL_TO_MAX * np.abs(w).max())
