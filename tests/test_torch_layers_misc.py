"""The misc family's 42 layers (ROADMAP Queue 1, step 5e; item 6) in the
port against the JAX package's, on the CPU: each builds a main and a
startup desc byte-identical to the reference's (ops, slots, attrs and
the shapes inferred at build time), both packages export it alike, the
identities stay identities and the layers that raise in the JAX package
raise in the port. ``py_func``'s ids and ``load``'s attrs match, and
``load`` reads a ``.npy`` file and a reference-format file in both.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import compat
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as j_program_guard
from paddle_tpu.layers import nn as j_nn

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.layers import nn as t_nn

from torch_py_func_ids import _align_py_func_registries

FRONT_ENDS = ((jfluid, JProgram, j_program_guard, j_unique_name),
              (tfluid, tfluid.Program, tfluid.program_guard, t_unique_name))


def _square(a):
    return a * a


def _square_grad(a, dout):
    return 2.0 * a * dout


def _program(fluid, name, path=None):
    """One small program calling layer ``name`` of ``fluid`` (either
    package's)."""
    layers = fluid.layers
    x = layers.data(name="x", shape=[6], dtype="float32")
    img = layers.data(name="img", shape=[4, 6, 6], dtype="float32")
    vol = layers.data(name="vol", shape=[3, 4, 8, 8], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    if name == "cos_sim":
        return layers.cos_sim(x, layers.fc(input=x, size=6))
    if name == "affine_channel":
        s = layers.create_parameter([4], "float32", name="s")
        b = layers.create_parameter([4], "float32", name="b", is_bias=True)
        return layers.affine_channel(img, scale=s, bias=b)
    if name == "shuffle_channel":
        return layers.shuffle_channel(img, group=2)
    if name == "space_to_depth":
        return layers.space_to_depth(img, blocksize=2)
    if name == "crop":
        like = layers.data(name="like", shape=[2, 3, 3], dtype="float32")
        off = layers.data(name="off", shape=[4], dtype="int32",
                          append_batch_size=False)
        return [layers.crop(img, shape=[2, 2, 3, 4], offsets=[0, 1, 2, 1]),
                layers.crop(img, shape=like, offsets=off)]
    if name == "pad_constant_like":
        small = layers.data(name="small", shape=[2, 3, 3], dtype="float32")
        return layers.pad_constant_like(img, small, pad_value=0.5)
    if name == "multiplex":
        return layers.multiplex([x, layers.relu(x)], label)
    if name == "bilinear_tensor_product":
        y = layers.data(name="y", shape=[3], dtype="float32")
        return [layers.bilinear_tensor_product(x, y, size=4, act="tanh"),
                layers.bilinear_tensor_product(x, y, size=2,
                                               bias_attr=False)]
    if name in ("rank_loss", "margin_rank_loss"):
        lab = layers.data(name="lab", shape=[1], dtype="float32")
        left = layers.fc(input=x, size=1)
        right = layers.fc(input=x, size=1)
        if name == "rank_loss":
            return layers.rank_loss(lab, left, right)
        return layers.margin_rank_loss(lab, left, right, margin=0.2)
    if name == "bpr_loss":
        return layers.bpr_loss(layers.softmax(x), label)
    if name == "teacher_student_sigmoid_loss":
        soft = layers.data(name="soft", shape=[1], dtype="float32")
        return layers.teacher_student_sigmoid_loss(
            layers.fc(input=x, size=1), soft, soft_max_up_bound=10.0)
    if name == "dice_loss":
        seg = layers.data(name="seg", shape=[6], dtype="float32")
        return layers.dice_loss(layers.softmax(x), seg)
    if name == "mean_iou":
        pred = layers.data(name="pred", shape=[8], dtype="int32")
        return list(layers.mean_iou(pred, pred, num_classes=4))
    if name == "sampling_id":
        return layers.sampling_id(layers.softmax(x))
    if name == "random_crop":
        return layers.random_crop(img, shape=[3, 4])
    if name == "add_position_encoding":
        seq = layers.data(name="seq", shape=[5, 6], dtype="float32")
        return layers.add_position_encoding(seq, alpha=0.5, beta=1.5)
    if name == "hash":
        return [layers.hash(label, hash_size=1000),
                layers.hash(label, hash_size=50, num_hash=2),
                layers.hash(label, hash_size=50, num_hash=3)]
    if name in ("grid_sampler", "affine_grid"):
        theta = layers.data(name="theta", shape=[2, 3], dtype="float32")
        shape = layers.data(name="shape", shape=[4], dtype="int32",
                            append_batch_size=False)
        grid = layers.affine_grid(theta, out_shape=[-1, 4, 5, 5])
        return [layers.grid_sampler(img, grid),
                layers.affine_grid(theta, out_shape=shape)]
    if name == "ctc_greedy_decoder":
        probs = layers.data(name="probs", shape=[7, 5], dtype="float32")
        return list(layers.ctc_greedy_decoder(probs, blank=0))
    if name == "selu":
        return [layers.selu(x), layers.selu(x, scale=1.5, alpha=0.5)]
    if name in ("has_inf", "has_nan", "isfinite"):
        return getattr(layers, name)(x)
    if name == "is_empty":
        cond = layers.fill_constant(shape=[1], dtype="bool", value=False)
        return [layers.is_empty(x), layers.is_empty(img, cond=cond)]
    if name == "conv3d":
        return [layers.conv3d(vol, num_filters=5, filter_size=3, padding=1,
                              act="relu"),
                layers.conv3d(vol, num_filters=6, filter_size=[1, 3, 3],
                              stride=[1, 2, 2], groups=3, bias_attr=False)]
    if name == "conv3d_transpose":
        return [layers.conv3d_transpose(vol, num_filters=2, filter_size=2,
                                        stride=2),
                layers.conv3d_transpose(vol, num_filters=4, filter_size=3,
                                        stride=2, padding=1, act="relu")]
    if name == "pool3d":
        return [layers.pool3d(vol, pool_size=[1, 2, 2], pool_stride=[1, 2, 2]),
                layers.pool3d(vol, pool_size=3, pool_type="avg",
                              pool_stride=2, pool_padding=1,
                              exclusive=False),
                layers.pool3d(vol, global_pooling=True)]
    if name == "adaptive_pool3d":
        return [layers.adaptive_pool3d(vol, pool_size=[2, 4, 4]),
                layers.adaptive_pool3d(vol, pool_size=1, pool_type="avg")]
    if name == "nce":
        cost = layers.nce(layers.fc(input=x, size=4), label,
                          num_total_classes=20, num_neg_samples=3)
        return [cost, layers.nce(x, label, num_total_classes=9,
                                 bias_attr=False, is_sparse=True)]
    if name == "hsigmoid":
        return [layers.hsigmoid(x, label, num_classes=10),
                layers.hsigmoid(x, label, num_classes=4, bias_attr=False)]
    if name in ("lod_reset", "reorder_lod_tensor_by_rank"):
        h = layers.fc(input=x, size=3)
        out = (layers.lod_reset(h, y=x) if name == "lod_reset"
               else layers.reorder_lod_tensor_by_rank(h, None))
        assert out is h
        return layers.scale(out, scale=2.0)
    if name == "data_norm":
        return [layers.data_norm(x, act="relu"),
                layers.data_norm(x, name="dn")]
    if name in ("uniform_random_batch_size_like",
                "gaussian_random_batch_size_like"):
        return getattr(layers, name)(x, shape=[-1, 3, 2])
    if name == "Print":
        return [layers.Print(x), layers.Print(x, message="probe")]
    if name == "psroi_pool":
        rois = layers.data(name="rois", shape=[4], dtype="float32")
        idx = layers.data(name="idx", shape=[-1], dtype="int64",
                          append_batch_size=False)
        return [layers.psroi_pool(img, rois, 1, 0.5, 2, 2),
                layers.psroi_pool(img, rois, 1, 1.0, 2, 2,
                                  rois_batch_idx=idx)]
    if name == "py_func":
        block = fluid.default_main_program().global_block()
        o = block.create_var(name="pyf_out", shape=[-1, 6],
                             dtype="float32")
        o2 = block.create_var(name="pyf_out2", shape=[2, 2], dtype="int64")
        layers.py_func(_square, x, o, backward_func=_square_grad)
        layers.py_func(_square, [x, img], [o2])
        return layers.mean(o)
    if name == "load":
        block = fluid.default_main_program().global_block()
        out = block.create_var(name="loaded", shape=[4, 3], dtype="float32")
        out16 = block.create_var(name="loaded16", shape=[4, 3],
                                 dtype="float16")
        layers.load(out, path)
        return layers.load(out16, path, load_as_fp16=True)
    if name == "tree_conv":
        nodes = layers.data(name="nodes", shape=[10, 5], dtype="float32")
        edges = layers.data(name="edges", shape=[10, 2], dtype="int32")
        return [layers.tree_conv(nodes, edges, 6, num_filters=2),
                layers.tree_conv(nodes, edges, 3, max_depth=3, act=None,
                                 bias_attr=True, name="tc")]
    raise KeyError(name)


LAYERS = sorted([
    "Print", "adaptive_pool3d", "add_position_encoding", "affine_channel",
    "affine_grid", "bilinear_tensor_product", "bpr_loss", "conv3d",
    "conv3d_transpose", "cos_sim", "crop", "ctc_greedy_decoder",
    "data_norm", "dice_loss", "gaussian_random_batch_size_like",
    "grid_sampler", "has_inf", "has_nan", "hash", "hsigmoid", "is_empty",
    "isfinite", "load", "lod_reset", "margin_rank_loss", "mean_iou",
    "multiplex", "nce", "pad_constant_like", "pool3d", "psroi_pool",
    "py_func", "random_crop", "rank_loss", "reorder_lod_tensor_by_rank",
    "sampling_id", "selu", "shuffle_channel", "space_to_depth",
    "teacher_student_sigmoid_loss", "tree_conv",
    "uniform_random_batch_size_like"])


def _descs(build):
    out = []
    for fluid_mod, prog_cls, guard, unique in FRONT_ENDS:
        main, startup = prog_cls(), prog_cls()
        with unique.guard(), guard(main, startup):
            build(fluid_mod)
        out.append((main.desc.serialize_to_string(),
                    startup.desc.serialize_to_string()))
    return out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("load") / "w.npy")
    np.save(path, np.arange(12, dtype=np.float32).reshape(4, 3))
    return path


@pytest.mark.parametrize("name", LAYERS)
def test_layer_desc_matches_reference(name, saved):
    """Each layer appends the reference's ops, slots, attrs and vars (with
    the shapes inferred at build time), and its startup program the same
    initializers."""
    _align_py_func_registries()
    want, got = _descs(lambda fluid: _program(fluid, name, saved))
    assert got == want


def test_layers_exported_as_in_reference():
    assert len(LAYERS) == 42
    for n in LAYERS:
        assert n in j_nn.__all__ and n in t_nn.__all__, n
        assert hasattr(jfluid.layers, n) and hasattr(tfluid.layers, n), n


def test_py_func_ids_match_the_reference():
    """A program that registers new callables names the same ids in both
    packages when both registries are as long."""
    _align_py_func_registries()

    def fresh(a):
        return a + 1.0

    def fresh_grad(a, d):
        return d

    ids = []
    for fluid_mod, prog_cls, guard, unique in FRONT_ENDS:
        main = prog_cls()
        with unique.guard(), guard(main, prog_cls()):
            x = fluid_mod.layers.data(name="x", shape=[3], dtype="float32")
            o = main.global_block().create_var(name="o", shape=[-1, 3],
                                               dtype="float32")
            fluid_mod.layers.py_func(fresh, x, o, backward_func=fresh_grad)
        op = main.global_block().ops[-1]
        ids.append((op.attr("func_id"), op.attr("backward_func_id")))
    assert ids[0] == ids[1]
    assert ids[1][1] == ids[1][0] + 1


@pytest.mark.parametrize("fmt", ["npy", "reference"])
def test_load_reads_npy_and_reference_files(tmp_path, fmt):
    arr = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    path = str(tmp_path / ("w.npy" if fmt == "npy" else "w"))
    if fmt == "npy":
        np.save(path, arr)
    else:
        compat.save_reference_var(arr, path)
    got = []
    for fluid_mod, prog_cls, guard, unique in FRONT_ENDS:
        main, startup = prog_cls(), prog_cls()
        with unique.guard(), guard(main, startup):
            out = main.global_block().create_var(
                name="loaded_w", shape=[4, 3], dtype="float32")
            fluid_mod.layers.load(out, path)
        op = main.global_block().ops[-1]
        assert op.attr("file_path") == path
        assert op.attr("load_as_fp16") is False
        exe = fluid_mod.Executor(fluid_mod.CPUPlace())
        scope = fluid_mod.Scope()
        with fluid_mod.scope_guard(scope):
            exe.run(startup)
            (v,) = exe.run(main, feed={}, fetch_list=["loaded_w"])
        got.append(np.asarray(v))
    np.testing.assert_array_equal(got[0], arr)
    np.testing.assert_array_equal(got[1], arr)


def test_layers_that_raise_in_the_reference_raise():
    """``hsigmoid`` with a custom tree and ``adaptive_pool3d`` on dims
    that do not divide raise in both packages."""
    for fluid_mod, prog_cls, guard, unique in FRONT_ENDS:
        with unique.guard(), guard(prog_cls(), prog_cls()):
            x = fluid_mod.layers.data(name="x", shape=[6], dtype="float32")
            y = fluid_mod.layers.data(name="y", shape=[1], dtype="int64")
            vol = fluid_mod.layers.data(name="v", shape=[2, 3, 8, 8],
                                        dtype="float32")
            with pytest.raises(NotImplementedError):
                fluid_mod.layers.hsigmoid(x, y, num_classes=4,
                                          is_custom=True)
            with pytest.raises(ValueError):
                fluid_mod.layers.adaptive_pool3d(vol, pool_size=2)
