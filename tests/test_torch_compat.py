"""The port's ``compat.py`` (the reference's framework.proto programs and
tensor streams) against the JAX package's, on the CPU.

- The same program serializes to the same ``__model__`` bytes in both
  packages (``serialize_program_desc``), and each package parses the
  other's bytes back to them; ``save_reference_var`` writes the same
  bytes, bfloat16 included, and each package reads the other's files.
- A reference-format inference directory written by the JAX package is
  served by the port, and one the port writes is served by the JAX
  package: an MLP and a 2-layer BERT encoder (d_model 64), answers within
  rtol 1e-5 / atol 1e-5 (float32, the same formulas in other summation
  orders). On the port alone the reference format and the native one
  answer bitwise equal.
- ``Program.parse_from_string`` reads reference bytes; the misc ``load``
  op reads a reference-stream variable through ``compat``; the wire
  encoder of ``tests/test_compat_import.py`` is the oracle the importer
  is held to.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import compat as j_compat
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.desc import ProgramDescData as JProgramDescData
from paddle_tpu.core.desc import VarDescData as JVarDescData
from paddle_tpu.models import bert as j_bert

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import compat, unique_name
from paddle_tpu_torch.core.desc import OpDesc, ProgramDescData, VarDescData
from paddle_tpu_torch.models import bert as t_bert
from paddle_tpu_torch.ops import misc_ops

import test_compat_import as oracle

RTOL = ATOL = 1e-5
BERT_CFG = dict(batch_size=2, seq_len=16, vocab_size=50, d_model=64,
                n_layers=2, n_heads=2, d_inner=128, max_position=32,
                is_train=False)
BERT_FEEDS = ["src_ids", "pos_ids", "sent_ids", "seq_lens"]


def _mlp(fluid_, unique_name_):
    main, startup = fluid_.Program(), fluid_.Program()
    with unique_name_.guard(), fluid_.program_guard(main, startup):
        x = fluid_.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid_.layers.fc(input=x, size=6, act="relu")
        p = fluid_.layers.fc(input=h, size=3, act="softmax")
    main.random_seed = startup.random_seed = 5
    return main, startup, ["x"], p


def _bert(fluid_, unique_name_, bert):
    with unique_name_.guard():
        main, startup, h = bert.get_model(**BERT_CFG)
    main.random_seed = startup.random_seed = 5
    return main, startup, BERT_FEEDS, h["enc_out"]


def _models(name):
    if name == "mlp":
        return _mlp(jfluid, j_unique_name), _mlp(fluid, unique_name)
    return (_bert(jfluid, j_unique_name, j_bert),
            _bert(fluid, unique_name, t_bert))


def _feed(name):
    rng = np.random.RandomState(4)
    if name == "mlp":
        return {"x": rng.randn(4, 8).astype(np.float32)}
    b = t_bert.make_fake_batch(2, BERT_CFG["seq_len"],
                               BERT_CFG["vocab_size"], rng=rng, varlen=True)
    return {k: b[k] for k in BERT_FEEDS}


def _attr_corner_desc(program_desc, var_desc, op_desc):
    prog = program_desc()
    gb = prog.global_block()
    gb.vars["v"] = var_desc("v", shape=[-1, 4], dtype="float32")
    gb.ops.append(op_desc(
        "dummy", {"X": ["v"]}, {"Out": ["v"]},
        {"b": True, "i": 7, "f": 0.5, "s": "hi",
         "ints": [1, 2], "floats": [1.0, 2.0], "strs": ["a", "b"],
         "long": 1 << 40, "longs": [1 << 40, 2],
         "skipme": {"not": "encodable"}}))
    return prog


# -- the program's bytes -------------------------------------------------------
@pytest.mark.parametrize("name", ["mlp", "bert"])
@pytest.mark.parametrize("which", ["main", "startup"])
def test_serialize_program_desc_bytes_equal(name, which):
    (jm, js, _, _), (tm, ts, _, _) = _models(name)
    j_prog, t_prog = (jm, tm) if which == "main" else (js, ts)
    j_bytes = j_compat.serialize_program_desc(j_prog.desc)
    t_bytes = compat.serialize_program_desc(t_prog.desc)
    assert t_bytes == j_bytes
    # each package parses the other's bytes back to them
    assert compat.serialize_program_desc(
        compat.parse_program_desc(j_bytes)) == j_bytes
    assert j_compat.serialize_program_desc(
        j_compat.parse_program_desc(t_bytes)) == t_bytes


def test_attr_corner_cases_encode_alike():
    t = compat.serialize_program_desc(
        _attr_corner_desc(ProgramDescData, VarDescData, OpDesc))
    j = j_compat.serialize_program_desc(
        _attr_corner_desc(JProgramDescData, JVarDescData, JOpDesc))
    assert t == j
    op = compat.parse_program_desc(t).global_block().ops[0]
    assert op.attrs["long"] == 1 << 40 and "skipme" not in op.attrs


# -- tensor streams ------------------------------------------------------------
STREAM_ARRAYS = {
    "float32": np.random.RandomState(0).randn(3, 5).astype(np.float32),
    "int64": np.arange(-6, 6, dtype=np.int64).reshape(3, 4),
    "int32": np.arange(7, dtype=np.int32),
    "float16": np.linspace(-2, 2, 9).astype(np.float16).reshape(3, 3),
    "float64": np.linspace(0, 1, 4),
    "bool": np.array([True, False, True]),
}


@pytest.mark.parametrize("dtype", sorted(STREAM_ARRAYS) + ["bfloat16"])
def test_save_reference_var_bytes_equal(tmp_path, dtype):
    if dtype == "bfloat16":
        f32 = STREAM_ARRAYS["float32"]
        j_val = f32.astype(ml_dtypes.bfloat16)
        t_val = torch.from_numpy(f32).to(torch.bfloat16)
    else:
        j_val = STREAM_ARRAYS[dtype]
        t_val = j_val if dtype != "float32" else torch.from_numpy(j_val)
    j_compat.save_reference_var(j_val, str(tmp_path / "j"))
    compat.save_reference_var(t_val, str(tmp_path / "t"))
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    got = compat.load_reference_var(str(tmp_path / "j"))
    back = j_compat.load_reference_var(str(tmp_path / "t"))
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      j_val.view(np.int16))
        np.testing.assert_array_equal(back.view(np.int16),
                                      j_val.view(np.int16))
    else:
        np.testing.assert_array_equal(got, j_val)
        assert got.dtype == j_val.dtype
        np.testing.assert_array_equal(back, j_val)


def test_load_reference_var_reads_the_oracle_stream(tmp_path):
    arr = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    (tmp_path / "v").write_bytes(oracle._reference_tensor_bytes(arr))
    np.testing.assert_array_equal(compat.load_reference_var(
        str(tmp_path / "v")), arr)


# -- inference directories across the packages ----------------------------------
def _save_jax(name, d):
    jm, js, feeds, target = _models(name)[0]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(js)
        jfluid.io.save_inference_model(d, feeds, [target], exe,
                                       main_program=jm,
                                       export_format="reference")


def _save_port(name, d, export_format="reference"):
    tm, ts, feeds, target = _models(name)[1]
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(ts)
        fluid.io.save_inference_model(d, feeds, [target], exe,
                                      main_program=tm,
                                      export_format=export_format)


def _serve_port(d, feed):
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        program, feeds, fetches = compat.load_reference_inference_model(
            d, exe, scope=scope)
        assert sorted(feeds) == sorted(feed)
        (out,) = exe.run(program, feed=feed,
                         fetch_list=[v.name for v in fetches])
    return out


def _serve_jax(d, feed):
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        program, feeds, fetches = j_compat.load_reference_inference_model(
            d, exe, scope=scope)
        assert sorted(feeds) == sorted(feed)
        (out,) = exe.run(program, feed=feed,
                         fetch_list=[v.name for v in fetches])
    return np.asarray(out)


@pytest.mark.parametrize("name", ["mlp", "bert"])
def test_jax_reference_model_served_by_the_port(tmp_path, name):
    d = str(tmp_path / "ref")
    _save_jax(name, d)
    feed = _feed(name)
    np.testing.assert_allclose(_serve_port(d, feed), _serve_jax(d, feed),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["mlp", "bert"])
def test_port_reference_model_served_by_jax(tmp_path, name):
    d = str(tmp_path / "ref")
    _save_port(name, d)
    feed = _feed(name)
    np.testing.assert_allclose(_serve_jax(d, feed), _serve_port(d, feed),
                               rtol=RTOL, atol=ATOL)
    # the JAX package's own export of the model: the same files and the
    # same __model__ bytes (the weights are each package's own draws)
    dj = str(tmp_path / "jref")
    _save_jax(name, dj)
    assert sorted(os.listdir(dj)) == sorted(os.listdir(d))
    assert (tmp_path / "ref" / "__model__").read_bytes() == \
        (tmp_path / "jref" / "__model__").read_bytes()


@pytest.mark.parametrize("name", ["mlp", "bert"])
def test_reference_and_native_formats_answer_alike(tmp_path, name):
    """The port serves its reference export bitwise as its native one."""
    ref, nat = str(tmp_path / "ref"), str(tmp_path / "nat")
    _save_port(name, ref)
    _save_port(name, nat, export_format="native")
    feed = _feed(name)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        program, _, fetches = fluid.io.load_inference_model(nat, exe)
        (want,) = exe.run(program, feed=feed, fetch_list=fetches)
    np.testing.assert_array_equal(_serve_port(ref, feed), want)


def test_oracle_model_served_by_the_port(tmp_path):
    w = np.random.RandomState(1).randn(4, 2).astype(np.float32)
    oracle._write_model(tmp_path, w)
    x = np.random.RandomState(2).randn(6, 4).astype(np.float32)
    out = _serve_port(str(tmp_path), {"x": x})
    logits = x @ w
    e = np.exp(logits - logits.max(1, keepdims=True))
    np.testing.assert_allclose(out, e / e.sum(1, keepdims=True),
                               rtol=RTOL, atol=1e-6)


# -- parse_from_string and the load op -------------------------------------------
def test_parse_from_string_reads_reference_bytes():
    (jm, _, _, _), (tm, _, _, _) = _models("mlp")
    ref = j_compat.serialize_program_desc(jm.desc)
    prog = fluid.Program.parse_from_string(ref)
    assert compat.serialize_program_desc(prog.desc) == ref
    assert [op.type for op in prog.global_block().desc.ops] == \
        [op.type for op in tm.desc.global_block().ops]
    native = fluid.Program.parse_from_string(tm.desc.serialize_to_string())
    assert native.desc.serialize_to_string() == \
        tm.desc.serialize_to_string()
    with pytest.raises(ValueError, match="neither the native format"):
        fluid.Program.parse_from_string(b"\xff\xff\xff not a program")


def test_load_op_reads_a_reference_var_through_compat(tmp_path):
    assert not hasattr(misc_ops, "_load_reference_var")
    arr = np.random.RandomState(3).randn(2, 3).astype(np.float32)
    path = str(tmp_path / "w")
    with open(path, "wb") as f:
        f.write(oracle._reference_tensor_bytes(arr))
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        out = main.global_block().create_var(name="w_out", shape=[2, 3],
                                             dtype="float32")
        fluid.layers.load(out, path)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        (got,) = exe.run(main, fetch_list=[out])
    np.testing.assert_array_equal(got, arr)
