"""The port's reader layers (``paddle_tpu_torch/layers/io.py``), the
executor's ``py_reader`` feed and reqtrace's step seams against the JAX
package's, on the CPU.

- Programs built with ``py_reader``, ``create_py_reader_by_data`` and
  over ``open_files`` are byte-identical across the two packages.
- An MNIST MLP trained from ``dataset.mnist`` through
  ``reader.decorator.batch`` and a ``py_reader``: in the port its losses
  are bitwise equal to the same program fed by ``feed=``; against the
  JAX package's ``py_reader`` loop, from the same initial state, they
  agree at rtol 1e-5 (float32 on both sides, the training parity tests'
  tolerance).
- ``EOFException`` ends the epoch and ``start()`` begins the next; an
  epoch stopped halfway is ``reset()`` and restarted with no thread
  left behind and no hang.
- ``Preprocessor`` (run on ``CPUPlace()``) gives the JAX package's
  batches, rtol 1e-6.
- A windowed run (``dispatch_steps=2``) under an active trace emits the
  same ``step_enqueue``/``step_retire`` sequence, with the same ``step``
  and ``depth`` args, in both packages.
- ``fluid`` and ``fluid.layers`` carry the reference's reader names;
  ``open_files`` (raw and parsed, two passes), ``layers.shuffle`` (seeded)
  and ``layers.batch`` yield the JAX package's items exactly, and
  ``read_file``, ``double_buffer`` and ``random_data_generator`` keep
  their contracts.
"""

import threading

import numpy as np
import pytest

import paddle_tpu.dataset as j_dataset
import paddle_tpu.fluid as jfluid
import paddle_tpu.reader as j_reader
from paddle_tpu import observability as j_obs
from paddle_tpu import recordio_writer as j_recordio_writer
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as j_program_guard
from paddle_tpu.observability import reqtrace as j_reqtrace

import paddle_tpu_torch.dataset as t_dataset
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.reader as t_reader
from paddle_tpu_torch import convert
from paddle_tpu_torch import observability as t_obs
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.observability import reqtrace as t_reqtrace

LOSS_RTOL = 1e-5
BATCH = 16
STEPS = 6

PKGS = {
    "port": (tfluid, t_unique_name, tfluid.Program, tfluid.program_guard,
             t_reader, t_dataset),
    "jax": (jfluid, j_unique_name, JProgram, j_program_guard, j_reader,
            j_dataset),
}


def _mlp(pkg, make_input):
    fluid, unique_name, program_cls, guard = PKGS[pkg][:4]
    main, startup = program_cls(), program_cls()
    with unique_name.guard(), guard(main, startup):
        rd, img, label = make_input(fluid)
        h = fluid.layers.fc(input=img, size=32, act="relu")
        logits = fluid.layers.fc(input=h, size=10)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, rd, loss


def _by_py_reader(fluid):
    rd = fluid.layers.py_reader(capacity=4, shapes=[[-1, 784], [-1, 1]],
                                dtypes=["float32", "int64"], name="mnist")
    return (rd,) + tuple(rd.vars)


def _by_data(fluid):
    img = fluid.layers.data(name="img", shape=[784], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    rd = fluid.layers.create_py_reader_by_data(capacity=2,
                                               feed_list=[img, label])
    return (rd,) + tuple(rd.vars)


def _over_files(fluid):
    rd = fluid.layers.py_reader(capacity=2, shapes=[[-1, 3, 4], [-1, 1]],
                                dtypes=["uint8", "int64"])
    img = fluid.layers.cast(fluid.layers.reshape(rd.vars[0], [-1, 12]),
                            "float32")
    return rd, fluid.layers.scale(img, scale=1 / 255.0), rd.vars[1]


@pytest.mark.parametrize("make_input", [_by_py_reader, _by_data,
                                        _over_files])
def test_reader_programs_are_byte_identical(make_input):
    t_main, t_startup, t_rd, _ = _mlp("port", make_input)
    j_main, j_startup, j_rd, _ = _mlp("jax", make_input)
    assert t_rd.var_names == j_rd.var_names
    assert [r.var_names for r in t_main._py_readers] == \
        [r.var_names for r in j_main._py_readers]
    assert t_main.desc.serialize_to_string() == \
        j_main.desc.serialize_to_string()
    assert t_startup.desc.serialize_to_string() == \
        j_startup.desc.serialize_to_string()


def _mnist_batches(pkg):
    reader, dataset = PKGS[pkg][4:]

    def to_arrays(rows):
        return [np.stack([r[0] for r in rows]),
                np.asarray([[r[1]] for r in rows], np.int64)]

    return reader.map_readers(to_arrays, reader.batch(
        reader.firstn(dataset.mnist.train(), BATCH * STEPS), BATCH))


def _epoch(exe, main, loss, rd, fluid):
    rd.start()
    out = []
    while True:
        try:
            out.append(float(np.asarray(
                exe.run(main, fetch_list=[loss])[0])))
        except fluid.EOFException:
            return out


def test_mnist_trains_from_py_reader_like_feed_and_reference():
    j_main, j_startup, j_rd, j_loss = _mlp("jax", _by_py_reader)
    j_rd.decorate_paddle_reader(_mnist_batches("jax"))
    j_exe, j_scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(j_scope):
        j_exe.run(j_startup)
        state = {v.name: np.array(j_scope.get(v.name))
                 for v in j_main.list_vars() if v.persistable}
        want = _epoch(j_exe, j_main, j_loss, j_rd, jfluid)

    t_main, _, t_rd, t_loss = _mlp("port", _by_py_reader)
    t_rd.decorate_paddle_reader(_mnist_batches("port"))
    exe = tfluid.Executor(tfluid.CPUPlace())
    runs = {}
    for how in ("py_reader", "feed"):
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            convert.load_numpy_state(scope, state, "cpu", program=t_main)
            if how == "py_reader":
                runs[how] = _epoch(exe, t_main, t_loss, t_rd, tfluid)
            else:
                runs[how] = [float(np.asarray(exe.run(
                    t_main, feed=dict(zip(t_rd.var_names, b)),
                    fetch_list=[t_loss])[0]))
                    for b in _mnist_batches("port")()]
    assert len(want) == STEPS
    assert runs["py_reader"] == runs["feed"]  # bitwise
    np.testing.assert_allclose(runs["py_reader"], want, rtol=LOSS_RTOL)
    assert runs["py_reader"][-1] < runs["py_reader"][0]


def _producers():
    return [t for t in threading.enumerate()
            if t.name == "paddle-gpu-py-reader" and t.is_alive()]


def test_eof_next_epoch_and_reset_halfway():
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard(), tfluid.program_guard(main, startup):
        rd = tfluid.layers.py_reader(capacity=2, shapes=[[-1, 2]],
                                     dtypes=["float32"])
        out = tfluid.layers.reduce_sum(rd.vars[0])
    batches = [[np.full((3, 2), i, np.float32)] for i in range(40)]
    rd.decorate_paddle_reader(lambda: iter(batches))
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    before = len(_producers())

    def take(n):
        return [float(exe.run(main, fetch_list=[out])[0]) for _ in range(n)]

    for _ in range(2):  # an epoch, EOFException, then the next epoch
        rd.start()
        assert take(40) == [6.0 * i for i in range(40)]
        with pytest.raises(tfluid.EOFException):
            exe.run(main, fetch_list=[out])
    # stop halfway: the producer is parked on the full queue
    rd.start()
    assert take(5) == [6.0 * i for i in range(5)]
    rd.reset()
    assert len(_producers()) == before
    rd.start()  # starts over from the first batch
    assert take(3) == [0.0, 6.0, 12.0]
    rd.start()  # a start over a live epoch stops it first
    assert take(40)[-1] == 234.0
    with pytest.raises(tfluid.EOFException):
        exe.run(main, fetch_list=[out])
    rd.reset()
    assert len(_producers()) == before
    # an explicit feed bypasses the reader
    (v,) = exe.run(main, feed={rd.var_names[0]: np.ones((1, 2),
                                                         np.float32)},
                   fetch_list=[out])
    assert float(v) == 2.0


def _preprocessed(pkg, source):
    fluid, unique_name = PKGS[pkg][:2]
    with unique_name.guard():
        kw = {"place": fluid.CPUPlace()} if pkg == "port" else {}
        p = fluid.layers.Preprocessor(reader=source(pkg),
                                      shapes=[[-1, 2, 3], [-1, 1]],
                                      dtypes=["float32", "int64"], **kw)
        with p.block():
            img, lbl = p.inputs()
            p.outputs(fluid.layers.scale(img, scale=0.5, bias=0.25),
                      fluid.layers.elementwise_add(
                          lbl, fluid.layers.fill_constant(
                              shape=[1], dtype="int64", value=1)))
        return list(p()())


def _batch_source(pkg):
    rng = np.random.RandomState(4)
    batches = [(rng.randn(3, 2, 3).astype(np.float32),
                rng.randint(0, 9, (3, 1)).astype(np.int64))
               for _ in range(4)]
    return lambda: iter(batches)


def _py_reader_source(pkg):
    fluid, unique_name, program_cls, guard = PKGS[pkg][:4]
    with guard(program_cls(), program_cls()):
        rd = fluid.layers.py_reader(capacity=2, shapes=[[-1, 2, 3], [-1, 1]],
                                    dtypes=["float32", "int64"])
    rd.decorate_paddle_reader(_batch_source(pkg))
    return rd


@pytest.mark.parametrize("source", [_batch_source, _py_reader_source])
def test_preprocessor_matches_reference(source):
    got = _preprocessed("port", source)
    want = _preprocessed("jax", source)
    assert len(got) == len(want) == 4
    for (g_img, g_lbl), (w_img, w_lbl) in zip(got, want):
        np.testing.assert_allclose(g_img, w_img, rtol=1e-6)
        np.testing.assert_array_equal(g_lbl, w_lbl)


def _step_events(pkg):
    fluid, unique_name, program_cls, guard = PKGS[pkg][:4]
    obs, reqtrace = (t_obs, t_reqtrace) if pkg == "port" else \
        (j_obs, j_reqtrace)
    main, startup = program_cls(), program_cls()
    with unique_name.guard(), guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(input=x, size=2))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    obs.reset()
    try:
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            ctx = reqtrace.TraceContext("ab" * 8, 5, reqtrace.FLAG_EAGER)
            with reqtrace.use(ctx):
                assert reqtrace.current() is ctx
                for i in range(5):
                    exe.run(main, feed={"x": np.full((2, 4), i, np.float32)},
                            fetch_list=[loss], dispatch_steps=2)
                exe.sync()
            assert reqtrace.current() is None
            # no active trace: the seams emit nothing
            exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                    fetch_list=[loss], dispatch_steps=2)
            exe.sync()
        return [(s.name, s.args["step"], s.args.get("depth"),
                 s.args["trace"], s.args["parent"])
                for s in obs.spans() if s.name.startswith("trace.step_")]
    finally:
        obs.reset()


def test_reqtrace_step_events_match_reference():
    got = _step_events("port")
    want = _step_events("jax")
    assert got == want
    names = [g[0] for g in got]
    assert names.count("trace.step_enqueue") == 5
    assert names.count("trace.step_retire") == 5


FLUID_NAMES = ["DataFeeder", "PyReader", "py_reader", "LoDTensor",
               "LoDTensorArray", "create_lod_tensor",
               "create_random_int_lodtensor", "EOFException",
               "DataFeedDesc", "CUDAPinnedPlace", "set_flags", "reader",
               "recordio", "recordio_writer"]
LAYER_NAMES = ["py_reader", "PyReader", "create_py_reader_by_data",
               "open_files", "read_file", "double_buffer", "batch",
               "shuffle", "Preprocessor", "random_data_generator"]


def test_fluid_surface_has_the_reference_names():
    for name in FLUID_NAMES:
        assert hasattr(jfluid, name) and hasattr(tfluid, name), name
    for name in LAYER_NAMES:
        assert hasattr(jfluid.layers, name), name
        assert hasattr(tfluid.layers, name), name
    assert isinstance(tfluid.CUDAPinnedPlace(), tfluid.CPUPlace)
    assert repr(tfluid.CUDAPinnedPlace()) == repr(jfluid.CUDAPinnedPlace())


def test_reader_layers_match_reference(tmp_path):
    import random

    rng = np.random.RandomState(2)
    samples = [(rng.randint(0, 256, (3, 4)).astype(np.uint8),
                np.int64(i), rng.rand(2).astype(np.float32))
               for i in range(10)]
    path = str(tmp_path / "s.rio")
    j_recordio_writer.convert_reader_to_recordio_file(
        path, lambda: iter(samples), max_num_records=3)
    kw = dict(shapes=[[3, 4], [1], [2]], dtypes=["uint8", "int64",
                                                 "float32"], pass_num=2)
    outs = []
    for fluid in (tfluid, jfluid):
        parsed = fluid.layers.open_files([path], **kw)
        raw = fluid.layers.open_files(path)
        random.seed(5)
        batches = list(fluid.layers.batch(
            fluid.layers.shuffle(parsed, 4), 3)())
        outs.append((list(raw()), batches))
        with pytest.raises(ValueError, match="BOTH"):
            fluid.layers.open_files(path, shapes=[[3, 4]])
        with pytest.raises(NotImplementedError):
            fluid.layers.read_file(raw)
        assert fluid.layers.double_buffer(raw) is raw
        gen = fluid.layers.random_data_generator(-2.0, 3.0,
                                                 [[2, 3], [4]])()
        a, b = next(gen)
        assert a.shape == (2, 3) and b.shape == (4,)
        assert a.dtype == b.dtype == np.float32
        assert (a >= -2).all() and (a < 3).all()
    (t_raw, t_batches), (j_raw, j_batches) = outs
    assert t_raw == j_raw and len(t_raw) == 10
    assert len(t_batches) == len(j_batches) == 7
    for tb, jb in zip(t_batches, j_batches):
        for ts, js in zip(tb, jb):
            for x, y in zip(ts, js):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
