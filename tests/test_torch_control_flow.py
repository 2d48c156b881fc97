"""Control flow of the port against the JAX package, on the CPU, at tiny
sizes: the 18 lowerings of ``ops/controlflow_ops.py``, the programs of
``tests/test_control_flow.py`` (a counting ``While``, a ``While`` writing
a tensor array, a ``StaticRNN`` forward and trained, a ``Switch``
cascade) plus an ``IfElse`` and a ragged ``DynamicRNN``, and dropout
inside a ``StaticRNN`` cell.

- Both front ends build the same main and startup descs, sub-blocks
  included, byte for byte.
- The JAX package runs its startup; its scope is carried into the port by
  name (``convert.load_numpy_state``). Fetches: rtol 1e-5 / atol 1e-6
  (float32 on both sides; counters and lengths exactly); losses over
  training steps rtol 1e-5, parameters after them atol 1e-6.
- Lowerings: the same inputs through both registries; compare and
  logical results exactly, ``where``, ``split``, ``assign`` and the
  tensor arrays exactly.
- Dropout in a cell (the port alone: its masks are not the JAX
  package's, ROADMAP Queue 3 "Dropout seeds"): the masks differ between
  steps, repeat between two runs from the same seed and change with the
  seed, and the weight grad is the one the forward's masks give.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import (LowerContext as JLowerContext,
                                      OpRegistry as JOpRegistry)

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry)
from paddle_tpu_torch.engine.lowering import BlockProgram

RTOL, ATOL = 1e-5, 1e-6


# -- lowerings ---------------------------------------------------------------

def _lower(op_type, ins, attrs, out_slot="Out"):
    j_ctx = JLowerContext(JOpDesc(op_type, {}, {}, attrs), None)
    t_ctx = TLowerContext(TOpDesc(op_type, {}, {}, attrs), None, "cpu")
    j = JOpRegistry.get(op_type).lower(
        j_ctx, {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
        attrs)[out_slot]
    t = TOpRegistry.get(op_type).lower(
        t_ctx, {k: [torch.from_numpy(v) for v in vs]
                for k, vs in ins.items()}, attrs)[out_slot]
    return j, t


def _f(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


_A = np.array([[1.0, 2.0, 3.0], [3.0, 2.0, 1.0]], np.float32)
_B = np.array([[1.0, 1.0, 3.0], [4.0, 2.0, 0.0]], np.float32)
_P = np.array([[True, False, True], [False, False, True]])
_Q = np.array([[True, True, False], [False, True, True]])

OP_CASES = [(op, op, {"X": [_A], "Y": [_B]}, {}) for op in (
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal")]
OP_CASES += [
    ("less_than_int64", "less_than",
     {"X": [np.array([3], np.int64)], "Y": [np.array([10], np.int64)]}, {}),
]
OP_CASES += [(op, op, {"X": [_P], "Y": [_Q]}, {}) for op in (
    "logical_and", "logical_or", "logical_xor")]
OP_CASES += [
    ("logical_not", "logical_not", {"X": [_P]}, {}),
    ("where", "where", {"Condition": [_P], "X": [_A], "Y": [_B]}, {}),
    ("where_rows", "where", {"Condition": [np.array([[True], [False]])],
                             "X": [_A], "Y": [_B]}, {}),
    ("split_num", "split", {"X": [_f((2, 8), 1)]},
     {"axis": 1, "num": 4, "sections": []}),
    ("split_sections", "split", {"X": [_f((5, 3), 2)]},
     {"axis": 0, "num": 0, "sections": [1, 3, 1]}),
    ("assign", "assign", {"X": [_f((3, 4), 3)]}, {}),
    ("fill_constant_batch_size_like", "fill_constant_batch_size_like",
     {"Input": [_f((5, 7, 2), 4)]},
     {"shape": [-1, 16], "dtype": 5, "value": 0.5, "input_dim_idx": 1,
      "output_dim_idx": 0}),
    ("fill_constant_batch_size_like_int", "fill_constant_batch_size_like",
     {"Input": [_f((3, 2), 5)]},
     {"shape": [2, -1], "dtype": 3, "value": 7.0, "input_dim_idx": 0,
      "output_dim_idx": 1}),
]


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_lowering_matches_jax(case):
    _, op_type, ins, attrs = case
    j, t = _lower(op_type, ins, attrs)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape
        assert np.dtype(b.numpy().dtype).kind == a.dtype.kind
        np.testing.assert_array_equal(b.numpy(), a)


def _array_ops(reg, ctx_of, tensor, x, y, i, j, k):
    """create, two writes, a read and the length, in one registry."""
    def run(op, ins, attrs=None):
        attrs = dict(attrs or {}, capacity=4)
        return reg.get(op).lower(ctx_of(op, attrs), ins, attrs)["Out"][0]
    arr = run("create_array", {})
    arr = run("write_to_array", {"X": [tensor(x)], "I": [tensor(i)],
                                 "Array": [arr]})
    arr = run("write_to_array", {"X": [tensor(y)], "I": [tensor(j)],
                                 "Array": [arr]})
    got = run("read_from_array", {"X": [arr], "I": [tensor(k)]})
    length = run("lod_array_length", {"X": [arr]})
    return arr["buf"], got, length


@pytest.mark.parametrize("i,j,k", [(0, 2, 2), (1, 1, 1), (3, 9, 3)],
                         ids=["two_writes", "overwrite", "clamped"])
def test_tensor_array_ops_match_jax(i, j, k):
    """``create_array``, ``write_to_array``, ``read_from_array`` and
    ``lod_array_length``: the buffer, the element read and the length, an
    index past the capacity clamped into the buffer as in the JAX
    package (its length counts the index as given)."""
    x, y = _f((2, 3), 6), _f((2, 3), 7)
    idx = [np.array([v], np.int64) for v in (i, j, k)]
    want = _array_ops(
        JOpRegistry, lambda op, a: JLowerContext(JOpDesc(op, {}, {}, a), None),
        jnp.asarray, x, y, *idx)
    got = _array_ops(
        TOpRegistry,
        lambda op, a: TLowerContext(TOpDesc(op, {}, {}, a), None, "cpu"),
        torch.from_numpy, x, y, *idx)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- programs -----------------------------------------------------------------

def _while_counting(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        limit = fluid.layers.fill_constant(shape=[1], dtype="int64",
                                           value=10)
        acc = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                         value=0.0)
        cond = fluid.layers.less_than(x=i, y=limit)
        w = fluid.While(cond=cond)
        with w.block():
            acc2 = fluid.layers.scale(acc, scale=1.0)
            acc2 = fluid.layers.elementwise_add(
                acc2, fluid.layers.cast(i, "float32"))
            fluid.layers.assign(acc2, output=acc)
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.less_than(x=i, y=limit, cond=cond)
    return main, startup, [acc, i], [{}]


def _while_array(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        limit = fluid.layers.fill_constant(shape=[1], dtype="int64", value=5)
        arr = fluid.layers.create_array(dtype="float32", capacity=8)
        zero = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                          value=0.0)
        fluid.layers.array_write(zero, i, array=arr)
        cond = fluid.layers.less_than(x=i, y=limit)
        w = fluid.While(cond=cond)
        with w.block():
            sq = fluid.layers.cast(i, "float32")
            sq = fluid.layers.elementwise_mul(sq, sq)
            fluid.layers.array_write(sq, i, array=arr)
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.less_than(x=i, y=limit, cond=cond)
        ln = fluid.layers.array_length(arr)
        last = fluid.layers.array_read(
            arr, fluid.layers.fill_constant(shape=[1], dtype="int64",
                                            value=4))
    return main, startup, [ln, last], [{}]


T, B, D, H = 4, 3, 5, 6


def _static_rnn(fluid):
    rng = np.random.RandomState(0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[B, D], dtype="float32")
        h0 = fluid.layers.data(name="h0", shape=[H], dtype="float32")
        rnn = fluid.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            hprev = rnn.memory(init=h0)
            xw = fluid.layers.fc(input=xt, size=H, bias_attr=False,
                                 param_attr=fluid.ParamAttr(name="W"))
            hu = fluid.layers.fc(input=hprev, size=H, bias_attr=False,
                                 param_attr=fluid.ParamAttr(name="U"))
            h = fluid.layers.tanh(fluid.layers.elementwise_add(xw, hu))
            rnn.update_memory(hprev, h)
            rnn.step_output(h)
        out = rnn()
    feed = {"x": rng.randn(T, B, D).astype(np.float32),
            "h0": rng.randn(B, H).astype(np.float32)}
    return main, startup, [out], [feed]


def _static_rnn_train(fluid):
    rng = np.random.RandomState(1)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[B, D], dtype="float32")
        y = fluid.layers.data(name="y", shape=[H], dtype="float32")
        h0 = fluid.layers.fill_constant(shape=[B, H], dtype="float32",
                                        value=0.0)
        rnn = fluid.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            hprev = rnn.memory(init=h0)
            xw = fluid.layers.fc(input=xt, size=H, bias_attr=False)
            hu = fluid.layers.fc(input=hprev, size=H, bias_attr=False)
            h = fluid.layers.tanh(fluid.layers.elementwise_add(xw, hu))
            rnn.update_memory(hprev, h)
            rnn.step_output(h)
        out = rnn()
        last = fluid.layers.slice(out, axes=[0], starts=[T - 1], ends=[T])
        last = fluid.layers.reshape(last, shape=[B, H])
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=last, label=y))
        fluid.optimizer.SGD(learning_rate=0.2).minimize(loss)
    feed = {"x": rng.randn(T, B, D).astype(np.float32),
            "y": rng.randn(B, H).astype(np.float32)}
    return main, startup, [loss], [feed] * 4


def _switch(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        step = fluid.layers.data(name="step", shape=[1], dtype="float32",
                                 append_batch_size=False)
        lr = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                        value=0.001)
        b1 = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                        value=10.0)
        b2 = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                        value=20.0)
        sw = fluid.Switch()
        with sw.case(fluid.layers.less_than(x=step, y=b1)):
            fluid.layers.assign(
                fluid.layers.fill_constant(shape=[1], dtype="float32",
                                           value=1.0), output=lr)
        with sw.case(fluid.layers.less_than(x=step, y=b2)):
            fluid.layers.assign(
                fluid.layers.fill_constant(shape=[1], dtype="float32",
                                           value=0.1), output=lr)
        with sw.default():
            fluid.layers.assign(
                fluid.layers.fill_constant(shape=[1], dtype="float32",
                                           value=0.01), output=lr)
    feeds = [{"step": np.array([v], np.float32)} for v in (5.0, 15.0, 25.0)]
    return main, startup, [lr], feeds


def _ifelse(fluid):
    rng = np.random.RandomState(2)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        zero = fluid.layers.fill_constant_batch_size_like(
            input=x, shape=[-1, 1], dtype="float32", value=0.0)
        cond = fluid.layers.less_than(
            x=fluid.layers.reduce_sum(x, dim=1, keep_dim=True), y=zero)
        ie = fluid.layers.IfElse(cond)
        with ie.true_block():
            ie.output(fluid.layers.scale(ie.input(x), scale=2.0))
        with ie.false_block():
            ie.output(fluid.layers.fc(input=ie.input(x), size=4))
        (out,) = ie()
    return main, startup, [out], [{"x": rng.randn(6, 4).astype(np.float32)}]


def _dynamic_rnn(fluid):
    """Batch-major ragged input, a learned cell, trained by SGD: the
    ``recurrent`` op with ``SeqLen`` and its vjp grad."""
    rng = np.random.RandomState(3)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[T, D], dtype="float32")
        lens = fluid.layers.data(name="lens", shape=[1], dtype="int64")
        drnn = fluid.layers.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x, length=lens)
            hprev = drnn.memory(shape=[H], value=0.0)
            h = fluid.layers.tanh(fluid.layers.elementwise_add(
                fluid.layers.fc(input=xt, size=H),
                fluid.layers.fc(input=hprev, size=H, bias_attr=False)))
            drnn.update_memory(hprev, h)
            drnn.output(h)
        out = drnn()
        loss = fluid.layers.mean(fluid.layers.square(out))
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    feed = {"x": rng.randn(B, T, D).astype(np.float32),
            "lens": np.array([[4], [1], [3]], np.int64)}
    return main, startup, [out, loss], [feed] * 3


PROGRAMS = {"while_counting": _while_counting, "while_array": _while_array,
            "static_rnn": _static_rnn, "static_rnn_train": _static_rnn_train,
            "switch": _switch, "ifelse": _ifelse,
            "dynamic_rnn": _dynamic_rnn}


def _build(name):
    with j_unique_name.guard():
        j = PROGRAMS[name](jfluid)
    with t_unique_name.guard():
        t = PROGRAMS[name](tfluid)
    return j, t


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_desc_parity(name):
    (j_main, j_startup, _, _), (t_main, t_startup, _, _) = _build(name)
    for j_prog, t_prog in ((j_main, t_main), (j_startup, t_startup),
                           (j_main.clone(for_test=True),
                            t_main.clone(for_test=True))):
        assert json.loads(t_prog.desc.serialize_to_string()) == \
            json.loads(j_prog.desc.serialize_to_string())
        assert t_prog.desc.serialize_to_string() == \
            j_prog.desc.serialize_to_string()
    if name != "ifelse":   # IfElse merges with `where`, in block 0
        assert t_main.desc.num_blocks() > 1


def _run(fluid, exe, scope, main, fetches, feeds, state=None):
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    if state is not None:
        convert.load_numpy_state(scope, state, "cpu", program=main)
    with fluid.scope_guard(scope):
        outs = [[np.asarray(v) for v in exe.run(main, feed=f,
                                                  fetch_list=fetches)]
                for f in feeds]
        final = {n: np.array(scope.get(n)) for n in names}
    return outs, final


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_runs_as_jax(name):
    (j_main, j_startup, j_fetch, feeds), (t_main, _, t_fetch, _) = \
        _build(name)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    names = sorted(v.name for v in j_main.list_vars() if v.persistable)
    with jfluid.scope_guard(scope):
        exe.run(j_startup)
        state = {n: np.array(scope.get(n)) for n in names}
    want, j_final = _run(jfluid, exe, scope, j_main, j_fetch, feeds)
    got, t_final = _run(tfluid, tfluid.Executor(tfluid.CPUPlace()),
                        tfluid.Scope(), t_main, t_fetch, feeds, state)
    for w_step, g_step in zip(want, got):
        for w, g in zip(w_step, g_step):
            assert g.shape == w.shape
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(g, w)
    for n in names:
        np.testing.assert_allclose(t_final[n], j_final[n], rtol=0,
                                   atol=ATOL)
    if name == "while_counting":
        assert float(got[0][0][0]) == sum(range(10))
        assert int(got[0][1][0]) == 10
    elif name == "while_array":
        assert (int(got[0][0][0]), float(got[0][1][0])) == (5, 16.0)
    elif name == "switch":
        assert [float(s[0][0]) for s in got] == pytest.approx(
            [1.0, 0.1, 0.01], abs=1e-7)
    elif name in ("static_rnn_train", "dynamic_rnn"):
        losses = [float(s[-1].reshape(-1)[0]) for s in got]
        assert losses[-1] < losses[0]


def test_while_is_not_capturable_and_the_rest_is():
    """A block holding ``while`` (directly or in a sub-block) runs
    eagerly on the card; ``conditional_block`` and ``recurrent`` are
    captured."""
    _, (t_main, _, t_fetch, _) = _build("while_counting")
    bp = BlockProgram(t_main.desc.block(0), [], [v.name for v in t_fetch])
    assert not bp.capturable and bp.uncapturable_ops == ["while"]
    for name in ("switch", "static_rnn_train", "dynamic_rnn"):
        _, (t_main, _, t_fetch, _) = _build(name)
        bp = BlockProgram(t_main.desc.block(0), sorted(
            v.name for v in t_main.global_block().vars.values()
            if v.name in ("x", "y", "h0", "lens", "step")),
            [v.name for v in t_fetch])
        assert bp.capturable, name


def test_sub_blocks_in_liveness_and_cache_key():
    """The cell's weights enter the step through the ``recurrent`` op's
    ``Params``; the step's state is theirs and SGD's learning rate, all
    of block 0; no var of a sub-block is state;
    an edit inside a sub-block changes the program's fingerprint (the
    engine's cache key)."""
    _, (t_main, _, t_fetch, _) = _build("static_rnn_train")
    bp = BlockProgram(t_main.desc.block(0), ["x", "y"],
                      [v.name for v in t_fetch])
    params = sorted(p.name for p in t_main.all_parameters())
    lr = [n for n in bp.state_in_names if n.startswith("learning_rate")]
    assert sorted(bp.state_in_names) == sorted(params + lr) and len(lr) == 1
    assert sorted(bp.state_out_names) == params
    assert all(n in t_main.desc.block(0).vars for n in bp.state_in_names)
    sub_vars = {n for b in t_main.desc.blocks[1:] for n in b.vars}
    assert sub_vars and not sub_vars & set(bp.state_in_names
                                           + bp.state_out_names)
    rec = next(op for op in t_main.desc.block(0).ops
               if op.type == "recurrent")
    assert sorted(rec.input("Params")) == params
    before = t_main.desc.cached_fingerprint()
    t_main.desc.block(1).ops[-1].attrs["op_role"] = 0x100
    t_main._bump_version()
    assert t_main.desc.cached_fingerprint() != before


def test_tensor_array_fetch_refused():
    _, (t_main, t_startup, _, _) = _build("while_array")
    arr = next(v for v in t_main.global_block().vars.values()
               if v.name.startswith("array"))
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(t_startup)
        with pytest.raises(TypeError, match="tensor array"):
            exe.run(t_main, feed={}, fetch_list=[arr])


# -- dropout inside a StaticRNN cell -----------------------------------------

def _dropout_cell(seed=0):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = seed
    with t_unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[B, D], dtype="float32")
        h0 = tfluid.layers.fill_constant(shape=[B, D], dtype="float32",
                                         value=0.0)
        rnn = tfluid.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            hprev = rnn.memory(init=h0)
            z = tfluid.layers.fc(input=xt, size=D, bias_attr=False,
                                 param_attr=tfluid.ParamAttr(name="W"))
            d = tfluid.layers.dropout(z, dropout_prob=0.5)
            rnn.update_memory(hprev, d)
            rnn.step_output(d)
        out = rnn()
        loss = tfluid.layers.mean(out)
        tfluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
    return main, startup, out, loss


def _dropout_run(seed=0, steps=1):
    main, startup, out, _ = _dropout_cell(seed)
    exe = tfluid.Executor(tfluid.CPUPlace())
    xv = 1.0 + np.abs(np.random.RandomState(4).randn(T, B, D)).astype(
        np.float32)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        w = np.array(scope.get("W"))
        runs = [exe.run(main, feed={"x": xv}, fetch_list=[out, "W@GRAD"])
                for _ in range(steps)]
    return xv, w, runs


def test_dropout_in_cell_seeds():
    """The seed table has one slot for the ``recurrent`` op (and its
    grad): the masks differ between time steps and between runs, repeat
    from the same seed and run counter, and change with the seed."""
    main, _, out, _ = _dropout_cell()
    bp = BlockProgram(main.desc.block(0), ["x"], [out.name])
    assert [h for _, h in bp.rng_slots] == [2 ** 32]
    xv, w, (first, second) = _dropout_run(steps=2)
    masks = first[0] != 0
    assert 0.2 < masks.mean() < 0.8
    assert all(not np.array_equal(masks[0], masks[t]) for t in range(1, T))
    assert not np.array_equal(masks, second[0] != 0)
    _, _, (again,) = _dropout_run()
    np.testing.assert_array_equal(again[0], first[0])
    _, _, (other,) = _dropout_run(seed=7)
    assert not np.array_equal(other[0] != 0, masks)


def test_dropout_in_cell_grad_uses_forward_masks():
    """``recurrent_grad`` (the vjp of the loop) re-draws the forward's
    masks: W@GRAD is the one the fetched masks give."""
    xv, w, ((out, w_grad),) = _dropout_run()
    masks = (out != 0).astype(np.float32)
    np.testing.assert_allclose(out, np.einsum("tbd,de->tbe", xv, w) * masks,
                               rtol=1e-5, atol=1e-6)
    want = np.einsum("tbd,tbe->de", xv, masks) / out.size
    np.testing.assert_allclose(w_grad, want, rtol=1e-5, atol=1e-7)


# the lowerings this file holds against the JAX package's (program cases
# for while, conditional_block and recurrent; tests/test_torch_ops.py
# checks every ported lowering has a case)
SLICE_OPS = {c[1] for c in OP_CASES} | {
    "create_array", "write_to_array", "read_from_array", "lod_array_length",
    "while", "conditional_block", "recurrent", "square_error_cost"}
