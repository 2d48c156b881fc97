"""The port's SelectedRows sparse gradients (``core/selected_rows.py``,
the sparse branches of ``lookup_table_grad``, the optimizers, the math
and loss ops, and the engine's seams) against the JAX package, on the
CPU. Mirrors ``tests/test_sparse_grad.py``.

Tolerances, float32 on both sides:
- ``merged()``: rows equal, values within atol 1e-6 (duplicate rows
  summed in another order);
- sparse SGD, Momentum (plain and Nesterov) and Adagrad against the
  port's own dense run: losses rtol 1e-5, table rtol 1e-5 / atol 1e-6
  (the sparse update adds each duplicate's term to the row one by one,
  the dense one adds their sum once), as the JAX package's test holds
  its own;
- sparse (lazy) Adam against the JAX package's sparse run: losses rtol
  1e-5, table atol 1e-6 (a tenth of an Adam step at lr 0.1 would be
  1e-2; the two differ in summation order only);
- per-op sparse branches against the JAX lowerings: rtol 1e-5 / atol
  1e-6, rows of a sparse result equal;
- rows outside every batch under lazy Adam: bitwise unchanged.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import (LowerContext as JLowerContext,
                                      OpRegistry as JOpRegistry)
from paddle_tpu.core.selected_rows import SelectedRows as JSelectedRows
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as j_program_guard

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry)
from paddle_tpu_torch.core.selected_rows import SelectedRows, densify
from paddle_tpu_torch.framework import Program as TProgram
from paddle_tpu_torch.framework import program_guard as t_program_guard

VOCAB, DIM, FIELDS = 40, 4, 3
W0 = np.linspace(-1, 1, VOCAB * DIM).astype(np.float32).reshape(VOCAB, DIM)


def _sr_pair(rows, vals, height):
    """The same sparse value in both packages."""
    return (JSelectedRows(jnp.asarray(rows, jnp.int32), jnp.asarray(vals),
                          height),
            SelectedRows(torch.from_numpy(rows.astype(np.int64)),
                         torch.from_numpy(vals), height))


@pytest.mark.parametrize("n,height,seed", [(5, 9, 0), (64, 10, 1),
                                           (33, 1000, 2), (1, 3, 3)])
def test_merged_matches_jax(n, height, seed):
    """Random ids with duplicates: the port's host-free merge gives the
    JAX package's layout (unique rows ascending, then sentinel rows
    ``height`` with zero values) and its values."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, height, n)
    vals = rng.randn(n, 3).astype(np.float32)
    j, t = _sr_pair(rows, vals, height)
    jm, tm = j.merged(), t.merged()
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_allclose(tm.values.numpy(), np.asarray(jm.values),
                               rtol=0, atol=1e-6)
    assert tm.is_merged and tm.merged() is tm
    np.testing.assert_allclose(tm.to_dense().numpy(),
                               np.asarray(j.to_dense()), rtol=0, atol=1e-6)


def test_to_dense_and_sentinel_writes():
    """Sentinel slots never reach an index op: ``to_dense`` drops them;
    on merged rows ``add_rows`` and ``set_rows`` write the first slot's
    value to the first slot's row; on unmerged rows holding sentinels (a
    ``sum`` of merged grads) ``add_rows`` adds -0.0 to row 0, a bitwise
    no-op that keeps -0.0."""
    sr = SelectedRows(torch.tensor([3, 1, 3]), torch.ones(3, 2), 5).merged()
    assert sr.rows.tolist() == [1, 3, 5]
    dense = torch.tensor([[-0.0, 2.0]] * 5)
    added = sr.add_rows(dense, torch.full((3, 2), 7.0))
    assert added[1].tolist() == [7.0, 9.0] and added[3].tolist() == [7.0, 9.0]
    assert torch.equal(added[[0, 2, 4]], dense[[0, 2, 4]])
    assert torch.signbit(added[0, 0])
    put = sr.set_rows(dense, torch.tensor([[1.0, 1.0], [3.0, 3.0],
                                           [9.0, 9.0]]))
    assert put[1].tolist() == [1.0, 1.0] and put[3].tolist() == [3.0, 3.0]
    assert torch.equal(put[[0, 2, 4]], dense[[0, 2, 4]])
    assert sr.gather_rows(put)[2].tolist() == [1.0, 1.0]
    assert torch.equal(densify(sr), sr.to_dense())
    assert sr.to_dense()[[1, 3]].tolist() == [[1.0, 1.0], [2.0, 2.0]]
    both = SelectedRows(torch.cat([sr.rows, sr.rows]),
                        torch.cat([sr.values, sr.values]), 5)
    added = both.add_rows(dense, torch.full((6, 2), 7.0))
    assert added[1].tolist() == [14.0, 16.0]
    assert torch.equal(added[0], dense[0]) and torch.signbit(added[0, 0])
    assert both.to_dense()[3].tolist() == [4.0, 4.0]


def _j_lower(op_type, ins, attrs):
    ctx = JLowerContext(JOpDesc(op_type, {}, {}, attrs), None)
    return JOpRegistry.get(op_type).lower(ctx, ins, attrs)


def _t_lower(op_type, ins, attrs):
    ctx = TLowerContext(TOpDesc(op_type, {}, {}, attrs), None, "cpu")
    return TOpRegistry.get(op_type).lower(ctx, ins, attrs)


def _assert_same(t, j):
    if isinstance(j, JSelectedRows):
        assert isinstance(t, SelectedRows) and t.height == j.height
        np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
        np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values),
                                   rtol=1e-5, atol=1e-6)
    else:
        assert isinstance(t, torch.Tensor)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)


_ROWS = np.array([3, 1, 3, 7, 1, 0], np.int64)
_VALS = np.random.RandomState(4).randn(6, 2).astype(np.float32)
_ROWS2 = np.array([2, 7, 8], np.int64)
_VALS2 = np.random.RandomState(5).randn(3, 2).astype(np.float32)
_DENSE = np.random.RandomState(6).randn(9, 2).astype(np.float32)

# (id, op type, {slot: [values; "sr" / "sr2" a sparse input]}, attrs,
#  output slot)
SPARSE_OP_CASES = [
    ("scale_keeps_rows", "scale", {"X": ["sr"]}, {"scale": 0.5}, "Out"),
    ("scale_bias_densifies", "scale", {"X": ["sr"]},
     {"scale": 2.0, "bias": 1.0}, "Out"),
    ("sum_sparse_concat", "sum", {"X": ["sr", "sr2"]}, {}, "Out"),
    ("sum_mixed_dense", "sum", {"X": [_DENSE, "sr", "sr2"]}, {}, "Out"),
    ("mul_by_scalar", "elementwise_mul",
     {"X": ["sr"], "Y": [np.array([0.25], np.float32)]}, {"axis": -1},
     "Out"),
    ("div_by_scalar", "elementwise_div",
     {"X": ["sr"], "Y": [np.array([4.0], np.float32)]}, {"axis": -1},
     "Out"),
    ("add_dense_densifies", "elementwise_add",
     {"X": ["sr"], "Y": [_DENSE]}, {"axis": -1}, "Out"),
    ("clip_merges", "clip", {"X": ["sr"]}, {"min": -0.5, "max": 0.5},
     "Out"),
    ("clip_by_norm_merges", "clip_by_norm", {"X": ["sr"]},
     {"max_norm": 0.5}, "Out"),
    ("squared_l2_norm_merges", "squared_l2_norm", {"X": ["sr"]}, {},
     "Out"),
]


@pytest.mark.parametrize("case", SPARSE_OP_CASES,
                         ids=[c[0] for c in SPARSE_OP_CASES])
def test_sparse_op_branch_matches_jax(case):
    _, op_type, slots, attrs, out_slot = case
    srs = {"sr": _sr_pair(_ROWS, _VALS, 9), "sr2": _sr_pair(_ROWS2, _VALS2, 9)}
    j_ins, t_ins = {}, {}
    for slot, vals in slots.items():
        j_ins[slot] = [srs[v][0] if isinstance(v, str) else jnp.asarray(v)
                       for v in vals]
        t_ins[slot] = [srs[v][1] if isinstance(v, str)
                       else torch.from_numpy(v) for v in vals]
    (j_out,) = _j_lower(op_type, j_ins, attrs)[out_slot]
    (t_out,) = _t_lower(op_type, t_ins, attrs)[out_slot]
    _assert_same(t_out, j_out)


@pytest.mark.parametrize("padding_idx", [-1, 2])
def test_lookup_table_grad_sparse_matches_jax(padding_idx):
    """The SelectedRows the sparse grad emits: rows = the ids, values =
    the output grads, the padding rows zero."""
    ids = np.array([[1], [2], [1], [5]], np.int64)
    w = np.zeros((7, 3), np.float32)
    og = np.random.RandomState(7).randn(4, 3).astype(np.float32)
    attrs = {"is_sparse": True, "padding_idx": padding_idx}
    (j_g,) = _j_lower("lookup_table_grad", {
        "Ids": [jnp.asarray(ids)], "W": [jnp.asarray(w)],
        "Out@GRAD": [jnp.asarray(og)]}, attrs)["W@GRAD"]
    (t_g,) = _t_lower("lookup_table_grad", {
        "Ids": [torch.from_numpy(ids)], "W": [torch.from_numpy(w)],
        "Out@GRAD": [torch.from_numpy(og)]}, attrs)["W@GRAD"]
    _assert_same(t_g, j_g)
    assert t_g.rows.dtype == torch.int64


def _build(fl, program, guard, is_sparse, make_opt, clip=None):
    main, startup = program(), program()
    with guard(main, startup):
        ids = fl.layers.data(name="ids", shape=[FIELDS], dtype="int64")
        emb = fl.layers.embedding(
            ids, size=[VOCAB, DIM], is_sparse=is_sparse,
            param_attr=fl.ParamAttr(name="emb_w"))
        if clip is None:
            loss = fl.layers.mean(fl.layers.square(emb))
        else:
            pooled = fl.layers.reduce_sum(emb, dim=1)
            out = fl.layers.fc(input=pooled, size=1,
                               param_attr=fl.ParamAttr(name="fc_w"))
            loss = fl.layers.mean(fl.layers.square(out))
            fl.clip.set_gradient_clip(
                fl.clip.GradientClipByGlobalNorm(clip_norm=clip))
        make_opt(fl).minimize(loss)
        if clip is not None:
            fl.clip.set_gradient_clip(None)
    return main, startup, loss


def _batches(steps, seed, high=VOCAB // 2, batch=6):
    rng = np.random.RandomState(seed)
    # duplicates within a batch on purpose
    return [rng.randint(0, high, size=(batch, FIELDS)).astype(np.int64)
            for _ in range(steps)]


def _train_port(is_sparse, make_opt, batches, clip=None, **run_kw):
    main, startup, loss = _build(tfluid, TProgram, t_program_guard,
                                 is_sparse, make_opt, clip)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        scope.set("emb_w", torch.from_numpy(W0.copy()))
        if clip is not None:
            scope.set("fc_w", torch.from_numpy(
                np.linspace(0.5, -0.5, DIM).astype(np.float32).reshape(
                    DIM, 1)))
        losses = [float(exe.run(main, feed={"ids": b}, fetch_list=[loss],
                                **run_kw)[0].reshape(-1)[0])
                  for b in batches]
    return {n: scope.get(n).numpy() for n in scope.local_var_names()}, losses


def _train_jax(make_opt, batches, **run_kw):
    main, startup, loss = _build(jfluid, JProgram, j_program_guard, True,
                                 make_opt)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        scope.set("emb_w", jnp.asarray(W0.copy()))
        losses = [float(np.asarray(exe.run(
            main, feed={"ids": b}, fetch_list=[loss],
            **run_kw)[0]).reshape(-1)[0]) for b in batches]
        return np.asarray(jax.device_get(scope.get("emb_w"))), losses


OPTIMIZERS = {
    "sgd": lambda fl: fl.optimizer.SGD(learning_rate=0.5),
    "momentum": lambda fl: fl.optimizer.Momentum(learning_rate=0.5,
                                                 momentum=0.9),
    "nesterov": lambda fl: fl.optimizer.Momentum(
        learning_rate=0.5, momentum=0.9, use_nesterov=True),
    "adagrad": lambda fl: fl.optimizer.Adagrad(learning_rate=0.5),
    "adam": lambda fl: fl.optimizer.Adam(learning_rate=0.1),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_sparse_optimizer(name):
    """SGD, Momentum and Adagrad: the sparse update is the dense update.
    Adam: the sparse (lazy) update is not the dense one, so it is held
    against the JAX package's sparse run."""
    make_opt = OPTIMIZERS[name]
    batches = _batches(5, 0)
    state, losses = _train_port(True, make_opt, batches)
    if name == "adam":
        want_w, want_losses = _train_jax(make_opt, batches)
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        np.testing.assert_allclose(state["emb_w"], want_w, rtol=0,
                                   atol=1e-6)
        return
    dense, dense_losses = _train_port(False, make_opt, batches)
    np.testing.assert_allclose(losses, dense_losses, rtol=1e-5)
    np.testing.assert_allclose(state["emb_w"], dense["emb_w"], rtol=1e-5,
                               atol=1e-6)


def test_sparse_adam_leaves_untouched_rows_bitwise():
    """Lazy Adam (reference SparseAdamFunctor): rows outside every batch
    keep their weight and zero moments bit for bit; the touched rows
    move."""
    state, _ = _train_port(True, OPTIMIZERS["adam"], _batches(5, 0))
    moments = [n for n in state if "moment" in n]
    assert len(moments) == 2
    upper = slice(VOCAB // 2, None)
    assert np.array_equal(state["emb_w"][upper], W0[upper])
    for n in moments:
        assert not state[n][upper].any()
    assert np.abs(state["emb_w"][:VOCAB // 2] - W0[:VOCAB // 2]).max() > 1e-4


def test_global_norm_clip_with_sparse_grads():
    """GradientClipByGlobalNorm over a sparse table and a dense weight
    equals the dense-grad run (squared_l2_norm, scale and
    elementwise_div on the SelectedRows)."""
    make_opt = lambda fl: fl.optimizer.SGD(learning_rate=1.0)  # noqa: E731
    batches = _batches(3, 7, high=VOCAB, batch=5)
    sparse, _ = _train_port(True, make_opt, batches, clip=0.05)
    dense, _ = _train_port(False, make_opt, batches, clip=0.05)
    for n in ("emb_w", "fc_w"):
        np.testing.assert_allclose(sparse[n], dense[n], rtol=1e-5,
                                   atol=1e-6)


def test_accumulate_steps_with_sparse_table():
    """``accumulate_steps=2`` with a sparse table and lazy Adam: the
    micro-batches' rows concatenate, each value scaled by 1/2, against
    the JAX package's accumulated sparse run."""
    batches = _batches(3, 3, batch=8)
    state, losses = _train_port(True, OPTIMIZERS["adam"], batches,
                                accumulate_steps=2)
    want_w, want_losses = _train_jax(OPTIMIZERS["adam"], batches,
                                     accumulate_steps=2)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(state["emb_w"], want_w, rtol=0, atol=1e-6)


def test_fetched_sparse_grad_is_dense():
    """A fetch of the table's grad leaves the block densified: the JAX
    package's fetched grad, duplicates summed."""
    ids = np.array([[1, 2, 1], [2, 5, 1]], np.int64)
    make_opt = OPTIMIZERS["sgd"]
    got, want = [], []
    main, startup, loss = _build(tfluid, TProgram, t_program_guard, True,
                                 make_opt)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        scope.set("emb_w", torch.from_numpy(W0.copy()))
        got = exe.run(main, feed={"ids": ids}, fetch_list=["emb_w@GRAD"])
    main, startup, loss = _build(jfluid, JProgram, j_program_guard, True,
                                 make_opt)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        scope.set("emb_w", jnp.asarray(W0.copy()))
        want = exe.run(main, feed={"ids": ids}, fetch_list=["emb_w@GRAD"])
    assert got[0].shape == (VOCAB, DIM)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-6,
                               atol=1e-7)


class _TableShaped(TorchDispatchMode):
    """Counts op outputs of one shape."""

    def __init__(self, shape):
        super().__init__()
        self.shape, self.n = tuple(shape), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if isinstance(t, torch.Tensor) and tuple(t.shape) == self.shape:
                self.n += 1
        return out


def test_no_dense_table_gradient_materialized():
    """The memory contract: with ``is_sparse=True`` no intermediate of the
    table's shape exists but the parameter update itself (counted with a
    TorchDispatchMode over the training block); the dense control makes
    several."""
    vocab, dim = 5000, 8

    def table_intermediates(is_sparse):
        main, startup = TProgram(), TProgram()
        with t_program_guard(main, startup):
            ids = tfluid.layers.data(name="ids", shape=[FIELDS],
                                     dtype="int64")
            emb = tfluid.layers.embedding(
                ids, size=[vocab, dim], is_sparse=is_sparse,
                param_attr=tfluid.ParamAttr(name="big_emb"))
            loss = tfluid.layers.mean(tfluid.layers.square(emb))
            tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        ids = np.zeros((4, FIELDS), np.int64)
        with tfluid.scope_guard(scope):
            exe.run(startup)
            exe.run(main, feed={"ids": ids}, fetch_list=[loss])
            compiled = list(exe.engine._cache.values())[-1]
            state = [scope.get(n)
                     for n in compiled.block_program.state_in_names]
            counter = _TableShaped((vocab, dim))
            with counter, torch.no_grad():
                compiled.fn([torch.from_numpy(ids)], state, (0, 2))
        return counter.n

    sparse_n = table_intermediates(True)
    dense_n = table_intermediates(False)
    assert sparse_n <= 1, sparse_n
    assert dense_n > sparse_n, (dense_n, sparse_n)


class _NoHostSync(TorchDispatchMode):
    """Raises at an op that reads a device value on the host or sizes its
    output by the data: on CUDA each waits for the card, and none may run
    in a captured step."""

    FORBIDDEN = ("_local_scalar_dense", "nonzero", "unique", "masked_select",
                 "_unique")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if any(name.startswith(f) for f in self.FORBIDDEN):
            raise AssertionError("host sync op %s in a sparse op" % name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("op_type", ["sgd", "momentum", "adam", "adagrad",
                                     "sum", "clip", "clip_by_norm",
                                     "squared_l2_norm"])
def test_sparse_ops_read_nothing_on_the_host(op_type):
    """``lookup_table_grad`` and each sparse branch run under a dispatch
    mode that refuses ``.item()``, ``nonzero`` and ``unique``: the
    operations a CUDA graph cannot hold."""
    ids = torch.tensor([[3], [1], [3], [7]])
    w = torch.randn(9, 2, generator=torch.Generator().manual_seed(0))
    one = lambda v: torch.tensor([v])  # noqa: E731
    with _NoHostSync():
        (g,) = _t_lower("lookup_table_grad", {
            "Ids": [ids], "W": [w], "Out@GRAD": [torch.ones(4, 2)]},
            {"is_sparse": True, "padding_idx": -1})["W@GRAD"]
        ins, attrs = {
            "sgd": ({"Param": [w], "Grad": [g], "LearningRate": [one(0.1)]},
                    {}),
            "momentum": ({"Param": [w], "Grad": [g], "Velocity": [w],
                          "LearningRate": [one(0.1)]}, {"mu": 0.9}),
            "adam": ({"Param": [w], "Grad": [g], "Moment1": [w],
                      "Moment2": [w.abs()], "LearningRate": [one(0.1)],
                      "Beta1Pow": [one(0.9)], "Beta2Pow": [one(0.99)]}, {}),
            "adagrad": ({"Param": [w], "Grad": [g], "Moment": [w.abs()],
                         "LearningRate": [one(0.1)]}, {}),
            "sum": ({"X": [w, g]}, {}),
            "clip": ({"X": [g]}, {"min": -0.5, "max": 0.5}),
            "clip_by_norm": ({"X": [g]}, {"max_norm": 0.5}),
            "squared_l2_norm": ({"X": [g]}, {}),
        }[op_type]
        outs = _t_lower(op_type, ins, attrs)
    for vals in outs.values():
        for v in vals:
            assert torch.isfinite(densify(v)).all()
