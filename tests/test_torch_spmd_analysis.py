"""The port's static SPMD analysis (``paddle_tpu_torch/analysis/spmd.py``)
against the JAX package's, on the CPU: the book models of
``tests/test_spmd_analysis.py`` (BERT with its attention unfused and
fused, ResNet-20, the MNIST MLP and the batch-norm model, plain and
``sync_batch_norm``) under its meshes and axes (dp; dp x tp; with and
without a tensor-parallel rule table; ``zero1``), each built in both
packages and analysed with the same feeds and fetches. The reports must
be equal: the collective list (kind, axes, var, bytes, op type, index and
order, phase, reason), the counts, ``total_bytes``,
``ring_traffic_bytes``, the per-device and replicated peaks, the
optimizer-state ledger, the conflicts, barriers, blowups and flagged
ops, every var's sharding and the rendered report. ``op_flops_bytes`` is
equal on every op, and the three SPMD checkers (and the whole default
pipeline over a mesh) give the same findings, ``test_unsharded_param_
fails_lint``'s case included. Integers are exact; nothing is a float
but ``render``'s ratio, compared as text.

The reference's cases that hold a prediction against compiled HLO have
no counterpart: the port's measured side is the mesh path's own record
(``tests/test_torch_parallel_dp.py``).
"""

import functools
import re

import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import paddle_tpu.fluid as jfluid
from paddle_tpu import models as j_models
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.analysis import passes as j_passes
from paddle_tpu.analysis import spmd as j_spmd
from paddle_tpu.analysis import verify_program as j_verify
from paddle_tpu.analysis.diagnostics import (
    VerificationError as JVerificationError)
from paddle_tpu.parallel import ShardingRules as JRules
from paddle_tpu.parallel import make_mesh as j_make_mesh

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import models as t_models
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.analysis import passes as t_passes
from paddle_tpu_torch.analysis import spmd as t_spmd
from paddle_tpu_torch.analysis import verify_program as t_verify
from paddle_tpu_torch.analysis.diagnostics import (
    VerificationError as TVerificationError)
from paddle_tpu_torch.parallel import PartitionSpec as TP
from paddle_tpu_torch.parallel import ShardingRules as TRules

BERT_KW = dict(batch_size=8, seq_len=32, vocab_size=512, dropout=0.0,
               lr=1e-4, max_position=512, d_model=64, n_layers=2,
               n_heads=2, d_inner=128)
FEEDS = {
    "mlp": {"img": (8, 784), "label": (8, 1)},
    "resnet": {"img": (8, 3, 32, 32), "label": (8, 1)},
    "bn": {"img": (8, 3, 8, 8), "label": (8, 1)},
}
# the tensor-parallel table: fc weights column-parallel, the first one
# row-parallel (first match wins), embeddings vocab-sharded
TP_RULES = [(r"^fc_0\.w_0", ("tp", None)), (r"fc_\d+\.w_0", (None, "tp")),
            (r"embedding", ("tp", None))]
SPMD_CHECKERS = ("spmd-unsharded-param", "spmd-replication-blowup",
                 "spmd-collective-report")


def _bn_model(fluid, sync):
    """``tests/test_spmd_analysis.py``'s ``_bn_model``, in either
    package."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        layers = fluid.layers
        img = layers.data("img", shape=[3, 8, 8], dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        conv = layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                             param_attr=fluid.ParamAttr(name="zbw"))
        bn = (layers.sync_batch_norm if sync else layers.batch_norm)(
            conv, act="relu")
        pool = layers.pool2d(bn, pool_size=8, pool_type="avg")
        fc = layers.fc(pool, size=10, param_attr=fluid.ParamAttr(name="zfw"))
        loss = layers.reduce_mean(
            layers.softmax_with_cross_entropy(fc, label))
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(loss)
    return main, startup, {"loss": loss}


@functools.lru_cache(maxsize=None)
def _build(which, pkg):
    """(program, loss name, feed shapes) of a model in package ``pkg``,
    built once a test module (the analysis reads a desc, never writes
    it)."""
    models, fluid, guard = ((j_models, jfluid, j_unique_name.guard)
                            if pkg == "jax" else
                            (t_models, tfluid, t_unique_name.guard))
    with guard():
        if which == "mlp":
            main, _, h = models.mnist.get_model()
        elif which == "resnet":
            main, _, h = models.resnet.get_model(
                dataset="cifar10", depth=20, class_num=10, lr=0.1)
        elif which in ("bn", "sync_bn"):
            main, _, h = _bn_model(fluid, which == "sync_bn")
        else:
            main, _, h = models.bert.get_model(
                use_fused_attention=which == "bert_fused", **BERT_KW)
    if which.startswith("bert"):
        feeds = {k: tuple(np.shape(v)) for k, v in
                 j_models.bert.make_fake_batch(8, 32, 512, 2).items()}
    else:
        feeds = FEEDS["bn" if which.endswith("bn") else which]
    return main, h["loss"].name, feeds


def _rules(pkg, table):
    if table is None:
        return JRules() if pkg == "jax" else TRules()
    if pkg == "jax":
        return JRules([(p, JP(*s)) for p, s in table])
    return TRules([(p, TP(*s)) for p, s in table])


def _report_key(r):
    return {
        "collectives": [(c.kind, c.axes, c.var, c.nbytes, c.op_type,
                         c.op_idx, c.order, c.phase, c.reason)
                        for c in r.collectives],
        "counts": (r.psum_count, r.all_gather_count, r.n_devices),
        "bytes": (r.total_bytes, r.ring_traffic_bytes()),
        "peaks": (r.per_device_peak_bytes, r.replicated_peak_bytes),
        "opt_state": (sorted(r.opt_state.entries), r.opt_state.data_shards,
                      r.opt_state.replicated_bytes,
                      r.opt_state.zero1_savings_bytes),
        "conflicts": r.conflicts, "barriers": r.barriers,
        "replication": r.replication, "shard_map_ops": r.shard_map_ops,
        "shardings": r.shardings,
        "flags": (r.suppressed_dead, r.zero1, r.data_axes, r.mesh_axes),
        "render": r.render(),
    }


CASES = [
    (which, axes, table, zero1)
    for which in ("mlp", "resnet", "bert", "bert_fused", "bn", "sync_bn")
    for axes, table in (({"dp": 2}, None), ({"dp": 2, "tp": 2}, None),
                        ({"dp": 2, "tp": 2}, TP_RULES))
    for zero1 in (False, True)
    if not (table is not None and which.endswith("bn"))
]


def _case_id(case):
    which, axes, table, zero1 = case
    return "%s-%s%s%s" % (which, "x".join("%s%d" % kv for kv in
                                          axes.items()),
                          "-tp_rules" if table else "",
                          "-zero1" if zero1 else "")


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_analyze_spmd_reports_equal(case):
    which, axes, table, zero1 = case
    reports = {}
    for pkg, an in (("jax", j_spmd.analyze_spmd),
                    ("torch", t_spmd.analyze_spmd)):
        main, loss, feeds = _build(which, pkg)
        reports[pkg] = an(main.desc, mesh=dict(axes),
                          shard_rules=_rules(pkg, table),
                          feed_shapes=feeds, fetch_names=[loss],
                          zero1=zero1)
    j, t = (_report_key(reports[p]) for p in ("jax", "torch"))
    for k in j:
        assert t[k] == j[k], (k, t[k], j[k])
    assert reports["torch"].collectives, "every case reduces something"
    # the mesh arguments the port reads name the same mesh
    sig = (tuple(axes.items()), tuple(range(2 ** len(axes))), "cpu")
    main, loss, feeds = _build(which, "torch")
    again = t_spmd.analyze_spmd(main.desc, mesh=sig,
                                shard_rules=_rules("torch", table),
                                feed_shapes=feeds, fetch_names=[loss],
                                zero1=zero1)
    assert _report_key(again) == t


@pytest.mark.parametrize("which", ["mlp", "resnet", "bert", "bert_fused",
                                   "sync_bn"])
def test_op_flops_bytes_equal_on_every_op(which):
    costs = {}
    for pkg, fn in (("jax", j_spmd.op_flops_bytes),
                    ("torch", t_spmd.op_flops_bytes)):
        main, _, feeds = _build(which, pkg)
        block = main.desc.block(0)
        costs[pkg] = [(op.type, fn(op, block, feed_shapes=feeds))
                      for op in block.ops]
    assert costs["torch"] == costs["jax"]
    assert any(f > 0 for _, (f, _) in costs["torch"])


def _findings(report):
    return [(f.pass_name, int(f.severity), f.message, f.op_idx, f.op_type,
             f.var_names, f.hint) for f in report]


@pytest.mark.parametrize("which,axes,table", [
    ("mlp", {"dp": 2}, None),
    ("bert_fused", {"dp": 2, "tp": 2}, None),
    ("bert", {"dp": 2, "tp": 2}, TP_RULES),
    ("resnet", {"dp": 2, "tp": 2}, TP_RULES),
    ("sync_bn", {"dp": 2}, None),
])
@pytest.mark.parametrize("only_spmd", [True, False],
                         ids=["spmd_checkers", "default_pipeline"])
def test_checkers_give_the_reference_findings(which, axes, table,
                                              only_spmd):
    out = {}
    for pkg in ("jax", "torch"):
        main, loss, feeds = _build(which, pkg)
        passes = (j_passes if pkg == "jax" else t_passes)
        verify = j_verify if pkg == "jax" else t_verify
        chosen = ([passes.PASS_REGISTRY[n]() for n in SPMD_CHECKERS]
                  if only_spmd else None)
        out[pkg] = _findings(verify(
            main.desc, feed_names=sorted(feeds), fetch_names=[loss],
            mesh=j_make_mesh(axes) if pkg == "jax" else dict(axes),
            shard_rules=_rules(pkg, table), passes=chosen))
    assert out["torch"] == out["jax"]
    names = {f[0] for f in out["torch"]}
    assert "spmd-collective-report" in names
    # no mesh: the three checkers find nothing
    main, loss, feeds = _build(which, "torch")
    assert not len(t_verify(
        main.desc, feed_names=sorted(feeds), fetch_names=[loss],
        shard_rules=_rules("torch", table),
        passes=[t_passes.PASS_REGISTRY[n]() for n in SPMD_CHECKERS]))


def test_spmd_checkers_are_in_the_default_pipeline():
    assert t_passes.DEFAULT_PASSES == j_passes.DEFAULT_PASSES
    assert set(SPMD_CHECKERS) <= set(t_passes.DEFAULT_PASSES)


def test_unsharded_param_fails_lint():
    """``tests/test_spmd_analysis.py``'s case in both packages: an
    incomplete rule table under a mesh is an ERROR of
    ``spmd-unsharded-param`` with the same message; an empty table and
    no mesh are quiet."""
    errors = {}
    for pkg in ("jax", "torch"):
        main, loss, feeds = _build("mlp", pkg)
        first = sorted(vd.name for vd in main.desc.block(0).vars.values()
                       if vd.is_parameter)[0]
        spec = ("^%s$" % re.escape(first), (None, None))
        verify = j_verify if pkg == "jax" else t_verify
        mesh = j_make_mesh({"dp": 2}) if pkg == "jax" else {"dp": 2}
        err = JVerificationError if pkg == "jax" else TVerificationError
        with pytest.raises(err) as ei:
            verify(main.desc, feed_names=["img", "label"],
                   fetch_names=[loss], mesh=mesh,
                   shard_rules=_rules(pkg, [spec]), raise_on_error=True)
        assert "spmd-unsharded-param" in str(ei.value)
        errors[pkg] = _findings(ei.value.report.errors
                                if hasattr(ei.value, "report")
                                else [])
        verify(main.desc, feed_names=["img", "label"], fetch_names=[loss],
               mesh=mesh, shard_rules=_rules(pkg, None),
               raise_on_error=True)
        verify(main.desc, feed_names=["img", "label"], fetch_names=[loss],
               shard_rules=_rules(pkg, [spec]), raise_on_error=True)
    assert errors["torch"] == errors["jax"]


def test_no_mesh_and_one_device_meshes_are_empty():
    main, loss, feeds = _build("mlp", "torch")
    for mesh in (None, {"dp": 1}, {"dp": 1, "tp": 1}):
        rep = t_spmd.analyze_spmd(main.desc, mesh=mesh, feed_shapes=feeds,
                                  fetch_names=[loss])
        assert rep.empty and not rep.collectives
    assert "no mesh" in rep.render()


def test_measured_collectives_reads_the_mesh_record():
    """The record ``parallel.plan.MeshPlan`` keeps, aggregated with the
    reference's keys: a bucket's one reduce-scatter over k grads counts
    k psums."""
    record = [
        {"kind": "all-reduce", "source": "grad", "var": "w@GRAD",
         "nbytes": 256, "n_operands": 1},
        {"kind": "reduce-scatter", "source": "grad", "var": "a,b",
         "nbytes": 96, "n_operands": 2},
        {"kind": "all-gather", "source": "state", "var": "w",
         "nbytes": 128, "n_operands": 1},
        {"kind": "all-reduce", "source": "redistribute", "var": None,
         "nbytes": 4, "n_operands": 1},
    ]
    m = t_spmd.measured_collectives(record)
    assert m["psum_count"] == 4
    assert m["all_gather_count"] == 1
    assert m["total_bytes"] == 256 + 96 + 128 + 4
    assert m["by_kind"]["reduce-scatter"] == {"count": 2, "bytes": 96}
    assert t_spmd.measured_collectives(None)["psum_count"] == 0
