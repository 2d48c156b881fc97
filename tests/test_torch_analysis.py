"""The port's static verifier (``paddle_tpu_torch/analysis``) against the
JAX package's, on the CPU: the cases of ``tests/test_analysis_passes.py``
(:59-274). Each crafted program is built in both packages, isolates one
defect, and runs only the checker under test; both packages must give
the same findings (pass, severity, message, op and vars, in order), and
the port must give what the reference test asserts. A real training
program lints clean, and the executor's ``verify`` hook raises before
lowering, from the argument or the ``PADDLE_GPU_VERIFY`` flag. The
reference's timing case (:277) stays out: it is a timing test.

The sharding case hands the JAX package a real mesh and
``ShardingRules``; the port, whose mesh path is ROADMAP item 10, the
same facts as plain objects (axis names and sizes, compiled patterns and
specs), which is all its copy of the checker reads.
"""

import re
import types

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import analysis as j_analysis
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.analysis import passes as j_passes
from paddle_tpu.framework import OpRole as JOpRole
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as j_program_guard

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import analysis as t_analysis
from paddle_tpu_torch import flags
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.analysis import Severity, VerificationError
from paddle_tpu_torch.analysis import passes as t_passes
from paddle_tpu_torch.core.types import VarType
from paddle_tpu_torch.framework import OpRole
from paddle_tpu_torch.framework import Program, program_guard


def _pkg(which):
    if which == "jax":
        from paddle_tpu.framework import convert_np_dtype_to_dtype_
        return types.SimpleNamespace(
            Program=JProgram, analysis=j_analysis, passes=j_passes,
            OpRole=JOpRole, fluid=jfluid, program_guard=j_program_guard,
            dtype=convert_np_dtype_to_dtype_, unique_name=j_unique_name)
    from paddle_tpu_torch.framework import convert_np_dtype_to_dtype_
    return types.SimpleNamespace(
        Program=Program, analysis=t_analysis, passes=t_passes,
        OpRole=OpRole, fluid=tfluid, program_guard=program_guard,
        dtype=convert_np_dtype_to_dtype_, unique_name=t_unique_name)


def _fill(pkg, block, name, shape=(4,), dtype="float32", value=0.0,
          declare=True):
    if declare:
        block.create_var(name=name, shape=list(shape), dtype=dtype)
    block.append_op(
        type="fill_constant", outputs={"Out": [name]},
        attrs={"shape": list(shape), "dtype": int(pkg.dtype(dtype)),
               "value": value})


def _key(report):
    return [(f.pass_name, int(f.severity), f.message, f.op_idx, f.op_type,
             f.var_names, f.hint) for f in report]


def _both(build, pass_name, **ctx_kwargs):
    """Run one checker on ``build(pkg)`` in both packages: the port's
    report, after requiring the same findings from each."""
    reports = {}
    for which in ("jax", "torch"):
        pkg = _pkg(which)
        prog = build(pkg)
        p = getattr(pkg.passes, pass_name)()
        ctx = pkg.passes.AnalysisContext(**ctx_kwargs)
        reports[which] = pkg.analysis.verify_graph(
            pkg.analysis.build_graph(prog), ctx, passes=[p])
    assert _key(reports["torch"]) == _key(reports["jax"])
    return reports["torch"]


# -- use-before-def ------------------------------------------------------

def _relu_of(pkg, x_name, declare_x=False):
    prog = pkg.Program()
    block = prog.global_block()
    if declare_x:
        block.create_var(name=x_name, shape=[4], dtype="float32")
    block.create_var(name="out", shape=[4], dtype="float32")
    block.append_op(type="relu", inputs={"X": [x_name]},
                    outputs={"Out": ["out"]})
    return prog


def test_use_before_def_undeclared_is_error():
    report = _both(lambda pkg: _relu_of(pkg, "missing"), "UseBeforeDefPass")
    assert len(report.errors) == 1
    f = report.errors[0]
    assert "missing" in f.var_names and f.op_type == "relu"


def test_use_before_def_unwritten_nonfeed_is_warning():
    def build(pkg):
        return _relu_of(pkg, "x", declare_x=True)

    # x declared but never written and not fed -> WARNING, not ERROR
    report = _both(build, "UseBeforeDefPass", feed_names=["img"])
    assert not report.errors
    assert len(report.warnings) == 1 and "x" in report.warnings[0].var_names
    # same program with x fed -> clean
    assert not len(_both(build, "UseBeforeDefPass", feed_names=["x"]))


# -- shape-dtype ---------------------------------------------------------

def test_dtype_clash_float_int_is_error():
    def build(pkg):
        prog = pkg.Program()
        block = prog.global_block()
        _fill(pkg, block, "a", dtype="float32")
        _fill(pkg, block, "b", dtype="int64")
        block.create_var(name="c", shape=[4], dtype="float32")
        block.append_op(type="elementwise_add",
                        inputs={"X": ["a"], "Y": ["b"]},
                        outputs={"Out": ["c"]})
        return prog

    report = _both(build, "ShapeDtypePass")
    assert any(f.severity == Severity.ERROR
               and set(f.var_names) == {"a", "b"} for f in report)


def test_declared_shape_mismatch_is_warning():
    def build(pkg):
        prog = pkg.Program()
        block = prog.global_block()
        _fill(pkg, block, "a", shape=(2, 3))
        block.create_var(name="out", shape=[2, 3], dtype="float32")
        block.append_op(type="relu", inputs={"X": ["a"]},
                        outputs={"Out": ["out"]})
        # corrupt the declared shape after the fact, as a hand-edited or
        # deserialized program may carry
        prog.desc.block(0).vars["out"].shape = [7, 7]
        return prog

    report = _both(build, "ShapeDtypePass")
    assert not report.errors
    assert any("declared shape" in f.message and "out" in f.var_names
               for f in report.warnings)


# -- waw-hazard ----------------------------------------------------------

def test_waw_hazard_fires():
    def build(pkg):
        prog = pkg.Program()
        block = prog.global_block()
        _fill(pkg, block, "v", value=1.0)
        _fill(pkg, block, "v", value=2.0, declare=False)
        return prog

    report = _both(build, "WriteAfterWritePass")
    assert len(report.warnings) == 1
    assert "v" in report.warnings[0].var_names


def test_waw_with_intervening_read_is_clean():
    def build(pkg):
        prog = pkg.Program()
        block = prog.global_block()
        _fill(pkg, block, "v", value=1.0)
        block.create_var(name="r", shape=[4], dtype="float32")
        block.append_op(type="relu", inputs={"X": ["v"]},
                        outputs={"Out": ["r"]})
        _fill(pkg, block, "v", value=2.0, declare=False)
        return prog

    assert not len(_both(build, "WriteAfterWritePass"))


# -- grad-pairing --------------------------------------------------------

def test_orphan_grad_is_error():
    def build(pkg):
        prog = pkg.Program()
        block = prog.global_block()
        _fill(pkg, block, "x")
        block.create_var(name="ghost@GRAD", shape=[4], dtype="float32")
        block.append_op(type="relu_grad", inputs={"X": ["x"]},
                        outputs={"X@GRAD": ["ghost@GRAD"]},
                        attrs={"op_role": pkg.OpRole.Backward})
        return prog

    report = _both(build, "GradPairingPass")
    assert len(report.errors) == 1
    assert "ghost@GRAD" in report.errors[0].var_names
    assert "orphan" in report.errors[0].message


def test_grad_dtype_mismatch_is_warning():
    def build(pkg):
        prog = pkg.Program()
        block = prog.global_block()
        _fill(pkg, block, "x", dtype="float32")
        block.create_var(name="x@GRAD", shape=[4], dtype="float32")
        block.append_op(type="relu_grad", inputs={"X": ["x"]},
                        outputs={"X@GRAD": ["x@GRAD"]},
                        attrs={"op_role": pkg.OpRole.Backward})
        # stale metadata: the desc claims an int gradient
        prog.desc.block(0).vars["x@GRAD"].dtype = VarType.INT64
        return prog

    report = _both(build, "GradPairingPass")
    assert not report.errors
    assert any(set(f.var_names) == {"x@GRAD", "x"}
               for f in report.warnings)


# -- dead-op -------------------------------------------------------------

def test_dead_op_fires_with_fetch_names():
    def build(pkg):
        prog = pkg.Program()
        block = prog.global_block()
        _fill(pkg, block, "live")
        _fill(pkg, block, "dead")
        return prog

    report = _both(build, "DeadOpPass", fetch_names=["live"])
    assert len(report.warnings) == 1
    assert "dead" in report.warnings[0].var_names
    # without fetch info every terminal op is a potential fetch: silent
    assert not len(_both(build, "DeadOpPass"))


# -- sharding ------------------------------------------------------------

class _Rules:
    """The facts of a sharding-rule table the checker reads: (compiled
    pattern, spec) pairs."""

    def __init__(self, pairs):
        self._rules = [(re.compile(p), s) for p, s in pairs]

    def rules(self):
        return list(self._rules)


def _mesh(axes):
    return types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


@pytest.mark.parametrize("axes", [{"dp": 2}, {"dp": 2, "tp": 2}])
def test_sharding_unknown_axis_is_error(axes):
    from jax.sharding import PartitionSpec
    from paddle_tpu.parallel.mesh import make_mesh
    from paddle_tpu.parallel.sharding import ShardingRules

    def build(pkg):
        prog = pkg.Program()
        _fill(pkg, prog.global_block(), "fc_w", shape=(8, 8))
        return prog

    j_rules = ShardingRules()
    j_rules.add("fc_w", PartitionSpec(None, "tp"))
    j_rep = j_analysis.verify_graph(
        j_analysis.build_graph(build(_pkg("jax"))),
        j_passes.AnalysisContext(mesh=make_mesh(axes), shard_rules=j_rules),
        passes=[j_passes.ShardingConsistencyPass()])
    t_rep = t_analysis.verify_graph(
        t_analysis.build_graph(build(_pkg("torch"))),
        t_passes.AnalysisContext(mesh=_mesh(axes),
                                 shard_rules=_Rules([("fc_w",
                                                      (None, "tp"))])),
        passes=[t_passes.ShardingConsistencyPass()])
    assert _key(t_rep) == _key(j_rep)
    if "tp" in axes:
        assert not t_rep.errors
    else:
        assert len(t_rep.errors) == 1
        assert "'tp'" in t_rep.errors[0].message
    # without rules the checker finds nothing
    assert not len(t_analysis.verify_graph(
        t_analysis.build_graph(build(_pkg("torch"))),
        t_passes.AnalysisContext(),
        passes=[t_passes.ShardingConsistencyPass()]))


# -- clean program + executor wiring ------------------------------------

def _build_mlp_training(pkg):
    main, startup = pkg.Program(), pkg.Program()
    layers = pkg.fluid.layers
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = layers.data(name="img", shape=[784], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        h = layers.fc(input=img, size=128, act="relu")
        h2 = layers.fc(input=h, size=64, act="relu")
        pred = layers.fc(input=h2, size=10, act=None)
        avg_loss = layers.mean(layers.softmax_with_cross_entropy(
            logits=pred, label=label))
        acc = layers.accuracy(input=pred, label=label)
        pkg.fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_loss)
    return main, startup, avg_loss, acc


def test_clean_program_has_no_findings():
    reports = {}
    for which in ("jax", "torch"):
        pkg = _pkg(which)
        main, startup, avg_loss, acc = _build_mlp_training(pkg)
        reports[which] = pkg.analysis.verify_program(
            main, feed_names=["img", "label"],
            fetch_names=[avg_loss.name, acc.name])
        assert not len(pkg.analysis.verify_program(startup))
    report = reports["torch"]
    assert _key(report) == _key(reports["jax"])
    assert not report.errors, report.render()
    assert not report.warnings, report.render()


def _missing_input_program():
    prog = Program()
    block = prog.global_block()
    out = block.create_var(name="out", shape=[4], dtype="float32")
    block.append_op(type="relu", inputs={"X": ["missing"]},
                    outputs={"Out": ["out"]})
    return prog, out


def test_executor_verify_raises_before_lowering():
    prog, out = _missing_input_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        with pytest.raises(VerificationError) as ei:
            exe.run(prog, feed={}, fetch_list=[out], verify=True)
    assert "missing" in str(ei.value)
    assert not exe.engine._cache  # nothing was lowered


def test_verify_env_flag_default_on():
    prog, out = _missing_input_program()
    flags.set_flags({"verify": True})
    try:
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(tfluid.Scope()):
            with pytest.raises(VerificationError):
                exe.run(prog, feed={}, fetch_list=[out])
            # explicit verify=False overrides the flag; the failure is
            # now the engine's (the missing input), not the verifier's
            with pytest.raises(Exception) as ei:
                exe.run(prog, feed={}, fetch_list=[out], verify=False)
            assert not isinstance(ei.value, VerificationError)
    finally:
        flags.reset_flag("verify")


def test_verified_mlp_trains():
    """``verify=True`` on a clean training program: no finding stops it,
    and it trains as without."""
    main, startup, avg_loss, _ = _build_mlp_training(_pkg("torch"))
    exe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(0)
    x = rng.randn(16, 784).astype(np.float32)
    y = rng.randint(0, 10, (16, 1)).astype(np.int64)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup, verify=True)
        losses = [float(np.asarray(exe.run(
            main, feed={"img": x, "label": y}, fetch_list=[avg_loss],
            verify=True)[0]).reshape(())) for _ in range(3)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("transformed", [False, True])
@pytest.mark.parametrize("kind", ["bert_train", "bert_serve", "nmt_train"])
def test_model_findings_match_reference(kind, transformed):
    """The whole default pipeline on the unfused BERT and Transformer
    programs, as built and as level 1 transforms them: the same findings
    in both packages (INFO and WARNING ones: the dead heads of a served
    encoder, unread outputs...), and no ERROR."""
    from test_torch_transforms import _programs

    t_prog, feeds, fetches = _programs("torch", kind, 0.1)
    j_prog, _, _ = _programs("jax", kind, 0.1)
    if transformed:
        t_prog, _ = t_analysis.optimize_program(
            t_prog, level=1, feed_names=feeds, fetch_names=fetches)
        j_prog, _ = j_analysis.optimize_program(
            j_prog, level=1, feed_names=feeds, fetch_names=fetches)
    t_rep = t_analysis.verify_program(t_prog, feed_names=feeds,
                                      fetch_names=fetches)
    j_rep = j_analysis.verify_program(j_prog, feed_names=feeds,
                                      fetch_names=fetches)
    assert _key(t_rep) == _key(j_rep)
    assert len(t_rep) and not t_rep.errors
