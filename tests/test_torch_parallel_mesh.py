"""The port's mesh helpers, sharding rules and ZeRO-1 plans against the
JAX package's (tests/test_mesh_sharding.py's cases), with no spawned
process, and the engine's mesh path in a one-rank world held in this
process: a 1-rank mesh is bit-identical to no mesh, and the engine's
cache keys on the mesh and the rule table.

``zero1_plan`` reads only the desc, so both packages must give the same
plan, spec for spec, on the same programs.
"""

import types
import warnings

import numpy as np
import pytest
import torch.distributed as dist

from jax.sharding import PartitionSpec as JP
from paddle_tpu import models as j_models
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.parallel import sharding as j_sharding

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import flags, models, observability as obs, parallel
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel.plan import gather
from paddle_tpu_torch.parallel.sharding import (
    PartitionSpec as P, ShardingRules, batch_sharding, placements,
    zero1_extend_spec, zero1_plan,
)
from torch.distributed.tensor import Replicate, Shard


def _fake_mesh(**axes):
    """What the spec helpers read of a mesh: its axis names and sizes."""
    return types.SimpleNamespace(mesh_dim_names=tuple(axes),
                                 mesh=np.zeros(tuple(axes.values())))


class TestMeshFactors:
    def test_parse_mesh_spec(self):
        assert tmesh.parse_mesh_spec("dp=4,tp=2") == {"dp": 4, "tp": 2}
        assert tmesh.parse_mesh_spec(" dp=2 , sp=4 ") == {"dp": 2, "sp": 4}

    def test_parse_wildcard_takes_remaining_devices(self):
        ranks = list(range(8))
        assert tmesh.parse_mesh_spec("dp=-1", ranks) == {"dp": 8}
        spec = tmesh.parse_mesh_spec("dp=-1,tp=2", ranks)
        assert spec == {"dp": 4, "tp": 2}
        with pytest.raises(ValueError, match="not divisible"):
            tmesh.parse_mesh_spec("dp=-1,tp=3", ranks)

    @pytest.mark.parametrize("spec", ["dp=-1,tp=-1", "dp4", ""])
    def test_parse_rejects_bad_specs(self, spec):
        with pytest.raises(ValueError):
            tmesh.parse_mesh_spec(spec, list(range(8)))

    def test_make_mesh_too_few_devices(self):
        with pytest.raises(ValueError,
                           match=r"mesh \{'dp': 2\} needs 2 devices, have 1"):
            tmesh.make_mesh({"dp": 2}, devices=[0], device_type="cpu")

    def test_mesh_from_flag_unset(self):
        assert tmesh.mesh_from_flag("cpu") is None


class TestShardingRuleTables:
    def test_first_match_wins_on_overlap(self):
        rules = ShardingRules([
            (r"layer_0\.fc\.w", P("tp", None)),
            (r"fc\.w", P(None, "tp")),
        ])
        assert rules.spec_for("layer_0.fc.w_0") == P("tp", None)
        assert rules.spec_for("layer_3.fc.w_0") == P(None, "tp")
        flipped = ShardingRules([
            (r"fc\.w", P(None, "tp")),
            (r"layer_0\.fc\.w", P("tp", None)),
        ])
        assert flipped.spec_for("layer_0.fc.w_0") == P(None, "tp")

    def test_signature_matches_reference(self):
        table = [(r"w1", (None, "tp")), (r"w2", (("dp", "tp"), None))]
        a = ShardingRules([(p, P(*s)) for p, s in table])
        b = ShardingRules([(p, P(*s)) for p, s in table])
        c = ShardingRules([(r"w1", P("tp", None))])
        assert a.signature() == b.signature() != c.signature()
        assert ShardingRules().signature() == ()
        j = j_sharding.ShardingRules([(p, JP(*s)) for p, s in table])
        assert a.signature() == j.signature()

    def test_rank_mismatch_raises(self):
        rules = ShardingRules([(r"w1", P(None, "tp", None))])
        with pytest.raises(ValueError, match="rank 3 > var 'w1' rank 2"):
            rules.spec_for("w1", ndim=2)

    def test_unmatched_param_warns_once_and_counts(self):
        obs.set_enabled(True)
        try:
            obs.reset()
            rules = ShardingRules([(r"fc\.w", P(None, "tp"))])
            with pytest.warns(RuntimeWarning, match="matches no rule"):
                spec = rules.spec_for("embedding_0", warn_unmatched=True)
            assert spec == P()
            assert obs.counter_value("sharding.unmatched_param") == 1
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                rules.spec_for("embedding_0", warn_unmatched=True)
            assert obs.counter_value("sharding.unmatched_param") == 1
        finally:
            obs.set_enabled(None)
            obs.reset()

    def test_empty_table_never_warns(self):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert ShardingRules().spec_for("w", warn_unmatched=True) == P()

    def test_coverage(self):
        with unique_name.guard():
            main, _, _ = models.mnist.get_model()
        cov = ShardingRules([(r"fc_0\.w", P(None, "tp")),
                             (r"never", P())]).coverage(main)
        assert cov.matched == {"fc_0.w_0_0": r"fc_0\.w"}
        assert "fc_1.w_0_0" in cov.unmatched
        assert cov.rules_unused == ["never"]


class TestPlacements:
    def test_spec_to_placements(self):
        mesh = _fake_mesh(dp=2, tp=2)
        assert placements(mesh, P()) == (Replicate(), Replicate())
        assert placements(mesh, P(None, "tp")) == (Replicate(), Shard(1))
        assert placements(mesh, P("tp", "dp")) == (Shard(1), Shard(0))
        assert placements(mesh, P(("dp", "tp"))) == (Shard(0), Shard(0))

    @pytest.mark.parametrize("shape,want", [
        ((8, 3), (Shard(0), Replicate())),
        ((7, 3), (Replicate(), Replicate())),
        ((), (Replicate(), Replicate())),
    ])
    def test_batch_sharding(self, shape, want):
        mesh = _fake_mesh(dp=2, tp=2)
        assert batch_sharding(mesh, np.zeros(shape)) == want

    @pytest.mark.parametrize("spec,shape", [
        ((), (8, 4)), ((), (3, 4)), ((None, "tp"), (6, 4)),
        (("tp", None), (6, 4)), ((), (1,)), ((), (5,)), (("dp",), (4,)),
    ])
    def test_zero1_extend_spec_matches_reference(self, spec, shape):
        axes = {"dp": 2, "tp": 2}
        got = zero1_extend_spec(P(*spec), shape, ("dp",), axes)
        want = j_sharding.zero1_extend_spec(JP(*spec), shape, ("dp",), axes)
        assert (got is None) == (want is None)
        if got is not None:
            assert tuple(got) == tuple(want)


def _programs(which):
    kw = {"mlp": ("mnist", dict()),
          "bert": ("bert", dict(batch_size=2, seq_len=8, vocab_size=20,
                                d_model=8, n_layers=1, n_heads=2,
                                d_inner=16, max_position=8)),
          "resnet": ("resnet", dict(dataset="cifar10", depth=8))}[which]
    with j_unique_name.guard():
        j_main = getattr(j_models, kw[0]).get_model(**kw[1])[0]
    with unique_name.guard():
        t_main = getattr(models, kw[0]).get_model(**kw[1])[0]
    return j_main, t_main


@pytest.mark.parametrize("which", ["mlp", "bert", "resnet"])
@pytest.mark.parametrize("axes,rules", [
    ({"dp": 2}, None),
    ({"dp": 4}, None),
    ({"dp": 2, "tp": 2}, [(r"fc_0\.w", (None, "tp")),
                          (r"fc_1\.w", ("tp", None))]),
])
def test_zero1_plan_matches_reference(which, axes, rules):
    """The same plan, spec for spec, from both packages' descs: which
    params shard their update, which slots live sharded, where each grad
    is reduce-scattered (replicated for an embedding's, none for batch
    norm's)."""
    j_main, t_main = _programs(which)
    j_rules = t_rules = None
    if rules is not None:
        j_rules = j_sharding.ShardingRules([(p, JP(*s)) for p, s in rules])
        t_rules = ShardingRules([(p, P(*s)) for p, s in rules])
    want = j_sharding.zero1_plan(j_main.desc.global_block(), axes,
                                 shard_rules=j_rules)
    got = zero1_plan(t_main.desc.global_block(), axes, shard_rules=t_rules)
    assert got.param_specs, which
    for g, w in zip(got, want):
        assert {n: tuple(s) for n, s in g.items()} == \
            {n: tuple(s) for n, s in w.items()}
    if which == "bert":
        assert got.grad_specs["word_embedding@GRAD"] == P()
    if which == "resnet":
        assert not any(n.startswith("batch_norm") for n in got.param_specs)


def test_dist_strategy_pserver_raises_naming_10b():
    """Item 10b ported the transpiler's transports; ParallelExecutor
    refuses them with the reference's ValueError, naming the
    transpiler."""
    for strategy in ("pserver", "nccl2"):
        with pytest.raises(ValueError,
                           match="go through DistributeTranspiler"):
            fluid.ParallelExecutor(use_cuda=False, dist_strategy=strategy)
    with pytest.raises(ValueError, match="unknown dist_strategy"):
        fluid.ParallelExecutor(use_cuda=False, dist_strategy="ring")


def test_spmd_lowering_context():
    assert tmesh.current_spmd() is None
    mesh = _fake_mesh(dp=1)
    with tmesh.spmd_lowering(mesh, ("dp",)):
        assert tmesh.current_spmd() == (mesh, ("dp",))
        with tmesh.spmd_lowering(None):
            assert tmesh.current_spmd() == (mesh, ("dp",))
    assert tmesh.current_spmd() is None


# -- one rank in this process -------------------------------------------
@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo world in this process (a FileStore, no port)."""
    path = tmp_path_factory.mktemp("one_rank") / "store"
    assert not dist.is_initialized()
    parallel.init_distributed(num_processes=1, process_id=0,
                              device_type="cpu",
                              init_method="file://%s" % path)
    try:
        yield
    finally:
        tmesh._meshes.clear()
        dist.destroy_process_group()


def _mesh(axes):
    return parallel.make_mesh(axes, device_type="cpu")


def _bert_run(mesh=None, steps=3, dropout=0.1, opt_level=None):
    with unique_name.guard():
        main, startup, h = models.bert.get_model(
            batch_size=4, seq_len=16, vocab_size=64, d_model=32,
            n_layers=1, n_heads=2, d_inner=64, dropout=dropout, lr=1e-3,
            max_position=16)
    batch = models.bert.make_fake_batch(4, 16, 64, 2,
                                        rng=np.random.RandomState(0))
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    out = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(steps):
            (l,) = exe.run(main, feed=batch, fetch_list=[h["loss"]],
                           mesh=mesh, opt_level=opt_level)
            out.append(float(np.asarray(l).reshape(-1)[0]))
        params = {p.name: np.asarray(gather(
            scope.get(p.name))) for p in main.all_parameters()}
    return out, params


def _mlp(rules_w1=None):
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[16], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
            h = fluid.layers.fc(input=x, size=32, act="relu",
                                param_attr=fluid.ParamAttr(name="w1"),
                                bias_attr=False)
            pred = fluid.layers.fc(input=h, size=4,
                                   param_attr=fluid.ParamAttr(name="w2"),
                                   bias_attr=False)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits=pred,
                                                        label=y))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _mlp_feed(step):
    rng = np.random.RandomState(step)
    return {"x": rng.randn(16, 16).astype(np.float32),
            "y": rng.randint(0, 4, (16, 1)).astype(np.int64)}


@pytest.mark.parametrize("opt_level", [1, 2])
def test_one_rank_mesh_is_bit_identical_bert(one_rank, opt_level):
    """A 1-rank mesh is bit-identical to no mesh (the reference's
    acceptance criterion, executor.py:192-193), dropout on."""
    base, base_params = _bert_run(opt_level=opt_level)
    got, got_params = _bert_run(mesh=_mesh({"dp": 1}), opt_level=opt_level)
    assert got == base
    for n, v in base_params.items():
        np.testing.assert_array_equal(got_params[n], v, err_msg=n)


def test_one_rank_mesh_is_bit_identical_mlp(one_rank):
    runs = []
    for mesh in (None, _mesh({"dp": 1}), _mesh({"dp": 1, "tp": 1})):
        main, startup, loss = _mlp()
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        runs.append([float(exe.run(main, feed=_mlp_feed(s),
                                   fetch_list=[loss], scope=scope,
                                   mesh=mesh)[0]) for s in range(4)])
    assert runs[0] == runs[1] == runs[2]


def test_engine_cache_keys_on_mesh(one_rank):
    main, startup, loss = _mlp()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)

    def run(**kw):
        exe.run(main, feed=_mlp_feed(0), fetch_list=[loss], scope=scope,
                **kw)
        return len(exe.engine._cache)

    n1 = run()
    sizes = [run(mesh=_mesh({"dp": 1})), run(mesh=_mesh({"dp": 1, "tp": 1})),
             run(), run(mesh=_mesh({"dp": 1}))]
    assert sizes == [n1 + 1, n1 + 2, n1 + 2, n1 + 2]
    assert tmesh.mesh_signature(_mesh({"dp": 1})) == \
        tmesh.mesh_signature(_mesh({"dp": 1}))
    assert len({tmesh.mesh_signature(_mesh(a)) for a in (
        {"dp": 1}, {"tp": 1}, {"dp": 1, "tp": 1})}) == 3
    assert tmesh.mesh_signature(None) is None


def test_rule_table_is_part_of_the_cache_key_and_reshards(one_rank):
    """Two rule tables on one scope are two entries; the second lays the
    first's state out anew (``engine.state_resharded``)."""
    main, startup, loss = _mlp()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    mesh = _mesh({"dp": 1, "tp": 1})
    flags.set_flags({"metrics": True})
    obs.reset()
    try:
        def run(rules):
            exe.run(main, feed=_mlp_feed(0), fetch_list=[loss], scope=scope,
                    mesh=mesh, shard_rules=rules)
            return len(exe.engine._cache)

        n1 = run(ShardingRules([(r"w1", P(None, "tp"))]))
        assert scope.get("w1").placements == (Replicate(), Shard(1))
        assert run(ShardingRules([(r"w1", P("tp", None))])) == n1 + 1
        assert scope.get("w1").placements == (Replicate(), Shard(0))
        assert obs.counter_value("engine.state_resharded") == 1
        assert run(ShardingRules([(r"w1", P(None, "tp"))])) == n1 + 1
        assert obs.counter_value("engine.state_resharded") == 2
    finally:
        flags.reset_flag("metrics")
        obs.reset()


def test_mesh_from_flag(one_rank):
    flags.set_flags({"mesh": "dp=-1"})
    try:
        mesh = tmesh.mesh_from_flag("cpu")
        assert tmesh.axis_sizes(mesh) == {"dp": 1}
        # the flag puts a plain run on the mesh: the state comes back
        # as DTensors
        main, startup, loss = _mlp()
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=_mlp_feed(0), fetch_list=[loss], scope=scope)
        assert scope.get("w1").placements == (Replicate(),)
    finally:
        flags.reset_flag("mesh")


def test_mesh_refuses_accumulation_and_remat(one_rank):
    main, startup, loss = _mlp()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for kw in ({"accumulate_steps": 2}, {"remat_segments": 2}):
        with pytest.raises(NotImplementedError, match="over a mesh"):
            exe.run(main, feed=_mlp_feed(0), fetch_list=[loss], scope=scope,
                    mesh=_mesh({"dp": 1}), **kw)
