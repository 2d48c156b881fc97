"""The port's mesh path at dp=2 (and sp=2) on the CPU over gloo, against
the JAX package's runs on its 8 virtual devices.

One world of two spawned ranks (tests/torch_mesh_worker.py) runs every
case of this file; the JAX package's runs take the same startup state
and batches in this process (tests/torch_mesh_reference.py). "SPMD
computes the same math as one big batch" (tests/test_parallel_dp.py):
each case is held against the reference's dp=2 run and, where the
reference has one, its single-device run.

Tolerances, float32 on both sides, the same formulas summed in other
orders (the batch split into two partial sums, the matmuls):
- losses: rtol 1e-5 (MLP, BERT, sync batch norm), 1e-4 (ResNet, whose
  random-init logits magnify rounding);
- state after the steps, against the port's own run without a mesh:
  |d| <= 1e-5 * max|want| + 1e-5 a var;
- state against the reference: |d| <= 1e-5 * max|want| + 1e-3 for the
  MLP, a tenth of Adam's learning rate 0.01, which sizes each step
  (test_torch_bert_training.py's rule): Adam moves an element whose
  grad is near rounding noise by a different fraction of it, in the
  port's run without a mesh as much as with one (measured 1.2e-4 in
  test_torch_parallel_spmd.py); + 1e-5 elsewhere;
- ResNet's state is held against the reference's dp=2 run only: the
  reference's own dp=2 and single-device runs differ by up to 6.9 % of
  a conv velocity's max after 2 steps of this random-init batch-4 model
  (the port's two runs differ the same way), while their losses agree
  to 5e-6;
- BERT's step-1 grads and the sp program's parameter grads:
  |d| <= 1e-4 * max|want| + 1e-7;
- the runs of one program through ``Executor.run(mesh=)``,
  ``CompiledProgram`` and ``ParallelExecutor``: bitwise equal;
- ring attention: output 2e-5 + 2e-4 * |want|, grads 2e-4 + 2e-3 *
  |want| (test_parallel_spmd.py's tolerances).
"""

import json

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import parallel as j_parallel

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert

import torch_mesh_reference as ref
import torch_mesh_worker as worker

WORLD = 2
LOSS_RTOL = 1e-5
STATE_REL, STATE_ABS = 1e-5, 1e-5
MLP_REF_ABS = 1e-3
GRAD_REL, GRAD_ABS = 1e-4, 1e-7
BERT_GRADS = ("word_embedding@GRAD", "fc_0.w_0_0@GRAD",
              "layer_norm_0.w_0_0@GRAD")


def _inputs():
    rng = np.random.RandomState(11)
    mlp_state = ref.startup_state(*ref.MLP)
    bert_kw = ref.BERT[1]
    bert_feed = ref.j_models.bert.make_fake_batch(
        bert_kw["batch_size"], bert_kw["seq_len"], bert_kw["vocab_size"],
        rng=np.random.RandomState(5))
    q, k, v, g = (rng.randn(2, 2, 16, 8).astype(np.float32)
                  for _ in range(4))
    sp_state = ref.startup_state(*ref.SP_ATTENTION)
    sp_feed = {"x": rng.randn(2, 16, 16).astype(np.float32)}
    return {
        "mlp": (mlp_state, ref.mlp_batches(3)),
        "resnet": (ref.startup_state(*ref.RESNET), [{
            "img": rng.randn(4, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}] * 2),
        "sync_bn": (ref.startup_state(*ref.SYNC_BN), [
            {"img": rng.randn(4, 3, 6, 6).astype(np.float32)}
            for _ in range(2)]),
        "bert": (ref.startup_state(*ref.BERT), [bert_feed] * 3),
        "ragged": (mlp_state, ref.mlp_batches(2, batch=7, seed=3)),
        "ring": (q, k, v, g),
        "sp": (sp_state, sp_feed),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, and every case's results on each rank of one world."""
    inp = _inputs()
    mlp_state, mlp_batches = inp["mlp"]
    kind, kw = ref.MLP
    acc = (ref.model(*ref.MLP)[2]["acc"].name,)
    cases = {}
    for mode in ("executor", "compiled", "parallel", "plain"):
        cases["mlp_" + mode] = ("train_case", dict(
            kind=kind, model_kw=kw, state=mlp_state, batches=mlp_batches,
            mode=mode, axes={"dp": WORLD}, fetch_extra=acc))
    for name, model, extra in (("resnet", ref.RESNET, ()),
                               ("sync_bn", ref.SYNC_BN, ()),
                               ("bert", ref.BERT, BERT_GRADS)):
        state, batches = inp[name]
        cases[name] = ("train_case", dict(
            kind=model[0], model_kw=model[1], state=state, batches=batches,
            fetch_extra=extra, axes={"dp": WORLD}, first_fetch_only=True))
    state, batches = inp["ragged"]
    for name, mode in (("ragged", "executor"), ("ragged_plain", "plain")):
        cases[name] = ("train_case", dict(
            kind=kind, model_kw=kw, state=state, batches=batches,
            mode=mode, axes={"dp": WORLD}))
    for name, bucket in (("zero", 0.0), ("zero_bucketed", 0.01)):
        cases[name] = ("counters_case", dict(
            kind=kind, model_kw=kw, state=mlp_state, batches=mlp_batches,
            axes={"dp": WORLD},
            flag_values={"zero": True, "grad_bucket_mb": bucket}))
    for name, zero in (("spmd", False), ("spmd_zero", True)):
        cases[name] = ("spmd_case", dict(
            kind=kind, model_kw=kw, state=mlp_state, batches=mlp_batches,
            axes={"dp": WORLD}, flag_values={"zero": zero}))
    q, k, v, g = inp["ring"]
    cases["ring"] = ("ring_case", dict(q=q, k=k, v=v, g=g))
    sp_state, sp_feed = inp["sp"]
    main, _, h = ref.model(*ref.SP_ATTENTION)
    fetch = [h["out"].name, h["loss"].name] + sorted(
        p.name + "@GRAD" for p in main.all_parameters())
    for mode in ("default", "mesh"):
        cases["sp_" + mode] = ("sp_program_case", dict(
            state=sp_state, feed=sp_feed, fetch=fetch, mode=mode))
    out = worker.run_world(WORLD, cases, tmp_path_factory.mktemp("dp2"))
    return inp, out, fetch


def _dp2():
    return {"dp": WORLD}


def test_mlp_dp2_matches_reference_dp2_and_single_device(world):
    """Losses, ``accuracy`` (a batch reduction through ``top_k``: the
    global batch's value on every rank) and state."""
    inp, out, _ = world
    state, batches = inp["mlp"]
    acc = (ref.model(*ref.MLP)[2]["acc"].name,)
    want_dp = ref.train(*ref.MLP, state, batches, fetch_extra=acc,
                        axes=_dp2())
    want_one = ref.train(*ref.MLP, state, batches, fetch_extra=acc)
    got = out[0]["mlp_executor"]
    for want in (want_dp, want_one):
        np.testing.assert_allclose(ref.losses(got), ref.losses(want),
                                   rtol=LOSS_RTOL)
        for g, w in zip(got["fetches"], want["fetches"]):
            np.testing.assert_array_equal(np.asarray(g[1]).reshape(-1),
                                          np.asarray(w[1]).reshape(-1))
        ref.assert_state_close(got["state"], want["state"], STATE_REL,
                               MLP_REF_ABS)
    ref.assert_state_close(got["state"], out[0]["mlp_plain"]["state"],
                           STATE_REL, STATE_ABS)
    # every rank fetches the same global values and holds the same state
    for name in ("mlp_executor", "mlp_compiled", "mlp_parallel"):
        for r in range(1, WORLD):
            np.testing.assert_array_equal(ref.losses(out[r][name]),
                                          ref.losses(out[0][name]))
    # the params stay replicated, whole on every rank
    w0 = "fc_0.w_0_0"
    assert out[0]["mlp_executor"]["placements"][w0] == "(Replicate(),)"
    assert out[0]["mlp_executor"]["local_shapes"][w0] == (784, 128)
    # each rank's feed buffers hold its half of the batch
    assert out[0]["mlp_executor"]["feed_shapes"] == [[(4, 784), (4, 1)]]


def test_compiled_program_and_parallel_executor_runs_equal(world):
    """``Executor.run(mesh=)``, ``CompiledProgram.with_data_parallel`` and
    ``ParallelExecutor`` run the same step: bitwise equal losses and
    state."""
    _, out, _ = world
    base = out[0]["mlp_executor"]
    for name in ("mlp_compiled", "mlp_parallel"):
        np.testing.assert_array_equal(ref.losses(out[0][name]),
                                      ref.losses(base))
        for n, v in base["state"].items():
            np.testing.assert_array_equal(out[0][name]["state"][n], v,
                                          err_msg=n)


@pytest.mark.parametrize("build", ["data_parallel", "spmd",
                                   "inference_optimize"])
def test_compiled_program_descs_match_reference(build):
    """The program a ``CompiledProgram`` runs is byte-identical in both
    packages, for each strategy."""
    descs = []
    for fl, mdl in ((jfluid, ref.model),
                    (tfluid, lambda k, kw: worker._model(k, **kw))):
        main, _, h = mdl(*ref.MLP)
        cp = fl.CompiledProgram(main)
        if build == "data_parallel":
            cp.with_data_parallel(loss_name=h["loss"].name,
                                  build_strategy=fl.BuildStrategy(),
                                  exec_strategy=fl.ExecutionStrategy())
        elif build == "spmd":
            cp._program = main  # with_spmd needs a mesh of the world
        else:
            cp.with_inference_optimize(None)
        descs.append(cp._program.desc.serialize_to_string())
    assert json.loads(descs[0]) == json.loads(descs[1])
    assert descs[0] == descs[1]


def test_resnet_batch_norm_dp2_uses_global_batch_statistics(world):
    """ResNet with batch norm at dp=2 matches the reference's dp=2 run and
    its single-device run: the statistics are the global batch's."""
    inp, out, _ = world
    state, batches = inp["resnet"]
    got = out[0]["resnet"]
    want = ref.train(*ref.RESNET, state, batches, axes=_dp2())
    np.testing.assert_allclose(ref.losses(got), ref.losses(want), rtol=1e-4)
    ref.assert_state_close(got["state"], want["state"], STATE_REL,
                           STATE_ABS)
    want_one = ref.train(*ref.RESNET, state, batches)
    np.testing.assert_allclose(ref.losses(got), ref.losses(want_one),
                               rtol=1e-4)


def _port_grads(kind, kw, state, feed, names):
    """The port's grads of one step on ``feed`` without a mesh."""
    main, _, h = worker._model(kind, **kw)
    scope = tfluid.Scope()
    convert.load_numpy_state(scope, state, "cpu", program=main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        return exe.run(main, feed=feed, fetch_list=list(names))


@pytest.mark.parametrize("model,differs", [("resnet", True),
                                           ("mlp", False)])
def test_averaging_local_grads_differs_with_batch_norm(world, model, differs):
    """What a plain DDP design computes — each rank's grads from its own
    half of the batch, averaged — is the global batch's grad for the MLP
    (a mean loss, no batch statistics) but not for ResNet, whose batch
    norm normalizes each half by its own statistics."""
    inp, _, _ = world
    kind, kw = ref.RESNET if model == "resnet" else ref.MLP
    state, batches = inp[model]
    feed = batches[0]
    main, _, _ = worker._model(kind, **kw)
    names = [p.name + "@GRAD" for p in main.all_parameters()]
    whole = _port_grads(kind, kw, state, feed, names)
    halves = [_port_grads(kind, kw, state,
                          {n: np.split(v, 2)[i] for n, v in feed.items()},
                          names)
              for i in range(2)]
    worst = max(np.abs((a + b) / 2 - w).max() / (np.abs(w).max() + 1e-12)
                for a, b, w in zip(halves[0], halves[1], whole))
    if differs:
        assert worst > 1e-2
    else:
        assert worst < 1e-5


def test_sync_batch_norm_dp2_matches_reference(world):
    inp, out, _ = world
    state, batches = inp["sync_bn"]
    got = out[0]["sync_bn"]
    for want in (ref.train(*ref.SYNC_BN, state, batches, axes=_dp2()),
                 ref.train(*ref.SYNC_BN, state, batches)):
        np.testing.assert_allclose(ref.losses(got), ref.losses(want),
                                   rtol=LOSS_RTOL)
        ref.assert_state_close(got["state"], want["state"], STATE_REL,
                               STATE_ABS)


def test_bert_dp2_matches_reference_dp2(world):
    inp, out, _ = world
    state, batches = inp["bert"]
    got = out[0]["bert"]
    want = ref.train(*ref.BERT, state, batches, fetch_extra=BERT_GRADS,
                     axes=_dp2(), first_fetch_only=True)
    np.testing.assert_allclose(ref.losses(got), ref.losses(want),
                               rtol=LOSS_RTOL)
    for name, g, w in zip(BERT_GRADS, got["fetches"][0][1:],
                          want["fetches"][0][1:]):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_REL * np.abs(w).max() + GRAD_ABS,
            err_msg=name)
    ref.assert_state_close(got["state"], want["state"], STATE_REL,
                           STATE_ABS)


def test_indivisible_batch_is_replicated(world):
    """A batch of 7 over dp=2 runs whole on every rank (``batch_sharding``
    replicates it) and still matches the reference and one device."""
    inp, out, _ = world
    state, batches = inp["ragged"]
    got = out[0]["ragged"]
    assert got["feed_shapes"] == [[(7, 784), (7, 1)]]
    for want in (ref.train(*ref.MLP, state, batches, axes=_dp2()),
                 ref.train(*ref.MLP, state, batches)):
        np.testing.assert_allclose(ref.losses(got), ref.losses(want),
                                   rtol=LOSS_RTOL)
        ref.assert_state_close(got["state"], want["state"], STATE_REL,
                               MLP_REF_ABS)
    ref.assert_state_close(got["state"], out[0]["ragged_plain"]["state"],
                           STATE_REL, STATE_ABS)


@pytest.mark.parametrize("case", ["zero", "zero_bucketed"])
def test_zero1_matches_replicated_and_reference(world, case):
    """ZeRO-1 (the reference's ``zero`` flag), with and without buckets:
    the same trajectory as the replicated run and the reference's ZeRO
    run; the Adam moments live sharded on the batch axis, the params
    whole."""
    inp, out, _ = world
    state, batches = inp["mlp"]
    got = out[0][case]
    want = ref.train(*ref.MLP, state, batches, axes=_dp2(), zero=True)
    np.testing.assert_allclose(ref.losses(got), ref.losses(want),
                               rtol=LOSS_RTOL)
    ref.assert_state_close(got["state"], want["state"], STATE_REL,
                           MLP_REF_ABS)
    base = out[0]["mlp_executor"]
    np.testing.assert_allclose(ref.losses(got), ref.losses(base),
                               rtol=LOSS_RTOL)
    ref.assert_state_close(got["state"], base["state"], STATE_REL,
                           STATE_ABS)
    m1 = "fc_0.w_0_0_moment1_0"
    assert got["placements"][m1] == "(Shard(dim=0),)"
    assert got["local_shapes"][m1] == (784 // WORLD, 128)
    assert got["placements"]["fc_0.w_0_0"] == "(Replicate(),)"
    # beta powers ([1]) take the replicated path
    assert got["placements"]["fc_0.w_0_0_beta1_pow_acc_0"] == \
        "(Replicate(),)"
    buckets = got["counters"]["engine.grad_buckets"]
    if case == "zero":
        assert buckets == 0
    else:
        # 0.01 MB buckets in backward order: fc_2's and fc_1's grads
        # (35 KB) fill one, fc_0's (402 KB) the next, each step
        assert buckets == 2 * len(batches)


@pytest.mark.parametrize("case,kind", [("spmd", "all-reduce"),
                                       ("spmd_zero", "reduce-scatter")])
def test_spmd_prediction_delta_and_exact_param_grad_reductions(world, case,
                                                               kind):
    """Under ``spmd_predict`` (metrics and ``verify`` on) the entry's first
    run emits ``spmd.prediction_delta`` once, with the gauges, and the
    parameter-gradient reductions the mesh path issued equal the static
    prediction's parameter-gradient psums exactly, var by var and byte by
    byte: all-reduces of the replicated grads, or under ZeRO-1 the
    reduce-scatters (operand = the whole grad on this rank)."""
    _, out, _ = world
    for r in range(WORLD):
        got = out[r][case]
        (delta,) = got["events"]["spmd.prediction_delta"]
        assert len(got["events"]["spmd_plan"]) == 1
        assert got["gauges"]["spmd.measured_psums"] == \
            delta["psums_measured"]
        assert got["gauges"]["spmd.predicted_psums"] == \
            delta["psums_predicted"]
        assert delta["bytes_delta"] == \
            delta["bytes_measured"] - delta["bytes_predicted"]
        assert delta["peak_bytes_predicted"] > 0
        want = sorted((v, n) for k, v, n, phase in got["predicted"]
                      if k == "psum" and phase == "backward")
        grads = [c for c in got["record"] if c["source"] == "grad"]
        assert {c["kind"] for c in grads} == {kind}
        assert sorted((c["var"], c["nbytes"]) for c in grads) == want
        assert len(want) == 6  # the MLP's three weights and biases


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_sp2_matches_reference(world, causal):
    inp, out, _ = world
    q, k, v, g = inp["ring"]
    got = out[0]["ring"][causal]
    import jax
    import jax.numpy as jnp

    mesh = j_parallel.make_mesh({"sp": WORLD})

    def ring(q_, k_, v_):
        return j_parallel.ring_attention(q_, k_, v_, mesh=mesh,
                                         causal=causal)

    want_out, vjp = jax.vjp(ring, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v))
    want = [want_out] + list(vjp(jnp.asarray(g)))
    full = j_parallel.reference_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(got[0], np.asarray(full), atol=2e-5,
                               rtol=2e-4)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=2e-5,
                               rtol=2e-4)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=2e-3)
    for r in range(1, WORLD):
        for a, b in zip(out[r]["ring"][causal], got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["default", "mesh"])
def test_fused_attention_sequence_parallel_sp2(world, mode):
    """``fused_attention(sequence_parallel=True)`` inside the Transformer's
    attention block at sp=2, whole tensors in (a default mesh) and
    DTensors in (``Executor.run(mesh={'dp': 1, 'sp': 2})``): the output,
    the loss and every parameter's grad match the reference's program
    under its sp=2 default mesh."""
    inp, out, fetch = world
    state, feed = inp["sp"]
    main, _, _ = ref.model(*ref.SP_ATTENTION)
    scope = jfluid.Scope()
    for n, v in state.items():
        scope.set(n, v)
    j_parallel.set_default_mesh(j_parallel.make_mesh({"sp": WORLD}))
    try:
        want = jfluid.Executor(jfluid.CPUPlace()).run(
            main, feed=feed, fetch_list=fetch, scope=scope)
    finally:
        j_parallel.set_default_mesh(None)
    got = out[0]["sp_" + mode]
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=2e-5,
                               rtol=2e-4)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-5)
    for name, a, b in zip(fetch[2:], got[2:], want[2:]):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_REL * np.abs(b).max() + 1e-7,
                                   err_msg=name)
