"""chip_smoke.py's misc-family programs at tiny widths, built by the same
builder with each package's ``fluid``, on the CPU:

- ``skipgram`` (skip-gram over a sparse embedding, vocabulary 50,
  8-dim): descs byte-identical with either head. The ``hsigmoid`` head
  runs 3 SGD steps, losses rtol 1e-5 and every parameter within 1e-5 of
  its largest entry. The ``nce`` head runs one step with the JAX
  package's draw patched to return the port's negatives (fetched from
  the port's step): loss and parameters likewise.
- ``c3d`` (two conv3d layers with their pools, fc layers, on 4 x 16 x
  16 clips, dropout 0 so the two packages' masks agree): descs
  byte-identical, 3 Momentum steps, losses rtol 1e-5, parameters within
  1e-5 of their largest entries; the ``for_test`` clone's logits within
  1e-5.
- ``host_ops`` (``py_func`` with its numpy grad and ``Print``): 2 SGD
  steps end to end in both packages, losses and the weight within 1e-5.
- ``random_ops`` (``random_crop``, ``sampling_id`` and the two
  ``*_batch_size_like`` layers): descs byte-identical; each package's
  runs meet the contract and draw anew at each run (the bits differ
  between the packages, so only the contract is compared).

The port's scope is carried from the reference's startup state by name
(``convert.load_numpy_state``).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as j_program_guard
from paddle_tpu.ops import misc_ops as j_misc

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import convert
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.ops import misc_ops as t_misc

from torch_py_func_ids import _align_py_func_registries

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                               "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

REL = 1e-5

FRONT_ENDS = ((jfluid, JProgram, j_program_guard, j_unique_name),
              (tfluid, tfluid.Program, tfluid.program_guard, t_unique_name))

SKIPGRAM = dict(vocab=50, dim=8, neg=5, lr=0.5)
C3D = dict(stages=[((4,), [1, 2, 2], 0), ((6,), 2, [0, 1, 1])], fc=16,
           classes=5, clip=[4, 16, 16], dropout=0.0, lr=0.05, momentum=0.9)


def _build(build):
    """[(fluid, main, startup, handles)] of ``build(fluid)``, the
    reference's first; the two packages' descs byte-identical (the
    ``py_func`` registries aligned first, so the ids a build registers
    agree whatever earlier tests of the process registered)."""
    _align_py_func_registries()
    out = []
    for fluid_mod, prog_cls, guard, unique in FRONT_ENDS:
        main, startup = prog_cls(), prog_cls()
        with unique.guard(), guard(main, startup):
            handles = build(fluid_mod)
        main.random_seed = startup.random_seed = 2024
        out.append((fluid_mod, main, startup, handles))
    (_, jm, js, _), (_, tm, ts, _) = out
    assert tm.desc.serialize_to_string() == jm.desc.serialize_to_string()
    assert ts.desc.serialize_to_string() == js.desc.serialize_to_string()
    return out


def _executors(built):
    """Each package's CPU executor and scope, the port's holding the
    reference's startup state."""
    (jf, j_main, j_startup, _), (tf, t_main, _, _) = built
    j_scope = jf.Scope()
    exe = jf.Executor(jf.CPUPlace())
    with jf.scope_guard(j_scope):
        exe.run(j_startup)
    state = {v.name: np.array(j_scope.get(v.name))
             for v in j_main.list_vars() if v.persistable}
    t_scope = tf.Scope()
    convert.load_numpy_state(t_scope, state, "cpu", program=t_main)
    return [(jf, exe, j_scope), (tf, tf.Executor(tf.CPUPlace()), t_scope)]


def _run(runner, program, feed, fetch):
    fluid, exe, scope = runner
    with fluid.scope_guard(scope):
        return [np.asarray(v) for v in exe.run(program, feed=feed,
                                               fetch_list=fetch)]


def _params_close(built, runners):
    for p in built[1][1].all_parameters():
        want = np.asarray(runners[0][2].get(p.name))
        got = runners[1][2].get(p.name).numpy()
        err = float(np.abs(got - want).max())
        assert err <= REL * float(np.abs(want).max()), (p.name, err)


@pytest.mark.parametrize("head", ["nce", "hsigmoid"])
def test_skipgram_desc_matches_reference(head):
    _build(lambda fluid: chip_smoke.skipgram(fluid, head=head, **SKIPGRAM))


def test_skipgram_hsigmoid_steps_match_reference():
    built = _build(lambda fluid: chip_smoke.skipgram(
        fluid, head="hsigmoid", **SKIPGRAM))
    runners = _executors(built)
    losses = []
    for runner, (_, main, _, h) in zip(runners, built):
        losses.append([float(_run(runner, main, chip_smoke.skipgram_feed(
            16, seed=s, **SKIPGRAM), [h["loss"].name])[0].reshape(-1)[0])
            for s in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=REL)
    _params_close(built, runners)


def test_skipgram_nce_step_matches_reference_through_the_ports_negatives():
    """One step of the port, its negatives fetched; the reference's step
    from the same state with ``jax.random.randint`` returning them (the
    JAX package's files untouched): the same loss and parameters."""
    built = _build(lambda fluid: chip_smoke.skipgram(fluid, head="nce",
                                                     **SKIPGRAM))
    runners = _executors(built)
    feed = chip_smoke.skipgram_feed(16, seed=5, **SKIPGRAM)
    t_main, th = built[1][1], built[1][3]
    labels = chip_smoke.nce_op_outputs(t_main)
    t_loss, sample = _run(runners[1], t_main, feed, [th["loss"].name,
                                                     labels])
    neg = sample[:, 1:]
    assert neg.shape == (16, SKIPGRAM["neg"])
    np.testing.assert_array_equal(sample[:, 0], feed["context"][:, 0])
    real = jax.random.randint
    jax.random.randint = lambda key, shape, lo, hi: jnp.asarray(
        neg, jnp.int32)
    try:
        j_main, jh = built[0][1], built[0][3]
        (j_loss,) = _run(runners[0], j_main, feed, [jh["loss"].name])
    finally:
        jax.random.randint = real
    np.testing.assert_allclose(t_loss, j_loss, rtol=REL)
    _params_close(built, runners)


def test_c3d_steps_and_clone_match_reference():
    built = _build(lambda fluid: chip_smoke.c3d(fluid, **C3D))
    runners = _executors(built)
    losses = []
    for runner, (_, main, _, h) in zip(runners, built):
        losses.append([float(_run(runner, main, chip_smoke.c3d_feed(
            3, seed=s, **C3D), [h["loss"].name])[0].reshape(-1)[0])
            for s in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=REL)
    _params_close(built, runners)
    clip = chip_smoke.c3d_feed(2, seed=9, **C3D)["clip"]
    logits = [_run(runner, main.clone(for_test=True), {"clip": clip},
                   [h["logits"].name])[0]
              for runner, (_, main, _, h) in zip(runners, built)]
    assert logits[1].shape == (2, C3D["classes"])
    np.testing.assert_allclose(logits[1], logits[0], rtol=0,
                               atol=REL * float(np.abs(logits[0]).max()))


def test_host_ops_program_runs_end_to_end_in_both(capsys):
    built = _build(lambda fluid: chip_smoke.host_ops(fluid, 4, 3))
    runners = _executors(built)
    feed = {"x": np.random.RandomState(0).randn(4, 3).astype(np.float32)}
    losses = []
    for runner, (_, main, _, h) in zip(runners, built):
        losses.append([float(_run(runner, main, feed, [h["loss"].name])[0]
                             .reshape(-1)[0]) for _ in range(2)])
    assert losses[0][1] < losses[0][0]
    np.testing.assert_allclose(losses[1], losses[0], rtol=REL)
    _params_close(built, runners)
    assert "host_ops" in capsys.readouterr().out


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_host_ops_descs_match_after_one_package_registers_more(side):
    """Callables registered in one package alone (as another test file on
    the same worker does) leave the two packages' ``host_ops`` descs
    byte-identical."""
    register = (j_misc if side == "jax" else t_misc).register_py_func
    for _ in range(5):
        register(lambda a: a)
    _build(lambda fluid: chip_smoke.host_ops(fluid, 4, 3))


RANDOM_OPS = dict(image=[3, 12, 10], crop=[8, 6], classes=7, width=4)


def test_random_ops_program_draws_by_contract_in_both():
    """``random_ops`` (the four random layers) builds byte-identical
    descs; each package's three CPU runs meet chip_smoke's contract
    (``random_draws_ok``) and draw anew at each run; the port's runs
    repeat on a second executor."""
    built = _build(lambda fluid: chip_smoke.random_ops(fluid, **RANDOM_OPS))
    feed = chip_smoke.random_feed(5, seed=3, **RANDOM_OPS)
    names = sorted(built[0][3])
    draws = []
    for fluid_mod, main, startup, h in built + built[1:]:
        exe, scope = fluid_mod.Executor(fluid_mod.CPUPlace()), \
            fluid_mod.Scope()
        with fluid_mod.scope_guard(scope):
            exe.run(startup)
            draws.append([dict(zip(names, [np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=[h[n] for n in names])]))
                for _ in range(3)])
    for runs in draws:
        for out in runs:
            assert not chip_smoke.random_draws_ok(out, feed, **RANDOM_OPS)
            assert out["crop"].shape == (5, 3, 8, 6)
            assert out["uniform"].shape == out["normal"].shape == (5, 4)
        for a, b in zip(runs, runs[1:]):
            assert not np.array_equal(a["uniform"], b["uniform"])
            assert not np.array_equal(a["normal"], b["normal"])
    assert draws[1][0]["ids"].dtype == np.int64
    for a, b in zip(draws[1], draws[2]):
        for n in names:
            np.testing.assert_array_equal(a[n], b[n])
