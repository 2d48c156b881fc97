"""The sequence and beam-search slice's lowerings (ROADMAP Queue 1, step
5d, with eight ops of step 5e) against the JAX package's, on the same
random inputs (numpy, seeded), through each package's registry and
LowerContext: the 11 remaining ``sequence_ops``, ``row_conv``,
``lstm_unit``, ``gru_unit``, ``linear_chain_crf``, ``crf_decoding``,
``sequence_reshape``, ``sequence_scatter``, ``tensor_array_to_tensor``,
``beam_search`` and ``beam_search_decode``.

The cases follow the JAX package's tests: ``tests/test_sequence.py``
(ragged concat, slice, pad and unpad, the context-window convolution,
enumerate), ``tests/test_rnn_beam.py::TestBeamSearch`` (a finished beam,
the ``ids`` input, ``is_accumulated=False``, ``first_step``, exact ties)
and ``tests/test_layer_surface.py`` (the CRF, also against its
brute-force oracle here).

Tolerances: float32 outputs and grads rtol 1e-5 / atol 1e-6 (the same
formulas, summed in other orders); integer and boolean outputs exact, by
value (the JAX package runs with 64-bit types off, so its int64 outputs
come back int32). Grads: for every op with one, ``jax.vjp`` of the
reference's lowering against ``torch.func.vjp`` of the port's, the float
inputs outside ``no_grad_inputs`` as primals and one seeded cotangent for
every float output. A tensor array is ``{"buf", "len"}`` in both
packages.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.registry import (LowerContext as JLowerContext,
                                      OpRegistry as JOpRegistry)
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)

from paddle_tpu_torch.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.core.registry import (LowerContext as TLowerContext,
                                            OpRegistry as TOpRegistry)
import paddle_tpu_torch.ops  # noqa: F401  (registers the torch lowerings)

RTOL, ATOL = 1e-5, 1e-6


def _f(shape, seed, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _i(values):
    return np.asarray(values, np.int64)


def _array(buf, length):
    """A tensor array: its [capacity, ...] buffer and live length."""
    return {"buf": buf, "len": np.int32(length)}


def _log_probs(shape, seed):
    return np.log(np.random.RandomState(seed).dirichlet(
        np.ones(shape[-1]), shape[0])).astype(np.float32)


_CRF_EM = _f((2, 4, 3), 40)
_CRF_TRANS = _f((5, 3), 41, 0.3)
_CRF_LABEL = np.random.RandomState(42).randint(0, 3, (2, 4)).astype(np.int64)
# integer scores: Viterbi's ties, broken by the first best label
_CRF_EM_TIED = np.round(_f((3, 5, 4), 43)).astype(np.float32)
_CRF_TRANS_TIED = np.round(_f((6, 4), 44)).astype(np.float32)

_BEAM_PRE_IDS = _i([[3], [0], [5], [2], [0], [0]])   # end_id 0 finishes
_BEAM_PRE_SCORES = _f((6, 1), 50)
_BEAM_SCORES = _log_probs((6, 7), 51) + _BEAM_PRE_SCORES
# every beam of a group the same, equal scores: the ties decide parents
_BEAM_TIED = np.tile(np.round(_f((2, 5), 52)), (1, 3)).reshape(6, 5)

_DEC_IDS = np.random.RandomState(60).randint(0, 9, (6, 4, 1)).astype(
    np.int64)
_DEC_PARENTS = np.stack([np.random.RandomState(61 + t).randint(
    2 * (np.arange(4) // 2), 2 * (np.arange(4) // 2) + 2) for t in range(6)])
_DEC_SCORES = _f((6, 4, 1), 62)


# (id, op type, {slot: [numpy arrays or tensor arrays]}, attrs)
CASES = [
    ("sequence_softmax", "sequence_softmax",
     {"X": [_f((3, 6), 0, 2.0)], "Length": [_i([6, 2, 4])]}, {}),
    ("sequence_softmax_empty_row", "sequence_softmax",
     {"X": [_f((2, 5), 1)], "Length": [_i([0, 3])]}, {}),
    ("sequence_expand", "sequence_expand",
     {"X": [_f((3, 4), 2)], "Y": [_f((3, 5, 2), 3)]}, {"ref_level": -1}),
    ("sequence_reverse", "sequence_reverse",
     {"X": [_f((3, 5, 2), 4)], "Length": [_i([5, 3, 1])]}, {}),
    ("im2sequence_padded", "im2sequence", {"X": [_f((2, 3, 5, 6), 5)]},
     {"kernels": [2, 3], "strides": [1, 2], "paddings": [1, 0, 2, 1]}),
    ("im2sequence_stride2", "im2sequence", {"X": [_f((2, 2, 6, 6), 6)]},
     {"kernels": [2, 2], "strides": [2, 2], "paddings": [0, 0, 0, 0]}),
    ("sequence_concat_ragged", "sequence_concat",
     {"X": [_f((3, 4, 2), 7), _f((3, 3, 2), 8)],
      "Length": [_i([2, 4, 1]), _i([3, 1, 2])]}, {}),
    ("sequence_concat_three", "sequence_concat",
     {"X": [_f((2, 2, 3), 9), _f((2, 3, 3), 10), _f((2, 1, 3), 11)],
      "Length": [_i([1, 2]), _i([3, 0]), _i([1, 1])]}, {}),
    ("sequence_concat_full", "sequence_concat",
     {"X": [_f((2, 2, 3), 12), _f((2, 3, 3), 13)]}, {}),
    ("sequence_slice", "sequence_slice",
     {"X": [_f((3, 6, 2), 14)], "Offset": [_i([1, 0, 3])],
      "Length": [_i([2, 4, 3])]}, {}),
    ("sequence_slice_past_end", "sequence_slice",
     {"X": [_f((2, 5, 2), 15)], "Offset": [_i([[3], [0]])],
      "Length": [_i([[4], [5]])]}, {}),
    ("sequence_expand_as", "sequence_expand_as",
     {"X": [_f((3, 4), 16)], "Y": [_f((3, 5, 1), 17)]}, {}),
    ("sequence_pad_longer", "sequence_pad",
     {"X": [_f((3, 4, 2), 18)], "Length": [_i([2, 4, 1])],
      "PadValue": [np.array([-7.0], np.float32)]}, {"padded_length": 6}),
    ("sequence_pad_cut", "sequence_pad",
     {"X": [_f((3, 4, 2), 19)], "Length": [_i([[2], [4], [1]])],
      "PadValue": [np.array([0.5], np.float32)]}, {"padded_length": 3}),
    ("sequence_pad_default", "sequence_pad",
     {"X": [_f((2, 3), 20)], "Length": [_i([1, 3])],
      "PadValue": [np.array(2.0, np.float32)]}, {"padded_length": -1}),
    ("sequence_unpad", "sequence_unpad",
     {"X": [_f((3, 4, 2), 21)], "Length": [_i([2, 4, 0])]}, {}),
    ("sequence_conv_ctx3", "sequence_conv",
     {"X": [_f((2, 5, 3), 22)], "Length": [_i([3, 5])],
      "Filter": [_f((9, 4), 23)]},
     {"contextLength": 3, "contextStart": -1, "contextStride": 1}),
    ("sequence_conv_ctx4_start_minus2", "sequence_conv",
     {"X": [_f((3, 6, 2), 24)], "Length": [_i([6, 1, 4])],
      "Filter": [_f((8, 3), 25)]},
     {"contextLength": 4, "contextStart": -2, "contextStride": 1}),
    ("sequence_conv_ctx2_forward", "sequence_conv",
     {"X": [_f((2, 4, 3), 26)], "Length": [_i([[4], [2]])],
      "Filter": [_f((6, 5), 27)]}, {"contextLength": 2, "contextStart": 0}),
    ("sequence_enumerate", "sequence_enumerate",
     {"X": [_i([[1, 2, 3, 4], [5, 6, 7, 8]])]},
     {"win_size": 2, "pad_value": 0}),
    ("sequence_enumerate_lengths", "sequence_enumerate",
     {"X": [_i([[1, 2, 3, 4, 5], [6, 7, 8, 0, 0]])[..., None]],
      "Length": [_i([5, 3])]}, {"win_size": 3, "pad_value": 9}),
    ("row_conv", "row_conv",
     {"X": [_f((2, 5, 3), 28)], "Filter": [_f((3, 3), 29)]}, {}),
    ("lstm_unit", "lstm_unit",
     {"X": [_f((3, 8), 30)], "C_prev": [_f((3, 2), 31)]},
     {"forget_bias": 0.5}),
    ("gru_unit", "gru_unit",
     {"Input": [_f((3, 6), 32)], "HiddenPrev": [_f((3, 2), 33)],
      "Weight": [_f((2, 6), 34)], "Bias": [_f((1, 6), 35)]}, {}),
    ("gru_unit_no_bias", "gru_unit",
     {"Input": [_f((2, 9), 36)], "HiddenPrev": [_f((2, 3), 37)],
      "Weight": [_f((3, 9), 38)]}, {}),
    ("linear_chain_crf", "linear_chain_crf",
     {"Emission": [_CRF_EM], "Transition": [_CRF_TRANS],
      "Label": [_CRF_LABEL], "Length": [_i([3, 4])]}, {}),
    ("linear_chain_crf_full_rows", "linear_chain_crf",
     {"Emission": [_f((3, 5, 4), 45)], "Transition": [_f((6, 4), 46)],
      "Label": [np.random.RandomState(47).randint(0, 4, (3, 5, 1))]}, {}),
    ("crf_decoding", "crf_decoding",
     {"Emission": [_CRF_EM], "Transition": [_CRF_TRANS],
      "Length": [_i([3, 4])]}, {}),
    ("crf_decoding_ties", "crf_decoding",
     {"Emission": [_CRF_EM_TIED], "Transition": [_CRF_TRANS_TIED],
      "Length": [_i([[5], [2], [1]])]}, {}),
    ("crf_decoding_label", "crf_decoding",
     {"Emission": [_CRF_EM_TIED], "Transition": [_CRF_TRANS_TIED],
      "Label": [np.random.RandomState(48).randint(0, 4, (3, 5, 1))],
      "Length": [_i([5, 4, 3])]}, {}),
    ("sequence_reshape_narrow", "sequence_reshape",
     {"X": [_f((2, 4, 6), 49)]}, {"new_dim": 3}),
    ("sequence_reshape_wide", "sequence_reshape",
     {"X": [_f((2, 4, 6), 53)]}, {"new_dim": 12}),
    ("sequence_scatter", "sequence_scatter",
     {"X": [_f((3, 6), 54)],
      "Ids": [_i([[0, 5, 5, 2], [1, 1, 1, 1], [4, -1, 7, -8]])],
      "Updates": [_f((3, 4), 55)]}, {}),
    ("tensor_array_to_tensor_axis1", "tensor_array_to_tensor",
     {"X": [_array(_f((4, 2, 3), 56), 2)]}, {"axis": 1}),
    ("tensor_array_to_tensor_axis0", "tensor_array_to_tensor",
     {"X": [_array(_f((3, 2, 2), 57), 3)]}, {"axis": 0}),
    ("beam_search_finished_beams", "beam_search",
     {"pre_ids": [_BEAM_PRE_IDS], "pre_scores": [_BEAM_PRE_SCORES],
      "scores": [_BEAM_SCORES]},
     {"beam_size": 3, "end_id": 0, "is_accumulated": True,
      "first_step": False}),
    ("beam_search_ids", "beam_search",
     {"pre_ids": [_BEAM_PRE_IDS], "pre_scores": [_BEAM_PRE_SCORES],
      "ids": [np.random.RandomState(58).randint(0, 30, (6, 4))],
      "scores": [_BEAM_SCORES[:, :4]]},
     {"beam_size": 3, "end_id": 0}),
    ("beam_search_probabilities", "beam_search",
     {"pre_ids": [_i([[1], [2], [0], [4]])],
      "pre_scores": [_f((4, 1), 59)],
      "scores": [np.exp(_log_probs((4, 6), 63))]},
     {"beam_size": 2, "end_id": 0, "is_accumulated": False}),
    ("beam_search_first_step", "beam_search",
     {"pre_ids": [np.ones((6, 1), np.int64)],
      "pre_scores": [np.zeros((6, 1), np.float32)],
      "scores": [_log_probs((6, 5), 64)]},
     {"beam_size": 3, "end_id": 0, "first_step": True}),
    ("beam_search_equal_beams", "beam_search",
     {"pre_ids": [np.ones((6, 1), np.int64)],
      "pre_scores": [np.zeros((6, 1), np.float32)],
      "ids": [np.tile(np.arange(5), (6, 1))], "scores": [_BEAM_TIED]},
     {"beam_size": 3, "end_id": 1}),
    ("beam_search_decode", "beam_search_decode",
     {"Ids": [_array(_DEC_IDS, 4)], "ParentIdx": [_array(_DEC_PARENTS, 4)],
      "Scores": [_array(_DEC_SCORES, 4)]},
     {"beam_size": 2, "end_id": 1}),
    ("beam_search_decode_full", "beam_search_decode",
     {"Ids": [_array(_DEC_IDS, 6)], "ParentIdx": [_array(_DEC_PARENTS, 6)],
      "Scores": [_array(_DEC_SCORES, 6)]},
     {"beam_size": 2, "end_id": 1}),
]

# every lowering this file holds
SLICE_OPS = {c[1] for c in CASES}


def _jax_value(v):
    if isinstance(v, dict):
        return {k: jnp.asarray(a) for k, a in v.items()}
    return jnp.asarray(v)


def _torch_value(v):
    if isinstance(v, dict):
        return {k: torch.as_tensor(np.array(a)) for k, a in v.items()}
    return torch.from_numpy(np.array(v))


def _run(side, op_type, ins, attrs):
    """One run of ``side``'s lowering of ``op_type``: {slot: [numpy]}."""
    names = {s: ["x"] * len(v) for s, v in ins.items()}
    if side == "jax":
        ctx = JLowerContext(JOpDesc(op_type, names, {}, attrs), None,
                            rng_key=jax.random.PRNGKey(0), op_index=0)
        outs = jax.jit(lambda jins: JOpRegistry.get(op_type).lower(
            ctx, jins, attrs))(
            {s: [_jax_value(a) for a in v] for s, v in ins.items()})
        return {s: [np.asarray(x) for x in v] for s, v in outs.items()}
    ctx = TLowerContext(TOpDesc(op_type, names, {}, attrs), None, "cpu",
                        rng_seed=(0, 1), op_index=0)
    outs = TOpRegistry.get(op_type).lower(
        ctx, {s: [_torch_value(a) for a in v] for s, v in ins.items()},
        attrs)
    return {s: [x.numpy() for x in v] for s, v in outs.items()}


def _compare(want, got):
    assert sorted(got) == sorted(want)
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for g, w in zip(got[slot], want[slot]):
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.floating):
                assert g.dtype == w.dtype, (slot, g.dtype, w.dtype)
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=slot)
            else:
                np.testing.assert_array_equal(g, w, err_msg=slot)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_lowering_matches_reference(case):
    _, op_type, ins, attrs = case
    _compare(_run("jax", op_type, ins, attrs),
             _run("torch", op_type, ins, attrs))


def _primals(op_type, ins):
    """(slot, index) of each input the grad flows to: floats outside the
    op's ``no_grad_inputs``."""
    skip = TOpRegistry.get(op_type).no_grad_inputs
    return [(s, i) for s in sorted(ins) if s not in skip
            for i, v in enumerate(ins[s])
            if not isinstance(v, dict)
            and np.issubdtype(np.asarray(v).dtype, np.floating)]


VJP_CASES = [c for c in CASES
             if TOpRegistry.get(c[1]).grad_maker is not None
             and _primals(c[1], c[2])]


@pytest.mark.parametrize("case", VJP_CASES, ids=[c[0] for c in VJP_CASES])
def test_vjp_grad_matches_reference(case):
    """The grads the engine derives for the op (``torch.func.vjp`` of the
    port's lowering) against ``jax.vjp`` of the reference's, on seeded
    cotangents for every float output."""
    _, op_type, ins, attrs = case
    assert JOpRegistry.get(op_type).grad_maker is not None
    assert JOpRegistry.get(op_type).no_grad_inputs == \
        TOpRegistry.get(op_type).no_grad_inputs
    primals = _primals(op_type, ins)
    names = {s: ["x"] * len(v) for s, v in ins.items()}
    outs = _run("torch", op_type, ins, attrs)
    out_keys = [(s, i) for s in sorted(outs) for i, v in enumerate(outs[s])
                if np.issubdtype(v.dtype, np.floating)]
    cots = [_f(outs[s][i].shape, 90 + k) for k, (s, i) in enumerate(out_keys)]

    def jfwd(*xs):
        jins = {s: [_jax_value(a) for a in v] for s, v in ins.items()}
        for (s, i), x in zip(primals, xs):
            jins[s][i] = x
        ctx = JLowerContext(JOpDesc(op_type, names, {}, attrs), None,
                            rng_key=jax.random.PRNGKey(0), op_index=0)
        out = JOpRegistry.get(op_type).lower(ctx, jins, attrs)
        return tuple(out[s][i] for s, i in out_keys)

    def tfwd(*xs):
        tins = {s: [_torch_value(a) for a in v] for s, v in ins.items()}
        for (s, i), x in zip(primals, xs):
            tins[s][i] = x
        ctx = TLowerContext(TOpDesc(op_type, names, {}, attrs), None, "cpu",
                            rng_seed=(0, 1), op_index=0)
        out = TOpRegistry.get(op_type).lower(ctx, tins, attrs)
        return tuple(out[s][i] for s, i in out_keys)

    want = jax.jit(lambda xs, cs: jax.vjp(jfwd, *xs)[1](cs))(
        [jnp.asarray(ins[s][i]) for s, i in primals],
        tuple(jnp.asarray(c) for c in cots))
    _, tvjp = torch.func.vjp(
        tfwd, *[torch.from_numpy(np.array(ins[s][i])) for s, i in primals])
    got = tvjp(tuple(torch.from_numpy(c) for c in cots))
    for (s, i), g, w in zip(primals, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg="%s@GRAD" % s)


def test_no_grad_ops_match_the_reference():
    """The ops the JAX package registers without a grad have none in the
    port either; those with one have the same ``no_grad_inputs``."""
    for op_type in SLICE_OPS:
        j, t = JOpRegistry.get(op_type), TOpRegistry.get(op_type)
        assert (j.grad_maker is None) == (t.grad_maker is None), op_type
        if t.grad_maker is not None:
            assert j.no_grad_inputs == t.no_grad_inputs, op_type


def test_crf_matches_the_brute_force_oracle():
    """``linear_chain_crf``'s log-likelihood and ``crf_decoding``'s path
    against every label sequence of each row enumerated
    (tests/test_layer_surface.py's oracle)."""
    lens = _i([3, 4])
    ins = {"Emission": [_CRF_EM], "Transition": [_CRF_TRANS],
           "Length": [lens]}
    ll = _run("torch", "linear_chain_crf",
              dict(ins, Label=[_CRF_LABEL]), {})["LogLikelihood"][0]
    path = _run("torch", "crf_decoding", ins, {})["ViterbiPath"][0]
    start, end, tr = _CRF_TRANS[0], _CRF_TRANS[1], _CRF_TRANS[2:]

    def score(b, seq):
        s = start[seq[0]] + _CRF_EM[b, 0, seq[0]]
        for t in range(1, len(seq)):
            s += tr[seq[t - 1], seq[t]] + _CRF_EM[b, t, seq[t]]
        return s + end[seq[-1]]

    for b, n in enumerate(lens):
        seqs = list(itertools.product(range(3), repeat=int(n)))
        logz = np.log(np.sum(np.exp([score(b, s) for s in seqs])))
        np.testing.assert_allclose(
            ll[b, 0], score(b, _CRF_LABEL[b, :n]) - logz, rtol=1e-5,
            atol=1e-5)
        best = max(seqs, key=lambda s: score(b, s))
        np.testing.assert_array_equal(path[b, :n], best)
        assert not path[b, n:].any()


def test_sequence_scatter_adds_duplicates_and_drops_out_of_range():
    """Repeated ids add, a negative id counts from the end, and ids past
    either end are dropped, as the JAX package's ``mode="drop"``."""
    x = np.zeros((2, 4), np.float32)
    got = _run("torch", "sequence_scatter", {
        "X": [x], "Ids": [_i([[1, 1, -1, 4], [-5, 0, 3, 3]])],
        "Updates": [np.ones((2, 4), np.float32)]}, {})["Out"][0]
    np.testing.assert_array_equal(got, [[0, 2, 0, 1], [1, 0, 0, 2]])


@pytest.mark.parametrize("case", [
    c for c in CASES if c[0] in ("sequence_softmax", "sequence_reverse",
                                 "sequence_pad_longer", "sequence_conv_ctx3")
], ids=lambda c: c[0])
def test_missing_length_reads_every_row_full(case):
    """Without ``Length`` these ops read every row as full, as
    ``sequence_pool`` does (the JAX package's raise): the JAX lowering
    given every row's full length answers the same."""
    _, op_type, ins, attrs = case
    x = ins["X"][0]
    full = dict(ins, Length=[np.full((x.shape[0],), x.shape[1], np.int64)])
    bare = {s: v for s, v in ins.items() if s != "Length"}
    _compare(_run("jax", op_type, full, attrs),
             _run("torch", op_type, bare, attrs))
