"""The sequence and beam-search slice's layers (ROADMAP Queue 1, step 5d;
item 6) in the port against the JAX package's, on the CPU: each builds a
main and a startup desc byte-identical to the reference's (ops, slots,
attrs and the shapes inferred at build time), and both packages export
it alike (``nets.sequence_conv_pool`` is held in
test_torch_metrics_nets.py).
"""

import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as j_program_guard
from paddle_tpu.layers import nn as j_nn

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.layers import nn as t_nn

FRONT_ENDS = ((jfluid, JProgram, j_program_guard, j_unique_name),
              (tfluid, tfluid.Program, tfluid.program_guard, t_unique_name))


def _program(fluid, name):
    """One small program calling layer ``name`` of ``fluid`` (either
    package's)."""
    layers = fluid.layers
    seq = layers.data(name="seq", shape=[5, 4], dtype="float32")
    lens = layers.data(name="lens", shape=[1], dtype="int64")
    ids = layers.data(name="ids", shape=[5], dtype="int64")
    if name == "sequence_softmax":
        x = layers.data(name="x", shape=[5], dtype="float32")
        return layers.sequence_softmax(x, length=lens)
    if name == "sequence_expand":
        return layers.sequence_expand(layers.fc(input=seq, size=3), seq)
    if name == "sequence_reverse":
        return layers.sequence_reverse(seq, length=lens)
    if name == "sequence_concat":
        other = layers.data(name="other", shape=[3, 4], dtype="float32")
        return layers.sequence_concat([seq, other], lengths=[lens, lens])
    if name == "sequence_slice":
        return layers.sequence_slice(seq, lens, lens)
    if name == "sequence_first_step":
        return layers.sequence_first_step(seq, length=lens)
    if name == "sequence_expand_as":
        return layers.sequence_expand_as(layers.fc(input=seq, size=3), seq)
    if name == "sequence_pad":
        pad = layers.fill_constant(shape=[1], dtype="float32", value=-1.0)
        return list(layers.sequence_pad(seq, pad, maxlen=7, length=lens))
    if name == "sequence_unpad":
        return layers.sequence_unpad(seq, lens)
    if name == "sequence_conv":
        return layers.sequence_conv(seq, num_filters=6, filter_size=3,
                                    act="tanh", length=lens)
    if name == "sequence_conv_no_bias":
        return layers.sequence_conv(seq, num_filters=2, filter_size=4,
                                    bias_attr=False, length=lens,
                                    param_attr=fluid.ParamAttr(name="w"))
    if name == "sequence_enumerate":
        return layers.sequence_enumerate(ids, win_size=2, pad_value=3,
                                         length=lens)
    if name == "beam_search":
        pre_ids = layers.data(name="pre_ids", shape=[1], dtype="int64")
        pre_scores = layers.data(name="pre_scores", shape=[1],
                                 dtype="float32")
        scores = layers.data(name="scores", shape=[6], dtype="float32")
        top_s, top_i = layers.topk(scores, k=3)
        return list(layers.beam_search(
            pre_ids, pre_scores, top_i, layers.log(top_s), beam_size=2,
            end_id=1, return_parent_idx=True, is_accumulated=False))
    if name == "beam_search_decode":
        step = layers.fill_constant(shape=[1], dtype="int64", value=0)
        arrays = [layers.create_array(d) for d in ("int64", "float32",
                                                   "int64")]
        layers.array_write(ids, step, array=arrays[0])
        layers.array_write(seq, step, array=arrays[1])
        layers.array_write(lens, step, array=arrays[2])
        return list(layers.beam_search_decode(
            arrays[0], arrays[1], beam_size=2, end_id=1,
            parent_array=arrays[2]))
    if name == "row_conv":
        return layers.row_conv(seq, future_context_size=2, act="relu")
    if name == "lstm_unit":
        x = layers.data(name="x", shape=[3], dtype="float32")
        h = layers.data(name="h", shape=[4], dtype="float32")
        c = layers.data(name="c", shape=[4], dtype="float32")
        return list(layers.lstm_unit(x, h, c, forget_bias=0.5))
    if name == "gru_unit":
        x = layers.data(name="x", shape=[12], dtype="float32")
        h = layers.data(name="h", shape=[4], dtype="float32")
        return list(layers.gru_unit(x, h, size=12))
    if name == "gru_unit_no_bias":
        x = layers.data(name="x", shape=[9], dtype="float32")
        h = layers.data(name="h", shape=[3], dtype="float32")
        return list(layers.gru_unit(x, h, size=9, bias_attr=False))
    if name in ("linear_chain_crf", "crf_decoding"):
        em = layers.fc(input=seq, size=3, num_flatten_dims=2)
        attr = fluid.ParamAttr(name="crfw")
        ll = layers.linear_chain_crf(em, ids, param_attr=attr, length=lens)
        if name == "linear_chain_crf":
            return layers.mean(layers.scale(ll, scale=-1.0))
        return [layers.crf_decoding(em, param_attr=attr, length=lens),
                layers.crf_decoding(em, param_attr=attr, label=ids)]
    if name == "sequence_reshape":
        return layers.sequence_reshape(seq, new_dim=10)
    if name == "sequence_scatter":
        upd = layers.data(name="upd", shape=[5], dtype="float32")
        table = layers.data(name="table", shape=[8], dtype="float32")
        return layers.sequence_scatter(table, ids, upd)
    if name == "im2sequence":
        img = layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        return [layers.im2sequence(img, filter_size=[2, 3], stride=2,
                                   padding=[1, 0, 1, 2]),
                layers.im2sequence(img, filter_size=2, padding=1)]
    if name == "tensor_array_to_tensor":
        step = layers.fill_constant(shape=[1], dtype="int64", value=0)
        arr = layers.array_write(seq, step)
        return list(layers.tensor_array_to_tensor(arr, axis=1))
    raise KeyError(name)


LAYERS = ["sequence_softmax", "sequence_expand", "sequence_reverse",
          "sequence_concat", "sequence_slice", "sequence_first_step",
          "sequence_expand_as", "sequence_pad", "sequence_unpad",
          "sequence_conv", "sequence_conv_no_bias", "sequence_enumerate",
          "beam_search", "beam_search_decode", "row_conv", "lstm_unit",
          "gru_unit", "gru_unit_no_bias", "linear_chain_crf",
          "crf_decoding", "sequence_reshape", "sequence_scatter",
          "im2sequence", "tensor_array_to_tensor"]


def _descs(build):
    out = []
    for fluid_mod, prog_cls, guard, unique in FRONT_ENDS:
        main, startup = prog_cls(), prog_cls()
        with unique.guard(), guard(main, startup):
            build(fluid_mod)
        out.append((main.desc.serialize_to_string(),
                    startup.desc.serialize_to_string()))
    return out


@pytest.mark.parametrize("name", LAYERS)
def test_layer_desc_matches_reference(name):
    """Each layer appends the reference's ops, slots, attrs and vars (with
    the shapes inferred at build time), and its startup program the same
    initializers."""
    want, got = _descs(lambda fluid: _program(fluid, name))
    assert got == want


def test_layers_exported_as_in_reference():
    """The new names stand in ``layers/nn.py``'s ``__all__`` and in
    ``fluid.layers`` of both packages, and the decoder API in
    ``fluid.contrib``."""
    names = [n for n in LAYERS if n not in (
        "sequence_conv_no_bias", "gru_unit_no_bias")]
    for n in names:
        assert n in j_nn.__all__ and n in t_nn.__all__, n
        assert hasattr(jfluid.layers, n) and hasattr(tfluid.layers, n), n
    for n in ("InitState", "StateCell", "TrainingDecoder",
              "BeamSearchDecoder"):
        assert hasattr(tfluid.contrib, n) and hasattr(jfluid.contrib, n), n
    assert tfluid.contrib.decoder.__all__ == jfluid.contrib.decoder.__all__
