"""Recurrent ops — port of ``paddle_tpu/ops/rnn_ops.py``:
``dynamic_lstm`` (:32) and ``dynamic_gru`` (:100).

Padded [B, T, ...] batches run as a Python loop over the time steps
(the JAX package's ``lax.scan``), with per-step validity masking by a
[B] ``SeqLen``: a row's state holds once ``t`` passes its length.
Their grads are ``torch.func.vjp`` of these lowerings (the engine's
generic grad), which runs the loop again. On ``meta`` tensors
(build-time shape inference) one step runs: every step has its shapes.

Gate layouts follow the reference: the LSTM's projected input [B, T, 4H]
in i, f, c, o order (lstm_op.cc), the GRU's [B, T, 3H] in update, reset,
candidate order (gru_op.cc).
"""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import single


def _act(name):
    return {
        "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
        "tanh": torch.tanh,
        "relu": lambda x: torch.clamp_min(x, 0),
        "identity": lambda x: x,
    }[name]


def _time_steps(ctx, T, reverse):
    """The loop's (step, time index) pairs: one on ``meta``."""
    n = 1 if ctx.device.type == "meta" else T
    return [(t, (T - 1 - t) if reverse else t) for t in range(n)]


def _stack(ctx, seq, T, reverse):
    """[B, T, H] from the steps' [B, H] outputs, in time order."""
    if ctx.device.type == "meta":
        h = seq[0]
        return torch.empty((h.shape[0], T, h.shape[1]), dtype=h.dtype,
                           device=h.device)
    if reverse:
        seq = seq[::-1]
    return torch.stack(seq, dim=1)


@register_op("dynamic_lstm", no_grad_inputs=("SeqLen",))
def dynamic_lstm(ctx, ins, attrs):
    x = single(ins, "Input")       # [B, T, 4H] pre-projected (x @ W_x)
    w = single(ins, "Weight")      # [H, 4H] recurrent weights
    bias = single(ins, "Bias")     # [1, 4H] (+ [1, 3H] peephole tail)
    h_prev = single(ins, "H0")
    c_prev = single(ins, "C0")
    seq_len = single(ins, "SeqLen")   # [B] or [B, 1] lengths, optional
    if seq_len is not None:
        seq_len = seq_len.reshape(-1)

    B, T, H4 = x.shape
    H = H4 // 4
    use_peepholes = bool(attrs.get("use_peepholes", False))
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cell_act = _act(attrs.get("cell_activation", "tanh"))
    cand_act = _act(attrs.get("candidate_activation", "tanh"))
    reverse = bool(attrs.get("is_reverse", False))

    gate_bias = bias[:, :4 * H]
    if use_peepholes:
        w_ic = bias[:, 4 * H:5 * H]
        w_fc = bias[:, 5 * H:6 * H]
        w_oc = bias[:, 6 * H:7 * H]
    if h_prev is None:
        h_prev = x.new_zeros((B, H))
    if c_prev is None:
        c_prev = x.new_zeros((B, H))

    hs, cs = [], []
    for _, tt in _time_steps(ctx, T, reverse):
        gates = x[:, tt] + h_prev @ w + gate_bias
        i, f, c_hat, o = gates.chunk(4, dim=1)
        if use_peepholes:
            i = i + c_prev * w_ic
            f = f + c_prev * w_fc
        i, f = gate_act(i), gate_act(f)
        c = f * c_prev + i * cand_act(c_hat)
        if use_peepholes:
            o = o + c * w_oc
        h = gate_act(o) * cell_act(c)
        if seq_len is not None:
            valid = (tt < seq_len)[:, None]
            h = torch.where(valid, h, h_prev)
            c = torch.where(valid, c, c_prev)
        h_prev, c_prev = h, c
        hs.append(h)
        cs.append(c)
    return {"Hidden": [_stack(ctx, hs, T, reverse)],
            "Cell": [_stack(ctx, cs, T, reverse)]}


@register_op("dynamic_gru", no_grad_inputs=("SeqLen",))
def dynamic_gru(ctx, ins, attrs):
    x = single(ins, "Input")       # [B, T, 3H] pre-projected
    w = single(ins, "Weight")      # [H, 3H]: [:, :2H] gates, [:, 2H:] cand
    bias = single(ins, "Bias")     # [1, 3H]
    h_prev = single(ins, "H0")
    seq_len = single(ins, "SeqLen")
    if seq_len is not None:
        seq_len = seq_len.reshape(-1)

    B, T, H3 = x.shape
    H = H3 // 3
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cand_act = _act(attrs.get("activation", "tanh"))
    reverse = bool(attrs.get("is_reverse", False))
    # origin_mode: h = (1-u)*h_prev + u*c, the original GRU paper's
    # interpolation (reference: gru_op.h origin_mode branch)
    origin = bool(attrs.get("origin_mode", False))

    w_g = w[:, :2 * H]   # update and reset recurrent weights
    w_c = w[:, 2 * H:]   # candidate recurrent weights
    if h_prev is None:
        h_prev = x.new_zeros((B, H))

    hs = []
    for _, tt in _time_steps(ctx, T, reverse):
        xt = x[:, tt]
        if bias is not None:
            xt = xt + bias
        gates = xt[:, :2 * H] + h_prev @ w_g
        u = gate_act(gates[:, :H])
        r = gate_act(gates[:, H:])
        c = cand_act(xt[:, 2 * H:] + (r * h_prev) @ w_c)
        if origin:
            h = (1.0 - u) * h_prev + u * c
        else:
            h = u * h_prev + (1.0 - u) * c
        if seq_len is not None:
            valid = (tt < seq_len)[:, None]
            h = torch.where(valid, h, h_prev)
        h_prev = h
        hs.append(h)
    return {"Hidden": [_stack(ctx, hs, T, reverse)]}
