"""Quantization ops — port of ``paddle_tpu/ops/quant_ops.py``: the three
fake-quant ops of quantization-aware training (:24-66) and the frozen
INT8 path's ``quantize``, ``dequantize``, ``quantized_matmul`` and
``quantized_conv2d`` (:88-168).

Reference: the xiaolil1 fork's MKL-DNN INT8 inference
(paddle/fluid/operators/mkldnn/quantize_mkldnn_op.cc,
conv_mkldnn_op.cc:287 ComputeINT8) and the QAT fake-quant ops
(operators/fake_quantize_op.cc). Fake-quant trains with a
straight-through estimator: ``x + (q(x) - x).detach()``, whose vjp (the
engine derives the grad ops' lowering as ``torch.func.vjp`` of the
forward) is the identity.

``quantized_matmul`` and ``quantized_conv2d`` contract int8 operands
into an int32 accumulator, then rescale to float32. Where
(``int8_native``, ``_native_int8``):

* on a CUDA tensor (``auto`` or ``'1'``): ``torch._int_mm``, cuBLASLt's
  int8 GEMM on the tensor cores. The convolution is an im2col of the int8
  input (``Tensor.unfold`` windows, gathered once into an
  [N*OH*OW, K] int8 matrix) times the [K, O] filter; under NHWC a 1x1
  stride-1 convolution is a plain GEMM over ``x.reshape(-1, C)``, and
  an HWIO filter is the [KH*KW*C, O] matrix as it lies. ``_int_mm``
  wants more than 16 rows and K and N multiples of 8: the operands are
  padded with zero rows or columns (a zero adds nothing to an int32 sum)
  and the result sliced;
* on the CPU (``auto`` or ``'0'``): the exact float32 emulation of the
  reference (int8 values cast to float32; products <= 127^2 and the
  partial sums of these contractions stay inside the float32 mantissa);
  ``'1'`` raises there, since the port has no CPU int8 GEMM to offer;
* ``'0'`` on a CUDA tensor: the same emulation in float64 (exact
  whatever the TF32 switches say), rounded to float32.

The int32 result is rescaled by ``1 / (sx * sy)`` (a per-column ``sy``
broadcast over N, a per-channel ``sw`` over the channel dim, last under
NHWC), as float32 division by a tensor: on CUDA a division by a Python
number multiplies by its reciprocal, which rounds otherwise.

Scale attrs become device tensors once (``_const``), on the first
(eager) run of an entry, so that a captured graph copies nothing from
the host.
"""

import threading

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_no_grad_op, register_op
from paddle_tpu_torch.ops.common import flatten_to_2d, single

_CONSTS = {}
_CONSTS_LOCK = threading.Lock()


def _const(values, device):
    """A float32 tensor of ``values`` (a float or a list) on ``device``,
    made once per (values, device)."""
    key = (tuple(values) if isinstance(values, (list, tuple))
           else float(values), str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(values, dtype=torch.float32, device=device)
        with _CONSTS_LOCK:
            t = _CONSTS.setdefault(key, t)
    return t


def _qrange(bits):
    return float(2 ** (bits - 1) - 1)


def _ste_quant(x, scale, bits):
    """Simulated quantization with straight-through gradient."""
    qmax = _qrange(bits)
    s = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax) * s
    q = q / _const(qmax, x.device)
    return x + (q - x).detach()


@register_op("fake_quantize_abs_max")
def fake_quantize_abs_max(ctx, ins, attrs):
    x = single(ins, "X")
    bits = int(attrs.get("bit_length", 8))
    scale = x.abs().amax().detach()
    out = _ste_quant(x, scale, bits)
    return {"Out": [out], "OutScale": [scale.reshape(1)]}


@register_op(
    "fake_quantize_moving_average_abs_max",
    no_grad_inputs=("InScale",),
    inplace_map={"OutScale": "InScale"},
)
def fake_quantize_moving_average_abs_max(ctx, ins, attrs):
    x = single(ins, "X")
    in_scale = single(ins, "InScale")
    bits = int(attrs.get("bit_length", 8))
    rate = float(attrs.get("moving_rate", 0.9))
    cur = x.abs().amax().reshape(1)
    if attrs.get("is_test", False) or ctx.is_test:
        scale = in_scale
    else:
        scale = rate * in_scale + (1.0 - rate) * cur
    scale = scale.detach()
    out = _ste_quant(x, scale.reshape(()), bits)
    return {"Out": [out], "OutScale": [scale]}


@register_op("fake_dequantize_max_abs")
def fake_dequantize_max_abs(ctx, ins, attrs):
    x = single(ins, "X")
    scale = single(ins, "Scale")
    qmax = float(attrs.get("max_range", _qrange(8)))
    return {"Out": [x * scale.reshape(()) / _const(qmax, x.device)]}


# -- frozen INT8 inference path --------------------------------------------

def _native_int8(x):
    """Whether ``x``'s quantized op contracts in native int8 (int32
    accumulation) or in the exact float32 emulation (reference:
    ``_native_int8``, quant_ops.py:71-85, with "a CUDA tensor" in place
    of "not the CPU backend"). ``'1'`` on a CPU tensor raises; a meta
    tensor (build-time shape inference) takes the emulation, which has
    the same shapes."""
    from paddle_tpu_torch import flags

    mode = str(flags.get_flag("int8_native")).strip().lower()
    if mode in ("", "auto"):
        return x.is_cuda
    if mode in ("0", "false"):
        return False
    if x.device.type == "cpu":
        raise RuntimeError(
            "int8_native=%r on a CPU tensor: the port has no CPU int8 "
            "GEMM; use 'auto' or '0' (the exact float32 emulation) on "
            "the CPU" % mode)
    return x.device.type != "meta"


def _scale_param(attrs, key, device, default=1.0):
    """Scalar or per-channel scale attr -> float | float32 vector."""
    v = attrs.get(key, default)
    if isinstance(v, (list, tuple)):
        return _const([float(e) for e in v], device)
    return float(v)


def _rescale(acc, sx, s):
    """``acc / (sx * s)`` in float32: ``s`` a float (the divisor is the
    float32 of the double product, as the reference's weak-typed
    scalar) or a float32 vector over the last dim (``sx`` multiplies it
    in float32)."""
    if isinstance(s, torch.Tensor):
        return acc / (sx * s)
    return acc / _const(sx * s, acc.device)


def _round_up(n, m):
    return -(-n // m) * m


def _int_mm(a, b):
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N] through ``torch._int_mm``,
    the operands padded with zeros to what it takes: M > 16, K and N
    multiples of 8."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    if (mp, np_) != (m, n):
        out = out[:m, :n]
    return out


def _emulation_dtype(x):
    """The emulation's float type: float32 on the CPU (the reference's),
    float64 on CUDA, where cuBLAS and cuDNN may sum float32 in TF32."""
    return torch.float64 if x.is_cuda else torch.float32


@register_no_grad_op("quantize")
def quantize(ctx, ins, attrs):
    """float -> int8 (reference: quantize_mkldnn_op.cc): round half to
    even, clip to [-127, 127]."""
    x = single(ins, "Input")
    scale = float(attrs.get("Scale", 1.0))
    q = torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)
    return {"Output": [q]}


@register_no_grad_op("dequantize")
def dequantize(ctx, ins, attrs):
    x = single(ins, "Input")
    scale = float(attrs.get("Scale", 1.0))
    return {"Output": [x.to(torch.float32) / _const(scale, x.device)]}


@register_no_grad_op("quantized_matmul")
def quantized_matmul(ctx, ins, attrs):
    """int8 x int8 -> int32 accumulate -> rescale to float32. Honors the
    ``mul`` op's flattening attrs so frozen fc layers keep their shape
    contract. ``scale_y`` may be a per-output-column list (per-channel
    weight quantization); the rescale broadcasts over the last dim."""
    x = single(ins, "X")  # int8 activations (pre-quantized)
    y = single(ins, "Y")  # int8 [K, N] frozen weights
    sx = float(attrs.get("scale_x", 1.0))
    sy = _scale_param(attrs, "scale_y", x.device)
    x_cols = int(attrs.get("x_num_col_dims", 1))
    lead_shape = tuple(x.shape[:x_cols])
    x2 = flatten_to_2d(x, x_cols)
    if _native_int8(x):
        out = _int_mm(x2.to(torch.int8), y.to(torch.int8)).to(torch.float32)
    else:
        dt = _emulation_dtype(x)
        out = torch.matmul(x2.to(dt), y.to(dt)).to(torch.float32)
    out = _rescale(out, sx, sy)
    return {"Out": [out.reshape(lead_shape + (y.shape[-1],))]}


def _im2col(x, kh, kw, strides, paddings, dilations, nhwc):
    """[N*OH*OW, K] int8 patches of ``x`` and (N, OH, OW): K in (C, KH,
    KW) order for NCHW (an OIHW filter's row order), (KH, KW, C) for
    NHWC (an HWIO filter's)."""
    sh, sw_ = strides
    ph, pw = paddings
    dh, dw = dilations
    ekh, ekw = dh * (kh - 1) + 1, dw * (kw - 1) + 1
    hd, wd = (1, 2) if nhwc else (2, 3)
    if ph or pw:
        pad = (0, 0, pw, pw, ph, ph) if nhwc else (pw, pw, ph, ph)
        x = F.pad(x, pad)
    # [N, C, OH, OW, ekh, ekw] (NCHW) or [N, OH, OW, C, ekh, ekw] (NHWC)
    win = x.unfold(hd, ekh, sh).unfold(wd, ekw, sw_)
    if dh > 1 or dw > 1:
        win = win[..., ::dh, ::dw]
    if nhwc:
        n, oh, ow, c = win.shape[:4]
        cols = win.permute(0, 1, 2, 4, 5, 3)
    else:
        n, c, oh, ow = win.shape[:4]
        cols = win.permute(0, 2, 3, 1, 4, 5)
    return cols.reshape(n * oh * ow, c * kh * kw), (n, oh, ow)


def _conv_int8(x, w, strides, paddings, dilations, groups, nhwc):
    """int32 [N*OH*OW, O] of the int8 convolution, and (N, OH, OW)."""
    if nhwc:
        kh, kw, cg, o = w.shape
        wmat = w.reshape(kh * kw * cg, o)
    else:
        o, cg, kh, kw = w.shape
        wmat = w.reshape(o, cg * kh * kw).t()
    if (groups == 1 and nhwc and (kh, kw) == (1, 1)
            and tuple(strides) == (1, 1) and tuple(paddings) == (0, 0)):
        n, oh, ow = x.shape[:3]
        return _int_mm(x.reshape(-1, x.shape[3]), wmat), (n, oh, ow)
    if groups == 1:
        cols, dims = _im2col(x, kh, kw, strides, paddings, dilations, nhwc)
        return _int_mm(cols, wmat), dims
    # grouped: one GEMM a group over its channel slice
    cdim = 3 if nhwc else 1
    og = o // groups
    outs = []
    for g in range(groups):
        xg = x.narrow(cdim, g * cg, cg)
        if nhwc:
            wg = w[..., g * og:(g + 1) * og].reshape(kh * kw * cg, og)
        else:
            wg = w[g * og:(g + 1) * og].reshape(og, cg * kh * kw).t()
        cols, dims = _im2col(xg, kh, kw, strides, paddings, dilations, nhwc)
        outs.append(_int_mm(cols, wg))
    return torch.cat(outs, dim=1), dims


@register_no_grad_op("quantized_conv2d")
def quantized_conv2d(ctx, ins, attrs):
    x = single(ins, "Input")   # int8 NCHW (NHWC after the layout pass)
    w = single(ins, "Filter")  # int8 OIHW (HWIO after the layout pass)
    sx = float(attrs.get("scale_x", 1.0))
    sw = _scale_param(attrs, "scale_w", x.device)  # scalar or [O]
    strides = list(attrs.get("strides", [1, 1]))
    paddings = list(attrs.get("paddings", [0, 0]))
    dilations = list(attrs.get("dilations", [1, 1]))
    groups = int(attrs.get("groups", 1))
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if _native_int8(x):
        acc, (n, oh, ow) = _conv_int8(x.to(torch.int8), w.to(torch.int8),
                                      strides, paddings, dilations, groups,
                                      nhwc)
        out = _rescale(acc.to(torch.float32), sx, sw)
        out = out.reshape(n, oh, ow, -1)
        if not nhwc:
            out = out.permute(0, 3, 1, 2).contiguous()
        return {"Output": [out]}

    dt = _emulation_dtype(x)
    xf, wf = x.to(dt), w.to(dt)
    if nhwc:
        xf, wf = xf.permute(0, 3, 1, 2), wf.permute(3, 2, 0, 1)
    out = F.conv2d(xf, wf, stride=tuple(strides), padding=tuple(paddings),
                   dilation=tuple(dilations), groups=groups).to(torch.float32)
    if nhwc:
        out = out.permute(0, 2, 3, 1).contiguous()
    if isinstance(sw, torch.Tensor):
        # per-O scale over the channel dim (last under NHWC)
        sw = sw.reshape((1, 1, 1, -1) if nhwc else (1, -1, 1, 1))
    return {"Output": [_rescale(out, sx, sw)]}
