"""Math ops — port of ``paddle_tpu/ops/math_ops.py`` for ``mul`` (:17),
``mul_grad`` (:36), ``elementwise_add/sub/mul/div`` (:178-181), ``scale``
(:212) and ``sum`` (:233), dense tensors only. The GEMMs are
``torch.matmul`` (cuBLAS on the card), as the JAX package leaves them to
XLA; float32 GEMMs run in full float32 unless the caller turns TF32 on.

Under AMP (``core/registry.py`` ``amp_scope``) the reference's dtype rules
hold exactly: ``mul`` and ``mul_grad`` take bfloat16 operands and give a
bfloat16 product (cuBLAS accumulates it in float32), and a bfloat16
activation combined elementwise with a float32 operand stays bfloat16."""

import torch

from paddle_tpu_torch.core.registry import (
    amp_enabled, register_no_grad_op, register_op,
)
from paddle_tpu_torch.ops.common import (
    amp_cast, bcast_y_to_x, flatten_to_2d, single,
)


def _matmul(a, b):
    """a @ b in a's dtype for bfloat16 and float32 operands; other float
    types (float16, whose narrow exponent overflows on long dots)
    accumulate to float32, as the reference's preferred_element_type
    float32 does (math_ops.py:25-30)."""
    if a.dtype in (torch.bfloat16, torch.float32):
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float())


@register_op("mul")
def mul(ctx, ins, attrs):
    x = single(ins, "X")
    y = single(ins, "Y")
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    x2, y2 = amp_cast(flatten_to_2d(x, xnc), flatten_to_2d(y, ync))
    out = _matmul(x2, y2)
    out_shape = tuple(x.shape[:xnc]) + tuple(y.shape[ync:])
    return {"Out": [out.reshape(out_shape)]}


@register_no_grad_op("mul_grad")
def mul_grad(ctx, ins, attrs):
    """Direct fc/mul gradients — two transposed matmuls (reference:
    mul_op.cc MulGradKernel), no forward re-run."""
    x = single(ins, "X")
    y = single(ins, "Y")
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    x2, y2 = amp_cast(flatten_to_2d(x, xnc), flatten_to_2d(y, ync))
    g2 = flatten_to_2d(single(ins, "Out@GRAD"), xnc).to(x2.dtype)
    dx = _matmul(g2, y2.t())
    dy = _matmul(x2.t(), g2)
    return {"X@GRAD": [dx.reshape(x.shape).to(x.dtype)],
            "Y@GRAD": [dy.reshape(y.shape).to(y.dtype)]}


def _elementwise(fn):
    def lower(ctx, ins, attrs):
        x = single(ins, "X")
        y = bcast_y_to_x(x, single(ins, "Y"), attrs.get("axis", -1))
        # a bf16 activation with a float32 operand (a bias add after a
        # bf16 GEMM) stays bf16 under AMP (math_ops.py:160-171); the
        # cast's vjp still gives the operand a float32 grad
        if (amp_enabled() and x.dtype == torch.bfloat16
                and y.dtype == torch.float32):
            y = y.to(torch.bfloat16)
        return {"Out": [fn(x, y)]}

    return lower


register_op("elementwise_add")(_elementwise(torch.add))
register_op("elementwise_sub")(_elementwise(torch.sub))
register_op("elementwise_mul")(_elementwise(torch.mul))
register_op("elementwise_div")(_elementwise(torch.div))


@register_op("scale")
def scale(ctx, ins, attrs):
    x = single(ins, "X")
    s = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + bias]}
    return {"Out": [(x + bias) * s]}


@register_op("sum")
def sum_op(ctx, ins, attrs):
    """Elementwise sum of the ``X`` inputs (reference: sum_op.cc); the
    ``append_backward`` dedup of repeated grads emits it."""
    xs = ins.get("X", [])
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}
