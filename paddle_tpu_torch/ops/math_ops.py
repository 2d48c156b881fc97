"""Math ops — port of ``paddle_tpu/ops/math_ops.py`` for ``mul`` (:17),
``mul_grad`` (:36), ``elementwise_add/sub/mul/div/max/min/pow``
(:178-184), ``scale`` (:212), ``sum`` (:233), ``pow`` (:255), ``clip``
(:261) and ``clip_by_norm`` (:276). The GEMMs are
``torch.matmul`` (cuBLAS on the card), as the JAX package leaves them to
XLA; float32 GEMMs run in full float32 unless the caller turns TF32 on.

Under AMP (``core/registry.py`` ``amp_scope``) the reference's dtype rules
hold exactly: ``mul`` and ``mul_grad`` take bfloat16 operands and give a
bfloat16 product (cuBLAS accumulates it in float32), and a bfloat16
activation combined elementwise with a float32 operand stays bfloat16.

A ``SelectedRows`` (a sparse embedding grad) keeps its rows where the
reference's SelectedRows kernels do: times or over a scalar (the
global-norm clip), ``scale`` without a bias, ``sum`` of sparse inputs
only (the rows concatenate), ``clip`` and ``clip_by_norm`` (on the merged
rows); every other use densifies it, and ``sum`` adds a sparse input into
a dense one row-wise."""

import torch

from paddle_tpu_torch.core.registry import (
    amp_enabled, register_no_grad_op, register_op,
)
from paddle_tpu_torch.core.selected_rows import SelectedRows, add_to_dense
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
        y = single(ins, "Y")
        if isinstance(x, SelectedRows):
            # a sparse grad times or over a scalar keeps its rows; other
            # pairings densify
            if (fn in (torch.mul, torch.div)
                    and not isinstance(y, SelectedRows) and y.numel() == 1):
                ys = y.reshape(())
                return {"Out": [x.map_values(lambda v: fn(v, ys))]}
            x = x.to_dense()
        if isinstance(y, SelectedRows):
            y = y.to_dense()
        y = bcast_y_to_x(x, y, attrs.get("axis", -1))
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
register_op("elementwise_max")(_elementwise(torch.maximum))
register_op("elementwise_min")(_elementwise(torch.minimum))
register_op("elementwise_pow")(_elementwise(torch.pow))


@register_op("scale")
def scale(ctx, ins, attrs):
    x = single(ins, "X")
    s = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if isinstance(x, SelectedRows):
        # no bias keeps the rows (reference: scale_op.h's SelectedRows
        # kernel); a bias densifies
        if bias == 0.0:
            return {"Out": [x.map_values(lambda v: v * s)]}
        x = x.to_dense()
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + bias]}
    return {"Out": [(x + bias) * s]}


@register_op("sum")
def sum_op(ctx, ins, attrs):
    """Elementwise sum of the ``X`` inputs (reference: sum_op.cc and
    math/selected_rows_functor.cc); the ``append_backward`` dedup of
    repeated grads emits it. Sparse inputs only stay sparse (the rows
    concatenate); a dense input makes the sum dense, the sparse ones
    added row-wise."""
    xs = ins.get("X", [])
    sparse = [x for x in xs if isinstance(x, SelectedRows)]
    dense = [x for x in xs if not isinstance(x, SelectedRows)]
    if sparse and not dense:
        rows = torch.cat([x.rows for x in sparse])
        vals = torch.cat([x.values for x in sparse])
        return {"Out": [SelectedRows(rows, vals, sparse[0].height)]}
    out = dense[0]
    for x in dense[1:]:
        out = out + x
    for x in sparse:
        out = add_to_dense(out, x)
    return {"Out": [out]}


@register_op("pow")
def pow_op(ctx, ins, attrs):
    return {"Out": [torch.pow(single(ins, "X"), attrs.get("factor", 1.0))]}


@register_op("clip")
def clip(ctx, ins, attrs):
    x = single(ins, "X")
    lo, hi = attrs.get("min"), attrs.get("max")
    if isinstance(x, SelectedRows):
        # the clip is elementwise on the dense view, so duplicates merge
        # first; the sentinel rows' zeros stay zero when the range
        # brackets 0, as a gradient clip's does
        return {"Out": [x.merged().map_values(
            lambda v: torch.clamp(v, lo, hi))]}
    return {"Out": [torch.clamp(x, lo, hi)]}


@register_op("clip_by_norm")
def clip_by_norm(ctx, ins, attrs):
    """``x`` scaled to L2 norm ``max_norm`` when its norm is larger."""
    x = single(ins, "X")
    max_norm = attrs.get("max_norm")
    # a sparse grad's norm is its merged rows'
    sr = x.merged() if isinstance(x, SelectedRows) else None
    v = x if sr is None else sr.values
    norm = torch.sqrt(torch.sum(v * v))
    out = torch.where(norm > max_norm,
                      v * (max_norm / torch.clamp(norm, min=1e-12)), v)
    return {"Out": [out if sr is None else sr.map_values(lambda _: out)]}
