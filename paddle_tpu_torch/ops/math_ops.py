"""Math ops — port of ``paddle_tpu/ops/math_ops.py`` for ``mul`` (:17),
``mul_grad`` (:36), ``matmul`` (:119), ``matmul_grad`` (:71),
``elementwise_add/sub/mul/div/max/min/pow`` (:178-184),
``elementwise_mod`` and ``elementwise_floordiv`` (:185-186: the floor
modulo, ``torch.remainder``, not ``torch.fmod``, and the floor
quotient, as ``jnp.mod`` and ``jnp.floor_divide``), ``scale``
(:212), ``sum`` (:233), ``pow`` (:255), ``clip`` (:261) and
``clip_by_norm`` (:276). The GEMMs are ``torch.matmul`` (cuBLAS on the
card), as the JAX package leaves them to XLA; float32 GEMMs run in full
float32 unless the caller turns TF32 on.

Under AMP (``core/registry.py`` ``amp_scope``) the reference's dtype rules
hold exactly: ``mul`` and ``mul_grad`` take bfloat16 operands and give a
bfloat16 product (cuBLAS accumulates it in float32), so do ``matmul``
and ``matmul_grad``, and a bfloat16 activation combined elementwise with
a float32 operand stays bfloat16.

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


def _mm(a, b):
    """a @ b in the operands' promoted type (JAX's ``result_type``):
    bfloat16 and float32 products stay in it, float16 accumulates to a
    float32 product (math_ops.py:129-135); integers stay integers."""
    rt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(rt), b.to(rt)
    return _matmul(a, b) if rt.is_floating_point else torch.matmul(a, b)


def _t(a):
    return a.transpose(-1, -2) if a.ndim > 1 else a


def _sum_to_shape(g, shape):
    """Reduce broadcast batch dims of a matmul cotangent back to the
    operand's shape (math_ops.py:56)."""
    shape = tuple(shape)
    if tuple(g.shape) == shape:
        return g
    extra = g.ndim - len(shape)
    if extra > 0:
        g = g.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, (gs, ss) in enumerate(zip(g.shape, shape))
                 if gs != ss)
    if axes:
        g = g.sum(dim=axes, keepdim=True)
    return g.reshape(shape)


@register_op("matmul")
def matmul(ctx, ins, attrs):
    """``alpha * op(X) @ op(Y)``, op a transpose of the last two dims
    when ``transpose_X``/``transpose_Y`` ask (rank-1 operands stay as
    they are), batch dims broadcast as numpy's matmul does."""
    x = single(ins, "X")
    y = single(ins, "Y")
    if attrs.get("transpose_X", False):
        x = _t(x)
    if attrs.get("transpose_Y", False):
        y = _t(y)
    x, y = amp_cast(x, y)
    out = _mm(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register_no_grad_op("matmul_grad")
def matmul_grad(ctx, ins, attrs):
    """Direct matmul gradients for every transpose combination
    (reference: matmul_op.cc MatMulGradKernel): transposed products of
    the saved operands, broadcast batch dims summed back; a rank-1
    operand takes ``torch.func.vjp`` of the product, as the reference
    takes its own vjp."""
    x = single(ins, "X")
    y = single(ins, "Y")
    g = single(ins, "Out@GRAD")
    tx = attrs.get("transpose_X", False)
    ty = attrs.get("transpose_Y", False)
    alpha = attrs.get("alpha", 1.0)
    xa, ya = amp_cast(x, y)
    if g.dtype != xa.dtype:
        g = g.to(torch.promote_types(xa.dtype, ya.dtype))
    if alpha != 1.0:
        g = g * alpha
    if x.ndim == 1 or y.ndim == 1:
        _, vjp = torch.func.vjp(
            lambda xx, yy: _mm(_t(xx) if tx else xx, _t(yy) if ty else yy),
            xa, ya)
        dx, dy = vjp(g)
        return {"X@GRAD": [dx.to(x.dtype)], "Y@GRAD": [dy.to(y.dtype)]}
    if not tx and not ty:
        dx, dy = _mm(g, _t(ya)), _mm(_t(xa), g)
    elif tx and not ty:
        dx, dy = _mm(ya, _t(g)), _mm(xa, g)
    elif not tx and ty:
        dx, dy = _mm(g, ya), _mm(_t(g), xa)
    else:
        dx, dy = _mm(_t(ya), _t(g)), _mm(_t(g), _t(xa))
    return {"X@GRAD": [_sum_to_shape(dx, x.shape).to(x.dtype)],
            "Y@GRAD": [_sum_to_shape(dy, y.shape).to(y.dtype)]}


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


def _floor_divide(x, y):
    """The floor quotient: a step function, whose grad is zero (as JAX
    derives it; torch defines none for ``floor_divide``)."""
    return torch.floor_divide(x.detach(), y.detach())


register_op("elementwise_mod", grad=None)(_elementwise(torch.remainder))
register_op("elementwise_floordiv", grad=None)(_elementwise(_floor_divide))


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
