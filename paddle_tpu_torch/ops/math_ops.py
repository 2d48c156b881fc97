"""Math ops — port of ``paddle_tpu/ops/math_ops.py`` for ``mul`` (:17) and
``elementwise_add/sub/mul/div`` (:178-181). The GEMM is ``torch.matmul``
(cuBLAS on the card), as the JAX package leaves it to XLA; float32 GEMMs
run in full float32 unless the caller turns TF32 on."""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import bcast_y_to_x, flatten_to_2d, single


@register_op("mul")
def mul(ctx, ins, attrs):
    x = single(ins, "X")
    y = single(ins, "Y")
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    out = torch.matmul(flatten_to_2d(x, xnc), flatten_to_2d(y, ync))
    out_shape = tuple(x.shape[:xnc]) + tuple(y.shape[ync:])
    return {"Out": [out.reshape(out_shape)]}


def _elementwise(fn):
    def lower(ctx, ins, attrs):
        x = single(ins, "X")
        y = bcast_y_to_x(x, single(ins, "Y"), attrs.get("axis", -1))
        return {"Out": [fn(x, y)]}

    return lower


register_op("elementwise_add")(_elementwise(torch.add))
register_op("elementwise_sub")(_elementwise(torch.sub))
register_op("elementwise_mul")(_elementwise(torch.mul))
register_op("elementwise_div")(_elementwise(torch.div))
