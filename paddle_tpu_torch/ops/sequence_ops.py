"""Sequence ops — port of ``paddle_tpu/ops/sequence_ops.py`` for
``sequence_pool`` (:21), which ``layers.lstm`` takes the last step with
(``sequence_last_step``), and ``sequence_mask`` (:70), the first op of
the key-padding mask ``layers.attention_bias_from_lens`` builds.

The reference's LoDTensor batches become padded [B, T, ...] tensors with
a [B] ``Length``, as in the JAX package: each pooling masks the padding.
"""

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import single


def _mask(lengths, max_len, dtype):
    steps = torch.arange(max_len, device=lengths.device)
    return (steps[None, :] < lengths.reshape(-1, 1)).to(dtype)


@register_op("sequence_pool", no_grad_inputs=("Length",))
def sequence_pool(ctx, ins, attrs):
    x = single(ins, "X")              # [B, T, D] padded
    lengths = single(ins, "Length")   # [B]; absent: every row full
    if lengths is None:
        lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                             device=x.device)
    pooltype = attrs.get("pooltype", "SUM").upper()
    mask = _mask(lengths, x.shape[1], x.dtype)[..., None]
    if pooltype == "SUM":
        out = (x * mask).sum(1)
    elif pooltype in ("AVERAGE", "SQRT"):
        denom = lengths.reshape(-1, 1).to(x.dtype).clamp_min(1.0)
        if pooltype == "SQRT":
            denom = denom.sqrt()
        out = (x * mask).sum(1) / denom
    elif pooltype == "MAX":
        out = torch.where(mask > 0, x, torch.full_like(x, -1e38)).amax(1)
    elif pooltype == "LAST":
        idx = (lengths - 1).clamp_min(0).to(torch.int64)
        idx = idx.reshape(-1, 1, 1).expand(-1, 1, x.shape[2])
        out = torch.gather(x, 1, idx)[:, 0]
    elif pooltype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError(pooltype)
    return {"Out": [out]}


@register_op("sequence_mask", grad=None)
def sequence_mask(ctx, ins, attrs):
    """[B, maxlen] float32 of 1 where the step is below the row's length
    (the reference's ``_mask`` dtype), from lengths of any shape read as
    [B]; ``maxlen`` must be static, as in the reference."""
    x = single(ins, "X")
    maxlen = attrs.get("maxlen", -1)
    if maxlen < 0:
        raise ValueError("sequence_mask needs a static maxlen")
    return {"Y": [_mask(x, maxlen, torch.float32)]}
