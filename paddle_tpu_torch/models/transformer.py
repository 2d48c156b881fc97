"""Transformer building blocks — port of ``paddle_tpu/models/transformer.py``
for ``multi_head_attention`` (:35), ``ffn`` (:110) and
``pre_post_process`` (:115), copied with the imports switched to the
port. The attention core is one ``fused_attention`` op (the CUDA flash
kernel on the card): padding as per-sequence lengths, causality as a
flag, attention dropout inside the kernel. The unfused composition (a
dense additive ``mask``, or ``use_fused_attention=False``) and the
sequence-parallel ring path need ops a later slice ports, and raise.
"""

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.layers.nn import fused_attention as _fused_attention_layer


def multi_head_attention(q_in, k_in, v_in, d_model, n_heads, dropout_rate,
                         mask=None, seq_lens=None, causal=False,
                         is_train=True, name=None,
                         sequence_parallel=False, sp_axis="sp",
                         use_fused_attention=True):
    """Scaled dot-product attention with head split/merge
    (reference: dist_transformer.py multi_head_attention)."""
    if sequence_parallel:
        raise NotImplementedError(
            "sequence_parallel attention (ring attention) is ROADMAP "
            "Queue 1, multi-GPU")
    if mask is not None or not (use_fused_attention or causal):
        raise NotImplementedError(
            "the unfused attention composition (matmul, softmax) is ROADMAP "
            "Queue 1, the remaining op families; use the fused op")
    d_head = d_model // n_heads
    q = fluid.layers.fc(input=q_in, size=d_model, num_flatten_dims=2,
                        bias_attr=False)
    k = fluid.layers.fc(input=k_in, size=d_model, num_flatten_dims=2,
                        bias_attr=False)
    v = fluid.layers.fc(input=v_in, size=d_model, num_flatten_dims=2,
                        bias_attr=False)

    def split_heads(x):
        x = fluid.layers.reshape(x, shape=[0, 0, n_heads, d_head])
        return fluid.layers.transpose(x, perm=[0, 2, 1, 3])  # [B,H,T,dh]

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    ctx = _fused_attention_layer(
        q, k, v, causal=causal, scale=d_head ** -0.5,
        seq_lens=seq_lens,
        dropout_rate=dropout_rate if is_train else 0.0)
    ctx = fluid.layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = fluid.layers.reshape(ctx, shape=[0, 0, d_model])
    return fluid.layers.fc(input=ctx, size=d_model, num_flatten_dims=2,
                           bias_attr=False)


def ffn(x, d_model, d_inner, is_train=True, act="relu"):
    h = fluid.layers.fc(input=x, size=d_inner, num_flatten_dims=2, act=act)
    return fluid.layers.fc(input=h, size=d_model, num_flatten_dims=2)


def pre_post_process(prev, out, dropout_rate, is_train):
    """residual + dropout + layer_norm (post-process 'dan')."""
    if dropout_rate > 0:
        out = fluid.layers.dropout(
            out, dropout_prob=dropout_rate, is_test=not is_train,
            dropout_implementation="upscale_in_train")
    if prev is not None:
        out = fluid.layers.elementwise_add(out, prev)
    return fluid.layers.layer_norm(out, begin_norm_axis=2)
