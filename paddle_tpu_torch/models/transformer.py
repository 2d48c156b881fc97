"""Transformer for NMT — port of ``paddle_tpu/models/transformer.py``
(reference: benchmark/fluid/models/machine_translation.py and
tests/unittests/dist_transformer.py), copied with the imports switched to
the port. Encoder-decoder with multi-head attention, teacher-forced over
padded batches: padding as per-sequence lengths (``src_lens``,
``trg_lens``), the decoder's self-attention causal, its cross-attention
over the encoder's keys at ``src_lens``.

The attention core is one ``fused_attention`` op (the CUDA flash kernels
on the card): padding as per-sequence lengths, causality as a flag,
attention dropout inside the kernel. A dense additive ``mask``, or
``use_fused_attention=False`` without causality, emits the unfused
composition (matmul -> [+mask] -> softmax -> [dropout] -> matmul), the
lengths as the additive bias of ``layers.nn.attention_bias_from_lens``;
at ``opt_level`` 1, the default, the engine's fuse-attention pass
(``analysis/transforms.py``) rewrites it back to the fused op. The
sequence-parallel ring path is multi-GPU work (ROADMAP item 10) and
raises.
"""

import numpy as np

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.initializer import NumpyArrayInitializer
from paddle_tpu_torch.layers.nn import (
    attention_bias_from_lens as _attention_bias_from_lens,
    fused_attention as _fused_attention_layer,
)


def positional_encoding_table(max_len, d_model):
    pos = np.arange(max_len)[:, None].astype(np.float64)
    i = np.arange(d_model)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2 * (i // 2) / d_model)
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def multi_head_attention(q_in, k_in, v_in, d_model, n_heads, dropout_rate,
                         mask=None, seq_lens=None, causal=False,
                         is_train=True, name=None,
                         sequence_parallel=False, sp_axis="sp",
                         use_fused_attention=True):
    """Scaled dot-product attention with head split/merge
    (reference: dist_transformer.py multi_head_attention). With no dense
    ``mask``, and ``use_fused_attention`` or ``causal``, the core is one
    ``fused_attention`` op; otherwise the unfused composition, causal
    attention having no unfused form (transformer.py:86-103)."""
    if sequence_parallel:
        raise NotImplementedError(
            "sequence_parallel attention (ring attention) is ROADMAP "
            "item 10, multi-GPU")
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
    if mask is None and (use_fused_attention or causal):
        ctx = _fused_attention_layer(
            q, k, v, causal=causal, scale=d_head ** -0.5,
            seq_lens=seq_lens,
            dropout_rate=dropout_rate if is_train else 0.0)
    else:
        if mask is None and seq_lens is not None:
            mask = _attention_bias_from_lens(seq_lens, k.shape[2])
        scores = fluid.layers.matmul(q, k, transpose_y=True,
                                     alpha=d_head ** -0.5)
        if mask is not None:
            scores = fluid.layers.elementwise_add(scores, mask)
        weights = fluid.layers.softmax(scores)
        if dropout_rate > 0:
            weights = fluid.layers.dropout(
                weights, dropout_prob=dropout_rate, is_test=not is_train,
                dropout_implementation="upscale_in_train")
        ctx = fluid.layers.matmul(weights, v)  # [B,H,T,dh]
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


def encoder_layer(x, d_model, n_heads, d_inner, dropout, src_lens, is_train,
                  use_fused_attention=True):
    attn = multi_head_attention(x, x, x, d_model, n_heads, dropout,
                                seq_lens=src_lens, is_train=is_train,
                                use_fused_attention=use_fused_attention)
    x = pre_post_process(x, attn, dropout, is_train)
    f = ffn(x, d_model, d_inner, is_train)
    return pre_post_process(x, f, dropout, is_train)


def decoder_layer(x, enc_out, d_model, n_heads, d_inner, dropout,
                  trg_lens, src_lens, is_train, use_fused_attention=True):
    self_attn = multi_head_attention(x, x, x, d_model, n_heads, dropout,
                                     seq_lens=trg_lens, causal=True,
                                     is_train=is_train)
    x = pre_post_process(x, self_attn, dropout, is_train)
    cross = multi_head_attention(x, enc_out, enc_out, d_model, n_heads,
                                 dropout, seq_lens=src_lens,
                                 is_train=is_train,
                                 use_fused_attention=use_fused_attention)
    x = pre_post_process(x, cross, dropout, is_train)
    f = ffn(x, d_model, d_inner, is_train)
    return pre_post_process(x, f, dropout, is_train)


def embed(ids, vocab_size, d_model, max_len, pos_ids, scope_name):
    word = fluid.layers.embedding(
        input=ids, size=[vocab_size, d_model],
        param_attr=fluid.ParamAttr(name=scope_name + "_word_emb"))
    pos_table = positional_encoding_table(max_len, d_model)
    pos = fluid.layers.embedding(
        input=pos_ids, size=[max_len, d_model],
        param_attr=fluid.ParamAttr(
            name=scope_name + "_pos_emb",
            initializer=NumpyArrayInitializer(pos_table),
            trainable=False))
    scaled = fluid.layers.scale(word, scale=float(d_model ** 0.5))
    return fluid.layers.elementwise_add(scaled, pos)


def build_transformer(src_ids, src_pos, trg_ids, trg_pos, label,
                      src_lens, trg_lens,
                      vocab_size, d_model=256, n_heads=8, d_inner=1024,
                      n_layers=4, dropout=0.1, max_len=256, is_train=True,
                      label_smooth_eps=0.1, use_fused_attention=True):
    enc = embed(src_ids, vocab_size, d_model, max_len, src_pos, "src")
    for _ in range(n_layers):
        enc = encoder_layer(enc, d_model, n_heads, d_inner, dropout,
                            src_lens, is_train,
                            use_fused_attention=use_fused_attention)

    dec = embed(trg_ids, vocab_size, d_model, max_len, trg_pos, "trg")
    for _ in range(n_layers):
        dec = decoder_layer(dec, enc, d_model, n_heads, d_inner, dropout,
                            trg_lens, src_lens, is_train,
                            use_fused_attention=use_fused_attention)

    logits = fluid.layers.fc(input=dec, size=vocab_size, num_flatten_dims=2,
                             act=None)
    flat_logits = fluid.layers.reshape(logits, shape=[-1, vocab_size])
    flat_label = fluid.layers.reshape(label, shape=[-1, 1])
    if label_smooth_eps > 0 and is_train:
        soft = fluid.layers.label_smooth(
            fluid.layers.one_hot(flat_label, depth=vocab_size),
            epsilon=label_smooth_eps)
        loss = fluid.layers.softmax_with_cross_entropy(
            logits=flat_logits, label=soft, soft_label=True)
    else:
        loss = fluid.layers.softmax_with_cross_entropy(
            logits=flat_logits, label=flat_label)
    avg_loss = fluid.layers.mean(loss)
    return avg_loss, logits


def get_model(batch_size=8, seq_len=16, vocab_size=1000, d_model=64,
              n_heads=4, d_inner=128, n_layers=2, dropout=0.1, lr=1e-3,
              is_train=True, label_smooth_eps=0.1,
              use_fused_attention=True):
    """Feeds: src/trg token ids + position ids + per-sequence valid
    lengths (key-padding masks, TPU-first: no dense [B,H,T,T] mask
    tensors; the decoder's causal mask is structural)."""
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data(name="src", shape=[seq_len], dtype="int64")
        src_pos = fluid.layers.data(name="src_pos", shape=[seq_len],
                                    dtype="int64")
        trg = fluid.layers.data(name="trg", shape=[seq_len], dtype="int64")
        trg_pos = fluid.layers.data(name="trg_pos", shape=[seq_len],
                                    dtype="int64")
        label = fluid.layers.data(name="label", shape=[seq_len],
                                  dtype="int64")
        src_lens = fluid.layers.data(name="src_lens", shape=[1],
                                     dtype="int64")
        trg_lens = fluid.layers.data(name="trg_lens", shape=[1],
                                     dtype="int64")
        loss, logits = build_transformer(
            src, src_pos, trg, trg_pos, label, src_lens, trg_lens,
            vocab_size, d_model, n_heads, d_inner, n_layers,
            dropout, max_len=max(seq_len, 256), is_train=is_train,
            label_smooth_eps=label_smooth_eps,
            use_fused_attention=use_fused_attention)
        if is_train:
            fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    feeds = {"src": src, "src_pos": src_pos, "trg": trg, "trg_pos": trg_pos,
             "label": label, "src_lens": src_lens, "trg_lens": trg_lens}
    return main, startup, {"feeds": feeds, "loss": loss, "logits": logits}


def make_fake_batch(batch_size, seq_len, vocab_size, n_heads=None, rng=None,
                    varlen=False):
    """Synthetic copy-task batch: target = source shifted (learnable).
    ``varlen=True`` draws ragged lengths to exercise the padding masks."""
    rng = rng or np.random.RandomState(0)
    src = rng.randint(1, vocab_size, (batch_size, seq_len)).astype(np.int64)
    trg = np.concatenate(
        [np.ones((batch_size, 1), np.int64), src[:, :-1]], axis=1)
    label = src.copy()
    pos = np.tile(np.arange(seq_len, dtype=np.int64), (batch_size, 1))
    if varlen:
        lens = rng.randint(max(seq_len // 2, 1), seq_len + 1,
                           (batch_size, 1)).astype(np.int64)
    else:
        lens = np.full((batch_size, 1), seq_len, np.int64)
    return {
        "src": src, "src_pos": pos, "trg": trg, "trg_pos": pos,
        "label": label, "src_lens": lens, "trg_lens": lens.copy(),
    }
