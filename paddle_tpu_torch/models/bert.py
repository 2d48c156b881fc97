"""BERT encoder with masked-LM + next-sentence heads — port of
``paddle_tpu/models/bert.py``, copied with the imports switched to the
port. ``get_model(is_train=False)`` builds the inference program the
predictor serves; ``get_model(is_train=True)`` the pre-training program,
with ``append_backward`` and ``Adam.minimize``, which ``Executor.run``
trains step by step."""

import numpy as np

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models.transformer import (
    multi_head_attention, ffn, pre_post_process,
)


def bert_encoder(src_ids, pos_ids, sent_ids, seq_lens, vocab_size,
                 max_position=512, type_vocab_size=2, d_model=768,
                 n_layers=12, n_heads=12, d_inner=3072, dropout=0.1,
                 is_train=True, use_fused_attention=True):
    word = fluid.layers.embedding(
        input=src_ids, size=[vocab_size, d_model],
        param_attr=fluid.ParamAttr(name="word_embedding"))
    pos = fluid.layers.embedding(
        input=pos_ids, size=[max_position, d_model],
        param_attr=fluid.ParamAttr(name="pos_embedding"))
    sent = fluid.layers.embedding(
        input=sent_ids, size=[type_vocab_size, d_model],
        param_attr=fluid.ParamAttr(name="sent_embedding"))
    emb = fluid.layers.elementwise_add(
        fluid.layers.elementwise_add(word, pos), sent)
    emb = fluid.layers.layer_norm(emb, begin_norm_axis=2)
    if dropout > 0:
        emb = fluid.layers.dropout(
            emb, dropout_prob=dropout, is_test=not is_train,
            dropout_implementation="upscale_in_train")

    h = emb
    for _ in range(n_layers):
        attn = multi_head_attention(
            h, h, h, d_model, n_heads, dropout, seq_lens=seq_lens,
            is_train=is_train, use_fused_attention=use_fused_attention)
        h = pre_post_process(h, attn, dropout, is_train)
        f = ffn(h, d_model, d_inner, is_train, act="gelu")
        h = pre_post_process(h, f, dropout, is_train)
    return h


def pretrain_heads(enc_out, mask_label, mask_weight, ns_label, vocab_size,
                   d_model, is_train=True):
    """Masked-LM over the full sequence (weighted by the mask) + NSP on
    position 0 — the padding/ragged-free formulation XLA wants."""
    # MLM
    mlm_h = fluid.layers.fc(input=enc_out, size=d_model, num_flatten_dims=2,
                            act="gelu")
    mlm_h = fluid.layers.layer_norm(mlm_h, begin_norm_axis=2)
    mlm_logits = fluid.layers.fc(input=mlm_h, size=vocab_size,
                                 num_flatten_dims=2)
    flat_logits = fluid.layers.reshape(mlm_logits, shape=[-1, vocab_size])
    flat_label = fluid.layers.reshape(mask_label, shape=[-1, 1])
    mlm_loss = fluid.layers.softmax_with_cross_entropy(
        logits=flat_logits, label=flat_label)
    flat_w = fluid.layers.reshape(mask_weight, shape=[-1, 1])
    weighted = fluid.layers.elementwise_mul(mlm_loss, flat_w)
    denom = fluid.layers.elementwise_add(
        fluid.layers.reduce_sum(flat_w),
        fluid.layers.fill_constant(shape=[1], dtype="float32", value=1e-6))
    mlm_mean = fluid.layers.elementwise_div(
        fluid.layers.reduce_sum(weighted), denom)

    # NSP from the [CLS] position
    first = fluid.layers.slice(enc_out, axes=[1], starts=[0], ends=[1])
    pooled = fluid.layers.fc(
        input=fluid.layers.reshape(first, shape=[-1, enc_out.shape[2]]),
        size=enc_out.shape[2], act="tanh")
    ns_logits = fluid.layers.fc(input=pooled, size=2)
    ns_loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
        logits=ns_logits, label=ns_label))

    total = fluid.layers.elementwise_add(mlm_mean, ns_loss)
    return total, mlm_mean, ns_loss


def get_model(batch_size=8, seq_len=128, vocab_size=30522, d_model=768,
              n_layers=12, n_heads=12, d_inner=3072, dropout=0.1, lr=1e-4,
              is_train=True, max_position=512, use_fused_attention=True):
    """BERT pre-training program. ``bert_base`` defaults; shrink the dims for
    tests."""
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data(name="src_ids", shape=[seq_len],
                                dtype="int64")
        pos = fluid.layers.data(name="pos_ids", shape=[seq_len],
                                dtype="int64")
        sent = fluid.layers.data(name="sent_ids", shape=[seq_len],
                                 dtype="int64")
        seq_lens = fluid.layers.data(name="seq_lens", shape=[1],
                                     dtype="int64")
        mask_label = fluid.layers.data(name="mask_label", shape=[seq_len],
                                       dtype="int64")
        mask_weight = fluid.layers.data(name="mask_weight", shape=[seq_len],
                                        dtype="float32")
        ns_label = fluid.layers.data(name="ns_label", shape=[1],
                                     dtype="int64")
        enc = bert_encoder(src, pos, sent, seq_lens, vocab_size,
                           max_position=max_position, d_model=d_model,
                           n_layers=n_layers, n_heads=n_heads,
                           d_inner=d_inner, dropout=dropout,
                           is_train=is_train,
                           use_fused_attention=use_fused_attention)
        loss, mlm_loss, ns_loss = pretrain_heads(
            enc, mask_label, mask_weight, ns_label, vocab_size, d_model,
            is_train=is_train)
        if is_train:
            fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    feeds = {"src_ids": src, "pos_ids": pos, "sent_ids": sent,
             "seq_lens": seq_lens, "mask_label": mask_label,
             "mask_weight": mask_weight, "ns_label": ns_label}
    return main, startup, {"feeds": feeds, "loss": loss,
                           "mlm_loss": mlm_loss, "ns_loss": ns_loss,
                           "enc_out": enc}


def make_fake_batch(batch_size, seq_len, vocab_size, n_heads=None,
                    mask_frac=0.15, rng=None, varlen=False):
    """``varlen=True`` draws ragged lengths to exercise the key-padding
    masks (otherwise full-length, the bench configuration)."""
    rng = rng or np.random.RandomState(0)
    src = rng.randint(0, vocab_size, (batch_size, seq_len)).astype(np.int64)
    pos = np.tile(np.arange(seq_len, dtype=np.int64), (batch_size, 1))
    sent = np.zeros((batch_size, seq_len), np.int64)
    if varlen:
        lens = rng.randint(max(seq_len // 2, 1), seq_len + 1,
                           (batch_size, 1)).astype(np.int64)
    else:
        lens = np.full((batch_size, 1), seq_len, np.int64)
    mask_label = src.copy()
    mask_weight = (rng.rand(batch_size, seq_len) < mask_frac).astype(
        np.float32)
    ns_label = rng.randint(0, 2, (batch_size, 1)).astype(np.int64)
    return {"src_ids": src, "pos_ids": pos, "sent_ids": sent,
            "seq_lens": lens, "mask_label": mask_label,
            "mask_weight": mask_weight, "ns_label": ns_label}
