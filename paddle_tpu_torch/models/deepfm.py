"""DeepFM CTR model — port of ``paddle_tpu/models/deepfm.py`` (reference:
the dist-training CTR configs, tests/unittests/dist_ctr.py), imports
switched. Sparse feature ids feed ``is_sparse=True`` embeddings, an FM
second-order term and a DNN tower; the tables' grads are SelectedRows
and Adam updates only the batch's rows. ``is_distributed=True`` marks
both tables for the parameter-server path: ``fluid.DistributeTranspiler``
row-shards them over the pservers (``distributed/ps.py``), and the
trainers prefetch the batch's rows instead of holding the tables."""

import numpy as np

import paddle_tpu_torch.fluid as fluid


def deepfm(feat_ids, label, num_features, num_fields, embed_dim=8,
           dnn_hidden=(64, 32), is_train=True, is_distributed=False):
    """feat_ids: [B, num_fields] int64 global feature ids."""
    # first-order weights: embedding with dim 1
    w1 = fluid.layers.embedding(
        input=feat_ids, size=[num_features, 1], is_sparse=True,
        is_distributed=is_distributed,
        param_attr=fluid.ParamAttr(name="fm_w1"))
    first_order = fluid.layers.reduce_sum(
        fluid.layers.reshape(w1, shape=[-1, num_fields]), dim=1,
        keep_dim=True)

    # second-order: 0.5 * ((sum_i v_i)^2 - sum_i v_i^2)
    emb = fluid.layers.embedding(
        input=feat_ids, size=[num_features, embed_dim], is_sparse=True,
        is_distributed=is_distributed,
        param_attr=fluid.ParamAttr(name="fm_v"))  # [B, F, K]
    sum_v = fluid.layers.reduce_sum(emb, dim=1)              # [B, K]
    sum_v_sq = fluid.layers.elementwise_mul(sum_v, sum_v)
    v_sq = fluid.layers.elementwise_mul(emb, emb)
    sq_sum = fluid.layers.reduce_sum(v_sq, dim=1)
    second_order = fluid.layers.scale(
        fluid.layers.reduce_sum(
            fluid.layers.elementwise_sub(sum_v_sq, sq_sum), dim=1,
            keep_dim=True),
        scale=0.5)

    # DNN tower on flattened embeddings
    dnn = fluid.layers.reshape(emb, shape=[-1, num_fields * embed_dim])
    for size in dnn_hidden:
        dnn = fluid.layers.fc(input=dnn, size=size, act="relu")
    dnn_out = fluid.layers.fc(input=dnn, size=1, act=None)

    logit = fluid.layers.elementwise_add(
        fluid.layers.elementwise_add(first_order, second_order), dnn_out)
    loss = fluid.layers.mean(
        fluid.layers.sigmoid_cross_entropy_with_logits(
            x=logit, label=fluid.layers.cast(label, "float32")))
    pred = fluid.layers.sigmoid(logit)
    return loss, pred, logit


def get_model(batch_size=32, num_features=10000, num_fields=10, embed_dim=8,
              lr=0.01, is_train=True, is_distributed=False):
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        feat = fluid.layers.data(name="feat_ids", shape=[num_fields],
                                 dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, pred, logit = deepfm(feat, label, num_features, num_fields,
                                   embed_dim, is_train=is_train,
                                   is_distributed=is_distributed)
        if is_train:
            fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, {"feat_ids": feat, "label": label, "loss": loss,
                           "pred": pred}


def make_fake_batch(batch_size, num_features, num_fields, rng=None):
    rng = rng or np.random.RandomState(0)
    # field f draws from its own slice of the global id space
    per = num_features // num_fields
    ids = np.stack([
        rng.randint(f * per, (f + 1) * per, batch_size)
        for f in range(num_fields)
    ], axis=1).astype(np.int64)
    # clickiness depends on a hidden linear rule so the model can learn
    w = np.sin(np.arange(num_features) * 0.1)
    score = w[ids].sum(axis=1)
    label = (score > np.median(score)).astype(np.int64).reshape(-1, 1)
    return {"feat_ids": ids, "label": label}
