"""Stacked LSTM sentiment classifier (reference:
benchmark/fluid/models/stacked_dynamic_lstm.py). The reference time-steps
via dynamic LoD LSTM ops; here, as in the JAX package's builder, the
recurrence is a StaticRNN (one ``recurrent`` op, a loop over the time
steps) over padded, time-major sequences."""

import paddle_tpu_torch.fluid as fluid


def lstm_layer(x_tbd, hidden_size, is_train=True):
    """One LSTM layer over a time-major [T, B, D] tensor via StaticRNN."""
    h0 = fluid.layers.fill_constant_batch_size_like(
        input=x_tbd, shape=[-1, hidden_size], dtype="float32", value=0.0,
        input_dim_idx=1, output_dim_idx=0)
    c0 = fluid.layers.fill_constant_batch_size_like(
        input=x_tbd, shape=[-1, hidden_size], dtype="float32", value=0.0,
        input_dim_idx=1, output_dim_idx=0)
    rnn = fluid.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x_tbd)
        h_prev = rnn.memory(init=h0)
        c_prev = rnn.memory(init=c0)
        gates = fluid.layers.fc(input=xt, size=4 * hidden_size,
                                bias_attr=True)
        gates = fluid.layers.elementwise_add(
            gates, fluid.layers.fc(input=h_prev, size=4 * hidden_size,
                                   bias_attr=False))
        i, f, g, o = fluid.layers.split(gates, num_or_sections=4, dim=1)
        i = fluid.layers.sigmoid(i)
        f = fluid.layers.sigmoid(f)
        g = fluid.layers.tanh(g)
        o = fluid.layers.sigmoid(o)
        c = fluid.layers.elementwise_add(
            fluid.layers.elementwise_mul(f, c_prev),
            fluid.layers.elementwise_mul(i, g))
        h = fluid.layers.elementwise_mul(o, fluid.layers.tanh(c))
        rnn.update_memory(h_prev, h)
        rnn.update_memory(c_prev, c)
        rnn.step_output(h)
    return rnn()


def stacked_lstm_net(seq_ids, label, dict_dim, emb_dim=64, hidden_dim=64,
                     stacked_num=2, class_num=2, is_train=True):
    """seq_ids: [B, T] int64 token ids (padded)."""
    emb = fluid.layers.embedding(input=seq_ids, size=[dict_dim, emb_dim])
    # [B, T, D] -> time-major [T, B, D]
    x = fluid.layers.transpose(emb, perm=[1, 0, 2])
    h = x
    for _ in range(stacked_num):
        h = lstm_layer(h, hidden_dim, is_train=is_train)
    # last-step hidden state: [T, B, H] -> [B, H]
    T = h.shape[0]
    last = fluid.layers.slice(h, axes=[0], starts=[T - 1], ends=[T])
    last = fluid.layers.reshape(last, shape=[-1, hidden_dim])
    logits = fluid.layers.fc(input=last, size=class_num, act=None)
    loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
        logits=logits, label=label))
    acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                label=label)
    return loss, acc, logits


def get_model(batch_size=16, seq_len=32, dict_dim=5000, emb_dim=64,
              hidden_dim=64, stacked_num=2, lr=0.01, is_train=True):
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        seq = fluid.layers.data(name="seq", shape=[seq_len], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc, logits = stacked_lstm_net(
            seq, label, dict_dim, emb_dim, hidden_dim, stacked_num,
            is_train=is_train)
        if is_train:
            fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, {"seq": seq, "label": label, "loss": loss,
                           "acc": acc, "logits": logits}
