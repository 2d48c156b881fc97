"""The port's async dispatch window and input prefetch
(engine/pipeline.py) on the CPU, the cases of tests/test_pipeline.py that
the port carries (no mesh, checkpoint or resilience driver yet):

- ``dispatch_steps=8`` is bitwise equal to ``dispatch_steps=1`` (an MLP,
  and a tiny BERT with dropout 0.1); the flag sets the depth and an
  explicit depth 1 drains the window first;
- the ``DeferredFetch`` lifecycle: metadata without waiting, retire at
  overflow, a host read retiring everything before it, ``sync``;
  ``discard_window`` drops placeholders unread;
- ``check_nan_inf`` under a window defers its verdict and names the
  ORIGINAL step;
- the feeder: order and staging to tensors, a new producer each epoch,
  reader exceptions in order, early close unblocking the producer; its
  default device is the card, which raises without CUDA;
- the heartbeat's counters: enqueued ahead of retired in a window, both
  in the beat.

Everything is compared bitwise: the window changes when results are read,
never what is computed.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import flags
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.engine.pipeline import (DeferredFetch,
                                              PrefetchingFeeder,
                                              prefetch_to_device)
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.observability import health


@pytest.fixture(autouse=True)
def _pipeline_isolation():
    yield
    flags.reset_flag("dispatch_steps")
    flags.reset_flag("prefetch_depth")
    health.reset_steps()


def _build_mlp(lr=0.05):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=16, act="relu",
                            param_attr=fluid.ParamAttr(name="pw1"),
                            bias_attr=False)
        pred = fluid.layers.fc(input=h, size=4,
                               param_attr=fluid.ParamAttr(name="pw2"),
                               bias_attr=False)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits=pred, label=y))
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    init = {
        "pw1": np.linspace(-0.4, 0.4, 8 * 16).astype(
            np.float32).reshape(8, 16),
        "pw2": np.linspace(0.3, -0.3, 16 * 4).astype(
            np.float32).reshape(16, 4),
    }
    return main, startup, loss, init


def _mlp_batch(step, batch=16):
    W = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    rng = np.random.RandomState(1000 + step)
    xv = rng.randn(batch, 8).astype(np.float32)
    yv = np.argmax(xv @ W, 1).astype(np.int64).reshape(-1, 1)
    return {"x": xv, "y": yv}


def _start(main, startup, init):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        for k, v in init.items():
            scope.set(k, torch.from_numpy(v.copy()))
    return exe, scope


def _train_mlp(depth, n_steps=20):
    """A fresh executor and scope (the run counter restarts, so the
    steps replay identically); the loss bytes in step order."""
    main, startup, loss, init = _build_mlp()
    exe, scope = _start(main, startup, init)
    with fluid.scope_guard(scope):
        vals = [exe.run(main, feed=_mlp_batch(s), fetch_list=[loss],
                        dispatch_steps=depth)[0]
                for s in range(n_steps)]
        exe.sync()
        return [np.asarray(v).tobytes() for v in vals]


def _train_bert(depth, n_steps=6, batch=2, seq_len=16):
    """A tiny BERT with dropout 0.1: the window must not move the run
    counters that seed the masks."""
    with unique_name.guard():
        main, startup, h = bert.get_model(
            batch_size=batch, seq_len=seq_len, vocab_size=128, d_model=32,
            n_layers=2, n_heads=2, d_inner=64, max_position=64, dropout=0.1,
            lr=1e-3)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        vals = [exe.run(main, feed=bert.make_fake_batch(
                    batch, seq_len, 128, rng=np.random.RandomState(77 + s),
                    varlen=True),
                    fetch_list=[h["loss"]], dispatch_steps=depth)[0]
                for s in range(n_steps)]
        exe.sync()
        return [np.asarray(v).tobytes() for v in vals]


@pytest.mark.parametrize("model", ["mlp", "bert_dropout"])
def test_depth8_bit_exact_with_depth1(model):
    train = _train_mlp if model == "mlp" else _train_bert
    assert train(8) == train(1)


def test_flag_derived_depth_returns_placeholders():
    main, startup, loss, init = _build_mlp()
    exe, scope = _start(main, startup, init)
    flags.set_flags({"dispatch_steps": 4})
    with fluid.scope_guard(scope):
        out = exe.run(main, feed=_mlp_batch(0), fetch_list=[loss])[0]
        assert isinstance(out, DeferredFetch)
        sync_out = exe.run(main, feed=_mlp_batch(1), fetch_list=[loss],
                           dispatch_steps=1)[0]
        assert isinstance(sync_out, np.ndarray)
        # the explicit depth-1 run drained the window first
        assert out.resolved


def test_deferred_fetch_lifecycle():
    main, startup, loss, init = _build_mlp()
    exe, scope = _start(main, startup, init)
    depth, n = 4, 7
    with fluid.scope_guard(scope):
        phs = [exe.run(main, feed=_mlp_batch(s), fetch_list=[loss],
                       dispatch_steps=depth)[0] for s in range(n)]
        assert [p.resolved for p in phs] == [True] * (n - depth) \
            + [False] * depth
        assert phs[-1].shape == () and phs[-1].dtype == np.float32
        assert "in-flight" in repr(phs[-1]) and phs[-1].name == loss.name
        # a host read of the newest placeholder retires all before it
        v = float(phs[-1])
        assert np.isfinite(v)
        assert all(p.resolved for p in phs)
        assert "resolved" in repr(phs[-1])
        exe.sync()  # a no-op: the window is empty
    assert [np.asarray(p).tobytes() for p in phs] == _train_mlp(1, n)


def test_return_numpy_false_hands_out_tensors_and_discard_drops_them():
    main, startup, loss, init = _build_mlp()
    exe, scope = _start(main, startup, init)
    with fluid.scope_guard(scope):
        phs = [exe.run(main, feed=_mlp_batch(s), fetch_list=[loss],
                       return_numpy=False, dispatch_steps=3)[0]
               for s in range(4)]
        assert isinstance(phs[0].value(), torch.Tensor)
        # 4 pushes at depth 3: the first retired, 3 dropped unread
        assert exe.engine.discard_window() == 3
        with pytest.raises(RuntimeError, match="discarded"):
            phs[-1].value()
        assert phs[-1].discarded and "discarded" in repr(phs[-1])


def test_deferred_nan_verdict_names_original_step():
    main, startup, loss, init = _build_mlp()
    exe, scope = _start(main, startup, init)
    exe.engine.check_nan_inf = True
    depth, poison = 4, 3
    with fluid.scope_guard(scope):
        phs = []
        with pytest.raises(RuntimeError) as ei:
            for s in range(10):
                feed = _mlp_batch(s)
                if s == poison:
                    feed["x"] = np.full_like(feed["x"], np.nan)
                phs.append(exe.run(main, feed=feed, fetch_list=[loss],
                                   dispatch_steps=depth)[0])
            exe.sync()
        msg = str(ei.value)
        assert "check_nan_inf" in msg and "deferred" in msg
        assert "after step %d" % phs[poison].step in msg
        assert phs[poison].step < exe.engine._run_counter
        exe.engine.discard_window()


def _feed_source(n, fail_at=None):
    def reader():
        for i in range(n):
            if fail_at is not None and i == fail_at:
                raise ValueError("reader boom at %d" % i)
            yield {"x": np.full((2, 3), float(i), dtype=np.float32),
                   "meta": [i]}
    return reader


def test_prefetch_order_and_staging():
    with PrefetchingFeeder(_feed_source(7), depth=3, device="cpu") as f:
        items = list(f)
    assert len(items) == 7
    for i, item in enumerate(items):
        # arrays became tensors on the producer thread; lists pass
        # through for the engine's declared-dtype conversion
        assert isinstance(item["x"], torch.Tensor)
        assert float(item["x"][0, 0]) == float(i)
        assert item["meta"] == [i]


def test_prefetch_decorator_is_reusable_per_epoch():
    reader = prefetch_to_device(_feed_source(5), depth=2, device="cpu")
    for _ in range(2):  # each epoch gets a new producer thread
        assert [float(d["x"][0, 0]) for d in reader()] == \
            [0.0, 1.0, 2.0, 3.0, 4.0]


def test_prefetch_exception_propagates_in_order():
    got = []
    with pytest.raises(ValueError, match="reader boom at 3"):
        for item in PrefetchingFeeder(_feed_source(9, fail_at=3), depth=2,
                                      device="cpu"):
            got.append(float(item["x"][0, 0]))
    assert got == [0.0, 1.0, 2.0]


def test_prefetch_early_close_unblocks_producer():
    f = PrefetchingFeeder(_feed_source(500), depth=2, device="cpu")
    it = iter(f)
    next(it)
    t = f._thread
    assert t is not None and t.is_alive()
    f.close()
    t.join(timeout=5.0)
    assert not t.is_alive(), "producer thread leaked after close()"


def test_prefetched_training_is_bit_exact_with_the_plain_loop():
    main, startup, loss, init = _build_mlp()
    batches = [_mlp_batch(s) for s in range(6)]
    exe, scope = _start(main, startup, init)
    with fluid.scope_guard(scope):
        got = [exe.run(main, feed=f, fetch_list=[loss], dispatch_steps=2)[0]
               for f in prefetch_to_device(lambda: iter(batches), depth=2,
                                           device="cpu")()]
        exe.sync()
    assert [np.asarray(g).tobytes() for g in got] == _train_mlp(1, 6)


def test_feeder_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrefetchingFeeder(_feed_source(1))


def test_step_counter_split():
    health.reset_steps()
    for _ in range(3):
        health.note_step_enqueued()
    assert (health.enqueued_count(), health.step_count()) == (3, 0)
    for _ in range(2):
        health.note_step_retired()
    assert (health.enqueued_count(), health.step_count()) == (3, 2)
    health.note_step()  # the synchronous path bumps both
    assert (health.enqueued_count(), health.step_count()) == (4, 3)
    p = health.HeartbeatEmitter(interval_ms=60000.0).emit_now()
    # "step" is the RETIRED count: a full window over a wedged card
    # still reads as a stall
    assert p["step"] == 3 and p["enqueued"] == 4


def test_engine_books_enqueued_ahead_of_retired():
    main, startup, loss, init = _build_mlp()
    health.reset_steps()
    exe, scope = _start(main, startup, init)  # books 1 and 1
    with fluid.scope_guard(scope):
        for s in range(6):
            exe.run(main, feed=_mlp_batch(s), fetch_list=[loss],
                    dispatch_steps=3)
        assert health.enqueued_count() == 7
        # 6 pushes against depth 3: the first 3 retired by overflow
        assert health.step_count() == 4
        exe.sync()
    assert health.enqueued_count() == health.step_count() == 7
