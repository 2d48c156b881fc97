"""The port's engine on the CPU: its cache of compiled blocks, donated
state, the seed table, and ``check_nan_inf``.

On CUDA each cache entry captures one CUDA graph; here, on the CPU, the
same ``CompiledBlock`` runs its function over the same static buffers,
so everything but the capture itself is exercised:

- cache hit, miss and evict under ``executable_cache_size``; one entry
  per feed shape, ``amp``, ``is_test`` and ``cache_key_extra``;
- state updated in place (the scope keeps its tensor objects), a
  ``return_numpy=False`` fetch unchanged by the next run, a scope var
  replaced between runs read by the next;
- the seed table holds the values the ops drew on the host before the
  table existed, and the dropout hashes give the same bits for an int
  and a tensor seed; two runs from the same state at the same run
  counter are bitwise equal at dropout 0.1;
- which blocks can be captured, read from the desc;
- the launch counters record, and do not count, what a capture launches;
- a CUDA engine selects cuDNN's deterministic algorithms, a CPU engine
  leaves torch's switches as they are;
- ``check_nan_inf`` raises with the JAX package's message.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import flags as j_flags
from paddle_tpu import unique_name as j_unique_name

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import convert, flags, unique_name
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.contrib import mixed_precision
from paddle_tpu_torch.core.registry import stream_seed
from paddle_tpu_torch.engine.lowering import BlockProgram
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops.common import hash_keep_mask

CFG = dict(batch_size=2, seq_len=16, vocab_size=50, d_model=32, n_layers=2,
           n_heads=2, d_inner=64, max_position=32)


@pytest.fixture
def metrics():
    obs.set_enabled(True)
    obs.reset()
    yield obs
    obs.reset()
    obs.set_enabled(None)


def _sgd_model(fluid_, unique_name_, size=2):
    main, startup = fluid_.Program(), fluid_.Program()
    with unique_name_.guard(), fluid_.program_guard(main, startup):
        x = fluid_.layers.data(name="x", shape=[3], dtype="float32")
        loss = fluid_.layers.mean(fluid_.layers.fc(input=x, size=size))
        fluid_.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _started(program_fn=_sgd_model):
    """A started model and a fresh executor (whose cache holds nothing of
    the startup run)."""
    main, startup, loss = program_fn(fluid, unique_name)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    return fluid.Executor(fluid.CPUPlace()), scope, main, loss


def _counters():
    c = obs.snapshot()["counters"]
    return {k: c.get("engine." + k, 0)
            for k in ("cache_hit", "cache_miss", "cache_evict")}


def test_cache_hit_miss_and_evict(metrics):
    exe, scope, main, loss = _started()
    flags.set_flags({"executable_cache_size": 2})
    try:
        with fluid.scope_guard(scope):
            base = _counters()
            for rows in (1, 2, 1, 3, 1):
                exe.run(main, feed={"x": np.ones((rows, 3), np.float32)},
                        fetch_list=[loss])
    finally:
        flags.reset_flag("executable_cache_size")
    got = {k: v - base[k] for k, v in _counters().items()}
    # 1 miss, 2 miss, 1 hit, 3 miss (evicts 2), 1 hit
    assert got == {"cache_hit": 2, "cache_miss": 3, "cache_evict": 1}
    assert len(exe.engine._cache) == 2
    exe.close()
    assert not exe.engine._cache and not exe.engine._blocks


@pytest.mark.parametrize("change", ["feed_shape", "amp", "is_test",
                                    "cache_key_extra"])
def test_keys_differ(change):
    exe, scope, main, loss = _started()
    engine = exe.engine
    feed = {"x": np.ones((2, 3), np.float32)}
    kw = dict(fetch_list=[loss.name], state_writeback=False)
    engine.run_block(main.desc, 0, scope, feed=feed, **kw)
    assert len(engine._cache) == 1
    other = dict(kw)
    other_feed = feed
    if change == "feed_shape":
        other_feed = {"x": np.ones((4, 3), np.float32)}
    elif change == "amp":
        other["amp"] = True
    elif change == "is_test":
        other["is_test"] = True
    else:
        other["cache_key_extra"] = ("serving", "s", 2)
    engine.run_block(main.desc, 0, scope, feed=other_feed, **other)
    assert len(engine._cache) == 2
    engine.run_block(main.desc, 0, scope, feed=other_feed, **other)
    engine.run_block(main.desc, 0, scope, feed=feed, **kw)
    assert len(engine._cache) == 2  # both hit from now on
    # every key shares the block's one analysis (same feeds and fetches)
    assert len(engine._blocks) == 1


def test_state_updated_in_place():
    exe, scope, main, loss = _started()
    params = [p.name for p in main.all_parameters()]
    objs = {n: scope.get(n) for n in params}
    before = {n: t.clone() for n, t in objs.items()}
    feed = {"x": np.ones((4, 3), np.float32)}
    with fluid.scope_guard(scope):
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss])
    for n in params:
        assert scope.get(n) is objs[n], n  # the same tensor ...
        assert not torch.equal(objs[n], before[n]), n  # ... with new values


def test_fetch_without_numpy_unchanged_by_next_run():
    exe, scope, main, loss = _started()
    w = main.all_parameters()[0].name
    feed = {"x": np.ones((4, 3), np.float32)}
    with fluid.scope_guard(scope):
        first = exe.run(main, feed=feed, fetch_list=[loss, w],
                        return_numpy=False)
        kept = [t.clone() for t in first]
        exe.run(main, feed={"x": np.full((4, 3), 2.0, np.float32)},
                fetch_list=[loss, w], return_numpy=False)
    for t, k in zip(first, kept):
        assert torch.equal(t, k)
    # the fetched parameter is a copy, not the scope's tensor
    assert first[1] is not scope.get(w)


def test_replaced_scope_var_rebinds():
    exe, scope, main, loss = _started()
    w, b = sorted(p.name for p in main.all_parameters())[::-1]
    feed = {"x": np.ones((4, 3), np.float32)}
    with fluid.scope_guard(scope):
        exe.run(main, feed=feed, fetch_list=[loss])
        exe.run(main, feed=feed, fetch_list=[loss])
        new = torch.zeros_like(scope.get(w))
        scope.set(w, new)
        bias = scope.get(b).clone()
        (out,) = exe.run(main, feed=feed, fetch_list=[loss])
    # the run read the zero weight: the loss is the bias's mean alone ...
    np.testing.assert_allclose(out.reshape(()), bias.mean().item(),
                               rtol=1e-6)
    # ... and updated the replacing tensor in place
    assert scope.get(w) is new and not torch.equal(new, torch.zeros_like(new))


def _draw_seed_before(seed, run_counter, rng_id, high):
    """The op's dropout seed as ``_draw_seed`` (ops/nn_ops.py) drew it on
    the host before the seed table: a CPU generator seeded with the op's
    stream, one ``randint``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(stream_seed(seed, run_counter, rng_id))
    return int(torch.randint(0, high, (), generator=gen))


def _bert(dropout=0.1, is_train=True):
    with unique_name.guard():
        return bert.get_model(dropout=dropout, is_train=is_train, **CFG)


def test_seed_table_equals_the_host_draws():
    main, _, handles = _bert()
    block = main.desc.global_block()
    feeds = ["mask_label", "mask_weight", "ns_label", "pos_ids", "sent_ids",
             "seq_lens", "src_ids"]
    bp = BlockProgram(block, feeds, [handles["loss"].name])
    kinds = {}
    for op in bp.ops:
        if op.type in ("dropout", "fused_attention", "fused_attention_grad",
                       "dropout_grad"):
            kinds.setdefault(int(op.attrs["__rng_id__"]), set()).add(op.type)
    # one slot per stream: a grad op shares its forward's
    assert sorted(rid for rid, _ in bp.rng_slots) == sorted(kinds)
    assert any("fused_attention_grad" in k for k in kinds.values())
    assert any("dropout_grad" in k for k in kinds.values())
    for seed, run_counter in ((0, 1), (2024, 7)):
        want = [_draw_seed_before(seed, run_counter, rid,
                                  2 ** 31 - 1 if "fused_attention" in
                                  kinds[rid] else 2 ** 32)
                for rid, _ in bp.rng_slots]
        assert bp.seed_values(seed, run_counter) == want


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 2, 2 ** 32 - 1])
def test_hashes_same_for_int_and_tensor_seed(seed):
    t = torch.tensor(seed, dtype=torch.int64)
    assert torch.equal(hash_keep_mask(seed, (3, 50), 0.1, "cpu"),
                       hash_keep_mask(t, (3, 50), 0.1, "cpu"))
    bh = torch.arange(6).reshape(6, 1, 1)
    qp = torch.arange(9).reshape(1, 9, 1)
    kp = torch.arange(11).reshape(1, 1, 11)
    assert torch.equal(fa.keep_mask(seed, bh, qp, kp, 11, 0.3),
                       fa.keep_mask(t, bh, qp, kp, 11, 0.3))
    gen = torch.Generator().manual_seed(3)
    q, k, v, g = (torch.randn(2, 3, 9, 8, generator=gen) for _ in range(4))
    lens = torch.tensor([9, 4])
    a = fa.attention_lse_plain(q, k, v, lens, None, seed, True, None, 0.2)
    b = fa.attention_lse_plain(q, k, v, lens, None, t, True, None, 0.2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    out, lse = a
    a = fa.attention_bwd_plain(q, k, v, out, lse, g, None, lens, None, seed,
                               True, None, 0.2)
    b = fa.attention_bwd_plain(q, k, v, out, lse, g, None, lens, None, t,
                               True, None, 0.2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_two_runs_from_one_state_are_bitwise_equal():
    """Dropout 0.1 in the attention and the generic dropout: two fresh
    executors from the same state run at the same run counter and draw
    the same masks, so every fetched grad and the loss agree bit for
    bit; a second step on one executor draws other masks."""
    main, startup, handles = _bert()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    state = {v.name: scope.get(v.name).numpy().copy()
             for v in main.list_vars() if v.persistable}
    feed = bert.make_fake_batch(2, CFG["seq_len"], CFG["vocab_size"],
                                rng=np.random.RandomState(3), varlen=True)
    fetch = [handles["loss"].name, "word_embedding@GRAD", "fc_0.w_0_0@GRAD"]
    runs = []
    for _ in range(2):
        s = fluid.Scope()
        convert.load_numpy_state(s, state, "cpu", program=main)
        e = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(s):
            runs.append(e.run(main, feed=feed, fetch_list=fetch)
                        + [e.run(main, feed=feed, fetch_list=fetch)[0]])
    a, b = runs
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[0] != a[3]  # the next step differs (new masks, new weights)


def test_capturable_read_from_the_desc():
    main, startup, handles = _bert()
    infer = main.clone(for_test=True)
    feeds = ["mask_label", "mask_weight", "ns_label", "pos_ids", "sent_ids",
             "seq_lens", "src_ids"]
    train = BlockProgram(main.desc.global_block(), feeds,
                         [handles["loss"].name])
    serve = BlockProgram(infer.desc.global_block(), feeds[3:],
                         [handles["enc_out"].name])
    init = BlockProgram(startup.desc.global_block(), [], [])
    assert train.capturable and serve.capturable
    assert not init.capturable and "uniform_random" in init.uncapturable_ops
    # the test clone's dropout ops draw nothing; its attention's rate is
    # turned off by the run's is_test, whose entries hold no seed table
    assert serve.rng_slots and all(high == 2 ** 31 - 1
                                   for _, high in serve.rng_slots)


def test_launches_recorded_not_counted_while_capturing():
    before = {c: getattr(fa, c) for c in fa.COUNTERS}
    with fa.record_launches() as rec:
        fa._count("launches")
        fa._count("launches_dq")
    assert {c: getattr(fa, c) for c in fa.COUNTERS} == before
    assert rec == {"launches": 1, "launches_dq": 1, "launches_dkv": 0}
    fa.add_launches(rec)
    fa.add_launches(rec)
    try:
        assert fa.launches == before["launches"] + 2
        assert fa.launches_dq == before["launches_dq"] + 2
        assert fa.launches_dkv == before["launches_dkv"]
        fa._count("launches_dkv")
        assert fa.launches_dkv == before["launches_dkv"] + 1
    finally:
        for c, n in before.items():
            setattr(fa, c, n)


@pytest.mark.parametrize("place", ["cpu", "cuda"])
def test_cuda_engine_selects_deterministic_cudnn(place, monkeypatch):
    """A CUDA engine turns cuDNN's deterministic algorithms on and its
    autotuner off (two identical ResNet-50 steps differ in 153 grads
    with the default algorithms on an H100, chip_smoke.py
    ``resnet50_determinism``). Constructing an engine touches no device,
    so the CUDA one is built here with CUDA reported present."""
    from paddle_tpu_torch.engine.executor import Engine

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    if place == "cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        Engine(fluid.CUDAPlace(0))
    else:
        Engine(fluid.CPUPlace())
    assert torch.backends.cudnn.deterministic == (place == "cuda")
    assert torch.backends.cudnn.benchmark == (place == "cpu")


def test_amp_program_runs_bf16_and_keeps_float32_state():
    main, startup, handles = _bert(dropout=0.0)
    mixed_precision.enable_bf16(main)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    feed = bert.make_fake_batch(2, CFG["seq_len"], CFG["vocab_size"],
                                rng=np.random.RandomState(4), varlen=True)
    with fluid.scope_guard(scope):
        exe.run(startup)
        out = exe.run(main, feed=feed,
                      fetch_list=[handles["loss"], "fc_0.tmp_0"],
                      return_numpy=False)
    assert out[0].dtype == torch.float32 and out[1].dtype == torch.bfloat16
    assert all(scope.get(p.name).dtype == torch.float32
               for p in main.all_parameters())


def _nan_message(fluid_, unique_name_, flags_, kind, **run_kw):
    """Run a program that makes a NaN under check_nan_inf and return the
    raised message: ``kind`` "fetch" divides a feed by itself; "state"
    takes an SGD step on a NaN feed, so the weights become NaN."""
    main, startup = fluid_.Program(), fluid_.Program()
    with unique_name_.guard(), fluid_.program_guard(main, startup):
        x = fluid_.layers.data(name="x", shape=[2], dtype="float32")
        if kind == "fetch":
            out = fluid_.layers.elementwise_div(x, x)
        else:
            out = fluid_.layers.mean(fluid_.layers.fc(input=x, size=2))
            fluid_.optimizer.SGD(learning_rate=0.1).minimize(out)
    feed = {"x": np.array([[0.0, 1.0]], np.float32)}
    if kind == "state":
        feed = {"x": np.array([[np.nan, 1.0]], np.float32)}
    flags_.set_flags({"check_nan_inf": True})
    try:
        exe = fluid_.Executor(fluid_.CPUPlace())
        with fluid_.scope_guard(fluid_.Scope()):
            exe.run(startup)
            with pytest.raises(RuntimeError) as err:
                exe.run(main, feed=feed, fetch_list=[out], **run_kw)
    finally:
        flags_.reset_flag("check_nan_inf")
    return str(err.value)


@pytest.mark.parametrize("kind", ["fetch", "state"])
def test_check_nan_inf_message_matches_jax(kind, metrics):
    want = _nan_message(jfluid, j_unique_name, j_flags, kind, opt_level=0)
    got = _nan_message(fluid, unique_name, flags, kind)
    assert got == want
    assert got.startswith("check_nan_inf: %s " % kind)
    assert obs.snapshot()["counters"]["engine.nan_inf_trips"] == 1
