"""Overload protection & graceful degradation in the port
(paddle_tpu_torch/inference/admission.py and the serving seams that act on
it): every case of tests/test_admission.py rewritten for the port, over a
tiny BERT model directory the port saves (2 layers, d_model 64, seq 32) —
typed admission errors, the bounded-queue + predictive gate, deadline
expiry in the queue, priority shedding under SLO burn, the
degraded-program fallback, the per-worker circuit breaker state machine,
and the contract that with every protection flag at its default the
server behaves exactly like the unprotected one."""

import time
from concurrent.futures import CancelledError

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.inference import (
    AdmissionError,
    AdmissionGate,
    CircuitBreaker,
    DeadlineExceeded,
    InferenceServer,
    Rejected,
)
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.observability.health import SloMonitor

PROTECTION_FLAGS = ("queue_limit", "serving_shed", "serving_degraded")
FEEDS = ["src_ids", "pos_ids", "sent_ids", "seq_lens"]
SEQ, VOCAB, D = 32, 100, 64
OUT = (SEQ, D)


@pytest.fixture(autouse=True)
def _clean_flags():
    obs.reset()
    obs.set_enabled(None)
    yield
    for name in PROTECTION_FLAGS + ("metrics",):
        flags.reset_flag(name)
    obs.reset()
    obs.set_enabled(None)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    with unique_name.guard():
        main, startup, h = bert.get_model(
            batch_size=2, seq_len=SEQ, vocab_size=VOCAB, d_model=D,
            n_layers=2, n_heads=2, d_inner=128, dropout=0.1,
            is_train=False, max_position=64)
    exe = fluid.Executor(fluid.CPUPlace())
    d = str(tmp_path_factory.mktemp("port_bert_adm"))
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(d, FEEDS, [h["enc_out"]], exe,
                                      main_program=main)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        program, feed_names, fetch_vars = fluid.io.load_inference_model(
            d, exe)
    return {"program": program, "feed_names": feed_names,
            "fetch_names": [v.name for v in fetch_vars], "scope": scope,
            "exe": exe}


def _server(served, **kw):
    kw.setdefault("buckets", (1, 2, 4, 8))
    kw.setdefault("max_wait_ms", 25.0)
    return InferenceServer(
        served["program"], served["feed_names"], served["fetch_names"],
        scope=served["scope"], executor=served["exe"], **kw)


def _mk(n=1, seed=0):
    b = bert.make_fake_batch(n, SEQ, VOCAB, rng=np.random.RandomState(seed),
                             varlen=True)
    return {k: b[k] for k in FEEDS}


def _burning_monitor(slo_ms=10.0):
    """An SloMonitor already deep in fast-window burn (every sample a
    violation, threshold 1.0x on a permissive target)."""
    mon = SloMonitor(slo_ms, target=0.5, fast_window_s=60.0,
                     slow_window_s=600.0, fast_burn=1.0, slow_burn=1.0,
                     name="test")
    now = time.monotonic()
    for _ in range(30):
        mon.record(slo_ms * 100.0, now=now)
    return mon


# -- typed errors ----------------------------------------------------------
def test_error_taxonomy():
    r = Rejected("queue_full", trace_id="t1")
    assert isinstance(r, AdmissionError)
    assert isinstance(r, RuntimeError)  # coarse catches keep working
    assert r.reason == "queue_full" and r.trace_id == "t1"
    d = DeadlineExceeded(deadline_ms=5.0, waited_ms=9.0, trace_id="t2")
    assert isinstance(d, AdmissionError)
    assert d.deadline_ms == 5.0 and d.waited_ms == 9.0
    assert d.trace_id == "t2"


# -- AdmissionGate ---------------------------------------------------------
def test_gate_ewma_and_prediction():
    g = AdmissionGate(queue_limit=4, alpha=0.5)
    # cold start: no EWMA yet -> optimistic 0.0 (admit the warmup)
    assert g.batch_ewma_ms is None
    assert g.predicted_wait_ms(100, 8) == 0.0
    g.note_batch(10.0)
    assert g.batch_ewma_ms == 10.0
    g.note_batch(20.0)
    assert g.batch_ewma_ms == pytest.approx(15.0)
    # 9 queued rows / bucket 8 = 2 batches ahead + its own = 3 EWMAs
    assert g.predicted_wait_ms(9, 8) == pytest.approx(45.0)
    assert g.predicted_wait_ms(0, 8) == pytest.approx(15.0)


def test_gate_queue_limit():
    g = AdmissionGate(queue_limit=2)
    assert not g.over_limit(1)
    assert g.over_limit(2) and g.over_limit(3)
    unbounded = AdmissionGate(queue_limit=0)
    assert not unbounded.over_limit(10 ** 6)


def test_gate_reads_flag():
    flags.set_flags({"queue_limit": 7})
    assert AdmissionGate().queue_limit == 7


# -- CircuitBreaker --------------------------------------------------------
def test_breaker_state_machine():
    t = [0.0]
    br = CircuitBreaker(failures=2, reset_s=5.0, clock=lambda: t[0])
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.state == "closed"      # one failure is not a pattern
    br.record_failure()
    assert br.state == "open" and br.trips == 1
    assert not br.allow()
    t[0] = 4.9
    assert not br.allow()            # still cooling down
    t[0] = 5.1
    assert br.allow()                # the single half-open probe
    assert br.state == "half_open"
    assert not br.allow()            # probe outstanding: no second one
    br.record_success()
    assert br.state == "closed" and br.allow()


def test_breaker_probe_failure_reopens():
    t = [0.0]
    br = CircuitBreaker(failures=1, reset_s=5.0, clock=lambda: t[0])
    br.record_failure()
    assert br.state == "open"
    t[0] = 6.0
    assert br.allow()
    br.record_failure()              # probe failed
    assert br.state == "open"
    t[0] = 10.0
    assert not br.allow()            # cool-down restarted at t=6
    t[0] = 11.5
    assert br.allow()
    br.record_success()
    assert br.state == "closed"


def test_breaker_disabled_is_noop():
    br = CircuitBreaker(failures=0, reset_s=1.0)
    for _ in range(50):
        br.record_failure()
    assert br.allow() and br.state == "closed" and br.trips == 0


# -- deadlines in the serving queue ---------------------------------------
def test_deadline_expired_in_queue(served):
    obs.set_enabled(True)
    flags.set_flags({"metrics": True})
    # bucket 8 never fills with one row, so the lone request waits the
    # full 150ms timer — far past its 5ms deadline
    srv = _server(served, buckets=(8,), max_wait_ms=150.0)
    with srv:
        fut = srv.submit(_mk(), deadline_ms=5.0)
        with pytest.raises(DeadlineExceeded) as ei:
            fut.result(timeout=10)
        assert ei.value.deadline_ms == 5.0
        assert ei.value.waited_ms >= 5.0
        assert fut.t_done is not None
    assert obs.counter_value("serving.expired") == 1
    assert obs.counter_value("serving.requests") == 0


def test_future_deadline_is_served(served):
    srv = _server(served, max_wait_ms=5.0)
    with srv:
        out = srv.submit(_mk(), deadline_ms=30000.0).result(timeout=30)
    assert out[0].shape == (1,) + OUT


def test_stop_drains_expired_entries(served):
    """stop() must resolve EVERY queued future — expired entries with
    DeadlineExceeded, live ones with results. None may hang."""
    srv = _server(served, buckets=(64,), max_wait_ms=10_000.0)
    with srv:
        doomed = [srv.submit(_mk(), deadline_ms=0.0) for _ in range(4)]
        live = [srv.submit(_mk(i + 1)) for i in range(2)]
    # the context exit ran stop(): everything must be resolved
    for fut in doomed + live:
        assert fut.done()
    for fut in doomed:
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=0)
    for i, fut in enumerate(live):
        assert fut.result(timeout=0)[0].shape == (i + 1,) + OUT


# -- bounded queue + predictive gate --------------------------------------
def test_queue_full_rejects(served):
    obs.set_enabled(True)
    flags.set_flags({"metrics": True, "queue_limit": 2})
    srv = _server(served, buckets=(64,), max_wait_ms=10_000.0)
    with srv:
        a = srv.submit(_mk())
        b = srv.submit(_mk())
        with pytest.raises(Rejected) as ei:
            srv.submit(_mk())
        assert ei.value.reason == "queue_full"
        assert srv.health()["queue_limit"] == 2
    assert obs.counter_value("serving.rejected") == 1
    assert a.result(timeout=10) and b.result(timeout=10)


def test_queue_full_evicts_expired_first(served):
    """CoDel-style: a full queue sheds its already-expired entries to
    admit fresh work instead of refusing it."""
    flags.set_flags({"queue_limit": 2})
    srv = _server(served, buckets=(64,), max_wait_ms=10_000.0)
    with srv:
        doomed = [srv.submit(_mk(), deadline_ms=0.0) for _ in range(2)]
        admitted = srv.submit(_mk())     # evicts both expired entries
        for fut in doomed:
            with pytest.raises(DeadlineExceeded):
                fut.result(timeout=1)
    # stop() drained the 10s timer: the admitted request was served
    assert admitted.result(timeout=30)[0].shape == (1,) + OUT


def test_queue_full_priority_eviction(served):
    """With shedding armed, a higher-priority newcomer evicts the
    lowest-priority queued entry rather than being refused."""
    obs.set_enabled(True)
    flags.set_flags({"metrics": True, "queue_limit": 1,
                     "serving_shed": True})
    srv = _server(served, buckets=(64,), max_wait_ms=10_000.0)
    with srv:
        low = srv.submit(_mk(), priority=0)
        high = srv.submit(_mk(), priority=5)
        with pytest.raises(Rejected) as ei:
            low.result(timeout=1)
        assert ei.value.reason == "shed"
        # an equal-priority newcomer does NOT evict: strict ordering
        with pytest.raises(Rejected) as ei:
            srv.submit(_mk(), priority=5)
        assert ei.value.reason == "queue_full"
    assert high.result(timeout=30)  # served by stop()'s drain
    assert obs.counter_value("serving.shed") == 1
    assert obs.counter_value("serving.rejected") == 1


def test_predictive_gate_rejects_doomed_deadline(served):
    srv = _server(served, buckets=(8,), max_wait_ms=10_000.0)
    with srv:
        srv._adm.note_batch(50.0)        # a calibrated 50ms EWMA
        filler = srv.submit(_mk())       # 1 queued row -> ~100ms wait
        with pytest.raises(Rejected) as ei:
            srv.submit(_mk(), deadline_ms=10.0)
        assert ei.value.reason == "predicted_late"
        # a deadline beyond the estimate is admitted
        ok = srv.submit(_mk(), deadline_ms=60_000.0)
    # served by stop()'s drain, not the 10s timer
    assert ok.result(timeout=30) and filler.result(timeout=30)


# -- priority shedding + degraded mode under burn -------------------------
def test_shed_low_priority_under_burn(served):
    obs.set_enabled(True)
    flags.set_flags({"metrics": True, "serving_shed": True})
    srv = _server(served, slo_monitor=_burning_monitor())
    assert srv.fast_burning()
    with srv:
        with pytest.raises(Rejected) as ei:
            srv.submit(_mk(), priority=0)
        assert ei.value.reason == "shed"
        # high-priority traffic rides through the same burn
        assert srv.submit(_mk(), priority=1).result(timeout=30)
    assert obs.counter_value("serving.shed") == 1


def test_no_shed_without_flag(served):
    srv = _server(served, slo_monitor=_burning_monitor())
    with srv:
        assert srv.submit(_mk(), priority=0).result(timeout=30)


def test_degraded_mode_engages_and_recovers(served):
    """Fast burn flips dispatch to the degraded executable (edge-
    triggered event); only slow-window recovery flips it back. While a
    degraded program is configured but not yet engaged, priority-0
    traffic is NOT shed — degrade first, drop second."""
    obs.set_enabled(True)
    flags.set_flags({"metrics": True, "serving_shed": True,
                     "serving_degraded": True})
    # short slow window so the burn ages out inside the test
    mon = SloMonitor(10.0, target=0.5, fast_window_s=0.4,
                     slow_window_s=0.8, fast_burn=1.0, slow_burn=1.0,
                     name="deg")
    for _ in range(30):
        mon.record(1000.0)
    srv = _server(served, slo_monitor=mon,
                  degraded_program=served["program"])
    with srv:
        # not yet degraded -> low priority is admitted, and this
        # dispatch is what engages degraded mode
        out = srv.submit(_mk(), priority=0).result(timeout=30)
        assert out[0].shape == (1,) + OUT
        assert srv._degraded and srv.health()["degraded"]
        # degraded AND still burning -> now shedding starts
        with pytest.raises(Rejected):
            srv.submit(_mk(), priority=0)
        # wait out both burn windows, then a dispatch confirms
        # recovery and exits degraded mode
        time.sleep(1.0)
        assert srv.submit(_mk(), priority=1).result(timeout=30)
        assert not srv._degraded
    assert obs.counter_value("serving.degraded_entered") == 1
    flips = [s.args["engaged"] for s in obs.spans()
             if s.name == "health.degraded_mode"]
    assert flips == [True, False]  # edge-triggered, no flapping


def test_degraded_flag_without_program_is_inert(served):
    flags.set_flags({"serving_degraded": True})
    srv = _server(served, slo_monitor=_burning_monitor())
    assert not srv._deg_enabled
    with srv:
        assert srv.submit(_mk()).result(timeout=30)


# -- run(timeout)/cancel ---------------------------------------------------
def test_cancel_unknown_future_is_false(served):
    from concurrent.futures import Future

    srv = _server(served)
    with srv:
        served_fut = srv.submit(_mk())
        assert served_fut.result(timeout=30)
        assert srv.cancel(served_fut) is False   # already dispatched
        assert srv.cancel(Future()) is False     # never ours


def test_cancel_queued_entry(served):
    obs.set_enabled(True)
    flags.set_flags({"metrics": True})
    srv = _server(served, buckets=(64,), max_wait_ms=10_000.0)
    with srv:
        fut = srv.submit(_mk())
        assert srv.cancel(fut) is True
        assert fut.cancelled()
        with pytest.raises(CancelledError):
            fut.result(timeout=0)
        assert srv.health()["queue_depth"] == 0
    assert obs.counter_value("serving.cancelled") == 1


# -- defaults-off parity ---------------------------------------------------
def test_defaults_keep_unprotected_behavior(served):
    """With every protection flag at its default the server must be
    indistinguishable from the pre-admission build: unbounded queue, no
    shedding, no degraded program, identical executable cache tags."""
    srv = _server(served)
    assert srv._adm.queue_limit == 0
    assert not srv._shed and not srv._deg_enabled and not srv._degraded
    with srv:
        futs = [srv.submit(_mk(i + 1, seed=i)) for i in range(6)]
        for i, f in enumerate(futs):
            assert f.result(timeout=30)[0].shape == (i + 1,) + OUT
