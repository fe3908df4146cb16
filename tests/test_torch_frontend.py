"""The port's admission front end (``serve/frontend.py``) against
``repro``'s, and the typed round trips of the resilient and admission
layers.

Mirrors the 27 cases of ``tests/test_frontend.py`` and the frontend and
resilient round trips of ``tests/test_query_api.py``.  The port's
engines run on the CPU (``flash`` backend, the kernels' plain versions);
``repro``'s run its ``jnp`` backend.  Inputs are numpy arrays made from a
seed.

No wall clock decides an outcome: the frontend (and the resilient
engine) read a ``FakeClock`` that moves only when a test moves it, so a
queued request expires exactly when the test says and no answer is late
because the machine is busy.  Two things still read real time, each with
its margin stated where it is used: the plain engine's own deadline
check, and the drain tests' short sleeps that widen a race window (they
decide no outcome: every check holds whichever way the race goes).

Tolerances: through the frontend against the same engine directly, rtol
1e-5 (one code path; a fused batch differs only in which rows share a
padded dispatch); the port against ``repro``, the f32 serve bar (rtol
1e-5, atol 1e-6·peak); the brownout tier's rows against float64 at that
tier's bar (bf16 5e-2).
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.fault_injection import ChaosConfig as JChaosConfig
from repro.fault_injection import FaultInjector as JFaultInjector
from repro.serve import AsyncFrontend as JAsyncFrontend
from repro.serve import FrontendConfig as JFrontendConfig
from repro.serve import QueryRequest as JRequest
from repro.serve import ResilienceConfig as JResilienceConfig
from repro.serve import ResilientEngine as JResilientEngine
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import fault_injection
from repro_torch.core import kde as tkde
from repro_torch.fault_injection import ChaosConfig, FaultInjector
from repro_torch.serve import (AdmissionStateMachine, AimdController,
                               AsyncFrontend, BadRequest, DeadlineExceeded,
                               FrontendConfig, Overloaded, QueryRequest,
                               ResilienceConfig, ResilientEngine,
                               ServeConfig, ServeEngine, TokenBucket)
from repro_torch.serve.frontend import (ACCEPTING, BACKPRESSURE, DRAINING,
                                        SHEDDING)

D, H = 4, 0.5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((384, D)).astype(np.float32),
            rng.standard_normal((48, D)).astype(np.float32),
            rng.standard_normal((64, D)).astype(np.float32))


@pytest.fixture(autouse=True)
def _no_injector():
    yield
    fault_injection.uninstall()


def _cfg(**kw):
    base = dict(backend="flash", method="sdkde", device="cpu", block_m=8,
                block_n=128, min_batch=8, max_batch=64, prune="off")
    base.update(kw)
    return ServeConfig(**base)


def _engine(x, **kw):
    eng = ServeEngine(_cfg(**kw))
    eng.register("ds", x, h=H)
    return eng


class FakeClock:
    """Test clock that moves only when told (``tick``); thread-safe."""

    def __init__(self, t=0.0):
        self.t = t
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            return self.t

    def tick(self, dt):
        with self._lock:
            self.t += dt


def _pump_fe(eng, clock=None, **kw):
    base = dict(workers=0)
    base.update(kw)
    return AsyncFrontend(eng, FrontendConfig(**base),
                         clock=clock or FakeClock())


def _req(key, y, **kw):
    return QueryRequest(key=key, points=y, **kw)


def _close(got, want, rtol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# Coalescing equivalence: through the frontend == direct engine.query.
# ---------------------------------------------------------------------------


def test_fused_batch_matches_direct_queries(data):
    x, _, y = data
    eng = _engine(x)
    ys = [y[:3], y[3:10], y[10:15], y[15:16]]
    with _pump_fe(eng) as fe:
        futs = [fe.submit(_req("ds", q)) for q in ys]
        assert fe.pump() == 1              # all four fused into one batch
        for q, f in zip(ys, futs):
            ans = f.result(timeout=5)
            assert ans.batch_requests == len(ys)
            _close(ans.value, eng.query(_req("ds", q)).value)
        assert fe.unaccounted() == 0


def test_fused_batch_matches_repro_frontend(data):
    """The same fused traffic through repro's frontend over its engine:
    the port's answers match at the f32 serve bar, batch by batch."""
    x, _, y = data
    ys = [y[:3], y[3:10], y[10:15], y[15:16]]
    jeng = JServeEngine(JServeConfig(backend="jnp", method="sdkde",
                                     min_batch=8, max_batch=64))
    jeng.register("ds", x, h=H)
    with JAsyncFrontend(jeng, JFrontendConfig(workers=0)) as jfe:
        jf = [jfe.submit(JRequest(key="ds", points=q, deadline_s=60.0))
              for q in ys]
        jfe.pump()
        want = [np.asarray(f.result().value) for f in jf]
    with _pump_fe(_engine(x)) as fe:
        futs = [fe.submit(_req("ds", q)) for q in ys]
        fe.pump()
        for f, w in zip(futs, want):
            assert f.result().batch_requests == len(ys)
            _close(f.result().value, w)


@pytest.mark.parametrize("tier,rtol", [
    ("f32", 1e-5), ("bf16x2", 1e-5), ("bf16", 1e-5),
])
def test_tier_equivalence_through_frontend(data, tier, rtol):
    """Same tier through the frontend vs direct: one code path, so the
    bar is 1e-5 however lossy the tier itself is."""
    x, _, y = data
    eng = _engine(x)
    with _pump_fe(eng) as fe:
        futs = [fe.submit(_req("ds", y[:12], precision=tier)),
                fe.submit(_req("ds", y[12:20], precision=tier))]
        fe.pump()
        want = [eng.query(_req("ds", y[:12], precision=tier)).value,
                eng.query(_req("ds", y[12:20], precision=tier)).value]
        for f, w in zip(futs, want):
            assert f.result().tier == tier
            _close(f.result().value, w, rtol=rtol)


def test_streaming_generation_flip_through_frontend(data):
    """A registry append between batches flips the generation; the
    frontend's next fused dispatch serves the new one."""
    x, xa, y = data
    eng = _engine(x, block_n=64, stream=True, staleness_budget=0,
                  min_batch=16, max_batch=128)
    with _pump_fe(eng) as fe:
        f0 = fe.submit(_req("ds", y[:8]))
        fe.pump()
        before = f0.result().value.numpy()
        eng.registry.append("ds", xa)          # generation flip
        f1 = fe.submit(_req("ds", y[:8]))
        fe.pump()
        after = f1.result().value.numpy()
        _close(after, eng.query(_req("ds", y[:8])).value)
        assert not np.allclose(after, before)  # the new mass counted


def test_mixed_precision_requests_do_not_fuse(data):
    x, _, y = data
    eng = _engine(x)
    with _pump_fe(eng) as fe:
        fa = fe.submit(_req("ds", y[:4], precision="f32"))
        fb = fe.submit(_req("ds", y[4:8], precision="bf16"))
        assert fe.pump() == 2
        assert fa.result().tier == "f32" and fb.result().tier == "bf16"


# ---------------------------------------------------------------------------
# Typed shed paths: queue full, draining, chaos retries.
# ---------------------------------------------------------------------------


def test_queue_full_sheds_typed(data):
    x, _, y = data
    fe = _pump_fe(_engine(x), max_queue=4, rate=1e5, burst=1e4)
    for _ in range(4):
        fe.submit(_req("ds", y[:2]))
    with pytest.raises(Overloaded) as ei:
        fe.submit(_req("ds", y[:2]))
    assert ei.value.reason == "queue_full"
    fe.pump()
    assert fe.unaccounted() == 0
    assert fe.report()["rejected_by"] == {"queue_full": 1}


def test_draining_rejects_new_but_serves_queued(data):
    x, _, y = data
    fe = _pump_fe(_engine(x))
    f0 = fe.submit(_req("ds", y[:4]))
    fe.sm.drain()
    with pytest.raises(Overloaded) as ei:
        fe.submit(_req("ds", y[:4]))
    assert ei.value.reason == "draining"
    assert fe.drain(timeout=5)             # pump-mode drain serves f0
    assert f0.result().value.shape == (4,)
    assert fe.state == DRAINING


def test_injected_failure_retries_then_answers(data):
    """One chaos-failed dispatch costs a retry, not an answer."""
    x, _, y = data
    eng = _engine(x)
    calls = {"n": 0}
    real_query_many = eng.query_many

    def flaky(reqs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise fault_injection.InjectedFailure("slow_shard",
                                                  point="serve.dispatch")
        return real_query_many(reqs)

    eng.query_many = flaky
    with _pump_fe(eng, max_retries=2) as fe:
        f = fe.submit(_req("ds", y[:5]))
        fe.pump()                           # fails, requeues ...
        _close(f.result(timeout=5).value,   # ... and the retry answers
               eng.query(_req("ds", y[:5])).value)
        assert fe.stats["retries"] == 1 and fe.unaccounted() == 0


def test_retries_exhausted_is_typed_overloaded(data):
    x, _, y = data
    eng = _engine(x)

    def always_fails(reqs):
        raise fault_injection.InjectedFailure("slow_shard",
                                              point="serve.dispatch")

    eng.query_many = always_fails
    with _pump_fe(eng, max_retries=1) as fe:
        f = fe.submit(_req("ds", y[:5]))
        for _ in range(3):
            fe.pump()
        with pytest.raises(Overloaded) as ei:
            f.result(timeout=5)
        assert ei.value.reason == "retries"
        assert fe.unaccounted() == 0


def test_real_bug_propagates_to_caller_not_retried(data):
    x, _, y = data
    eng = _engine(x)

    def broken(reqs):
        raise RuntimeError("genuine bug")

    eng.query_many = broken
    with _pump_fe(eng) as fe:
        f = fe.submit(_req("ds", y[:5]))
        fe.pump()
        with pytest.raises(RuntimeError, match="genuine bug"):
            f.result(timeout=5)
        assert fe.stats["retries"] == 0 and fe.stats["errored"] == 1


# ---------------------------------------------------------------------------
# Deadlines: queue expiry, engine enforcement, EDF ordering.
# ---------------------------------------------------------------------------


def test_expired_in_queue_is_typed_deadline(data):
    x, _, y = data
    clock = FakeClock()
    fe = _pump_fe(_engine(x), clock=clock)
    f = fe.submit(_req("ds", y[:4], deadline_s=1e-3))
    clock.tick(2e-3)                       # past its deadline, in queue
    fe.pump()
    with pytest.raises(DeadlineExceeded):
        f.result(timeout=5)
    assert fe.stats["expired"] == 1 and fe.unaccounted() == 0


def test_edf_dequeue_order(data):
    """Earliest deadline first, whatever the arrival order (different
    keys, so the batches cannot fuse)."""
    x, _, y = data
    eng = _engine(x)
    for k in ("a", "b", "c"):
        eng.register(k, x, h=H)
    fe = _pump_fe(eng)
    order = []
    real = eng.query_many

    def spy(reqs):
        order.append(reqs[0].key)
        return real(reqs)

    eng.query_many = spy
    fe.submit(_req("b", y[:2], deadline_s=20.0))
    fe.submit(_req("c", y[:2], deadline_s=30.0))
    fe.submit(_req("a", y[:2], deadline_s=10.0))
    fe.pump()
    assert order == ["a", "b", "c"]


def test_engine_deadline_enforced(data):
    """The plain engine honors a request's deadline on its own (real)
    clock: 1 ns has always passed between taking the deadline and the
    first check, which are microseconds apart."""
    x, _, y = data
    eng = _engine(x)
    with pytest.raises(DeadlineExceeded):
        eng.query(_req("ds", y[:4], deadline_s=1e-9))
    with pytest.raises(DeadlineExceeded):
        eng.query_many([_req("ds", y[:4], deadline_s=1e-9)])
    ok = eng.query(_req("ds", y[:4], deadline_s=60.0)).value
    _close(ok, eng.query(_req("ds", y[:4])).value, rtol=1e-7)


# ---------------------------------------------------------------------------
# Admission state machine: watermarks, hysteresis, terminal drain.
# ---------------------------------------------------------------------------


def test_state_machine_watermarks_and_hysteresis():
    sm = AdmissionStateMachine(max_queue=100, backpressure_frac=0.4,
                               shed_frac=0.8, hysteresis=0.5)
    assert sm.observe(0) == ACCEPTING
    assert sm.observe(39) == ACCEPTING
    assert sm.observe(40) == BACKPRESSURE      # enter at the watermark
    assert sm.observe(25) == BACKPRESSURE      # above exit (20): held
    assert sm.observe(20) == ACCEPTING         # at exit: released
    assert sm.observe(80) == SHEDDING
    assert sm.observe(45) == SHEDDING          # above shed exit (40): held
    assert sm.observe(40) == BACKPRESSURE      # drops one level, not two
    assert sm.observe(5) == ACCEPTING
    assert sm.level == 0


def test_state_machine_drain_is_terminal():
    sm = AdmissionStateMachine(100, 0.4, 0.8, 0.5)
    sm.observe(90)
    sm.drain()
    assert sm.observe(0) == DRAINING           # depth can't resurrect it
    assert sm.transitions[-1][1] == DRAINING
    assert sm.level == 2


def test_workers_over_plain_engine_rejected(data):
    x, _, _ = data
    with pytest.raises(ValueError, match="ResilientEngine"):
        AsyncFrontend(_engine(x), FrontendConfig(workers=2))
    with pytest.raises(TypeError):
        AsyncFrontend(object(), FrontendConfig(workers=0))


# ---------------------------------------------------------------------------
# Token bucket + AIMD (fake clock: deterministic, no sleeps).
# ---------------------------------------------------------------------------


def test_token_bucket_refill_and_capacity():
    clk = FakeClock()
    tb = TokenBucket(rate=10.0, capacity=5.0, clock=clk)
    assert all(tb.take() for _ in range(5))    # starts full
    assert not tb.take()                       # empty
    clk.tick(0.25)                             # +2.5 tokens
    assert tb.take(2.0) and not tb.take(1.0)
    clk.tick(100.0)                            # clamped at capacity
    tb._refill()
    assert tb.tokens == 5.0
    assert tb.take(5.0) and not tb.take(0.5)


def test_aimd_additive_up_multiplicative_down():
    clk = FakeClock()
    tb = TokenBucket(rate=100.0, capacity=10.0, clock=clk)
    c = AimdController(tb, increase=10.0, decrease=0.5,
                       min_rate=4.0, max_rate=200.0)
    c.on_healthy()
    assert c.rate == 110.0 and tb.rate == 110.0
    for _ in range(20):
        c.on_healthy()
    assert c.rate == 200.0                     # clamped at max
    c.on_breach("queue_full")
    assert c.rate == 100.0
    for _ in range(10):
        c.on_breach("slo")
    assert c.rate == 4.0 and tb.rate == 4.0    # clamped at min


def test_frontend_brownout_ladder_under_pressure(data):
    """Past the shed watermark unpinned requests are served at the
    cheapest tier (held against float64 at bf16's bar); a pinned tier
    always wins."""
    x, _, y = data
    eng = _engine(x, max_batch=8)
    fe = _pump_fe(eng, max_queue=8, backpressure_frac=0.25, shed_frac=0.625,
                  rate=1e5, burst=1e4, default_deadline_ms=60_000.0)
    futs = [fe.submit(_req("ds", y[i:i + 1])) for i in range(6)]
    pinned = fe.submit(_req("ds", y[6:7], precision="f32"))
    assert fe.state == SHEDDING
    fe.pump()
    shed = futs[0].result(timeout=5)
    assert shed.tier == "bf16" and shed.browned and shed.state == SHEDDING
    want = tkde.sdkde_eval(torch.as_tensor(x, dtype=torch.float64),
                           torch.as_tensor(y[:1], dtype=torch.float64), H)
    _close(shed.value, want, rtol=5e-2)
    assert pinned.result(timeout=5).tier == "f32"
    assert not pinned.result().browned
    assert fe.stats["browned"] > 0 and fe.unaccounted() == 0


def _resilient(x, clock):
    reng = ResilientEngine(
        _cfg(max_batch=32),
        ResilienceConfig(shards=2, replicas=2, seed=0,
                         deadline_ms=30_000.0, hedge_after_ms=1000.0),
        clock=clock, sleep=clock.tick)
    reng.register("ds", x, h=H)
    return reng


def test_resilient_frontend_multiworker_equivalence(data):
    """Two dispatcher threads over a ResilientEngine: every answer
    matches the direct resilient query, nothing unaccounted.  Both layers
    read the fake clock, so no answer can be late."""
    x, _, y = data
    clock = FakeClock()
    reng = _resilient(x, clock)
    try:
        want = reng.query(_req("ds", y[:6])).value
        with AsyncFrontend(reng, FrontendConfig(workers=2),
                           clock=clock) as fe:
            futs = [fe.submit(_req("ds", y[:6])) for _ in range(8)]
            for f in futs:
                _close(f.result(timeout=30).value, want)
            assert fe.unaccounted() == 0
    finally:
        reng.close()


def test_resilient_shedding_rung_opts_into_degraded(data):
    """In front of a ResilientEngine the shedding rung opts into its
    certified degraded answers even where the request asked for none."""
    x, _, y = data
    from repro_torch.fault_injection import ChaosEvent

    clock = FakeClock()
    reng = ResilientEngine(
        _cfg(max_batch=8),
        ResilienceConfig(shards=2, replicas=2, seed=0, max_retries=0,
                         allow_degraded=False, degraded_accuracy=1e6,
                         deadline_ms=30_000.0, hedge_after_ms=1000.0),
        chaos=ChaosConfig(events=(ChaosEvent("shard_kill", shard=1),)),
        clock=clock, sleep=clock.tick)
    try:
        reng.register("ds", x, h=H, prewarm=False)
        fe = _pump_fe(reng, clock=clock, max_queue=8, backpressure_frac=0.25,
                      shed_frac=0.625, rate=1e5, burst=1e4)
        futs = [fe.submit(_req("ds", y[i:i + 1], allow_degraded=False))
                for i in range(6)]
        assert fe.state == SHEDDING
        fe.pump(1)
        ans = futs[0].result(timeout=5)
        assert ans.degraded and ans.missing_shards == (1,)
        fe.drain()
        assert fe.unaccounted() == 0
    finally:
        reng.close()


# ---------------------------------------------------------------------------
# Overload chaos modes: the serve.admit point, determinism in the seed.
# ---------------------------------------------------------------------------


def _drive_admit(inj):
    events = []
    for _ in range(40):
        inj.begin_request()
        try:
            inj.fire("serve.admit", key="k")
            events.append(("ok", inj.burst("serve.admit")))
        except fault_injection.InjectedFailure as e:
            events.append(("fail", e.kind))
    return events, inj.snapshot()


def test_drain_implies_every_future_resolved(data):
    """``drain()`` returns only once every admitted future carries an
    outcome: the worker decrements inflight after ``set_result``.  The
    5 ms sleep only widens the would-be race window; deadlines are on
    the fake clock."""
    x, _, y = data
    eng = _engine(x)
    real = eng.query_many

    def slow(reqs):
        time.sleep(0.005)
        return real(reqs)

    eng.query_many = slow
    for _ in range(20):
        with AsyncFrontend(eng, FrontendConfig(
                workers=1, batch_wait_ms=0.0), clock=FakeClock()) as fe:
            futs = [fe.submit(_req("ds", y[:3])) for _ in range(4)]
            assert fe.drain(timeout=10.0)
            assert all(f.done() for f in futs)
            assert fe.unaccounted() == 0


def test_drain_covers_straggler_wait_window(data):
    """The straggler wait in ``_next_batch`` releases the lock with the
    head request popped; inflight is claimed before it, so a concurrent
    ``drain()`` cannot return while the request is unserved.  The 20 ms
    sleep lets the worker enter its 100 ms wait; it decides nothing."""
    x, _, y = data
    eng = _engine(x)
    for _ in range(10):
        with AsyncFrontend(eng, FrontendConfig(
                workers=1, batch_wait_ms=100.0), clock=FakeClock()) as fe:
            f = fe.submit(_req("ds", y[:3]))
            time.sleep(0.02)
            assert fe.drain(timeout=10.0)
            assert f.done()
            assert fe.unaccounted() == 0


def test_overload_modes_deterministic_in_seed_and_as_repro():
    kw = dict(client_burst=0.5, admit_stall=0.2, burst_factor=3,
              slow_ms=0.0)
    e1, s1 = _drive_admit(FaultInjector(ChaosConfig(seed=11, **kw)))
    e2, s2 = _drive_admit(FaultInjector(ChaosConfig(seed=11, **kw)))
    assert e1 == e2 and s1 == s2
    assert s1["client_burst"] > 0 and s1["admit_stall"] > 0
    assert any(b == 3 for _, b in e1)
    e3, _ = _drive_admit(FaultInjector(ChaosConfig(seed=12, **kw)))
    assert e3 != e1
    ej, sj = _drive_admit(JFaultInjector(JChaosConfig(seed=11, **kw)))
    assert ej == e1 and sj == s1          # repro's draws, one for one


def test_burst_mode_injects_synthetic_queue_pressure(data):
    """client_burst at serve.admit enqueues burst_factor synthetic
    requests; all resolve (typed or answered), none silently."""
    x, _, y = data
    inj = fault_injection.install(FaultInjector(ChaosConfig(
        client_burst=1.0, burst_factor=4, seed=1)))
    fe = _pump_fe(_engine(x), max_queue=16)
    f = fe.submit(_req("ds", y[:2]))
    assert fe.stats["synthetic"] == 4 and inj.counts["client_burst"] == 1
    fe.pump()
    assert f.result(timeout=5).value.shape == (2,)
    assert fe.unaccounted() == 0


def test_burst_hook_inactive_without_mode():
    inj = FaultInjector(ChaosConfig(shard_kill=0.5, seed=0))
    inj.begin_request()
    assert inj.burst("serve.admit") == 0
    assert fault_injection.burst("serve.admit") == 0   # no injector: 0


# ---------------------------------------------------------------------------
# The overload soak, short and deterministic.
# ---------------------------------------------------------------------------


def test_overload_soak_steady_burst_recovery(data):
    """``repro``'s overload soak (benchmarks/overload_soak.py) on the fake
    clock: the frontend serves one 64-row request (max_batch 64, so none
    fuse) per 10 ms slot; arrivals come at half that rate (steady, 20),
    4x it (burst, 80), then half again (settle 20, recovery 20).  The
    burst sheds typed, nothing is silent, the state walks to shedding and
    back to accepting, and recovery's goodput is the steady phase's."""
    x, _, _ = data
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((256, D)).astype(np.float32)
    clock = FakeClock()
    fe = _pump_fe(_engine(x), clock=clock, max_queue=16, rate=100.0,
                  burst=8.0, default_deadline_ms=60_000.0)
    slot = 0.01
    phases = [("steady", 20, 2 * slot), ("burst", 80, slot / 4),
              ("settle", 20, 2 * slot), ("recovery", 20, 2 * slot)]
    outcome = {}
    next_slot = slot
    for name, arrivals, gap in phases:
        futs, shed = [], 0
        for _ in range(arrivals):
            clock.tick(gap)
            while clock() >= next_slot:        # the server's slots so far
                fe.pump(1)
                next_slot += slot
            off = int(rng.integers(0, 192))
            try:
                futs.append(fe.submit(_req("ds", pool[off:off + 64])))
            except Overloaded:
                shed += 1
        outcome[name] = (futs, shed, fe.state)
    assert fe.drain()
    assert fe.unaccounted() == 0
    answered = {}
    for name, (futs, shed, _) in outcome.items():
        assert all(f.done() for f in futs)
        answered[name] = sum(f.exception() is None for f in futs)
        shed += sum(isinstance(f.exception(), Overloaded) for f in futs)
        assert answered[name] + shed == dict(
            steady=20, burst=80, settle=20, recovery=20)[name]
        outcome[name] = (futs, shed, outcome[name][2])
    assert outcome["steady"][1] == 0 and answered["steady"] == 20
    assert outcome["burst"][1] > 0                       # typed sheds
    transitions = [b for _, b in fe.sm.transitions]
    assert BACKPRESSURE in transitions and SHEDDING in transitions
    assert outcome["recovery"][2] == ACCEPTING
    assert answered["recovery"] >= 0.8 * answered["steady"]


# ---------------------------------------------------------------------------
# Typed round trips (tests/test_query_api.py): resilient and frontend.
# ---------------------------------------------------------------------------


def test_resilient_roundtrip_matches_repro(data):
    x, _, y = data
    jeng = JResilientEngine(
        JServeConfig(backend="jnp", method="sdkde", min_batch=8,
                     max_batch=64),
        JResilienceConfig(shards=2, replicas=2))
    try:
        jeng.register("ds", x, h=H)
        want = np.asarray(jeng.query(JRequest(key="ds", points=y[:40])).value)
    finally:
        jeng.close()
    clock = FakeClock()
    with ResilientEngine(_cfg(), ResilienceConfig(shards=2, replicas=2),
                         clock=clock, sleep=clock.tick) as eng:
        eng.register("ds", x, h=H)
        ans = eng.query(QueryRequest(key="ds", points=y[:40]))
    _close(ans.value, want)
    assert not ans.degraded and ans.rel_err_bound > 0.0
    assert ans.key == "ds" and ans.tier == "f32" and ans.path == ("f32",)


def test_frontend_roundtrip_matches_repro(data):
    x, _, y = data
    jeng = JServeEngine(JServeConfig(backend="jnp", method="sdkde",
                                     min_batch=8, max_batch=64))
    jeng.register("ds", x, h=H)
    with JAsyncFrontend(jeng, JFrontendConfig(workers=0)) as jfe:
        jf = jfe.submit(JRequest(key="ds", points=y[:40], deadline_s=60.0))
        jfe.pump()
        want = np.asarray(jf.result(timeout=10).value)
    with _pump_fe(_engine(x)) as fe:
        fut = fe.submit(QueryRequest(key="ds", points=y[:40],
                                     deadline_s=60.0))
        fe.pump()
        ans = fut.result(timeout=10)
        with pytest.raises(BadRequest):
            fe.submit("ds")          # legacy-api-ok: refused, no shim
    _close(ans.value, want)
    assert ans.batch_requests >= 1 and ans.latency_s >= 0.0
    assert ans.state == ACCEPTING and not ans.browned
    assert ans.queued_ms >= 0.0


# ---------------------------------------------------------------------------
# The launcher's open loop.
# ---------------------------------------------------------------------------


def test_launcher_open_loop_sheds_typed(capsys):
    """``--open-loop --expect-shed`` on the CPU: arrivals back to back
    (``--qps 1e6``) into a queue of 4.  A submit takes ~25 µs here and a
    dispatch ~2 ms, so the queue is full after ~0.1 ms of a dispatch
    that takes 80x that: the run sheds, typed, and leaves nothing
    unaccounted."""
    from repro_torch.launch import serve_kde

    rc = serve_kde.main([
        "--device", "cpu", "--n", "2048", "--d", "4", "--requests", "40",
        "--max-batch", "256", "--min-batch", "32", "--block-m", "32",
        "--block-n", "128", "--open-loop", "--qps", "1e6",
        "--max-queue", "4", "--expect-shed"])
    out = capsys.readouterr().out
    assert rc == 0, out
    line = next(ln for ln in out.splitlines() if ln.startswith("open-loop"))
    assert "silent=0" in line and " shed=0 " not in line
