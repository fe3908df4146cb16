"""The port's resilient serving layer (``serve/resilience.py``) against
``repro``'s: replicated shard dispatch, chaos, hedging, breakers,
fencing, certified degradation, and ``spatial.partition_clusters``.

Mirrors ``tests/test_resilience.py`` function for function, plus parity
with ``repro``.  The port runs on the CPU, its ``flash`` backend through
the kernels' plain versions; ``repro``'s engine runs its ``jnp`` backend,
as its own tests do.  Inputs are numpy arrays made from a seed.

No wall clock: deadlines, breaker cooldowns and heartbeats read the
injected ``FakeClock``, which advances 1 µs per read (so a 1 ns deadline
has passed by the first check), and backoff sleeps advance it.  The one
test that needs real time, the hedge against a ``slow_shard`` replica
(the injector's sleep is real), states its margin.

Tolerances:
  * exact answers against float64 sums, ``repro``'s engine and the
    port's plain engine: the f32 serve bar, rtol 1e-5 with an atol of
    1e-6·peak, the rtol never below the norm-trick model
    8·eps·max‖x‖²/(2h²) (ROADMAP C); Laplace sums cross zero, so each row
    is held to that bar times its absolute mass Σ φ·(2 + d/2 + scaled),
    as ``test_torch_laplace.py`` does;
  * degraded answers: every row's error against float64 within its
    certified bound times |f|, plus the f32 bar of the answer itself
    (bar·|f̂| + 1e-6·peak, or the Laplace mass bar): the certificate
    bounds the exact partial sum, and where the missing mass underflows
    the realized error equals the bound up to that rounding;
  * degraded values and bounds against ``repro``'s, given ``repro``'s
    cluster labels: values at the f32 bar; bounds within rtol 1e-4 (each
    package debiases in its own f32 order, and the bound's exponentials
    amplify a ~1e-6 move of a tile's distance by the exponent, ≤ ~50
    for the tiles that carry mass).
"""

import math
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fault_injection import ChaosConfig as JChaosConfig
from repro.fault_injection import ChaosEvent as JChaosEvent
from repro.fault_injection import FaultInjector as JFaultInjector
from repro.kernels import spatial as jsp
from repro.serve import QueryRequest as JRequest
from repro.serve import ResilienceConfig as JResilienceConfig
from repro.serve import ResilientEngine as JResilientEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch import convert
from repro_torch.core import kde as tkde
from repro_torch.fault_injection import ChaosConfig, ChaosEvent, FaultInjector
from repro_torch.kernels import spatial
from repro_torch.serve import (BadRequest, DeadlineExceeded, Degraded,
                               Overloaded, QueryRequest, ResilienceConfig,
                               ResilientEngine, ServeConfig, ServeEngine,
                               ServeError, UnknownKey)

D, N, H = 3, 384, 0.5
REF = {"sdkde": tkde.sdkde_eval, "kde": tkde.kde_eval,
       "laplace": tkde.laplace_kde_eval}


class FakeClock:
    """Monotonic test clock: every read advances it by ``tick`` seconds;
    ``sleep`` advances it by the requested time.  Thread-safe (the
    engine's workers read it)."""

    def __init__(self, tick: float = 1e-6):
        self.t = 0.0
        self.tick = tick
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            self.t += self.tick
            return self.t

    def sleep(self, dt: float) -> None:
        with self._lock:
            self.t += max(dt, 0.0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x[: N // 2] += 3.0                   # two well-separated groups
    pool = rng.standard_normal((64, D)).astype(np.float32)
    pool[::2] += 3.0
    return x, pool


def _req(key, y, **kw):
    return QueryRequest(key=key, points=y, **kw)


def _cfg(method="sdkde", **kw):
    base = dict(backend="flash", method=method, device="cpu", block_m=8,
                block_n=64, min_batch=8, max_batch=32, prune="off")
    base.update(kw)
    return ServeConfig(**base)


def mk_engine(chaos=None, clock=None, method="sdkde", **rkw):
    clock = clock or FakeClock()
    defaults = dict(shards=2, replicas=2, deadline_ms=30_000.0,
                    backoff_ms=1.0, hedge_after_ms=1000.0, seed=0)
    defaults.update(rkw)
    return ResilientEngine(_cfg(method), ResilienceConfig(**defaults),
                           chaos=chaos, clock=clock, sleep=clock.sleep)


def _f64(x, y, h, method="sdkde"):
    return REF[method](torch.as_tensor(x, dtype=torch.float64),
                       torch.as_tensor(y, dtype=torch.float64),
                       h).numpy()


def assert_close(got, want, rtol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * np.max(np.abs(want)))


def f32_bar(x, h):
    """The f32 bar: 1e-5, or the norm-trick model 8·eps·max‖x‖²/(2h²)
    where larger (two implementations round the Gram differently and
    1/(2h²) amplifies it inside exp)."""
    x = np.asarray(x, np.float64)
    return max(1e-5, 8 * np.finfo(np.float32).eps
               * float((x * x).sum(1).max()) / (2 * h * h))


def laplace_mass_bar(x, y, h):
    """Per-row allowance of a Laplace density: the f32 bar times the
    row's normalized absolute mass."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n, d = x.shape
    s = ((y[:, None, :] - x[None]) ** 2).sum(-1) / (2 * h * h)
    mass = (np.exp(-s) * (2 + d / 2 + s)).sum(1) / (
        n * (2 * math.pi) ** (d / 2) * h**d)
    return f32_bar(x, h) * mass


def assert_method_close(got, want, x, y, h, method):
    if method != "laplace":
        return assert_close(got, want, rtol=f32_bar(x, h))
    got = np.asarray(got, np.float64)
    excess = np.abs(got - np.asarray(want, np.float64)) - laplace_mass_bar(
        x, y, h)
    assert np.isfinite(got).all() and excess.max() <= 0, excess.max()


# -- exact recombination ------------------------------------------------------


def test_sharded_answer_matches_full_reference(data):
    x, pool = data
    y = pool[:24]
    with mk_engine() as eng:
        table = eng.register("k", x, h=H, prewarm=False)
        assert table.n_shards == 2 and table.n_replicas == 2
        assert sum(table.shard_n) == N
        ans = eng.query(_req("k", y))
        assert_close(ans.value, _f64(x, y, H))
        assert not ans.degraded and ans.live_shards == (0, 1)
        assert ans.missing_shards == ()
        assert 0.0 < ans.rel_err_bound <= 1e-5   # f32 tier rtol
        assert ans.rel_err_bounds.shape == (24,)


@pytest.mark.parametrize("method", ["sdkde", "kde", "laplace"])
def test_exact_densities_match_repro_and_the_plain_engine(data, method):
    """The recombined answer does not depend on the partition (each
    package clusters for itself), so it matches repro's resilient engine
    and the port's unsharded engine at the f32 bar."""
    x, pool = data
    y = pool[:40]
    jeng = JResilientEngine(
        JServeConfig(backend="jnp", method=method, min_batch=8,
                     max_batch=32),
        JResilienceConfig(shards=2, replicas=2, seed=0,
                          deadline_ms=30_000.0, hedge_after_ms=1000.0))
    try:
        jeng.register("k", jnp.asarray(x), h=H, prewarm=False)
        want = np.asarray(jeng.query(JRequest(key="k", points=y)).value)
    finally:
        jeng.close()
    plain = ServeEngine(_cfg(method))
    plain.register("k", x, h=H)
    with mk_engine(method=method) as eng:
        eng.register("k", x, h=H, prewarm=False)
        got = eng.query(_req("k", y)).value
    assert_method_close(got, want, x, y, H, method)
    assert_method_close(got, plain.query(_req("k", y)).value, x, y, H,
                        method)
    assert_method_close(got, _f64(x, y, H, method), x, y, H, method)


# -- shard partitioning + certificates ----------------------------------------


def test_partition_clusters_covers_and_balances():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 8, 500)
    shard_of = spatial.partition_clusters(labels, 3)
    assert shard_of.shape == (8,) and shard_of.dtype == np.int32
    assert set(shard_of) == {0, 1, 2}           # no empty shard
    loads = np.bincount(shard_of[labels], minlength=3)
    assert loads.min() > 0 and loads.sum() == 500
    # a tensor of labels (any device) gives the same partition
    np.testing.assert_array_equal(
        spatial.partition_clusters(torch.as_tensor(labels), 3), shard_of)
    with pytest.raises(ValueError):
        spatial.partition_clusters(labels, 0)
    with pytest.raises(ValueError):
        spatial.partition_clusters(labels, 9)   # more shards than clusters


@pytest.mark.parametrize("case", ["iid", "ties", "empty_clusters", "skewed",
                                  "one_shard", "all_shards"])
def test_partition_clusters_bit_identical_to_repro(case):
    rng = np.random.default_rng(7)
    labels, shards = {
        "iid": (rng.integers(0, 45, 32768), 2),
        "ties": (np.repeat(np.arange(12), 50), 5),
        "empty_clusters": (rng.choice([0, 2, 3, 7, 9], 400), 4),
        "skewed": (np.minimum(rng.geometric(0.2, 5000), 30) - 1, 4),
        "one_shard": (rng.integers(0, 10, 300), 1),
        "all_shards": (rng.integers(0, 6, 300), 6),
    }[case]
    labels = labels.astype(np.int32)
    got = spatial.partition_clusters(labels, shards)
    want = jsp.partition_clusters(labels, shards)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_point_mass_bound_dominates_true_mass(data):
    x, pool = data
    pts = torch.as_tensor(x[:200])
    labels = spatial.build_index(pts, seed=0).labels.numpy()
    local = np.unique(labels, return_inverse=True)[1]
    layout = spatial.cluster_layout(pts, local, 64)
    meta = spatial.tile_metadata(layout.points, layout.real, block=64)
    h = 0.4
    y = torch.as_tensor(pool[:32])
    bound = spatial.point_mass_bound(y, meta, 1.0 / (2 * h * h)).double()
    d2 = ((y.double()[:, None, :] - pts.double()[None, :, :]) ** 2).sum(-1)
    true_mass = torch.exp(-d2 / (2 * h * h)).sum(1)
    assert bool((bound + 1e-9 >= true_mass).all())


# -- chaos survival -----------------------------------------------------------


def test_replica_kill_is_survived_exactly(data):
    x, pool = data
    chaos = ChaosConfig(events=(
        ChaosEvent("shard_kill", shard=0, replica=0),), seed=0)
    with mk_engine(chaos=chaos) as eng:
        table = eng.register("k", x, h=H, prewarm=False)
        for i in range(5):
            y = pool[8 * i:8 * i + 16]
            ans = eng.query(_req("k", y))
            assert not ans.degraded
            assert_close(ans.value, _f64(x, y, table.h))
        assert eng.stats["dropped"] == 0 and eng.stats["retries"] > 0
        assert eng.injector.snapshot()["shard_kill"] > 0


def test_nan_poison_never_reaches_caller(data):
    x, pool = data
    chaos = ChaosConfig(events=(
        ChaosEvent("nan_poison", shard=0, replica=0),), seed=0)
    with mk_engine(chaos=chaos) as eng:
        eng.register("k", x, h=H, prewarm=False)
        for i in range(4):
            ans = eng.query(_req("k", pool[8 * i:8 * i + 8]))
            assert bool(torch.isfinite(ans.value).all())
            assert not ans.degraded
        assert eng.stats["dropped"] == 0
        assert eng.injector.snapshot()["nan_poison"] > 0


def test_compile_fail_opens_breaker(data):
    x, pool = data
    chaos = ChaosConfig(events=(
        ChaosEvent("compile_fail", shard=0, replica=0),), seed=0)
    with mk_engine(chaos=chaos, breaker_threshold=2,
                   breaker_cooldown_s=3600.0) as eng:
        eng.register("k", x, h=H, prewarm=False)
        for _ in range(8):
            assert not eng.query(_req("k", pool[:8])).degraded
        states = eng.breaker_states()
        assert any(k.startswith("k/s0r0") and v == "open"
                   for k, v in states.items()), states
        # the sibling replica keeps the shard serving: zero drops
        assert eng.stats["dropped"] == 0


def test_hedge_wins_over_slow_replica(data):
    """Real time: the injector's slow_shard sleeps 300 ms on replica
    (0, 0) and the hedge fires after 20 ms.  An 8-row attempt on one
    shard replica takes 0.35 ms median, 0.62 ms at most over 50 calls, on
    this file's data on the CPU, so the 280 ms the hedge has to win in is
    over 400x it."""
    x, pool = data
    chaos = ChaosConfig(events=(
        ChaosEvent("slow_shard", shard=0, replica=0),),
        slow_ms=300.0, seed=0)
    with mk_engine(chaos=chaos, hedge_after_ms=20.0) as eng:
        table = eng.register("k", x, h=H)      # prewarmed
        for _ in range(6):
            ans = eng.query(_req("k", pool[:8]))
            assert not ans.degraded
            assert_close(ans.value, _f64(x, pool[:8], table.h))
        assert eng.stats["hedges"] > 0
        assert eng.stats["hedge_wins"] > 0
        assert eng.stats["dropped"] == 0


def test_real_bug_propagates_not_retried(data):
    x, _ = data
    with mk_engine() as eng:
        table = eng.register("k", x, h=H, prewarm=False)

        def boom(*a, **kw):
            raise ZeroDivisionError("real bug, not chaos")

        for r in range(table.n_replicas):
            table.engines[0][r].query = boom
        with pytest.raises(ZeroDivisionError, match="real bug"):
            eng.query(_req("k", np.zeros((4, D), np.float32)))
        assert eng.stats["retries"] == 0


# -- graceful degradation -----------------------------------------------------


def test_total_shard_loss_yields_certified_answer(data):
    x, pool = data
    chaos = ChaosConfig(events=(ChaosEvent("shard_kill", shard=1),), seed=0)
    with mk_engine(chaos=chaos, max_retries=1,
                   degraded_accuracy=10.0) as eng:
        table = eng.register("k", x, h=H, prewarm=False)
        y = pool[:16]
        ans = eng.query(_req("k", y))
        assert ans.degraded and ans.missing_shards == (1,)
        assert ans.live_shards == (0,)
        # the certificate must dominate the realized error, per query
        check_certificate(ans, _f64(x, y, table.h), x, y, table.h)
        assert ans.rel_err_bound == pytest.approx(ans.rel_err_bounds.max())
        # the caller asked for exactness -> typed refusal instead
        with pytest.raises(ServeError):
            eng.query(_req("k", y, allow_degraded=False))


def test_uncertifiable_degradation_is_refused(data):
    x, pool = data
    chaos = ChaosConfig(events=(ChaosEvent("shard_kill", shard=1),), seed=0)
    with mk_engine(chaos=chaos, max_retries=0,
                   degraded_accuracy=1e-6) as eng:
        eng.register("k", x, h=H, prewarm=False)
        with pytest.raises(Degraded) as ei:
            eng.query(_req("k", pool[:8]))
        assert ei.value.bound > ei.value.target == 1e-6
        assert eng.stats["dropped"] == 1


def _repro_labels(jtable):
    """The cluster labels ``repro``'s engine sharded by: its k-means is
    seeded by a JAX key, so clustering its fitted points again with the
    same seed gives the same index."""
    pts = np.asarray(jtable.rff_prep.points, np.float32)
    idx = jsp.build_index(jnp.asarray(pts), seed=0)
    return np.asarray(idx.labels), np.asarray(idx.centroids)


@pytest.fixture(scope="module")
def blobs():
    """Four tight blobs 10 apart (σ 0.5, 96 points each): k-means's four
    clusters, two whole blobs a shard, so rows near a live shard's blobs
    get a finite (two-sided too) certificate when the other is lost."""
    rng = np.random.default_rng(1)
    centres = np.array([[0, 0, 0], [10, 0, 0], [0, 10, 0], [10, 10, 0]],
                       np.float32)
    lab = np.repeat(np.arange(4), N // 4)
    return (centres[lab] + 0.5 * rng.standard_normal((N, D))).astype(
        np.float32)


@pytest.mark.parametrize("method", ["sdkde", "laplace"])
def test_degraded_answer_matches_repro_given_its_labels(blobs, method,
                                                        monkeypatch):
    """Degraded values and bounds depend on the partition: with repro's
    labels carried across (``convert.index_from_state``, injected through
    ``spatial.build_index``), the port's shards, certificates, partial
    sums and per-row bounds match repro's.  Laplace runs the two-sided
    bound.  Queries are shard 0's points moved by 0.1·N(0, 1)."""
    x = blobs
    jchaos = JChaosConfig(events=(JChaosEvent("shard_kill", shard=1),))
    jeng = JResilientEngine(
        JServeConfig(backend="jnp", method=method, min_batch=8,
                     max_batch=32),
        JResilienceConfig(shards=2, replicas=2, seed=0, max_retries=1,
                          degraded_accuracy=1e6, deadline_ms=30_000.0,
                          hedge_after_ms=1000.0), chaos=jchaos)
    try:
        jtable = jeng.register("k", jnp.asarray(x), h=H, prewarm=False)
        labels, centroids = _repro_labels(jtable)
        live = jsp.partition_clusters(labels, 2)[labels] == 0
        rng = np.random.default_rng(2)
        y = (x[live][rng.choice(int(live.sum()), 24, replace=False)]
             + 0.1 * rng.standard_normal((24, D))).astype(np.float32)
        jans = jeng.query(JRequest(key="k", points=y))
    finally:
        jeng.close()
    carried = convert.index_from_state(labels, centroids, device="cpu")
    monkeypatch.setattr(spatial, "build_index", lambda *a, **kw: carried)
    chaos = ChaosConfig(events=(ChaosEvent("shard_kill", shard=1),))
    with mk_engine(chaos=chaos, method=method, max_retries=1,
                   degraded_accuracy=1e6) as eng:
        table = eng.register("k", x, h=H, prewarm=False)
        ans = eng.query(_req("k", y))
    assert table.shard_n == jtable.shard_n
    assert jans.degraded and ans.degraded
    assert ans.missing_shards == jans.missing_shards == (1,)
    assert_method_close(ans.value, np.asarray(jans.value), x, y, H, method)
    jb = np.asarray(jans.rel_err_bounds, np.float64)
    assert np.isfinite(jb).all() and np.isfinite(ans.rel_err_bounds).all()
    np.testing.assert_allclose(ans.rel_err_bounds, jb, rtol=1e-4)
    check_certificate(ans, _f64(x, y, H, method), x, y, H, method)


def check_certificate(ans, oracle, x, y, h, method="sdkde"):
    """Every row: |f̂ − f| ≤ bound·|f| plus the f32 answer's own bar (the
    certificate bounds the exact partial sum; the answer carries its f32
    rounding on top: bar·|f̂| + 1e-6·peak, or the Laplace mass bar)."""
    got = ans.value.double().numpy()
    err = np.abs(got - oracle)
    slack = (laplace_mass_bar(x, y, h) if method == "laplace"
             else f32_bar(x, h) * np.abs(got) + 1e-6 * np.abs(oracle).max())
    assert (err <= ans.rel_err_bounds * np.abs(oracle) + slack).all()


# -- deadlines, shedding, typed errors ----------------------------------------


def test_deadline_exceeded_is_typed(data):
    x, pool = data
    with mk_engine() as eng:
        eng.register("k", x, h=H, prewarm=False)
        with pytest.raises(DeadlineExceeded):
            eng.query(_req("k", pool[:8], deadline_s=1e-9))
        assert isinstance(DeadlineExceeded("x"), TimeoutError)
        assert eng.stats["dropped"] == 1


def test_deadline_misses_trigger_tier_shedding(data):
    x, pool = data
    with mk_engine(shed_after_misses=2, shed_requests=3,
                   shed_accuracy=5e-2) as eng:
        eng.register("k", x, h=H, prewarm=False)
        eng.query(_req("k", pool[:8]))                 # healthy baseline
        for _ in range(2):
            with pytest.raises(DeadlineExceeded):
                eng.query(_req("k", pool[:8], deadline_s=1e-9))
        ans = eng.query(_req("k", pool[:8]))
        assert ans.shed and ans.tier == "bf16"         # ladder downgrade
        # an explicit precision overrides the shed tier
        assert eng.query(_req("k", pool[:8], precision="f32")).tier == "f32"
        # the episode ends after shed_requests
        eng.query(_req("k", pool[:8]))
        assert not eng.query(_req("k", pool[:8])).shed


def test_unknown_key_and_bad_request(data):
    x, _ = data
    with mk_engine() as eng:
        with pytest.raises(UnknownKey):
            eng.query(_req("nope", np.zeros((2, D), np.float32)))
        assert isinstance(UnknownKey("k"), KeyError)
        eng.register("k", x, h=H, prewarm=False)
        with pytest.raises(BadRequest):
            eng.query(_req("k", np.zeros((2, D + 1), np.float32)))
        with pytest.raises(BadRequest):
            eng.query(_req("k", np.zeros((0, D), np.float32)))
        with pytest.raises(BadRequest):
            eng.query("k")          # legacy-api-ok: refused, no shim


def test_overloaded_when_no_live_replica(data):
    x, pool = data
    chaos = ChaosConfig(events=(ChaosEvent("shard_kill"),), seed=0)
    with mk_engine(chaos=chaos, max_retries=0, allow_degraded=False) as eng:
        eng.register("k", x, h=H, prewarm=False)
        with pytest.raises(Overloaded):
            eng.query(_req("k", pool[:8]))


def test_fenced_but_alive_shard_served_as_last_resort(data):
    """Fencing is inferred from missed heartbeats, so a wrongly fenced
    (stalled but alive) shard is tried before answering degraded: the
    last-resort pass returns the exact answer."""
    x, pool = data
    with mk_engine() as eng:
        table = eng.register("k", x, h=H, prewarm=False)
        want = eng.query(_req("k", pool[:8])).value
        eng.supervisor.fence(range(table.n_replicas))   # all of shard 0
        ans = eng.query(_req("k", pool[:8]))
        torch.testing.assert_close(ans.value, want, rtol=1e-6, atol=0)
        assert not ans.degraded and ans.missing_shards == ()
        assert eng.stats["last_resort"] >= 1


# -- fault injector determinism -----------------------------------------------


def _drive(inj, requests: int = 40):
    fired = []
    for _ in range(requests):
        inj.begin_request()
        for s in range(2):
            for r in range(2):
                with inj.scope(s, r):
                    try:
                        inj.fire("serve.dispatch", key="k")
                        fired.append(0)
                    except Exception:
                        fired.append(1)
    return fired, inj.snapshot()


def test_injector_is_deterministic_in_seed_and_fires_as_repro():
    cfg = ChaosConfig(seed=7, shard_kill=0.3)
    f1, s1 = _drive(FaultInjector(cfg))
    f2, s2 = _drive(FaultInjector(cfg))
    assert f1 == f2 and s1 == s2 and s1["shard_kill"] > 0
    f3, _ = _drive(FaultInjector(ChaosConfig(seed=8, shard_kill=0.3)))
    assert f3 != f1                     # the seed actually matters
    fj, sj = _drive(JFaultInjector(JChaosConfig(seed=7, shard_kill=0.3)))
    assert fj == f1 and sj == s1        # the same draws as repro's


# -- the chaos soak, short and deterministic ----------------------------------


def test_chaos_soak_kill_recovery_arc(data):
    """``repro``'s chaos soak (benchmarks/chaos_soak.py) as a test: a
    sustained kill of replica (0, 0) over the middle third of 36 requests
    paced 0.1 s apart on the fake clock, heartbeat timeout 0.5 s, a probe
    every 4 requests.  Every answer is exact, nothing is dropped, the
    killed replica is fenced during the window and re-admitted after it.
    Then the degraded cell: shard 1 lost, every answer's certificate
    dominates its realized error and stays within the 10.0 target."""
    x, pool = data
    clock = FakeClock()
    requests = 36
    lo, hi = requests // 3, 2 * requests // 3
    chaos = ChaosConfig(events=(ChaosEvent(
        "shard_kill", shard=0, replica=0, start=lo, stop=hi),), seed=0)
    rng = np.random.default_rng(0)
    sizes = np.exp(rng.uniform(0, np.log(32), requests)).astype(int).clip(1)
    with mk_engine(chaos=chaos, clock=clock, heartbeat_timeout_s=0.5,
                   probe_every=4) as eng:
        table = eng.register("k", x, h=H)
        fenced_in_window = False
        for i, m in enumerate(sizes):
            off = int(rng.integers(0, pool.shape[0] - m))
            y = pool[off:off + m]
            ans = eng.query(_req("k", y))
            assert not ans.degraded
            assert_close(ans.value, _f64(x, y, table.h))
            fenced_in_window |= lo <= i < hi and 0 in eng.supervisor.fenced()
            clock.sleep(0.1)
        assert eng.stats["dropped"] == 0 and eng.stats["retries"] > 0
        assert fenced_in_window and eng.stats["fenced"] >= 1
        assert eng.stats["readmits"] >= 1 and eng.supervisor.fenced() == []
    chaos = ChaosConfig(events=(ChaosEvent("shard_kill", shard=1),), seed=0)
    with mk_engine(chaos=chaos, max_retries=1,
                   degraded_accuracy=10.0) as eng:
        table = eng.register("k", x, h=H, prewarm=False)
        for i in range(3):
            y = pool[16 * i:16 * i + 32]
            ans = eng.query(_req("k", y))
            assert ans.degraded and ans.missing_shards == (1,)
            check_certificate(ans, _f64(x, y, table.h), x, y, table.h)
            assert ans.rel_err_bound <= 10.0


# -- the pre-shard cascade -----------------------------------------------------


def test_rff_pin_answers_before_any_shard(data):
    """``precision="rff"`` answers from the full-set RFF tier: no shard
    is dispatched, the band comes back as each row's bound; an accuracy
    target escalates only the rows whose band misses it."""
    x, pool = data
    cfg = _cfg("sdkde", rff="on", rff_features=512, rff_pilot=16)
    clock = FakeClock()
    with ResilientEngine(cfg, ResilienceConfig(hedge_after_ms=1000.0),
                         clock=clock, sleep=clock.sleep) as eng:
        table = eng.register("k", x, h=H, prewarm=False)
        for row in table.engines:
            for e in row:
                e.query = None                  # any dispatch would fail
        ans = eng.query(_req("k", pool[:16], precision="rff"))
        assert ans.path == ("rff",) and ans.rff_hits == 16
        assert ans.escalated == 0 and ans.live_shards == ()
    with ResilientEngine(cfg, ResilienceConfig(hedge_after_ms=1000.0),
                         clock=clock, sleep=clock.sleep) as eng:
        eng.register("k", x, h=H, prewarm=False)
        ans = eng.query(_req("k", pool[:16], accuracy_target=1e-12))
        assert ans.path == ("rff", "f32") and ans.escalated == 16
        assert_close(ans.value, _f64(x, pool[:16], H))
        assert (ans.rel_err_bounds == 1e-5).all()


def test_streaming_config_is_refused():
    with pytest.raises(ValueError, match="stream"):
        ResilientEngine(_cfg(stream=True))


# -- the launcher --------------------------------------------------------------


@pytest.mark.parametrize("method", ["sdkde", "laplace"])
def test_launcher_survives_a_replica_kill_and_verifies(method, capsys):
    """``python -m repro_torch.launch.serve_kde --shards 2 --replicas 2
    --chaos shard_kill --verify`` on the CPU: zero drops and the answer
    after the traffic matches float64.  Real clock: the 5 s request
    deadline is over 1000x a request's CPU time here (~2 ms)."""
    from repro_torch.launch import serve_kde

    rc = serve_kde.main([
        "--device", "cpu", "--method", method, "--n", "1024", "--d", "3",
        "--requests", "12", "--max-batch", "32", "--min-batch", "8",
        "--block-m", "8", "--block-n", "64", "--shards", "2",
        "--replicas", "2", "--chaos", "shard_kill", "--verify"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "dropped=0" in out and "'shard_kill': 0" not in out
    assert "verify: resilient path matches" in out
