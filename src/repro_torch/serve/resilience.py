"""Resilient dispatch: replicated shards, deadlines, hedging, degradation.

The counterpart of ``repro.serve.resilience``.  A ``ServeEngine`` is one
synchronous process: one dead device, one broken bucket callable, one NaN
and the request is gone.  This layer puts a dispatch policy in front of it
without touching the math.

**Sharding.**  ``register`` runs the expensive fit ONCE on the full set
(for sd-kde the O(n²·d) debias: each point's score shift depends on every
other point, so sharding before the debias would change the estimator),
through the config's backend (on the card, kernel B1, or B3 when ``prune``
engages).  It then k-means-partitions the fitted points
(``spatial.build_index``): whole clusters go to shards
(``spatial.partition_clusters``), so each shard is a self-contained
cluster-aligned tile set with its own ``TileMeta``, the certificate that
bounds what a *missing* shard would have added.  Each of the S shards is
served by R independent ``ServeEngine`` replicas (own registry, own
bucket-callable cache), each serving its shard as a plain KDE of the
already-debiased points (B2, B4 where ``prune`` engages for the shard, B5
or B4's Laplace flag for ``method="laplace"``).  Density is linear in the
points' contributions, so the exact answer recombines as
``Σ_s (n_s / n_tot) · dens_s``, in f32 on the device, in shard order.

**Dispatch policy**, per shard, inside a per-request deadline:

  * retry with exponential backoff and deterministic jitter, rotating
    across replicas;
  * hedged dispatch: when the p99-informed hedge timer expires before the
    primary answers, a duplicate fires at another replica and the first
    success wins;
  * a circuit breaker per (shard, replica, bucket) that opens after
    repeated failures (a broken bucket callable included) and routes
    around it until a cooldown probe closes it;
  * the NaN guard: a non-finite result is a failure (retried), never an
    answer; it reads the result's finiteness to the host once an attempt;
  * health: every successful attempt heartbeats a ``distributed.fault``
    ``Supervisor`` host (host = shard·R + replica); hosts past the
    heartbeat timeout are fenced through ``restart_plan(fence=True)``, the
    routing table shrinks ``elastic.plan_mesh``-style, and periodic probes
    re-admit recovered replicas.  A shard with every replica fenced is
    tried once more on them before it is given up (fencing is inferred).

Replicas run on a thread pool.  The kernels launch on the calling
thread's current CUDA stream, which for every worker is the device's
default stream, so hedges and retries are ordered by the stream and share
no memory across streams.  An engine is not reentrant: a per-engine lock
makes a replica still busy with an abandoned attempt fail fast.  The fault
injector's ``scope(shard, replica)`` is entered inside the worker thread.

**Graceful degradation.**  When every replica of some shard is gone and
the deadline still stands, the surviving shards' partial sum is
renormalized into an estimate with a certified relative-error bound from
the missing shards' tile metadata (``spatial.point_mass_bound``), in
float64 on the host: the true density lies in ``[S_live − U⁻, S_live +
U] / (n_tot·c)`` with ``U`` the per-query missing-mass bound (two-sided
for Laplace).  The answer is returned only when the bound clears
``degraded_accuracy``; otherwise the caller gets a typed ``Degraded``.
Under repeated deadline misses the engine sheds load by serving unpinned
requests at the cheapest tier of the planner's ladder (``TIER_ORDER``)
whose rtol fits ``shed_accuracy``.

A request with an accuracy target first meets the RFF fast tier fitted on
the FULL debiased set (the cascade answers whole rows before any shard is
touched); only escalated rows fan out.  The band is read to the host once.

Every decision is counted under ``resilience.*`` (``repro``'s names):
requests, retries, hedges fired and won, breaker transitions, attempt
failures by kind, fenced / readmitted hosts and probes, shed and degraded
requests, drops by reason.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import fault_injection, obs
from repro_torch.core.bandwidth import gaussian_norm_const
from repro_torch.distributed import elastic
from repro_torch.distributed.fault import Supervisor
from repro_torch.fault_injection import ChaosConfig, FaultInjector, InjectedFailure
from repro_torch.kernels import spatial
from repro_torch.obs.metrics import Histogram
from repro_torch.plan.planner import TIER_ORDER, TIER_RTOL
from repro_torch.serve import cascade
from repro_torch.serve.api import RFF_TIER, Answer, QueryRequest
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.errors import (BadRequest, DeadlineExceeded, Degraded,
                                      Overloaded, UnknownKey)
from repro_torch.serve.registry import EstimatorRegistry, PreparedEstimator
from repro_torch.serve.stats import LatencyRecorder


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Dispatch policy of the resilient layer (the math lives in
    ``ServeConfig``; this only decides where and when to run it)."""

    shards: int = 2              # S self-contained cluster groups
    replicas: int = 2            # R independent engines per shard
    deadline_ms: float = 5000.0  # default per-request deadline
    max_retries: int = 3         # per shard, within the deadline
    backoff_ms: float = 5.0
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.5  # ± fraction of the backoff step
    hedge_after_ms: Optional[float] = None   # None → p99-informed
    hedge_p99_factor: float = 2.0
    hedge_min_ms: float = 25.0
    breaker_threshold: int = 3   # consecutive failures before OPEN
    breaker_cooldown_s: float = 1.0
    heartbeat_timeout_s: float = 2.0
    probe_every: int = 16        # requests between fenced-host probes
    allow_degraded: bool = True
    degraded_accuracy: float = 0.5   # certified rel-err budget, degraded
    shed_after_misses: int = 3   # deadline misses before tier shedding
    shed_requests: int = 16      # how long a shed episode lasts
    shed_accuracy: float = 5e-2  # ladder budget while shedding (→ bf16)
    meta_block: int = 128        # certificate tile rows per shard
    seed: int = 0

    def __post_init__(self):
        if self.shards < 1 or self.replicas < 1:
            raise ValueError(
                f"need shards >= 1 and replicas >= 1, got "
                f"{self.shards}x{self.replicas}")
        for name in ("deadline_ms", "backoff_ms", "hedge_min_ms",
                     "breaker_cooldown_s", "heartbeat_timeout_s",
                     "degraded_accuracy", "shed_accuracy", "meta_block"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")
        if self.max_retries < 0 or self.breaker_threshold < 1:
            raise ValueError("max_retries >= 0, breaker_threshold >= 1")


class CircuitBreaker:
    """CLOSED → (threshold failures) → OPEN → (cooldown) → HALF_OPEN →
    one probe → CLOSED or back to OPEN."""

    def __init__(self, threshold: int, cooldown_s: float,
                 clock: Callable[[], float]):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.state = "closed"
        self.failures = 0
        self.opened_at = 0.0
        self._lock = threading.Lock()

    def allow(self) -> bool:
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if self.clock() - self.opened_at >= self.cooldown_s:
                    self._transition("half_open")
                    return True          # this caller is the probe
                return False
            return False                 # half_open: probe already out

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            if self.state != "closed":
                self._transition("closed")

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == "half_open" or (
                    self.state == "closed"
                    and self.failures >= self.threshold):
                self._transition("open")
                self.opened_at = self.clock()

    def _transition(self, to: str) -> None:
        self.state = to
        obs.counter("resilience.breaker_transitions",
                    "circuit breaker state changes",
                    labels={"to": to}).inc()


class _ReplicaBusy(RuntimeError):
    """A replica engine was still busy with an abandoned dispatch."""


@dataclasses.dataclass
class _ShardTable:
    """One registered dataset, sharded and replicated."""

    key: str
    h: float
    d: int
    n_tot: int
    kind: str                            # bound kind: kde | laplace
    norm_c: float                        # (2π)^{d/2}·h^d per-point normalizer
    shard_n: List[int]                   # real points per shard
    shard_meta: List[spatial.TileMeta]   # per-shard certificate geometry
    engines: List[List[ServeEngine]]     # [shard][replica]
    skeys: List[str]
    # the full-set fit: its RFF tier (fitted lazily under rff="auto")
    # serves the pre-shard cascade, and holding the registry keeps the
    # debiased full set alive for that fit
    rff_prep: Optional[PreparedEstimator] = None
    rff_reg: Optional[EstimatorRegistry] = None

    @property
    def n_shards(self) -> int:
        return len(self.engines)

    @property
    def n_replicas(self) -> int:
        return len(self.engines[0])


class ResilientEngine:
    """Replicated-shard front end over ``ServeEngine`` (see module doc).

    ``clock`` and ``sleep`` drive deadlines, backoff, breaker cooldowns
    and heartbeats; tests pass their own to run without the wall clock.
    """

    def __init__(
        self,
        config: ServeConfig | None = None,
        resilience: ResilienceConfig | None = None,
        *,
        chaos: ChaosConfig | None = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        config = config or ServeConfig()
        if config.backend == "ring" or config.stream:
            raise ValueError(
                "ResilientEngine replicates static flash/torch engines; "
                "ring sharding and streaming estimators are their own "
                "distribution stories")
        self.config = config
        self.device = device_mod.resolve(config.device)
        self.rcfg = resilience or ResilienceConfig()
        self._clock = clock
        self._sleep = sleep
        self.injector: Optional[FaultInjector] = (
            fault_injection.install(FaultInjector(chaos))
            if chaos is not None else None)
        self._tables: Dict[str, _ShardTable] = {}
        self.supervisor: Optional[Supervisor] = None
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * self.rcfg.shards),
            thread_name_prefix="resilient-serve")
        self._breakers: Dict[tuple, CircuitBreaker] = {}
        self._eng_locks: Dict[tuple, threading.Lock] = {}
        self._requests = 0
        self._miss_streak = 0
        self._shed_left = 0
        self.latency = LatencyRecorder()
        self._attempt_hist = Histogram("resilience.attempt_s",
                                       lo=1e-5, hi=1e3)
        self.stats: Dict[str, int] = {
            k: 0 for k in ("requests", "dropped", "degraded", "shed",
                           "retries", "hedges", "hedge_wins", "probes",
                           "readmits", "fenced", "last_resort")}
        self.service_plan: Optional[elastic.MeshPlan] = None
        self._lock = threading.Lock()

    # -- fit path ---------------------------------------------------------

    def register(self, key: str, x, h: Optional[float] = None, *,
                 prewarm: bool = True) -> _ShardTable:
        """Fit once on the full set, then shard and replicate (see the
        module doc for why the debias comes before the split).  With
        ``prewarm`` every replica builds its largest bucket here, so no
        kernel build or tile probe runs inside a request's deadline."""
        cfg = self.config
        # the one O(n²·d) fit, through the config's backend (the kernels
        # on the card); it also carries the full-set RFF tier
        fit_reg = EstimatorRegistry(dataclasses.replace(
            cfg, stream=False, plan="off"))
        prep = fit_reg.fit(key, x, h)
        points = prep.points
        n, d = points.shape

        index = spatial.build_index(points, seed=self.rcfg.seed)
        labels = index.labels.cpu().numpy()
        n_clusters = int(labels.max()) + 1
        S = min(self.rcfg.shards, n_clusters)
        R = self.rcfg.replicas
        shard_of = spatial.partition_clusters(labels, S)
        point_shard = shard_of[labels]

        # each shard serves its slice of the ALREADY-debiased points, so
        # sdkde becomes a plain kde there and recombination is exact by
        # linearity; the shards are always asked for an exact tier, so
        # they carry no RFF tier of their own
        shard_cfg = dataclasses.replace(
            cfg, method="kde" if cfg.method == "sdkde" else cfg.method,
            precision=cfg.exact_precision, rff="off", stream=False,
            plan="off")
        kind = "laplace" if cfg.method == "laplace" else "kde"

        engines: List[List[ServeEngine]] = []
        shard_n: List[int] = []
        shard_meta: List[spatial.TileMeta] = []
        skeys: List[str] = []
        block = self.rcfg.meta_block
        for s in range(S):
            mask = point_shard == s
            pts = points.index_select(
                0, spatial.upload(np.flatnonzero(mask), points.device))
            shard_n.append(int(pts.shape[0]))
            skeys.append(f"{key}::s{s}")
            # certificate geometry: the shard's own cluster-aligned tile
            # set (a local relabel keeps the layout dense)
            local = np.unique(labels[mask], return_inverse=True)[1]
            layout = spatial.cluster_layout(pts, local, block)
            shard_meta.append(spatial.tile_metadata(
                layout.points, layout.real, block=block))
            row = []
            for _ in range(R):
                eng = ServeEngine(shard_cfg)
                eng.register(skeys[s], pts, h=prep.h, prewarm=False)
                row.append(eng)
            engines.append(row)

        table = _ShardTable(
            key=key, h=prep.h, d=d, n_tot=n, kind=kind,
            norm_c=gaussian_norm_const(d, 1.0) * prep.h ** d,
            shard_n=shard_n, shard_meta=shard_meta, engines=engines,
            skeys=skeys, rff_prep=prep, rff_reg=fit_reg)
        self._tables[key] = table
        if self.supervisor is None:
            self.supervisor = Supervisor(
                S * R, timeout=self.rcfg.heartbeat_timeout_s,
                clock=self._clock)
        if prewarm:
            for s in range(S):
                for r in range(R):
                    engines[s][r].prewarm(skeys[s])
        # registration is proof of life: without an initial beat, a slow
        # prewarm outlives the heartbeat timeout and the first query
        # finds every host already fenced
        for hid in range(S * R):
            self.supervisor.beat(hid, 0)
        obs.counter("resilience.registered",
                    "datasets sharded for resilient serving").inc()
        return table

    # -- query path -------------------------------------------------------

    def query(self, req: QueryRequest) -> Answer:
        """Densities for one request under the full dispatch policy.

        ``deadline_s`` is relative seconds (default
        ``deadline_ms``); ``accuracy_target`` (or the config's) engages
        the pre-shard RFF cascade, whose escalated rows alone fan out to
        the shards; ``allow_degraded`` overrides the engine's default.
        Degraded answers compose per row: fast-tier rows keep their band,
        escalated rows carry the degraded certificate.
        """
        if not isinstance(req, QueryRequest):
            raise BadRequest("query takes a QueryRequest")
        table = self._tables.get(req.key)
        if table is None:
            raise UnknownKey(
                f"estimator {req.key!r} not registered with the resilient "
                f"engine (have {list(self._tables)})")
        y = torch.atleast_2d(torch.as_tensor(
            req.points, dtype=torch.float32, device=self.device))
        if y.ndim != 2 or y.shape[0] == 0 or y.shape[-1] != table.d:
            raise BadRequest(
                f"query batch {tuple(y.shape)} does not match registered "
                f"dimensionality d={table.d} (or is empty)")
        allow_degraded = (req.allow_degraded
                          if req.allow_degraded is not None
                          else self.rcfg.allow_degraded)
        if self.injector is not None:
            self.injector.begin_request()
        with self._lock:
            self._requests += 1
            req_no = self._requests
            shed = self._shed_left > 0
            if shed:
                self._shed_left -= 1
        pin = req.precision
        tier = pin or self.config.precision
        if shed and pin is None:
            tier = _cheapest_tier(self.rcfg.shed_accuracy)
            self.stats["shed"] += 1
            obs.counter("resilience.shed",
                        "requests served at a downgraded tier").inc()
        t0 = self._clock()
        deadline = t0 + (req.deadline_s if req.deadline_s is not None
                         else self.rcfg.deadline_ms / 1e3)
        self._refresh_health(table)
        self._maybe_probe(table, req_no)

        target = (req.accuracy_target if req.accuracy_target is not None
                  else self.config.accuracy_target)
        m = int(y.shape[0])
        pinned = tier == RFF_TIER
        p = band = None
        esc = np.ones(m, bool)
        if pinned or (pin is None and target is not None):
            serving = self._rff_serving(table)
            if serving is None and pinned:
                raise BadRequest(
                    f"precision='rff' pinned but the RFF tier is "
                    f"unavailable for method={self.config.method!r} "
                    f"(rff={self.config.rff!r})")
            if serving is not None:
                p, band_dev = cascade.evaluate(self.config, serving, y)
                band = band_dev.to(torch.float64).cpu().numpy()  # one read
                esc = np.zeros(m, bool) if pinned else band > target
                obs.counter("serve.cascade_hits",
                            "query rows answered at the RFF fast "
                            "tier").inc(int(m - esc.sum()))
                if esc.any():
                    obs.counter("serve.cascade_escalations",
                                "query rows escalated to the exact "
                                "tier").inc(int(esc.sum()))
        exact_tier = self.config.exact_precision if pinned else tier

        counters = {"retries": 0, "hedges": 0, "hedge_wins": 0}
        sub = None
        idx = np.flatnonzero(esc)
        rows = None
        sp = obs.span("resilience.request", key=req.key, rows=m,
                      tier=tier, shed=shed)
        with sp:
            if p is not None:
                sp.set(cascade=True, hits=int(m - esc.sum()))
            if esc.any():
                if not esc.all():
                    rows = spatial.upload(idx, y.device)
                y_esc = y if rows is None else y.index_select(0, rows)
                sub = self._dispatch_shards(table, y_esc, exact_tier,
                                            deadline, t0, shed,
                                            allow_degraded, counters, sp)
            else:
                # the whole batch resolved at the fast tier: no shard was
                # touched, but the request still counts as served
                self.stats["requests"] += 1
                obs.counter("resilience.requests",
                            "resilient requests").inc()
                self._note_done(t0, m, deadline_hit=False)

        if p is None:
            sub.latency_s = self._clock() - t0
            return sub
        value = p.to(torch.float32)
        bounds = band.copy()
        if sub is not None:
            sv = sub.value.to(torch.float32)
            value = sv if rows is None else value.index_copy(0, rows, sv)
            bounds[idx] = (sub.rel_err_bounds if sub.degraded
                           else cascade.exact_bound(exact_tier,
                                                    self.config.prune))
        path = (RFF_TIER,) if sub is None else (RFF_TIER, exact_tier)
        return Answer(
            value=value, key=req.key, tier=path[-1], path=path,
            rel_err_bound=float(bounds.max()), rel_err_bounds=bounds,
            rff_hits=int(m - esc.sum()), escalated=int(esc.sum()),
            degraded=sub.degraded if sub is not None else False,
            shed=shed,
            live_shards=sub.live_shards if sub is not None else (),
            missing_shards=sub.missing_shards if sub is not None else (),
            retries=counters["retries"], hedges=counters["hedges"],
            hedge_wins=counters["hedge_wins"],
            latency_s=self._clock() - t0)

    def _rff_serving(self, table: _ShardTable):
        """The full-set RFF serving tensors, or None when the tier is off
        or unsupported (the registry fits it lazily)."""
        if table.rff_prep is None or table.rff_prep.rff is None:
            return None
        return table.rff_reg.rff_serving(table.rff_prep)

    def _dispatch_shards(self, table: _ShardTable, y: torch.Tensor,
                         tier: str, deadline: float, t0: float, shed: bool,
                         allow_degraded: bool, counters, sp) -> Answer:
        """Fan the (sub)batch out to every shard under the dispatch
        policy; recombine, or certify a degraded partial answer.  Raises
        the typed errors when neither is possible."""
        m = int(y.shape[0])
        results: List[Optional[torch.Tensor]] = [
            self._shard_query(table, s, y, deadline, tier, counters)
            for s in range(table.n_shards)]
        missing = tuple(s for s, r in enumerate(results) if r is None)
        live = tuple(s for s, r in enumerate(results) if r is not None)
        sp.set(missing=len(missing), retries=counters["retries"],
               hedges=counters["hedges"])
        self.stats["requests"] += 1
        self.stats["retries"] += counters["retries"]
        self.stats["hedges"] += counters["hedges"]
        self.stats["hedge_wins"] += counters["hedge_wins"]
        obs.counter("resilience.requests", "resilient requests").inc()
        if counters["retries"]:
            obs.counter("resilience.retries",
                        "shard dispatch retries").inc(counters["retries"])

        if not missing:
            dens = sum((table.shard_n[s] / table.n_tot) * results[s]
                       for s in live)
            self._note_done(t0, m, deadline_hit=False)
            b = cascade.exact_bound(tier, self.config.prune)
            return Answer(
                value=dens, key=table.key, tier=tier, path=(tier,),
                rel_err_bound=b, rel_err_bounds=np.full(m, b),
                shed=shed, live_shards=live,
                latency_s=self._clock() - t0, **counters)

        if live and allow_degraded:
            ans = self._degraded_answer(table, y, results, live, missing,
                                        tier, shed, counters)
            ans.latency_s = self._clock() - t0
            sp.set(degraded=True, rel_err_bound=ans.rel_err_bound)
            if ans.rel_err_bound <= self.rcfg.degraded_accuracy:
                self.stats["degraded"] += 1
                obs.counter("resilience.degraded",
                            "certified partial-shard answers").inc()
                obs.histogram("resilience.degraded_bound",
                              "certified rel-err bound of degraded "
                              "answers", lo=1e-6, hi=1e2).observe(
                    max(ans.rel_err_bound, 1e-6))
                self._note_done(t0, m, deadline_hit=False)
                return ans
            self._drop("degraded_uncertifiable")
            raise Degraded(
                f"partial answer from shards {live} has certified "
                f"rel-err bound {ans.rel_err_bound:.3g} > target "
                f"{self.rcfg.degraded_accuracy:.3g}",
                bound=ans.rel_err_bound, target=self.rcfg.degraded_accuracy)

        timed_out = self._clock() >= deadline
        self._note_done(t0, m, deadline_hit=timed_out)
        self._drop("deadline" if timed_out else "no_live_shards")
        if timed_out:
            raise DeadlineExceeded(
                f"deadline expired with shards {missing} unanswered "
                f"(retries={counters['retries']})")
        raise Overloaded(
            f"no live replica for shards {missing} "
            f"(fenced={self.supervisor.fenced()})")

    # -- per-shard dispatch ----------------------------------------------

    def _bucket(self, table: _ShardTable, s: int, m: int) -> int:
        """The shape bucket a shard's replicas serve ``m`` rows at (part
        of the breaker key: a broken bucket callable is routed around)."""
        eng = table.engines[s][0]
        return eng.config.bucket_for(
            m, eng.registry.get(table.skeys[s]).block_m)

    def _shard_query(self, table: _ShardTable, s: int, y: torch.Tensor,
                     deadline: float, tier: str,
                     counters) -> Optional[torch.Tensor]:
        rcfg = self.rcfg
        bucket = self._bucket(table, s, int(y.shape[0]))
        backoff = rcfg.backoff_ms / 1e3
        for attempt in range(rcfg.max_retries + 1):
            if self._clock() >= deadline:
                return None
            cands = self._candidates(table, s, bucket, attempt)
            if not cands:
                # every replica is fenced (or breaker-open).  Fencing is
                # inferred from missed heartbeats, and a degraded answer
                # is strictly worse than an exact one, so the fenced
                # replicas are tried as a last resort first
                cands = self._candidates(table, s, bucket, attempt,
                                         include_fenced=True)
                if cands:
                    self.stats["last_resort"] += 1
                    obs.counter(
                        "resilience.last_resort",
                        "dispatches to fenced replicas after every live "
                        "candidate was exhausted").inc()
            if not cands:
                return None
            dens = self._race(table, s, cands, y, deadline, tier, bucket,
                              counters)
            if dens is not None:
                return dens
            counters["retries"] += 1
            if attempt < rcfg.max_retries:
                # deterministic jitter: a herd of retries must not
                # re-synchronize, but a replayed chaos run must
                u = float(np.random.default_rng(
                    (rcfg.seed, self._requests, s, attempt)).random())
                step = backoff * (1.0 + rcfg.backoff_jitter * (2 * u - 1))
                self._sleep(min(step, max(deadline - self._clock(), 0.0)))
                backoff *= rcfg.backoff_factor
        return None

    def _candidates(self, table: _ShardTable, s: int, bucket: int,
                    attempt: int, *,
                    include_fenced: bool = False) -> List[int]:
        """Live, breaker-admitted replicas of shard ``s``, primary first
        (the primary rotates per request, so every replica sees traffic);
        with ``include_fenced`` the fenced ones too, still breaker-gated."""
        R = table.n_replicas
        out = []
        for r in ((r + self._requests + s + attempt) % R for r in range(R)):
            if self.supervisor.hosts[s * R + r].fenced and not include_fenced:
                continue
            if self._breaker(table.key, s, r, bucket).allow():
                out.append(r)
        return out

    def _race(self, table: _ShardTable, s: int, cands: List[int],
              y: torch.Tensor, deadline: float, tier: str, bucket: int,
              counters) -> Optional[torch.Tensor]:
        """One hedged round: the primary, then a duplicate when the hedge
        timer expires; the first finite success wins."""
        futures = {self._pool.submit(self._attempt, table, s, cands[0], y,
                                     tier, deadline): cands[0]}
        if len(cands) > 1:
            timer = min(self._hedge_timer(),
                        max(deadline - self._clock(), 0.0))
            done, _ = wait(list(futures), timeout=timer)
            if not done:
                counters["hedges"] += 1
                obs.counter("resilience.hedges",
                            "hedged duplicate dispatches fired").inc()
                futures[self._pool.submit(
                    self._attempt, table, s, cands[1], y, tier,
                    deadline)] = cands[1]
        remaining = set(futures)
        while remaining:
            budget = deadline - self._clock()
            if budget <= 0:
                break
            done, _ = wait(remaining, timeout=budget,
                           return_when=FIRST_COMPLETED)
            if not done:
                break
            for f in done:
                remaining.discard(f)
                r = futures[f]
                br = self._breaker(table.key, s, r, bucket)
                err = f.exception()
                if err is not None:
                    if not isinstance(err, (InjectedFailure, _ReplicaBusy)):
                        self._abandon(futures, remaining, table, s, bucket)
                        raise err        # a real bug is not chaos
                    br.record_failure()
                    obs.counter(
                        "resilience.attempt_failures",
                        "failed shard dispatch attempts",
                        labels={"kind": getattr(err, "kind", "busy")}).inc()
                    continue
                t_attempt, dens = f.result()
                if not bool(torch.isfinite(dens).all()):   # the NaN guard
                    br.record_failure()
                    obs.counter("resilience.attempt_failures",
                                "failed shard dispatch attempts",
                                labels={"kind": "nan"}).inc()
                    continue
                br.record_success()
                self.supervisor.beat(s * table.n_replicas + r,
                                     self._requests)
                self._attempt_hist.observe(t_attempt)
                if r != cands[0]:
                    counters["hedge_wins"] += 1
                    obs.counter("resilience.hedge_wins",
                                "hedged duplicates that answered "
                                "first").inc()
                self._abandon(futures, remaining, table, s, bucket)
                return dens
        self._abandon(futures, remaining, table, s, bucket)
        return None

    def _abandon(self, futures, remaining, table, s: int, bucket) -> None:
        """Liveness bookkeeping for attempts a race leaves behind: a lost
        hedge that still completes proves its replica alive (beat and
        breaker close); without this, replicas that keep losing races
        decay into fenced state while healthy."""
        for f in remaining:
            r = futures[f]
            f.add_done_callback(
                lambda fut, r=r: self._absorb(table, s, r, bucket, fut))

    def _absorb(self, table, s: int, r: int, bucket, f) -> None:
        err = f.exception()
        br = self._breaker(table.key, s, r, bucket)
        if err is not None:
            if isinstance(err, (InjectedFailure, _ReplicaBusy)):
                br.record_failure()
            else:
                # a callback cannot re-raise: count real bugs on
                # abandoned attempts instead of swallowing them silently
                obs.counter("resilience.abandoned_errors",
                            "non-chaos exceptions on abandoned attempts",
                            labels={"type": type(err).__name__}).inc()
            return
        t_attempt, dens = f.result()
        if bool(torch.isfinite(dens).all()):
            br.record_success()
            self.supervisor.beat(s * table.n_replicas + r, self._requests)
            self._attempt_hist.observe(t_attempt)

    def _attempt(self, table, s: int, r: int, y: torch.Tensor, tier: str,
                 deadline: float):
        """One dispatch on replica engine (s, r), in this worker thread's
        injection scope.  The per-engine lock serializes against abandoned
        earlier attempts (``ServeEngine`` is not reentrant): failing fast
        as busy beats corrupting a bucket cache."""
        lock = self._eng_lock(table.key, s, r)
        budget = max(deadline - self._clock(), 0.0)
        if not lock.acquire(timeout=budget if budget > 0 else 0.001):
            raise _ReplicaBusy(f"replica ({s},{r}) busy past deadline")
        try:
            t0 = self._clock()
            ctx = (self.injector.scope(s, r) if self.injector is not None
                   else contextlib.nullcontext())
            with ctx:
                dens = table.engines[s][r].query(QueryRequest(
                    key=table.skeys[s], points=y, precision=tier)).value
            return self._clock() - t0, dens
        finally:
            lock.release()

    def _hedge_timer(self) -> float:
        rcfg = self.rcfg
        if rcfg.hedge_after_ms is not None:
            return rcfg.hedge_after_ms / 1e3
        if self._attempt_hist.count >= 16:
            return max(rcfg.hedge_min_ms / 1e3,
                       rcfg.hedge_p99_factor
                       * self._attempt_hist.quantile(0.99))
        return rcfg.hedge_min_ms / 1e3

    # -- degradation ------------------------------------------------------

    def _degraded_answer(self, table, y, results, live, missing, tier,
                         shed, counters) -> Answer:
        """Renormalized partial sum with a certified relative-error bound,
        in float64 on the host.

        With c = (2π)^{d/2}h^d, S = Σ_live n_s·dens_s·c the live mass and
        U(y) the bound on what the missing shards could add
        (``spatial.point_mass_bound``; two-sided for Laplace), the true
        density lies in [lo, hi] = [S − U⁻, S + U] / (n_tot·c).  The
        estimate is f̂ = S / (n_live·c); its relative error against any f
        in [lo, hi] is largest at an endpoint, and that is the bound (∞
        where lo ≤ 0: an uncertifiable query)."""
        n_live = sum(table.shard_n[s] for s in live)
        sums_live = sum(
            float(table.shard_n[s]) * results[s].to(torch.float64).cpu()
            .numpy() for s in live)               # Σ n_s·dens_s per query
        f_hat = sums_live / n_live
        inv2h2 = 1.0 / (2.0 * table.h * table.h)
        u = np.zeros_like(f_hat)
        for s in missing:
            u += spatial.point_mass_bound(
                y, table.shard_meta[s], inv2h2, kind=table.kind,
            ).to(torch.float64).cpu().numpy()
        u /= table.norm_c                         # same units as n·dens
        u_neg = u if table.kind == "laplace" else 0.0
        lo = (sums_live - u_neg) / table.n_tot
        hi = (sums_live + u) / table.n_tot
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.maximum(np.abs(f_hat - lo) / lo,
                             np.abs(f_hat - hi) / hi)
        rel = np.where(lo > 0, rel, np.inf)
        return Answer(
            value=torch.as_tensor(f_hat, dtype=torch.float32,
                                  device=y.device),
            key=table.key, degraded=True, shed=shed, tier=tier, path=(tier,),
            rel_err_bound=float(np.max(rel)) if rel.size else 0.0,
            rel_err_bounds=rel, live_shards=live, missing_shards=missing,
            **counters)

    # -- health -----------------------------------------------------------

    def _refresh_health(self, table) -> None:
        sup = self.supervisor
        before = set(sup.fenced())
        plan = sup.restart_plan(fence=True)
        if plan is None:
            return
        newly = [h for h in plan["dead"] if h not in before]
        if not newly:
            return
        self.stats["fenced"] += len(newly)
        obs.counter("resilience.fenced",
                    "replica hosts fenced after missed heartbeats").inc(
            len(newly))
        n_live = len(sup.hosts) - len(sup.fenced())
        live_shards = {
            s for s in range(table.n_shards)
            for r in range(table.n_replicas)
            if not sup.hosts[s * table.n_replicas + r].fenced}
        # the routing table shrinks as an elastic mesh would: surviving
        # hosts re-planned as (data = replica, model = shard)
        self.service_plan = elastic.plan_mesh(
            max(n_live, 1), model_parallel=max(len(live_shards), 1))
        obs.gauge("resilience.live_hosts",
                  "replica hosts currently serving").set(n_live)

    def _maybe_probe(self, table, req: int) -> None:
        """Every ``probe_every`` requests, health-probe one fenced host;
        success re-admits it (supervisor epoch and breaker reset)."""
        if req % self.rcfg.probe_every:
            return
        fenced = self.supervisor.fenced()
        if not fenced:
            return
        hid = fenced[(req // self.rcfg.probe_every) % len(fenced)]
        s, r = divmod(hid, table.n_replicas)
        if s >= table.n_shards:
            return
        self.stats["probes"] += 1
        obs.counter("resilience.probes", "fenced-host health probes").inc()
        probe = torch.zeros((1, table.d), dtype=torch.float32,
                            device=self.device)
        try:
            _, dens = self._attempt(table, s, r, probe,
                                    self.config.exact_precision,
                                    self._clock() + 1.0)
            if not bool(torch.isfinite(dens).all()):
                return
        except (InjectedFailure, _ReplicaBusy):
            return
        self.supervisor.readmit(hid)
        for bk, br in list(self._breakers.items()):
            if bk[:3] == (table.key, s, r):
                br.record_success()
        self.stats["readmits"] += 1
        obs.counter("resilience.readmits",
                    "fenced hosts re-admitted after a probe").inc()

    # -- bookkeeping ------------------------------------------------------

    def _note_done(self, t0: float, rows: int, *, deadline_hit: bool):
        self.latency.record(self._clock() - t0, rows, 1)
        with self._lock:
            if deadline_hit:
                self._miss_streak += 1
                if self._miss_streak >= self.rcfg.shed_after_misses \
                        and self._shed_left == 0:
                    self._shed_left = self.rcfg.shed_requests
                    self._miss_streak = 0
                    obs.counter("resilience.shed_episodes",
                                "tier-downgrade episodes entered").inc()
            else:
                self._miss_streak = 0

    def _drop(self, reason: str) -> None:
        self.stats["dropped"] += 1
        obs.counter("resilience.dropped", "requests that got no answer",
                    labels={"reason": reason}).inc()

    def _breaker(self, key, s, r, bucket) -> CircuitBreaker:
        bk = (key, s, r, bucket)
        with self._lock:
            if bk not in self._breakers:
                self._breakers[bk] = CircuitBreaker(
                    self.rcfg.breaker_threshold,
                    self.rcfg.breaker_cooldown_s, self._clock)
            return self._breakers[bk]

    def _eng_lock(self, key, s, r) -> threading.Lock:
        with self._lock:
            return self._eng_locks.setdefault((key, s, r), threading.Lock())

    # -- telemetry / lifecycle -------------------------------------------

    def breaker_states(self) -> Dict[str, str]:
        return {f"{k[0]}/s{k[1]}r{k[2]}b{k[3]}": br.state
                for k, br in self._breakers.items()}

    def metrics(self) -> dict:
        out = {
            "latency": self.latency.summary().as_dict(),
            "stats": dict(self.stats),
            "breakers": self.breaker_states(),
            "fenced": self.supervisor.fenced() if self.supervisor else [],
            "rejected_beats": (self.supervisor.rejected_beats
                               if self.supervisor else 0),
            "service_plan": (dataclasses.asdict(self.service_plan)
                             if self.service_plan else None),
            "registry": obs.metrics_snapshot(),
        }
        if self.injector is not None:
            out["chaos"] = self.injector.snapshot()
        return out

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)
        if self.injector is not None and fault_injection.active() \
                is self.injector:
            fault_injection.uninstall()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _cheapest_tier(accuracy: float) -> str:
    """Cheapest precision tier whose rtol clears ``accuracy``: the
    planner's ladder, reused for load-shed downgrades."""
    admissible = [t for t in TIER_ORDER if TIER_RTOL[t] <= accuracy]
    return admissible[-1] if admissible else TIER_ORDER[0]


__all__ = ["ResilienceConfig", "ResilientEngine", "CircuitBreaker"]
