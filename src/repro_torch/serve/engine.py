"""The serving engine: registry + micro-batcher + backend dispatch.

The counterpart of ``repro.serve.engine``.  Request lifecycle:

  register(key, x)         — one-time: resolve the plan (``plan="auto"``)
                             and tiles, debias (sdkde), prepare the column
                             layout, cache, optionally fit the RFF tier
                             (``stream=True``: a streaming estimator,
                             updated through the registry's ``append`` /
                             ``evict_ids`` / ``slide``); a planned
                             estimator prewarms its top bucket
  query(QueryRequest)      — resolve the tier (request pin > explicit
                             config > planner), route through the accuracy
                             cascade when a target gates it, pad to a
                             shape bucket, run the bucket callable, return
                             an Answer with per-row certified bounds
  query_many([requests…])  — coalesce several ragged requests into ONE
                             padded dispatch (members may carry different
                             targets), then split the Answer back out

Both backends dispatch through per-(estimator, tier, bucket) callables
kept in a small LRU:

  * ``flash`` — prepared fast path (``kernels.ops.flash_kde_prepared``,
                kernel B2, or B4 when ``prune`` engages for the train
                set; ``method="laplace"``: B5, or B4 with its ``laplace``
                flag): train columns transposed and normed once at fit
                (clustered for B4), queries arrive padded to a
                ``block_m`` multiple;
  * ``torch`` — the streaming plain math of ``core/kde.py``
                (``laplace_kde_eval`` for ``method="laplace"``);
  * ``ring``  — the ring over ``torch.distributed``
                (``repro_torch.distributed.ring``): each bucket, a
                multiple of the ring size, is sharded over the ranks, the
                train shards rotate (B2, or B5 for Laplace, a step) and
                the densities are gathered back.  Every rank of the world
                serves the same requests in the same order (the ring is
                collective); a process outside a world is a ring of one.

A streaming estimator's callables read the train tensors of the snapshot
each dispatch is pinned to, and re-resolve pruning per call (appends and
evictions move the live count across ``ops.resolve_prune``'s threshold),
so only a layout rebuild (a new ``layout_epoch``) builds new callables.
The staleness gate (``_serve``) serves a snapshot at most
``staleness_budget`` generations behind live.

Telemetry goes through ``repro_torch.obs`` with ``repro``'s names: spans
``serve.request`` → ``serve.dispatch`` → ``serve.bucket`` (→
``serve.compile`` on a miss) and ``plan.prewarm``; and the port's own:
``serve.coalesce`` (fusing a ``query_many``'s members), ``sync.engine``
(the wait for the card before an answer) and ``serve.split``; counters
``serve.requests`` / ``serve.queries`` / ``serve.deadline_exceeded`` /
``serve.pin_overrides_plan`` / ``plan.prewarms`` (and the cascade's,
``serve/cascade.py``), histograms ``serve.pad_ratio``,
``serve.compile_s`` and ``serve.staleness_gen``.  Chaos hooks
(``fault_injection``): ``serve.dispatch``, ``serve.compile`` and
``serve.result``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import fault_injection, obs
from repro_torch.core import kde as ref
from repro_torch.distributed import ring
from repro_torch.kernels import ops
from repro_torch.serve import cascade
from repro_torch.serve.api import RFF_TIER, Answer, QueryRequest, resolve_tier
from repro_torch.serve.batching import ShapeBucketCache, coalesce, pad_queries, split
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.errors import BadRequest, DeadlineExceeded
from repro_torch.serve.registry import EstimatorRegistry, PreparedEstimator
from repro_torch.serve.stats import LatencyRecorder


class ServeEngine:
    def __init__(self, config: ServeConfig | None = None,
                 registry: EstimatorRegistry | None = None):
        if config is None:
            config = registry.config if registry is not None else ServeConfig()
        self.config = config
        self.device = device_mod.resolve(config.device)
        self.registry = registry or EstimatorRegistry(config)
        self.cache = ShapeBucketCache(config.cache_buckets)
        self.latency = LatencyRecorder()
        # generations-behind-live of recent streaming dispatches (a budget
        # of 0 pins this to all zeros); bounded so a long-lived server does
        # not grow it with request count
        self.staleness_log: Deque[int] = deque(maxlen=8192)
        # per-request instruments, looked up once (a lookup takes the
        # registry's lock)
        self._requests = obs.counter("serve.requests", "requests admitted")
        self._rows = obs.counter("serve.queries", "density rows served")
        self._pad_ratio = obs.histogram(
            "serve.pad_ratio", "bucket rows / real rows per dispatch",
            lo=1.0, hi=1e4, per_decade=12)

    # -- fit path --------------------------------------------------------

    def register(self, key: str, x, h: Optional[float] = None,
                 config: ServeConfig | None = None, refit: bool = False,
                 prewarm: Optional[bool] = None) -> PreparedEstimator:
        """Fit (or fetch) an estimator.  ``prewarm=None`` follows the
        plan: a planned estimator builds its top bucket at registration,
        so the first request finds the kernels loaded; pass False to
        defer."""
        prep = self.registry.fit(key, x, h, config=config, refit=refit)
        if refit:
            self.cache.invalidate(lambda k: k[0] == key)
        if prewarm is None:
            prewarm = prep.plan is not None and getattr(prep.plan,
                                                        "prewarm", False)
        if prewarm:
            self.prewarm(key)
        return prep

    def prewarm(self, key: str) -> None:
        """Run the largest bucket's callable once ahead of traffic, through
        the normal LRU path, so the first request finds the kernel library
        loaded and the bucket built.  Not recorded as served latency."""
        prep = self.registry.get(key)
        cfg = prep.config
        bucket = cfg.bucket_sizes(prep.block_m,
                                  ring_size=prep.ring_size)[-1]
        with obs.span("plan.prewarm", key=key, buckets=1,
                      plan=getattr(prep.plan, "plan_id", "")):
            y = torch.zeros((bucket, prep.d), dtype=torch.float32,
                            device=prep.points.device)
            snap = (prep.stream.ensure(cfg.staleness_budget)
                    if prep.stream is not None else None)
            self._run_bucket(prep, y, cfg.exact_precision, snap)
            device_mod.synchronize(prep.points.device)
        obs.counter("plan.prewarms",
                    "bucket executables built ahead of traffic").inc()

    # -- query path ------------------------------------------------------

    def query(self, request: QueryRequest) -> Answer:
        """Serve one request.  A request past its deadline raises
        ``DeadlineExceeded`` before any compute, and so does an answer
        that completes past it."""
        if not isinstance(request, QueryRequest):
            raise BadRequest("query takes a QueryRequest")
        prep = self.registry.get(request.key)
        y = self._points(prep, request.points)
        deadline = (None if request.deadline_s is None
                    else time.monotonic() + request.deadline_s)
        self._check_deadline(request.key, deadline, phase="dispatch")
        with obs.span("serve.request", key=request.key, rows=int(y.shape[0]),
                      requests=1):
            t0 = time.perf_counter()
            ans, _ = self._serve(prep, y, [request], [int(y.shape[0])])
            with obs.span("sync.engine"):
                device_mod.synchronize(y.device)
            dt = time.perf_counter() - t0
        self._check_deadline(request.key, deadline, phase="answer")
        self._note_served(dt, y.shape[0], 1)
        ans.latency_s = dt
        return ans

    def query_many(self, requests: Sequence[QueryRequest]) -> List[Answer]:
        """Coalesce requests sharing one key and one precision pin into
        one padded dispatch; one Answer per request, each with its slice
        of the per-row bounds and cascade counts.  Members' accuracy
        targets may differ (the cascade gates row ranges apart; a member
        with no target, and no config default, is answered exact).  The
        fused dispatch runs under the latest member deadline."""
        reqs = list(requests)
        if not reqs or not all(isinstance(r, QueryRequest) for r in reqs):
            raise BadRequest("query_many takes a non-empty sequence of "
                             "QueryRequest")
        key, pin = reqs[0].key, reqs[0].precision
        if any(r.key != key or r.precision != pin for r in reqs[1:]):
            raise BadRequest("fused query_many requests must share one key "
                             "and one precision pin")
        prep = self.registry.get(key)
        with obs.span("serve.coalesce", requests=len(reqs)):
            fused, sizes = coalesce([self._points(prep, r.points)
                                     for r in reqs])
        now = time.monotonic()
        member_dl = [now + r.deadline_s for r in reqs
                     if r.deadline_s is not None]
        deadline = max(member_dl) if member_dl else None
        self._check_deadline(key, deadline, phase="dispatch")
        with obs.span("serve.request", key=key, rows=int(fused.shape[0]),
                      requests=len(sizes)):
            t0 = time.perf_counter()
            ans, esc_rows = self._serve(prep, fused, reqs, sizes)
            with obs.span("sync.engine"):
                device_mod.synchronize(fused.device)
            dt = time.perf_counter() - t0
        self._check_deadline(key, deadline, phase="answer")
        self._note_served(dt, fused.shape[0], len(sizes))
        with obs.span("serve.split", requests=len(reqs)):
            return self._split_answer(ans, len(reqs), sizes, esc_rows, dt)

    def _serve(self, prep: PreparedEstimator, y: torch.Tensor,
               reqs: Sequence[QueryRequest], sizes: Sequence[int]):
        """Resolve the tier, route through the cascade when engaged, and
        assemble one fused Answer for ``y``; returns ``(answer,
        esc_rows)``, the fused rows that escalated marked."""
        cfg = prep.config
        pin = reqs[0].precision
        tier, overrode = resolve_tier(pin, cfg.precision, prep.plan)
        if overrode:
            obs.counter(
                "serve.pin_overrides_plan",
                "requests whose precision pin overrode the planner tier",
            ).inc()
        m = int(y.shape[0])
        target = self._targets(cfg, reqs, sizes)
        # the staleness gate: a snapshot at most ``staleness_budget``
        # generations behind live (a flush only past the budget), the
        # whole request pinned to it
        snap = (prep.stream.ensure(cfg.staleness_budget)
                if prep.stream is not None else None)
        res = None
        # an exact-tier pin skips the fast tier: the pin is the routing
        # decision; unpinned requests (or an "rff" pin) consult the gate
        if tier == RFF_TIER or (pin is None and cascade.engaged(
                cfg, prep, tier, target)):
            res = cascade.run(self, prep, y, tier, target, snap=snap)
            if res is None and tier == RFF_TIER:
                raise BadRequest(
                    f"precision='rff' pinned but the RFF tier is "
                    f"unavailable for method={cfg.method!r} "
                    f"backend={cfg.backend!r} (rff={cfg.rff!r})")
        if res is not None:
            value, bounds, path = res.value, res.bounds, res.path
            hits, esc, esc_rows = res.hits, res.escalated, res.esc_rows
        else:
            exact = cfg.exact_precision if tier == RFF_TIER else tier
            value = self._dispatch(prep, y, exact, snap)
            bounds = np.full(m, cascade.exact_bound(exact, cfg.prune))
            hits, esc, path = 0, 0, (exact,)
            esc_rows = np.zeros(m, bool)
        value = fault_injection.poison("serve.result", value)
        lag = prep.stream.gen - snap.gen if snap is not None else 0
        ans = Answer(value=value, key=prep.key, tier=path[-1], path=path,
                     rel_err_bound=float(bounds.max()),
                     rel_err_bounds=bounds, rff_hits=hits, escalated=esc,
                     staleness=lag,
                     plan_id=getattr(prep.plan, "plan_id", "") or "")
        return ans, esc_rows

    @staticmethod
    def _targets(cfg: ServeConfig, reqs: Sequence[QueryRequest],
                 sizes: Sequence[int]) -> Optional[np.ndarray]:
        """Per-row accuracy targets of a fused batch, or None when no
        member carries one.  A request's target beats the config's; a
        member with neither gets -inf, so its rows always escalate (an
        untargeted request expects an exact-grade answer)."""
        per = [r.accuracy_target if r.accuracy_target is not None
               else cfg.accuracy_target for r in reqs]
        if all(t is None for t in per):
            return None
        return np.concatenate([np.full(s, -np.inf if t is None else float(t))
                               for t, s in zip(per, sizes)])

    @staticmethod
    def _split_answer(ans: Answer, n_reqs: int, sizes: Sequence[int],
                      esc_rows: np.ndarray, dt: float) -> List[Answer]:
        offs = np.cumsum([0] + list(sizes))
        cascaded = RFF_TIER in ans.path
        out = []
        for i, dens in enumerate(split(ans.value, sizes)):
            lo, hi = int(offs[i]), int(offs[i + 1])
            b = ans.rel_err_bounds[lo:hi]
            esc = int(esc_rows[lo:hi].sum()) if cascaded else 0
            path = (RFF_TIER,) if cascaded and not esc else ans.path
            out.append(Answer(
                value=dens, key=ans.key, tier=path[-1], path=path,
                rel_err_bound=float(b.max()), rel_err_bounds=b,
                rff_hits=(hi - lo - esc) if cascaded else 0, escalated=esc,
                batch_requests=n_reqs, staleness=ans.staleness,
                plan_id=ans.plan_id, latency_s=dt))
        return out

    @staticmethod
    def _points(prep: PreparedEstimator, points) -> torch.Tensor:
        y = torch.atleast_2d(torch.as_tensor(points, dtype=torch.float32,
                                             device=prep.points.device))
        if y.ndim != 2 or y.shape[0] == 0 or y.shape[-1] != prep.d:
            raise BadRequest(
                f"query shape {tuple(y.shape)} does not match estimator "
                f"{prep.key!r} (expected (m, {prep.d}) with m >= 1)")
        return y

    @staticmethod
    def _check_deadline(key: str, deadline: Optional[float],
                        phase: str) -> None:
        if deadline is None:
            return
        late = time.monotonic() - deadline
        if late >= 0:
            obs.counter("serve.deadline_exceeded",
                        "requests past their deadline at the engine",
                        labels={"phase": phase}).inc()
            raise DeadlineExceeded(
                f"request for {key!r} missed its deadline by "
                f"{1e3 * late:.1f}ms "
                + ("before dispatch" if phase == "dispatch"
                   else "(answer completed late)"))

    def _note_served(self, seconds: float, rows: int, requests: int) -> None:
        self.latency.record(seconds, rows, requests)
        self._requests.inc(requests)
        self._rows.inc(rows)

    # -- telemetry --------------------------------------------------------

    def metrics(self) -> dict:
        """One JSON-safe view of everything this engine can observe:
        latency (bounded histogram), bucket-cache efficiency, streaming
        staleness, and the process-wide obs registry (prune occupancy,
        stream counters and gauges, ...)."""
        return {
            "latency": self.latency.summary().as_dict(),
            "latency_hist": self.latency.histogram_snapshot(),
            "bucket_cache": {
                "hits": self.cache.hits,
                "misses": self.cache.misses,
                "evictions": self.cache.evictions,
                "resident": len(self.cache),
            },
            "staleness": self.staleness_summary(),
            "registry": obs.metrics_snapshot(),
        }

    def trace_events(self) -> list:
        """The buffered obs span events (enable with
        ``obs.configure(trace=True)``)."""
        return obs.trace_events()

    def staleness_summary(self) -> dict:
        """p50/p99/max of how many generations behind live each streaming
        dispatch was served (empty dict when nothing streamed)."""
        if not self.staleness_log:
            return {}
        xs = sorted(self.staleness_log)

        def pct(q):
            return xs[min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))]

        return {"count": len(xs), "p50": pct(0.5), "p99": pct(0.99),
                "max": xs[-1]}

    # -- internals -------------------------------------------------------

    def _dispatch(self, prep: PreparedEstimator, y: torch.Tensor,
                  tier: str, snap=None) -> torch.Tensor:
        """The exact tier's densities for ``y``.  A streaming estimator
        answers from ``snap``, the snapshot the request's staleness gate
        took (``_serve``; the cascade's escalation uses the one its fast
        tier read)."""
        cfg = prep.config
        with obs.span("serve.dispatch", key=prep.key, backend=cfg.backend,
                      tier=tier, rows=int(y.shape[0])) as sp:
            # chaos hook: a killed replica raises InjectedFailure here, a
            # slow one sleeps — before any compute, like a dead device
            fault_injection.fire("serve.dispatch", key=prep.key)
            if prep.plan is not None:
                sp.set(plan=prep.plan.plan_id)
            if prep.stream is not None:
                # the dispatch is pinned to the gate's snapshot: concurrent
                # updates publish NEW snapshots and never change the one in
                # flight
                lag = prep.stream.gen - snap.gen
                self.staleness_log.append(lag)
                obs.histogram("serve.staleness_gen",
                              "generations behind live per streaming "
                              "dispatch", lo=1, hi=1e4,
                              per_decade=8).observe(lag)
                sp.set(staleness=lag, stream_gen=snap.gen,
                       layout_epoch=snap.layout_epoch)
            top = cfg.bucket_sizes(prep.block_m,
                                   ring_size=prep.ring_size)[-1]
            m = y.shape[0]
            if m <= top:
                return self._run_bucket(prep, y, tier, snap)
            # oversize batch: chunk at the largest bucket
            sp.set(chunks=-(-m // top))
            return torch.cat([self._run_bucket(prep, y[off:off + top], tier,
                                               snap)
                              for off in range(0, m, top)])

    def _run_bucket(self, prep: PreparedEstimator, y: torch.Tensor,
                    tier: str, snap=None) -> torch.Tensor:
        m = y.shape[0]
        bucket = prep.config.bucket_for(m, prep.block_m,
                                        ring_size=prep.ring_size)
        if prep.stream is not None:
            # streaming callables read the pinned snapshot per call, so
            # value-only generations reuse them; only a rebuild changes
            # the column shapes, so the layout epoch joins the key
            ck = (prep.key, prep.generation, "stream", snap.layout_epoch,
                  tier, bucket)
            build = lambda: self._build_stream_executable(prep, tier)  # noqa: E731
        else:
            # the fit generation keys out stale callables after a refit;
            # the tier keys each precision to its own prepared columns
            ck = (prep.key, prep.generation, tier, bucket)
            build = lambda: self._build_executable(prep, tier)  # noqa: E731
        hit = ck in self.cache
        self._pad_ratio.observe(bucket / m)
        with obs.span("serve.bucket", key=prep.key, bucket=bucket, rows=m,
                      pad_ratio=round(bucket / m, 4),
                      cache="hit" if hit else "miss"):
            fn = self.cache.get_or_build(
                ck, lambda: self._timed_build(build, prep, bucket))
            yp = pad_queries(y, bucket)
            if prep.stream is not None:
                return fn(yp, m, snap)[:m]
            return fn(yp, m)[:m]

    @staticmethod
    def _timed_build(build, prep: PreparedEstimator, bucket: int):
        """Build a bucket callable under a compile span + histogram, so a
        rebuild storm is visible as ``serve.compile_s`` mass."""
        t0 = time.perf_counter()
        with obs.span("serve.compile", key=prep.key, bucket=bucket):
            fault_injection.fire("serve.compile", key=prep.key)
            fn = build()
        obs.histogram("serve.compile_s", "bucket-callable build seconds",
                      lo=1e-5, hi=1e3).observe(time.perf_counter() - t0)
        return fn

    @staticmethod
    def _build_stream_executable(prep: PreparedEstimator, tier: str):
        """Bucket callable for a streaming estimator: ``fn(yp, n_real,
        snap)``.  No train tensor is closed over — each call reads the
        snapshot its dispatch is pinned to; normalization uses the
        snapshot's live count, and the prune decision re-resolves per
        call, since the live count drifts across the "auto" threshold."""
        cfg = prep.config
        laplace = cfg.method == "laplace"
        if cfg.backend == "flash":
            def fn(yp, n_real, snap):
                cols = prep.stream.columns_for(tier, snap)
                eps = ops.resolve_prune(cfg.prune, snap.n_live, prep.block_n)
                prune = (cfg.prune if eps is not None
                         and cols.meta is not None else "off")
                sums = ops.flash_kde_prepared(
                    yp, cols.xt, cols.nrm_x, prep.h, cols.xt_lo,
                    precision=tier, block_m=prep.block_m,
                    block_n=prep.block_n, laplace=laplace, prune=prune,
                    columns=cols, n_real=n_real)
                return sums / snap.norm

            return fn
        eval_fn = ref.laplace_kde_eval if laplace else ref.kde_eval
        # snap.xp is the live set padded to a pow2 row bucket; sentinel
        # rows add exactly 0.0 to the sums but enter eval_fn's 1/n, so
        # rescale from the padded count to the live one
        return lambda yp, n_real, snap: eval_fn(
            snap.xp, yp, prep.h, block=cfg.block) * (
            snap.xp.shape[0] / snap.n_live)

    @staticmethod
    def _build_executable(prep: PreparedEstimator, tier: str):
        """Bucket callable ``fn(yp, n_real)``: padded (bucket, d) queries
        → (bucket,) densities.  ``n_real`` is the true query count; the
        pruned path keeps the sentinel rows past it out of the row-tile
        geometry, the other paths ignore it.  Pruning is decided once per
        callable: "auto" below the size threshold is the dense path for
        every request."""
        cfg = prep.config
        laplace = cfg.method == "laplace"
        if cfg.backend == "flash":
            cols = prep.columns_for(tier)
            prune = cfg.prune if ops.resolve_prune(
                cfg.prune, prep.n_true, prep.block_n) is not None else "off"
            return lambda yp, n_real: ops.flash_kde_prepared(
                yp, cols.xt, cols.nrm_x, prep.h, cols.xt_lo, precision=tier,
                block_m=prep.block_m, block_n=prep.block_n, laplace=laplace,
                prune=prune, columns=cols, n_real=n_real) / prep.norm
        if cfg.backend == "ring":
            ring_fn = ring.ring_laplace_kde if laplace else ring.ring_kde
            axes = ("data",)

            def ring_eval(yp, n_real):
                dens = ring_fn(prep.x_sharded,
                               ring.shard_points(yp, prep.mesh, axes),
                               prep.h, n_true=prep.n_true, mesh=prep.mesh)
                return ring.gather_rows(dens, prep.mesh, axes)

            return ring_eval
        eval_fn = ref.laplace_kde_eval if laplace else ref.kde_eval
        return lambda yp, n_real: eval_fn(prep.points, yp, prep.h,
                                          block=cfg.block)


__all__ = ["ServeEngine"]
