"""The serving engine: registry + micro-batcher + backend dispatch.

The counterpart of ``repro.serve.engine``.  Request lifecycle:

  register(key, x)         — one-time: debias (sdkde), prepare the column
                             layout, cache
  query(QueryRequest)      — resolve the tier (request pin > config), pad
                             to a shape bucket, run the bucket callable,
                             return an Answer with per-row certified bounds
  query_many([requests…])  — coalesce several ragged requests into ONE
                             padded dispatch, then split the Answer back out

Both backends dispatch through per-(estimator, tier, bucket) callables
kept in a small LRU:

  * ``flash`` — prepared fast path (``kernels.ops.flash_kde_prepared``,
                kernel B2, or B4 when ``prune`` engages for the train
                set; ``method="laplace"``: B5, or B4 with its ``laplace``
                flag): train columns transposed and normed once at fit
                (clustered for B4), queries arrive padded to a
                ``block_m`` multiple;
  * ``torch`` — the streaming plain math of ``core/kde.py``
                (``laplace_kde_eval`` for ``method="laplace"``).

Spans are ``torch.profiler.record_function`` ranges with ``repro``'s
names (``serve.request``, ``serve.dispatch``, ``serve.bucket``); they cost
nothing unless a profiler is recording.  The accuracy cascade, streaming,
planning and chaos hooks arrive with their slices (ROADMAP A7-A12).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import device as device_mod
from repro_torch.core import kde as ref
from repro_torch.kernels import ops
from repro_torch.serve.api import Answer, QueryRequest, exact_bound, resolve_tier
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

    # -- fit path --------------------------------------------------------

    def register(self, key: str, x, h: Optional[float] = None,
                 config: ServeConfig | None = None,
                 refit: bool = False) -> PreparedEstimator:
        """Fit (or fetch) an estimator."""
        prep = self.registry.fit(key, x, h, config=config, refit=refit)
        if refit:
            self.cache.invalidate(lambda k: k[0] == key)
        return prep

    def prewarm(self, key: str) -> None:
        """Run the largest bucket's callable once ahead of traffic, through
        the normal LRU path, so the first request finds the kernel library
        loaded and the bucket built.  Not recorded as served latency."""
        prep = self.registry.get(key)
        bucket = prep.config.bucket_sizes()[-1]
        y = torch.zeros((bucket, prep.d), dtype=torch.float32,
                        device=prep.points.device)
        self._run_bucket(prep, y, prep.config.precision)
        device_mod.synchronize(prep.points.device)

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
        with record_function("serve.request"):
            t0 = time.perf_counter()
            ans = self._serve(prep, y, request.precision)
            device_mod.synchronize(y.device)
            dt = time.perf_counter() - t0
        self._check_deadline(request.key, deadline, phase="answer")
        self._note_served(dt, y.shape[0], 1)
        ans.latency_s = dt
        return ans

    def query_many(self, requests: Sequence[QueryRequest]) -> List[Answer]:
        """Coalesce requests sharing one key and one precision pin into
        one padded dispatch; one Answer per request.  The fused dispatch
        runs under the latest member deadline."""
        reqs = list(requests)
        if not reqs or not all(isinstance(r, QueryRequest) for r in reqs):
            raise BadRequest("query_many takes a non-empty sequence of "
                             "QueryRequest")
        key, pin = reqs[0].key, reqs[0].precision
        if any(r.key != key or r.precision != pin for r in reqs[1:]):
            raise BadRequest("fused query_many requests must share one key "
                             "and one precision pin")
        prep = self.registry.get(key)
        fused, sizes = coalesce([self._points(prep, r.points) for r in reqs])
        now = time.monotonic()
        member_dl = [now + r.deadline_s for r in reqs
                     if r.deadline_s is not None]
        deadline = max(member_dl) if member_dl else None
        self._check_deadline(key, deadline, phase="dispatch")
        with record_function("serve.request"):
            t0 = time.perf_counter()
            ans = self._serve(prep, fused, pin)
            device_mod.synchronize(fused.device)
            dt = time.perf_counter() - t0
        self._check_deadline(key, deadline, phase="answer")
        self._note_served(dt, fused.shape[0], len(sizes))
        offs = np.cumsum([0] + sizes)
        return [
            Answer(value=dens, key=key, tier=ans.tier, path=ans.path,
                   rel_err_bound=ans.rel_err_bound,
                   rel_err_bounds=ans.rel_err_bounds[offs[i]:offs[i + 1]],
                   batch_requests=len(reqs), latency_s=dt)
            for i, dens in enumerate(split(ans.value, sizes))
        ]

    def _serve(self, prep: PreparedEstimator, y: torch.Tensor,
               pin: Optional[str]) -> Answer:
        tier = resolve_tier(pin, prep.config.precision)
        value = self._dispatch(prep, y, tier)
        m = int(y.shape[0])
        bounds = np.full(m, exact_bound(tier))
        return Answer(value=value, key=prep.key, tier=tier, path=(tier,),
                      rel_err_bound=float(bounds.max()),
                      rel_err_bounds=bounds)

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
            raise DeadlineExceeded(
                f"request for {key!r} missed its deadline by "
                f"{1e3 * late:.1f}ms "
                + ("before dispatch" if phase == "dispatch"
                   else "(answer completed late)"))

    def _note_served(self, seconds: float, rows: int, requests: int) -> None:
        self.latency.record(seconds, rows, requests)

    # -- telemetry --------------------------------------------------------

    def metrics(self) -> dict:
        """JSON-safe view of latency and bucket-cache efficiency."""
        return {
            "latency": self.latency.summary().as_dict(),
            "latency_hist": self.latency.histogram_snapshot(),
            "bucket_cache": {
                "hits": self.cache.hits,
                "misses": self.cache.misses,
                "evictions": self.cache.evictions,
                "resident": len(self.cache),
            },
        }

    # -- internals -------------------------------------------------------

    def _dispatch(self, prep: PreparedEstimator, y: torch.Tensor,
                  tier: str) -> torch.Tensor:
        with record_function("serve.dispatch"):
            top = prep.config.bucket_sizes()[-1]
            m = y.shape[0]
            if m <= top:
                return self._run_bucket(prep, y, tier)
            # oversize batch: chunk at the largest bucket
            return torch.cat([self._run_bucket(prep, y[off:off + top], tier)
                              for off in range(0, m, top)])

    def _run_bucket(self, prep: PreparedEstimator, y: torch.Tensor,
                    tier: str) -> torch.Tensor:
        m = y.shape[0]
        bucket = prep.config.bucket_for(m)
        # the fit generation keys out stale callables after a refit; the
        # tier keys each precision to its own prepared columns
        ck = (prep.key, prep.generation, tier, bucket)
        with record_function("serve.bucket"):
            fn = self.cache.get_or_build(
                ck, lambda: self._build_executable(prep, tier))
            return fn(pad_queries(y, bucket), m)[:m]

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
        eval_fn = ref.laplace_kde_eval if laplace else ref.kde_eval
        return lambda yp, n_real: eval_fn(prep.points, yp, prep.h,
                                          block=cfg.block)


__all__ = ["ServeEngine"]
