"""Estimator registry: fit once, serve many times.

The counterpart of ``repro.serve.registry``.  SD-KDE's debias of the train
set is O(n²·d) and depends only on the dataset, while each query batch is
an O(n·m·d) pass against the fixed debiased points.  The registry runs the
expensive pass once per dataset and caches a prepared estimator: debiased
points, the padded transposed column layout per precision tier, and the
normalization constant.  ``kde`` and ``laplace`` serve the raw points
with the Silverman bandwidth (no debias), as ``repro`` does.  When the
config's ``prune`` engages for the train set (``ops.resolve_prune``),
every tier's columns are clustered, and all tiers share ONE spatial
index, clustered once.

With ``ServeConfig(stream=True)`` a registered dataset is a
``repro_torch.stream.StreamingSDKDE``: ``append`` / ``evict_ids`` /
``slide`` fold updates in without a refit, and the prepared state is the
stream's published snapshot.  ``repro``'s RFF tier on a stream (its
``_RFFTier`` and the id-diff ``_sync``) arrives with the RFF half of
ROADMAP A7.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import device as device_mod
from repro_torch import fault_injection
from repro_torch.core import bandwidth as bw
from repro_torch.core.bandwidth import gaussian_norm_const
from repro_torch.kernels import ops, spatial
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.errors import UnknownKey


@dataclasses.dataclass
class PreparedEstimator:
    """Everything query evaluation needs, precomputed at fit time."""

    key: str
    config: ServeConfig
    h: float
    n_true: int              # real (unpadded) train count, for normalization
    d: int
    generation: int          # bumped per fit; bucket keys include it so a
                             # refit never serves stale callables
    points: torch.Tensor     # (n, d) train points (debiased for sdkde;
                             # raw for kde and laplace)
    norm: float              # n_true · (2π)^{d/2} · h^d
    block_m: Optional[int] = None   # flash: kernel tiles
    block_n: Optional[int] = None
    # the spatial index every tier's clustered columns share (pruning)
    index: Optional[spatial.SpatialIndex] = None
    # streaming (config.stream): the incrementally maintained live state;
    # the prepared-state accessors read its published snapshot
    stream: object = None
    _columns: dict = dataclasses.field(default_factory=dict, repr=False)

    def columns_for(self, precision: str) -> ops.TrainColumns:
        """Prepared train tensors for one tier (built once, then cached).

        Clustered only when pruning can engage for this set ("auto" below
        the size threshold stays dense end to end); the first clustered
        tier fits the index the others reuse, so their tile layouts agree.
        A streaming estimator answers from its published snapshot.
        """
        if self.stream is not None:
            return self.stream.columns_for(precision)
        if precision not in self._columns:
            clustered = ops.resolve_prune(
                self.config.prune, self.n_true, self.block_n) is not None
            cols = ops.prepare_train_columns(
                self.points, block_n=self.block_n, precision=precision,
                clustered=clustered, index=self.index)
            if cols.index is not None:
                self.index = cols.index
            self._columns[precision] = cols
        return self._columns[precision]


class EstimatorRegistry:
    """Named cache of prepared estimators.

    ``fit`` is idempotent per key: re-registering an existing key returns
    the cached estimator without re-running the score pass (``n_fits``
    counts actual passes).  ``refit=True`` forces a refresh.
    """

    def __init__(self, config: ServeConfig | None = None):
        self.config = config or ServeConfig()
        self._store: Dict[str, PreparedEstimator] = {}
        self.n_fits = 0

    def get(self, key: str) -> PreparedEstimator:
        if key not in self._store:
            raise UnknownKey(
                f"estimator {key!r} not registered (have {list(self._store)})")
        return self._store[key]

    def evict(self, key: str) -> None:
        self._store.pop(key, None)

    # -- streaming updates (config.stream estimators) --------------------

    def _stream_of(self, key: str):
        prep = self.get(key)
        if prep.stream is None:
            raise ValueError(
                f"estimator {key!r} is not streaming (register it with "
                "ServeConfig(stream=True) to append/evict points)")
        return prep.stream

    def append(self, key: str, xs):
        """Fold new train points into a streaming estimator — the O(n·b·d)
        delta pass, never the O(n²·d) refit.  Returns the assigned ids."""
        return self._stream_of(key).append(xs)

    def evict_ids(self, key: str, ids) -> int:
        """Remove train points (by the ids ``append`` returned) from a
        streaming estimator.  Not to be confused with ``evict(key)``,
        which drops a whole registered estimator."""
        return self._stream_of(key).evict(ids)

    def slide(self, key: str, xs):
        """Sliding-window update: append ``xs``, evict the oldest as many."""
        return self._stream_of(key).slide(xs)

    def adopt(self, prep: PreparedEstimator) -> PreparedEstimator:
        """Register an estimator prepared elsewhere (``convert``), as a new
        generation under its key."""
        self.n_fits += 1
        prep.generation = self.n_fits
        self._store[prep.key] = prep
        return prep

    def fit(self, key: str, x, h: Optional[float] = None,
            config: ServeConfig | None = None,
            refit: bool = False) -> PreparedEstimator:
        if key in self._store and not refit:
            return self._store[key]
        cfg = config or self.config
        dev = device_mod.resolve(cfg.device)
        fault_injection.fire("registry.fit", key=key)
        self.n_fits += 1
        prep = self._prepare(
            key, torch.as_tensor(x, dtype=torch.float32, device=dev), h, cfg)
        self._store[key] = prep
        return prep

    # -- the one-time expensive pass ------------------------------------

    def _prepare(self, key: str, x: torch.Tensor, h: Optional[float],
                 cfg: ServeConfig) -> PreparedEstimator:
        n, d = x.shape
        if h is None:
            h = (bw.sdkde_bandwidth(x) if cfg.method == "sdkde"
                 else bw.silverman_bandwidth(x))
        h = float(h)
        if cfg.stream:
            return self._prepare_stream(key, x, h, cfg)
        points = self._debias(x, h, cfg) if cfg.method == "sdkde" else x
        prep = PreparedEstimator(
            key=key, config=cfg, h=h, n_true=n, d=d,
            generation=self.n_fits, points=points,
            norm=n * gaussian_norm_const(d, 1.0) * h**d,
        )
        if cfg.backend == "flash":
            prep.block_m, prep.block_n = cfg.block_m, cfg.block_n
            prep.columns_for(cfg.precision)
        return prep

    def _prepare_stream(self, key: str, x: torch.Tensor, h: float,
                        cfg: ServeConfig) -> PreparedEstimator:
        """Fit a streaming estimator: the one full score pass happens in
        the stream's constructor; every later ``append``/``evict_ids`` is
        an O(n·b·d) delta against this state."""
        from repro_torch.stream import StreamConfig, StreamingSDKDE

        n, d = x.shape
        prep = PreparedEstimator(
            key=key, config=cfg, h=h, n_true=n, d=d,
            generation=self.n_fits, points=x,
            norm=n * gaussian_norm_const(d, 1.0) * h**d,
        )
        if cfg.backend == "flash":
            prep.block_m, prep.block_n = cfg.block_m, cfg.block_n
        prep.stream = StreamingSDKDE(
            x, h, method=cfg.method, score_h=cfg.score_h,
            backend=cfg.backend, block_n=cfg.block_n,
            precision=cfg.precision,
            config=StreamConfig(slack=cfg.stream_slack,
                                staleness_budget=cfg.staleness_budget,
                                background=cfg.stream_background),
            device=x.device)
        prep.points = prep.stream.snapshot().points
        return prep

    def _debias(self, x: torch.Tensor, h: float, cfg: ServeConfig):
        """The O(n²·d) score pass — once per registered key, through the
        core estimator (one backend dispatch for the whole port).  Like
        ``fit_precision``, the amortized fit never spends an epsilon
        budget: exact (underflow-only) pruning at most."""
        from repro_torch.core.estimator import SDKDE, EstimatorConfig

        est_cfg = EstimatorConfig(
            backend=cfg.backend, block=cfg.block, block_m=cfg.block_m,
            block_n=cfg.block_n, score_h=cfg.score_h,
            precision=cfg.fit_precision,
            prune="auto" if cfg.prune != "off" else "off", device=cfg.device,
        )
        return SDKDE(h, est_cfg).fit(x).x_sd


__all__ = ["PreparedEstimator", "EstimatorRegistry"]
