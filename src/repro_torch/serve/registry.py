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
index, clustered once.  On the ``ring`` backend the prepared state is the
mesh and this rank's shard of the (sentinel-padded) points: the debias
fit and every query batch run the ring (``repro_torch.distributed.ring``).

With ``ServeConfig(stream=True)`` a registered dataset is a
``repro_torch.stream.StreamingSDKDE``: ``append`` / ``evict_ids`` /
``slide`` fold updates in without a refit, and the prepared state is the
stream's published snapshot.

``ServeConfig(plan="auto")`` resolves the config's unset knobs through
the planner once per fit (``plan.resolve_config``), and ``"auto"`` tiles
are tuned once per fit (``_resolve_fit_blocks``).  The RFF fast tier
(``_RFFTier``) is fitted once per generation, eagerly under
``rff="on"``, on the first cascade-routed request under ``"auto"``; on a
stream it follows each served snapshot by an id diff (``_sync``) folded
in on the card, and refits on a layout rebuild.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import fault_injection, obs
from repro_torch.core import bandwidth as bw
from repro_torch.core.bandwidth import gaussian_norm_const
from repro_torch.core.kde import pad_rows
from repro_torch.distributed import ring
from repro_torch.kernels import autotune, flash_rff, ops, spatial
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
    block_m: Optional[int] = None   # flash: kernel tiles, resolved at fit
    block_n: Optional[int] = None
    # ring: the mesh and this rank's row shard of the sentinel-padded
    # points (every rank holds one)
    mesh: object = None
    x_sharded: Optional[torch.Tensor] = None
    # the spatial index every tier's clustered columns share (pruning)
    index: Optional[spatial.SpatialIndex] = None
    # streaming (config.stream): the incrementally maintained live state;
    # the prepared-state accessors read its published snapshot
    stream: object = None
    # plan="auto": the ExecutionPlan the knobs were resolved from (spans
    # and answers carry its id; planned estimators prewarm); None when
    # the config pinned every knob
    plan: object = None
    # the RFF fast tier's lifecycle (_RFFTier), None when disabled or
    # unsupported for the method
    rff: object = None
    _columns: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def ring_size(self) -> int:
        """Ranks the ring shards over (1 off the ring backend)."""
        return (ring.ring_size(self.mesh, ("data",))
                if self.mesh is not None else 1)

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


class _RFFTier:
    """Lifecycle of one estimator's RFF fast-tier state.

    Fits once per static generation.  On a stream, consecutive snapshots
    are diffed by live id on the host (the ids live there): appended,
    evicted and debias-shifted rows fold into the exact feature sums as
    an O(b·D·d/2) float64 delta on the card — a shifted survivor counts
    as an eviction of its old coordinates and an append of its new ones,
    weighted by a 0/1 "moved" mask computed on the card, so nothing is
    read back.  A layout-epoch rebuild refits,
    since the pilot anchors are stale by construction then."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self.state: Optional[flash_rff.RFFState] = None
        self._epoch: Optional[int] = None
        self._gen: Optional[int] = None
        self._ids: Optional[np.ndarray] = None
        self._points: Optional[torch.Tensor] = None
        self._lock = threading.Lock()
        self.fits = 0
        self.syncs = 0

    def _fit(self, points: torch.Tensor, h: float) -> None:
        cfg = self.cfg
        with obs.span("rff.fit", n=int(points.shape[0]),
                      features=cfg.rff_features):
            self.state = flash_rff.fit(
                points, h, n_features=cfg.rff_features,
                n_pilot=cfg.rff_pilot, groups=cfg.rff_groups)
        self.fits += 1
        obs.counter("rff.fits", "RFF tier fits (full featurization "
                    "passes)").inc()

    def serving(self, prep: "PreparedEstimator", snap=None):
        """The tier's serving tensors, synced to ``snap`` if streaming."""
        with self._lock:
            if prep.stream is None:
                if self.state is None:
                    self._fit(prep.points, prep.h)
                return self.state.serving()
            if snap is None:
                snap = prep.stream.ensure(self.cfg.staleness_budget)
            if snap.ids is None:
                return None
            if self.state is None or snap.layout_epoch != self._epoch:
                self._fit(snap.points, prep.h)
            elif snap.gen != self._gen:
                self._sync(snap)
            if snap.gen != self._gen or snap.layout_epoch != self._epoch:
                self._epoch, self._gen = snap.layout_epoch, snap.gen
                self._ids = np.asarray(snap.ids, np.int64)
                self._points = snap.points
            return self.state.serving()

    def _sync(self, snap) -> None:
        """Fold the id/value diff between the last synced snapshot and
        ``snap`` into the accumulators (see the class docstring)."""
        ids = np.asarray(snap.ids, np.int64)
        pts = snap.points
        dev = pts.device
        _, i_new, i_old = np.intersect1d(ids, self._ids, assume_unique=True,
                                         return_indices=True)
        fresh = np.setdiff1d(np.arange(ids.size), i_new, assume_unique=True)
        gone = np.setdiff1d(np.arange(self._ids.size), i_old,
                            assume_unique=True)
        def up(rows: np.ndarray) -> torch.Tensor:
            return spatial.upload(rows.astype(np.int64), dev)

        now = pts.index_select(0, up(i_new))
        was = self._points.index_select(0, up(i_old))
        moved = (now != was).any(dim=1).to(torch.float64)
        flash_rff.update(
            self.state,
            added=torch.cat([pts.index_select(0, up(fresh)), now]),
            removed=torch.cat([self._points.index_select(0, up(gone)), was]),
            added_weights=torch.cat([moved.new_ones(fresh.size), moved]),
            removed_weights=torch.cat([moved.new_ones(gone.size), moved]),
            n_live=ids.size)
        self.syncs += 1
        obs.counter("rff.incremental_syncs",
                    "RFF feature-sum delta updates across stream "
                    "generations").inc()


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

    def rff_serving(self, prep: PreparedEstimator, snap=None):
        """The RFF tier's serving tensors for one estimator, or None when
        the tier is disabled or unsupported (fitted on first use under
        ``rff="auto"``)."""
        if prep.rff is None:
            return None
        return prep.rff.serving(prep, snap=snap)

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
        # the plan resolves once per fit, before any backend branch: knobs
        # still at their defaults come from the planner, set ones win
        plan_obj = None
        if cfg.plan == "auto":
            from repro_torch.plan import resolve_config

            cfg, plan_obj = resolve_config(cfg, n=n, d=d)
        if cfg.stream:
            return self._prepare_stream(key, x, h, cfg, plan_obj)
        points = self._debias(x, h, cfg) if cfg.method == "sdkde" else x
        prep = PreparedEstimator(
            key=key, config=cfg, h=h, n_true=n, d=d,
            generation=self.n_fits, points=points,
            norm=n * gaussian_norm_const(d, 1.0) * h**d, plan=plan_obj,
        )
        self._attach_rff(prep, cfg)
        if cfg.backend == "flash":
            prep.block_m, prep.block_n = self._resolve_fit_blocks(
                cfg, n, d, x.device)
            prep.columns_for(cfg.exact_precision)
        elif cfg.backend == "ring":
            prep.mesh = ring.default_mesh()
            prep.x_sharded = ring.shard_points(points, prep.mesh, ("data",))
        return prep

    @staticmethod
    def _attach_rff(prep: PreparedEstimator, cfg: ServeConfig) -> None:
        """Attach (and under ``rff="on"`` fit, beside the debias pass) the
        RFF fast tier, once per generation."""
        if cfg.rff == "off" or not flash_rff.supports(cfg.method,
                                                      cfg.backend):
            return
        prep.rff = _RFFTier(cfg)
        if cfg.rff == "on" and prep.stream is None:
            prep.rff._fit(prep.points, prep.h)

    @staticmethod
    def _resolve_fit_blocks(cfg: ServeConfig, n: int, d: int,
                            device: torch.device):
        """Resolve "auto" tiles once per fit: rows the largest bucket this
        estimator dispatches, columns the train count, launchable at
        every tier (per-request pins reuse the tile); timed on the card
        when the points live there.  The tiles shape the bucket ladder
        and the prepared padding, so they live on the estimator."""
        return autotune.resolve_blocks(
            cfg.block_m, cfg.block_n, rows=cfg.max_batch, cols=n, d=d,
            out_width=1, precision=cfg.exact_precision, gate_all_tiers=True,
            pruned=cfg.prune != "off", device=device)

    def _prepare_stream(self, key: str, x: torch.Tensor, h: float,
                        cfg: ServeConfig,
                        plan_obj: object = None) -> PreparedEstimator:
        """Fit a streaming estimator: the one full score pass happens in
        the stream's constructor; every later ``append``/``evict_ids`` is
        an O(n·b·d) delta against this state."""
        from repro_torch.stream import StreamConfig, StreamingSDKDE

        n, d = x.shape
        prep = PreparedEstimator(
            key=key, config=cfg, h=h, n_true=n, d=d,
            generation=self.n_fits, points=x,
            norm=n * gaussian_norm_const(d, 1.0) * h**d, plan=plan_obj,
        )
        block_n = cfg.block_n if isinstance(cfg.block_n, int) else 128
        if cfg.backend == "flash":
            prep.block_m, prep.block_n = self._resolve_fit_blocks(
                cfg, n, d, x.device)
            block_n = prep.block_n
        prep.stream = StreamingSDKDE(
            x, h, method=cfg.method, score_h=cfg.score_h,
            backend=cfg.backend, block_n=block_n,
            precision=cfg.exact_precision,
            config=StreamConfig(slack=cfg.stream_slack,
                                staleness_budget=cfg.staleness_budget,
                                background=cfg.stream_background),
            device=x.device)
        prep.points = prep.stream.snapshot().points
        self._attach_rff(prep, cfg)
        return prep

    def _debias(self, x: torch.Tensor, h: float, cfg: ServeConfig):
        """The O(n²·d) score pass — once per registered key, through the
        core estimator (one backend dispatch for the whole port).  Like
        ``fit_precision``, the amortized fit never spends an epsilon
        budget: exact (underflow-only) pruning at most.  On the ring the
        set is padded with sentinels to the ring size first, since a
        registered dataset's size need not divide it."""
        from repro_torch.core.estimator import SDKDE, EstimatorConfig

        n = x.shape[0]
        if cfg.backend == "ring":
            x = pad_rows(x, ring.ring_size(ring.default_mesh(), ("data",)))
        est_cfg = EstimatorConfig(
            backend=cfg.backend, block=cfg.block, block_m=cfg.block_m,
            block_n=cfg.block_n, score_h=cfg.score_h,
            precision=cfg.fit_precision,
            prune="auto" if cfg.prune != "off" else "off", device=cfg.device,
        )
        return SDKDE(h, est_cfg).fit(x).x_sd[:n]


__all__ = ["PreparedEstimator", "EstimatorRegistry"]
