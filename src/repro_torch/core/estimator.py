"""High-level estimator API: KDE / SDKDE with backend dispatch.

The counterpart of ``repro.core.estimator``.  Backends:

  * ``flash`` — the hand-written kernels (``repro_torch.kernels.ops``):
                B1 for the fit's score pass, B2 for every evaluation, or
                their pruned forms B3 / B4 when ``prune`` engages (by
                default at ≥16384 train points, ``ops.resolve_prune``);
                ``LaplaceKDE`` evaluates through B5 (B4 with its
                ``laplace`` flag when pruning), or B2 + B6 unfused.
                The default.  On CPU tensors the kernels' plain PyTorch
                versions run instead.
  * ``torch`` — the streaming plain math of ``core/kde.py``.
  * ``ring``  — ring sharding over ``torch.distributed``
                (``repro_torch.distributed.ring``) on the world the
                process runs in, a ring of one without one: each ring
                step one launch of B1 (rectangular: resident rows against
                a visiting block), B2 or B5.  Every rank passes the whole
                arrays and gets the whole result, as ``repro``'s callers
                see one global array; the points are padded with
                sentinels to the ring size and sharded in rank order.
                f32 and dense: ``precision``, ``prune`` and the tiles
                are ignored, as ``repro``'s ring ignores them, and
                ``LaplaceKDE(fused=False)`` runs fused too.

Estimators run on ``config.device`` ("cuda" by default; asking for the
card where there is none raises).  ``SDKDE.append``/``evict`` update a
fitted estimator through the streaming delta pass (``stream/delta.py``).
While tracing is on (``repro_torch.obs``) ``fit`` and ``evaluate`` open
``estimator.fit`` / ``estimator.evaluate`` spans, and the bandwidth's
read to the host a ``sync.bandwidth`` span.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import obs
from repro_torch.core import bandwidth as bw
from repro_torch.core import kde as ref
from repro_torch.distributed import ring
from repro_torch.kernels import ops
from repro_torch.kernels import precision as prec

Backend = Literal["flash", "torch", "ring"]
BACKENDS = ("flash", "torch", "ring")


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (choose from "
                         f"{BACKENDS})")


@dataclasses.dataclass
class EstimatorConfig:
    backend: Backend = "flash"
    block: int = 1024            # streaming column-block size (torch backend)
    # kernel tiles: ints, or "auto" (tuned per shape by kernels/autotune,
    # timed on the card when the points live there)
    block_m: "int | str" = 128   # kernel row tile (rows padded to it)
    block_n: "int | str" = 128   # kernel column tile (points per stage)
    score_h: Optional[float] = None  # score-estimation bandwidth (None = h)
    precision: str = "f32"       # GEMM-operand tier (kernels/precision)
    # cluster pruning (kernels/spatial.py): "auto" = exact pruning at
    # >= 16384 train points, "off" = dense, float = epsilon >= 0
    prune: "str | float" = "auto"
    device: str = "cuda"         # "cuda" (raises without a card) or "cpu"

    def __post_init__(self):
        check_backend(self.backend)
        ops.check_prune(self.prune)
        ops.check_blocks(self.block_m, self.block_n)
        prec.validate(self.precision)
        if self.block < 1:
            raise ValueError(f"bad block {self.block!r}")


class KDE:
    """Classical Gaussian KDE."""

    def __init__(self, h=None, config: EstimatorConfig | None = None):
        self.h = None if h is None else float(h)
        self.config = config or EstimatorConfig()
        self.x_train: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return device_mod.resolve(self.config.device)

    def _as_points(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def fit(self, x) -> "KDE":
        with obs.span("estimator.fit", backend=self.config.backend) as sp:
            self.x_train = self._as_points(x)
            sp.set(rows=self.x_train.shape[0])
            if self.h is None:
                with obs.span("sync.bandwidth"):
                    self.h = float(bw.silverman_bandwidth(self.x_train))
        return self

    def _train_points(self) -> torch.Tensor:
        if self.x_train is None:
            raise RuntimeError("call fit() first")
        return self.x_train

    def evaluate(self, y) -> torch.Tensor:
        x = self._train_points()
        cfg = self.config
        with obs.span("estimator.evaluate", backend=cfg.backend) as sp:
            y = self._as_points(y)
            sp.set(rows=y.shape[0])
            if cfg.backend == "flash":
                return ops.flash_kde(x, y, self.h, precision=cfg.precision,
                                     block_m=cfg.block_m,
                                     block_n=cfg.block_n, prune=cfg.prune)
            if cfg.backend == "ring":
                return _on_ring(ring.ring_kde, x, y, h=self.h,
                                n_true=x.shape[0])
            return ref.kde_eval(x, y, self.h, block=cfg.block)

    __call__ = evaluate


def _on_ring(fn, *arrays: torch.Tensor, **kw) -> torch.Tensor:
    """``fn`` on this rank's shards of whole ``arrays`` over the default
    mesh, and its rows (one per row of the last array) gathered back."""
    mesh = ring.default_mesh()
    out = fn(*(ring.shard_points(a, mesh, ("data",)) for a in arrays),
             mesh=mesh, **kw)
    return ring.gather_rows(out, mesh, ("data",))[:arrays[-1].shape[0]]


class SDKDE(KDE):
    """Score-debiased KDE: empirical-score shift + KDE on debiased samples.

    ``fit`` performs the quadratic score pass (the paper's hot spot, kernel
    B1 on the flash backend) and caches the debiased samples; ``evaluate``
    is then a standard KDE pass (kernel B2; B3 / B4 when pruning).

    ``append``/``evict`` update a fitted estimator *incrementally* — the
    O(n·b·d) delta score pass of ``repro_torch.stream.delta`` instead of a
    fresh O(n²·d) fit.  The first incremental call pays one full pass to
    seed float64 score statistics; every later update is a delta against
    them, and the debiased samples are recomputed from the maintained
    statistics.  The bandwidth stays the fit-time one.
    """

    def __init__(self, h=None, config: EstimatorConfig | None = None):
        super().__init__(h, config)
        self.x_sd: torch.Tensor | None = None
        self._s0 = self._s1 = None       # f64 score stats (lazy, streaming)

    def fit(self, x) -> "SDKDE":
        cfg = self.config
        with obs.span("estimator.fit", backend=cfg.backend) as sp:
            self.x_train = self._as_points(x)
            sp.set(rows=self.x_train.shape[0])
            self._s0 = self._s1 = None   # a refit invalidates seeded stats
            if self.h is None:
                with obs.span("sync.bandwidth"):
                    self.h = float(bw.sdkde_bandwidth(self.x_train))
            if cfg.backend == "flash":
                self.x_sd = ops.flash_sdkde_shift(
                    self.x_train, self.h, score_h=cfg.score_h,
                    precision=cfg.precision, block_m=cfg.block_m,
                    block_n=cfg.block_n, prune=cfg.prune)
            elif cfg.backend == "ring":
                self.x_sd = _on_ring(ring.ring_sdkde_shift, self.x_train,
                                     h=self.h, score_h=cfg.score_h)
            else:
                self.x_sd = ref.sdkde_shift(self.x_train, self.h,
                                            score_h=cfg.score_h,
                                            block=cfg.block)
        return self

    def _train_points(self) -> torch.Tensor:
        if self.x_sd is None:
            raise RuntimeError("call fit() first")
        return self.x_sd

    # -- incremental updates (repro_torch.stream.delta) ------------------

    def _score_h(self) -> float:
        sh = self.config.score_h
        return float(self.h if sh is None else sh)

    def _seed_stats(self) -> None:
        from repro_torch.stream import delta

        if self._s0 is None:
            self._s0, self._s1 = delta.initial_stats(self.x_train,
                                                     self._score_h())

    def _refresh_shift(self) -> None:
        from repro_torch.stream import delta

        self.x_sd = delta.apply_shift(self.x_train, self._s0, self._s1,
                                      self.h, self._score_h()).to(
            torch.float32)

    def append(self, x_new) -> "SDKDE":
        """Fold new points into a fitted estimator without a refit."""
        from repro_torch.stream import delta

        self._train_points()
        x_new = torch.atleast_2d(self._as_points(x_new))
        self._seed_stats()
        ds0, ds1, s0n, s1n = delta.append_delta(self.x_train, x_new,
                                                self._score_h())
        self._s0 = torch.cat([self._s0 + ds0, s0n])
        self._s1 = torch.cat([self._s1 + ds1, s1n])
        self.x_train = torch.cat([self.x_train, x_new])
        self._refresh_shift()
        return self

    def evict(self, idx) -> "SDKDE":
        """Remove train rows (by position) without a refit."""
        from repro_torch.stream import delta

        self._train_points()
        out = np.zeros(self.x_train.shape[0], bool)
        out[np.atleast_1d(np.asarray(idx, np.int64))] = True
        if out.all():
            raise ValueError("cannot evict every train point")
        self._seed_stats()
        keep = torch.as_tensor(np.flatnonzero(~out), device=self.device)
        gone = torch.as_tensor(np.flatnonzero(out), device=self.device)
        x_keep = self.x_train.index_select(0, keep)
        ds0, ds1 = delta.evict_delta(
            x_keep, self.x_train.index_select(0, gone), self._score_h())
        self._s0 = self._s0.index_select(0, keep) - ds0
        self._s1 = self._s1.index_select(0, keep) - ds1
        self.x_train = x_keep
        self._refresh_shift()
        return self


class LaplaceKDE(KDE):
    """Laplace-corrected KDE (Flash-Laplace-KDE when fused).

    The kernel K_h(u)·(1 + d/2 − ‖u‖²/(2h²)) on the raw train points with
    the Silverman bandwidth; signed, so densities may dip below zero in
    the tails.  ``fused=False`` runs the two-pass baseline, which stays
    dense whatever ``prune`` says, as in ``repro``."""

    def __init__(self, h=None, config: EstimatorConfig | None = None,
                 fused: bool = True):
        super().__init__(h, config)
        self.fused = fused

    def evaluate(self, y) -> torch.Tensor:
        x = self._train_points()
        cfg = self.config
        with obs.span("estimator.evaluate", backend=cfg.backend) as sp:
            y = self._as_points(y)
            sp.set(rows=y.shape[0])
            if cfg.backend == "flash":
                if self.fused:
                    return ops.flash_laplace_kde(
                        x, y, self.h, precision=cfg.precision,
                        block_m=cfg.block_m, block_n=cfg.block_n,
                        prune=cfg.prune)
                return ops.laplace_kde_nonfused(
                    x, y, self.h, precision=cfg.precision,
                    block_m=cfg.block_m, block_n=cfg.block_n)
            if cfg.backend == "ring":
                return _on_ring(ring.ring_laplace_kde, x, y, h=self.h,
                                n_true=x.shape[0])
            if self.fused:
                return ref.laplace_kde_eval(x, y, self.h, block=cfg.block)
            return ref.laplace_kde_eval_nonfused(x, y, self.h,
                                                 block=cfg.block)

    __call__ = evaluate


__all__ = ["Backend", "BACKENDS", "EstimatorConfig", "KDE", "LaplaceKDE",
           "SDKDE", "check_backend"]
