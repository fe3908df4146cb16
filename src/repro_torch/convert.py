"""Carry fitted state from the JAX package into the port.

The converters take numpy arrays and plain scalars — what
``np.asarray`` of the JAX package's state gives — so this module imports
nothing of JAX:

  * ``sdkde_from_state`` — a fitted ``repro.core.estimator.SDKDE``
    (``x_train``, ``x_sd``, ``h``, ``score_h``) becomes a fitted port
    ``SDKDE`` without running the score pass again;
  * ``laplace_from_state`` — a fitted ``repro.core.estimator.LaplaceKDE``
    (``x_train``, ``h``, ``fused``) becomes a fitted port ``LaplaceKDE``;
  * ``prepared_from_state`` — a ``repro.serve.registry.PreparedEstimator``
    (``points``, ``h``, ``n_true``, ``d``, ``norm``, block sizes) becomes
    the port's ``PreparedEstimator``, ready to be adopted by a registry,
    for any method (``config.method``: ``"kde"``, ``"sdkde"`` or
    ``"laplace"``);
  * ``index_from_state`` — a fitted ``repro.kernels.spatial.SpatialIndex``
    (``labels``, ``centroids``, ``method``) becomes the port's, so a
    pruned path can run on JAX's clustering (the two packages' k-means
    draw different random numbers from the same seed);
  * ``stream_from_state`` — a flushed ``repro.stream.StreamingSDKDE``
    (live points, ids, f64 statistics, index, slab geometry, slots,
    labels, occupied mask, layout points, generation and layout epoch)
    becomes the port's stream, so one sequence of updates can drive both
    and their layouts be compared slot for slot;
  * ``rff_from_state`` — a fitted ``repro.kernels.flash_rff.RFFState``
    (frequencies, feature sums, pilot anchors and moments, ``p_scale``,
    ``h``, ``n``, ``groups``) becomes the port's, so both packages
    evaluate one state (each package's k-means draws its own anchors);
  * ``lm_params_from_state`` — ``repro.models.common.init_params``'
    output (or any parameter dict of that layout) becomes the port's
    parameter dict for ``repro_torch.models``, so both packages compute
    the same model.

With these the KDE pass can be held against JAX's on a debiased set that
JAX computed, apart from the score pass, and the pruned path on
identical layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.bandwidth import gaussian_norm_const
from repro_torch.core.estimator import SDKDE, EstimatorConfig, LaplaceKDE
from repro_torch.kernels.flash_rff import RFFState
from repro_torch.kernels.spatial import SpatialIndex
from repro_torch.models.common import ModelConfig, param_shapes
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.registry import PreparedEstimator
from repro_torch.stream import StreamConfig, StreamingSDKDE


def sdkde_from_state(x_train: np.ndarray, x_sd: np.ndarray, h: float,
                     score_h: Optional[float] = None,
                     config: EstimatorConfig | None = None) -> SDKDE:
    """A fitted port ``SDKDE`` holding the given train and debiased sets."""
    cfg = config or EstimatorConfig()
    if score_h is not None:
        cfg = dataclasses.replace(cfg, score_h=float(score_h))
    est = SDKDE(float(h), cfg)
    est.x_train = est._as_points(np.array(x_train, np.float32))
    est.x_sd = est._as_points(np.array(x_sd, np.float32))
    return est


def laplace_from_state(x_train: np.ndarray, h: float, fused: bool = True,
                       config: EstimatorConfig | None = None) -> LaplaceKDE:
    """A fitted port ``LaplaceKDE`` on the given train set."""
    est = LaplaceKDE(float(h), config or EstimatorConfig(), fused=bool(fused))
    est.x_train = est._as_points(np.array(x_train, np.float32))
    return est


def index_from_state(labels: Optional[np.ndarray],
                     centroids: Optional[np.ndarray], method: str = "kmeans",
                     device: str = "cuda") -> SpatialIndex:
    """The port's ``SpatialIndex`` for a fitted JAX one: int32 labels
    (n,) and f32 centroids (k, d) (None for a Morton index) on
    ``device``."""
    dev = device_mod.resolve(device)
    return SpatialIndex(
        None if labels is None else torch.as_tensor(
            np.array(labels, np.int32), device=dev),
        None if centroids is None else torch.as_tensor(
            np.array(centroids, np.float32), device=dev),
        method)


def prepared_from_state(key: str, points: np.ndarray, h: float, n_true: int,
                        d: int, norm: float, *, block_m: int = 128,
                        block_n: int = 128,
                        config: ServeConfig | None = None,
                        index: Optional[SpatialIndex] = None
                        ) -> PreparedEstimator:
    """The port's ``PreparedEstimator`` for a JAX-prepared one.

    ``points`` are the (debiased) train points the JAX estimator serves;
    the port prepares its own column layout from them at the config's
    tier, clustered by ``index`` (``index_from_state``) when the config's
    pruning engages.  Register the result with ``EstimatorRegistry.adopt``.
    """
    cfg = config or ServeConfig()
    cfg = dataclasses.replace(cfg, block_m=int(block_m), block_n=int(block_n))
    dev = device_mod.resolve(cfg.device)
    pts = torch.as_tensor(np.array(points, np.float32), device=dev)
    if tuple(pts.shape) != (int(n_true), int(d)):
        raise ValueError(f"points {tuple(pts.shape)} do not match "
                         f"(n_true={n_true}, d={d})")
    prep = PreparedEstimator(
        key=key, config=cfg, h=float(h), n_true=int(n_true), d=int(d),
        generation=0, points=pts, norm=float(norm), index=index,
    )
    if cfg.backend == "flash":
        prep.block_m, prep.block_n = cfg.block_m, cfg.block_n
        prep.columns_for(cfg.precision)
    return prep


def stream_from_state(x: np.ndarray, ids: np.ndarray, next_id: int,
                      h: float, *, gen: int, layout_epoch: int,
                      s0: Optional[np.ndarray] = None,
                      s1: Optional[np.ndarray] = None,
                      method: str = "sdkde", score_h: Optional[float] = None,
                      backend: str = "flash", block_n: int = 128,
                      precision: str = "f32",
                      config: StreamConfig | None = None, seed: int = 0,
                      index: Optional[SpatialIndex] = None,
                      starts: Optional[np.ndarray] = None,
                      caps: Optional[np.ndarray] = None,
                      slots: Optional[np.ndarray] = None,
                      labels: Optional[np.ndarray] = None,
                      real: Optional[np.ndarray] = None,
                      xp: Optional[np.ndarray] = None,
                      policy: Optional[dict] = None,
                      device: str = "cuda") -> StreamingSDKDE:
    """The port's ``StreamingSDKDE`` for a JAX one, taken after a flush
    (nothing dirty, its snapshot at ``gen``).

    ``x`` / ``ids`` / ``next_id`` are the live set, ``s0`` / ``s1`` its
    f64 statistics (sdkde).  On the flash backend the layout comes over
    as it is: ``index`` (``index_from_state``), the slab ``starts`` /
    ``caps``, each live point's ``slots`` and ``labels``, the occupied
    mask ``real`` and the layout points ``xp``.  ``policy`` carries the
    rebuild policy's counters (``base_size``, ``appends``, ``evicts``,
    ``base_mean_radius``, ``overflowed``).  The port publishes generation
    ``gen`` from the carried layout, every tier's columns built anew; no
    k-means runs, so both packages then place the same appends in the
    same slots.
    """
    st = StreamingSDKDE.__new__(StreamingSDKDE)
    st._setup(h, method=method, score_h=score_h, backend=backend,
              block_n=block_n, precision=precision, config=config,
              seed=seed, device=device)
    dev = st.device
    st.x = torch.as_tensor(np.array(x, np.float32), device=dev)
    st.d = int(st.x.shape[1])
    st.ids = np.array(ids, np.int64)
    st.next_id = int(next_id)
    if method == "sdkde":
        st.s0 = torch.as_tensor(np.array(s0, np.float64), device=dev)
        st.s1 = torch.as_tensor(np.array(s1, np.float64), device=dev)
    else:
        st.s0 = st.s1 = None
    st.gen, st.layout_epoch = int(gen), int(layout_epoch)
    st.policy.reset(st.x.shape[0])
    for k, v in (policy or {}).items():
        if k not in ("base_size", "appends", "evicts", "base_mean_radius",
                     "overflowed"):
            raise ValueError(f"unknown rebuild-policy field {k!r}")
        setattr(st.policy, k, v)
    st._dirty = torch.zeros(st.x.shape[0], dtype=torch.bool, device=dev)
    x_sd = st._shifted()
    if backend == "flash":
        st._index = index
        st._starts = np.array(starts, np.int64)
        st._caps = np.array(caps, np.int64)
        st._slots = np.array(slots, np.int64)
        st._labels = np.array(labels, np.int64)
        st._real = np.array(real, bool)
        st._xp = torch.as_tensor(np.array(xp, np.float32), device=dev)
        st._snapshot = st._publish_full(x_sd, st._norm(st.x.shape[0]))
    else:
        st._snapshot = st._build_snapshot()
    return st


def rff_from_state(w: np.ndarray, z_cos: np.ndarray, z_sin: np.ndarray,
                   centroids: np.ndarray, pilot_n: np.ndarray,
                   pilot_s1: np.ndarray, pilot_ss: np.ndarray, *,
                   p_scale: float, h: float, n: int, groups: int,
                   seed: int = 0, device: str = "cuda") -> RFFState:
    """The port's ``RFFState`` for a JAX-fitted one: its float64 arrays
    (``w`` (D/2, d), ``z_cos`` / ``z_sin`` (D/2,), ``centroids`` (K, d),
    ``pilot_n`` / ``pilot_ss`` (K,), ``pilot_s1`` (K, d)) on ``device``,
    and its scalars."""
    dev = device_mod.resolve(device)

    def f64(a):
        return torch.as_tensor(np.array(a, np.float64), device=dev)

    wt = f64(w)
    d = int(wt.shape[1])
    return RFFState(
        h=float(h), d=d, n=int(n), groups=int(groups), seed=int(seed),
        npp=gaussian_norm_const(d, 1.0) * float(h) ** d, w=wt,
        z_cos=f64(z_cos), z_sin=f64(z_sin), centroids=f64(centroids),
        pilot_n=f64(pilot_n), pilot_s1=f64(pilot_s1),
        pilot_ss=f64(pilot_ss), p_scale=float(p_scale))


def lm_params_from_state(params: "dict[str, np.ndarray]", cfg: ModelConfig,
                         device: str = "cuda") -> "dict[str, torch.Tensor]":
    """The port's parameter dict for a ``repro`` one given as numpy
    arrays (``{k: np.asarray(v)}``): the same names and shapes, each
    tensor in ``cfg.param_dtype`` on ``device``.  Raises when a name is
    missing or extra, or a shape differs from ``param_shapes(cfg)``."""
    dev = device_mod.resolve(device)
    shapes = param_shapes(cfg)
    missing, extra = set(shapes) - set(params), set(params) - set(shapes)
    if missing or extra:
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(missing)}, extra {sorted(extra)}")
    out = {}
    for name, (shape, dtype) in shapes.items():
        # bf16 numpy arrays (ml_dtypes) widen exactly to float32
        arr = np.asarray(params[name]).astype(np.float32)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[name] = torch.as_tensor(arr, device=dev).to(dtype)
    return out


__all__ = ["sdkde_from_state", "laplace_from_state", "prepared_from_state",
           "index_from_state", "stream_from_state", "lm_params_from_state"]
