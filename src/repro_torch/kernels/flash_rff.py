"""Random-Fourier-feature fast tier: one small product per query, banded.

The counterpart of ``repro.kernels.flash_rff``.  With frequencies
``w_j ~ N(0, I/h²)`` the Gaussian kernel is the expectation
``k(y, x) = E_w[cos(w·y)cos(w·x) + sin(w·y)sin(w·x)]``, so the kernel sum
``S(y) = Σ_i k(y, x_i)`` is estimated from per-dataset feature sums

    z_cos[j] = Σ_i cos(w_j·x_i),   z_sin[j] = Σ_i sin(w_j·x_i)

as ``Ŝ(y) = mean_j [cos(w_j·y)·z_cos[j] + sin(w_j·y)·z_sin[j]]``: one
(m × d)@(d × D/2) phase product plus trig per query batch, independent
of n.  Two additions make it a tier the cascade can route on:

**Pilot control variate.**  Per-cluster Gaussian moments (counts, means,
mean per-dimension variances over the k-means cells of
``kernels.spatial``) give an analytic pilot term, and the features
estimate only the residual: ``S(y) ≈ S_pilot(y) + mean_j [cos(w_j·y)·rc_j
+ sin(w_j·y)·rs_j]`` with ``rc = z_cos − z_pilot_cos``.

**Per-query band.**  The D/2 frequencies fall into ``groups``
independent groups; their spread gives a standard error, and the band is

    band(y) = Z · stderr(y) / max(p̂(y) − Z · stderr(y), TAIL_FRAC · p_scale)

**Departure from repro (ROADMAP C).**  ``repro`` divides by
``max(|p̂|, floor)``.  Where p̂ overshoots the true density, that
denominator grows with the error it should bound, and the band
understates the error (``tests/test_rff_cascade.py::
test_band_dominates_realized_error[2048-4-0]``, row 66: band 1.54 against
a realized 3.22).  The port divides by the lower end of the estimate's
own Z-interval instead: never larger than ``repro``'s denominator, so the
band is at least ``repro``'s on every row, and ``p̂`` is unchanged.

On the card: the fit's feature sums are f32 ``cos``/``sin`` of ``x @ wt``
a block, accumulated in float64; ``update`` folds a delta in float64 on
the same device (weights per row let a streaming sync fold shifted
survivors without reading them back); ``eval_density`` keeps ``p`` and
the band on the device.  No kernel of its own: the phase product is a
plain matrix product (``repro`` has no Pallas kernel here either).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.bandwidth import gaussian_norm_const
from repro_torch.kernels import precision as prec
from repro_torch.kernels import spatial, tuning

#: Total feature count D (a cos and a sin per frequency: D/2 frequencies).
DEFAULT_FEATURES = 8192
#: Pilot mixture size (k-means cells whose Gaussian moments are fitted).
DEFAULT_PILOT = 256
#: Independent frequency groups behind the standard error: the band's
#: t-statistic has groups − 1 degrees of freedom (repro's reasoning: at
#: Z = 5, P(|t₃₁| > 5) ≈ 1e-5).
DEFAULT_GROUPS = 32
#: Band factor Z.
BAND_Z = 5.0
#: Tail floor of band and realized error, a fraction of the fitted
#: density scale ``p_scale``.
TAIL_FRAC = 0.01
#: Bandwidth scale of the frequency distribution; 1.0 keeps the tier's
#: estimand the exact tier's kernel sum (repro's H_SCALE).
H_SCALE = 1.0

_FIT_BLOCK = 16384
_P_SCALE_SAMPLE = 512
_P_SCALE_PCT = 99.0


@dataclasses.dataclass(frozen=True)
class RFFServing:
    """Per-generation serving tensors, on the state's device, finalized
    from the exact accumulators of :class:`RFFState`."""

    wt: torch.Tensor        # (d, D/2) f32 phase-product operand
    res_cos: torch.Tensor   # (D/2,) f32 residual feature sums
    res_sin: torch.Tensor   # (D/2,) f32
    mu: torch.Tensor        # (K, d) f32 live pilot means
    beta: torch.Tensor      # (K,) f32 pilot amplitudes n_k·(h²/s²_k)^{d/2}
    inv2s2: torch.Tensor    # (K,) f32 1/(2s²_k), s²_k = h² + var_k
    norm: float             # n · (2π)^{d/2} h^d
    p_floor: float          # TAIL_FRAC · p_scale
    groups: int             # frequency groups for the standard error


@dataclasses.dataclass
class RFFState:
    """Exact fit-time accumulators of the tier, float64 on one device.

    The sums are exact for the frequencies ``w`` actually used, so
    append/evict deltas commute with refits; the serving tensors are
    cached and dropped on every update."""

    h: float
    d: int
    n: int                    # live train count the sums cover
    groups: int
    seed: int
    npp: float                # per-point normalizer (2π)^{d/2} h^d
    w: torch.Tensor           # (D/2, d) f64 frequencies (f32 values)
    z_cos: torch.Tensor       # (D/2,) f64 feature sums
    z_sin: torch.Tensor
    centroids: torch.Tensor   # (K, d) f64 pilot anchors
    pilot_n: torch.Tensor     # (K,) f64 per-cell counts
    pilot_s1: torch.Tensor    # (K, d) f64 per-cell coordinate sums
    pilot_ss: torch.Tensor    # (K,) f64 per-cell Σ‖x‖²
    p_scale: float = 0.0      # high-percentile fit density (band floor)
    _serving: Optional[RFFServing] = dataclasses.field(default=None,
                                                       repr=False)

    @property
    def n_features(self) -> int:
        return 2 * self.w.shape[0]

    @property
    def device(self) -> torch.device:
        return self.w.device

    def serving(self) -> RFFServing:
        """Finalized serving tensors (cached until the next update)."""
        if self._serving is None:
            self._serving = _finalize(self)
        return self._serving


def supports(method: str, backend: str) -> bool:
    """Whether the tier can serve an estimator: the Gaussian kernel (kde,
    and sdkde on its debiased points) on the port's backends.  The
    Laplace kernel's spectral weight inflates exactly the residuals the
    pilot cannot absorb."""
    return method in ("kde", "sdkde") and backend in ("flash", "torch")


def _points(points, device) -> torch.Tensor:
    if device is None:
        device = points.device if isinstance(points, torch.Tensor) \
            else "cuda"
    return torch.as_tensor(points, dtype=torch.float32,
                           device=device_mod.resolve(device))


def _pilot_sums(x64: torch.Tensor, labels: torch.Tensor, k: int,
                weight: Optional[torch.Tensor] = None):
    """(counts, coordinate sums, squared-norm sums) per cell, f64."""
    lab = labels.to(torch.int64)
    w = torch.ones_like(x64[:, 0]) if weight is None else weight
    cnt = torch.zeros(k, dtype=torch.float64, device=x64.device)
    cnt.index_add_(0, lab, w)
    s1 = torch.zeros((k, x64.shape[1]), dtype=torch.float64,
                     device=x64.device)
    s1.index_add_(0, lab, x64 * w[:, None])
    ss = torch.zeros(k, dtype=torch.float64, device=x64.device)
    ss.index_add_(0, lab, (x64 * x64).sum(1) * w)
    return cnt, s1, ss


def fit(points, h: float, *, n_features: int = DEFAULT_FEATURES,
        n_pilot: int = DEFAULT_PILOT, groups: int = DEFAULT_GROUPS,
        h_scale: float = H_SCALE, seed: int = 0,
        index: Optional[spatial.SpatialIndex] = None,
        device: "str | torch.device | None" = None) -> RFFState:
    """Fit the tier over a (debiased) train set, once per generation.

    The frequencies come from ``np.random.default_rng(seed)`` as in
    ``repro``, so both packages draw the same ones.  The pilot anchors
    are the k-means centroids of ``spatial.build_index`` (or ``index``,
    e.g. one carried from ``repro`` by ``convert.index_from_state``);
    the feature sums are f32 phases a block, summed in float64 on the
    points' device.  ``device`` defaults to the points' (the card for a
    host array)."""
    x32 = _points(points, device)
    n, d = x32.shape
    if n_features % (2 * groups):
        raise ValueError(
            f"n_features must be a multiple of 2·groups, got "
            f"{n_features} with groups={groups}")
    dev = x32.device
    h_rff = float(h) * float(h_scale)
    n_half = n_features // 2
    rng = np.random.default_rng(seed)
    w_np = (rng.standard_normal((n_half, d)) / h_rff).astype(np.float32)
    w = torch.as_tensor(w_np, device=dev).to(torch.float64)

    if index is None:
        index = spatial.build_index(x32, n_clusters=max(1, min(n_pilot, n)),
                                    seed=seed)
    centroids = index.centroids.to(dev, torch.float64)
    k = centroids.shape[0]
    x64 = x32.to(torch.float64)
    pilot_n, pilot_s1, pilot_ss = _pilot_sums(x64, index.labels.to(dev), k)

    wt32 = w.T.to(torch.float32).contiguous()
    z_cos = torch.zeros(n_half, dtype=torch.float64, device=dev)
    z_sin = torch.zeros(n_half, dtype=torch.float64, device=dev)
    for off in range(0, n, _FIT_BLOCK):
        t = prec.dot_f32(x32[off:off + _FIT_BLOCK], wt32)
        z_cos += torch.cos(t).sum(0, dtype=torch.float64)
        z_sin += torch.sin(t).sum(0, dtype=torch.float64)

    state = RFFState(
        h=h_rff, d=d, n=n, groups=groups, seed=seed,
        npp=gaussian_norm_const(d, 1.0) * h_rff ** d,
        w=w, z_cos=z_cos, z_sin=z_sin, centroids=centroids,
        pilot_n=pilot_n, pilot_s1=pilot_s1, pilot_ss=pilot_ss)
    # band floor scale: the tier's own density at a train subsample (the
    # same rows as repro's: the rng continues after the frequencies)
    pick = rng.choice(n, size=min(_P_SCALE_SAMPLE, n), replace=False)
    p, _ = eval_density(state.serving(),
                        x32[torch.as_tensor(pick, device=dev)])
    state.p_scale = float(np.percentile(p.cpu().numpy(), _P_SCALE_PCT))
    state._serving = None          # rebuild with the real floor
    return state


def update(state: RFFState, added=None, removed=None, *,
           added_weights: Optional[torch.Tensor] = None,
           removed_weights: Optional[torch.Tensor] = None,
           n_live: Optional[int] = None) -> None:
    """Fold a streaming delta into the accumulators, float64, on the
    state's device: O(b·D·d/2).

    ``added`` / ``removed`` are (b, d) point batches; optional per-row
    ``*_weights`` (0 or 1) fold only the rows they mark, so a caller can
    pass whole survivor sets without selecting them on the host, and
    then gives the live count as ``n_live``.  Eviction subtracts exactly
    what an append added: pilot assignment is argmin-to-anchor on both
    sides.  Drops the cached serving tensors."""
    dev = state.device
    for sign, pts, wts in ((1.0, added, added_weights),
                           (-1.0, removed, removed_weights)):
        if pts is None:
            continue
        p = torch.atleast_2d(torch.as_tensor(pts, device=dev)).to(
            torch.float64)
        if p.numel() == 0:
            continue
        wv = None if wts is None else torch.as_tensor(
            wts, device=dev).to(torch.float64)
        for off in range(0, p.shape[0], _FIT_BLOCK):
            blk = p[off:off + _FIT_BLOCK]
            wb = None if wv is None else wv[off:off + _FIT_BLOCK]
            t = blk @ state.w.T
            c, s = torch.cos(t), torch.sin(t)
            if wb is not None:
                c, s = c * wb[:, None], s * wb[:, None]
            state.z_cos += sign * c.sum(0)
            state.z_sin += sign * s.sum(0)
            lab = torch.argmin(spatial._sqdist(blk, state.centroids), dim=1)
            cnt, s1, ss = _pilot_sums(blk, lab, state.centroids.shape[0],
                                      wb)
            state.pilot_n += sign * cnt
            state.pilot_s1 += sign * s1
            state.pilot_ss += sign * ss
            if wb is None:
                state.n += int(sign * blk.shape[0])
    if n_live is not None:
        state.n = int(n_live)
    state.pilot_n.clamp_(min=0.0)
    state._serving = None


def _finalize(state: RFFState) -> RFFServing:
    """Exact accumulators → f32 serving tensors (residuals, pilot form)."""
    nk = state.pilot_n
    live = nk > 0
    safe = torch.where(live, nk, torch.ones_like(nk))
    mu = torch.where(live[:, None], state.pilot_s1 / safe[:, None],
                     torch.zeros_like(state.pilot_s1))
    var = torch.where(
        live, torch.clamp(state.pilot_ss / safe - (mu * mu).sum(1), min=0.0)
        / state.d, torch.zeros_like(nk))
    h2 = state.h * state.h
    s2 = h2 + var
    beta = torch.where(live, nk * (h2 / s2) ** (state.d / 2.0),
                       torch.zeros_like(nk))
    # the pilot mixture's characteristic-function sums → residual sums
    w2 = (state.w * state.w).sum(1)                       # (D/2,)
    att = torch.exp(-var[None, :] * w2[:, None] / 2.0)    # (D/2, K)
    tm = state.w @ mu.T                                   # (D/2, K)
    amp = torch.where(live, nk, torch.zeros_like(nk))[None, :] * att
    zpc = (amp * torch.cos(tm)).sum(1)
    zps = (amp * torch.sin(tm)).sum(1)
    f32 = torch.float32
    return RFFServing(
        wt=state.w.T.to(f32).contiguous(),
        res_cos=(state.z_cos - zpc).to(f32),
        res_sin=(state.z_sin - zps).to(f32),
        mu=mu.to(f32), beta=beta.to(f32), inv2s2=(1.0 / (2.0 * s2)).to(f32),
        norm=float(max(state.n, 1) * state.npp),
        p_floor=float(TAIL_FRAC * max(state.p_scale, 0.0)),
        groups=state.groups)


def _feature_phases(y: torch.Tensor, wt: torch.Tensor,
                    precision: str) -> torch.Tensor:
    """The (m, D/2) phase product ``y @ wt`` at a GEMM-operand tier (the
    exact kernels' cast discipline); trig and everything after is f32."""
    y_hi, y_lo = prec.cast_operand(y, precision)
    w_hi, w_lo = prec.cast_operand(wt, precision)
    if y_lo is not None:
        return prec.gram_compensated(y_hi, y_lo, w_hi, w_lo)
    return prec.dot_f32(y_hi, w_hi)


def eval_density(serving: RFFServing, y: torch.Tensor, *,
                 precision: str = "f32",
                 z: float = BAND_Z) -> Tuple[torch.Tensor, torch.Tensor]:
    """Densities and relative bands (m,) for a query batch, both on the
    serving tensors' device: ``p`` clipped at 0 and ``band`` the Z-sigma
    relative band over the lower end of the estimate's interval (module
    docstring).  ``p̂`` is ``repro``'s, term for term."""
    y = torch.as_tensor(y, dtype=torch.float32, device=serving.wt.device)
    t = _feature_phases(y, serving.wt, precision)          # (m, D/2)
    contrib = torch.cos(t) * serving.res_cos + torch.sin(t) * serving.res_sin
    m = contrib.shape[0]
    g = serving.groups
    per_group = contrib.reshape(m, g, -1).mean(dim=2)      # (m, g)
    d2 = ((y * y).sum(1, keepdim=True)
          + (serving.mu * serving.mu).sum(1)[None, :]
          - 2.0 * prec.dot_f32(y, serving.mu.T))
    s_pilot = (serving.beta[None, :]
               * torch.exp(-torch.clamp(d2, min=0.0)
                           * serving.inv2s2[None, :])).sum(1)
    p_g = (s_pilot[:, None] + per_group) / serving.norm
    p_hat = p_g.mean(dim=1)
    stderr = p_g.std(dim=1, correction=1) / math.sqrt(g)
    lower = torch.clamp(p_hat - z * stderr, min=serving.p_floor)
    band = torch.where(lower > 0, z * stderr / lower,
                       torch.full_like(lower, math.inf))
    return torch.clamp(p_hat, min=0.0), band


def realized_error(p_hat, p_exact, p_scale: float) -> np.ndarray:
    """The tail-floored relative error the band bounds, on the host:
    ``|p̂ − p| / max(p, TAIL_FRAC·p_scale)`` (``repro``'s definition)."""
    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, np.float64)

    p_hat, p_exact = host(p_hat), host(p_exact)
    return np.abs(p_hat - p_exact) / np.maximum(
        p_exact, TAIL_FRAC * max(p_scale, 0.0))


def modeled_query_cost_us(rows: int, d: int, *,
                          n_features: int = DEFAULT_FEATURES,
                          n_pilot: int = 0,
                          precision: str = "f32") -> float:
    """Modeled time of one RFF evaluation of ``rows`` queries on the
    H100, microseconds (``tuning.rff_eval_cost``); ``n_pilot`` adds the
    (rows, K) pilot pass."""
    return 1e6 * tuning.rff_eval_cost(rows, d, n_features=n_features,
                                      n_pilot=n_pilot, precision=precision)


__all__ = [
    "DEFAULT_FEATURES", "DEFAULT_PILOT", "DEFAULT_GROUPS", "BAND_Z",
    "TAIL_FRAC", "H_SCALE", "RFFServing", "RFFState", "supports", "fit",
    "update", "eval_density", "realized_error", "modeled_query_cost_us",
]
