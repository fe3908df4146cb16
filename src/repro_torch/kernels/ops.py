"""Public wrappers around the Flash-SD-KDE kernels.

The counterpart of ``repro.kernels.ops``: pad point sets to tile
multiples with far sentinels (whose kernel weight underflows to exactly
0.0, so padding never changes a real row's sum), precompute squared norms
and the transposed (d, n) column layout, cast operands to the precision
tier, launch the kernels, slice off padding and normalize.

Three launch knobs thread through every wrapper:

  * ``precision`` — the GEMM-operand tier (``"f32"`` / ``"bf16"`` /
    ``"bf16x2"``, ``kernels/precision.py``).  Norms come from the
    tier-cast operands; distances, ``exp`` and sums stay f32.
  * ``block_m`` / ``block_n`` — the kernels' row tile and column tile
    (the unit of the visit lists and of each partial sum): ints (128 by
    default), or ``"auto"``, which the Hopper launch tuner resolves per
    shape (``kernels/autotune.py``: the H100 cost model's shortlist,
    timed on the card when the operands live there).  Rows are padded to
    ``block_m`` and columns to ``block_n`` multiples, as the JAX wrappers
    pad.
  * ``prune`` — cluster pruning (``kernels/spatial.py``): ``"off"``
    streams every tile pair (B1 / B2), a float ``epsilon ≥ 0`` reorders
    the train set spatially and skips column tiles whose certified
    per-point contribution is ≤ epsilon (B3 / B4; ``0.0`` skips only tiles
    whose every term underflows to exactly 0.0 in f32), and ``"auto"``
    (the one-shot wrappers' default) applies exact pruning once the
    streamed set is large enough (``resolve_prune``).

Each wrapper runs where its tensors are: the kernels on the card, their
plain PyTorch versions on the CPU (``flash_score``, ``flash_kde``,
``flash_laplace``, ``flash_pruned``).  The Laplace-corrected estimator
runs fused, one pass of B5 (B4 with ``laplace`` when pruning), or
non-fused, B2 then B6, always dense (``laplace_kde_nonfused``).  The
pruned path syncs once per pass to size its visit lists, and reads the
pass's largest certified error for the ``kernels.prune.*`` telemetry in
the same transfer; it also feeds the launch tuner's occupancy profile at
the launch width and, until the regime has one, at
``autotune.FINE_PROBE_BLOCK`` (``TrainColumns.meta_fine``).

Spans (``repro_torch.obs``, recorded only while tracing is on):
``kernels.shift``, ``kernels.score_stats`` and ``kernels.eval`` around the
wrappers; ``kernels.prepass`` (``kind`` score, columns, kde or laplace)
around everything a pruned launch waits for on the host, with
``kernels/spatial.py``'s spans inside; ``repro``'s
``kernels.pruned_score`` / ``kernels.pruned_eval`` around the launches,
whose ``tile_rows`` (block_m × the visits) and ``real_tile_rows`` (the
non-sentinel rows among them, read in the visit lists' one transfer) are
the rows a launch streams and the real ones; and a ``sync.<site>`` span
around each call that waits for the card (``sync.inv2h2``,
``sync.shift``, ``sync.normalize``, ``sync.occupancy``).  Outside these
wrappers ``spatial``'s spans sit under their caller's: the streaming
layer's re-cluster under ``stream.rebuild``, the shard partition and the
RFF tier's pilot centroids under theirs.
The streaming layer keeps its own layout and builds its columns with
``columns_from_layout`` / ``update_train_columns``.  Not ported:
``repro``'s fallback to dense under JAX tracing (PyTorch does not
trace), and the wrappers' ``plan=`` argument (the planner is reached
through ``ServeConfig(plan="auto")``).

The ring (``distributed/ring.py``, ``ring2d.py``) runs its blocks through
``score_block`` (rectangular B1) and ``kde_block`` (B2, or B5 for
Laplace): resident rows prepared once (``ring_rows``), each visiting
block padded to a tile multiple with ``PAD_VALUE``; f32 and dense, as
``repro``'s ring is.
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.bandwidth import gaussian_norm_const
from repro_torch.kernels import autotune, flash_pruned, spatial, tuning
from repro_torch.kernels import precision as prec
from repro_torch.kernels.flash_kde import flash_kde as _kde_kernel
from repro_torch.kernels.flash_laplace import flash_laplace as _laplace_kernel
from repro_torch.kernels.flash_laplace import sq_moment as _sq_moment_kernel
from repro_torch.kernels.flash_score import flash_score as _score_kernel

PAD_VALUE = 1.0e6

PruneArg = Union[str, float]  # "auto" | "off" | epsilon ≥ 0

#: ``prune="auto"`` enables exact pruning only past these sizes — below
#: them the bounds prepass and visit-list compaction cost more than the
#: skipped tiles were worth.
PRUNE_AUTO_MIN_COLS = 16384
PRUNE_AUTO_MIN_TILES = 4


def resolve_prune(prune: PruneArg, cols: int, block_n: int) -> Optional[float]:
    """The per-point epsilon a prune argument means; None = dense."""
    if prune is None or prune is False or prune == "off":
        return None
    if prune == "auto":
        if (cols >= PRUNE_AUTO_MIN_COLS
                and cols >= PRUNE_AUTO_MIN_TILES * block_n):
            return 0.0
        return None
    if isinstance(prune, str):
        raise ValueError(
            f"bad prune argument {prune!r} (choose 'auto', 'off', or a "
            "float epsilon >= 0)"
        )
    eps = float(prune)
    if not eps >= 0.0:
        raise ValueError(f"prune epsilon must be >= 0, got {eps}")
    return eps


def check_prune(prune) -> None:
    """A config's prune knob: ``"auto"``, ``"off"`` or an epsilon ≥ 0."""
    if not (prune in ("auto", "off")
            or (isinstance(prune, (int, float))
                and not isinstance(prune, bool) and prune >= 0)):
        raise ValueError(
            f"bad prune {prune!r} ('auto', 'off', or epsilon >= 0)")


def check_blocks(block_m, block_n) -> None:
    """Each tile is a positive int or ``"auto"`` (tuned per shape)."""
    for name, b in (("block_m", block_m), ("block_n", block_n)):
        if b == "auto":
            continue
        if not (isinstance(b, int) and not isinstance(b, bool) and b > 0):
            raise ValueError(f"bad {name} {b!r} (a positive int or 'auto')")


def _resolve(block_m, block_n, rows: int, cols: int, d: int, *,
             out_width: int, precision: str, device: torch.device,
             row_multiple: Optional[int] = None,
             col_multiple: Optional[int] = None, pruned: bool = False):
    """``"auto"`` tiles resolved by the launch tuner (measured when the
    operands are on the card, the model alone on the CPU), then held to
    the kernels' limits."""
    check_blocks(block_m, block_n)
    block_m, block_n = autotune.resolve_blocks(
        block_m, block_n, rows, cols, d, out_width=out_width,
        precision=precision, row_multiple=row_multiple,
        col_multiple=col_multiple, pruned=pruned, device=device)
    why = tuning.infeasible(d, block_m=block_m, block_n=block_n,
                            precision=precision, out_width=out_width)
    if why is not None:
        raise ValueError(f"the kernels refuse this launch: {why}")
    return block_m, block_n


def _pad_to(x: torch.Tensor, mult: int,
            value: float = PAD_VALUE) -> torch.Tensor:
    rem = (-x.shape[0]) % mult
    if rem == 0:
        return x
    fill = x.new_full((rem,) + tuple(x.shape[1:]), value)
    return torch.cat([x, fill], dim=0)


def _norms(x: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32)
    return torch.sum(x32 * x32, dim=-1, keepdim=True)


def _tier_norms(hi: torch.Tensor, lo: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 squared norms of the points the tier-cast operands represent."""
    return _norms(prec.reconstruct(hi, lo))


def _inv2h2(h, device: torch.device) -> torch.Tensor:
    """1/(2h²) as a (1, 1) f32 tensor on ``device``, computed in f32."""
    with obs.span("sync.inv2h2"):
        h = torch.as_tensor(h, dtype=torch.float32).to(device)
    return (1.0 / (2.0 * h * h)).reshape(1, 1)


def _t(x: torch.Tensor) -> torch.Tensor:
    """Contiguous transpose: the (d, n) column layout the kernels read."""
    return x.T.contiguous()


def _normalize(sums: torch.Tensor, n: int, d: int, h) -> torch.Tensor:
    with obs.span("sync.normalize"):
        h = torch.as_tensor(h, dtype=torch.float32).to(sums.device)
    return sums / (n * gaussian_norm_const(d, 1.0) * h**d)


# One-shot wrappers amortize the spatial prep across repeated calls on the
# SAME train tensor (e.g. the estimators' evaluate loops): keyed by tensor
# identity, guarded by a weakref so a recycled id can never alias.
_COLUMNS_CACHE: dict = {}
_COLUMNS_LOCK = threading.Lock()


def _cached_columns(x: torch.Tensor, *, block_n: int, precision: str,
                    seed: int) -> "TrainColumns":
    key = (id(x), int(block_n), precision, seed)
    with _COLUMNS_LOCK:
        hit = _COLUMNS_CACHE.get(key)
        if hit is not None and hit[0]() is x:
            return hit[1]
    with obs.span("kernels.prepass", kind="columns", rows=x.shape[0]):
        cols = prepare_train_columns(x, block_n=block_n, precision=precision,
                                     clustered=True, seed=seed)
    with _COLUMNS_LOCK:
        for k in [k for k, (r, _) in _COLUMNS_CACHE.items() if r() is None]:
            del _COLUMNS_CACHE[k]
        _COLUMNS_CACHE[key] = (weakref.ref(x), cols)
    return cols


# ---------------------------------------------------------------------------
# Score statistics / SD-KDE shift.
# ---------------------------------------------------------------------------


def _score_operands(xp: torch.Tensor, precision: str):
    """(x_ops, xt_ops, xaug_ops, nrm, xrec) for a padded train set; at
    f32 xaug_ops is (None, None): the kernel makes [X | 1] from xt."""
    if precision == "f32":
        x_ops = (xp.contiguous(), None)
        xt_ops = (_t(xp), None)
        xaug_ops = (None, None)
        xrec = xp.to(torch.float32)
    else:
        xaug = torch.cat([xp, xp.new_ones((xp.shape[0], 1))], dim=1)
        x_ops = prec.cast_operand(xp.to(torch.float32), precision)
        xt_ops = (_t(x_ops[0]), None if x_ops[1] is None else _t(x_ops[1]))
        xaug_ops = prec.cast_operand(xaug.to(torch.float32), precision)
        xrec = prec.reconstruct(*x_ops)
    return x_ops, xt_ops, xaug_ops, _norms(xrec), xrec


def _score_stats_pruned(x: torch.Tensor, h, epsilon: float,
                        index: Optional[spatial.SpatialIndex], *,
                        precision: str, block_m: int, block_n: int,
                        seed: int = 0):
    """Pruned score pass (B3); returns (S0, S1) in ``x``'s row order.

    The score pass is train×train, so the cluster-aligned layout serves
    both axes: row tiles and column tiles of the same padded scatter, and
    the output rows come back through the layout's slot map.  The
    certificate uses the score kind (per-point bound exp(-arg)·max(1,
    max|x|)) because the accumulator weights are the [X | 1] columns.
    ``index=None`` clusters ``x`` here (k-means seeded by ``seed``).
    """
    n, d = x.shape
    with obs.span("kernels.prepass", kind="score", rows=n):
        if index is None:
            index = spatial.build_index(x, seed=seed)
        layout = spatial.cluster_layout(
            x.to(torch.float32), index.labels, block_n,
            total_multiple=math.lcm(block_m, block_n))
        x_ops, xt_ops, xaug_ops, nrm, xrec = _score_operands(layout.points,
                                                             precision)
        inv = _inv2h2(h, x.device)
        col_meta = spatial.tile_metadata(xrec, layout.real, block=block_n)
        tm = spatial.tile_map(xrec, col_meta, inv, epsilon, block_m=block_m,
                              kind="score")
        vl = spatial.visit_lists(tm.keep, err_bound=_telemetry_err(tm),
                                 real_rows=_traced_real_rows(layout,
                                                             block_m))
        fine = autotune.FINE_PROBE_BLOCK
        fine_meta = None
        if (block_n > fine and layout.points.shape[0] % fine == 0
                and not autotune.has_occupancy(n, n, d, fine)):
            fine_meta = spatial.tile_metadata(xrec, layout.real, block=fine)
        _record_occupancy_profile(n, {n}, d, vl.occupancy, block_n, xrec,
                                  fine_meta, inv, epsilon, block_m, "score")
        _note_pruned_launch("score", vl, epsilon)
    with obs.span("kernels.pruned_score", rows=n,
                  occupancy=round(vl.occupancy, 4),
                  tile_rows=block_m * vl.visits,
                  real_tile_rows=vl.real_visit_rows):
        s1aug = flash_pruned.flash_score_pruned(
            vl.counts, vl.tile_map, x_ops[0], nrm, xt_ops[0], xaug_ops[0],
            inv, x_ops[1], xt_ops[1], xaug_ops[1], block_m=block_m,
            block_n=block_n)
    rows = s1aug[layout.slots]
    return rows[:, d], rows[:, :d]


def _record_occupancy_profile(rows, col_counts, d, launch_occ, block_n,
                              yrec, meta_fine, inv2h2, epsilon, block_m,
                              kind) -> None:
    """Feed the tuner's occupancy profile after one bounds prepass.

    The launch-width occupancy (already on the host) is recorded under
    every column count a later resolve may key on.  The fine-width probe,
    a second bounds pass at ``FINE_PROBE_BLOCK`` with one device read,
    runs only until the profile has a fine record for this regime; after
    that the query path skips it."""
    fine = autotune.FINE_PROBE_BLOCK
    for n_key in col_counts:
        autotune.record_occupancy(rows, n_key, d, launch_occ,
                                  block_n=block_n)
    if meta_fine is None or all(
            autotune.has_occupancy(rows, k, d, fine) for k in col_counts):
        return
    fine_tm = spatial.tile_map(yrec, meta_fine, inv2h2, epsilon,
                               block_m=block_m, kind=kind)
    with obs.span("sync.occupancy"):
        fine_occ = float(fine_tm.keep.float().mean())
    for n_key in col_counts:
        autotune.record_occupancy(rows, n_key, d, fine_occ, block_n=fine)


def _telemetry_err(tm: spatial.TileMap) -> Optional[torch.Tensor]:
    """The certificate vector ``visit_lists`` reads back for telemetry,
    or None when metrics are off (nothing extra is read then)."""
    return tm.err_bound if obs.state.metrics_on else None


def _traced_real_rows(layout: spatial.ClusterLayout,
                      block_m: int) -> Optional[torch.Tensor]:
    """Real rows of each ``block_m`` row tile of a layout, summed on the
    device, for the pruned launch spans' ``real_tile_rows``; None while
    tracing is off (nothing is computed or read then)."""
    if not obs.state.trace_on:
        return None
    return layout.real.reshape(-1, block_m).sum(dim=1, dtype=torch.int64)


def _note_pruned_launch(kind: str, vl: spatial.VisitLists,
                        epsilon) -> None:
    """Record one pruned pass: visit fraction (= 1 − skip rate) and the
    certified error budget actually spent, so serving telemetry shows how
    sparse traffic really is and how close certificates run to their
    epsilon.  Everything here is already on the host (``visit_lists``
    read it with the visit counts)."""
    if not obs.state.metrics_on:
        return
    obs.counter("kernels.prune.launches", labels={"kind": kind}).inc()
    obs.histogram("kernels.prune.visit_fraction",
                  "column tiles visited / total per pruned pass",
                  lo=1e-3, hi=1.0).observe(vl.occupancy)
    obs.histogram("kernels.prune.cert_budget",
                  "max certified abs error of the unnormalized "
                  "accumulator per pruned pass",
                  lo=1e-30, hi=1.0, per_decade=1).observe(vl.max_err)
    obs.gauge("kernels.prune.epsilon",
              "per-point contribution threshold of the last pruned "
              "pass").set(float(epsilon))


def flash_score_stats(x: torch.Tensor, h, *, precision: str = "f32",
                      block_m=128, block_n=128,
                      prune: PruneArg = "auto", seed: int = 0):
    """(S0, S1) score statistics over the train set via kernel B1, or B3
    when ``prune`` engages (``seed`` seeds the k-means index)."""
    prec.validate(precision)
    n, d = x.shape
    with obs.span("kernels.score_stats", rows=n, precision=precision):
        block_m, block_n = _resolve(block_m, block_n, n, n, d,
                                    out_width=d + 1, precision=precision,
                                    device=x.device, pruned=prune != "off")
        eps = resolve_prune(prune, n, block_n)
        if eps is not None:
            return _score_stats_pruned(
                x, h, eps, None, precision=precision, block_m=block_m,
                block_n=block_n, seed=seed)
        xp = _pad_to(x, math.lcm(block_m, block_n))
        x_ops, xt_ops, xaug_ops, nrm, _ = _score_operands(xp, precision)
        s1aug = _score_kernel(
            x_ops[0], nrm, xt_ops[0], xaug_ops[0], _inv2h2(h, x.device),
            x_ops[1], xt_ops[1], xaug_ops[1], block_m=block_m,
            block_n=block_n,
        )
        return s1aug[:n, d], s1aug[:n, :d]


def _apply_score_shift(x32: torch.Tensor, s0, s1, h, sh) -> torch.Tensor:
    """x^SD = x + (h²/2)·ŝ(x) from the fused statistics (rows aligned)."""
    with obs.span("sync.shift"):
        sh = torch.as_tensor(sh, dtype=torch.float32).to(x32.device)
    with obs.span("sync.shift"):
        h = torch.as_tensor(h, dtype=torch.float32).to(x32.device)
    score = (s1 - x32 * s0[:, None]) / (sh * sh * s0[:, None])
    return x32 + 0.5 * h * h * score


def flash_sdkde_shift(x: torch.Tensor, h, *, score_h=None,
                      precision: str = "f32", block_m=128,
                      block_n=128, prune: PruneArg = "auto",
                      seed: int = 0) -> torch.Tensor:
    """Debiased samples x^SD = x + (h²/2)·ŝ(x), score via kernel B1 (B3
    when ``prune`` engages)."""
    sh = h if score_h is None else score_h
    with obs.span("kernels.shift", rows=x.shape[0], precision=precision):
        s0, s1 = flash_score_stats(x, sh, precision=precision,
                                   block_m=block_m, block_n=block_n,
                                   prune=prune, seed=seed)
        return _apply_score_shift(x.to(torch.float32), s0, s1, h, sh)


# ---------------------------------------------------------------------------
# KDE / Laplace-KDE evaluation.
# ---------------------------------------------------------------------------


def _prep_eval(x, y, block_m, block_n, precision):
    """Pad, transpose, norm and tier-cast one (train, queries) pair."""
    yp = _pad_to(y, block_m)
    xp = _pad_to(x, block_n)
    if precision == "f32":
        y_ops = (yp.contiguous(), None)
        xt_ops = (_t(xp), None)
        nrm_y, nrm_x = _norms(yp), _norms(xp).reshape(1, -1)
    else:
        y_ops = prec.cast_operand(yp.to(torch.float32), precision)
        x_ops = prec.cast_operand(xp.to(torch.float32), precision)
        xt_ops = (_t(x_ops[0]), None if x_ops[1] is None else _t(x_ops[1]))
        nrm_y = _tier_norms(*y_ops)
        nrm_x = _tier_norms(*x_ops).reshape(1, -1)
    return y_ops, xt_ops, nrm_y, nrm_x


def _flash_eval(x, y, h, *, laplace, precision, block_m, block_n, prune,
                seed) -> torch.Tensor:
    """Normalized KDE or fused-Laplace densities: B2 / B5 dense, B4 (its
    ``laplace`` flag) when ``prune`` engages."""
    prec.validate(precision)
    n, d = x.shape
    m = y.shape[0]
    with obs.span("kernels.eval", rows=m, cols=n, laplace=laplace):
        block_m, block_n = _resolve(block_m, block_n, m, n, d, out_width=1,
                                    precision=precision, device=x.device,
                                    pruned=prune != "off")
        eps = resolve_prune(prune, n, block_n)
        if eps is not None:
            cols = _cached_columns(x, block_n=block_n, precision=precision,
                                   seed=seed)
            sums = _pruned_eval_sums(y, cols, h, eps, precision=precision,
                                     block_m=block_m, block_n=block_n,
                                     laplace=laplace, n_true=n)
            return _normalize(sums, n, d, h)
        y_ops, xt_ops, nrm_y, nrm_x = _prep_eval(x, y, block_m, block_n,
                                                 precision)
        kernel = _laplace_kernel if laplace else _kde_kernel
        sums = kernel(
            y_ops[0], nrm_y, xt_ops[0], nrm_x, _inv2h2(h, y.device),
            y_ops[1], xt_ops[1], block_m=block_m, block_n=block_n,
        )
        return _normalize(sums[:m, 0], n, d, h)


def flash_kde(x: torch.Tensor, y: torch.Tensor, h, *,
              precision: str = "f32", block_m=128,
              block_n=128, prune: PruneArg = "auto",
              seed: int = 0) -> torch.Tensor:
    """Normalized Gaussian KDE densities at ``y`` (train set ``x``), via
    B2, or B4 when ``prune`` engages (the clustered columns of ``x`` are
    cached while ``x`` lives)."""
    return _flash_eval(x, y, h, laplace=False, precision=precision,
                       block_m=block_m, block_n=block_n, prune=prune,
                       seed=seed)


def flash_laplace_kde(x: torch.Tensor, y: torch.Tensor, h, *,
                      precision: str = "f32", block_m=128,
                      block_n=128, prune: PruneArg = "auto",
                      seed: int = 0) -> torch.Tensor:
    """Fused Flash-Laplace-KDE densities at ``y`` — one quadratic pass:
    B5, or B4 with ``laplace`` (and the Laplace bound kind in its prepass)
    when ``prune`` engages."""
    return _flash_eval(x, y, h, laplace=True, precision=precision,
                       block_m=block_m, block_n=block_n, prune=prune,
                       seed=seed)


def laplace_kde_nonfused(x: torch.Tensor, y: torch.Tensor, h, *,
                         precision: str = "f32", block_m=128,
                         block_n=128) -> torch.Tensor:
    """Non-fused Laplace baseline (Fig. 4): two quadratic launches, B2 for
    S = Σφ and B6 for M = Σφ·sq, combined as (1 + d/2)·S − M/(2h²).

    Stays dense on purpose, as in ``repro``: it is the measured baseline
    of the fusion."""
    prec.validate(precision)
    n, d = x.shape
    m = y.shape[0]
    block_m, block_n = _resolve(block_m, block_n, m, n, d, out_width=1,
                                precision=precision, device=x.device)
    y_ops, xt_ops, nrm_y, nrm_x = _prep_eval(x, y, block_m, block_n,
                                             precision)
    args = (y_ops[0], nrm_y, xt_ops[0], nrm_x, _inv2h2(h, y.device),
            y_ops[1], xt_ops[1])
    kde_sums = _kde_kernel(*args, block_m=block_m, block_n=block_n)
    sq_mom = _sq_moment_kernel(*args, block_m=block_m, block_n=block_n)
    hf = torch.as_tensor(h, dtype=torch.float32).to(y.device)
    combined = (1.0 + d / 2.0) * kde_sums - sq_mom / (2.0 * hf * hf)
    return _normalize(combined[:m, 0], n, d, h)


# ---------------------------------------------------------------------------
# Prepared fast path (serving).
# ---------------------------------------------------------------------------


class TrainColumns(NamedTuple):
    """Fit-time prepared train tensors for one precision tier."""

    xt: torch.Tensor                 # (d, n_padded) tier-cast hi plane
    xt_lo: Optional[torch.Tensor]    # (d, n_padded) bf16 lo plane (bf16x2)
    nrm_x: torch.Tensor              # (1, n_padded) f32 column norms
    # Cluster-pruning state (None on non-spatial prepares): per-column-tile
    # geometry certified against the tier-cast points, and the spatial
    # index whose centroids order incoming query batches.
    meta: Optional[spatial.TileMeta] = None
    index: Optional[spatial.SpatialIndex] = None
    # the same geometry at the tuner's fine probe width: the pruned
    # wrappers measure occupancy there too, so the tuner can extrapolate
    # skip rates to tile widths it has never launched
    meta_fine: Optional[spatial.TileMeta] = None
    block_n: int = 0                 # prepare-time column-tile width


def prepare_train_columns(x: torch.Tensor, *, block_n=128,
                          precision: str = "f32", clustered: bool = False,
                          index: Optional[spatial.SpatialIndex] = None,
                          seed: int = 0) -> TrainColumns:
    """One-time train-side prep for repeated evaluation against one set.

    Pads the (debiased) train set to a ``block_n`` multiple with sentinel
    points, builds the transposed (d, n) layout cast to the tier (both
    planes for bf16x2) and the f32 column norms of the cast points.

    ``clustered=True`` instead scatters the points into the cluster-aligned
    sentinel-padded layout (k-means seeded by ``seed``; pass ``index`` to
    reuse a clustering — its labels apply directly when it was fitted on a
    row-aligned set, e.g. the pre-shift points) and attaches the per-tile
    metadata the pruned kernels' bounds prepass reads.  ``block_n`` may be
    ``"auto"`` (tuned for a serving-scale request of 4096 rows).
    """
    prec.validate(precision)
    check_blocks(1, block_n)
    if block_n == "auto":
        _, block_n = _resolve(128, "auto", 4096, x.shape[0], x.shape[-1],
                              out_width=1, precision=precision,
                              device=x.device)
    real = None
    if clustered:
        if index is None:
            index = spatial.build_index(x, seed=seed)
        labels = index.labels if (
            index.labels is not None and index.labels.shape[0] == x.shape[0]
        ) else spatial.assign(x, index)
        layout = spatial.cluster_layout(x, labels, block_n)
        xp, real = layout.points, layout.real
    else:
        xp = _pad_to(x, block_n)
    return columns_from_layout(xp, real, index if clustered else None,
                               block_n=block_n, precision=precision)


def _tier_planes(xp: torch.Tensor, precision: str):
    """(hi, lo, rec) rows of a layout at one tier: the operand planes
    (row-major, not yet transposed) and the f32 points they represent."""
    x32 = xp.to(torch.float32)
    if precision == "f32":
        return x32, None, x32
    hi, lo = prec.cast_operand(x32, precision)
    return hi, lo, prec.reconstruct(hi, lo)


def columns_from_layout(xp: torch.Tensor, real: Optional[torch.Tensor],
                        index: Optional[spatial.SpatialIndex], *,
                        block_n: int,
                        precision: str = "f32") -> TrainColumns:
    """TrainColumns from an already-scattered padded layout.

    The streaming layer owns its layout (slack slots, rows changed in
    place) and calls this to (re)build the tier's cast planes, norms and
    tile metadata; ``prepare_train_columns`` routes through here too, so
    both share one casting/metadata recipe.  ``real=None`` means a plain
    tail-padded (non-clustered) layout: no metadata is attached.  A
    clustered layout wider than the tuner's fine probe also gets its
    metadata at that width (``meta_fine``).
    """
    prec.validate(precision)
    check_blocks(1, block_n)
    hi, lo, rec = _tier_planes(xp, precision)
    meta = meta_fine = None
    if real is not None:
        meta = spatial.tile_metadata(rec, real, block=block_n)
        fine = autotune.FINE_PROBE_BLOCK
        if block_n > fine and xp.shape[0] % fine == 0:
            meta_fine = spatial.tile_metadata(rec, real, block=fine)
    return TrainColumns(_t(hi), None if lo is None else _t(lo),
                        _norms(rec).reshape(1, -1), meta, index, meta_fine,
                        block_n)


def update_train_columns(cols: TrainColumns, xp: torch.Tensor,
                         real: torch.Tensor, tiles, *,
                         precision: str = "f32") -> TrainColumns:
    """Prepared columns with only the listed column tiles refreshed.

    The streaming delta path: after appends, evictions and shift drift
    touch some tiles, re-cast those tiles' operand columns, recompute
    their norms and tile metadata, and carry every other column over bit
    for bit.  ``cols`` is not changed: the planes are copied before the
    write (Θ(n·d), as ``repro``'s functional updates copy), so a snapshot
    that still holds ``cols`` keeps its bytes.  ``tiles`` may contain
    repeats (pow2-padded index lists); each write is recomputed from the
    current layout, so repeated writes carry equal values.
    """
    prec.validate(precision)
    block = cols.block_n
    tiles_np = np.asarray(tiles, np.int64).reshape(-1)
    if tiles_np.size == 0:
        return cols
    rows = spatial.upload((tiles_np[:, None] * block
                           + np.arange(block)[None, :]).reshape(-1),
                          xp.device)
    hi, lo, rec = _tier_planes(xp.index_select(0, rows), precision)
    xt = cols.xt.clone().index_copy_(1, rows, hi.T.to(cols.xt.dtype))
    xt_lo = None if cols.xt_lo is None else cols.xt_lo.clone().index_copy_(
        1, rows, lo.T)
    nrm_x = cols.nrm_x.clone().index_copy_(1, rows,
                                           _norms(rec).reshape(1, -1))
    meta, meta_fine = cols.meta, cols.meta_fine
    if meta is not None:
        mask = real.index_select(0, rows)
        meta = spatial.merge_tile_meta(meta, tiles_np,
                                       spatial.tile_meta_from_rows(
            rec.reshape(tiles_np.size, block, -1),
            mask.reshape(tiles_np.size, block)))
        if meta_fine is not None:
            fine = autotune.FINE_PROBE_BLOCK
            ratio = block // fine
            ftiles = (tiles_np[:, None] * ratio
                      + np.arange(ratio)[None, :]).reshape(-1)
            meta_fine = spatial.merge_tile_meta(
                meta_fine, ftiles, spatial.tile_meta_from_rows(
                    rec.reshape(ftiles.size, fine, -1),
                    mask.reshape(ftiles.size, fine)))
    return cols._replace(xt=xt, xt_lo=xt_lo, nrm_x=nrm_x, meta=meta,
                         meta_fine=meta_fine)


def _cast_queries(yp: torch.Tensor, precision: str):
    """(y_hi, y_lo, nrm_y, yrec) for a padded query block at one tier."""
    if precision == "f32":
        return yp.contiguous(), None, _norms(yp), yp.to(torch.float32)
    y_hi, y_lo = prec.cast_operand(yp.to(torch.float32), precision)
    yrec = prec.reconstruct(y_hi, y_lo)
    return y_hi, y_lo, _norms(yrec), yrec


def _pruned_eval_sums(y: torch.Tensor, cols: TrainColumns, h,
                      epsilon: float, *, precision: str, block_m: int,
                      block_n: int, laplace: bool = False,
                      n_real: Optional[int] = None,
                      n_true: Optional[int] = None) -> torch.Tensor:
    """Pruned kernel sums (len(y),) for queries against prepared columns:
    KDE sums, or with ``laplace`` the fused Laplace sums, whose prepass
    certifies with the Laplace bound kind.

    ``y`` may carry sentinel padding rows past ``n_real`` (the serving
    path); only real rows enter the query layout and the tail sums are 0.
    Assign queries to the train clusters → scatter into a cluster-aligned
    layout → bounds prepass → visit lists (one sync) → B4 → gather back
    to request order.  The occupancy is recorded for the tuner under the
    padded column count and, where the caller knows it, the true train
    count ``n_true`` (read from no tensor: ``repro`` sums the tile counts
    on the device for it).
    """
    if cols.meta is None or cols.index is None:
        raise ValueError(
            "pruned evaluation needs spatially prepared train columns "
            "(prepare_train_columns(..., clustered=True))")
    if cols.block_n != block_n:
        raise ValueError(
            "pruned launch block_n must match the width the columns were "
            f"prepared at: launch {block_n} vs prepared {cols.block_n} — "
            "the tile metadata and visit lists address tiles of that width")
    m_in = y.shape[0]
    nr = m_in if n_real is None else min(n_real, m_in)
    kind = "laplace" if laplace else "kde"
    with obs.span("kernels.prepass", kind=kind, rows=nr):
        yr = y[:nr].to(torch.float32)
        qlayout = spatial.cluster_layout(yr, spatial.assign(yr, cols.index),
                                         block_m, bucket_rows=True)
        y_hi, y_lo, nrm_y, yrec = _cast_queries(qlayout.points, precision)
        inv = _inv2h2(h, y.device)
        tm = spatial.tile_map(yrec, cols.meta, inv, epsilon, block_m=block_m,
                              kind=kind)
        vl = spatial.visit_lists(tm.keep, err_bound=_telemetry_err(tm),
                                 real_rows=_traced_real_rows(qlayout,
                                                             block_m))
        keys = {cols.xt.shape[1]} | ({n_true} if n_true else set())
        _record_occupancy_profile(m_in, keys, yr.shape[1], vl.occupancy,
                                  block_n, yrec, cols.meta_fine, inv,
                                  epsilon, block_m, kind)
        _note_pruned_launch(kind, vl, epsilon)
    with obs.span("kernels.pruned_eval", rows=nr, kind=kind,
                  occupancy=round(vl.occupancy, 4),
                  max_visits=vl.max_visits, tile_rows=block_m * vl.visits,
                  real_tile_rows=vl.real_visit_rows):
        sums = flash_pruned.flash_kde_pruned(
            vl.counts, vl.tile_map, y_hi, nrm_y, cols.xt, cols.nrm_x, inv,
            y_lo, cols.xt_lo, block_m=block_m, block_n=block_n,
            laplace=laplace)
    out = sums[qlayout.slots, 0]                 # back to request order
    if nr < m_in:                                # caller's sentinel tail
        out = torch.cat([out, out.new_zeros((m_in - nr,))])
    return out


def flash_kde_prepared(yp: torch.Tensor, xt: torch.Tensor,
                       nrm_x: torch.Tensor, h,
                       xt_lo: Optional[torch.Tensor] = None, *,
                       precision: str = "f32", block_m=128,
                       block_n=128, laplace: bool = False,
                       prune: PruneArg = "off",
                       columns: Optional[TrainColumns] = None,
                       n_real: Optional[int] = None) -> torch.Tensor:
    """Unnormalized kernel sums (m,) for queries already padded to a
    ``block_m`` multiple against prepared columns; the caller divides by
    ``n_true · (2π)^{d/2} h^d`` and slices off padding rows.  KDE sums
    (B2), or with ``laplace`` the fused Laplace sums (B5).

    ``prune`` ≠ "off" takes the cluster-pruned path (B4): pass the full
    ``columns`` (prepared with ``clustered=True``) and ``n_real``, the
    true query count, so sentinel padding rows stay out of the row-tile
    geometry.  ``"auto"`` tiles must divide the padded shapes; a pruned
    launch keeps the width the columns were prepared at.
    """
    prec.validate(precision)
    if (precision == "bf16x2") != (xt_lo is not None):
        raise ValueError(
            "bf16x2 needs prepared lo planes (and other tiers must not "
            f"pass them): precision={precision} xt_lo={xt_lo is not None}"
        )
    if prune != "off" and columns is not None and block_n == "auto":
        block_n = columns.block_n
    m, d = yp.shape
    with obs.span("kernels.eval", rows=m, cols=xt.shape[1],
                  laplace=laplace):
        block_m, block_n = _resolve(block_m, block_n, m, xt.shape[1], d,
                                    out_width=1, precision=precision,
                                    device=yp.device, row_multiple=m,
                                    col_multiple=xt.shape[1],
                                    pruned=prune != "off")
        eps = resolve_prune(prune, xt.shape[1], block_n)
        if eps is not None:
            if columns is None:
                raise ValueError(
                    "flash_kde_prepared(prune=...) needs columns= (the "
                    "clustered TrainColumns) for the tile metadata")
            return _pruned_eval_sums(yp, columns, h, eps,
                                     precision=precision, block_m=block_m,
                                     block_n=block_n, laplace=laplace,
                                     n_real=n_real)
        y_hi, y_lo, nrm_y, _ = _cast_queries(yp, precision)
        kernel = _laplace_kernel if laplace else _kde_kernel
        sums = kernel(y_hi, nrm_y, xt, nrm_x, _inv2h2(h, yp.device), y_lo,
                      xt_lo, block_m=block_m, block_n=block_n)
        return sums[:, 0]


# ---------------------------------------------------------------------------
# Per-block pieces of the ring (distributed/ring.py, ring2d.py).
# ---------------------------------------------------------------------------

#: The ring's kernel tiles: B1, B2 and B5 over one (rows, block) pair.
RING_BLOCK_M = 128
RING_BLOCK_N = 128


class RingRows(NamedTuple):
    """A rank's resident rows, prepared once for every block they meet:
    padded to a ``block_m`` multiple with ``PAD_VALUE`` and normed."""

    x: torch.Tensor      # (m_padded, d) f32, contiguous
    nrm: torch.Tensor    # (m_padded, 1) f32
    m: int               # real rows (the rest are sentinels)
    block_m: int


def ring_rows(x: torch.Tensor, block_m: int = RING_BLOCK_M) -> RingRows:
    """Resident rows for ``score_block`` / ``kde_block``."""
    xp = _pad_to(x.to(torch.float32), block_m).contiguous()
    return RingRows(xp, _norms(xp), int(x.shape[0]), block_m)


def pad_block(x: torch.Tensor, block_n: int = RING_BLOCK_N) -> torch.Tensor:
    """A column block padded to a ``block_n`` multiple with sentinels (far
    points whose weight underflows to exactly 0.0), f32 and contiguous:
    the form a ring rotates, padded once before its first step."""
    return _pad_to(x.to(torch.float32), block_n).contiguous()


def score_block(rows: RingRows, cols: torch.Tensor, inv2h2: torch.Tensor, *,
                block_n: int = RING_BLOCK_N) -> torch.Tensor:
    """Partial score statistics S1aug = Σ_j φ_ij·[x_j | 1] (rows.m, d+1) of
    the resident rows against one block of columns: one launch of B1 in
    its rectangular form (its plain version on the CPU), f32 and dense.
    ``inv2h2`` is ``_inv2h2(h, device)``, made once a ring (each upload
    of h is a host-to-device copy); column d holds the S0 part."""
    cp = pad_block(cols, block_n)
    s1aug = _score_kernel(rows.x, rows.nrm, _t(cp), None, inv2h2,
                          nrm_x=_norms(cp).reshape(1, -1),
                          block_m=rows.block_m, block_n=block_n)
    return s1aug[:rows.m]


def kde_block(rows: RingRows, cols: torch.Tensor, inv2h2: torch.Tensor, *,
              laplace: bool = False,
              block_n: int = RING_BLOCK_N) -> torch.Tensor:
    """Partial unnormalized KDE sums (rows.m,) of the resident queries
    against one block of train columns: one launch of B2, or of B5 with
    ``laplace`` (their plain versions on the CPU), f32 and dense."""
    cp = pad_block(cols, block_n)
    kernel = _laplace_kernel if laplace else _kde_kernel
    sums = kernel(rows.x, rows.nrm, _t(cp), _norms(cp).reshape(1, -1),
                  inv2h2, block_m=rows.block_m, block_n=block_n)
    return sums[:rows.m, 0]


# ---------------------------------------------------------------------------
# Full pipeline.
# ---------------------------------------------------------------------------


def flash_sdkde(x: torch.Tensor, y: torch.Tensor, h, *, score_h=None,
                precision: str = "f32", block_m=128,
                block_n=128, prune: PruneArg = "auto",
                seed: int = 0) -> torch.Tensor:
    """Full Flash-SD-KDE: score pass → shift → KDE at queries (normalized).

    Dense, B1 then B2; when ``prune`` engages, B3 then B4 with one shared
    spatial index: the clustering of ``x`` orders the score pass and,
    row for row, the O(h²)-shifted set of the KDE pass.  ``"auto"`` tiles
    are tuned for each pass on its own (train × train, queries × train).
    """
    prec.validate(precision)
    n, d = x.shape
    m = y.shape[0]
    sh = h if score_h is None else score_h
    pruned = prune != "off"
    s_bm, s_bn = _resolve(block_m, block_n, n, n, d, out_width=d + 1,
                          precision=precision, device=x.device,
                          pruned=pruned)
    k_bm, k_bn = _resolve(block_m, block_n, m, n, d, out_width=1,
                          precision=precision, device=x.device,
                          pruned=pruned)
    s_eps = resolve_prune(prune, n, s_bn)
    k_eps = resolve_prune(prune, n, k_bn)
    x32 = x.to(torch.float32)
    with obs.span("kernels.shift", rows=n, precision=precision):
        index = None
        if s_eps is not None or k_eps is not None:
            with obs.span("kernels.prepass", rows=n,
                          kind="columns" if s_eps is None else "score"):
                index = spatial.build_index(x32, seed=seed)
        if s_eps is None:
            s0, s1 = flash_score_stats(x32, sh, precision=precision,
                                       block_m=s_bm, block_n=s_bn,
                                       prune="off")
        else:
            with obs.span("kernels.score_stats", rows=n,
                          precision=precision):
                s0, s1 = _score_stats_pruned(x32, sh, s_eps, index,
                                             precision=precision,
                                             block_m=s_bm, block_n=s_bn)
        x_sd = _apply_score_shift(x32, s0, s1, h, sh)
    if k_eps is None:
        cols = prepare_train_columns(x_sd, block_n=k_bn, precision=precision)
        sums = flash_kde_prepared(_pad_to(y, k_bm), cols.xt, cols.nrm_x,
                                  h, cols.xt_lo, precision=precision,
                                  block_m=k_bm, block_n=k_bn)[:m]
        return _normalize(sums, n, d, h)
    with obs.span("kernels.eval", rows=m, cols=n, laplace=False):
        with obs.span("kernels.prepass", kind="columns", rows=n):
            cols = prepare_train_columns(x_sd, block_n=k_bn,
                                         precision=precision, clustered=True,
                                         index=index)
        sums = _pruned_eval_sums(y, cols, h, k_eps, precision=precision,
                                 block_m=k_bm, block_n=k_bn, n_true=n)
        return _normalize(sums, n, d, h)


__all__ = [
    "PAD_VALUE", "PRUNE_AUTO_MIN_COLS", "PRUNE_AUTO_MIN_TILES", "PruneArg",
    "resolve_prune", "check_prune", "check_blocks", "flash_score_stats",
    "flash_sdkde_shift", "flash_kde", "flash_laplace_kde",
    "laplace_kde_nonfused", "TrainColumns", "prepare_train_columns",
    "columns_from_layout", "update_train_columns", "flash_kde_prepared",
    "flash_sdkde", "RING_BLOCK_M", "RING_BLOCK_N", "RingRows", "ring_rows",
    "pad_block", "score_block", "kde_block",
]
