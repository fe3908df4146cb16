"""Pruned flash kernels (B3 score, B4 KDE / fused Laplace): visit lists.

The dense kernels stream every column tile for every row tile; these
stream, for row tile ``i``, only the column tiles
``tile_map[i, :counts[i]]`` that the bounds prepass kept
(``kernels/spatial.py``).  Rows arrive in the cluster-aligned layout, so
the row count is a multiple of ``block_m`` and the column count a multiple
of ``block_n``.  Visit slots past ``counts[i]`` are never run, and a row
tile with no visits sums to zero.  Three functions per kernel:

  * ``flash_score_pruned_cuda`` / ``flash_kde_pruned_cuda`` launch the
    hand-written CUDA kernels (``csrc/flash_pruned.cu``: the split-column
    bodies of ``csrc/flash_score_pass.cuh`` and ``csrc/flash_kde_pass.cuh``)
    on CUDA tensors and count the launch;
  * ``flash_score_pruned_plain`` / ``flash_kde_pruned_plain`` are the same
    functions in plain PyTorch: one visit slot at a time for all row tiles
    at once, each visited tile's terms summed into a partial that is added
    to the running total;
  * ``flash_score_pruned`` / ``flash_kde_pruned`` take the plain version
    for CPU tensors and the kernel for CUDA tensors — no fallback.

Arguments follow ``repro.kernels.flash_pruned``: ``counts`` (mt,) int32
and ``tile_map`` (mt, max_visits) int32 first, then the dense kernels'
operands; ``max_visits`` is ``tile_map``'s width.  ``flash_kde_pruned``
takes ``laplace`` (the fused Laplace factor ``1 + d/2 − sq/2h²``).

Each pass keeps its counts, ``score_counts`` (B3), ``kde_counts`` (B4)
and ``laplace_counts`` (B4 with ``laplace``): a launch adds one to
``launches``, the tiles it visits (``Σ counts``) to ``tiles_visited`` and
the tiles a dense pass would visit (``mt × n/block_n``) to
``tiles_total``; their ratio is the occupancy of the launches (the
launch-side view beside the metrics registry's
``kernels.prune.visit_fraction`` histogram, which ``kernels/ops.py`` feeds
from the visit lists).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_kde as _dense_kde
from repro_torch.kernels import flash_score as _dense_score
from repro_torch.kernels import precision as prec
from repro_torch.kernels.flash_kde import TIER_CODES, check_cuda, plan_splits

_KDE_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                 + [ctypes.c_void_p])
_SCORE_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])



@dataclasses.dataclass
class LaunchCounts:
    """Launches of one kernel, and the column tiles they streamed.

    The visited tiles are summed on the device and read back only when
    ``tiles_visited`` is read, so counting adds no sync to a launch."""

    launches: int = 0
    tiles_total: int = 0     # the tiles dense launches would stream
    _visited: object = 0     # Σ counts over the launches (device scalar)

    def add(self, counts: torch.Tensor, tiles_total: int) -> None:
        self.launches += 1
        self.tiles_total += tiles_total
        self._visited = self._visited + counts.sum(dtype=torch.int64)

    def reset(self) -> None:
        self.launches = self.tiles_total = self._visited = 0

    @property
    def tiles_visited(self) -> int:
        return int(self._visited)

    @property
    def occupancy(self) -> float:
        return self.tiles_visited / self.tiles_total if self.tiles_total \
            else 0.0


#: Counts of the ``*_cuda`` launches; ``reset()`` starts a count.
score_counts = LaunchCounts()
kde_counts = LaunchCounts()
laplace_counts = LaunchCounts()


def _check_visits(counts, tile_map, rows, cols, block_m, block_n):
    """Visit lists for ``rows // block_m`` row tiles (the operand checks,
    multiples included, are the dense kernels')."""
    mt = rows // block_m
    if (counts.ndim != 1 or counts.shape[0] != mt or tile_map.ndim != 2
            or tile_map.shape[0] != mt or tile_map.shape[1] < 1):
        raise ValueError(f"counts {tuple(counts.shape)} / tile_map "
                         f"{tuple(tile_map.shape)} do not match {mt} row "
                         f"tiles")
    return mt, cols // block_n


def _ptr(t):
    return None if t is None else t.data_ptr()


def _column_tiles(xt, block_n):
    """(d, n) columns as (t, d, block_n) tiles, indexable by tile."""
    d, n = xt.shape
    return xt.reshape(d, n // block_n, block_n).permute(1, 0, 2)


def _gram(rows, rows_lo, cols, cols_lo):
    if rows_lo is None:
        return prec.dot_f32(rows, cols)
    return prec.gram_compensated(rows, rows_lo, cols, cols_lo)


# ---------------------------------------------------------------------------
# B4: KDE / fused-Laplace sums over the visit lists.
# ---------------------------------------------------------------------------


def flash_kde_pruned_plain(
    counts: torch.Tensor,
    tile_map: torch.Tensor,
    y: torch.Tensor,
    nrm_y: torch.Tensor,
    xt: torch.Tensor,
    nrm_x: torch.Tensor,
    inv2h2: torch.Tensor,
    y_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
    laplace: bool = False,
) -> torch.Tensor:
    """Plain PyTorch B4: (m, 1) f32 sums, one visit slot at a time."""
    m, d = y.shape
    mt = m // block_m
    rows = y.reshape(mt, block_m, d)
    rows_lo = None if y_lo is None else y_lo.reshape(mt, block_m, d)
    nrm_r = nrm_y.reshape(mt, block_m, 1)
    cols = _column_tiles(xt, block_n)
    cols_lo = None if xt_lo is None else _column_tiles(xt_lo, block_n)
    nrm_c = nrm_x.reshape(-1, 1, block_n)
    visits = counts.to(torch.int64)
    tmap = tile_map.to(torch.int64)
    out = torch.zeros((mt, block_m, 1), dtype=torch.float32, device=y.device)
    for k in range(int(visits.max()) if mt else 0):
        j = tmap[:, k]
        g = _gram(rows, rows_lo, cols[j],
                  None if cols_lo is None else cols_lo[j])
        sq = torch.clamp(nrm_r + nrm_c[j] - 2.0 * g, min=0.0)
        scaled = sq * inv2h2
        phi = torch.exp(-scaled)
        if laplace:
            phi = phi * (1.0 + d / 2.0 - scaled)
        part = phi.sum(dim=2, keepdim=True)
        out += torch.where((k < visits)[:, None, None], part,
                           part.new_zeros(()))
    return out.reshape(m, 1)


def flash_kde_pruned_cuda(
    counts: torch.Tensor,
    tile_map: torch.Tensor,
    y: torch.Tensor,
    nrm_y: torch.Tensor,
    xt: torch.Tensor,
    nrm_x: torch.Tensor,
    inv2h2: torch.Tensor,
    y_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
    laplace: bool = False,
) -> torch.Tensor:
    """Launch kernel B4 (both of its passes) on the current stream;
    returns (m, 1) f32 sums.  The visit slots are split as
    ``plan_splits(n, block_n, max_visits)`` plans them."""
    m, n, d = _dense_kde._check(y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo,
                                block_m, block_n)
    mt, t = _check_visits(counts, tile_map, m, n, block_m, block_n)
    tier = prec.tier_of(y, y_lo)
    dev = check_cuda("flash_kde_pruned_cuda", tier, (y, xt, y_lo, xt_lo),
                     (nrm_y, nrm_x, inv2h2), d, block_m,
                     ints=(counts, tile_map))
    plan = plan_splits(n, block_n, tile_map.shape[1])
    launch, error = _build.load("flash_pruned", _KDE_ARGTYPES, "kde_launch")
    part = torch.empty(plan.scratch_shape(m), dtype=torch.float32,
                       device=dev)
    out = torch.empty((m, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(_ptr(counts), _ptr(tile_map), tile_map.shape[1],
                    _ptr(y), _ptr(y_lo), _ptr(nrm_y), _ptr(xt), _ptr(xt_lo),
                    _ptr(nrm_x), _ptr(inv2h2), _ptr(part), _ptr(out), m, n,
                    d, TIER_CODES[tier], block_m, block_n, int(laplace),
                    plan.per_split, plan.splits, stream)
    if rc != 0:
        raise RuntimeError(f"flash_kde_pruned launch failed ({rc}): "
                           f"{error(rc).decode()} [m={m} n={n} d={d} "
                           f"tier={tier} block_m={block_m} block_n={block_n} "
                           f"max_visits={tile_map.shape[1]} "
                           f"splits={plan.splits}]")
    (laplace_counts if laplace else kde_counts).add(counts, mt * t)
    return out


def flash_kde_pruned(
    counts: torch.Tensor,
    tile_map: torch.Tensor,
    y: torch.Tensor,
    nrm_y: torch.Tensor,
    xt: torch.Tensor,
    nrm_x: torch.Tensor,
    inv2h2: torch.Tensor,
    y_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
    laplace: bool = False,
) -> torch.Tensor:
    """B4 on the tensors' device: plain PyTorch on the CPU, the kernel on
    the card.  Returns unnormalized sums (m, 1) f32."""
    if y.device.type == "cpu":
        _dense_kde._check(y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo, block_m,
                          block_n)
        _check_visits(counts, tile_map, y.shape[0], xt.shape[1], block_m,
                      block_n)
        return flash_kde_pruned_plain(
            counts, tile_map, y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo,
            block_m=block_m, block_n=block_n, laplace=laplace)
    return flash_kde_pruned_cuda(
        counts, tile_map, y, nrm_y, xt, nrm_x, inv2h2, y_lo, xt_lo,
        block_m=block_m, block_n=block_n, laplace=laplace)


# ---------------------------------------------------------------------------
# B3: score statistics over the visit lists.
# ---------------------------------------------------------------------------


def flash_score_pruned_plain(
    counts: torch.Tensor,
    tile_map: torch.Tensor,
    x: torch.Tensor,
    nrm: torch.Tensor,
    xt: torch.Tensor,
    xaug: Optional[torch.Tensor],
    inv2h2: torch.Tensor,
    x_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    xaug_lo: Optional[torch.Tensor] = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """Plain PyTorch B3: (n, d+1) f32 S1aug, one visit slot at a time;
    ``xaug=None`` is ``[xt^T | 1]``."""
    n, d = x.shape
    if xaug is None:
        xaug = _dense_score.ones_augmented(xt)
    mt = n // block_m
    rows = x.reshape(mt, block_m, d)
    rows_lo = None if x_lo is None else x_lo.reshape(mt, block_m, d)
    nrm_r = nrm.reshape(mt, block_m, 1)
    cols = _column_tiles(xt, block_n)
    cols_lo = None if xt_lo is None else _column_tiles(xt_lo, block_n)
    nrm_c = nrm.reshape(-1, 1, block_n)
    aug = xaug.reshape(-1, block_n, d + 1)
    aug_lo = None if xaug_lo is None else xaug_lo.reshape(-1, block_n, d + 1)
    visits = counts.to(torch.int64)
    tmap = tile_map.to(torch.int64)
    out = torch.zeros((mt, block_m, d + 1), dtype=torch.float32,
                      device=x.device)
    for k in range(int(visits.max()) if mt else 0):
        j = tmap[:, k]
        g = _gram(rows, rows_lo, cols[j],
                  None if cols_lo is None else cols_lo[j])
        sq = torch.clamp(nrm_r + nrm_c[j] - 2.0 * g, min=0.0)
        phi = torch.exp(-sq * inv2h2)
        part = prec.weighted_accum(phi, aug[j],
                                   None if aug_lo is None else aug_lo[j])
        out += torch.where((k < visits)[:, None, None], part,
                           part.new_zeros(()))
    return out.reshape(n, d + 1)


def flash_score_pruned_cuda(
    counts: torch.Tensor,
    tile_map: torch.Tensor,
    x: torch.Tensor,
    nrm: torch.Tensor,
    xt: torch.Tensor,
    xaug: Optional[torch.Tensor],
    inv2h2: torch.Tensor,
    x_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    xaug_lo: Optional[torch.Tensor] = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """Launch kernel B3 (both of its passes) on the current stream;
    returns (n, d+1) f32.  The visit slots are split as
    ``flash_score.plan_score_splits(n, block_n, d, max_visits)`` plans
    them."""
    n, _, d = _dense_score._check(x, nrm, xt, xaug, inv2h2, x_lo, xt_lo,
                                  xaug_lo, block_m, block_n)
    mt, t = _check_visits(counts, tile_map, n, n, block_m, block_n)
    los = (x_lo, xt_lo, xaug_lo)
    tier = prec.tier_of(x, x_lo)
    if tier == "f32" and xaug is not None:
        raise ValueError("flash_score_pruned_cuda: the f32 kernel makes "
                         "[xt^T | 1] from xt; pass xaug=None")
    dev = check_cuda("flash_score_pruned_cuda", tier, (x, xt, xaug) + los,
                     (nrm, inv2h2), d, block_m, ints=(counts, tile_map))
    plan = _dense_score.plan_score_splits(n, block_n, d, tile_map.shape[1])
    launch, error = _build.load("flash_pruned", _SCORE_ARGTYPES,
                                "score_launch")
    shape = plan.scratch_shape(n)
    part = None if shape is None else torch.empty(
        shape, dtype=torch.float32, device=dev)
    out = torch.empty((n, d + 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(_ptr(counts), _ptr(tile_map), tile_map.shape[1],
                    _ptr(x), _ptr(x_lo), _ptr(nrm), _ptr(xt), _ptr(xt_lo),
                    _ptr(xaug), _ptr(xaug_lo), _ptr(inv2h2), _ptr(part),
                    _ptr(out), n, d, TIER_CODES[tier], block_m, block_n,
                    plan.per_split, plan.splits, stream)
    if rc != 0:
        raise RuntimeError(f"flash_score_pruned launch failed ({rc}): "
                           f"{error(rc).decode()} [n={n} d={d} tier={tier} "
                           f"block_m={block_m} block_n={block_n} "
                           f"max_visits={tile_map.shape[1]} "
                           f"splits={plan.splits}]")
    score_counts.add(counts, mt * t)
    return out


def flash_score_pruned(
    counts: torch.Tensor,
    tile_map: torch.Tensor,
    x: torch.Tensor,
    nrm: torch.Tensor,
    xt: torch.Tensor,
    xaug: Optional[torch.Tensor],
    inv2h2: torch.Tensor,
    x_lo: Optional[torch.Tensor] = None,
    xt_lo: Optional[torch.Tensor] = None,
    xaug_lo: Optional[torch.Tensor] = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
) -> torch.Tensor:
    """B3 on the tensors' device: plain PyTorch on the CPU, the kernel on
    the card.  Returns S1aug (n, d+1) f32."""
    if x.device.type == "cpu":
        _dense_score._check(x, nrm, xt, xaug, inv2h2, x_lo, xt_lo, xaug_lo,
                            block_m, block_n)
        _check_visits(counts, tile_map, x.shape[0], x.shape[0], block_m,
                      block_n)
        return flash_score_pruned_plain(
            counts, tile_map, x, nrm, xt, xaug, inv2h2, x_lo, xt_lo,
            xaug_lo, block_m=block_m, block_n=block_n)
    return flash_score_pruned_cuda(
        counts, tile_map, x, nrm, xt, xaug, inv2h2, x_lo, xt_lo, xaug_lo,
        block_m=block_m, block_n=block_n)


__all__ = [
    "LaunchCounts", "score_counts", "kde_counts", "laplace_counts",
    "flash_kde_pruned",
    "flash_kde_pruned_cuda", "flash_kde_pruned_plain",
    "flash_score_pruned", "flash_score_pruned_cuda",
    "flash_score_pruned_plain",
]
