"""Spatial tile reordering + certified tile skipping for the pruned kernels.

The counterpart of ``repro.kernels.spatial``.  A pruned pass needs three
pieces:

  1. **Clustered layout** — k-means (default) or Morton grouping of the
     (debiased) train set, laid out so every ``block_n`` column tile holds
     points of ONE cluster: each cluster's points are contiguous and
     sentinel-padded up to a tile multiple.  Queries go through the same
     layout per batch (assigned to the train centroids), so row tiles stay
     spatially coherent and their visit lists short.
  2. **Tile metadata** — per column tile: centroid, covering radius, real
     (non-sentinel) point count, and max |coordinate| (the score kernel's
     accumulator weight bound).  Sentinel rows are masked out, so
     all-padding tiles carry ``count == 0`` and are skipped for free.
  3. **Tile maps** — the bounds prepass.  For every query row the distance
     to every column-tile centroid (one ``(m × t)`` GEMM), min-reduced over
     each ``block_m`` row tile, gives

         dmin_ij = max(0, min_{r ∈ tile i} ‖y_r − c_j‖ − radius_j)
         arg_ij  = margin · dmin_ij² / (2h²)

     a certified lower bound on every pairwise exponent of the (i, j)
     tile.  The per-point contribution of tile ``j`` to any row of tile
     ``i`` is then at most

         kde:      exp(-arg)
         laplace:  exp(-arg) · (1 + d/2 + arg)
         score:    exp(-arg) · max(1, max|x| in j)

     A tile is skipped iff that bound is ≤ the caller's per-point
     ``epsilon``, or iff ``arg`` clears the f32 exp-underflow threshold
     (every pair would add exactly 0.0, so ``epsilon=0`` reproduces the
     dense sums up to summation order).  The summed bound over skipped
     tiles is the per-row-tile error certificate.

The kept tiles are compacted into per-row-tile visit lists
(``tile_map[i, k]`` = k-th column tile row tile ``i`` streams), which the
pruned kernels (``flash_pruned``) read in each block.

Differences from ``repro``: k-means draws its subsample and initial
centroids from a ``torch.Generator`` seeded with ``seed`` (so its clusters
differ from JAX's; carry a JAX index across with ``convert.index_from_state``
to compare layouts), ``tile_map`` runs in row-tile chunks whose
``(rows × t)`` distance block stays near 1 GiB, and ``visit_lists``
compacts on the tensors' device, reading back only the largest count
(and, when asked, the pass's largest certified error) in one transfer.
Streaming keeps a layout in place between rebuilds: ``place_points``
claims free slack slots for appended points, and
``tile_metadata_update`` / ``merge_tile_meta`` refresh the metadata of
only the tiles that changed.  ``partition_clusters`` assigns whole
clusters to the resilient layer's shards, bit for bit as ``repro`` does
for the same labels.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs

PAD_VALUE = 1.0e6   # matches ops.PAD_VALUE — kernel weight underflows to 0

# f32 exp(-x) is exactly 0.0 for x > 150·ln2 ≈ 103.97 (subnormal rounding).
# 105 adds a hair of slack; MARGIN then demands ~11% more headroom before a
# tile may be skipped under the exact (epsilon=0) rule.
UNDERFLOW_ARG = 105.0
#: Conservative shrink on the certified exponent lower bound: covers f32
#: rounding in the bounds prepass and the kernels' norms-minus-Gram ``sq``.
MARGIN = 0.9

KINDS = ("kde", "laplace", "score")

#: f32 elements of one chunk's (rows × tiles) distance block in ``tile_map``
#: (2**28 floats = 1 GiB).
TILE_MAP_CHUNK_ELEMS = 1 << 28

#: Host reads inside one ``torch.bincount`` on the card (its input's min,
#: then its max): the ``syncs`` a Lloyd iteration adds to ``sync.kmeans``.
#: An assumption about the PyTorch build, which ``tools/sync_audit.py``
#: checks on the card against the waits it sees.
BINCOUNT_SYNCS = 2


class SpatialIndex(NamedTuple):
    """A clustering of one point set: assignment state for layouts."""

    labels: Optional[torch.Tensor]     # (n,) int32 cluster of each point
    centroids: Optional[torch.Tensor]  # (k, d) f32 k-means centroids
    method: str = "kmeans"


class ClusterLayout(NamedTuple):
    """A cluster-aligned padded layout of one point set.

    ``points[slots[i]] == x[i]``; every other row is a sentinel.  Cluster
    c occupies a contiguous, ``block``-aligned slab, so no ``block`` tile
    ever holds two clusters.  ``real`` marks non-sentinel rows.
    """

    points: torch.Tensor  # (total, d) padded layout
    real: torch.Tensor    # (total,) bool
    slots: torch.Tensor   # (n,) int64 — row of original point i
    block: int


class TileMeta(NamedTuple):
    """Per-column-tile geometry of a cluster-aligned layout."""

    centroids: torch.Tensor  # (t, d) f32 centroid of the tile's real points
    radii: torch.Tensor      # (t,)   f32 max ‖x − centroid‖ over real points
    counts: torch.Tensor     # (t,)   int32 real (non-sentinel) points
    max_abs: torch.Tensor    # (t,)   f32 max |coordinate| over real points


class TileMap(NamedTuple):
    """Bounds-prepass output: which tiles each row block must visit."""

    keep: torch.Tensor       # (mt, t) bool
    err_bound: torch.Tensor  # (mt,)  f32 certified max abs error per row of
    #                        # the unnormalized accumulator (worst component)


class VisitLists(NamedTuple):
    """Compacted tile map in the layout the pruned kernels read."""

    counts: torch.Tensor     # (mt,) int32 visits per row tile
    tile_map: torch.Tensor   # (mt, max_visits) int32 column-tile indices
    max_visits: int          # visit-slot extent (pow2-bucketed)
    occupancy: float         # mean(counts) / n_tiles — the skip-rate stat
    max_err: float = 0.0     # largest err_bound passed to visit_lists
    visits: int = 0          # Σ counts: the row tiles' column-tile visits
    real_visit_rows: int = 0  # Σ real rows · counts (when asked, else 0)


def _numpy(a) -> np.ndarray:
    """Host copy of labels given as a tensor (any device) or array."""
    if isinstance(a, torch.Tensor):
        with obs.span("sync.labels"):
            return a.detach().cpu().numpy()
    return np.asarray(a)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a new tensor on ``device``.  On the card the copy
    goes through pinned memory without blocking, so the host does not
    wait for the queued work (a pageable copy would synchronize)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


# ---------------------------------------------------------------------------
# Clustering.
# ---------------------------------------------------------------------------


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    an = torch.sum(a * a, dim=-1)[:, None]
    bn = torch.sum(b * b, dim=-1)[None, :]
    return torch.clamp(an + bn - 2.0 * (a @ b.T), min=0.0)


def default_n_clusters(n: int) -> int:
    """sqrt-law cluster count: ~128 at 256k points, floor 2, cap 1024."""
    return max(2, min(1024, int(math.sqrt(max(n, 1) / 16.0))))


def _kmeans_fit(x: torch.Tensor, gen: torch.Generator, *, k: int,
                iters: int) -> torch.Tensor:
    """Lloyd iterations on (a subsample of) x; returns (k, d) centroids.

    ``gen`` is a CPU generator: the initial picks are drawn on the host
    and moved to ``x``'s device, so a seed picks the same points on the
    CPU and on the card."""
    n = x.shape[0]
    if n < k:
        pick = torch.randint(0, n, (k,), generator=gen)
    else:
        pick = torch.randperm(n, generator=gen)[:k]
    with obs.span("sync.kmeans"):
        c = x[pick.to(x.device)]
    # every iteration's bincount reads back twice; one span holds them all
    with obs.span("sync.kmeans", syncs=BINCOUNT_SYNCS * iters):
        for _ in range(iters):
            lab = torch.argmin(_sqdist(x, c), dim=1)
            cnt = torch.bincount(lab, minlength=k).to(torch.float32)[:, None]
            sums = torch.zeros_like(c).index_add_(0, lab, x)
            c = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1.0), c)
    return c


def _morton_codes(x: torch.Tensor) -> torch.Tensor:
    """Interleaved-bit codes; coords quantized to the data range."""
    n, d = x.shape
    bits = max(1, 31 // d)
    lo = torch.amin(x, dim=0, keepdim=True)
    hi = torch.amax(x, dim=0, keepdim=True)
    q = ((x - lo) / torch.clamp(hi - lo, min=1e-30)
         * (2**bits - 1)).to(torch.int32)
    code = torch.zeros((n,), dtype=torch.int32, device=x.device)
    for b in range(bits - 1, -1, -1):
        for j in range(d):
            code = (code << 1) | ((q[:, j] >> b) & 1)
    return code


def _morton_labels(x32: torch.Tensor, group: int = 64) -> torch.Tensor:
    """Bucketed morton-rank labels: ~``group`` spatial neighbors per label."""
    n = x32.shape[0]
    order = torch.argsort(_morton_codes(x32), stable=True)
    rank = torch.empty((n,), dtype=torch.int32, device=x32.device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=x32.device)
    return rank // group


def build_index(
    x: torch.Tensor,
    *,
    method: str = "kmeans",
    n_clusters: Optional[int] = None,
    iters: int = 8,
    fit_sample: int = 16384,
    seed: int = 0,
) -> SpatialIndex:
    """Cluster a point set; O(n·k·d) — amortized at prep/fit time.

    k-means fits Lloyd on a ≤``fit_sample`` subsample then assigns every
    point in one pass.  Morton labels points by their interleaved-bit
    code bucketed into ~64-point groups.
    """
    with obs.span("spatial.build_index", rows=x.shape[0], method=method):
        x32 = x.to(torch.float32)
        n = x32.shape[0]
        if method == "morton":
            return SpatialIndex(_morton_labels(x32), None, "morton")
        if method != "kmeans":
            raise ValueError(f"unknown spatial ordering {method!r}")
        k = n_clusters or default_n_clusters(n)
        gen = torch.Generator().manual_seed(seed)
        if n <= fit_sample:
            fit = x32
        else:
            with obs.span("sync.kmeans"):
                fit = x32[torch.randperm(n, generator=gen)[:fit_sample].to(
                    x32.device)]
        c = _kmeans_fit(fit, gen, k=k, iters=iters)
        labels = torch.argmin(_sqdist(x32, c), dim=1).to(torch.int32)
        return SpatialIndex(labels, c, "kmeans")


def assign(y: torch.Tensor, index: SpatialIndex) -> torch.Tensor:
    """Cluster labels for a NEW point set (queries) under a train index."""
    with obs.span("spatial.assign", rows=y.shape[0]):
        y32 = y.to(torch.float32)
        if index.centroids is not None:
            return torch.argmin(_sqdist(y32, index.centroids),
                                dim=1).to(torch.int32)
        # morton / centroid-free indexes: group by the queries' own codes
        return _morton_labels(y32)


# ---------------------------------------------------------------------------
# Cluster-aligned layouts (host-side slot arithmetic, as in repro).
# ---------------------------------------------------------------------------


def cluster_capacities(labels, block: int, *, slack: float = 0.0,
                       n_clusters: Optional[int] = None):
    """Per-cluster slab geometry ``(starts, caps)`` in padded-row units.

    ``slack > 0`` reserves ``ceil(size · slack)`` extra rows per cluster
    (at least one block even for an empty cluster) before rounding each
    slab up to a ``block`` multiple; ``slack == 0`` gives empty clusters
    zero rows.
    """
    lab = _numpy(labels)
    k = n_clusters if n_clusters is not None else (
        int(lab.max()) + 1 if lab.size else 1
    )
    sizes = np.bincount(lab, minlength=k)
    if slack > 0.0:
        want = sizes + np.ceil(sizes * slack).astype(np.int64)
        want = np.maximum(want, 1)                        # empty → 1 block
    else:
        want = sizes
    caps = ((want + block - 1) // block) * block
    starts = np.concatenate([[0], np.cumsum(caps)[:-1]])
    return starts.astype(np.int64), caps.astype(np.int64)


def cluster_slots(labels, block: int, *, slack: float = 0.0) -> np.ndarray:
    """Padded slot of each point: clusters contiguous, ``block``-multiples."""
    lab = _numpy(labels)
    n = lab.shape[0]
    k = int(lab.max()) + 1 if n else 1
    starts, _ = cluster_capacities(lab, block, slack=slack, n_clusters=k)
    sizes = np.bincount(lab, minlength=k)
    order = np.argsort(lab, kind="stable")
    within = np.empty(n, np.int64)
    within[order] = np.arange(n) - np.repeat(
        np.concatenate([[0], np.cumsum(sizes)[:-1]]), sizes
    )
    return (starts[lab] + within).astype(np.int32)


def place_points(real, labels_new, starts, caps) -> Optional[np.ndarray]:
    """Free slots for appended points, respecting the cluster slabs.

    ``real`` marks occupied rows of the existing layout (host array); each
    new point (cluster ``labels_new[i]``) takes the first free sentinel
    slot inside its cluster's ``[starts[c], starts[c] + caps[c])`` slab,
    so no tile ever straddles clusters and no existing row moves.
    Returns the claimed slots, or ``None`` when some cluster's slab is
    full — slack overflow, the caller's signal to rebuild the layout.
    """
    occ = _numpy(real).astype(bool)
    lab = _numpy(labels_new)
    slots = np.empty(lab.shape[0], np.int32)
    # one pass per cluster: its points, in order, take its free slots in
    # order — what a point-by-point first-free walk gives
    for c in np.unique(lab):
        mine = np.flatnonzero(lab == c)
        s, e = int(starts[c]), int(starts[c] + caps[c])
        free = np.flatnonzero(~occ[s:e])
        if free.size < mine.size:
            return None
        slots[mine] = s + free[:mine.size]
    return slots


def cluster_layout(x: torch.Tensor, labels, block: int, *,
                   total_multiple: Optional[int] = None,
                   bucket_rows: bool = False,
                   slack: float = 0.0) -> ClusterLayout:
    """Scatter a point set into its cluster-aligned sentinel-padded layout.

    ``total_multiple`` pads the total length up to a multiple (the score
    pass needs lcm(block_m, block_n)).  ``bucket_rows`` rounds the tile
    count up to a power of two, so ragged query batches land on a bounded
    set of shapes (extra tiles are all sentinel: zero count, never
    visited).  ``slack`` reserves per-cluster append headroom.
    """
    n, d = x.shape
    with obs.span("spatial.layout", rows=n, block=block):
        lab = _numpy(labels)
        slots = cluster_slots(lab, block, slack=slack)
        _, caps = cluster_capacities(lab, block, slack=slack)
        total = max(int(caps.sum()), block)
        if bucket_rows:
            tiles = -(-total // block)
            total = block * (1 << max(0, math.ceil(math.log2(tiles))))
        if total_multiple is not None:
            total = -(-total // total_multiple) * total_multiple
        with obs.span("sync.slots"):
            slots_t = torch.as_tensor(slots.astype(np.int64),
                                      device=x.device)
        points = torch.full((total, d), PAD_VALUE, dtype=x.dtype,
                            device=x.device)
        points[slots_t] = x
        real = torch.zeros((total,), dtype=torch.bool, device=x.device)
        with obs.span("sync.mask"):             # the scalar's upload
            real[slots_t] = True
        return ClusterLayout(points, real, slots_t, block)


# ---------------------------------------------------------------------------
# Tile metadata.
# ---------------------------------------------------------------------------


def tile_meta_from_rows(x3: torch.Tensor, mask: torch.Tensor) -> TileMeta:
    """TileMeta of pre-gathered tile rows: (t, block, d) points, (t, block)
    real-mask."""
    x3 = x3.to(torch.float32)
    cnt = torch.sum(mask, dim=1).to(torch.int32)
    denom = torch.clamp(cnt, min=1).to(torch.float32)[:, None]
    zero = x3.new_zeros(())
    cen = torch.sum(torch.where(mask[..., None], x3, zero), dim=1) / denom
    sq = torch.sum((x3 - cen[:, None, :]) ** 2, dim=-1)       # (t, block)
    radii = torch.sqrt(torch.amax(torch.where(mask, sq, zero), dim=1))
    max_abs = torch.amax(
        torch.where(mask[..., None], torch.abs(x3), zero), dim=(1, 2))
    return TileMeta(cen, radii, cnt, max_abs)


def tile_metadata(xp: torch.Tensor, real: torch.Tensor, *,
                  block: int) -> TileMeta:
    """Geometry of each ``block``-row tile of a cluster-aligned layout.

    ``xp`` must be the f32 points the kernel actually computes distances
    between — at reduced precision tiers, the tier-cast reconstruction —
    so the bounds certify the perturbed-operand distances.
    """
    npad, d = xp.shape
    t = npad // block
    with obs.span("spatial.tile_metadata", tiles=t, block=block):
        return tile_meta_from_rows(
            xp.to(torch.float32).reshape(t, block, d), real.reshape(t, block))


def merge_tile_meta(meta: TileMeta, tiles, sub: TileMeta) -> TileMeta:
    """A new ``TileMeta``: ``meta`` with ``sub``'s rows written over the
    listed tile indices (``meta`` itself is not changed, so a published
    snapshot holding it keeps its bytes).

    ``tiles`` may contain repeats (pow2-padded index buffers): each row of
    ``sub`` is the freshly recomputed geometry of its tile, so repeated
    writes carry equal values.
    """
    tiles = np.asarray(tiles, np.int64).reshape(-1)
    if tiles.size == 0:
        return meta
    idx = upload(tiles, meta.counts.device)
    return TileMeta(*(full.clone().index_copy_(0, idx, part)
                      for full, part in zip(meta, sub)))


def tile_metadata_update(meta: TileMeta, xp: torch.Tensor,
                         real: torch.Tensor, tiles, *,
                         block: int) -> TileMeta:
    """Refresh the metadata of only the listed tiles.

    The streaming layer calls this after an append / evict / shift pass
    with the tiles whose points changed; every other tile's geometry is
    carried over bit for bit, so certificates derived from it stay as
    valid as at the last full build.
    """
    tiles = np.asarray(tiles, np.int64).reshape(-1)
    if tiles.size == 0:
        return meta
    rows = upload((tiles[:, None] * block
                   + np.arange(block)[None, :]).reshape(-1), xp.device)
    sub = tile_meta_from_rows(
        xp.to(torch.float32).index_select(0, rows).reshape(
            tiles.size, block, -1),
        real.index_select(0, rows).reshape(tiles.size, block))
    return merge_tile_meta(meta, tiles, sub)


# ---------------------------------------------------------------------------
# The bounds prepass.
# ---------------------------------------------------------------------------


def _kind_weight(kind: str, arg: torch.Tensor, d: int,
                 max_abs: torch.Tensor):
    """Per-point weight bound w(arg) of a kind (see the module docstring)."""
    if kind == "laplace":
        return 1.0 + d / 2.0 + arg
    if kind == "score":
        return torch.clamp(max_abs, min=1.0)[None, :]
    return 1.0


def tile_map(
    yp: torch.Tensor,          # (m_pad, d) f32 padded query rows
    col_meta: TileMeta,
    inv2h2: torch.Tensor,
    epsilon,
    *,
    block_m: int,
    kind: str = "kde",
) -> TileMap:
    """Certified keep/skip decision for every (row tile, column tile) pair.

    ``epsilon`` is the per-train-point contribution threshold: a skipped
    tile's certified per-point bound is ≤ epsilon, so the absolute error on
    any row of the unnormalized accumulator is at most
    ``Σ_skipped count_j · bound_ij`` — returned as ``err_bound``.
    ``epsilon=0`` only skips tiles whose every term underflows to exactly
    0.0 in f32.  Row tiles are processed in chunks whose (rows × t)
    distance block holds about ``TILE_MAP_CHUNK_ELEMS`` floats.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown bound kind {kind!r} (choose from {KINDS})")
    m_pad, d = yp.shape
    mt = m_pad // block_m
    t = col_meta.centroids.shape[0]
    with obs.span("spatial.tile_map", row_tiles=mt, tiles=t, kind=kind):
        y32 = yp.to(torch.float32)
        chunk = block_m * max(1, TILE_MAP_CHUNK_ELEMS // max(1, t * block_m))
        dmin_c = torch.empty((mt, t), dtype=torch.float32, device=yp.device)
        for r0 in range(0, m_pad, chunk):
            rows = y32[r0:r0 + chunk]
            dist = torch.sqrt(_sqdist(rows, col_meta.centroids))
            dmin_c[r0 // block_m:(r0 + rows.shape[0]) // block_m] = \
                torch.amin(dist.reshape(-1, block_m, t), dim=1)
        dmin = torch.clamp(dmin_c - col_meta.radii[None, :], min=0.0)
        arg = MARGIN * dmin * dmin * inv2h2.to(torch.float32).reshape(())
        bound = _kind_weight(kind, arg, d, col_meta.max_abs) * torch.exp(-arg)
        with obs.span("sync.epsilon"):
            eps = torch.as_tensor(epsilon, dtype=torch.float32,
                                  device=yp.device)
        skip = (arg >= UNDERFLOW_ARG) | (col_meta.counts == 0)[None, :]
        skip = skip | ((eps > 0.0) & (bound <= eps))
        err = torch.sum(
            torch.where(skip,
                        col_meta.counts[None, :].to(torch.float32) * bound,
                        bound.new_zeros(())),
            dim=1)
        return TileMap(~skip, err)


def visit_lists(keep: torch.Tensor, *, bucket_visits: bool = True,
                err_bound: Optional[torch.Tensor] = None,
                real_rows: Optional[torch.Tensor] = None) -> VisitLists:
    """Compact a keep matrix into the per-row-tile visit-list layout.

    Row ``i`` lists its kept column tiles in ascending order; slots past
    ``counts[i]`` replay the row's first kept tile (0 when it keeps none),
    as ``repro``'s do.  The extent ``max_visits`` is the largest count,
    rounded up to a power of two (capped at the tile count) when
    ``bucket_visits``.  Runs on ``keep``'s device; only the largest count
    and the visit total are read back, with the largest ``err_bound``
    (``TileMap.err_bound``, telemetry) and ``Σ real_rows · counts``
    (``real_rows``, (mt,) real rows of each row tile: the rows the visits
    stream that are not sentinels) in the same transfer when given.
    """
    mt, t = keep.shape
    with obs.span("spatial.visit_lists", row_tiles=mt, tiles=t):
        counts = keep.sum(dim=1, dtype=torch.int32)
        max_err, real = 0.0, 0
        if mt:
            parts = [counts.max().double(), counts.sum().double()]
            if err_bound is not None and err_bound.numel():
                parts.append(err_bound.max().double())
            if real_rows is not None:
                parts.append(torch.dot(counts.double(), real_rows.double()))
            with obs.span("sync.visit_lists"):
                got = torch.stack(parts).tolist()
            cmax, total = int(got[0]), int(got[1])
            if real_rows is not None:
                real = int(got.pop())
            max_err = got[2] if len(got) > 2 else 0.0
        else:
            cmax, total = 0, 0
        kmax = max(cmax, 1)
        if bucket_visits and kmax < t:
            kmax = min(t, 1 << max(0, math.ceil(math.log2(kmax))))
        # three reads back, a span each: the nonzero's count, then the
        # sizes of the two masked selections of each row's first kept tile
        with obs.span("sync.compact"):
            rows, cols = torch.nonzero(keep, as_tuple=True)  # row-major
        pos = torch.cumsum(keep, dim=1, dtype=torch.int64)[rows, cols] - 1
        first = torch.zeros((mt,), dtype=torch.int64, device=keep.device)
        with obs.span("sync.compact"):
            lead = cols[pos == 0]
        with obs.span("sync.compact"):
            first[rows[pos == 0]] = lead
        tmap = first[:, None].expand(mt, kmax).contiguous()
        tmap[rows, pos] = cols
        occ = float(total / mt / t) if t and mt else 1.0
        return VisitLists(counts, tmap.to(torch.int32), int(kmax), occ,
                          float(max_err), total, real)


def partition_clusters(labels, n_shards: int) -> np.ndarray:
    """Balanced assignment of whole clusters to shards.

    Greedy longest-processing-time: clusters (by point count, descending,
    ties by cluster id) go to the currently-lightest shard (ties to the
    lowest shard id), after the first ``n_shards`` seed one shard each.
    Keeping clusters whole makes every shard a self-contained
    cluster-aligned tile set with its own ``TileMeta``, which the
    resilient layer's per-shard error certificates need.  Host numpy on
    the labels, so the same labels give ``repro``'s partition.

    Returns ``(k,)`` int32: the shard of each cluster.  Requires
    ``1 <= n_shards <= k`` so no shard ends up empty.
    """
    lab = _numpy(labels)
    k = int(lab.max()) + 1 if lab.size else 1
    if not (1 <= n_shards <= k):
        raise ValueError(
            f"n_shards={n_shards} must be in [1, n_clusters={k}]")
    sizes = np.bincount(lab, minlength=k)
    shard_of = np.zeros(k, np.int32)
    load = np.zeros(n_shards, np.int64)
    for filled, c in enumerate(np.argsort(-sizes, kind="stable")):
        s = filled if filled < n_shards else int(np.argmin(load))
        shard_of[c] = s
        load[s] += sizes[c]
    return shard_of


def point_mass_bound(y: torch.Tensor, meta: TileMeta, inv2h2,
                     *, kind: str = "kde") -> torch.Tensor:
    """Per-query upper bound on the unnormalized kernel mass of an entire
    absent point set summarized by ``meta`` (``tile_map``'s geometry per
    query row instead of per row tile)."""
    if kind not in KINDS:
        raise ValueError(f"unknown bound kind {kind!r} (choose from {KINDS})")
    y32 = y.to(torch.float32)
    d = y32.shape[-1]
    dist = torch.sqrt(_sqdist(y32, meta.centroids))           # (m, t)
    dmin = torch.clamp(dist - meta.radii[None, :], min=0.0)
    inv = torch.as_tensor(inv2h2, dtype=torch.float32,
                          device=y32.device).reshape(())
    arg = MARGIN * dmin * dmin * inv
    per = (meta.counts[None, :].to(torch.float32)
           * _kind_weight(kind, arg, d, meta.max_abs) * torch.exp(-arg))
    return torch.sum(per, dim=1)                              # (m,)


def epsilon_for_density_error(abs_err: float, d: int, h: float) -> float:
    """Per-point epsilon giving |Δdensity| ≤ abs_err (normalization undone).

    density = sums / (n·(2π)^{d/2}·h^d) and the dropped unnormalized mass
    is ≤ n·epsilon, so epsilon = abs_err · (2π)^{d/2} · h^d.
    """
    return float(abs_err * (2.0 * math.pi) ** (d / 2.0) * h**d)


__all__ = [
    "PAD_VALUE", "UNDERFLOW_ARG", "MARGIN", "KINDS", "TILE_MAP_CHUNK_ELEMS",
    "SpatialIndex", "ClusterLayout", "TileMeta", "TileMap", "VisitLists",
    "default_n_clusters", "build_index", "assign", "cluster_capacities",
    "cluster_slots", "place_points", "cluster_layout", "upload",
    "tile_meta_from_rows", "tile_metadata", "merge_tile_meta",
    "tile_metadata_update", "tile_map", "visit_lists", "partition_clusters",
    "point_mass_bound",
    "epsilon_for_density_error",
]
