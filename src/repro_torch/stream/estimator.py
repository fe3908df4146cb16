"""Incremental SD-KDE: append / evict / sliding-window without a refit.

The counterpart of ``repro.stream.estimator``.  A ``StreamingSDKDE``
holds a *live set* of train points whose score statistics (S0, S1) are
maintained incrementally (``stream.delta``): an append or eviction costs
one O(n·b·d) cross GEMM instead of the O(n²·d) score pass a refit pays,
and the debiased positions of every live point are recomputed from the
maintained statistics, so after any interleaving of updates the served
densities match a full refit to float tolerance.

Everything per point lives on the stream's device: the live points, the
f64 statistics, the dirty mask and the padded layout's points.  The host
keeps ids, cluster labels, slots, slab geometry and the layout's occupied
mask (``place_points`` is a host loop).  An append reads one thing back
from the device, its cluster labels; a flush reads one, the dirty mask
(with the published layout's mean tile radius in the same transfer).
``host_reads`` counts them by phase.  Index lists go to the device
through pinned memory without blocking (``spatial.upload``).

The ``flash`` backend's serving layout is kept in place between
*rebuilds*:

  * appends are assigned to the existing clusters (``spatial.assign``) and
    claim per-cluster **slack slots** reserved inside the sentinel-padded
    layout (``spatial.cluster_capacities(slack=…)``), so the layout's
    shape, and with it every bucket callable, survives the update;
  * evictions turn their slots back into sentinels, mid-tile;
  * only the **dirty tiles** — tiles holding appended/evicted slots or
    points whose statistics changed (a far-away append changes nothing:
    its kernel weight is exactly 0.0) — have their operand columns
    re-cast and their metadata recomputed (``ops.update_train_columns``);
    clean tiles carry over bit for bit.

Updates are folded into serving via **generations**: every ``append`` /
``evict`` bumps ``gen``; ``flush`` publishes an immutable
``StreamSnapshot`` of the current generation (optionally on a worker
thread, so queries keep serving generation ``g`` while ``g+1`` builds);
``ensure(budget)`` is the serving engine's staleness gate.  A snapshot's
tensors are never written after it is published: the working layout is
copied at every flush, and so are the column planes before their dirty
tiles are rewritten.  A ``RebuildPolicy`` (``stream.config``) triggers a
full re-cluster when slack overflows or a budget is spent.  The mean
tile radius of a published layout is read at the next flush (in the same
transfer as the dirty mask), so a radius drift rebuilds one flush later
than in ``repro``, which reads it at once.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import fault_injection, obs
from repro_torch.core.bandwidth import gaussian_norm_const
from repro_torch.kernels import ops, spatial
from repro_torch.stream import delta
from repro_torch.stream.config import (DELTA_BLOCK, RebuildPolicy,
                                       StreamConfig)

PAD_VALUE = ops.PAD_VALUE
BACKENDS = ("flash", "torch")


class StreamSnapshot(NamedTuple):
    """An immutable published generation: everything a query dispatch
    reads.  Snapshots are replaced wholesale (never mutated), so a query
    holding one is race-free against concurrent appends/evictions — the
    in-flight dispatch finishes against the generation it started with.
    ``columns`` is lazily extended per precision tier under the stream's
    lock; existing entries are never rewritten."""

    gen: int
    layout_epoch: int
    n_live: int
    norm: float                       # n_live · (2π)^{d/2} · h^d
    points: torch.Tensor              # (n_live, d) f32 debiased live points
    xp: Optional[torch.Tensor]        # padded layout points
    real: Optional[torch.Tensor]      # (total,) bool (flash)
    index: Optional[spatial.SpatialIndex]
    columns: Dict[str, ops.TrainColumns]
    affected_tiles: int               # tiles refreshed by this flush
    total_tiles: int
    ids: Optional[np.ndarray] = None  # live ids aligned with ``points``


class StreamingSDKDE:
    """Incrementally maintained KDE / SD-KDE / Laplace-KDE train state.

    ``method="sdkde"`` pays one full O(n²·d) score pass at construction
    and never again; ``"kde"`` / ``"laplace"`` need no statistics, so only
    the layout machinery runs.  ``backend="flash"`` maintains the
    cluster-aligned serving layout the kernels read; ``"torch"`` just the
    live debiased points.
    """

    def __init__(self, x0, h: float, *, method: str = "sdkde",
                 score_h: Optional[float] = None, backend: str = "flash",
                 block_n: int = 128, precision: str = "f32",
                 config: StreamConfig | None = None, seed: int = 0,
                 device: "str | torch.device" = "cuda"):
        self._setup(h, method=method, score_h=score_h, backend=backend,
                    block_n=block_n, precision=precision, config=config,
                    seed=seed, device=device)
        x0 = self._as_points(x0)
        if x0.shape[0] < 1:
            raise ValueError("streaming estimator needs >= 1 initial point")
        self.d = int(x0.shape[1])
        self.x = x0                               # original (pre-shift)
        self.ids = np.arange(x0.shape[0], dtype=np.int64)
        self.next_id = int(x0.shape[0])
        if method == "sdkde":
            self.s0, self.s1 = delta.initial_stats(
                self.x, self.sh, block=DELTA_BLOCK)
        else:
            self.s0 = self.s1 = None
        self.policy.reset(x0.shape[0])
        self._dirty = torch.zeros(x0.shape[0], dtype=torch.bool,
                                  device=self.device)
        self._flush_sync()                        # publish generation 0

    def _setup(self, h, *, method, score_h, backend, block_n, precision,
               config, seed, device) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"streaming supports the {BACKENDS} backends, "
                             f"not {backend!r}")
        if method not in ("kde", "sdkde", "laplace"):
            raise ValueError(f"unknown method {method!r}")
        ops.check_blocks(1, block_n)
        self.config = config or StreamConfig()
        self.method = method
        self.backend = backend
        self.block_n = int(block_n)
        self.precision = precision
        self.h = float(h)
        self.sh = float(score_h) if score_h is not None else float(h)
        self.seed = int(seed)
        self.device = device_mod.resolve(device)
        self.gen = 0
        self.layout_epoch = 0
        self.rebuilds = 0
        self.last_rebuild_reason: Optional[str] = None
        self.policy = RebuildPolicy()
        #: device → host reads by phase ("append", "flush", "rebuild")
        self.host_reads = {"append": 0, "flush": 0, "rebuild": 0}
        self._tiers = {precision}
        self._dirty_tiles: set = set()            # evicted slots' tiles
        self._lock = threading.RLock()
        self._worker: Optional[threading.Thread] = None
        # flash layout state (None on the torch backend)
        self._index: Optional[spatial.SpatialIndex] = None
        self._labels = self._slots = None         # host int64
        self._starts = self._caps = None          # host slab geometry
        self._xp: Optional[torch.Tensor] = None   # device working layout
        self._real: Optional[np.ndarray] = None   # host occupied mask
        self._pending_radius: Optional[torch.Tensor] = None
        self._snapshot: Optional[StreamSnapshot] = None

    # -- properties ------------------------------------------------------

    @property
    def n_live(self) -> int:
        return int(self.x.shape[0])

    @property
    def staleness(self) -> int:
        """Applied-but-unpublished update generations."""
        snap = self._snapshot
        return self.gen - (snap.gen if snap is not None else -1)

    def snapshot(self) -> StreamSnapshot:
        """The currently published generation (possibly stale)."""
        return self._snapshot

    # -- updates ---------------------------------------------------------

    def append(self, xs) -> np.ndarray:
        """Fold new points into the live set; returns their assigned ids.

        O(n·b·d): one delta score pass (sdkde), a nearest-centroid cluster
        assignment, and slack-slot placement.  The published snapshot is
        untouched — call ``flush()`` (or let the engine's staleness gate
        do it) to serve the new generation.
        """
        xs = self._as_points(xs)
        if xs.shape[1] != self.d:
            raise ValueError(f"append dim {xs.shape[1]} != {self.d}")
        b = int(xs.shape[0])
        obs.counter("stream.appends", "append calls").inc()
        obs.counter("stream.append_points", "points appended").inc(b)
        with obs.span("stream.append", points=b, n_live=self.n_live), \
                self._lock:
            if self.method == "sdkde":
                ds0, ds1, s0n, s1n = delta.append_delta(
                    self.x, xs, self.sh, block=DELTA_BLOCK)
                changed = ds0 != 0.0
                self.s0 = torch.cat([self.s0 + ds0, s0n])
                self.s1 = torch.cat([self.s1 + ds1, s1n])
                new_sd = delta.apply_shift(xs, s0n, s1n, self.h,
                                           self.sh).to(torch.float32)
            else:
                changed = torch.zeros_like(self._dirty)
                new_sd = xs
            new_ids = np.arange(self.next_id, self.next_id + b,
                                dtype=np.int64)
            self.next_id += b
            self.x = torch.cat([self.x, xs])
            self.ids = np.concatenate([self.ids, new_ids])
            self._dirty = torch.cat([self._dirty | changed,
                                     changed.new_ones(b)])
            if self.backend == "flash":
                labels_new = self._read(
                    spatial.assign(new_sd, self._index), "append"
                ).astype(np.int64)
                self._labels = np.concatenate([self._labels, labels_new])
                slots_new = None
                if not self.policy.overflowed:
                    slots_new = spatial.place_points(
                        self._real, labels_new, self._starts, self._caps)
                if slots_new is None:
                    # slack overflow: the layout can no longer hold the
                    # live set; park the rows and force a rebuild at the
                    # next flush
                    self.policy.note_overflow()
                    self._slots = np.concatenate(
                        [self._slots, np.full(b, -1, np.int64)])
                else:
                    self._real[slots_new] = True
                    self._slots = np.concatenate(
                        [self._slots, slots_new.astype(np.int64)])
            self.gen += 1
            self.policy.note_append(b)
        self._maybe_background()
        return new_ids

    def evict(self, ids) -> int:
        """Remove points by id; returns the number evicted.

        O(n·e·d): one delta pass subtracts the evicted points'
        contributions from every kept statistic; their slots revert to
        sentinels in place (the layout's shape is untouched).
        """
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        obs.counter("stream.evictions", "evict calls").inc()
        obs.counter("stream.evict_points", "points evicted").inc(
            int(ids.shape[0]))
        with obs.span("stream.evict", points=int(ids.shape[0]),
                      n_live=self.n_live), self._lock:
            out = np.isin(self.ids, ids)
            if out.sum() != ids.shape[0]:
                missing = np.setdiff1d(ids, self.ids)
                raise KeyError(f"ids not live: {missing[:8].tolist()}")
            if out.all():
                raise ValueError("cannot evict every live point")
            keep = ~out
            keep_idx = spatial.upload(np.flatnonzero(keep), self.device)
            x_keep = self.x.index_select(0, keep_idx)
            if self.method == "sdkde":
                x_out = self.x.index_select(
                    0, spatial.upload(np.flatnonzero(out), self.device))
                ds0, ds1 = delta.evict_delta(
                    x_keep, x_out, self.sh, block=DELTA_BLOCK)
                changed = ds0 != 0.0
                self.s0 = self.s0.index_select(0, keep_idx) - ds0
                self.s1 = self.s1.index_select(0, keep_idx) - ds1
            else:
                changed = torch.zeros(x_keep.shape[0], dtype=torch.bool,
                                      device=self.device)
            if self.backend == "flash":
                slots_out = self._slots[out]
                placed = slots_out[slots_out >= 0]
                self._real[placed] = False
                self._xp[spatial.upload(placed, self.device)] = PAD_VALUE
                self._dirty_tiles.update((placed // self.block_n).tolist())
                self._slots = self._slots[keep]
                self._labels = self._labels[keep]
            self.x = x_keep
            self.ids = self.ids[keep]
            self._dirty = self._dirty.index_select(0, keep_idx) | changed
            self.gen += 1
            self.policy.note_evict(int(out.sum()))
        self._maybe_background()
        return int(out.sum())

    def slide(self, xs) -> np.ndarray:
        """Sliding-window update: append ``xs``, evict the oldest as many.

        Live ids are monotone, so the oldest points are the smallest ids.
        """
        xs = self._as_points(xs)
        with self._lock:
            new_ids = self.append(xs)
            self.evict(self.ids[: xs.shape[0]])
        return new_ids

    # -- publishing ------------------------------------------------------

    def flush(self, wait: bool = True) -> StreamSnapshot:
        """Publish a snapshot of the current generation.

        ``wait=False`` with ``config.background`` starts the build on a
        worker thread and returns the (stale) published snapshot — the
        "serve g while g+1 prepares" mode.
        """
        if not wait and self.config.background:
            with self._lock:
                snap = self._snapshot
                if snap.gen == self.gen:
                    return snap
                if self._worker is None or not self._worker.is_alive():
                    self._worker = threading.Thread(
                        target=self._flush_sync, kwargs={"background": True},
                        daemon=True)
                    self._worker.start()
                return snap
        return self._flush_sync()

    def ensure(self, budget: Optional[int] = None) -> StreamSnapshot:
        """The serving gate: a snapshot no more than ``budget`` generations
        stale (default: ``config.staleness_budget``), waiting for or
        performing a flush only when the budget is exceeded."""
        budget = self.config.staleness_budget if budget is None else budget
        snap = self._snapshot
        if self.gen - snap.gen <= budget:
            return snap
        worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join()
            snap = self._snapshot
            if self.gen - snap.gen <= budget:
                return snap
        return self._flush_sync()

    def columns_for(self, tier: str,
                    snap: Optional[StreamSnapshot] = None
                    ) -> ops.TrainColumns:
        """Prepared train columns of a snapshot at one tier (built lazily
        on first use, then refreshed incrementally at every flush).

        Pass the ``snap`` an in-flight dispatch is pinned to so a
        concurrent flush/evict can never swap train tensors mid-query;
        default is the currently published snapshot."""
        if snap is None:
            snap = self._snapshot
        cols = snap.columns.get(tier)
        if cols is not None:
            return cols
        with self._lock:
            if tier not in snap.columns:
                self._tiers.add(tier)
                snap.columns[tier] = ops.columns_from_layout(
                    snap.xp, snap.real, snap.index, block_n=self.block_n,
                    precision=tier)
            return snap.columns[tier]

    # -- internals -------------------------------------------------------

    def _as_points(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            x = x.to(device=self.device, dtype=torch.float32)
        else:
            x = spatial.upload(np.asarray(x, np.float32), self.device)
        return torch.atleast_2d(x)

    def _read(self, t: torch.Tensor, phase: str) -> np.ndarray:
        """The one way this class reads the device: counted by phase."""
        self.host_reads[phase] += 1
        return t.cpu().numpy()

    def _maybe_background(self) -> None:
        if self.config.background:
            self.flush(wait=False)

    def _flush_sync(self, background: bool = False) -> StreamSnapshot:
        with self._lock:
            snap = self._snapshot
            if snap is not None and snap.gen == self.gen:
                return snap
            with obs.span("stream.flush", gen=self.gen, n_live=self.n_live):
                # chaos hook: a staleness blowout is a flush that stalls,
                # so queries queue behind the staleness gate
                fault_injection.fire("stream.flush", gen=self.gen)
                snap = self._build_snapshot()
                if background and self.device.type == "cuda":
                    # the worker's build is queued on this thread's stream;
                    # publish only once it has run, whatever stream a
                    # reader of the snapshot uses
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
                    done.synchronize()
            obs.counter("stream.publishes",
                        "snapshot generations published").inc()
            obs.gauge("stream.dirty_tiles",
                      "tiles refreshed by the last flush").set(
                snap.affected_tiles)
            if snap.real is not None:
                # live rows / layout slots: how full the slack-padded
                # serving layout is (1.0 = the next append overflows)
                obs.gauge("stream.slack_occupancy",
                          "live rows / layout slots").set(
                    snap.n_live / snap.xp.shape[0])
            self._snapshot = snap
            return snap

    def _shifted(self) -> torch.Tensor:
        if self.method == "sdkde":
            return delta.apply_shift(self.x, self.s0, self.s1, self.h,
                                     self.sh).to(torch.float32)
        return self.x

    def _norm(self, n: int) -> float:
        return n * gaussian_norm_const(self.d, 1.0) * self.h ** self.d

    def _build_snapshot(self) -> StreamSnapshot:
        x_sd = self._shifted()
        n = int(x_sd.shape[0])
        norm = self._norm(n)
        if self.backend != "flash":
            # torch path: publish the live points sentinel-padded to a pow2
            # row bucket (``xp``), so the engine sees a bounded set of
            # shapes across generations
            total = max(256, 1 << int(n - 1).bit_length())
            xp = x_sd.new_full((total, self.d), PAD_VALUE)
            xp[:n] = x_sd
            return StreamSnapshot(self.gen, self.layout_epoch, n, norm, x_sd,
                                  xp, None, None, {}, 0, 0,
                                  ids=self.ids)

        reason = (self.policy.reason()
                  if self._index is not None else "initial")
        if reason is not None:
            return self._publish_rebuilt(x_sd, norm, reason)
        # the flush's one read: the dirty mask, and the published layout's
        # mean tile radius for the drift policy
        parts = [self._dirty.view(torch.uint8)]
        if self._pending_radius is not None:
            parts.append(self._pending_radius.reshape(1).view(torch.uint8))
        got = self._read(torch.cat(parts), "flush")
        dirty = got[:n].astype(bool)
        if self._pending_radius is not None:
            self._pending_radius = None
            drift = self.policy.note_mean_radius(
                float(got[n:].copy().view(np.float32)[0]))
            if drift is not None:
                return self._publish_rebuilt(x_sd, norm, drift)

        # incremental path: re-scatter only the dirty rows, refresh only
        # the affected tiles' columns and metadata
        rows = np.flatnonzero(dirty)
        dirty_slots = self._slots[rows]
        self._xp[spatial.upload(dirty_slots, self.device)] = \
            x_sd.index_select(0, spatial.upload(rows, self.device))
        total_tiles = self._xp.shape[0] // self.block_n
        tiles = np.zeros(total_tiles, bool)
        tiles[dirty_slots // self.block_n] = True
        tiles[list(self._dirty_tiles)] = True
        n_tiles = int(tiles.sum())
        prev = self._snapshot.columns
        xp, real = self._publish_layout()
        if n_tiles >= max(1, total_tiles // 2):
            cols = {t: ops.columns_from_layout(
                xp, real, self._index, block_n=self.block_n, precision=t)
                for t in self._tiers}
        else:
            tidx = _pow2_pad(np.flatnonzero(tiles))
            cols = {t: (ops.update_train_columns(prev[t], xp, real, tidx,
                                                 precision=t)
                        if t in prev else
                        ops.columns_from_layout(xp, real, self._index,
                                                block_n=self.block_n,
                                                precision=t))
                    for t in self._tiers}
        self._pending_radius = _mean_tile_radius(cols[self.precision].meta)
        self._dirty.zero_()
        self._dirty_tiles = set()
        return StreamSnapshot(self.gen, self.layout_epoch, n, norm, x_sd, xp,
                              real, self._index, cols, n_tiles, total_tiles,
                              ids=self.ids)

    def _publish_layout(self):
        """Copies of the working layout for a snapshot: the device points
        and the occupied mask, which later updates must not reach."""
        return self._xp.clone(), spatial.upload(self._real, self.device)

    def _publish_rebuilt(self, x_sd: torch.Tensor, norm: float,
                         reason: str) -> StreamSnapshot:
        with obs.span("stream.rebuild", reason=reason, n_live=x_sd.shape[0]):
            self._rebuild_layout(x_sd)
        if reason != "initial":
            self.rebuilds += 1
            obs.counter("stream.rebuilds", "full layout re-clusters",
                        labels={"reason": reason}).inc()
            self.last_rebuild_reason = reason
        return self._publish_full(x_sd, norm)

    def _publish_full(self, x_sd: torch.Tensor,
                      norm: float) -> StreamSnapshot:
        """A snapshot whose every tier's columns are built anew from the
        working layout (after a rebuild, or for a carried-over state)."""
        xp, real = self._publish_layout()
        cols = {t: ops.columns_from_layout(
            xp, real, self._index, block_n=self.block_n, precision=t)
            for t in self._tiers}
        self._pending_radius = _mean_tile_radius(cols[self.precision].meta)
        total_tiles = self._xp.shape[0] // self.block_n
        return StreamSnapshot(self.gen, self.layout_epoch,
                              int(x_sd.shape[0]), norm, x_sd, xp, real,
                              self._index, cols, total_tiles, total_tiles,
                              ids=self.ids)

    def _rebuild_layout(self, x_sd: torch.Tensor) -> None:
        """Full re-cluster + re-scatter: the one non-incremental step.

        Shares the slab geometry helpers (``cluster_capacities`` /
        ``cluster_slots``) with the static ``spatial.cluster_layout``, so
        the cluster-alignment invariant has one owner.  Slabs are sized
        for EVERY centroid of the index, not just the labels the points
        happen to use: k-means can leave a trailing cluster empty, and a
        later append assigned to it still needs a slab to land in.
        """
        self._index = spatial.build_index(
            x_sd, seed=self.seed + self.layout_epoch)
        labels = self._read(self._index.labels, "rebuild").astype(np.int64)
        self._labels = labels
        k_full = (int(self._index.centroids.shape[0])
                  if self._index.centroids is not None
                  else int(labels.max()) + 1)
        self._starts, self._caps = spatial.cluster_capacities(
            labels, self.block_n, slack=self.config.slack, n_clusters=k_full)
        # slots only cover observed labels; their slab starts agree with
        # the full-k geometry because empty-cluster slabs append after
        slots = spatial.cluster_slots(
            labels, self.block_n, slack=self.config.slack).astype(np.int64)
        total = max(int(self._caps.sum()), self.block_n)
        xp = x_sd.new_full((total, self.d), PAD_VALUE)
        xp[spatial.upload(slots, self.device)] = x_sd
        real = np.zeros(total, bool)
        real[slots] = True
        self._slots, self._xp, self._real = slots, xp, real
        self.layout_epoch += 1
        self.policy.reset(x_sd.shape[0])
        self._dirty.zero_()
        self._dirty_tiles = set()


def _pow2_pad(idx: np.ndarray) -> np.ndarray:
    """Pad a tile-index list to the next power of two with repeats of its
    first entry — repeated writes carry equal values, and the bounded
    shape set keeps the index buffers few."""
    if idx.size == 0:
        return idx
    k = 1 << int(idx.size - 1).bit_length()
    return np.concatenate([idx, np.full(k - idx.size, idx[0], idx.dtype)])


def _mean_tile_radius(meta: Optional[spatial.TileMeta]
                      ) -> Optional[torch.Tensor]:
    """Mean covering radius of the non-empty tiles, as a device scalar
    (f32), read back at the next flush."""
    if meta is None:
        return None
    live = meta.counts > 0
    total = torch.where(live, meta.radii, meta.radii.new_zeros(())).sum()
    return (total / live.sum().clamp(min=1)).to(torch.float32)


__all__ = ["StreamSnapshot", "StreamingSDKDE"]
