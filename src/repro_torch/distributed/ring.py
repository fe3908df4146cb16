"""Ring-sharded SD-KDE over ``torch.distributed`` (``repro.distributed.ring``).

The Flash kernels stream column tiles through shared memory; the ring
applies the same idea one level up: point-set *shards* travel rank to
rank around a ring while each rank consumes the block it currently
holds.  Per-rank traffic is O(n·d / R) a step, linear in n, and the
rotation of the next block is posted (``dist.batch_isend_irecv``) before
the current block is consumed and waited on after, so the transfer
overlaps the block's kernels, as XLA's scheduler overlaps ``ppermute``.

A two-level ring runs an inner ring over ``data_axis`` and an outer
rotation over ``pod_axis``: the pod transfer of a full inner ring's home
block is posted when that ring starts and waited on when it ends, so
each cross-pod transfer has a whole inner ring of compute to hide behind.

Each block's pairwise work is one kernel launch (``kernels/ops.py``):
the score pass is B1 in its rectangular form (resident rows against a
visiting block), the KDE pass B2 and the Laplace pass B5; their plain
versions run when the shards lie on the CPU.  The ring is f32 and dense,
as ``repro``'s is.  Blocks are folded in ring-step order and each
kernel adds its splits in order, so a run is deterministic.

Shapes: every function takes and returns this rank's local shard (rows
``[k·L, (k+1)·L)`` for the rank at flat index k over the ring axes, pod
major); ``shard_points`` cuts one and ``gather_rows`` puts the whole
array back together in rank order.

Transport follows ``dist.get_backend(group)``: under NCCL device tensors
move directly; under gloo, whose point-to-point takes CPU tensors, a
block on the card is staged through host memory.  Without an initialized
``torch.distributed`` world the mesh is a ring of one (``SoloMesh``), as
``repro``'s one-device mesh, and no transfer happens.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.bandwidth import gaussian_norm_const
from repro_torch.core.kde import pad_rows
from repro_torch.distributed.world import stages_through_host
from repro_torch.kernels import ops


class SoloMesh:
    """A ring of one: the mesh of a process outside any ``torch.distributed``
    world.  It offers the parts of ``DeviceMesh`` the ring reads."""

    def __init__(self, axes: Sequence[str] = ("data",)):
        self.mesh_dim_names = tuple(axes)
        self.device_type = "cpu"
        self.mesh = torch.zeros((1,) * len(self.mesh_dim_names),
                                dtype=torch.int64)

    @property
    def ndim(self) -> int:
        return len(self.mesh_dim_names)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (1,) * self.ndim

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def get_coordinate(self) -> List[int]:
        return [0] * self.ndim

    def get_group(self, mesh_dim=None):
        raise RuntimeError("a ring of one has no process group")


_LOCK = threading.Lock()
_MESHES: Dict[tuple, object] = {}
_GROUPS: Dict[tuple, tuple] = {}


def default_mesh(data_axis: str = "data"):
    """A one-axis ``DeviceMesh`` over the initialized world, or a ring of
    one (``SoloMesh``) when ``torch.distributed`` is not initialized.

    The estimators' and the serving engine's ``ring`` backend use it when
    no mesh is passed.  The mesh's device type follows the backend
    ("cuda" under NCCL, "cpu" under gloo); the shards live wherever the
    caller put them.  Built once per world and axis name."""
    if not (dist.is_available() and dist.is_initialized()):
        return SoloMesh((data_axis,))
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.group.WORLD
    key = (id(world), dist.get_world_size(), data_axis)
    with _LOCK:
        hit = _MESHES.get(key)
    if hit is not None and hit[0] is world:
        return hit[1]
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(kind, (dist.get_world_size(),),
                            mesh_dim_names=(data_axis,))
    with _LOCK:
        _MESHES[key] = (world, mesh)
    return mesh


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def ring_size(mesh, axes: Sequence[str]) -> int:
    """The number of shards over ``axes`` (their sizes multiplied)."""
    return math.prod(axis_size(mesh, a) for a in axes)


def axes_index(mesh, axes: Sequence[str]) -> int:
    """This rank's flat index over ``axes`` (the first axis major): the
    shard it holds."""
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + int(mesh.get_local_rank(a))
    return idx


def _members(mesh, axes: Sequence[str], coord) -> List[int]:
    """Global ranks of the sub-mesh over ``axes`` through ``coord`` (the
    other dims fixed there), in flat order over ``axes``."""
    names = list(mesh.mesh_dim_names)
    sub = mesh.mesh[tuple(slice(None) if n in axes else coord[k]
                          for k, n in enumerate(names))]
    kept = [n for n in names if n in axes]
    return sub.permute([kept.index(a) for a in axes]).reshape(-1).tolist()


def axes_group(mesh, axes: Sequence[str]):
    """(group, members): the process group over ``axes`` that holds this
    rank, and its members' global ranks in flat order over ``axes``.

    One axis is the mesh's own group; several are built with
    ``dist.new_group``, one group for each position of the other axes,
    created in the same order on every rank (a collective call), once a
    mesh."""
    axes = tuple(axes)
    members = _members(mesh, axes, mesh.get_coordinate())
    if len(axes) == 1:
        return mesh.get_group(axes[0]), members
    key = (id(mesh), axes)
    with _LOCK:
        hit = _GROUPS.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1], members
    names = list(mesh.mesh_dim_names)
    others = [k for k, n in enumerate(names) if n not in axes]
    mine = None
    for pos in torch.cartesian_prod(
            *[torch.arange(mesh.mesh.shape[k]) for k in others]
            ).reshape(-1, len(others)).tolist() if others else [[]]:
        coord = [0] * len(names)
        for k, p in zip(others, pos):
            coord[k] = p
        ranks = _members(mesh, axes, coord)
        group = dist.new_group(sorted(ranks))
        if dist.get_rank() in ranks:
            mine = group
    with _LOCK:
        _GROUPS[key] = (mesh, mine)
    return mine, members


#: Ring steps posted (one send and one receive each); set to 0 to start a
#: count.
rotations = 0


class _Rotation:
    """One posted ring step: the send of a block to the next member and
    the receive of the previous member's."""

    def __init__(self, block: torch.Tensor, group, members: List[int]):
        global rotations
        rotations += 1
        me = members.index(dist.get_rank())
        size = len(members)
        self.device = block.device
        host = stages_through_host(group, block.device)
        self._send = block.cpu() if host else block.contiguous()
        self._recv = torch.empty_like(self._send)
        self._works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, self._send, members[(me + 1) % size],
                       group),
            dist.P2POp(dist.irecv, self._recv, members[(me - 1) % size],
                       group)])

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return self._recv.to(self.device)


def _ring_scan(cols0: torch.Tensor, acc, consume: Callable, mesh,
               data_axis: str, pod_axis: Optional[str]):
    """Hierarchical ring fold: acc = consume(acc, block) over every block,
    in ring-step order.  ``cols0`` is this rank's resident block."""
    n_data = axis_size(mesh, data_axis)
    n_pod = axis_size(mesh, pod_axis) if pod_axis else 1
    g_data = axes_group(mesh, (data_axis,)) if n_data > 1 else None
    g_pod = axes_group(mesh, (pod_axis,)) if n_pod > 1 else None
    cols = cols0
    for p in range(n_pod):
        # the pod rotation of this inner ring's home block hides behind
        # the whole inner ring
        outer = _Rotation(cols, *g_pod) if p + 1 < n_pod else None
        for i in range(n_data):
            inner = _Rotation(cols, *g_data) if i + 1 < n_data else None
            acc = consume(acc, cols)
            if inner is not None:
                cols = inner.wait()
        if outer is not None:
            cols = outer.wait()
    return acc


def _ring_axes(data_axis: str, pod_axis: Optional[str]) -> Tuple[str, ...]:
    return (pod_axis, data_axis) if pod_axis else (data_axis,)


def _f32(h, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(h, dtype=torch.float32).to(device)


# ---------------------------------------------------------------------------
# Ring score statistics (train × train).
# ---------------------------------------------------------------------------


def ring_score_stats(x: torch.Tensor, h, *, mesh=None,
                     data_axis: str = "data",
                     pod_axis: Optional[str] = None):
    """(S0, S1) of this rank's rows ``x`` (its local shard) against every
    shard of the ring: one rectangular B1 launch a ring step.

    Shards must be equal in size on every rank (``shard_points`` pads
    with sentinels, whose rows contribute exactly 0 as columns)."""
    mesh = default_mesh(data_axis) if mesh is None else mesh
    rows = ops.ring_rows(x)
    inv = ops._inv2h2(h, x.device)
    d = x.shape[1]

    def consume(acc, cols):
        return acc + ops.score_block(rows, cols, inv)

    acc = torch.zeros((x.shape[0], d + 1), dtype=torch.float32,
                      device=x.device)
    acc = _ring_scan(ops.pad_block(x), acc, consume, mesh, data_axis,
                     pod_axis)
    return acc[:, d], acc[:, :d]


def score_shift(x: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor, h, sh,
                eps: float = 1e-30) -> torch.Tensor:
    """x + (h²/2)·(S1 − x·S0) / (sh²·S0 + eps), in f32: ``repro``'s ring
    shift, whose ``eps`` keeps a row with S0 = 0 (a sentinel) finite."""
    x32 = x.to(torch.float32)
    sh = _f32(sh, x.device)
    h = _f32(h, x.device)
    score = (s1 - x32 * s0[:, None]) / (sh * sh * s0[:, None] + eps)
    return x32 + 0.5 * h * h * score


def ring_sdkde_shift(x: torch.Tensor, h, *, score_h=None, mesh=None,
                     data_axis: str = "data",
                     pod_axis: Optional[str] = None,
                     eps: float = 1e-30) -> torch.Tensor:
    """Debiased samples of this rank's shard; rows stay sharded."""
    mesh = default_mesh(data_axis) if mesh is None else mesh
    sh = h if score_h is None else score_h
    s0, s1 = ring_score_stats(x, sh, mesh=mesh, data_axis=data_axis,
                              pod_axis=pod_axis)
    return score_shift(x, s0, s1, h, sh, eps)


# ---------------------------------------------------------------------------
# Ring KDE / Laplace evaluation (train × query).
# ---------------------------------------------------------------------------


def _ring_eval(x: torch.Tensor, y: torch.Tensor, h, *, laplace: bool,
               n_true: Optional[int], mesh, data_axis: str,
               pod_axis: Optional[str]) -> torch.Tensor:
    mesh = default_mesh(data_axis) if mesh is None else mesh
    if n_true is None:
        n_true = x.shape[0] * ring_size(mesh, _ring_axes(data_axis,
                                                          pod_axis))
    rows = ops.ring_rows(y)
    inv = ops._inv2h2(h, y.device)

    def consume(acc, cols):
        return acc + ops.kde_block(rows, cols, inv, laplace=laplace)

    acc = torch.zeros(y.shape[0], dtype=torch.float32, device=y.device)
    sums = _ring_scan(ops.pad_block(x.to(y.device)), acc, consume, mesh,
                      data_axis, pod_axis)
    d = x.shape[1]
    return sums / (n_true * gaussian_norm_const(d, 1.0)
                   * _f32(h, y.device) ** d)


def ring_kde(x: torch.Tensor, y: torch.Tensor, h, *,
             n_true: Optional[int] = None, mesh=None,
             data_axis: str = "data",
             pod_axis: Optional[str] = None) -> torch.Tensor:
    """Gaussian KDE at this rank's queries ``y``; the train shards ``x``
    rotate around the ring (one B2 launch a step).  ``n_true`` is the
    real train count (default: the shards' total, padding included)."""
    return _ring_eval(x, y, h, laplace=False, n_true=n_true, mesh=mesh,
                      data_axis=data_axis, pod_axis=pod_axis)


def ring_laplace_kde(x: torch.Tensor, y: torch.Tensor, h, *,
                     n_true: Optional[int] = None, mesh=None,
                     data_axis: str = "data",
                     pod_axis: Optional[str] = None) -> torch.Tensor:
    """Fused Laplace-corrected KDE on the ring (one B5 launch a step)."""
    return _ring_eval(x, y, h, laplace=True, n_true=n_true, mesh=mesh,
                      data_axis=data_axis, pod_axis=pod_axis)


def ring_sdkde(x: torch.Tensor, y: torch.Tensor, h, *, score_h=None,
               n_true: Optional[int] = None, mesh=None,
               data_axis: str = "data",
               pod_axis: Optional[str] = None) -> torch.Tensor:
    """Full distributed SD-KDE on local shards: ring score pass → local
    shift → ring KDE."""
    x_sd = ring_sdkde_shift(x, h, score_h=score_h, mesh=mesh,
                            data_axis=data_axis, pod_axis=pod_axis)
    return ring_kde(x_sd, y, h, n_true=n_true, mesh=mesh,
                    data_axis=data_axis, pod_axis=pod_axis)


# ---------------------------------------------------------------------------
# Host-level helpers.
# ---------------------------------------------------------------------------


def shard_points(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """This rank's shard of the whole array ``x``: rows padded with
    sentinels to a multiple of the ring size, then cut into equal shards
    in flat order over ``axes``."""
    r = ring_size(mesh, axes)
    xp = pad_rows(x, r)
    k = xp.shape[0] // r
    i = axes_index(mesh, axes)
    return xp[i * k:(i + 1) * k]


def gather_parts(t: torch.Tensor, mesh,
                 axes: Sequence[str]) -> List[torch.Tensor]:
    """Every rank's ``t`` over ``axes``, in flat rank order, on ``t``'s
    device: one ``all_gather`` (staged through host memory under gloo for
    a tensor on the card)."""
    if ring_size(mesh, axes) == 1:
        return [t]
    group, members = axes_group(mesh, axes)
    host = stages_through_host(group, t.device)
    src = t.cpu() if host else t.contiguous()
    parts = [torch.empty_like(src) for _ in members]
    dist.all_gather(parts, src, group=group)
    return [parts[dist.get_group_rank(group, g)].to(t.device)
            for g in members]


def gather_rows(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The whole array from every rank's shard over ``axes``, rows in flat
    rank order."""
    return torch.cat(gather_parts(t, mesh, axes))


__all__ = ["SoloMesh", "default_mesh", "axis_size", "ring_size",
           "axes_index", "axes_group", "rotations", "ring_score_stats",
           "score_shift", "ring_sdkde_shift", "ring_kde", "ring_laplace_kde",
           "ring_sdkde", "shard_points", "gather_parts", "gather_rows"]
