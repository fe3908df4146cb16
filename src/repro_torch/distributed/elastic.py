"""Elastic resizing (``repro.distributed.elastic``).

When a fleet loses (or gains) hosts, the job restarts on a different
device count: ``plan_mesh`` picks the largest (pod, data, model) grid that
fits the survivors, ``make_mesh`` builds it as a ``torch.distributed``
``DeviceMesh`` over the first ranks of the world, ``reshard_specs`` maps
each logical sharding onto the new mesh, and ``rebatch`` keeps the global
batch (growing the accumulation count) when the data-parallel degree
changes.  The resilient serving layer re-plans its routing table with
``plan_mesh`` after a replica is fenced (data = replicas, model =
shards).

A logical sharding is ``repro``'s ``PartitionSpec`` written as a tuple:
one entry per tensor dimension, ``None`` (replicated), an axis name, or a
tuple of axis names (sharded over their product, the first major).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    note: str = ""

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_mesh(
    n_devices: int,
    *,
    model_parallel: int = 16,
    want_pods: Optional[int] = None,
) -> MeshPlan:
    """Largest (pod, data, model) mesh that fits ``n_devices``.

    Keeps the model axis fixed (halving it until it divides) and gives the
    rest to data; a pod axis is split out when the count divides.  Drops
    devices that don't fit the grid (reported in ``note``): the shrink
    path after failures.
    """
    mp = model_parallel
    while mp > 1 and n_devices % mp != 0:
        mp //= 2
    rest = n_devices // mp
    if want_pods and rest % want_pods == 0 and want_pods > 1:
        plan = MeshPlan((want_pods, rest // want_pods, mp),
                        ("pod", "data", "model"))
    else:
        plan = MeshPlan((rest, mp), ("data", "model"))
    used = plan.n_devices
    note = "" if used == n_devices else f"dropping {n_devices - used} devices"
    return dataclasses.replace(plan, note=note)


def make_mesh(plan: MeshPlan):
    """A ``DeviceMesh`` of ``plan.shape`` over ranks 0 .. n_devices − 1 of
    the initialized world (every rank calls it; ranks past the grid are
    the dropped ones and hold no coordinate), of device type "cuda" under
    NCCL and "cpu" otherwise.  Outside a world a plan of one device is a
    mesh of one (``ring.SoloMesh``), as ``repro``'s one-device mesh."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import ring

    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() and plan.n_devices == 1:
        return ring.SoloMesh(plan.axes)
    if plan.n_devices > world:
        raise ValueError(f"plan {plan.shape} needs {plan.n_devices} ranks, "
                         f"the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.arange(plan.n_devices).reshape(plan.shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(plan.axes))


def reshard_specs(pspecs: Dict[str, Sequence], old_mesh_axes: Tuple[str, ...],
                  new_mesh) -> Dict[str, tuple]:
    """Map logical shardings onto a (possibly smaller) new mesh.

    Axes that disappeared from the mesh (``pod`` after a shrink to one
    pod) are dropped from every spec, and those dims become replicated.
    Returns, per name, the DTensor placements over ``new_mesh``'s dims
    (``Shard(dim)`` where a tensor dimension names the mesh axis,
    ``Replicate()`` elsewhere), ready for ``distribute_tensor(t,
    new_mesh, placements)``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(new_mesh.mesh_dim_names)
    live = set(names)

    def fix_entry(e):
        if e is None:
            return None
        if isinstance(e, tuple):
            kept = tuple(a for a in e if a in live)
            return kept if kept else None
        return e if e in live else None

    out = {}
    for name, spec in pspecs.items():
        fixed = [fix_entry(e) for e in spec]
        placements = [Replicate()] * len(names)
        for dim, e in enumerate(fixed):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    placements[names.index(a)] = Shard(dim)
        out[name] = tuple(placements)
    return out


def rebatch(global_batch: int, old_dp: int, new_dp: int,
            microbatches: int) -> Tuple[int, int, int]:
    """(per_device_batch, microbatches, new_global) after a dp resize.

    Keeps the global batch exactly where it can (growing the accumulation
    count until the new dp degree divides); when no exact tiling exists
    (256 over 15 hosts), the global batch moves to the nearest achievable
    multiple.
    """
    for mb in range(microbatches, global_batch + 1):
        if global_batch % (new_dp * mb) == 0:
            return global_batch // (new_dp * mb), mb, global_batch
    mb = microbatches
    per_dev = max(1, round(global_batch / (new_dp * mb)))
    return per_dev, mb, per_dev * new_dp * mb


__all__ = ["MeshPlan", "plan_mesh", "make_mesh", "reshard_specs",
           "rebatch"]
