"""Elastic resizing, the arithmetic half (``repro.distributed.elastic``).

When a fleet loses (or gains) hosts, the job restarts on a different
device count: ``plan_mesh`` picks the largest (pod, data, model) grid that
fits the survivors, and ``rebatch`` keeps the global batch (growing the
accumulation count) when the data-parallel degree changes.  The resilient
serving layer re-plans its routing table with ``plan_mesh`` after a
replica is fenced (data = replicas, model = shards).

``repro``'s ``make_mesh`` and ``reshard_specs`` build a JAX ``Mesh`` and
``NamedSharding``s; their counterparts over ``torch.distributed``'s
``DeviceMesh`` wait for ROADMAP A13.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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


__all__ = ["MeshPlan", "plan_mesh", "rebatch"]
