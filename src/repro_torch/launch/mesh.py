"""Production mesh construction (``repro.launch.mesh``) over
``torch.distributed``'s ``DeviceMesh``.

A function, not a module constant, so importing this module touches no
process group.

Single pod:  (16, 16)      axes (data, model)          — 256 ranks
Multi-pod:   (2, 16, 16)   axes (pod, data, model)     — 512 ranks

Batch rows (and SD-KDE point rows) shard over (pod, data); tensor-parallel
weights over model.  The production shapes need a world of 256 or 512
ranks; the helpers below take any mesh.
"""

from __future__ import annotations

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh`` ("cuda" under NCCL, "cpu"
    otherwise); the initialized world must hold exactly its 256 (512)
    ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION[multi_pod]
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {shape} {axes} needs a world "
                         f"of {need} ranks, this one has {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def batch_axes(mesh) -> tuple:
    """The axes the global batch shards over."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def mesh_desc(mesh) -> str:
    names = mesh.mesh_dim_names
    return "x".join(str(mesh.size(i)) for i in range(len(names))) + (
        f" ({','.join(names)})")


__all__ = ["PRODUCTION", "make_production_mesh", "batch_axes", "mesh_desc"]
