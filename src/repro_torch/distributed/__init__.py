"""Distributed runtime of the port (``repro.distributed``): ring-sharded
SD-KDE over ``torch.distributed``, fault tolerance and elasticity.

``ring`` and ``ring2d`` shard the pairwise passes over a ``DeviceMesh``
(a ring of one without a world), each block one launch of B1, B2 or B5;
``world`` spawns local worlds of several ranks.  ``fault`` (heartbeats,
fencing epochs, restart plans, ``RestartLoop``), ``elastic`` (``MeshPlan``,
``plan_mesh``, ``make_mesh``, ``reshard_specs``, ``rebatch``),
``straggler`` and ``compression`` follow ``repro``'s modules; the
resilient serving layer (``serve/resilience.py``) runs on ``fault`` and
``plan_mesh``.  ``repro``'s ``compat`` shims JAX versions and has no
counterpart.
"""

from repro_torch.distributed import ring  # noqa: F401
from repro_torch.distributed.compression import (compress, compressed_psum,
                                                 decompress, init_residual)
from repro_torch.distributed.elastic import (MeshPlan, make_mesh, plan_mesh,
                                             rebatch, reshard_specs)
from repro_torch.distributed.fault import HostState, RestartLoop, Supervisor
from repro_torch.distributed.straggler import DuplicateDispatcher, pick_backup

__all__ = ["ring", "compress", "compressed_psum", "decompress",
           "init_residual", "MeshPlan", "make_mesh", "plan_mesh", "rebatch",
           "reshard_specs", "HostState", "RestartLoop", "Supervisor",
           "DuplicateDispatcher", "pick_backup"]
