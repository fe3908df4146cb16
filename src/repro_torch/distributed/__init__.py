"""Distributed runtime of the port: the fault-tolerance supervisor and the
arithmetic of elastic resizing.

The counterpart of ``repro.distributed``, in part.  ``fault`` (heartbeats,
fencing epochs, restart plans, ``RestartLoop``) and ``elastic``'s
``MeshPlan`` / ``plan_mesh`` / ``rebatch`` are host-side Python; the
resilient serving layer (``serve/resilience.py``) runs on them.  The
sharded rings (``ring``, ``ring2d``), ``elastic.make_mesh`` /
``reshard_specs``, ``straggler`` and ``compression`` wait for ROADMAP
A13.
"""

from repro_torch.distributed.elastic import MeshPlan, plan_mesh, rebatch
from repro_torch.distributed.fault import HostState, RestartLoop, Supervisor

__all__ = ["MeshPlan", "plan_mesh", "rebatch", "HostState", "RestartLoop",
           "Supervisor"]
