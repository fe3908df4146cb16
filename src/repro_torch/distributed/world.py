"""Local ``torch.distributed`` worlds: several ranks on one host.

``spawn(fn, world, *args, timeout=...)`` starts ``world`` processes (the
"spawn" start method) that each call ``fn(rank, world, init_file,
*args)``; ``init(rank, world, init_file)`` joins them into one process
group through a ``file://`` store, gloo by default.  The CPU tests run
their rings this way, and so does ``chip_smoke.py`` with four gloo ranks
on one card (NCCL refuses two ranks on one GPU).  Every join has a time
limit: past it the ranks are killed and ``TimeoutError`` is raised, so a
hung ring cannot hang its caller.  ``stages_through_host`` says how a
tensor travels in a group: directly under NCCL, through host memory under
gloo.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable

import torch.distributed as dist
import torch.multiprocessing as mp


def init(rank: int, world: int, init_file: str,
         backend: str = "gloo") -> None:
    """Join this process to the world as ``rank`` of ``world``."""
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)


def stages_through_host(group, device) -> bool:
    """Whether a tensor on ``device`` moves through host memory in a
    collective or point-to-point op of ``group``: under any backend but
    NCCL (gloo's point-to-point and gathers take CPU tensors), for a
    tensor that is not already there.  Chosen from the group's backend,
    never by catching an error."""
    return device.type != "cpu" and dist.get_backend(group) != "nccl"


def spawn(fn: Callable, world: int, *args, timeout: float = 120.0) -> None:
    """Run ``fn(rank, world, init_file, *args)`` in ``world`` processes and
    wait for all of them, at most ``timeout`` seconds.  ``fn`` must be
    importable by name (a module-level function).  A rank's exception is
    raised here; past the time limit the ranks are killed and
    ``TimeoutError`` is raised."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(fn, args=(world, store) + args,
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0,
                                           deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world} ranks of {getattr(fn, '__name__', fn)} "
                        f"did not finish within {timeout:g} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


__all__ = ["init", "stages_through_host", "spawn"]
