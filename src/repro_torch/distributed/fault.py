"""Fault-tolerance supervisor: heartbeats, failure detection, fencing,
restart decisions (``repro.distributed.fault``, pure Python).

A coordinator-side ``Supervisor`` tracks per-host heartbeats, declares a
host dead after ``timeout`` seconds without one, and drives the restart
decision:

  * dead host AND spare capacity   -> restart same-size ("replace")
  * dead host AND no spares        -> shrink (``elastic.plan_mesh``)
  * slow heartbeat                 -> a straggler, not a failure

With ``restart_plan(fence=True)`` the dead hosts are fenced in the same
step: their epoch bumps, and a zombie's late beat (no epoch, or a stale
one) is rejected.  The resilient serving layer (``serve/resilience.py``)
runs one host per (shard, replica) on this.  ``RestartLoop`` is the
single-host restart-from-checkpoint loop; it retries
``fault_injection.InjectedFailure`` only, so a real bug propagates.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional

from repro_torch.fault_injection import InjectedFailure


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float
    step: int = 0
    alive: bool = True
    # Fencing: once a restart decision committed a host as dead, late
    # heartbeats from its zombie process must not revive it.  ``epoch``
    # bumps on every fence; only a beat carrying the current epoch (i.e.
    # from a process that was re-admitted by the coordinator, not the
    # fenced zombie) is accepted again.
    fenced: bool = False
    epoch: int = 0


class Supervisor:
    """Heartbeat registry + failure/straggler classification."""

    def __init__(
        self,
        n_hosts: int,
        *,
        timeout: float = 60.0,
        straggler_factor: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.timeout = timeout
        self.straggler_factor = straggler_factor
        self.clock = clock
        now = clock()
        self.hosts: Dict[int, HostState] = {
            i: HostState(i, now) for i in range(n_hosts)
        }
        # EWMA of per-step wall time per host — straggler detection signal.
        self._step_time: Dict[int, float] = {}
        self._last_step_at: Dict[int, float] = {}
        #: Beats rejected by fencing — zombie liveness signal for telemetry.
        self.rejected_beats = 0

    # -- heartbeat ingestion ----------------------------------------------

    def beat(self, host_id: int, step: int,
             epoch: Optional[int] = None) -> bool:
        """Ingest a heartbeat; returns False if it was rejected.

        A fenced host's beats are rejected unless they carry the host's
        current fencing epoch — a zombie process that survived the
        restart decision keeps beating with no (or a stale) epoch and can
        no longer flip itself back to alive.
        """
        now = self.clock()
        h = self.hosts[host_id]
        if h.fenced:
            if epoch != h.epoch:
                self.rejected_beats += 1
                return False
            h.fenced = False   # re-admitted under the new epoch
        if step > h.step:
            prev = self._last_step_at.get(host_id)
            if prev is not None:
                dt = (now - prev) / max(step - h.step, 1)
                ewma = self._step_time.get(host_id, dt)
                self._step_time[host_id] = 0.8 * ewma + 0.2 * dt
            self._last_step_at[host_id] = now
        h.last_beat, h.step, h.alive = now, step, True
        return True

    # -- fencing ------------------------------------------------------------

    def fence(self, host_ids: Iterable[int]) -> None:
        """Commit hosts as dead: bump their epoch and reject stale beats."""
        for hid in host_ids:
            h = self.hosts[hid]
            if not h.fenced:
                h.fenced = True
                h.alive = False
                h.epoch += 1

    def fenced(self) -> List[int]:
        return sorted(h.host_id for h in self.hosts.values() if h.fenced)

    def readmit(self, host_id: int) -> int:
        """Coordinator-side re-admission of a fenced host (e.g. after a
        successful health probe); returns the epoch its beats must carry."""
        h = self.hosts[host_id]
        h.fenced = False
        h.alive = True
        h.last_beat = self.clock()
        return h.epoch

    # -- classification -----------------------------------------------------

    def dead_hosts(self) -> List[int]:
        now = self.clock()
        dead = []
        for h in self.hosts.values():
            if now - h.last_beat > self.timeout:
                h.alive = False
                dead.append(h.host_id)
        return dead

    def stragglers(self) -> List[int]:
        """Hosts whose EWMA step time exceeds factor × fleet median."""
        times = sorted(self._step_time.values())
        if len(times) < 2:
            return []
        median = times[len(times) // 2]
        return [
            hid for hid, t in self._step_time.items()
            if t > self.straggler_factor * median and self.hosts[hid].alive
        ]

    def fleet_step(self) -> int:
        """The globally-committed step = min over live hosts."""
        live = [h.step for h in self.hosts.values() if h.alive]
        return min(live) if live else 0

    # -- restart decision ----------------------------------------------------

    def restart_plan(self, spare_hosts: int = 0, *,
                     fence: bool = False) -> Optional[dict]:
        """None if healthy; else a restart decision dict.

        With ``fence=True`` the decision is also *committed*: the dead
        hosts are fenced atomically with the plan, so a zombie's late
        beat cannot revive a host the plan already removed.
        """
        dead = self.dead_hosts()
        if not dead:
            return None
        if fence:
            self.fence(dead)
        live = len(self.hosts) - len(dead)
        if len(dead) <= spare_hosts:
            return {
                "action": "replace",
                "dead": dead,
                "new_size": len(self.hosts),
            }
        return {"action": "shrink", "dead": dead, "new_size": live}


@dataclasses.dataclass
class RestartLoop:
    """Single-host skeleton of the restart-from-checkpoint loop: run
    ``step_fn`` until done, checkpointing every ``ckpt_every``; on an
    injected failure, restore and continue.
    """

    step_fn: Callable[[int], None]          # executes step i
    save_fn: Callable[[int], None]          # checkpoint at step i
    restore_fn: Callable[[], int]           # -> step to resume from
    ckpt_every: int = 50

    def run(self, total_steps: int, *, fail_at: Optional[int] = None) -> int:
        """Returns the number of (re)starts it took."""
        starts = 0
        done = 0
        while done < total_steps:
            starts += 1
            start = self.restore_fn()
            try:
                for i in range(start, total_steps):
                    if fail_at is not None and i == fail_at and starts == 1:
                        raise InjectedFailure("node_failure",
                                              point="restart_loop")
                    self.step_fn(i)
                    done = i + 1
                    if (i + 1) % self.ckpt_every == 0:
                        self.save_fn(i + 1)
            except InjectedFailure:
                continue   # supervisor restarts us; restore_fn resumes
            # any other exception — a real bug in step_fn — propagates:
            # absorbing it here would turn regressions into silent retries
        return starts


__all__ = ["HostState", "Supervisor", "RestartLoop"]
