"""Straggler mitigation: deadline-based duplicate dispatch
(``repro.distributed.straggler``, pure Python, the same policy).

Policy (data-parallel): the fleet advances in lockstep, so one slow host
gates every step.  When the Supervisor's EWMA flags a straggler, its NEXT
microbatch is duplicately dispatched to the fastest healthy host; whichever
copy lands first wins, the loser is cancelled.  Because synthetic batches
are pure functions of (seed, step) (data/synthetic.py), the duplicate is
bit-identical — re-dispatch never perturbs the training stream.

``DuplicateDispatcher`` is runtime-agnostic (callables in, result out) so it
is unit-testable on one host.
"""

from __future__ import annotations

from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Optional, Tuple


class DuplicateDispatcher:
    """Run ``work(host)`` with an optional racing duplicate on a backup."""

    def __init__(self, *, deadline: float):
        self.deadline = deadline
        self._pool = ThreadPoolExecutor(max_workers=4)

    def run(
        self,
        work: Callable[[int], object],
        primary: int,
        backup: Optional[int] = None,
    ) -> Tuple[object, int]:
        """Returns (result, winning_host).

        Dispatches to ``primary``; if it misses ``deadline`` and a backup is
        given, races a duplicate and takes the first completion.
        """
        f_primary = self._pool.submit(work, primary)
        done, _ = wait([f_primary], timeout=self.deadline)
        if f_primary in done:
            return f_primary.result(), primary
        if backup is None:
            return f_primary.result(), primary  # no spare: block it out
        f_backup = self._pool.submit(work, backup)
        done, _ = wait([f_primary, f_backup], return_when=FIRST_COMPLETED)
        winner = f_primary if f_primary in done else f_backup
        host = primary if winner is f_primary else backup
        return winner.result(), host

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)


def pick_backup(step_times: dict, straggler: int) -> Optional[int]:
    """Fastest healthy host ≠ straggler (lowest EWMA step time)."""
    candidates = [(t, h) for h, t in step_times.items() if h != straggler]
    return min(candidates)[1] if candidates else None


__all__ = ["DuplicateDispatcher", "pick_backup"]
