"""Seeded, deterministic chaos harness (``repro.fault_injection``).

A frozen :class:`ChaosConfig` describes *which* failure modes fire and
*how often*, a :class:`FaultInjector` turns that description into
concrete injected failures at well-known **injection points** hooked into
the serving stack, and everything is deterministic under the config seed
so a failing chaos run replays exactly.  Host code only (numpy), copied
from the JAX package so the port imports nothing of it.

Failure modes and where they strike:

  ===================  =========================  ==========================
  mode                 what it simulates          injection point (hook site)
  ===================  =========================  ==========================
  ``shard_kill``       dead shard replica: every  ``serve.dispatch``
                       dispatch raises            (serve/engine.py)
  ``slow_shard``       degraded device: dispatch  ``serve.dispatch``
                       sleeps ``slow_ms``
  ``compile_fail``     broken bucket callable:    ``serve.compile``
                       the build raises           (serve/engine.py),
                                                  ``registry.fit``
  ``nan_poison``       numerically-poisoned       ``serve.result``
                       result: densities → NaN    (serve/engine.py)
  ``staleness_blowout``  slow snapshot rebuild:   ``stream.flush``
                       the flush sleeps, queries  (stream/estimator.py)
                       pile up behind staleness
  ``client_burst``     traffic surge: the admit   ``serve.admit``
                       hook reports a burst of    (serve/frontend.py)
                       ``burst_factor`` synthetic
                       admissions (``burst()``)
  ``admit_stall``      stalled admission thread:  ``serve.admit``
                       the admit path sleeps
                       ``slow_ms``, arrivals
                       back up behind it
  ===================  =========================  ==========================

The resilient layer (``serve/resilience.py``) installs its injector and
enters ``scope(shard, replica)`` inside the worker thread that runs each
dispatch (the scope is thread-local, so a hedged duplicate is attributed
to the replica it targets); the admission front end
(``serve/frontend.py``) calls ``fire`` and ``burst`` at ``serve.admit``.

Each mode is a probability in [0, 1] drawn per *injection opportunity*
(deterministically: the k-th draw for a given (mode, point, shard,
replica) is a pure function of the seed, never of wall clock or thread
scheduling), plus an optional list of :class:`ChaosEvent` windows for
sustained, scheduled faults ("kill shard 0 replica 1 for requests
20..60").

The hooks are module-level (``fire`` / ``poison`` / ``burst``) and cost
one global read + branch when no injector is installed, so production
paths carry them for free.  ``InjectedFailure`` is the one exception
type every injected fault raises; the fault-tolerant layers (the
resilient engine, the front end's requeue, ``distributed.fault``'s
``RestartLoop``) catch exactly it and re-raise everything else — a real
bug must never be absorbed as chaos.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

MODES = ("shard_kill", "slow_shard", "compile_fail", "nan_poison",
         "staleness_blowout", "client_burst", "admit_stall")

#: Which failure modes each injection point consults.
POINT_MODES: Dict[str, Tuple[str, ...]] = {
    "serve.dispatch": ("shard_kill", "slow_shard"),
    "serve.compile": ("compile_fail",),
    "serve.result": ("nan_poison",),
    "registry.fit": ("compile_fail",),
    "stream.flush": ("staleness_blowout",),
    "serve.admit": ("client_burst", "admit_stall"),
}

_MODE_ID = {m: i for i, m in enumerate(MODES)}
_POINT_ID = {p: i for i, p in enumerate(POINT_MODES)}


class InjectedFailure(RuntimeError):
    """A deliberately injected fault — and ONLY that.

    Resilient layers catch this type exactly (retry, reroute, restart) and
    let every other exception propagate: absorbing a real bug as chaos is
    the classic way fault-injection harnesses hide regressions.
    """

    def __init__(self, kind: str, *, shard=None, replica=None, point=None):
        super().__init__(
            f"injected {kind} (point={point} shard={shard} replica={replica})"
        )
        self.kind = kind
        self.shard = shard
        self.replica = replica
        self.point = point


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """A sustained, scheduled fault window.

    Active while ``start <= request_index < stop`` for dispatches hitting
    the targeted ``(shard, replica)`` (-1 = every shard / every replica).
    """

    kind: str
    shard: int = -1
    replica: int = -1
    start: int = 0
    stop: int = 1 << 30

    def __post_init__(self):
        if self.kind not in MODES:
            raise ValueError(f"unknown chaos kind {self.kind!r} "
                             f"(choose from {MODES})")
        if self.stop < self.start:
            raise ValueError(f"empty chaos window [{self.start}, {self.stop})")

    def hits(self, request: int, shard, replica) -> bool:
        if not (self.start <= request < self.stop):
            return False
        if self.shard != -1 and shard != self.shard:
            return False
        if self.replica != -1 and replica != self.replica:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """What to break, how often, and on which schedule.

    Mode fields are per-opportunity probabilities; ``events`` adds
    deterministic sustained windows on top.  ``slow_ms`` is the injected
    delay of ``slow_shard`` / ``staleness_blowout`` faults.
    """

    seed: int = 0
    shard_kill: float = 0.0
    slow_shard: float = 0.0
    compile_fail: float = 0.0
    nan_poison: float = 0.0
    staleness_blowout: float = 0.0
    client_burst: float = 0.0
    admit_stall: float = 0.0
    slow_ms: float = 50.0
    #: Synthetic admissions injected per fired ``client_burst`` opportunity.
    burst_factor: int = 4
    events: Tuple[ChaosEvent, ...] = ()

    def __post_init__(self):
        for m in MODES:
            p = getattr(self, m)
            if not (0.0 <= p <= 1.0):
                raise ValueError(f"chaos probability {m}={p} outside [0, 1]")
        if self.slow_ms < 0:
            raise ValueError(f"slow_ms must be >= 0, got {self.slow_ms}")
        if self.burst_factor < 1:
            raise ValueError(
                f"burst_factor must be >= 1, got {self.burst_factor}")
        object.__setattr__(self, "events", tuple(self.events))

    @classmethod
    def from_modes(cls, modes: Union[str, Sequence[str]], *,
                   requests: int = 0, seed: int = 0,
                   slow_ms: float = 40.0) -> "ChaosConfig":
        """CLI shorthand: comma-separated mode names with stock rates.

        ``shard_kill`` additionally schedules one sustained kill of shard
        0 / replica 0 across the middle third of ``requests`` — the soak's
        kill + recovery arc — when a request count is known.
        """
        if isinstance(modes, str):
            modes = [m.strip() for m in modes.split(",") if m.strip()]
        rates = {"shard_kill": 0.1, "slow_shard": 0.2, "compile_fail": 0.3,
                 "nan_poison": 0.1, "staleness_blowout": 0.5,
                 "client_burst": 0.15, "admit_stall": 0.1}
        kw: dict = {"seed": seed, "slow_ms": slow_ms}
        events = []
        for m in modes:
            if m not in MODES:
                raise ValueError(f"unknown chaos mode {m!r} "
                                 f"(choose from {MODES})")
            kw[m] = rates[m]
            if m == "shard_kill" and requests >= 6:
                events.append(ChaosEvent("shard_kill", shard=0, replica=0,
                                         start=requests // 3,
                                         stop=2 * requests // 3))
        return cls(events=tuple(events), **kw)


class _Scope(threading.local):
    shard: Optional[int] = None
    replica: Optional[int] = None


class FaultInjector:
    """Deterministic fault source for one chaos run.

    The k-th probability draw for a (mode, point, shard, replica) target
    is seeded by exactly those coordinates plus k, so thread scheduling
    (hedged duplicates race on a pool) can never change which dispatch a
    fault lands on — only the *order* faults are observed in.
    ``counts`` records every injected fault by mode for telemetry and
    replay assertions.
    """

    def __init__(self, config: ChaosConfig):
        self.config = config
        self.request_index = -1        # no request admitted yet
        self.counts: Dict[str, int] = {m: 0 for m in MODES}
        self._draws: Dict[tuple, int] = {}
        self._scope = _Scope()
        self._lock = threading.Lock()

    # -- request lifecycle -----------------------------------------------

    def begin_request(self) -> int:
        """Advance the request clock (schedules index off this)."""
        with self._lock:
            self.request_index += 1
            return self.request_index

    @contextlib.contextmanager
    def scope(self, shard: Optional[int], replica: Optional[int]):
        """Attribute nested injection points to one (shard, replica)."""
        prev = (self._scope.shard, self._scope.replica)
        self._scope.shard, self._scope.replica = shard, replica
        try:
            yield self
        finally:
            self._scope.shard, self._scope.replica = prev

    # -- decisions --------------------------------------------------------

    def _draw(self, mode: str, point: str, shard, replica) -> float:
        key = (mode, point, shard, replica)
        with self._lock:
            k = self._draws.get(key, 0)
            self._draws[key] = k + 1
        seed = (int(self.config.seed) & 0x7FFFFFFF, _MODE_ID[mode],
                _POINT_ID[point], (shard if shard is not None else -1) + 2,
                (replica if replica is not None else -1) + 2, k)
        return float(np.random.default_rng(seed).random())

    def _active(self, mode: str, point: str, shard, replica) -> bool:
        req = self.request_index
        for ev in self.config.events:
            if ev.kind == mode and ev.hits(req, shard, replica):
                return True
        p = getattr(self.config, mode)
        return p > 0.0 and self._draw(mode, point, shard, replica) < p

    def _count(self, mode: str) -> None:
        with self._lock:
            self.counts[mode] += 1

    # -- the injection API the hooks call ---------------------------------

    def fire(self, point: str, **ctx) -> None:
        """Raise / delay according to the modes wired to this point."""
        shard = ctx.get("shard", self._scope.shard)
        replica = ctx.get("replica", self._scope.replica)
        for mode in POINT_MODES.get(point, ()):
            # value-shaped modes have dedicated hooks (poison / burst);
            # fire() only raises or delays
            if mode in ("nan_poison", "client_burst") or not self._active(
                    mode, point, shard, replica):
                continue
            self._count(mode)
            if mode in ("slow_shard", "staleness_blowout", "admit_stall"):
                time.sleep(self.config.slow_ms / 1e3)
            else:
                raise InjectedFailure(mode, shard=shard, replica=replica,
                                      point=point)

    def poison(self, point: str, value):
        """Return ``value``, NaN-poisoned when the mode fires."""
        shard, replica = self._scope.shard, self._scope.replica
        if "nan_poison" in POINT_MODES.get(point, ()) and self._active(
                "nan_poison", point, shard, replica):
            self._count("nan_poison")
            return value * float("nan")
        return value

    def burst(self, point: str) -> int:
        """Synthetic admissions to inject at ``point`` (0 = none).

        ``client_burst`` simulates a traffic surge rather than a broken
        component, so instead of raising it *reports load*: the admission
        front end asks this hook per real arrival and enqueues the
        returned number of synthetic duplicate requests — genuine queue
        pressure that exercises backpressure/shedding deterministically.
        """
        shard, replica = self._scope.shard, self._scope.replica
        if "client_burst" in POINT_MODES.get(point, ()) and self._active(
                "client_burst", point, shard, replica):
            self._count("client_burst")
            return int(self.config.burst_factor)
        return 0

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)


# ---------------------------------------------------------------------------
# Module-level hook surface (one global read + branch when quiet).
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    """Make ``injector`` the process-wide fault source (None-safe hooks)."""
    global _ACTIVE
    _ACTIVE = injector
    return injector


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


@contextlib.contextmanager
def installed(injector: FaultInjector):
    prev = _ACTIVE
    install(injector)
    try:
        yield injector
    finally:
        install(prev) if prev is not None else uninstall()


def fire(point: str, **ctx) -> None:
    """Hook: inject at ``point`` if a chaos run is active (else free)."""
    inj = _ACTIVE
    if inj is not None:
        inj.fire(point, **ctx)


def poison(point: str, value):
    """Hook: possibly NaN-poison a result if a chaos run is active."""
    inj = _ACTIVE
    return value if inj is None else inj.poison(point, value)


def burst(point: str) -> int:
    """Hook: synthetic admissions to inject at ``point`` (0 when quiet)."""
    inj = _ACTIVE
    return 0 if inj is None else inj.burst(point)


__all__ = [
    "MODES", "POINT_MODES", "InjectedFailure", "ChaosEvent", "ChaosConfig",
    "FaultInjector", "install", "uninstall", "installed", "active",
    "fire", "poison", "burst",
]
