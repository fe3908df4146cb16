"""Overload-robust async admission front end: continuous batching.

The counterpart of ``repro.serve.frontend``.  The engines below this layer
are pull interfaces: a caller hands ``ServeEngine`` / ``ResilientEngine``
a batch and blocks for the answer.  Open-loop traffic arrives when it
arrives, and when arrivals exceed capacity something must give: without
an admission layer that is an unbounded queue or a silent drop.
``AsyncFrontend`` makes overload a typed, bounded, observable state:

**Continuous batching.**  ``submit()`` returns a future at once; dispatcher
workers drain the admission queue, coalescing queued requests for the same
estimator (and tier) into one dispatch: ``query_many`` on a plain engine,
``coalesce`` / ``split`` around one ``ResilientEngine.query``.  Batches
form from whatever is queued now; a request never waits for a batch to
fill, and a burst never dispatches one by one.

**Bounded queue and a state machine** driven by queue depth, with
hysteresis:

    accepting ⇄ backpressure ⇄ shedding → draining

  * ``accepting``: depth below the backpressure watermark, admit freely;
  * ``backpressure``: admission costs a token; callers without one get a
    typed ``Overloaded``;
  * ``shedding``: the token rate has been cut by AIMD breaches, most
    arrivals shed, queued work is browned out (below);
  * ``draining``: terminal (``drain()`` / ``close()``): nothing new is
    admitted, everything queued resolves.

**Token bucket and AIMD.**  Under pressure admission spends tokens from a
bucket whose refill rate adapts additively up (a batch inside the p99 SLO
with a shallow queue) and multiplicatively down (a full queue, a late
answer, a dispatch past the SLO).

**EDF and deadlines end to end.**  The queue is a deadline heap; workers
pop the earliest deadline first.  A request that expires in the queue
resolves with a typed ``DeadlineExceeded``; admitted requests carry their
deadline into the engine, and an answer completed past it is typed too.
Every submitted request resolves as an answer, ``Overloaded``,
``DeadlineExceeded`` or ``Degraded`` (``unaccounted()`` counts the rest,
and must be 0).

**Brownout ladder.**  Under pressure the frontend sheds work before
requests: at ``backpressure`` unpinned requests are served one rung down
the planner ladder (``TIER_ORDER``) when ``brownout_tiers`` says so, at
``shedding`` at the cheapest rung, and in front of a ``ResilientEngine``
shedding also opts into its certified degraded answers.

Chaos: the admit path carries the ``serve.admit`` injection point
(``admit_stall`` sleeps the admitting caller, ``client_burst`` enqueues
``burst_factor`` synthetic duplicates of the arrival); an injected failure
on the dispatch path requeues the batch (bounded by ``max_retries``).
Instruments (``repro``'s names): ``frontend.queue_depth`` and
``frontend.admit_rate`` gauges, admitted / rejected / brownout / expired /
retries / late-answer counters, the ``frontend.queue_wait_s`` histogram
and ``frontend.batch`` spans; and the port's spans of a worker's other
time: ``frontend.idle`` (waiting on an empty queue), ``frontend.wait``
(the ``batch_wait_ms`` wait for stragglers) and ``frontend.finish``
(resolving a batch's futures).

Points are converted to tensors on the engine's device at admission, so a
fused dispatch concatenates on the card.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import fault_injection, obs
from repro_torch.fault_injection import InjectedFailure
from repro_torch.plan.planner import TIER_ORDER
from repro_torch.serve.api import RFF_TIER, Answer, QueryRequest
from repro_torch.serve.batching import coalesce, split
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.errors import (BadRequest, DeadlineExceeded,
                                      Overloaded, ServeError)
from repro_torch.serve.resilience import ResilientEngine

ACCEPTING = "accepting"
BACKPRESSURE = "backpressure"
SHEDDING = "shedding"
DRAINING = "draining"

#: Queue-pressure level per state (indexes the brownout ladder).
_LEVEL = {ACCEPTING: 0, BACKPRESSURE: 1, SHEDDING: 2, DRAINING: 2}


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Admission policy: queue bounds, watermarks, rates, brownout."""

    max_queue: int = 128          # hard bound on queued requests
    backpressure_frac: float = 0.375   # depth fraction entering backpressure
    shed_frac: float = 0.75            # depth fraction entering shedding
    hysteresis: float = 0.5       # exit watermark = enter watermark × this
    workers: int = 1              # dispatcher threads (0 = manual pump())
    batch_wait_ms: float = 2.0    # coalescing wait when the queue is shallow
    default_deadline_ms: float = 1000.0
    max_retries: int = 2          # injected-failure requeues per request
    # token bucket + AIMD (admission is token-gated under pressure)
    rate: float = 256.0           # initial admitted requests/sec
    burst: float = 64.0           # bucket capacity (tokens)
    min_rate: float = 4.0
    max_rate: float = 1e5
    aimd_increase: float = 8.0    # +req/s per healthy batch completion
    aimd_decrease: float = 0.5    # ×rate per breach signal
    p99_slo_ms: float = 250.0     # dispatch-latency SLO feeding AIMD
    # brownout: pressure level → tier for requests with no explicit
    # precision (None = the engine config's tier).  Any exact rung or
    # "rff" (only where the engine's method supports the RFF tier)
    brownout_tiers: Tuple[Optional[str], ...] = (None, None, TIER_ORDER[-1])
    brownout_degraded: bool = True   # shedding + resilient → opt into
                                     # certified degraded answers

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if not (0.0 < self.backpressure_frac <= self.shed_frac <= 1.0):
            raise ValueError(
                f"need 0 < backpressure_frac <= shed_frac <= 1, got "
                f"{self.backpressure_frac}/{self.shed_frac}")
        if not (0.0 < self.hysteresis <= 1.0):
            raise ValueError("hysteresis must be in (0, 1]")
        if self.workers < 0:
            raise ValueError("workers must be >= 0")
        for name in ("default_deadline_ms", "rate", "burst", "min_rate",
                     "max_rate", "aimd_increase", "p99_slo_ms"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")
        if not (0.0 < self.aimd_decrease < 1.0):
            raise ValueError("aimd_decrease must be in (0, 1)")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if len(self.brownout_tiers) != 3:
            raise ValueError("brownout_tiers maps the 3 pressure levels")
        for t in self.brownout_tiers:
            if t is not None and t not in TIER_ORDER + (RFF_TIER,):
                raise ValueError(f"unknown brownout tier {t!r}")


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s up to ``capacity``."""

    def __init__(self, rate: float, capacity: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.capacity = float(capacity)
        self.tokens = float(capacity)
        self.clock = clock
        self._last = clock()
        self._lock = threading.Lock()

    def set_rate(self, rate: float) -> None:
        with self._lock:
            self._refill()
            self.rate = float(rate)

    def take(self, k: float = 1.0) -> bool:
        with self._lock:
            self._refill()
            if self.tokens >= k:
                self.tokens -= k
                return True
            return False

    def _refill(self) -> None:
        now = self.clock()
        self.tokens = min(self.capacity,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now


class AimdController:
    """Additive-increase / multiplicative-decrease on the admitted rate:
    healthy completions add ``increase`` req/s, any breach multiplies by
    ``decrease``; clamped to [min_rate, max_rate], it drives the token
    bucket's refill."""

    def __init__(self, bucket: TokenBucket, *, increase: float,
                 decrease: float, min_rate: float, max_rate: float):
        self.bucket = bucket
        self.increase = increase
        self.decrease = decrease
        self.min_rate = min_rate
        self.max_rate = max_rate
        self.rate = bucket.rate
        self._lock = threading.Lock()

    def on_healthy(self) -> None:
        with self._lock:
            self.rate = min(self.max_rate, self.rate + self.increase)
            self.bucket.set_rate(self.rate)
        obs.gauge("frontend.admit_rate",
                  "AIMD-controlled admitted requests/sec").set(self.rate)

    def on_breach(self, reason: str) -> None:
        with self._lock:
            self.rate = max(self.min_rate, self.rate * self.decrease)
            self.bucket.set_rate(self.rate)
        obs.counter("frontend.aimd_breaches",
                    "multiplicative admission-rate cuts",
                    labels={"reason": reason}).inc()
        obs.gauge("frontend.admit_rate",
                  "AIMD-controlled admitted requests/sec").set(self.rate)


class AdmissionStateMachine:
    """accepting ⇄ backpressure ⇄ shedding → draining, with hysteresis.

    A state is entered at ``frac × max_queue`` and left at ``hysteresis ×
    enter``, so a queue oscillating around one watermark does not flap
    the state (and the brownout tier) per request.  ``draining`` is
    terminal and reachable only through :meth:`drain`.
    """

    def __init__(self, max_queue: int, backpressure_frac: float,
                 shed_frac: float, hysteresis: float):
        self.bp_enter = max(1, int(round(backpressure_frac * max_queue)))
        self.shed_enter = max(self.bp_enter,
                              int(round(shed_frac * max_queue)))
        self.bp_exit = int(self.bp_enter * hysteresis)
        self.shed_exit = max(self.bp_enter,
                             int(self.shed_enter * hysteresis))
        self.state = ACCEPTING
        self.transitions: List[Tuple[str, str]] = []

    @property
    def level(self) -> int:
        return _LEVEL[self.state]

    def observe(self, depth: int) -> str:
        """Fold the current queue depth into the state; returns it."""
        s = self.state
        if s == DRAINING:
            return s
        if depth >= self.shed_enter or (s == SHEDDING
                                        and depth > self.shed_exit):
            nxt = SHEDDING
        elif depth >= self.bp_enter or (s != ACCEPTING
                                        and depth > self.bp_exit):
            nxt = BACKPRESSURE
        else:
            nxt = ACCEPTING
        if nxt != s:
            self._transition(nxt)
        return nxt

    def drain(self) -> None:
        if self.state != DRAINING:
            self._transition(DRAINING)

    def _transition(self, to: str) -> None:
        self.transitions.append((self.state, to))
        self.state = to
        obs.counter("frontend.state_transitions",
                    "admission state machine transitions",
                    labels={"to": to}).inc()


@dataclasses.dataclass
class _Pending:
    """One admitted request waiting in the EDF heap."""

    deadline: float                  # absolute seconds on the clock
    seq: int
    key: str
    y: torch.Tensor                  # (rows, d) on the engine's device
    rows: int
    precision: Optional[str]         # a request pin wins over the ladder
    future: Future
    enq: float
    retries: int = 0
    synthetic: bool = False          # a chaos client_burst duplicate
    accuracy_target: Optional[float] = None
    allow_degraded: Optional[bool] = None

    def entry(self):
        return (self.deadline, self.seq, self)


class AsyncFrontend:
    """Admission front end over a ``ServeEngine`` or ``ResilientEngine``.

    ``submit()`` admits (or sheds, typed) and returns a
    ``concurrent.futures.Future`` resolving to an ``Answer``; ``query()``
    blocks on it; ``aquery()`` awaits it from asyncio.  ``workers=0``
    starts no dispatcher thread: the caller runs batches with
    :meth:`pump`, synchronously and deterministically.
    """

    def __init__(self, engine, config: FrontendConfig | None = None, *,
                 clock: Callable[[], float] = time.monotonic):
        cfg = config or FrontendConfig()
        self._resilient = isinstance(engine, ResilientEngine)
        if not self._resilient and not isinstance(engine, ServeEngine):
            raise TypeError(
                f"AsyncFrontend fronts ServeEngine or ResilientEngine, "
                f"got {type(engine).__name__}")
        if cfg.workers > 1 and not self._resilient:
            # a plain ServeEngine's bucket cache is not reentrant; the
            # resilient layer serializes per replica itself
            raise ValueError(
                "workers > 1 requires a ResilientEngine backend (the "
                "plain ServeEngine is single-dispatch)")
        self.engine = engine
        self.config = cfg
        self._clock = clock
        self.sm = AdmissionStateMachine(
            cfg.max_queue, cfg.backpressure_frac, cfg.shed_frac,
            cfg.hysteresis)
        self.bucket = TokenBucket(cfg.rate, cfg.burst, clock)
        self.aimd = AimdController(
            self.bucket, increase=cfg.aimd_increase,
            decrease=cfg.aimd_decrease, min_rate=cfg.min_rate,
            max_rate=cfg.max_rate)
        self._heap: List[tuple] = []
        self._seq = 0
        self._inflight = 0
        self._stop = False
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.stats = {k: 0 for k in (
            "submitted", "admitted", "answered", "degraded", "browned",
            "expired", "late", "retries", "batches", "synthetic",
            "rejected", "errored")}
        self._rejected_by: dict = {}
        self._queue_wait = obs.histogram(
            "frontend.queue_wait_s", "admit → dispatch seconds in queue",
            lo=1e-5, hi=1e3)
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"frontend-{i}")
            for i in range(cfg.workers)]
        for t in self._workers:
            t.start()

    # -- admission --------------------------------------------------------

    def submit(self, req: QueryRequest) -> Future:
        """Admit one request; returns its future or raises ``Overloaded``.

        ``deadline_s`` is relative seconds from now (default
        ``default_deadline_ms``); ``accuracy_target`` rides into the
        engine's cascade; a ``precision`` pin wins over the brownout
        ladder; ``allow_degraded`` overrides the resilient engine's
        default.  The admit decision is synchronous: a shed request fails
        here, typed, and never enters the queue.
        """
        if not isinstance(req, QueryRequest):
            raise BadRequest("submit takes a QueryRequest")
        self.stats["submitted"] += 1
        # chaos: a stalled admission thread blocks its caller here,
        # before any decision.  In front of a plain engine nothing else
        # advances the injector's request clock, so scheduled windows are
        # indexed off arrivals; the resilient engine keeps its own
        inj = fault_injection.active()
        if inj is not None and not self._resilient:
            inj.begin_request()
        fault_injection.fire("serve.admit", key=req.key)
        nburst = fault_injection.burst("serve.admit")
        pts = torch.atleast_2d(torch.as_tensor(
            req.points, dtype=torch.float32, device=self.engine.device))
        if nburst:
            self._inject_burst(req.key, pts, nburst)
        rel = (self.config.default_deadline_ms / 1e3
               if req.deadline_s is None else req.deadline_s)
        return self._admit(req.key, pts, rel, req.precision,
                           synthetic=False,
                           accuracy_target=req.accuracy_target,
                           allow_degraded=req.allow_degraded)

    def query(self, req: QueryRequest) -> Answer:
        """Blocking convenience: ``submit`` + wait (typed errors raise)."""
        return self.submit(req).result()

    async def aquery(self, req: QueryRequest) -> Answer:
        """Awaitable ``query`` for asyncio callers: the future the
        dispatcher resolves is the awaited one."""
        import asyncio

        return await asyncio.wrap_future(self.submit(req))

    def _admit(self, key: str, y: torch.Tensor, rel_deadline: float,
               precision: Optional[str], *, synthetic: bool,
               accuracy_target: Optional[float] = None,
               allow_degraded: Optional[bool] = None) -> Future:
        cfg = self.config
        fut: Future = Future()
        now = self._clock()
        with self._cv:
            depth = len(self._heap)
            state = self.sm.observe(depth)
            if self._stop or state == DRAINING:
                return self._reject(fut, "draining", synthetic,
                                    f"frontend draining; request for "
                                    f"{key!r} not admitted")
            if depth >= cfg.max_queue:
                self.aimd.on_breach("queue_full")
                return self._reject(
                    fut, "queue_full", synthetic,
                    f"admission queue full ({depth}/{cfg.max_queue})")
            if state in (BACKPRESSURE, SHEDDING) and not self.bucket.take():
                return self._reject(
                    fut, state, synthetic,
                    f"admission rate exhausted under {state} "
                    f"(AIMD rate {self.aimd.rate:.0f} req/s, "
                    f"queue {depth}/{cfg.max_queue})")
            self._seq += 1
            p = _Pending(deadline=now + rel_deadline, seq=self._seq,
                         key=key, y=y, rows=int(y.shape[0]),
                         precision=precision, future=fut, enq=now,
                         synthetic=synthetic,
                         accuracy_target=accuracy_target,
                         allow_degraded=allow_degraded)
            heapq.heappush(self._heap, p.entry())
            self.stats["admitted"] += 1
            if synthetic:
                self.stats["synthetic"] += 1
            obs.counter("frontend.admitted", "requests admitted to the "
                        "queue").inc()
            obs.gauge("frontend.queue_depth",
                      "admission queue depth").set(len(self._heap))
            self._cv.notify()
        return fut

    def _reject(self, fut: Future, reason: str, synthetic: bool,
                msg: str) -> Future:
        """Typed shed: counted, and ``Overloaded`` raised to a real
        caller; a synthetic burst request resolves its (unobserved)
        future instead, so even chaos traffic is never silent."""
        self.stats["rejected"] += 1
        self._rejected_by[reason] = self._rejected_by.get(reason, 0) + 1
        obs.counter("frontend.rejected", "requests shed at admission",
                    labels={"reason": reason}).inc()
        err = Overloaded(msg, reason=reason)
        if synthetic:
            self.stats["synthetic"] += 1
            fut.set_exception(err)
            return fut
        raise err

    def _inject_burst(self, key: str, y: torch.Tensor, k: int) -> None:
        """chaos ``client_burst``: k synthetic duplicates of this arrival
        through the same admission path (counted under
        ``stats['synthetic']``; nobody awaits them)."""
        rel = self.config.default_deadline_ms / 1e3
        for _ in range(k):
            fut = self._admit(key, y, rel, None, synthetic=True)
            # an unobserved future's exception is read here on purpose
            fut.add_done_callback(lambda f: f.exception())

    # -- dispatch ---------------------------------------------------------

    def pump(self, max_batches: int = 1 << 30) -> int:
        """Dispatch up to ``max_batches`` coalesced batches synchronously
        (the ``workers=0`` mode; also safe beside live workers)."""
        done = 0
        while done < max_batches:
            batch = self._next_batch(block=False)
            if not batch:
                break
            self._dispatch(batch)
            done += 1
        return done

    def _worker_loop(self) -> None:
        while True:
            batch = self._next_batch(block=True)
            if batch is None:          # stop signal
                return
            if batch:
                self._dispatch(batch)

    def _next_batch(self, block: bool):
        """Pop the earliest-deadline request, expiring stale ones (typed),
        then coalesce compatible queued requests into one dispatch.

        Returns a list of ``_Pending`` (empty when non-blocking and idle),
        or None when the frontend is stopping.
        """
        cfg = self.config
        with self._cv:
            while True:
                if self._stop and not self._heap:
                    return None if block else []
                if self._heap:
                    break
                if not block:
                    return []
                with obs.span("frontend.idle"):
                    self._cv.wait(timeout=0.1)
            first = self._pop_live()
            if first is None:
                return []
            batch = [first]
            # claim inflight BEFORE the straggler wait below: cv.wait
            # releases the lock with the head request already popped, and
            # without the claim a concurrent drain() could see an empty
            # heap and nothing in flight while this request is unserved
            self._inflight += 1
            self._coalesce_into(batch)
            # shallow queue: one short window for stragglers to fuse,
            # bounded by the head request's deadline slack
            slack = first.deadline - self._clock()
            wait_s = min(cfg.batch_wait_ms / 1e3, max(slack, 0.0))
            if block and len(batch) == 1 and not self._heap and wait_s > 0:
                with obs.span("frontend.wait"):
                    self._cv.wait(timeout=wait_s)
                self._coalesce_into(batch)
            obs.gauge("frontend.queue_depth",
                      "admission queue depth").set(len(self._heap))
        return batch

    def _expire(self, p: _Pending, now: float, msg: str) -> None:
        """A request whose deadline passed in the queue: typed and
        counted (an expiry is an outcome, not a drop)."""
        self.stats["expired"] += 1
        obs.counter("frontend.expired",
                    "requests whose deadline passed in queue").inc()
        self._queue_wait.observe(now - p.enq)
        p.future.set_exception(DeadlineExceeded(msg))

    def _pop_live(self) -> Optional[_Pending]:
        """The earliest-deadline queued request, expiring stale ones."""
        while self._heap:
            _, _, p = heapq.heappop(self._heap)
            now = self._clock()
            if now < p.deadline:
                return p
            self._expire(p, now, f"request for {p.key!r} expired after "
                         f"{1e3 * (now - p.enq):.1f}ms in the admission "
                         "queue")
        return None

    def _coalesce_into(self, batch: List[_Pending]) -> None:
        """Greedily fuse compatible queued requests (same estimator, same
        explicit tier; for the resilient engine also the same accuracy
        and degradation knobs, since it serves one fused request) up to
        the engine's largest bucket, in EDF order."""
        first = batch[0]
        max_rows = self.engine.config.max_batch
        rows = sum(p.rows for p in batch)
        while self._heap:
            head = self._heap[0][2]
            if (head.key != first.key or head.precision != first.precision
                    or rows + head.rows > max_rows):
                break
            if self._resilient and (
                    head.accuracy_target != first.accuracy_target
                    or head.allow_degraded != first.allow_degraded):
                break
            heapq.heappop(self._heap)
            now = self._clock()
            if now >= head.deadline:
                self._expire(head, now,
                             f"request for {head.key!r} expired in queue")
                continue
            batch.append(head)
            rows += head.rows

    def _dispatch(self, batch: List[_Pending]) -> None:
        cfg = self.config
        state = self.sm.state
        level = self.sm.level
        ladder_tier = cfg.brownout_tiers[level]
        tier = batch[0].precision or ladder_tier
        browned = batch[0].precision is None and ladder_tier is not None
        rows = sum(p.rows for p in batch)
        now = self._clock()
        for p in batch:
            self._queue_wait.observe(now - p.enq)
        t0 = now
        sp = obs.span("frontend.batch", key=batch[0].key, rows=rows,
                      requests=len(batch), state=state,
                      tier=tier or "config")
        # the inflight decrement comes LAST, after every member's future
        # carries its outcome (result, typed error, or a requeued heap
        # entry): drain() returns the moment heap and inflight are empty
        try:
            try:
                with sp:
                    if browned:
                        sp.set(browned=True)
                        obs.counter(
                            "frontend.brownout",
                            "dispatches tier-shed by queue pressure",
                            labels={"tier": tier}).inc(len(batch))
                    if self._resilient:
                        answers = self._dispatch_resilient(batch, tier,
                                                           level)
                    else:
                        answers = self._dispatch_plain(batch, tier)
            except InjectedFailure:
                self._requeue(batch)
                return
            except ServeError as e:
                self._resolve_error(batch, e)
                return
            except Exception as e:   # noqa: BLE001 — a worker thread
                # re-raises to nobody; the callers' futures are the only
                # channel a real bug can surface through
                obs.counter("frontend.dispatch_errors",
                            "non-chaos dispatch exceptions",
                            labels={"type": type(e).__name__}).inc()
                self._resolve_error(batch, e)
                return
            with obs.span("frontend.finish", requests=len(batch)):
                self._finish(batch, answers, browned, state,
                             self._clock() - t0)
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    def _dispatch_plain(self, batch: List[_Pending],
                        tier: Optional[str]) -> List[Answer]:
        """One fused dispatch through ``ServeEngine.query_many``: one
        QueryRequest per member, so per-member accuracy targets gate the
        cascade's row ranges apart."""
        now = self._clock()
        return self.engine.query_many([QueryRequest(
            key=p.key, points=p.y, precision=tier,
            accuracy_target=p.accuracy_target,
            deadline_s=max(p.deadline - now, 1e-3)) for p in batch])

    def _dispatch_resilient(self, batch: List[_Pending],
                            tier: Optional[str], level: int
                            ) -> List[Answer]:
        """One fused dispatch through ``ResilientEngine.query`` (the
        shedding rung opts into certified degraded answers); the fused
        Answer is split back per member, each with its slice of the
        per-row bounds."""
        fused, sizes = coalesce([p.y for p in batch])
        budget_s = max(max(p.deadline for p in batch) - self._clock(), 1e-3)
        allow = batch[0].allow_degraded
        if level >= 2 and self.config.brownout_degraded:
            allow = True
        ans = self.engine.query(QueryRequest(
            key=batch[0].key, points=fused, precision=tier,
            accuracy_target=batch[0].accuracy_target,
            deadline_s=budget_s, allow_degraded=allow))
        offs = np.cumsum([0] + list(sizes))
        out = []
        for i, dens in enumerate(split(ans.value, sizes)):
            b = ans.rel_err_bounds[int(offs[i]):int(offs[i + 1])]
            out.append(dataclasses.replace(
                ans, value=dens, rel_err_bounds=b,
                rel_err_bound=float(b.max())))
        return out

    def _requeue(self, batch: List[_Pending]) -> None:
        """Chaos on the dispatch path: retry each member (bounded), then
        shed it typed; injected faults cost retries, never silent drops.
        (``_dispatch``'s finally owns the inflight decrement.)"""
        with self._cv:
            for p in batch:
                if p.retries >= self.config.max_retries:
                    self.stats["rejected"] += 1
                    self._rejected_by["retries"] = (
                        self._rejected_by.get("retries", 0) + 1)
                    obs.counter("frontend.rejected",
                                "requests shed at admission",
                                labels={"reason": "retries"}).inc()
                    p.future.set_exception(Overloaded(
                        f"request for {p.key!r} failed "
                        f"{p.retries + 1} chaos-injected dispatches",
                        reason="retries"))
                    continue
                p.retries += 1
                self.stats["retries"] += 1
                obs.counter("frontend.retries",
                            "chaos-failed dispatches requeued").inc()
                heapq.heappush(self._heap, p.entry())
            self._cv.notify_all()

    def _resolve_error(self, batch: List[_Pending], err) -> None:
        """A typed engine error (or a bug) for every member: still an
        accounted outcome (``errored``), never a silent drop."""
        self.stats["errored"] += len(batch)
        for p in batch:
            p.future.set_exception(err)

    def _finish(self, batch, answers, browned, state, dispatch_s) -> None:
        now = self._clock()
        late = 0
        for p, ans in zip(batch, answers):
            if now > p.deadline:
                late += 1
                p.future.set_exception(DeadlineExceeded(
                    f"answer for {p.key!r} completed "
                    f"{1e3 * (now - p.deadline):.1f}ms past its deadline"))
                continue
            self.stats["answered"] += 1
            if ans.degraded:
                self.stats["degraded"] += 1
            if browned:
                self.stats["browned"] += 1
            ans.browned = browned
            ans.state = state
            ans.queued_ms = 1e3 * max(now - dispatch_s - p.enq, 0.0)
            ans.batch_requests = len(batch)
            p.future.set_result(ans)
        if late:
            self.stats["late"] += late
            obs.counter("frontend.late_answers",
                        "answers completed past their deadline").inc(late)
        self.stats["batches"] += 1
        obs.counter("frontend.batches", "fused dispatches").inc()
        obs.histogram("frontend.batch_rows", "query rows per fused "
                      "dispatch", lo=1, hi=1e6).observe(
            max(sum(p.rows for p in batch), 1))
        # the AIMD feedback: healthy = inside the SLO with a calm queue
        with self._lock:
            depth = len(self._heap)
            self.sm.observe(depth)
        if dispatch_s > self.config.p99_slo_ms / 1e3 or late:
            self.aimd.on_breach("slo" if not late else "late")
        elif depth < self.sm.bp_enter:
            self.aimd.on_healthy()

    # -- lifecycle --------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, serve everything queued; True when empty."""
        self.sm.drain()
        deadline = None if timeout is None else self._clock() + timeout
        with self._cv:
            while self._heap or self._inflight:
                if not self._workers:
                    break              # pump mode: drained below
                rem = (None if deadline is None
                       else max(deadline - self._clock(), 0.0))
                if rem == 0.0:
                    return False
                self._cv.wait(timeout=rem if rem is not None else 0.1)
        if not self._workers:
            while self.pump(1):
                pass
        with self._lock:
            return not self._heap and not self._inflight

    def close(self, timeout: float = 30.0) -> None:
        """Drain, then stop the dispatcher threads."""
        self.drain(timeout)
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._workers:
            t.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- telemetry --------------------------------------------------------

    @property
    def state(self) -> str:
        return self.sm.state

    def report(self) -> dict:
        """JSON-safe overload report: every submitted request accounted
        for by outcome, the queue-wait tail, the admitted rate and the
        state machine's history."""
        h = self._queue_wait
        return {
            "state": self.sm.state,
            "stats": dict(self.stats),
            "rejected_by": dict(self._rejected_by),
            "admit_rate": round(self.aimd.rate, 2),
            "queue_depth": len(self._heap),
            "queue_wait_ms": {
                "p50": round(1e3 * h.quantile(0.50), 3),
                "p99": round(1e3 * h.quantile(0.99), 3),
                "count": h.count,
            },
            "transitions": [f"{a}->{b}" for a, b in self.sm.transitions],
        }

    def unaccounted(self) -> int:
        """Requests that neither resolved nor were rejected typed (must be
        0; answered includes degraded, expired / late / rejected /
        errored are typed outcomes)."""
        s = self.stats
        return (s["submitted"] + s["synthetic"] - s["rejected"]
                - s["answered"] - s["expired"] - s["late"] - s["errored"]
                - len(self._heap) - self._inflight)


__all__ = ["ACCEPTING", "BACKPRESSURE", "SHEDDING", "DRAINING",
           "FrontendConfig", "TokenBucket", "AimdController",
           "AdmissionStateMachine", "AsyncFrontend"]
