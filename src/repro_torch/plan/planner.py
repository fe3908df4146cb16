"""Cost-model execution planner for the H100 port.

The counterpart of ``repro.plan.planner``: one deterministic decision
function that picks, for a (shape, accuracy target, backend hint,
streaming) request, the precision tier, prune mode, launch tiles,
backend, staleness policy and whether the RFF fast tier pays:

    plan(PlanRequest(n, d, q, accuracy, backend, stream, rff)) -> ExecutionPlan

Decision inputs (the planner never times the card):

  * the modeled pass costs of ``kernels/tuning.py`` /
    ``kernels/autotune.py`` — the H100's model, padding-aware, with the
    kernels' launch geometry;
  * *measured* benchmark cells wrapped by :class:`BenchModel`: measured
    prune occupancies and pruning error license an epsilon > 0 for a
    shape regime, a measured RFF hit fraction licenses the fast tier.
    The port has no committed H100 cells yet, so the default model is
    empty: by ``repro``'s own rule for unmeasured regimes no epsilon > 0
    and no RFF tier is planned by default (``repro``'s
    ``BENCH_flash.json`` cells are TPU measurements and are not read);
  * the tiers' documented accuracy bars (:data:`TIER_RTOL`).

Decision rules (``repro``'s, with the port's backends):

  tier      — cheapest tier whose rtol meets the target (f32 always
              admissible); ties to the more accurate tier.
  prune     — "off" below ``ops.PRUNE_AUTO_MIN_COLS``; exact (epsilon 0)
              otherwise; promoted to the largest measured epsilon with
              ``epsilon · EPS_SAFETY <= accuracy`` whose measured error
              meets the target; and kept only if its modeled pass beats
              the dense one.
  blocks    — best modeled tile at the chosen tier and occupancy,
              launchable at every tier (per-request pins reuse it).
  backend   — "flash" (the kernels) from ``FLASH_MIN_COLS`` train
              points, "torch" (the plain streaming math) below.
  staleness — streaming only: 0 at f32-grade targets, 1 at bf16x2-grade,
              2 looser; background builds when the budget is nonzero.
  rff       — only for cascade-eligible requests with a measured hit
              fraction, when the modeled RFF pass is cheaper than the
              hit fraction times the exact pass.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch import obs
from repro_torch.kernels import autotune
from repro_torch.kernels import precision as prec

# Documented per-tier relative accuracy of a served density (the serve
# verify bars: rtol of the tier vs the f32 reference path).
TIER_RTOL: Dict[str, float] = {"f32": 1e-5, "bf16x2": 5e-4, "bf16": 5e-2}

#: Tier preference order on cost ties: more accurate first.
TIER_ORDER: Tuple[str, ...] = ("f32", "bf16x2", "bf16")

#: Safety margin between a per-point prune epsilon and the accuracy
#: target: the certificate bounds the *unnormalized accumulator* error at
#: n·epsilon worst case, so the planner only spends epsilon two orders of
#: magnitude below the requested relative tolerance.
EPS_SAFETY = 100.0

#: Default accuracy target (matches the serve default: f32-grade answers).
DEFAULT_ACCURACY = 1e-5

#: Train count from which the planner routes to the kernels ("flash",
#: the "auto" backend's choice); below it a launch's fixed costs dominate
#: and the plain streaming math ("torch") is the cheaper path.
FLASH_MIN_COLS = 2048

#: Default per-dispatch query rows when the caller doesn't know the
#: traffic shape (the serve default max_batch).
DEFAULT_Q = 4096

_BACKENDS = ("torch", "flash")


def _bucket(x: int) -> int:
    return 1 << max(int(math.ceil(math.log2(max(int(x), 1)))), 0)


# ---------------------------------------------------------------------------
# Measured-cell model.
# ---------------------------------------------------------------------------


class BenchModel:
    """A read-only view of the measured cells the planner may consult:
    prune occupancies and pruning error per (shape bucket, d, epsilon)
    regime, and RFF hit fractions per (shape bucket, d, target).

    Deterministic by construction: it reads only the documents it is
    given, never the tuner's live occupancy state, so the same documents
    always plan the same way (the property the golden fixture pins).
    """

    def __init__(self, docs: Sequence[dict] = ()):
        self._prune_cells: List[dict] = []
        self._rff_cells: List[dict] = []
        for doc in docs:
            for cell in (doc or {}).get("cells", ()):
                if not isinstance(cell, dict):
                    continue
                if cell.get("cell") == "pruning" and "epsilon" in cell:
                    self._prune_cells.append(cell)
                if cell.get("cell") == "rff_cascade" \
                        and "rff_hit_frac" in cell:
                    self._rff_cells.append(cell)

    @classmethod
    def load(cls, paths: Optional[Sequence[Union[str, Path]]] = None
             ) -> "BenchModel":
        """Load from measured-cell documents (missing files are skipped);
        the default is :func:`default_bench_paths`, empty today."""
        if paths is None:
            paths = default_bench_paths()
        docs = []
        for p in paths:
            p = Path(p)
            if p.exists():
                with open(p) as f:
                    docs.append(json.load(f))
        return cls(docs)

    # -- lookups ---------------------------------------------------------

    def _regime_cells(self, n: int, d: int) -> List[dict]:
        nb = _bucket(n)
        return [c for c in self._prune_cells
                if _bucket(int(c.get("n", 0))) == nb
                and int(c.get("d", -1)) == int(d)]

    def measured_epsilons(self, n: int, d: int) -> List[float]:
        """Measured prune epsilons for this shape regime, ascending."""
        return sorted({float(c["epsilon"]) for c in self._regime_cells(n, d)
                       if float(c["epsilon"]) > 0.0})

    def occupancy_record(self, n: int, d: int, epsilon: float
                         ) -> Optional[Tuple[int, float]]:
        """(block_n, occupancy) measured for (regime, epsilon), or None."""
        for c in self._regime_cells(n, d):
            if float(c["epsilon"]) == float(epsilon) \
                    and "occupancy" in c and "block_n" in c:
                return int(c["block_n"]), float(c["occupancy"])
        return None

    def occupancy_fn(self, n: int, d: int, epsilon: float
                     ) -> Optional[Callable[[int], float]]:
        """Tile-width → expected occupancy from a measured record.

        Same extrapolation as ``autotune.expected_occupancy``: the keep
        fraction grows ~linearly with tile span (a tile wider than a
        cluster can't be skipped), capped at a dense pass.  None when the
        regime has no measurement.
        """
        rec = self.occupancy_record(n, d, epsilon)
        if rec is None:
            return None
        ref_bn, ref_occ = rec
        return lambda bn: min(1.0, ref_occ * bn / ref_bn)

    def measured_rel_err(self, n: int, d: int, epsilon: float
                         ) -> Optional[float]:
        """Measured pruning relative error for (regime, epsilon)."""
        for c in self._regime_cells(n, d):
            if float(c["epsilon"]) == float(epsilon) \
                    and "prune_rel_err" in c:
                return float(c["prune_rel_err"])
        return None

    def measured_rff_hit(self, n: int, d: int,
                         accuracy: float) -> Optional[float]:
        """Measured RFF-tier hit fraction for this regime and target.

        Only cells measured at an accuracy target at least as *tight* as
        the request's are admissible (a looser target can only raise the
        hit fraction, so the measurement is a safe lower bound); returns
        the best such fraction, or None when the regime is unmeasured —
        and an unmeasured regime never engages the fast tier in a plan,
        mirroring the prune-epsilon rule.
        """
        nb = _bucket(n)
        best = None
        for c in self._rff_cells:
            if _bucket(int(c.get("n", 0))) != nb \
                    or int(c.get("d", -1)) != int(d):
                continue
            if float(c.get("accuracy_target", float("inf"))) > accuracy:
                continue
            frac = float(c["rff_hit_frac"])
            if best is None or frac > best:
                best = frac
        return best


def default_bench_paths() -> List[Path]:
    """The committed H100 measured-cell documents the planner reads by
    default: none yet (ROADMAP: the planner's measured-cell file waits for
    committed H100 measurements), so an unmeasured regime plans exact."""
    return []


# ---------------------------------------------------------------------------
# Request / plan schema.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """What the planner needs to know about a workload: shape bucket,
    accuracy target, backend constraint, and whether the dataset streams."""

    n: int                          # train points
    d: int                          # dimension
    q: int = DEFAULT_Q              # query rows per dispatch (bucket top)
    accuracy: float = DEFAULT_ACCURACY   # target max relative error
    backend: str = "auto"           # "auto" | "torch" | "flash"
    stream: bool = False
    # Whether the workload is *eligible* for the RFF fast tier + accuracy
    # cascade (serve/cascade.py): the estimator method supports it and the
    # config hasn't disabled it.  Eligibility is not engagement — the
    # planner still demands a measured ``rff_cascade`` cell and a modeled
    # expected-cost win before a plan routes through the cascade.
    rff: bool = False

    def __post_init__(self):
        if self.n < 1 or self.d < 1 or self.q < 1:
            raise ValueError(f"bad plan shape n={self.n} d={self.d} "
                             f"q={self.q} (all must be >= 1)")
        if not (self.accuracy > 0.0):
            raise ValueError(f"accuracy target must be > 0, "
                             f"got {self.accuracy}")
        if self.backend not in _BACKENDS + ("auto",):
            raise ValueError(f"bad backend {self.backend!r}")

    def as_dict(self) -> dict:
        out = {"n": self.n, "d": self.d, "q": self.q,
               "accuracy": self.accuracy, "backend": self.backend,
               "stream": self.stream}
        if self.rff:                 # keep pre-cascade golden keys stable
            out["rff"] = True
        return out


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """One validated execution shape: every knob the serve path threads.

    ``prune`` is ``"off"`` or a per-point epsilon float (0.0 = exact
    certified-underflow pruning — dense up to summation order).
    ``block_m``/``block_n`` are resolved launch tiles on the flash
    backend, None elsewhere.  ``modeled_cost_s`` is the backend-agnostic
    modeled pairwise-pass time the decision was priced at.
    """

    request: PlanRequest
    backend: str
    precision: str
    prune: Union[str, float]
    block_m: Optional[int] = None
    block_n: Optional[int] = None
    staleness_budget: int = 0
    stream_background: bool = False
    prewarm: bool = True
    modeled_cost_s: float = 0.0
    bound: str = ""                 # which resource the model says saturates
    occupancy: float = 1.0          # expected visit fraction priced in
    # Route through the RFF fast tier with cascade escalation to the exact
    # plan above.  When True, ``precision``/``prune``/blocks describe the
    # *escalation* tier and ``rff_hit_frac``/``modeled_rff_cost_s`` carry
    # the measured hit fraction and modeled feature-GEMM cost the
    # expected-cost decision was priced at.
    rff: bool = False
    rff_hit_frac: float = 0.0
    modeled_rff_cost_s: float = 0.0

    @property
    def plan_id(self) -> str:
        """Short stable id for spans/log lines."""
        blocks = (f"{self.block_m}x{self.block_n}"
                  if self.block_m is not None else "-")
        pr = self.prune if isinstance(self.prune, str) else f"{self.prune:g}"
        base = f"{self.backend}/{self.precision}/prune={pr}/{blocks}"
        return f"rff+{base}" if self.rff else base

    def as_dict(self) -> dict:
        """The golden-pinned decision record (JSON-stable field order)."""
        out = {
            "backend": self.backend,
            "precision": self.precision,
            "prune": self.prune,
            "block_m": self.block_m,
            "block_n": self.block_n,
            "staleness_budget": self.staleness_budget,
            "stream_background": self.stream_background,
            "modeled_cost_us": round(self.modeled_cost_s * 1e6, 3),
            "bound": self.bound,
            "occupancy": round(self.occupancy, 4),
        }
        if self.rff:                 # keep pre-cascade golden plans stable
            out["rff"] = True
            out["rff_hit_frac"] = round(self.rff_hit_frac, 4)
            out["modeled_rff_cost_us"] = round(
                self.modeled_rff_cost_s * 1e6, 3)
        return out

    # -- validity --------------------------------------------------------

    def validate(self) -> List[str]:
        """Every constraint a plan must satisfy to be launchable; returns
        the violations (empty list = valid)."""
        problems: List[str] = []
        req = self.request
        if self.backend not in _BACKENDS:
            problems.append(f"bad backend {self.backend!r}")
        try:
            prec.validate(self.precision)
        except ValueError as e:
            problems.append(str(e))
        if TIER_RTOL.get(self.precision, 0.0) > req.accuracy \
                and self.precision != "f32":
            problems.append(
                f"tier {self.precision} rtol "
                f"{TIER_RTOL.get(self.precision)} exceeds accuracy "
                f"target {req.accuracy}")
        if self.backend == "flash":
            if not (isinstance(self.block_m, int) and self.block_m > 0
                    and isinstance(self.block_n, int) and self.block_n > 0):
                problems.append(
                    f"flash plan needs int blocks, got "
                    f"{self.block_m}x{self.block_n}")
            else:
                from repro_torch.kernels import tuning

                # launchable at every tier: serving reuses one tile
                # across per-request precision pins
                for tier in prec.PRECISIONS:
                    why = tuning.infeasible(req.d, block_m=self.block_m,
                                            block_n=self.block_n,
                                            precision=tier)
                    if why is not None:
                        problems.append(f"{tier}: {why}")
        else:
            if self.prune != "off":
                problems.append(
                    f"prune={self.prune!r} needs the flash backend, "
                    f"plan says {self.backend}")
        if not isinstance(self.prune, str):
            eps = float(self.prune)
            if eps < 0.0:
                problems.append(f"prune epsilon {eps} < 0")
            elif eps > 0.0 and eps * EPS_SAFETY > req.accuracy:
                problems.append(
                    f"prune epsilon {eps:g} spends more than "
                    f"accuracy/{EPS_SAFETY:g} of the {req.accuracy:g} target")
        elif self.prune != "off":
            problems.append(f"bad prune {self.prune!r}")
        if self.rff:
            if not req.rff:
                problems.append(
                    "rff routing planned for a request that is not "
                    "cascade-eligible")
            if not (0.0 < self.rff_hit_frac <= 1.0):
                problems.append(
                    f"rff plan without a measured hit fraction "
                    f"({self.rff_hit_frac})")
            if not (self.modeled_rff_cost_s > 0.0):
                problems.append(
                    f"rff plan with non-positive modeled feature-GEMM "
                    f"cost {self.modeled_rff_cost_s}")
        if self.staleness_budget < 0:
            problems.append("staleness_budget < 0")
        if not req.stream and self.staleness_budget != 0:
            problems.append("non-streaming plan carries a staleness budget")
        if not (0.0 < self.occupancy <= 1.0):
            problems.append(f"occupancy {self.occupancy} outside (0, 1]")
        if not (self.modeled_cost_s >= 0.0):
            problems.append(f"bad modeled cost {self.modeled_cost_s}")
        return problems

    def check(self) -> "ExecutionPlan":
        problems = self.validate()
        if problems:
            raise ValueError("invalid execution plan: " + "; ".join(problems))
        return self


# ---------------------------------------------------------------------------
# The decision function.
# ---------------------------------------------------------------------------


def _admissible_tiers(accuracy: float) -> List[str]:
    tiers = [t for t in TIER_ORDER if TIER_RTOL[t] <= accuracy]
    return tiers or ["f32"]          # f32 is the reference: always allowed


def _prune_decision(req: PlanRequest, bench: BenchModel
                    ) -> Tuple[Union[str, float],
                               Optional[Callable[[int], float]]]:
    """(prune mode, occupancy_fn) for the request.

    Mirrors ``ops.resolve_prune``'s size gate, then promotes the epsilon
    using measured evidence only.
    """
    from repro_torch.kernels import ops

    if req.n < ops.PRUNE_AUTO_MIN_COLS:
        return "off", None
    eps = 0.0
    for cand in bench.measured_epsilons(req.n, req.d):
        if cand * EPS_SAFETY > req.accuracy:
            continue
        measured = bench.measured_rel_err(req.n, req.d, cand)
        if measured is not None and measured <= req.accuracy:
            eps = max(eps, cand)
    return eps, bench.occupancy_fn(req.n, req.d, eps)


def _staleness_policy(req: PlanRequest) -> Tuple[int, bool]:
    if not req.stream:
        return 0, False
    if req.accuracy <= 1e-5:
        budget = 0
    elif req.accuracy <= 5e-4:
        budget = 1
    else:
        budget = 2
    return budget, budget > 0


def _best_candidate(req: PlanRequest, tier: str,
                    occupancy_fn: Optional[Callable[[int], float]]
                    ) -> Optional[autotune.TunedConfig]:
    """Best modeled launch config at one tier (pure model, no timing)."""
    cands = autotune.shortlist(
        req.q, req.n, req.d, out_width=1, precision=tier,
        gate_all_tiers=True, occupancy_fn=occupancy_fn,
    )
    return cands[0] if cands else None


def plan(req: PlanRequest, bench: Optional[BenchModel] = None
         ) -> ExecutionPlan:
    """The planner entry point: one validated ExecutionPlan per request.

    Deterministic in (request, measured cells): pinned by the port's
    golden fixture (``plan/golden_plans.json``), regenerated deliberately
    with ``python -m repro_torch.plan --regen-golden``.
    """
    if bench is None:
        bench = BenchModel.load()

    with obs.span("plan.decide", n=req.n, d=req.d, q=req.q,
                  accuracy=req.accuracy, backend=req.backend,
                  stream=req.stream) as sp:
        backend = req.backend
        if backend == "auto":
            backend = "flash" if req.n >= FLASH_MIN_COLS else "torch"

        prune: Union[str, float] = "off"
        occ_fn: Optional[Callable[[int], float]] = None
        if backend == "flash":
            prune, occ_fn = _prune_decision(req, bench)

        # Tier choice: cheapest admissible tier by modeled cost; ties
        # break toward the more accurate tier (TIER_ORDER).  The torch
        # path computes in f32 end to end, so only flash routes tiers.
        tiers = _admissible_tiers(req.accuracy) if backend == "flash" \
            else ["f32"]
        best_tier, best_cand = None, None
        for tier in tiers:
            cand = _best_candidate(req, tier, occ_fn)
            if cand is None:
                continue
            if best_cand is None or cand.step_time < best_cand.step_time:
                best_tier, best_cand = tier, cand
        if best_cand is None:
            # No feasible pruned-occupancy candidate (can't happen today —
            # small tiles always fit — but stay total): fall back dense.
            prune, occ_fn = "off", None
            for tier in tiers:
                cand = _best_candidate(req, tier, None)
                if cand is not None and (
                        best_cand is None
                        or cand.step_time < best_cand.step_time):
                    best_tier, best_cand = tier, cand
        if best_cand is None:
            raise ValueError(
                f"no feasible launch config for plan request {req}")

        # Pruning must pay for itself: compare against the dense pass at
        # the chosen tier and keep the cheaper (ties keep the certified
        # pruned pass — it never costs accuracy at epsilon admissibility).
        occupancy = 1.0
        if prune != "off":
            dense = _best_candidate(req, best_tier, None)
            if dense is not None and dense.step_time < best_cand.step_time:
                prune, best_cand, occ_fn = "off", dense, None
            else:
                occupancy = (occ_fn(best_cand.block_n)
                             if occ_fn is not None else 1.0)

        # RFF fast tier: engage only when the request is cascade-eligible,
        # a measured rff_cascade cell covers this (regime, accuracy), and
        # the *expected* cascade cost — every row pays the feature GEMM,
        # escalated rows additionally pay the exact pass — beats the
        # all-exact pass.  That reduces to rff_cost < hit_frac · exact.
        rff_on, rff_hit, rff_cost = False, 0.0, 0.0
        if req.rff:
            hit = bench.measured_rff_hit(req.n, req.d, req.accuracy)
            if hit is not None and hit > 0.0:
                from repro_torch.kernels import flash_rff

                rff_cost = flash_rff.modeled_query_cost_us(
                    req.q, req.d) / 1e6
                if rff_cost < hit * best_cand.step_time:
                    rff_on, rff_hit = True, hit

        staleness, background = _staleness_policy(req)
        p = ExecutionPlan(
            request=req,
            backend=backend,
            precision=best_tier,
            prune=prune,
            block_m=best_cand.block_m if backend == "flash" else None,
            block_n=best_cand.block_n if backend == "flash" else None,
            staleness_budget=staleness,
            stream_background=background,
            prewarm=True,
            modeled_cost_s=best_cand.step_time,
            bound=best_cand.bound,
            occupancy=occupancy,
            rff=rff_on,
            rff_hit_frac=rff_hit,
            modeled_rff_cost_s=rff_cost,
        ).check()
        sp.set(plan=p.plan_id, tier=p.precision,
               modeled_us=round(p.modeled_cost_s * 1e6, 2))
        obs.counter(
            "plan.decisions", "planner decisions",
            labels={"backend": p.backend, "tier": p.precision,
                    "prune": "off" if p.prune == "off" else "eps"},
        ).inc()
        obs.histogram("plan.modeled_s", "modeled cost of planned passes (s)",
                      lo=1e-9, hi=1e3).observe(p.modeled_cost_s)
    return p


def plan_for(n: int, d: int, q: int = DEFAULT_Q,
             accuracy: float = DEFAULT_ACCURACY, backend: str = "auto",
             stream: bool = False, rff: bool = False,
             bench: Optional[BenchModel] = None) -> ExecutionPlan:
    """Convenience wrapper over :func:`plan`."""
    return plan(PlanRequest(n=n, d=d, q=q, accuracy=accuracy,
                            backend=backend, stream=stream, rff=rff),
                bench=bench)


# ---------------------------------------------------------------------------
# Serve-config resolution (override precedence).
# ---------------------------------------------------------------------------


def _explicit_fields(cfg) -> set:
    """Config fields the user set away from their dataclass defaults.

    This is the documented override precedence: an explicitly-set knob
    (value != the field default) beats the plan; the plan beats the
    built-in default.  Setting a knob *to* its default value reads as
    "unset" — pass ``plan="off"`` to pin every knob by hand.
    """
    out = set()
    for f in dataclasses.fields(cfg):
        if f.default is not dataclasses.MISSING \
                and getattr(cfg, f.name) != f.default:
            out.add(f.name)
    return out


def resolve_config(cfg, n: int, d: int,
                   bench: Optional[BenchModel] = None):
    """Resolve a ``ServeConfig(plan="auto")`` into concrete knobs.

    Returns ``(resolved_config, ExecutionPlan)``.  Only knobs still at
    their dataclass defaults are overwritten by the plan; the request's
    accuracy target comes from ``cfg.accuracy_target`` (default
    f32-grade).  Works on any dataclass with the ServeConfig knob names —
    the serve layer is not imported here.
    """
    explicit = _explicit_fields(cfg)
    req = PlanRequest(
        n=n, d=d, q=cfg.max_batch,
        accuracy=getattr(cfg, "accuracy_target", None) or DEFAULT_ACCURACY,
        backend=cfg.backend if "backend" in explicit else "auto",
        stream=bool(getattr(cfg, "stream", False)),
        rff=(getattr(cfg, "rff", "off") != "off"
             and getattr(cfg, "method", "sdkde") in ("kde", "sdkde")),
    )
    p = plan(req, bench=bench)
    updates = {}

    def take(name, value):
        if name not in explicit:
            updates[name] = value

    take("backend", p.backend)
    take("prune", p.prune)      # "off" on the torch backend
    if p.backend == "flash":
        take("precision", p.precision)
        if p.block_m is not None:
            take("block_m", p.block_m)
            take("block_n", p.block_n)
    if p.rff:
        # the plan says the cascade pays for itself for this traffic —
        # fit the RFF state eagerly with the debias pass instead of on
        # the first cascade-routed request
        take("rff", "on")
    if req.stream:
        take("staleness_budget", p.staleness_budget)
        take("stream_background", p.stream_background)
    resolved = dataclasses.replace(cfg, **updates)
    obs.counter("plan.config_resolves",
                "ServeConfigs resolved through the planner").inc()
    return resolved, p


__all__ = [
    "TIER_RTOL", "TIER_ORDER", "EPS_SAFETY", "DEFAULT_ACCURACY",
    "FLASH_MIN_COLS", "DEFAULT_Q",
    "BenchModel", "default_bench_paths",
    "PlanRequest", "ExecutionPlan",
    "plan", "plan_for", "resolve_config",
]
