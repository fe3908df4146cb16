"""The port's execution planner (``repro_torch.plan``) against
``repro.plan``.

The two planners price candidates with different cost models (the H100's
and the TPU's), so the decision rules are held to parity with both
packages' ``autotune.shortlist`` and RFF cost replaced by the same stub:
then every decision (backend, tier, prune epsilon, tiles, staleness,
RFF) must match, with the port's backend names ("flash"/"torch" for
"pallas"/"jnp").  The port's golden fixture, ``resolve_config``'s
precedence and ``ServeConfig(plan="auto")`` end to end come after.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jautotune
from repro.kernels import flash_rff as jrff
from repro.plan import planner as jplanner
from repro.serve import ServeConfig as JServeConfig
from repro_torch import obs
from repro_torch import plan as plan_mod
from repro_torch.kernels import autotune, flash_rff
from repro_torch.plan import __main__ as plan_cli
from repro_torch.plan import planner
from repro_torch.serve import QueryRequest, ServeConfig, ServeEngine

BACKENDS = {"pallas": "flash", "jnp": "torch"}
CELLS = [
    {"cell": "pruning", "n": 262144, "d": 16, "epsilon": 1e-7,
     "block_n": 512, "occupancy": 0.2, "prune_rel_err": 1e-6},
    {"cell": "pruning", "n": 262144, "d": 16, "epsilon": 1e-5,
     "block_n": 512, "occupancy": 0.1, "prune_rel_err": 3e-4},
    {"cell": "rff_cascade", "n": 65536, "d": 2, "accuracy_target": 1e-2,
     "rff_hit_frac": 0.9},
]


class _Cand:
    def __init__(self, bm, bn, t):
        self.block_m, self.block_n, self.step_time = bm, bn, t
        self.bound = "stub"

    @property
    def blocks(self):
        return self.block_m, self.block_n


def _stub_shortlist(rows, cols, d, *, out_width=1, precision="f32",
                    occupancy_fn=None, **_):
    """Deterministic candidates: (128, 512) and (256, 1024), tiles every
    planner accepts, priced from the shape, tier and occupancy alone."""
    rate = {"f32": 3.0, "bf16x2": 2.0, "bf16": 1.0}[precision]
    out = []
    for bm, bn, k in ((128, 512, 1.0), (256, 1024, 0.9)):
        occ = occupancy_fn(bn) if occupancy_fn is not None else 1.0
        out.append(_Cand(bm, bn, 1e-12 * rows * cols * d * rate * k * occ
                         + 1e-6))
    return sorted(out, key=lambda c: c.step_time)


def _stub_rff_cost(rows, d, **_):
    return 1e-3 * rows * d


@pytest.fixture
def stubbed(monkeypatch):
    for mod in (jautotune, autotune):
        monkeypatch.setattr(mod, "shortlist", _stub_shortlist)
    for mod in (jrff, flash_rff):
        monkeypatch.setattr(mod, "modeled_query_cost_us", _stub_rff_cost)


REQUESTS = [
    (1024, 4, 4096, 1e-5, False, False),        # under FLASH_MIN_COLS
    (32768, 16, 4096, 1e-5, False, False),
    (32768, 16, 4096, 5e-4, False, False),
    (262144, 16, 4096, 1e-5, False, False),     # measured eps, exact target
    (262144, 16, 4096, 5e-2, True, False),      # eps promoted; streaming
    (262144, 16, 1024, 1e-3, True, False),
    (65536, 2, 4096, 1e-2, False, True),        # measured RFF hit fraction
    (65536, 2, 64, 1e-2, False, True),
    (65536, 2, 4096, 1e-4, False, True),        # target tighter than cell
]


@pytest.mark.parametrize("n,d,q,acc,stream,rff", REQUESTS)
def test_decision_rules_match_repro(stubbed, n, d, q, acc, stream, rff):
    jreq = jplanner.PlanRequest(n=n, d=d, q=q, accuracy=acc, stream=stream,
                                rff=rff)
    req = planner.PlanRequest(n=n, d=d, q=q, accuracy=acc, stream=stream,
                              rff=rff)
    jp = jplanner.plan(jreq, bench=jplanner.BenchModel([{"cells": CELLS}]))
    p = planner.plan(req, bench=planner.BenchModel([{"cells": CELLS}]))
    want = jp.as_dict()
    want["backend"] = BACKENDS[want["backend"]]
    assert p.as_dict() == want
    assert p.validate() == []


def test_explicit_backends_and_validation():
    small = planner.plan_for(1024, 4, backend="flash")
    assert small.backend == "flash" and small.prune == "off"
    big = planner.plan_for(65536, 4, backend="torch")
    assert big.backend == "torch" and big.block_m is None
    assert planner.plan_for(planner.FLASH_MIN_COLS - 1, 4).backend == "torch"
    assert planner.plan_for(planner.FLASH_MIN_COLS, 4).backend == "flash"
    bad = dataclasses.replace(big, prune=0.0)
    assert any("flash" in m for m in bad.validate())
    wide = dataclasses.replace(planner.plan_for(65536, 4), block_m=512)
    assert any("block_m" in m for m in wide.validate())
    with pytest.raises(ValueError):
        planner.PlanRequest(n=10, d=2, backend="pallas")


def test_default_model_plans_no_epsilon_and_no_rff():
    """No committed H100 cells: unmeasured regimes plan exact, and the
    fast tier is never planned by default (repro's rule)."""
    assert planner.default_bench_paths() == []
    assert planner.BenchModel.load()._prune_cells == []
    for _, req in plan_mod.golden_requests():
        p = planner.plan(req)
        assert p.prune in ("off", 0.0) and not p.rff


def test_the_planner_never_times_the_card(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the planner built a probe")
    monkeypatch.setattr(autotune, "_probe_time_fn", boom)
    autotune.clear_cache()
    for _, req in plan_mod.golden_requests():
        planner.plan(req, bench=plan_mod.golden_bench())
    assert autotune.probe_log() == []


# ---------------------------------------------------------------------------
# The golden fixture.
# ---------------------------------------------------------------------------


def test_golden_fixture_is_current():
    doc = plan_mod.load_golden()
    assert doc["meta"]["regen"] == "python -m repro_torch.plan --regen-golden"
    assert doc["plans"] == plan_mod.golden_entries()
    assert len(doc["plans"]) == len(plan_mod.GOLDEN_SHAPES) * len(
        plan_mod.GOLDEN_ACCURACIES)


def test_golden_fixture_pins_every_branch():
    plans = [e["plan"] for e in plan_mod.load_golden()["plans"].values()]
    assert {p["backend"] for p in plans} == {"flash", "torch", "ring"}
    assert {p["precision"] for p in plans} == {"f32", "bf16x2", "bf16"}
    assert any(isinstance(p["prune"], float) and p["prune"] > 0
               for p in plans)
    assert any(p.get("rff") for p in plans)
    assert any(p["staleness_budget"] > 0 for p in plans)


def test_golden_plans_validate():
    bench = plan_mod.golden_bench()
    for _, req in plan_mod.golden_requests():
        assert planner.plan(req, bench=bench).validate() == []


def test_regen_cli_reproduces_the_fixture(tmp_path, capsys):
    out = tmp_path / "golden.json"
    assert plan_cli.main(["--regen-golden", "--golden", str(out)]) == 0
    assert json.loads(out.read_text()) == plan_mod.load_golden()
    assert plan_cli.main(["--n", "32768", "--d", "16", "--accuracy",
                          "5e-4"]) == 0
    doc = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert doc["plan"]["precision"] == "bf16x2"
    with pytest.raises(SystemExit):
        plan_cli.main(["--d", "4"])


# ---------------------------------------------------------------------------
# resolve_config and the engine.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("explicit", [
    {}, {"precision": "bf16"}, {"block_m": 64, "block_n": 256},
    {"prune": "off"}, {"staleness_budget": 3, "stream": True},
    {"accuracy_target": 5e-4}, {"accuracy_target": 5e-2, "stream": True},
    {"rff": "off", "accuracy_target": 1e-2},
])
def test_resolve_config_precedence_matches_repro(stubbed, explicit):
    """Knobs left at their defaults are the plan's, explicit ones win: the
    same knobs are taken on both sides (the port's ServeConfig defaults
    block_n to 128 and the backend to "flash", repro's to 512 and "jnp",
    so those are compared as taken-or-not)."""
    jcfg = JServeConfig(plan="auto", **explicit)
    cfg = ServeConfig(plan="auto", device="cpu", **explicit)
    jres, jp = jplanner.resolve_config(
        jcfg, n=262144, d=16, bench=jplanner.BenchModel([{"cells": CELLS}]))
    res, p = planner.resolve_config(
        cfg, n=262144, d=16, bench=planner.BenchModel([{"cells": CELLS}]))
    for name in ("precision", "prune", "block_m", "block_n",
                 "staleness_budget", "stream_background", "rff"):
        jtaken = getattr(jres, name) != getattr(jcfg, name) or \
            name not in explicit
        taken = getattr(res, name) != getattr(cfg, name) or \
            name not in explicit
        assert jtaken == taken, name
        if name in explicit:
            assert getattr(res, name) == explicit[name]
    assert BACKENDS[jres.backend] == res.backend
    for name in ("precision", "prune", "block_m", "staleness_budget",
                 "stream_background", "rff"):
        assert getattr(res, name) == getattr(jres, name), name
    if "block_n" not in explicit:
        assert res.block_n == jres.block_n


def test_plan_auto_end_to_end():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4096, 4)).astype(np.float32)
    y = rng.standard_normal((300, 4)).astype(np.float32)
    prewarms = obs.counter("plan.prewarms")
    p0 = prewarms.value
    eng = ServeEngine(ServeConfig(plan="auto", min_batch=16, max_batch=256,
                                  device="cpu"))
    prep = eng.register("p", x, h=0.5)
    assert prep.plan is not None and prep.plan.backend == "flash"
    assert prep.config.block_m == prep.plan.block_m == prep.block_m
    assert prewarms.value == p0 + 1 and len(eng.cache) == 1
    ans = eng.query(QueryRequest(key="p", points=y))
    assert ans.plan_id == prep.plan.plan_id
    x64 = torch.as_tensor(prep.points, dtype=torch.float64)
    y64 = torch.as_tensor(y, dtype=torch.float64)
    want = (torch.exp(-torch.cdist(y64, x64) ** 2 / 0.5).sum(1)
            / (4096 * (2 * np.pi) ** 2 * 0.5 ** 4)).numpy()
    np.testing.assert_allclose(ans.value.double().numpy(), want,
                               rtol=planner.TIER_RTOL[prep.plan.precision],
                               atol=1e-6 * want.max())
    # a pin that departs from the planned tier is counted
    pins = obs.counter("serve.pin_overrides_plan")
    v0 = pins.value
    eng.query(QueryRequest(key="p", points=y[:5], precision="bf16"))
    eng.query(QueryRequest(key="p", points=y[:5],
                           precision=prep.plan.precision))
    assert pins.value == v0 + 1


def test_plan_auto_streaming_sets_the_staleness_policy():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2048, 3)).astype(np.float32)
    eng = ServeEngine(ServeConfig(plan="auto", stream=True,
                                  accuracy_target=5e-2, min_batch=16,
                                  max_batch=128, device="cpu"))
    prep = eng.register("s", x, h=0.5, prewarm=False)
    assert prep.config.staleness_budget == 2
    assert prep.config.stream_background
    assert len(eng.cache) == 0
    ans = eng.query(QueryRequest(key="s", points=x[:7]))
    assert ans.value.shape == (7,) and ans.plan_id == prep.plan.plan_id
