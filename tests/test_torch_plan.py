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
import pathlib
import re

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
from repro_torch.plan import cells, planner
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
    """Unmeasured regimes plan exact, and the fast tier is never planned
    without a measured hit fraction (repro's rule), on a model with no
    cells."""
    empty = planner.BenchModel([])
    assert empty._prune_cells == [] and empty._rff_cells == []
    for _, req in plan_mod.golden_requests():
        p = planner.plan(req, bench=empty)
        assert p.prune in ("off", 0.0) and not p.rff


# ---------------------------------------------------------------------------
# The committed H100 cells (plan/h100_cells.json, plan/cells.py).
# ---------------------------------------------------------------------------


def _committed() -> dict:
    return json.loads(planner.CELLS_PATH.read_text())


def test_default_bench_paths_name_the_committed_cells():
    assert planner.default_bench_paths() == [planner.CELLS_PATH]
    assert planner.CELLS_PATH.name == "h100_cells.json"
    assert planner.CELLS_PATH.parent == pathlib.Path(planner.__file__).parent
    doc = _committed()
    bench = planner.BenchModel.load()
    assert len(bench._prune_cells) == sum(
        c["cell"] == "pruning" for c in doc["cells"]) > 0
    assert len(bench._rff_cells) == sum(
        c["cell"] == "rff_cascade" for c in doc["cells"]) > 0


def test_committed_cells_schema():
    """``meta`` names an NVIDIA card and its power limit, every cell has
    the fields BenchModel reads, and a key holds at most one cell."""
    doc = _committed()
    meta = doc["meta"]
    assert "NVIDIA" in meta["card"]
    assert re.fullmatch(r"\d+(\.\d+)? W", meta["power_limit"])
    assert meta["writer"] == "python -m repro_torch.plan.cells"
    for key in ("torch", "cuda", "commit", "date"):
        assert meta[key]
    keys = [cells.cell_key(c) for c in doc["cells"]]
    assert len(keys) == len(set(keys))
    for c in doc["cells"]:
        fields = (cells.PRUNE_FIELDS if c["cell"] == "pruning"
                  else cells.RFF_FIELDS)
        assert all(f in c for f in fields), (c, fields)
        assert c["sources"]
        if c["cell"] == "pruning":
            assert 0.0 < c["occupancy"] <= 1.0 and c["prune_rel_err"] >= 0
            if c["epsilon"] == 0.0:
                assert c["prune_rel_err"] == 0.0
        else:
            assert 0.0 <= c["rff_hit_frac"] <= 1.0
    # every regime of the writer is in the document, merged or not
    regimes = {s["regime"] for c in doc["cells"] for s in c["sources"]}
    assert regimes >= {r.name for r in cells.PRUNE_REGIMES} | {
        r.name for r in cells.RFF_REGIMES}


def _prune_cell(n, eps, occ, err, regime, noise=1e-7):
    return {"cell": "pruning", "regime": regime, "n": n, "m": 1024,
            "d": 16, "h": 0.5, "epsilon": eps, "block_m": 128,
            "block_n": 128, "occupancy": occ, "prune_rel_err": err,
            "reorder_noise": noise}


def _rff_cell(n, target, hit, regime):
    return {"cell": "rff_cascade", "regime": regime, "n": n, "d": 2,
            "accuracy_target": target, "rff_hit_frac": hit}


def test_merge_keeps_the_worst_of_a_key():
    merged = cells.merge_cells([
        _prune_cell(32768, 1e-9, 0.03, 2e-6, "clustered", noise=3e-7),
        _prune_cell(30000, 1e-9, 0.55, 1e-8, "main"),
        _prune_cell(32768, 0.0, 0.6, 0.0, "main"),
        _prune_cell(262144, 1e-9, 0.02, 1e-9, "acceptance"),
        _rff_cell(65536, 1e-2, 0.9, "a"),
        _rff_cell(40000, 1e-2, 0.7, "b"),
        _rff_cell(65536, 1e-1, 0.95, "a"),
    ])
    assert len(merged) == 5
    by_key = {cells.cell_key(c): c for c in merged}
    worst = by_key[("pruning", 32768, 16, 1e-9)]
    assert worst["occupancy"] == 0.55 and worst["prune_rel_err"] == 2e-6
    assert worst["reorder_noise"] == 3e-7
    assert [s["regime"] for s in worst["sources"]] == ["clustered", "main"]
    assert "regime" not in worst
    assert by_key[("pruning", 262144, 16, 1e-9)]["occupancy"] == 0.02
    low = by_key[("rff_cascade", 65536, 2, 1e-2)]
    assert low["rff_hit_frac"] == 0.7
    assert {s["regime"] for s in low["sources"]} == {"a", "b"}
    # merging merged cells again changes nothing
    assert cells.merge_cells(merged) == merged
    bench = planner.BenchModel([{"cells": merged}])
    assert bench.occupancy_record(32768, 16, 1e-9) == (128, 0.55)
    assert bench.measured_rel_err(32768, 16, 1e-9) == 2e-6
    assert bench.measured_rff_hit(65536, 2, 1e-2) == 0.7
    with pytest.raises(ValueError, match="block_n"):
        cells.merge_cells([_prune_cell(32768, 0.0, 0.5, 0.0, "a"),
                           dict(_prune_cell(32768, 0.0, 0.5, 0.0, "b"),
                                block_n=512)])


def test_repro_and_the_port_read_the_committed_cells_alike():
    doc = _committed()
    jb, tb = jplanner.BenchModel([doc]), planner.BenchModel([doc])
    for c in doc["cells"]:
        n, d = c["n"], c["d"]
        assert tb.measured_epsilons(n, d) == jb.measured_epsilons(n, d)
        if c["cell"] == "pruning":
            eps = c["epsilon"]
            assert tb.occupancy_record(n, d, eps) == \
                jb.occupancy_record(n, d, eps)
            assert tb.measured_rel_err(n, d, eps) == \
                jb.measured_rel_err(n, d, eps)
        else:
            for acc in (c["accuracy_target"], 1.0, 1e-6):
                assert tb.measured_rff_hit(n, d, acc) == \
                    jb.measured_rff_hit(n, d, acc)


def test_default_plans_spend_only_measured_epsilons():
    """At every committed pruning regime and a ladder of targets, the
    default model's plan is valid, and an epsilon > 0 is one the cells
    measured with an error inside the target."""
    bench = planner.BenchModel.load()
    for c in _committed()["cells"]:
        if c["cell"] != "pruning":
            continue
        for acc in (1e-5, 5e-4, 5e-2):
            p = planner.plan_for(c["n"], c["d"], accuracy=acc)
            assert p.validate() == []
            if not isinstance(p.prune, str) and p.prune > 0:
                assert p.prune in bench.measured_epsilons(c["n"], c["d"])
                assert bench.measured_rel_err(c["n"], c["d"],
                                              p.prune) <= acc


def test_the_writer_refuses_the_cpu(monkeypatch, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        cells.measure("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cells.main(["--out", str(tmp_path / "cells.json")])
    assert not (tmp_path / "cells.json").exists()


def test_the_writers_clustered_mixture_is_repros():
    from benchmarks.pruning_sweep import clustered_mixture as jclustered

    mine, theirs = cells.clustered_mixture(), jclustered()
    np.testing.assert_array_equal(mine.means, np.asarray(theirs.means))
    np.testing.assert_array_equal(mine.stds, np.asarray(theirs.stds))
    np.testing.assert_array_equal(mine.weights, np.asarray(theirs.weights))


@pytest.mark.parametrize("kind,index", [("prune", 0), ("prune", 1),
                                        ("prune", 2), ("rff", 0),
                                        ("rff", 1), ("rff", 2)])
def test_the_writers_cells_on_the_cpu_at_a_tiny_size(monkeypatch, kind,
                                                     index):
    """Each regime's measurement at a tiny size through the plain
    versions (the kernel times stubbed: they are the card's): the fields
    BenchModel reads, occupancy in (0, 1], no pruning error at epsilon 0,
    and one cell a target."""
    monkeypatch.setattr(cells.profile, "graph_ms",
                        lambda fn, calls=10, reps=5: 0.0)
    dev = torch.device("cpu")
    if kind == "prune":
        reg = dataclasses.replace(cells.PRUNE_REGIMES[index], n=2048,
                                  m=600)
        got = cells.prune_cells(reg, dev)
        assert [c["epsilon"] for c in got] == list(cells.PRUNE_EPSILONS)
        for c in got:
            assert all(f in c for f in cells.PRUNE_FIELDS)
            assert 0.0 < c["occupancy"] <= 1.0
        assert got[0]["prune_rel_err"] == 0.0
        assert got[0]["reorder_noise"] < 1e-5
        occ = [c["occupancy"] for c in got]
        assert occ == sorted(occ, reverse=True)
    else:
        reg = dataclasses.replace(cells.RFF_REGIMES[index], n=2048,
                                  rows=1100, batch=512, features=512,
                                  pilot=16)
        got = cells.rff_cells(reg, dev)
        assert [c["accuracy_target"] for c in got] == (
            [reg.targets[0]] if reg.shares else list(reg.targets))
        for c in got:
            assert all(f in c for f in cells.RFF_FIELDS)
            assert c["rff_hits"] + c["escalated"] == c["rows"]
        if reg.shares:
            assert got[0]["rows"] == reg.spans()[0][2]
            assert got[0]["mixed_rows"] == reg.rows


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
