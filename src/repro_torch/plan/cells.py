"""Measured H100 cells for the planner: the writer of
``plan/h100_cells.json``, the document ``BenchModel`` reads by default.

    python -m repro_torch.plan.cells --out PATH [--commit SHA]

It measures on the card and raises without one (no fallback: a cell is
a measurement of the card).  The document is ``{"meta": {...}, "cells":
[...]}``: ``meta`` names the card and its power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them, torch,
CUDA, the commit and the date; each cell carries the fields
``BenchModel`` reads, plus information.

``pruning`` cells (``repro``'s definitions, ``benchmarks/pruning_sweep.py``
acceptance sweep), one per epsilon in :data:`PRUNE_EPSILONS`:
  * ``occupancy`` — the visit lists' occupancy over the whole query set at
    the tiles the pruned path launches (:data:`BLOCK_M` × :data:`BLOCK_N`,
    the ops, estimator and serving default);
  * ``prune_rel_err`` — max relative error of the epsilon run against the
    epsilon = 0 run on :data:`ERR_QUERIES` queries (a skipped tile at
    epsilon 0 adds exactly 0, so this is the error pruning makes);
  * ``reorder_noise`` — the epsilon = 0 run against dense, f32 order noise;
  * ``cert_max_abs`` — the largest certified per-row bound of the
    unnormalized sums; the dense (B2) and pruned (B4) kernel ms (CUDA-graph
    replays, device time) on the whole query set.

``rff_cascade`` cells carry ``accuracy_target`` and ``rff_hit_frac``, the
fraction of that target's rows a ``ServeEngine(rff="on")`` answers at the
fast tier.

``BenchModel`` keys a regime by (n rounded up to a power of two, d) and
knows nothing of the data: two data sets of one key would let the
planner prune the one on the other's evidence.  So cells that share a
key are merged to the worst: the highest occupancy and pruning error for
(bucket, d, epsilon), the lowest hit fraction for (bucket, d, target);
``sources`` lists each regime merged, with its own numbers.  This keeps
``repro``'s planner rules and adds no knob.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.analysis import profile
from repro_torch.core.mixtures import (GaussianMixture, benchmark_mixture_16d,
                                       benchmark_mixture_1d, mixture_for_dim)
from repro_torch.plan.planner import CELLS_PATH, _bucket

SEED = 0
PRUNE_EPSILONS = (0.0, 1e-12, 1e-9, 1e-6)
ERR_QUERIES = 512                # repro's n_err_queries
BLOCK_M = BLOCK_N = 128
#: ``repro``'s acceptance traffic: (relative accuracy target, share of rows)
TRAFFIC = ((1e-2, 0.75), (5e-2, 0.15), (1e-3, 0.10))
#: Fields every cell carries, by kind: ``BenchModel``'s inputs and
#: ``repro``'s cell identity.
PRUNE_FIELDS = ("n", "m", "d", "h", "epsilon", "block_m", "block_n",
                "occupancy", "prune_rel_err")
RFF_FIELDS = ("n", "d", "accuracy_target", "rff_hit_frac")


# ---------------------------------------------------------------------------
# Data (the port's own copies; numpy or torch draws from SEED).
# ---------------------------------------------------------------------------


def clustered_mixture(d: int = 16, k: int = 64, spread: float = 4.0,
                      sigma: float = 0.05, seed: int = 0) -> GaussianMixture:
    """k tight, well-separated isotropic clusters in [0, spread]^d
    (``repro``'s ``benchmarks/pruning_sweep.clustered_mixture``)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(0.0, spread, size=(k, d))
    return GaussianMixture(means=means, stds=np.full((k,), sigma),
                           weights=np.full((k,), 1.0 / k))


def _mixture_draws(mix: GaussianMixture, n: int, m: int, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return mix.sample(n, gen), mix.sample(m, gen)


def _centres_draws(n: int, m: int, dev, k: int = 32, spread: float = 20.0,
                   d: int = 16):
    """``chip_smoke.py``'s clustered set (phase 4b): ``k`` centres uniform
    in [0, spread]^d, sigma 1, train then queries from one numpy stream."""
    rng = np.random.default_rng(SEED)
    centres = rng.uniform(0.0, spread, (k, d))

    def draw(count):
        lab = rng.integers(0, k, count)
        pts = centres[lab] + rng.standard_normal((count, d))
        return torch.as_tensor(pts.astype(np.float32), device=dev)

    return draw(n), draw(m)


@dataclasses.dataclass(frozen=True)
class PruneRegime:
    name: str
    n: int
    m: int
    d: int
    h: float
    draw: Callable[[int, int, torch.device], Tuple[torch.Tensor,
                                                    torch.Tensor]]
    source: str


@dataclasses.dataclass(frozen=True)
class RffRegime:
    """Rows sent at each of ``targets`` in turn; with ``shares``, one
    mixed stream whose first ``shares[i]`` of the rows carry
    ``targets[i]``, and the cell is the first target's rows (``repro``'s
    acceptance cell)."""

    name: str
    n: int
    d: int
    rows: int
    method: str
    h: Optional[float]               # None: Silverman's rule
    targets: Tuple[float, ...]
    mixture: Callable[[], GaussianMixture]
    pilot: int
    source: str
    shares: Optional[Tuple[float, ...]] = None
    features: int = 8192
    groups: int = 32
    batch: int = 4096

    def spans(self) -> List[Tuple[float, int, int]]:
        """(target, first row, end row) of each run."""
        if self.shares is None:
            return [(t, 0, self.rows) for t in self.targets]
        counts = [int(self.rows * s) for s in self.shares]
        counts[0] += self.rows - sum(counts)
        ends = np.cumsum(counts).tolist()
        return [(t, e - c, e) for t, c, e in zip(self.targets, counts, ends)]


PRUNE_REGIMES = (
    PruneRegime("repro acceptance", 262144, 32768, 16, 0.2,
                lambda n, m, dev: _mixture_draws(clustered_mixture(),
                                                 n, m, dev),
                "repro benchmarks/pruning_sweep.py acceptance: "
                "clustered_mixture(d 16, k 64, spread 4, sigma 0.05, seed 0)"),
    PruneRegime("main", 32768, 16384, 16, 0.725,
                lambda n, m, dev: _mixture_draws(benchmark_mixture_16d(),
                                                 n, m, dev),
                "the paper's 16-d mixture (chip_smoke.py phase 4)"),
    PruneRegime("clustered", 32768, 16384, 16, 0.5, _centres_draws,
                "32 centres uniform in [0, 20]^16, sigma 1 "
                "(chip_smoke.py phase 4b)"),
)

RFF_REGIMES = (
    RffRegime("repro acceptance", 262144, 2, 8192, "kde", None,
              tuple(t for t, _ in TRAFFIC), lambda: mixture_for_dim(2),
              2048, "repro benchmarks/rff_cascade.py acceptance: "
              "mixture_for_dim(2), Silverman h, traffic 75% @ 1e-2 / 15% @ "
              "5e-2 / 10% @ 1e-3; the cell is the 1e-2 rows",
              shares=tuple(s for _, s in TRAFFIC)),
    RffRegime("main", 32768, 16, 4096, "sdkde", 0.725, (1e-2, 1e-1),
              benchmark_mixture_16d, 256,
              "the paper's 16-d mixture, SD-KDE (chip_smoke.py phase 10c)"),
    RffRegime("fig3 1-d", 8192, 1, 4096, "kde", 0.3, (1e-2,),
              benchmark_mixture_1d, 256,
              "Fig. 3's 1-D mixture, KDE (chip_smoke.py phase 10c)"),
)


# ---------------------------------------------------------------------------
# Measurements.
# ---------------------------------------------------------------------------


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (want.abs() + 1e-30)).max())


def prune_cells(reg: PruneRegime, dev: torch.device) -> List[dict]:
    """One ``pruning`` cell per epsilon of :data:`PRUNE_EPSILONS`."""
    from repro_torch.kernels import flash_kde, flash_pruned, ops, spatial

    x, y = reg.draw(reg.n, reg.m, dev)
    h, bm, bn = reg.h, BLOCK_M, BLOCK_N
    inv = ops._inv2h2(h, dev)
    cols = ops.prepare_train_columns(x, block_n=bn, clustered=True,
                                     seed=SEED)
    ql = spatial.cluster_layout(y, spatial.assign(y, cols.index), bm,
                                bucket_rows=True)
    y_hi, y_lo, nrm_y, yrec = ops._cast_queries(ql.points, "f32")
    yq = y[:ERR_QUERIES]
    y_ops, xt_ops, nrm_yd, nrm_x = ops._prep_eval(x, y, bm, bn, "f32")
    dense_args = (y_ops[0], nrm_yd, xt_ops[0], nrm_x, inv)
    dense_ms = profile.graph_ms(lambda: flash_kde.flash_kde(
        *dense_args, block_m=bm, block_n=bn), calls=3, reps=3)
    dense_q = flash_kde.flash_kde(*dense_args, block_m=bm,
                                  block_n=bn)[:ERR_QUERIES, 0]

    def pruned_q(eps):
        return ops._pruned_eval_sums(yq, cols, h, eps, precision="f32",
                                     block_m=bm, block_n=bn)

    base = pruned_q(0.0)
    noise = _max_rel(base, dense_q)
    out = []
    for eps in PRUNE_EPSILONS:
        tm = spatial.tile_map(yrec, cols.meta, inv, eps, block_m=bm,
                              kind="kde")
        vl = spatial.visit_lists(tm.keep)
        pruned_ms = profile.graph_ms(lambda: flash_pruned.flash_kde_pruned(
            vl.counts, vl.tile_map, y_hi, nrm_y, cols.xt, cols.nrm_x, inv,
            y_lo, cols.xt_lo, block_m=bm, block_n=bn), calls=3, reps=3)
        out.append({
            "cell": "pruning", "regime": reg.name, "n": reg.n, "m": reg.m,
            "d": reg.d, "h": h, "epsilon": eps, "block_m": bm,
            "block_n": bn, "occupancy": vl.occupancy,
            "prune_rel_err": _max_rel(pruned_q(eps), base),
            "reorder_noise": noise,
            "cert_max_abs": float(tm.err_bound.max()),
            "dense_kernel_ms": dense_ms, "pruned_kernel_ms": pruned_ms,
            "err_queries": ERR_QUERIES, "source": reg.source})
    return out


def rff_cells(reg: RffRegime, dev: torch.device) -> List[dict]:
    """The ``rff_cascade`` cells of one regime: the hit fraction of a
    target's rows through ``ServeEngine(rff="on")``, and (information)
    the largest realized error against float64 less the row's bound."""
    from repro_torch import serve
    from repro_torch.core import bandwidth, kde
    from repro_torch.kernels import flash_rff

    mix = reg.mixture()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = mix.sample(reg.n, gen)
    y = mix.sample(reg.rows, gen)
    h = reg.h if reg.h is not None else float(
        bandwidth.silverman_bandwidth(x))
    eng = serve.ServeEngine(serve.ServeConfig(
        backend="flash", method=reg.method, prune="off", rff="on",
        rff_features=reg.features, rff_pilot=reg.pilot,
        rff_groups=reg.groups, min_batch=512, max_batch=reg.batch,
        device=dev.type))
    eng.register("cells", x, h=h)
    p_scale = eng.registry.get("cells").rff.state.p_scale
    exact = kde.sdkde_eval if reg.method == "sdkde" else kde.kde_eval
    want = exact(x.double(), y.double(), h)
    runs = []
    for target, lo, hi in reg.spans():
        hits = esc = 0
        slack = -math.inf
        for start in range(lo, hi, reg.batch):
            stop = min(start + reg.batch, hi)
            ans = eng.query(serve.QueryRequest(
                key="cells", points=y[start:stop], accuracy_target=target))
            hits += ans.rff_hits
            esc += ans.escalated
            real = flash_rff.realized_error(ans.value, want[start:stop],
                                            p_scale)
            slack = max(slack, float((real - ans.rel_err_bounds).max()))
        runs.append({"cell": "rff_cascade", "regime": reg.name, "n": reg.n,
                     "d": reg.d, "method": reg.method, "h": h,
                     "accuracy_target": target,
                     "rff_hit_frac": hits / (hi - lo), "rows": hi - lo,
                     "rff_hits": hits, "escalated": esc,
                     "worst_cert_slack": slack,
                     "rff_features": reg.features, "rff_pilot": reg.pilot,
                     "rff_groups": reg.groups, "source": reg.source})
    if reg.shares is None:
        return runs
    head = runs[0]
    head.update(traffic="/".join(f"{t:g}@{s:g}" for t, s in
                                 zip(reg.targets, reg.shares)),
                mixed_rows=reg.rows,
                mixed_rff_frac=sum(r["rff_hits"] for r in runs) / reg.rows,
                mixed_escalated=sum(r["escalated"] for r in runs),
                mixed_worst_cert_slack=max(r["worst_cert_slack"]
                                           for r in runs))
    return [head]


# ---------------------------------------------------------------------------
# Merging to one cell a key.
# ---------------------------------------------------------------------------


def cell_key(cell: dict) -> tuple:
    """The regime key ``BenchModel`` reads a cell under."""
    if cell["cell"] == "pruning":
        return ("pruning", _bucket(int(cell["n"])), int(cell["d"]),
                float(cell["epsilon"]))
    return ("rff_cascade", _bucket(int(cell["n"])), int(cell["d"]),
            float(cell["accuracy_target"]))


_WORST_PRUNE = ("prune_rel_err", "reorder_noise", "cert_max_abs")


def merge_cells(cells: Sequence[dict]) -> List[dict]:
    """One cell a key, the worst of those that share it (module
    docstring), in first-seen order: the fields of the cell of highest
    occupancy (lowest hit fraction), with the pruning error, reorder
    noise and certificate raised to the group's largest; ``sources``
    holds each one merged."""
    groups: Dict[tuple, List[dict]] = {}
    for c in cells:
        groups.setdefault(cell_key(c), []).append(c)
    out = []
    for key, group in groups.items():
        if key[0] == "pruning":
            if len({int(c["block_n"]) for c in group}) > 1:
                raise ValueError(f"cells of {key} were measured at "
                                 "different block_n")
            worst = dict(max(group, key=lambda c: float(c["occupancy"])))
            for f in _WORST_PRUNE:
                vals = [float(c[f]) for c in group if f in c]
                if vals:
                    worst[f] = max(vals)
        else:
            worst = dict(min(group, key=lambda c: float(c["rff_hit_frac"])))
        sources = []
        for c in group:
            sources.extend(c.get("sources") or [
                {k: v for k, v in c.items() if k != "sources"}])
        worst["sources"] = sources
        worst.pop("regime", None)
        out.append(worst)
    return out


# ---------------------------------------------------------------------------
# The document.
# ---------------------------------------------------------------------------


def card_line() -> str:
    """``name, power.limit`` of card 0, as nvidia-smi prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _commit() -> Optional[str]:
    try:
        res = subprocess.run(["git", "rev-parse", "HEAD"],
                             cwd=Path(__file__).parent, capture_output=True,
                             text=True, timeout=30)
    except OSError:
        return None
    return res.stdout.strip() or None


def measure(device: str = "cuda", *, commit: Optional[str] = None) -> dict:
    """Measure every regime on the card; the document to write."""
    dev = device_mod.resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("measured cells are measurements of the card: "
                           f"device {device!r} is not a CUDA device")
    name, limit = (s.strip() for s in card_line().split(",", 1))
    cells: List[dict] = []
    for reg in PRUNE_REGIMES:
        cells.extend(prune_cells(reg, dev))
    for reg in RFF_REGIMES:
        cells.extend(rff_cells(reg, dev))
    meta = {
        "card": name, "power_limit": limit,
        "device_name": torch.cuda.get_device_name(dev),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "commit": commit or _commit(),
        "date": datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ"),
        "writer": "python -m repro_torch.plan.cells",
        "epsilons": list(PRUNE_EPSILONS), "err_queries": ERR_QUERIES,
        "blocks": [BLOCK_M, BLOCK_N], "seed": SEED,
    }
    return {"meta": meta, "cells": merge_cells(cells)}


def write(doc: dict, path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1, sort_keys=False) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.plan.cells",
        description="Measure the planner's cells on the card and write "
                    "them as JSON.")
    ap.add_argument("--out", type=Path, default=CELLS_PATH,
                    help=f"output path (default {CELLS_PATH})")
    ap.add_argument("--commit", default=None,
                    help="the commit measured (default: git rev-parse HEAD "
                         "where the checkout is a git repository)")
    args = ap.parse_args(argv)
    doc = measure(commit=args.commit)
    write(doc, args.out)
    print(f"wrote {len(doc['cells'])} cells measured on "
          f"{doc['meta']['card']} ({doc['meta']['power_limit']}) to "
          f"{args.out}")
    return 0


__all__ = ["SEED", "PRUNE_EPSILONS", "ERR_QUERIES", "BLOCK_M", "BLOCK_N",
           "TRAFFIC", "PRUNE_FIELDS", "RFF_FIELDS", "PRUNE_REGIMES",
           "RFF_REGIMES", "PruneRegime", "RffRegime", "clustered_mixture",
           "prune_cells", "rff_cells", "cell_key",
           "merge_cells", "card_line", "measure", "write", "main"]


if __name__ == "__main__":
    sys.exit(main())
