#!/usr/bin/env python3
"""Check and time the score-pass kernels B1 and B3 of checkouts of the
port on one card, in turns.

    python3 tools/score_pass_ab.py build/parent . . build/parent

Run from the repository root on a machine with one NVIDIA GPU and nvcc.
Each argument is a directory holding the port under ``src/``: this
repository, or another commit unpacked there with ``git archive``.  For
each, in the order given, a process of its own builds that checkout's
``flash_score`` and ``flash_pruned`` (into its own ``build/``), prints
the score pass's registers and spills (ptxas) and its tensor-core
instructions, those on BF16 and on TF32 (cuobjdump), then at f32
holds B1 (``flash_score``) and B3 (``flash_score_pruned``) against their
plain versions (``chip_smoke.check_kernel``: bar times each value's
absolute mass) and times them with CUDA-graph replays
(``chip_smoke.graph_ms``): at the main shape (32768 points of the
paper's 16-d mixture against themselves, h 0.78, blocks 128; B3 on the
mixture's visit lists at epsilon 0, occupancy ~1) and on the clustered
set (B3 skipping most tiles); B1 also at d = 1, 4, 8, 24 and 64
(32768 normal points, h 0.5 sqrt(d): every DMAX build).  Untimed, it
checks the ragged shape at blocks 128, (96, 100) and (64, 200) and two
launches equal bit for bit.  Prints the card's
name and power limit, one JSON line per checkout and a table of device
ms with the bound (``chip_smoke.bound_ms``) beside each.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
H, BLOCK = 0.78, 128
WIDE_DS = (1, 4, 8, 24, 64)
TIER = "f32"


def _sass_summary(cs, _build) -> dict:
    """Registers / spill bytes (ptxas) and tensor-core instructions, on
    BF16 and on TF32 (cuobjdump), of each score-pass instantiation."""
    out = {}
    for name in ("flash_score", "flash_pruned"):
        ptxas = _build.BUILD_DIR / f"{name}.ptxas.txt"
        if ptxas.exists():
            for k, r, sp in cs.ptxas_summary(ptxas.read_text()):
                if k.startswith("score_pass<"):
                    out.setdefault(k, {}).update(registers=r, spill=sp)
        counts = cs.tensor_op_counts(_build, name)
        for k, v in (counts or {}).items():
            if k.startswith("score_pass<"):
                out.setdefault(k, {}).update(tensor=v[0], bf16=v[1],
                                             tf32=v[2])
    return out


def one(checkout: Path) -> dict:
    """Build, check and time B1 and B3 of the port under ``checkout``."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(checkout / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.core import mixtures
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import spatial as sp

    if Path(_build.__file__).resolve().parents[3] != checkout:
        raise RuntimeError(f"imported the port from {_build.__file__}, not "
                           f"from {checkout}")
    _build.build(("flash_score", "flash_pruned"))
    out = {"checkout": str(checkout), "sass": _sass_summary(cs, _build)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    mix = mixtures.benchmark_mixture_16d()

    def record(label, name, c, h, d):
        err = cs.check_kernel(name, c, TIER, h, label)
        bms, _ = cs.bound_ms(c["kind"], TIER, c["pairs"], d, c["moved"])
        out[f"{name} {label} {TIER}"] = {
            "ms": cs.graph_ms(c["kernel"]), "bound_ms": bms,
            "max_err_over_mass": err["max_rel_err"],
            **({"occupancy": c["occupancy"]} if "occupancy" in c else {})}

    x = mix.sample(cs.N_TRAIN, gen)
    index = sp.build_index(x, seed=cs.SEED)
    cx, _, _ = cs.clustered_set(gen.device)
    cindex = sp.build_index(cx, seed=cs.SEED)
    c = cs.kernel_operands(ops, x, x, TIER, BLOCK, BLOCK, H)
    record("main", "flash_score", c["flash_score"], H, cs.D)
    c = cs.pruned_operands(ops, sp, x, x, TIER, BLOCK, BLOCK, H, index)
    record("main", "flash_score_pruned", c["flash_score_pruned"], H, cs.D)
    c = cs.pruned_operands(ops, sp, cx, cx, TIER, BLOCK, BLOCK, cs.CLU_H,
                           cindex)
    record("clustered", "flash_score_pruned", c["flash_score_pruned"],
           cs.CLU_H, cs.D)
    del c
    for d in WIDE_DS:
        xw = torch.randn(cs.N_TRAIN, d, generator=gen, device="cuda")
        hw = 0.5 * math.sqrt(d)
        c = cs.kernel_operands(ops, xw, xw, TIER, BLOCK, BLOCK, hw)
        record(f"d={d}", "flash_score", c["flash_score"], hw, d)
        del c
    n, m, d = cs.SMALL
    xs, ys = mix.sample(n, gen), mix.sample(m, gen)
    sindex = sp.build_index(xs, seed=cs.SEED)
    for bm, bn in ((BLOCK, BLOCK),) + cs.ODD_BLOCKS:
        c = dict(cs.kernel_operands(ops, xs, ys, TIER, bm, bn, H),
                 **cs.pruned_operands(ops, sp, xs, ys, TIER, bm, bn, H,
                                      sindex,
                                      empty_row=1 if bm == BLOCK else None))
        for name in cs.SCORE_PASSES:
            cs.check_kernel(name, c[name], TIER, H,
                            f"ragged n={n} blocks {bm} x {bn}")
            a, b = c[name]["kernel"](), c[name]["kernel"]()
            cs.sync()
            if not torch.equal(a, b):
                raise AssertionError(f"{name} {TIER}: two launches on the "
                                     "same inputs differ")
        del c
    out["checks"] = "passed"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="*", type=Path)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.one.resolve())), flush=True)
        return 0
    if not args.checkouts:
        ap.error("name at least one checkout")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    runs = []
    for checkout in args.checkouts:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one",
             str(checkout.resolve())],
            capture_output=True, text=True, timeout=1800)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    keys = [k for k in runs[0] if k not in ("checkout", "sass", "checks")]
    print("kernel shape tier | " + " | ".join(
        str(c) for c in args.checkouts) + " | bound (device ms)")
    for k in keys:
        print(f"{k} | " + " | ".join(f"{r[k]['ms']:.4f}" for r in runs)
              + f" | {runs[0][k]['bound_ms']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
