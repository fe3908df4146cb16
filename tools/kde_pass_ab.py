#!/usr/bin/env python3
"""Time the dense KDE-pass kernels B2, B5 and B6 of checkouts of the port
on one card, in turns.

    python3 tools/kde_pass_ab.py build/parent . . build/parent [--wide]

Run from the repository root on a machine with one NVIDIA GPU and nvcc.
Each argument is a directory holding the port under ``src/``: this
repository, or another commit unpacked there with ``git archive``.  For
each, in the order given, a process of its own builds that checkout's
kernels (into its own ``build/``) and, at every tier, holds B2
(``flash_kde``), B5 (``flash_laplace``) and B6 (``sq_moment``) against
their plain versions (``chip_smoke.check_kernel``) and times them with
CUDA-graph replays (``chip_smoke.graph_ms``): at the main shape (32768
train points of the paper's 16-d mixture against themselves, h 0.78,
blocks 128) and at one 128-row serving request against the same train
points; with ``--wide`` also at d = 24 and 64 (32768 normal points
against themselves, h 0.5 sqrt(d): the DMAX 32 and 64 builds).  Prints
the card's name and power limit, one JSON line per checkout and a table
of device ms, with the bound (``chip_smoke.bound_ms``) beside each.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("flash_kde", "flash_laplace", "sq_moment")
H, BLOCK = 0.78, 128
WIDE_DS = (24, 64)


def one(checkout: Path, wide: bool) -> dict:
    """Build and time B2, B5 and B6 of the port under ``checkout``/src."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(checkout / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.core import mixtures
    from repro_torch.kernels import _build, ops

    if Path(_build.__file__).resolve().parents[3] != checkout:
        raise RuntimeError(f"imported the port from {_build.__file__}, not "
                           f"from {checkout}")
    _build.build(("flash_kde", "flash_laplace"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    x = mixtures.benchmark_mixture_16d().sample(cs.N_TRAIN, gen)
    cases = [("main", x, x, H), ("request", x, x[:cs.REQUEST_ROWS], H)]
    for d in WIDE_DS if wide else ():
        xw = torch.randn(cs.N_TRAIN, d, generator=gen, device="cuda")
        cases.append((f"d={d}", xw, xw, 0.5 * d ** 0.5))
    out = {"checkout": str(checkout)}
    for label, x, y, h in cases:
        for tier in cs.TIERS:
            opnds = cs.kernel_operands(ops, x, y, tier, BLOCK, BLOCK, h)
            for name in KERNELS:
                c = opnds[name]
                err = cs.check_kernel(name, c, tier, h,
                                      f"{label} m={y.shape[0]}")
                bms, _ = cs.bound_ms(c["kind"], tier, c["pairs"],
                                     x.shape[1], c["moved"])
                out[f"{name} {label} {tier}"] = {
                    "ms": cs.graph_ms(c["kernel"]), "bound_ms": bms,
                    "max_abs_err": err["max_abs_err"]}
            del opnds
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="*", type=Path)
    ap.add_argument("--wide", action="store_true",
                    help="also time d = 24 and 64")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.one.resolve(), args.wide)), flush=True)
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
             str(checkout.resolve())] + ["--wide"] * args.wide,
            capture_output=True, text=True, timeout=1800)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    keys = [k for k in runs[0] if k != "checkout"]
    print("kernel shape tier | " + " | ".join(
        str(c) for c in args.checkouts) + " | bound (device ms)")
    for k in keys:
        print(f"{k} | " + " | ".join(f"{r[k]['ms']:.4f}" for r in runs)
              + f" | {runs[0][k]['bound_ms']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
