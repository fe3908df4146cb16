"""Run one cell of the port's benchmark on the card this process sees.

    python3 kdebench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  It makes its inputs on the card from
``--seed``, builds or loads the program's kernels (the program keeps them
in ``build/repro_torch_kernels/`` of the checkout; other caches go to
``build/kdebench_cache/``), warms the cell's shapes, measures for
``--seconds`` and checks the outputs against the float64 reference.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit; the same numbers are the last lines of standard error.

Without a card, or with fewer cards than the cell asks for, it exits 2
and prints no result.  It exits non-zero, with no result, if JAX or the
JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = ROOT / "build" / "kdebench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from kdebench import harness

    chips = next((w["chips"] for w in harness.manifest()["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result, lines = harness.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
