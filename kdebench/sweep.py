"""The knee of a serving cell: its offered rate swept on the card.

    python3 kdebench/sweep.py --workload mix16-1m.serve --seed <n> \
        --rates 10,15,20 --seconds 15

One process, one set-up: for each rate (requests a second) it offers the
cell's traffic for ``--seconds`` and prints what came back: rows a
second answered, latency p50 / p95 / max from when each request was due,
the p95 of the first and second half of the window (a backlog that grows
shows as a second half slower than the first), and the failures.  The
highest rate that is answered in full without a growing backlog is the
knee; a cell below it offers about four fifths of it.  No check runs
here: this sets the cell's rate once, the benchmark's runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(q * len(xs) + 0.5) - 1))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from kdebench import harness, loadgen
    from kdebench.spans import SpanLog

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 2
    _, config, traffic = harness.cell(harness.manifest(), args.workload)
    drv = harness.kind(harness.ROOT, traffic).Driver(
        config, traffic, args.seed, torch.device("cuda"), SpanLog(),
        loadgen.sync_device)
    drv.setup()
    print(json.dumps({"setup_s": time.perf_counter() - T_START,
                      "mean_rows": sum(drv.sizes) / len(drv.sizes)}))
    for rate in (float(r) for r in args.rates.split(",")):
        w = drv.window(args.seconds, rate=rate)
        lat = [1e3 * (r["t1"] - r["t0"]) for r in w.records]
        half = len(lat) // 2
        late = [1e3 * (r["sent"] - r["t0"]) for r in w.records]
        print(json.dumps({
            "rate": rate, "offered_rows_per_s":
                sum(r["rows"] for r in w.records) / args.seconds,
            "rows_per_s": sum(r["rows"] for r in w.records if r["ok"])
                / (w.t1 - w.t0),
            "requests": w.attempted, "failed": w.failed,
            "p50_ms": _pct(lat, 0.5), "p95_ms": _pct(lat, 0.95),
            "max_ms": max(lat), "p95_first_half_ms": _pct(lat[:half], 0.95),
            "p95_second_half_ms": _pct(lat[half:], 0.95),
            "generator_late_max_ms": max(late),
            "window_s": w.t1 - w.t0}), flush=True)
    drv.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
