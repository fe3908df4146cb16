"""Readings that set the limits of a cell's check, on the card.

    python3 kdebench/control.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds <s> [--variants program,bf16x2,tf32] \
        [--out <file.json>]

In one process (the set-up that every run pays is paid once), for each
seed it drives the cell through ``harness.run`` with a short window and
prints the numbers the check compares:

* ``program``: the program as the configuration states (float32): the
  lower readings;
* ``bf16x2``: the program with its own next tier below float32 switched
  on (``precision="bf16x2"``, for the fit too): the control, the path a
  change to the program would take;
* ``tf32``: the float32 reference with TF32 products put in the
  program's place, on the same inputs: float32 with TF32 on, kept beside
  the control.

The benchmark's own runs never run this.  With ``--out`` every reading is
also written as JSON.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def tf32_reference(kind: str):
    """The float32 reference with TF32 products, in the program's place."""
    import torch

    from kdebench.reference import sdkde as ref

    kw = {"dtype": torch.float32, "tf32": True}
    if kind == "task":
        return lambda x, y: ref.sdkde(x, y, **kw)[0]

    def served(x, y):
        h = ref.sdkde_bandwidth(x)
        x_sd, _ = ref.score_shift(x, h, **kw)
        return ref.kde(x_sd, y, h, **kw)[0]

    return served


def readings(workload: str, seeds, control_seeds, seconds: float,
             only=("program", "bf16x2", "tf32")):
    from kdebench import harness

    _, config, traffic = harness.cell(harness.manifest(), workload)
    lower_tier = {"estimator": {**config["estimator"],
                                "precision": "bf16x2"}}
    variants = [("program", seeds, {}),
                ("bf16x2", control_seeds, {"config_override": lower_tier}),
                ("tf32", control_seeds,
                 {"check_kw": {"reference": tf32_reference(traffic["kind"])}})]
    for name, seed_list, kw in variants:
        if name not in only:
            continue
        for seed in seed_list:
            t0 = time.perf_counter()
            result, lines = harness.run(workload, seed, seconds, False,
                                        t_start=t0, **kw)
            yield {"variant": name, "seed": seed,
                   "numbers": {k: v["value"]
                               for k, v in result["checks"].items()},
                   "correct": result["correct"],
                   "attempted": result["attempted"],
                   "run_s": time.perf_counter() - t0,
                   "work": next(x for x in lines
                                if x.startswith("check work:"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--variants", default="program,bf16x2,tf32")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("the readings need a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",")]
    out = []
    for r in readings(args.workload, seeds, control, args.seconds,
                      args.variants.split(",")):
        out.append(r)
        print(json.dumps(r), flush=True)
        if args.out:
            with open(args.out + ".partial", "a") as f:
                f.write(json.dumps(r) + "\n")
    by = {}
    for r in out:
        for k, v in r["numbers"].items():
            by.setdefault((r["variant"], k), []).append(v)
    summary = {f"{v}.{k}": {"min": min(xs), "max": max(xs), "n": len(xs)}
               for (v, k), xs in sorted(by.items())}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "readings": out,
             "summary": summary, "device": torch.cuda.get_device_name(0)},
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
