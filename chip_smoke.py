#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                # the default run, one card
    python3 chip_smoke.py --paper-scale  # plus 1,048,576 x 16 train /
                                         # 131,072 queries, timed

Run from the repository root.  Phases, each printing its lines:

  1. device       the card's name and power limit (nvidia-smi);
  2. build        both CUDA kernels compiled with nvcc for sm_90a;
  3. kernels      each kernel (B1 flash_score, B2 flash_kde) against its
                  plain PyTorch version on the card, every tier, at a
                  ragged small shape and at the main path's shape;
  4. main path    32768 x 16 train and 16384 queries from the paper's 16-d
                  mixture: SDKDE(backend="flash").fit(x).evaluate(y) and a
                  ServeEngine answering ragged QueryRequests and one
                  query_many, checked against the "torch" backend on the
                  card and both against float64 on 2048 queries; the
                  kernels' launch counters must rise;
  5. timings      CUDA-event medians of each kernel and its plain version
                  at the main path's shape, beside the least time the card
                  could take (the bound);
  6. paper scale  (--paper-scale only) fit + evaluate at the paper's size.

Before the last line it prints one JSON object ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises and exits non-zero with no result line, as does a machine with no
CUDA device or a directory without the repository's ``src/``.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
N_TRAIN, N_QUERY, D = 32768, 16384, 16
SMALL = (1000, 300, 16)                 # ragged (n, m, d)
TIERS = ("f32", "bf16x2", "bf16")
TIER_BAR = {"f32": 1e-5, "bf16x2": 5e-4, "bf16": 5e-2}
SERVE_SIZES = (1, 3, 17, 100, 333, 640, 1000, 2048, 2500, 4096)
N_F64 = 2048                            # queries held against float64
MANY_SIZES = (7, 120, 900, 2000)
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): FP32
# outside the tensor cores, bf16 on the tensor cores, HBM3 bandwidth.
# exp runs on the SFU: 16 results per clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) at
# 132 SMs and the 1980 MHz boost clock.
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def f32_bar(pts, inv2h2: float) -> float:
    """rtol at the f32 tier: 1e-5, or the norm-trick error model
    8·eps·max‖x‖²/(2h²) where larger (both sides round the Gram
    differently and 1/(2h²) amplifies it inside exp)."""
    eps = torch.finfo(torch.float32).eps
    return max(1e-5, 8 * eps * float((pts * pts).sum(1).max()) * inv2h2)


def compare(got, want, rtol: float, what: str) -> dict:
    """allclose(rtol, atol = 1e-6·peak) on the card; raises on a miss."""
    got = got.double()
    want = want.double()
    peak = float(want.abs().max())
    atol = 1e-6 * peak
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    excess = float((diff - (atol + rtol * want.abs())).max())
    big = want.abs() > atol / rtol
    rel = float((diff[big] / want.abs()[big]).max()) if bool(big.any()) else 0.0
    out = {"max_abs_err": float(diff.max()), "max_rel_err": rel,
           "rtol": rtol, "atol": atol}
    log(f"  {what}: max rel err {rel:.3e} (bar rtol {rtol:.1e}, atol "
        f"{atol:.2e}), max abs err {out['max_abs_err']:.3e}")
    if excess > 0:
        raise AssertionError(f"{what}: outside the bar by {excess:.3e}")
    return out


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(kernel: str, tier: str, rows: int, cols: int, d: int,
             moved: int) -> tuple:
    """(ms, "bytes" | "operations"): the larger of the bytes the call must
    move over the HBM rate and its operations over their peak rates."""
    pairs = rows * cols
    gemm = 2 * d + (2 * (d + 1) if kernel == "flash_score" else 0)
    gemm *= 4 if tier == "bf16x2" else 1
    elementwise = 3 if kernel == "flash_score" else 4
    if tier == "f32":
        ops_s = pairs * (gemm + elementwise) / PEAK_F32
    else:
        ops_s = max(pairs * gemm / PEAK_BF16,
                    pairs * elementwise / PEAK_F32)
    ops_s = max(ops_s, pairs / PEAK_EXP)
    bytes_s = moved / PEAK_BYTES
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


# ---------------------------------------------------------------------------


def phase_device() -> tuple:
    log("== phase 1: device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"  torch.cuda.get_device_name: {name}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    log(smi)
    return name, smi


def ptxas_summary(text: str) -> list:
    """(kernel<tier,DMAX>, registers, spill-store bytes) per instantiation
    from ptxas's -v report."""
    out, fn, spill = [], None, 0
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            t = re.search(r"(\w+?_kernel)I(f|13__nv_bfloat16)Lb([01])ELi(\d+)E",
                          fn)
            key = fn if t is None else (
                f"{t.group(1)}<"
                f"{'f32' if t.group(2) == 'f' else 'bf16'}"
                f"{'x2' if t.group(3) == '1' else ''},{t.group(4)}>")
            out.append((key, int(m.group(1)), spill))
            fn = None
    return out


def phase_build(_build) -> None:
    log("== phase 2: build")
    t0 = time.perf_counter()
    secs = _build.build()
    for name in _build.SOURCES:
        lib = _build.library_path(name)
        if not lib.exists():
            raise AssertionError(f"{name}: no library at {lib}")
        log(f"  {name}: built {lib.name} in "
            f"{secs.get(name, 0.0):.1f} s (0 = already built)")
        ptxas = _build.BUILD_DIR / f"{name}.ptxas.txt"
        if ptxas.exists():
            log("    registers / spill-store bytes per instantiation: "
                + ", ".join(f"{k} {r}/{sp}" for k, r, sp in
                            ptxas_summary(ptxas.read_text())))
    log(f"  build wall time {time.perf_counter() - t0:.1f} s")


def kernel_operands(ops, x, y, precision, block_m, block_n, h):
    """Operands of both kernels at one tier, as the ops wrappers make
    them, plus the kernel and plain callables."""
    from repro_torch.kernels import flash_kde as fk
    from repro_torch.kernels import flash_score as fs

    inv = ops._inv2h2(h, x.device)
    xp = ops._pad_to(x, math.lcm(block_m, block_n))
    x_ops, xt_ops, xaug_ops, nrm, xrec = ops._score_operands(xp, precision)
    s_args = (x_ops[0], nrm, xt_ops[0], xaug_ops[0], inv, x_ops[1],
              xt_ops[1], xaug_ops[1])
    y_ops, xt2, nrm_y, nrm_x = ops._prep_eval(x, y, block_m, block_n,
                                              precision)
    k_args = (y_ops[0], nrm_y, xt2[0], nrm_x, inv, y_ops[1], xt2[1])
    return {
        "flash_score": dict(
            kernel=lambda: fs.flash_score_cuda(*s_args, block_m=block_m,
                                               block_n=block_n),
            plain=lambda: fs.flash_score_plain(*s_args, block_n=512),
            rows=x.shape[0], cols=x.shape[0],
            moved=nbytes(*s_args) + x.shape[0] * (x.shape[1] + 1) * 4,
            pts=xrec[: x.shape[0]]),
        "flash_kde": dict(
            kernel=lambda: fk.flash_kde_cuda(*k_args, block_m=block_m,
                                             block_n=block_n),
            plain=lambda: fk.flash_kde_plain(*k_args, block_n=512),
            rows=y.shape[0], cols=x.shape[0],
            moved=nbytes(*k_args) + y.shape[0] * 4,
            pts=torch.cat([xrec[: x.shape[0]], y.float()])),
    }


def phase_kernels(ops, mixture, gen, block_m, block_n) -> dict:
    log("== phase 3: kernels against their plain versions on the card")
    results = {"flash_score": {}, "flash_kde": {}}
    cases = [("ragged", SMALL),
             ("main", (N_TRAIN, N_TRAIN, D))]
    for label, (n, m, d) in cases:
        x = mixture.sample(n, gen)
        y = mixture.sample(m, gen)
        h = 0.78
        for precision in TIERS:
            opnds = kernel_operands(ops, x, y, precision, block_m, block_n,
                                    h)
            for name, c in opnds.items():
                got = c["kernel"]()[: c["rows"]]
                want = c["plain"]()[: c["rows"]]
                torch.cuda.synchronize()
                rtol = (f32_bar(c["pts"], 1 / (2 * h * h))
                        if precision == "f32" else TIER_BAR[precision])
                res = compare(got, want, rtol,
                              f"{name} {precision} {label} n={n} m={m} d={d}")
                if label == "main":
                    results[name][precision] = res
            del opnds
    return results


def phase_main_path(mixture, gen, est_mod, kdemod, serve, fk, fs) -> dict:
    log("== phase 4: main path")
    x = mixture.sample(N_TRAIN, gen)
    y = mixture.sample(N_QUERY, gen)
    torch.cuda.synchronize()

    fs.launches = 0
    fk.launches = 0
    t0 = time.perf_counter()
    est = est_mod.SDKDE(config=est_mod.EstimatorConfig(backend="flash"))
    est.fit(x)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = (fs.launches, fk.launches)
    eval_s = []
    for _ in range(2):          # the first call also loads the kernel
        t0 = time.perf_counter()
        dens = est.evaluate(y)
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)
    eval_launches = (fs.launches - fit_launches[0],
                     fk.launches - fit_launches[1])
    log(f"  SDKDE flash fit {N_TRAIN}x{D}: {fit_s * 1e3:.2f} ms "
        f"(h={est.h:.6f}); evaluate {N_QUERY} queries: first "
        f"{eval_s[0] * 1e3:.2f} ms, second {eval_s[1] * 1e3:.2f} ms")

    eng = serve.ServeEngine(serve.ServeConfig(backend="flash",
                                              method="sdkde"))
    before = (fs.launches, fk.launches)
    t0 = time.perf_counter()
    eng.register("bench", x, h=est.h)
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t0
    answers, latencies, served = [], [], []
    off = 0
    for rnd in range(2):        # round 0 builds bucket callables
        for m in SERVE_SIZES:
            start = off % (N_QUERY - m + 1)
            sl = slice(start, start + m)
            off += m
            ans = eng.query(serve.QueryRequest(key="bench", points=y[sl]))
            answers.append((sl, ans.value))
            if rnd == 1:
                latencies.append(ans.latency_s)
                served.append(m)
    many_sl, start = [], 0
    for m in MANY_SIZES:
        many_sl.append(slice(start, start + m))
        start += m
    t0 = time.perf_counter()
    many = eng.query_many([serve.QueryRequest(key="bench", points=y[s])
                           for s in many_sl])
    many_s = time.perf_counter() - t0
    answers += [(s, a.value) for s, a in zip(many_sl, many)]
    serve_launches = (fs.launches - before[0], fk.launches - before[1])
    main_launches = (fs.launches, fk.launches)
    log(f"  ServeEngine register (debias + columns): "
        f"{register_s * 1e3:.2f} ms; {len(answers)} answers "
        f"({2 * len(SERVE_SIZES)} queries of {SERVE_SIZES} rows, one "
        f"query_many of {MANY_SIZES})")
    lat = sorted(latencies)
    p50 = lat[len(lat) // 2] * 1e3
    p99 = lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)] * 1e3
    qps = sum(served) / sum(latencies)
    log(f"  served (warm round): p50 {p50:.3f} ms, p99 {p99:.3f} ms per "
        f"request, {qps:.0f} query rows/s; query_many "
        f"{many_s * 1e3:.3f} ms for {sum(MANY_SIZES)} rows")
    log(f"  launches on the main path: flash_score {main_launches[0]} "
        f"(fit {fit_launches[0]}, register {serve_launches[0]}), "
        f"flash_kde {main_launches[1]} (evaluate {eval_launches[1]}, "
        f"serving {serve_launches[1]})")
    if min(main_launches) < 1:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{main_launches}")

    # the "torch" backend on the card is the reference; both are held
    # against float64 on the first N_F64 queries, at the f32 serve bar
    ref_est = est_mod.SDKDE(est.h, est_mod.EstimatorConfig(backend="torch"))
    ref_dens = ref_est.fit(x).evaluate(y)
    torch.cuda.synchronize()
    if fs.launches != main_launches[0] or fk.launches != main_launches[1]:
        raise AssertionError("the torch backend launched a flash kernel")
    bar = TIER_BAR["f32"]
    compare(dens, ref_dens, bar, "SDKDE flash vs torch backend")
    got = torch.cat([v for _, v in answers])
    want = torch.cat([ref_dens[s] for s, _ in answers])
    compare(got, want, bar, "ServeEngine answers vs torch backend")
    f64 = kdemod.sdkde_eval(x.double(), y[:N_F64].double(), est.h)
    compare(dens[:N_F64], f64, bar, f"SDKDE flash vs float64 ({N_F64} q)")
    compare(ref_dens[:N_F64], f64, bar,
            f"SDKDE torch backend vs float64 ({N_F64} q)")

    true = mixture.pdf(y.double()).float()
    kde = est_mod.KDE(config=est_mod.EstimatorConfig(backend="flash"))
    kde_dens = kde.fit(x).evaluate(y)
    sd_err = float(((dens - true).abs() / true).mean())
    kde_err = float(((kde_dens - true).abs() / true).mean())
    log(f"  mean relative error vs the mixture's pdf (information): "
        f"SD-KDE {sd_err:.4f}, KDE {kde_err:.4f}")
    return {
        "launches": {"flash_score": main_launches[0],
                     "flash_kde": main_launches[1]},
        "per_phase": {"fit": fit_launches, "evaluate": eval_launches,
                      "serve": serve_launches},
        "fit_ms": fit_s * 1e3, "evaluate_ms": eval_s[1] * 1e3,
        "evaluate_first_ms": eval_s[0] * 1e3,
        "register_ms": register_s * 1e3, "p50_ms": p50, "p99_ms": p99,
        "qps": qps, "query_many_ms": many_s * 1e3,
        "sdkde_mean_rel_err": sd_err, "kde_mean_rel_err": kde_err,
    }


def phase_timings(ops, mixture, gen, block_m, block_n, errors) -> dict:
    log(f"== phase 5: timings at the main path's shape "
        f"(n={N_TRAIN}, m={N_TRAIN}, d={D})")
    x = mixture.sample(N_TRAIN, gen)
    entries = {}
    for precision in TIERS:
        opnds = kernel_operands(ops, x, x, precision, block_m, block_n, 0.78)
        for name, c in opnds.items():
            ms = cuda_ms(c["kernel"], 10)
            plain = cuda_ms(c["plain"], 3)
            bms, by = bound_ms(name, precision, c["rows"], c["cols"], D,
                               c["moved"])
            log(f"  {name} {precision}: kernel {ms:.3f} ms, plain "
                f"{plain:.3f} ms, bound {bms:.4f} ms ({by}), "
                f"{bms / ms * 100:.1f}% of bound")
            entries.setdefault(name, {})[precision] = {
                "ms": ms, "plain_ms": plain, "bound_ms": bms,
                "bound_by": by, **errors[name][precision]}
        del opnds
    return entries


def phase_paper_scale(mixture, gen, est_mod) -> None:
    n, m = 1_048_576, 131_072
    log(f"== phase 6: paper scale, {n} x {D} train, {m} queries")
    x = mixture.sample(n, gen)
    y = mixture.sample(m, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = est_mod.SDKDE(config=est_mod.EstimatorConfig(backend="flash"))
    est.fit(x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dens = est.evaluate(y)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not bool(torch.isfinite(dens).all()) or dens.shape != (m,):
        raise AssertionError("paper-scale densities are not finite")
    true = mixture.pdf(y.double()).float()
    err = float(((dens - true).abs() / true).mean())
    log(f"  fit {(t1 - t0):.3f} s, evaluate {(t2 - t1):.3f} s, end to end "
        f"{(t2 - t0):.3f} s; mean relative error vs pdf {err:.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paper-scale", action="store_true",
                    help="also fit and evaluate at 1,048,576 x 16 / 131,072")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_mod
    from repro_torch import serve
    from repro_torch.core import estimator as est_mod
    from repro_torch.core import kde as kdemod
    from repro_torch.core import mixtures
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_kde as fk
    from repro_torch.kernels import flash_score as fs

    dev = device_mod.resolve("cuda")
    name, _ = phase_device()
    phase_build(_build)
    mixture = mixtures.benchmark_mixture_16d()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cfg = est_mod.EstimatorConfig()
    errors = phase_kernels(ops, mixture, gen, cfg.block_m, cfg.block_n)
    main_path = phase_main_path(mixture, gen, est_mod, kdemod, serve, fk,
                                fs)
    timings = phase_timings(ops, mixture, gen, cfg.block_m, cfg.block_n,
                            errors)
    if args.paper_scale:
        phase_paper_scale(mixture, gen, est_mod)

    sources = {
        "flash_score": ("src/repro_torch/kernels/csrc/flash_score.cu",
                        "src/repro/kernels/flash_score.py:78"),
        "flash_kde": ("src/repro_torch/kernels/csrc/flash_kde.cu",
                      "src/repro/kernels/flash_kde.py:57"),
    }
    kernels = []
    for kname, (src, replaces) in sources.items():
        main_tier = timings[kname]["f32"]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": main_path["launches"][kname],
            "max_abs_err": main_tier["max_abs_err"],
            "ms": main_tier["ms"], "plain_ms": main_tier["plain_ms"],
            "bound_ms": main_tier["bound_ms"],
            "bound_by": main_tier["bound_by"], "library_ms": None,
            "tier": "f32", "shape": {"rows": N_TRAIN, "cols": N_TRAIN,
                                     "d": D},
            "tiers": timings[kname],
        })
    summary = {k: v for k, v in main_path.items() if k != "per_phase"}
    log("main path: " + json.dumps(summary))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
