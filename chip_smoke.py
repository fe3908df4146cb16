#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                # the default run, one card
    python3 chip_smoke.py --paper-scale  # plus 1,048,576 x 16 train /
                                         # 131,072 queries, "auto" and
                                         # "off", timed
    python3 chip_smoke.py --prefill-profile DIR  # only phase 8's prefill,
                                         # profiled, with the port under
                                         # DIR/src (another checkout)

Run from the repository root.  Phases, each printing its lines:

  1. device       the card's name and power limit (nvidia-smi);
  2. build        the five CUDA sources (B1, B2, B3/B4, B5/B6, B7)
                  compiled with nvcc for sm_90a, in parallel; ptxas's
                  registers and spills (a score-pass instantiation at
                  d <= 32 must not spill, nor a dense KDE-pass one, B2,
                  B5 or B6, at any d); the HMMA/HGMMA instructions in
                  the SASS of each B1-B6 instantiation (cuobjdump; the
                  bf16 tiers must have them, f32 none); B7's
                  registers, spills and warps an SM at N = 4 and 16,
                  both modes and input types;
  3. kernels      each kernel against its plain PyTorch version on the
                  card, every tier: B1 flash_score, B2 flash_kde, B5
                  flash_laplace and B6 sq_moment, then B3
                  flash_score_pruned and B4 flash_kde_pruned (laplace off
                  and on), at a ragged small shape whose visit lists hold
                  a zero-count row tile, and at the main path's shape;
                  B2, B4, B5 and B6 also at serving requests of 1, 3 and
                  17 rows against the main train set; B1-B6 at blocks
                  (96, 100) and (64, 200) on the ragged shape, and B3/B4
                  on the clustered set (with a zero-count row tile), and
                  bit for bit: B2, B5 and B6 rows alone equal the same
                  rows in a 4096-row batch, and two launches of any of
                  B1-B6 on the same inputs are equal; B1, B2, B3, B5 and
                  B6 also at d = 24 and 64 (the DMAX 32 and 64 builds);
                  B1, B2, B5 and B6 also at d = 1 (Fig. 4's dimension).
                  Score sums are held per value to bar times their
                  absolute mass, sum phi |[x | 1]|;
                  B7 selective_scan (y and h_final) at ragged shapes
                  (S 200, D 1000, N 4, 5 and 16; B 3, S 1, D 33, N 3;
                  nonzero h0) and at
                  Falcon-Mamba-7B's layer shape (B 4, S 1024, D 8192,
                  N 16), f32 and bf16 inputs, each element within
                  MASS_BAR·(its mass) of the scan's error model, and
                  its fused mode mamba_scan at the same shapes (B, C
                  and z as strided views) against mamba_scan_plain:
                  h_final within MASS_BAR·mass, the gated output within
                  the fused bar of kernels/selective_scan.py; both modes
                  equal bit for bit across two launches;
  4. main path    32768 x 16 train and 16384 queries from the paper's 16-d
                  mixture.  The default path (prune="auto", which prunes
                  at this size): SDKDE(backend="flash").fit(x).evaluate(y)
                  and a ServeEngine answering ragged QueryRequests and one
                  query_many; B3 and B4 must launch, B1 and B2 must not.
                  Then the same with prune="off", which must launch B1
                  and B2 only.  Serving latency is printed by request
                  size.  Pruned densities are held against dense,
                  against the "torch" backend on the card, and both
                  against float64 on 2048 queries;
  4b. clustered   32768 x 16 from 32 centres uniform in [0, 20]^16, sigma
                  1, h 0.5 (drawn with numpy from the seed): tiles really
                  are skipped (occupancy <= 0.2), prune=0.0 equals dense,
                  and at prune=1e-7 every row's float64 error stays within
                  its certificate;
  4c. Laplace    the Laplace-corrected path at the main path's size:
                  LaplaceKDE(backend="flash").fit(x).evaluate(y) with
                  prune="auto" (must launch B4 with laplace only), "off"
                  (B5 only) and fused=False (B2 and B6 only), and a
                  ServeEngine(method="laplace") answering the ragged
                  requests and one query_many with prune="auto" (B4
                  laplace only) and "off" (B5 only); fused,
                  non-fused, dense, the "torch" backend and float64 on
                  2048 queries are held against each other per row within
                  bar·(the row's absolute mass);
  5. timings      each kernel's device time (CUDA-graph replays), its
                  wrapper call's time and its plain version's (CUDA-event
                  medians) at the main path's shape (and B3/B4 on the
                  clustered set), beside the least time the card could
                  take for the work (for B3/B4: the visited pairs only);
                  B2, B4, B5 and B6 at one 128-row serving request
                  against n = 32768; the host-side prepass (k-means, layout, tile
                  map, visit lists) timed apart from the kernels; the
                  fusion comparison, fused (B5) against non-fused (B2 +
                  B6), kernels alone and through ops, at the main shape
                  and Fig. 4's four 1-D shapes; B7, both modes, at
                  Falcon-Mamba-7B's layer shape;
  6. paper scale  (--paper-scale only) fit + evaluate at the paper's size,
                  prune="auto" and prune="off", each fit timed; the
                  score pass must plan one split and no scratch;
  7. oracle       MISE, MIAE and negative mass against the known mixture
                  for KDE, SD-KDE, Laplace fused and non-fused, flash and
                  "torch" backends: Fig. 3's 1-D setting at n = 8192 (grid)
                  and Fig. 2's 16-d setting at n = 32768 (importance
                  sampling), Silverman h, one seed.  Fused must agree with
                  non-fused per point, and each flash estimator's MISE and
                  MIAE with the "torch" backend's within the bound its
                  per-point bar implies; the ordering is printed;
  8. SSM serving  falcon_mamba_7b at full width (bf16, 7.27e9
                  parameters, 64 layers) initialised on the card from a
                  seed, served through launch.serve.generate: batch 4,
                  prompt 1024, 32 greedy tokens, the SD-KDE activation
                  monitor on.  B7's fused mode must launch exactly once
                  per layer in the prefill and in each of the monitor's
                  9 forward passes, no other scan path may run, and only
                  B1, B2 (the monitor) and B7 may launch; prefill ms,
                  decode tok/s and peak memory are printed, and the
                  profiled prefill's kernels by class (GEMM, B7, other)
                  with the other class by name; no softplus and at most
                  one silu a layer (the conv's) may run there.  The
                  monitor's B1
                  and B2 launches are held against their plain versions
                  on the same operands (d 8, fewer than 128 fit rows) at
                  phase 3's bars.  Then, at full width
                  and a depth of 2 in f32: prefill(p[:S]) plus one decode
                  step against prefill(p[:S+1]), and the prefill
                  through the fused B7 against the associative-scan
                  branch;
  9. streaming    the port's streaming path (ServeConfig(stream=True)):
                  (a) 32768 x 16 live points from the paper's mixture,
                  2048 queries, f32 and bf16x2: streams with prune="auto"
                  (must launch B4 only), "off" (B2 only) and
                  method="laplace", "off" (B5 only) take 8 appends of
                  256, one eviction of 512 and 4 slides of 256, flush,
                  and answer ragged requests and one query_many; held
                  against a fresh registration of the live set and
                  against float64 at the tier bar (Laplace per row, bar
                  times the absolute mass); B1 and B3 must not launch
                  from registration to the last query; (b) the clustered
                  set of phase 4b: 256 points around one centre refresh
                  at most the tiles of their slab and those their
                  weights reach above FLT_MIN, every other tile's xt,
                  nrm_x (xt_lo) and metadata keep their bytes, and
                  after a whole slab is evicted B4's answers hold
                  against float64; (c) staleness_budget=2 keeps every
                  answer within 2 generations and staleness_summary()
                  agrees, a slack overflow makes exactly one rebuild, a
                  background flush (stalled by the chaos hook) serves g,
                  one generation behind, to a query dispatched while the
                  worker builds g+1, and then catches up,
                  engine.metrics() shows the stream.*
                  counters and gauges, and obs.prometheus_text() lints
                  clean; (d) 262144 x 16 (repro's streaming acceptance
                  size), batches of 256, prune="auto": the initial
                  statistics, append and flush (ms), affected tiles, the
                  cost a point, a refit of the live set through the
                  registry (median of 3 after a warm-up) and the ratio
                  beside repro's 10x gate, one request's p50 before and
                  after the updates, the host reads and synchronizing
                  calls an update makes (and where the first one's
                  are), and
                  peak memory: printed, not gated; the streamed answers
                  against the refit's are;
 10. decisions    the decision layer at the main path's size, every time
                  printed with the card's name and power limit: (a) the
                  launch tuner's measured resolves of B2 (4096 x 32768),
                  B1 (32768^2) and B4 on the clustered set (pruned
                  model; repro's probe, B2 dense) with the shortlist,
                  each probe's modeled and measured time and their
                  ratio, the winner and 128x128's time; a second resolve
                  must hit the cache; SDKDE with "auto" tiles within the
                  f32 bar of the explicit tiles and of float64; (b) the
                  RFF tier fitted on the debiased points (D 8192, K 256,
                  G 32), 16384 queries at f32 and bf16x2: no row of
                  phase 4's float64 queries above its band, hit
                  fractions at 1e-1, 3e-2, 1e-2, and a 4096-row request
                  beside B2 and B4; (c) ServeEngine(rff="on") at those
                  targets with prune "auto" and "off": hits + escalated
                  = rows, escalations launch B4 (B2) only, every row
                  within its bound against float64, p50 of a 4096-row
                  request, synchronizing calls; and on Fig. 3's 1-D
                  set (n 8192, h 0.3), where the bands fit, rows
                  answered at the fast tier within their bands; (d) the
                  planner's
                  decisions at the main and clustered shapes equal the
                  golden fixture's, ServeConfig(plan="auto") answers
                  within the planned tier's bar of float64, and planning
                  probes nothing; (e) the RFF tier on a stream (8
                  appends of 256, an eviction of 512): the synced feature
                  sums within the f32 phase model of a fresh fit's, sync
                  and refit times, host reads; (f) density weights at
                  32768 x 16 within 2·alpha·bar of float64 weights.

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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_TRAIN, N_QUERY, D = 32768, 16384, 16
SMALL = (1000, 300, 16)                 # ragged (n, m, d)
TIERS = ("f32", "bf16x2", "bf16")
TIER_BAR = {"f32": 1e-5, "bf16x2": 5e-4, "bf16": 5e-2}
SERVE_SIZES = (1, 3, 17, 100, 333, 640, 1000, 2048, 2500, 4096)
REQUEST_ROWS = 128                      # one row tile: a serving request
ODD_BLOCKS = ((96, 100), (64, 200))     # (block_m, block_n) off the main
N_F64 = 2048                            # queries held against float64
MANY_SIZES = (7, 120, 900, 2000)
SEED = 0
# the clustered check: 32 centres uniform in [0, 20]^16, sigma 1, h 0.5
CLU_K, CLU_SPREAD, CLU_H, CLU_EPS = 32, 20.0, 0.5, 1e-7
CLU_MAX_OCCUPANCY = 0.2
N_CLU_F64 = 4096
# Fig. 4's fusion shapes: the 1-D mixture, h 0.3, n train, n/8 queries
FIG4_NS, FIG4_H = (4096, 8192, 16384, 32768), 0.3
# Fig. 3 (1-D grid) and Fig. 2 (16-d importance sampling) oracle errors
ORACLE_N_1D, N_MC = 8192, 8192
ORACLE_METHODS = ("kde", "sdkde", "laplace", "laplace_nonfused")
# B7: (B, S, D, N) of ragged shapes (S not a multiple of the Pallas
# kernel's chunk nor of B7's, down to one step; D not of 128 nor of 32;
# N 5 and 3 not of the 4 state groups) and of Falcon-Mamba-7B's layer at
# the serving batch and prompt
SCAN_RAGGED = ((2, 200, 1000, 4), (2, 200, 1000, 5), (2, 200, 1000, 16),
               (3, 1, 33, 3))
SCAN_MAIN = (4, 1024, 8192, 16)
SCAN_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# phase 9: streaming.  Parity at the main path's live size: 8 appends of
# 256, one eviction of 512, 4 slides of 256, then ragged requests (and one
# query_many over the rest) of N_F64 queries; scale at repro's streaming
# acceptance size (benchmarks/streaming_throughput.py), batches of 256
STREAM_APPENDS, STREAM_BATCH, STREAM_EVICT, STREAM_SLIDES = 8, 256, 512, 4
STREAM_SIZES = (1, 3, 17, 100, 333, 640)
STREAM_SCALE_N, STREAM_SCALE_UPDATES = 262144, 8
REFIT_REPEATS = 3                       # timed refits at scale, after a warm-up
BACKGROUND_STALL_MS = 500.0             # the chaos hook's stall of a worker flush
# phase 8: Falcon-Mamba-7B served at full width, depth cut only if it must
SERVE_ARCH = "falcon_mamba_7b"
SERVE_LAYERS = 64
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 32
MONITOR_LEN = 256        # the monitor's 8 x 16 reference sequences
CHECK_LAYERS, CHECK_BATCH, CHECK_PROMPT = 2, 2, 512
# prefill-vs-decode and kernel-vs-associative-scan logits and states, f32:
# rtol 2e-4 with atol 2e-5 of the largest magnitude (the CPU tests' bars,
# tests/test_torch_ssm.py).  Both sides are f32 throughout; they differ by
# the order cuBLAS sums products of width up to 16384 for S tokens and for
# one, and by the scan's order (B7 sequential, the associative branch a
# doubling scan): rounding of ~sqrt(K)·eps ≈ 1e-5 of the operands'
# magnitude per product, carried through two layers and the head.
MODEL_RTOL, MODEL_ATOL = 2e-4, 2e-5

# H100 SXM peaks for B7's bound (NVIDIA data sheet, dense, at the 700 W
# limit): FP32 outside the tensor cores, HBM3 bandwidth, exp on the SFU at
# 16 results per clock per SM (CUDA C++ Programming Guide, compute
# capability 9.0), 132 SMs, the 1980 MHz boost clock.  The pair passes'
# bound (B1-B6) is the launch tuner's, kernels.tuning.pair_bound.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9
# phase 10: the decision layer.  The RFF tier at repro's defaults (D 8192
# features, K 256 pilot cells, G 32 groups), the cascade's targets, one
# request of RFF_ROWS rows, and the timed requests per target
RFF_FEATURES, RFF_PILOT, RFF_GROUPS = 8192, 256, 32
CASCADE_TARGETS = (1e-1, 3e-2, 1e-2)
RFF_ROWS = 4096
CASCADE_REPEATS = 11
DENSITY_ALPHA = 0.5


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def f32_bar(pts, inv2h2: float) -> float:
    """rtol at the f32 tier: 1e-5, or the norm-trick error model
    8·eps·max‖x‖²/(2h²) where larger (both sides round the Gram
    differently and 1/(2h²) amplifies it inside exp)."""
    eps = torch.finfo(torch.float32).eps
    return max(1e-5, 8 * eps * float((pts * pts).sum(1).max()) * inv2h2)


def tier_bar(precision: str, pts, h: float) -> float:
    """A tier's bar, and never below the f32 norm-trick model: sq is f32
    at every tier, so a Gram summed in another order carries the same
    cancellation (it sets the bar where ‖x‖² is large, as on the
    clustered set)."""
    return max(TIER_BAR[precision], f32_bar(pts, 1 / (2 * h * h)))


def compare(got, want, rtol: float, what: str, *,
            atol_frac: float = 1e-6) -> dict:
    """allclose(rtol, atol = atol_frac·peak) on the card; raises on a
    miss.  Sums that cross zero (Laplace) go through ``compare_mass``."""
    got = got.double()
    want = want.double()
    peak = float(want.abs().max())
    atol = atol_frac * peak
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    excess = float((diff - (atol + rtol * want.abs())).max())
    big = want.abs() > (atol / rtol if rtol else peak * 1e-3)
    rel = float((diff[big] / want.abs()[big]).max()) if bool(big.any()) else 0.0
    out = {"max_abs_err": float(diff.max()), "max_rel_err": rel,
           "rtol": rtol, "atol": atol}
    log(f"  {what}: max rel err {rel:.3e} (bar rtol {rtol:.1e}, atol "
        f"{atol:.2e}), max abs err {out['max_abs_err']:.3e}")
    if excess > 0:
        raise AssertionError(f"{what}: outside the bar by {excess:.3e}")
    return out


def compare_mass(got, want, mass, bar: float, what: str) -> dict:
    """Per row |got − want| <= bar·mass on the card; raises on a miss.

    For sums that cross zero (Laplace) or weigh far points most (the
    square moment): ``mass`` is the row's absolute mass, the sum of the
    terms' magnitudes and of their sensitivity to an absolute error in
    the scaled distance (``flash_laplace``'s plain versions return it)."""
    got, want, mass = (t.double().reshape(-1) for t in (got, want, mass))
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    diff = (got - want).abs()
    excess = float((diff - bar * mass).max())
    ratio = float((diff / mass.clamp(min=1e-300)).max())
    out = {"max_abs_err": float(diff.max()), "max_rel_err": ratio,
           "rtol": bar, "atol": 0.0, "relative_to": "row absolute mass"}
    log(f"  {what}: max |err|/mass {ratio:.3e} (bar {bar:.1e}), max abs "
        f"err {out['max_abs_err']:.3e}")
    if excess > 0:
        raise AssertionError(f"{what}: outside bar·mass by {excess:.3e}")
    return out


def laplace_mass(kdemod, x, y, h: float, block: int = 2048):
    """Each query's normalized Laplace absolute mass in float64,
    Σ_i φ·(2 + d/2 + scaled) / (n (2π)^{d/2} h^d): the scale of the
    Laplace density's rounding error (``kernels/flash_laplace.py``)."""
    n, d = x.shape
    y64 = y.double()
    out = torch.zeros(y.shape[0], dtype=torch.float64, device=y.device)
    for j0 in range(0, n, block):
        s = kdemod.sqdist(y64, x[j0:j0 + block].double()) / (2 * h * h)
        out += (torch.exp(-s) * (2 + d / 2 + s)).sum(1)
    return out / (n * (2 * math.pi) ** (d / 2) * h**d)


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        sync()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, the graph replayed ``reps`` times between two events each;
    the median over the replays, per call.  Unlike ``cuda_ms`` no host
    work (the wrapper's checks and allocations) sits between launches,
    which matters for a kernel shorter than its wrapper's host time."""
    fn()
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    sync()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        sync()
        times.append(e0.elapsed_time(e1) / calls)
    del graph
    times.sort()
    return times[len(times) // 2]


def host_ms(fn) -> tuple:
    """(result, ms) of one call on the host clock, synchronized."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(kind: str, tier: str, pairs: int, d: int, moved: int) -> tuple:
    """(ms, "bytes" | "operations"): the larger of the bytes the call must
    move over the HBM rate and the operations on ``pairs`` (row, column)
    pairs over their peak rates.  ``kind`` is "score" (B1/B3), "kde"
    (B2/B4), "laplace" (B5, B4's flag: two more per pair for the factor)
    or "sq_moment" (B6: one more, the weight's multiply).  One definition
    with the launch tuner's floor: ``kernels.tuning.pair_bound``."""
    from repro_torch.kernels import tuning

    s, by = tuning.pair_bound(kind, tier, pairs, d, moved)
    return 1e3 * s, by


def clustered_points(rng: np.random.Generator, centres, n: int, dev):
    lab = rng.integers(0, centres.shape[0], n)
    x = centres[lab] + rng.standard_normal((n, centres.shape[1]))
    return torch.as_tensor(x.astype(np.float32), device=dev)


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


_PTXAS_NAME = re.compile(
    r"(kde_pass|score_pass)_kernelI(f|13__nv_bfloat16)Lb([01])ELi(\d+)E"
    r"(?:LN\w*?WeightE(\d)E)?N\w*?(AllTiles|VisitList)")
_WEIGHTS = {None: "", "0": "", "1": ",laplace", "2": ",sq_moment"}
_PTXAS_SCAN = re.compile(
    r"selective_scan_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E")
# the tensor-core instructions counted in the SASS of each instantiation
_TENSOR_OPS = re.compile(r"\b(HMMA|HGMMA)\b")


def kernel_key(fn: str) -> str:
    """kernel<tier,DMAX[,weight][,visits]> for a mangled kernel name
    (the name itself when it is none of the flash kernels)."""
    t = _PTXAS_NAME.search(fn)
    if t is not None:
        return (f"{t.group(1)}<{'f32' if t.group(2) == 'f' else 'bf16'}"
                f"{'x2' if t.group(3) == '1' else ''},{t.group(4)}"
                f"{_WEIGHTS[t.group(5)]}"
                f"{',visits' if t.group(6) == 'VisitList' else ''}>")
    sc = _PTXAS_SCAN.search(fn)
    if sc is not None:
        mode = "mamba_scan" if sc.group(3) == "1" else "selective_scan"
        return (f"{mode}<{'f32' if sc.group(1) == 'f' else 'bf16'},"
                f"{sc.group(2)}>")
    return fn


def ptxas_summary(text: str) -> list:
    """(kernel<tier,DMAX,...>, registers, spill-store bytes) per
    instantiation from ptxas's -v report."""
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
            out.append((kernel_key(fn), int(m.group(1)), spill))
            fn = None
    return out


def tensor_op_counts(_build, name: str):
    """{kernel<...>: HMMA/HGMMA instructions} in the SASS of library
    ``name`` (cuobjdump -sass), or None where the toolkit has no
    cuobjdump."""
    exe = Path(_build.nvcc()).with_name("cuobjdump")
    if not exe.exists():
        return None
    sass = subprocess.run([str(exe), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            fn = kernel_key(m.group(1))
            counts[fn] = 0
        elif fn is not None:
            counts[fn] += len(_TENSOR_OPS.findall(ln))
    return counts


def phase_build(_build) -> dict:
    log("== phase 2: build")
    scan_regs = {}
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
            rows = ptxas_summary(ptxas.read_text())
            log("    registers / spill-store bytes, d <= 16: "
                + ", ".join(f"{k} {r}/{sp}" for k, r, sp in rows
                            if ",16" in k))
            spills = [f"{k} {sp}" for k, _, sp in rows if sp]
            log(f"    {len(rows)} instantiations, most registers "
                f"{max((r for _, r, _ in rows), default=0)}; spills: "
                f"{', '.join(spills) or 'none'}")
            score = [(k, r, sp) for k, r, sp in rows
                     if k.startswith("score_pass<")]
            if score:
                log("    score pass registers / spill-store bytes: "
                    + ", ".join(f"{k} {r}/{sp}" for k, r, sp in score))
            if name in ("flash_kde", "flash_laplace"):
                log("    KDE pass registers / spill-store bytes: "
                    + ", ".join(f"{k} {r}/{sp}" for k, r, sp in rows))
                # the dense KDE passes (B2, B5, B6) may not spill at any d
                if spills:
                    raise AssertionError(f"{name}: KDE-pass instantiations "
                                         f"spill: {spills}")
            scan = [(k, r, sp) for k, r, sp in rows
                    if k.startswith(("selective_scan<", "mamba_scan<"))
                    and k.rstrip(">").split(",")[1] in ("4", "16")]
            if scan:
                from repro_torch.kernels import selective_scan as ss

                for k, r, sp in scan:
                    n = int(k.rstrip(">").split(",")[1])
                    dtype = SCAN_DTYPES[k.split("<")[1].split(",")[0]]
                    blocks = ss.blocks_per_sm(n, dtype,
                                              k.startswith("mamba_scan<"))
                    scan_regs[k] = {"registers": r, "spill_bytes": sp,
                                    "warps_per_sm": 4 * blocks}
                log("    scan registers / spill-store bytes / warps an SM "
                    "at N = 4, 16: " + ", ".join(
                        f"{k} {v['registers']}/{v['spill_bytes']}/"
                        f"{v['warps_per_sm']}" for k, v in scan_regs.items()))
            # the score pass may not spill at d <= 32 (DMAX 4 .. 32)
            narrow = [k for k, _, sp in score
                      if sp and int(k.split(",")[1].rstrip(">")) <= 32]
            if narrow:
                raise AssertionError(f"{name}: score-pass instantiations "
                                     f"spill at d <= 32: {narrow}")
    log(f"  build wall time {time.perf_counter() - t0:.1f} s")
    # B1-B6: the bf16 tiers' products run on the tensor cores, f32's not
    hmma = {}
    for name in ("flash_score", "flash_kde", "flash_pruned",
                 "flash_laplace"):
        counts = tensor_op_counts(_build, name)
        if counts is None:
            log(f"  {name}: tensor-core instructions in the SASS: not "
                "available (no cuobjdump)")
            continue
        passes = {k: v for k, v in counts.items()
                  if k.startswith(("kde_pass<", "score_pass<"))}
        log(f"  {name}: HMMA/HGMMA instructions per split-column "
            "instantiation: " + ", ".join(f"{k} {v}"
                                          for k, v in sorted(passes.items())))
        wrong = [k for k, v in passes.items()
                 if (v > 0) != ("<f32," not in k)]
        if not passes or wrong:
            raise AssertionError(f"{name}: the bf16 tiers must use tensor "
                                 f"cores and f32 none: {wrong or counts}")
        hmma[name] = passes
    return hmma, scan_regs


def score_mass_args(args, i):
    """B1's or B3's arguments with |[X|1]| for xaug (at ``args[i]``) and
    its lo plane (the last argument): the plain pass then gives each
    value's absolute mass, sum_j phi_ij |[x_j | 1]_k| (at bf16x2 an upper
    bound, |hi| + |lo|).  S1 cancels between points on either side of
    x_i, so the score pass's error is absolute, bar times this mass (as
    the Laplace sums are held); for the ones column, S0, the mass is S0
    itself."""
    out = list(args)
    for k in (i, len(out) - 1):
        if out[k] is not None:
            out[k] = out[k].abs()
    return out


def kernel_operands(ops, x, y, precision, block_m, block_n, h):
    """Operands of B1, B2, B5 and B6 at one tier, as the ops wrappers
    make them, plus the kernel and plain callables (and for B5/B6 the
    rows' absolute mass); the dense KDE passes (B2, B5, B6) also give
    their arguments (``args``) and CUDA wrapper (``cuda``)."""
    from repro_torch.kernels import flash_kde as fk
    from repro_torch.kernels import flash_laplace as fl
    from repro_torch.kernels import flash_score as fs

    inv = ops._inv2h2(h, x.device)
    xp = ops._pad_to(x, math.lcm(block_m, block_n))
    x_ops, xt_ops, xaug_ops, nrm, xrec = ops._score_operands(xp, precision)
    s_args = (x_ops[0], nrm, xt_ops[0], xaug_ops[0], inv, x_ops[1],
              xt_ops[1], xaug_ops[1])
    y_ops, xt2, nrm_y, nrm_x = ops._prep_eval(x, y, block_m, block_n,
                                              precision)
    k_args = (y_ops[0], nrm_y, xt2[0], nrm_x, inv, y_ops[1], xt2[1])
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    bk = dict(block_m=block_m, block_n=block_n)
    out = {
        "flash_score": dict(
            kind="score",
            kernel=lambda: fs.flash_score_cuda(*s_args, block_m=block_m,
                                               block_n=block_n),
            plain=lambda: fs.flash_score_plain(*s_args, block_n=512),
            mass=lambda: fs.flash_score_plain(*score_mass_args(s_args, 3),
                                              block_n=512),
            real=slice(0, n), pairs=n * n,
            moved=nbytes(*s_args) + n * (d + 1) * 4,
            pts=xrec[:n]),
        "flash_kde": dict(
            kind="kde",
            kernel=lambda: fk.flash_kde_cuda(*k_args, **bk),
            plain=lambda: fk.flash_kde_plain(*k_args, block_n=512),
            args=k_args, cuda=fk.flash_kde_cuda, real=slice(0, m),
            pairs=m * n,
            moved=nbytes(*k_args) + m * 4,
            pts=torch.cat([xrec[:n], y.float()])),
    }
    for name, cuda, plain in (
            ("flash_laplace", fl.flash_laplace_cuda, fl.flash_laplace_plain),
            ("sq_moment", fl.sq_moment_cuda, fl.sq_moment_plain)):
        out[name] = dict(
            kind=name.removeprefix("flash_"),
            kernel=lambda f=cuda: f(*k_args, **bk),
            plain=lambda f=plain: f(*k_args, block_n=512),
            mass=lambda f=plain: f(*k_args, block_n=512, mass=True)[1],
            args=k_args, cuda=cuda, real=slice(0, m), pairs=m * n,
            moved=nbytes(*k_args) + m * 4,
            pts=torch.cat([xrec[:n], y.float()]))
    return out


def prepass(ops, sp, x, y, precision, block_m, block_n, h, index, *,
            eps=0.0, empty_row=None, times=None):
    """The pruned passes' prepass, as ``ops._score_stats_pruned`` and
    ``ops._pruned_eval_sums`` run it: layouts, tier casts, tile metadata,
    tile maps and visit lists.  ``empty_row`` empties one row tile's
    visit list in both passes; ``times`` collects host ms per step."""
    times = {} if times is None else times

    def step(name, fn):
        out, ms = host_ms(fn)
        times[name] = times.get(name, 0.0) + ms
        return out

    inv = ops._inv2h2(h, x.device)
    lay = step("layout", lambda: sp.cluster_layout(
        x, index.labels, block_n, total_multiple=math.lcm(block_m, block_n)))
    x_ops, xt_ops, xaug_ops, nrm, xrec = ops._score_operands(lay.points,
                                                             precision)
    meta = step("tile_metadata", lambda: sp.tile_metadata(
        xrec, lay.real, block=block_n))
    skeep = step("tile_map", lambda: sp.tile_map(
        xrec, meta, inv, eps, block_m=block_m, kind="score")).keep
    cols = step("columns", lambda: ops.prepare_train_columns(
        x, block_n=block_n, precision=precision, clustered=True,
        index=index))
    ql = step("layout", lambda: sp.cluster_layout(
        y, sp.assign(y, index), block_m, bucket_rows=True))
    y_hi, y_lo, nrm_y, yrec = ops._cast_queries(ql.points, precision)
    ktm = step("tile_map", lambda: sp.tile_map(
        yrec, cols.meta, inv, eps, block_m=block_m, kind="kde"))
    if empty_row is not None:
        skeep[empty_row] = False
        ktm.keep[empty_row] = False
    sv = step("visit_lists", lambda: sp.visit_lists(skeep))
    kv = step("visit_lists", lambda: sp.visit_lists(ktm.keep))
    s_args = (sv.counts, sv.tile_map, x_ops[0], nrm, xt_ops[0], xaug_ops[0],
              inv, x_ops[1], xt_ops[1], xaug_ops[1])
    k_args = (kv.counts, kv.tile_map, y_hi, nrm_y, cols.xt, cols.nrm_x, inv,
              y_lo, cols.xt_lo)
    return dict(s_args=s_args, k_args=k_args, score_vl=sv, kde_vl=kv,
                score_real=lay.real, kde_real=ql.real, xrec=xrec,
                yrec=yrec, kde_map=ktm, qlayout=ql, cols=cols)


def pruned_operands(ops, sp, x, y, precision, block_m, block_n, h, index,
                    **kw):
    """B3 and B4 (laplace off and on) at one tier, on the prepass's
    operands and visit lists, with the kernel and plain callables."""
    from repro_torch.kernels import flash_laplace as fl
    from repro_torch.kernels import flash_pruned as fp

    pre = prepass(ops, sp, x, y, precision, block_m, block_n, h, index, **kw)
    s_args, k_args = pre["s_args"], pre["k_args"]
    d = x.shape[1]
    bk = dict(block_m=block_m, block_n=block_n)
    s_pairs = int(pre["score_vl"].counts.sum()) * block_m * block_n
    k_pairs = int(pre["kde_vl"].counts.sum()) * block_m * block_n
    rows_s, rows_k = s_args[2].shape[0], k_args[2].shape[0]
    xreal = pre["xrec"][pre["score_real"]]
    out = {
        "flash_score_pruned": dict(
            kind="score",
            kernel=lambda: fp.flash_score_pruned_cuda(*s_args, **bk),
            plain=lambda: fp.flash_score_pruned_plain(*s_args, **bk),
            mass=lambda: fp.flash_score_pruned_plain(
                *score_mass_args(s_args, 5), **bk),
            real=pre["score_real"], pairs=s_pairs,
            moved=nbytes(*s_args) + rows_s * (d + 1) * 4,
            occupancy=pre["score_vl"].occupancy,
            max_visits=pre["score_vl"].max_visits, pts=xreal),
    }
    for laplace in (False, True):
        name = "flash_kde_pruned" + (" laplace" if laplace else "")
        out[name] = dict(
            kind="kde", laplace=laplace,
            kernel=lambda lp=laplace: fp.flash_kde_pruned_cuda(
                *k_args, laplace=lp, **bk),
            plain=lambda lp=laplace: fp.flash_kde_pruned_plain(
                *k_args, laplace=lp, **bk),
            real=pre["kde_real"], pairs=k_pairs,
            moved=nbytes(*k_args) + rows_k * 4,
            occupancy=pre["kde_vl"].occupancy,
            max_visits=pre["kde_vl"].max_visits,
            pts=torch.cat([xreal, pre["yrec"][pre["kde_real"]]]))
        if laplace:
            # the rows' mass over every column tile bounds it over the
            # visited ones (at epsilon 0 the skipped tiles add exactly 0)
            out[name].update(kind="laplace", mass=lambda: (
                fl.flash_laplace_plain(*k_args[2:], block_n=512,
                                       mass=True)[1]))
    return out


def check_kernel(name, c, precision, h, label) -> dict:
    got = c["kernel"]()[c["real"]]
    want = c["plain"]()[c["real"]]
    sync()
    rtol = tier_bar(precision, c["pts"], h)
    what = f"{name} {precision} {label}"
    if "mass" in c:
        return compare_mass(got, want, c["mass"]()[c["real"]], rtol, what)
    return compare(got, want, rtol, what)


def scan_inputs(shape, dtype, gen):
    """B7's operands on the card, drawn as tests/test_selective_scan_kernel
    draws them: xi, B, C normal, dt softplus(normal), a = −exp(normal/2),
    h0 normal/10."""
    bsz, s, d, n = shape
    dev = gen.device

    def randn(*size):
        return torch.randn(size, generator=gen, device=dev)

    xi = randn(bsz, s, d).to(dtype)
    dt = torch.nn.functional.softplus(randn(bsz, s, d)).to(dtype)
    b, c = randn(bsz, s, n).to(dtype), randn(bsz, s, n).to(dtype)
    a = -torch.exp(randn(d, n) * 0.5)
    h0 = randn(bsz, d, n) * 0.1
    return xi, dt, b, c, a, h0


SCAN_RANK = 256     # Falcon-Mamba-7B's dt_rank: B and C sit past it


def fused_scan_inputs(shape, dtype, gen):
    """The fused B7's operands on the card, as the Mamba block hands them
    over: xi and Δ_raw normal, B and C views of an x-projection (B, S,
    rank + 2N), z the second half of an in-projection (B, S, 2D), dt_bias
    normal/2, the D skip normal; a and h0 as ``scan_inputs``."""
    bsz, s, d, n = shape
    dev = gen.device

    def randn(*size):
        return torch.randn(size, generator=gen, device=dev)

    xi = randn(bsz, s, d).to(dtype)
    dt_raw = randn(bsz, s, d).to(dtype)
    xbc = randn(bsz, s, SCAN_RANK + 2 * n).to(dtype)
    _, b, c = torch.split(xbc, [SCAN_RANK, n, n], dim=-1)
    z = randn(bsz, s, 2 * d).to(dtype)[..., d:]
    a = -torch.exp(randn(d, n) * 0.5)
    h0 = randn(bsz, d, n) * 0.1
    dt_bias = (randn(d) * 0.5).to(dtype)
    d_skip = randn(d)
    return xi, dt_raw, b, c, a, h0, dt_bias, d_skip, z


def scan_bound_ms(shape, dtype, fused: bool = False) -> tuple:
    """(ms, "bytes" | "operations") for B7: each input read once (xi, dt,
    B, C in ``dtype``, a and h0 f32), y and h_final written once in f32;
    per (b, t, d, n) one exp on the SFU and 6 FP32 operations (the exp's
    argument, decay·h, dx·B, the add, C·h and the sum).  ``fused`` adds
    the z read, dt_bias and the D skip, writes the output in ``dtype``
    instead of y in f32, and per (b, t, d) three transcendentals on the
    SFU (softplus's exp and log1p, silu's exp) and 8 FP32 operations (the
    bias add, the threshold, silu's add and division, D·xi, its add, the
    product, dx)."""
    bsz, s, d, n = shape
    size = torch.finfo(dtype).bits // 8
    rows = bsz * s * d
    terms = rows * n
    f32_moved = (d * n + 2 * bsz * d * n) * 4
    if fused:
        moved = (4 * rows + 2 * bsz * s * n + d) * size + f32_moved + d * 4
        sfu, fp32 = terms + 3 * rows, 6 * terms + 8 * rows
    else:
        moved = (2 * rows + 2 * bsz * s * n) * size + f32_moved + rows * 4
        sfu, fp32 = terms, 6 * terms
    ops_s = max(sfu / PEAK_EXP, fp32 / PEAK_F32)
    bytes_s = moved / PEAK_BYTES
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def check_scan(ss, args, label) -> dict:
    """B7 against its plain version on the card, y and h_final, each
    element within MASS_BAR·(its mass): the error model of
    kernels/selective_scan.py (32·eps of Σ_n |C_n|·(G_n + |h_n|), where G
    carries the rounding of every step through the state's memory); and
    a second launch on the same inputs equal bit for bit."""
    y, h = ss.selective_scan_cuda(*args)
    y2, h2 = ss.selective_scan_cuda(*args)
    py, ph, my, mh = ss.selective_scan_plain(*args, mass=True)
    sync()
    out = {"y": compare_mass(y, py, my, ss.MASS_BAR, f"selective_scan y "
                             f"{label}"),
           "h_final": compare_mass(h, ph, mh, ss.MASS_BAR,
                                   f"selective_scan h_final {label}")}
    if not (torch.equal(y, y2) and torch.equal(h, h2)):
        raise AssertionError(f"selective_scan {label}: two launches differ")
    out["max_abs_err"] = max(out["y"]["max_abs_err"],
                             out["h_final"]["max_abs_err"])
    out["bitwise_repeat"] = True
    return out


def check_fused_scan(ss, args, label) -> dict:
    """Fused B7 against ``mamba_scan_plain`` on the card: h_final within
    MASS_BAR·(its mass), the gated output within the fused bar of
    kernels/selective_scan.py (|silu(z)|·(MASS_BAR·M_y + one f32 and one
    working-type ulp of y + D·xi) + one working-type ulp of the output,
    the allowance ``mamba_scan_plain(..., mass=True)`` returns, so the
    printed ratio is |err| / allowance against 1); and a second launch on
    the same inputs equal bit for bit."""
    o, h = ss.mamba_scan_cuda(*args)
    o2, h2 = ss.mamba_scan_cuda(*args)
    po, ph, tol, mh = ss.mamba_scan_plain(*args, mass=True)
    sync()
    out = {"out": compare_mass(o, po, tol, 1.0, f"mamba_scan out {label} "
                               "(|err| / allowance)"),
           "h_final": compare_mass(h, ph, mh, ss.MASS_BAR,
                                   f"mamba_scan h_final {label}")}
    if not (torch.equal(o, o2) and torch.equal(h, h2)):
        raise AssertionError(f"mamba_scan {label}: two launches differ")
    out["max_abs_err"] = max(out["out"]["max_abs_err"],
                             out["h_final"]["max_abs_err"])
    out["bitwise_repeat"] = True
    return out


def clustered_set(dev) -> tuple:
    """The clustered check's points (phase 4b): 32 centres uniform in
    [0, 20]^16, sigma 1, train and queries drawn with numpy from SEED."""
    rng = np.random.default_rng(SEED)
    centres = rng.uniform(0.0, CLU_SPREAD, (CLU_K, D))
    return (clustered_points(rng, centres, N_TRAIN, dev),
            clustered_points(rng, centres, N_QUERY, dev))


# the KDE-pass kernels: dense B2, B5, B6 (their rows alone must equal the
# same rows in a batch) and the pruned B4, both flags
DENSE_KDE_PASSES = ("flash_kde", "flash_laplace", "sq_moment")
PRUNED_KDE_PASSES = ("flash_kde_pruned", "flash_kde_pruned laplace")
KDE_PASSES = DENSE_KDE_PASSES + PRUNED_KDE_PASSES
SCORE_PASSES = ("flash_score", "flash_score_pruned")
# B1, B2, B3, B5 and B6 at d = 24 and 64 (the DMAX 32 and 64 builds; the
# score pass at bf16x2 two and three groups of output tiles), h
# 0.5 sqrt(d), on normal points
WIDE_DS = (24, 64)
WIDE_PASSES = SCORE_PASSES + DENSE_KDE_PASSES


def check_zero_tile(pruned, block_m, precision, keys) -> None:
    """Row tile 1, emptied in both visit lists, sums to exactly 0."""
    for key in keys:
        tile1 = pruned[key]["kernel"]()[block_m:2 * block_m]
        sync()
        if bool((tile1 != 0).any()):
            raise AssertionError(f"{key}: a zero-count row tile did not "
                                 "sum to zero")
    log(f"  zero-count row tile sums to 0.0 in {', '.join(keys)} "
        f"({precision})")


def check_bitwise(ops, sp, x, y, index, block_m, block_n, h) -> dict:
    """On the card, bit for bit: B2, B5 and B6 on rows served alone (1,
    3, 17 and 128 of them, padded to one row tile with other rows) and
    the same rows inside a 4096-row batch, on operands sliced from the
    batch's; B1-B6 (B4 both flags) launched twice on the same inputs."""
    bk = dict(block_m=block_m, block_n=block_n)
    out = {}
    for precision in TIERS:
        dense = kernel_operands(ops, x, y[:4096], precision, block_m,
                                block_n, h)
        for name in DENSE_KDE_PASSES:
            c = dense[name]
            args = c["args"]
            batch = c["cuda"](*args, **bk)
            for k in (1, 3, 17, 128):
                off = 1234 + k           # not on a warp or tile boundary
                rows = torch.cat([torch.arange(off, off + k),
                                  torch.arange(0, block_m - k)]).to(x.device)
                alone = list(args)
                for i in (0, 1, 5):      # y, nrm_y, y_lo
                    if alone[i] is not None:
                        alone[i] = alone[i][rows].contiguous()
                got = c["cuda"](*alone, **bk)[:k]
                sync()
                if not torch.equal(got, batch[off:off + k]):
                    raise AssertionError(
                        f"{name} {precision}: {k} rows alone differ from "
                        "the same rows in a 4096-row batch")
        log(f"  {', '.join(DENSE_KDE_PASSES)} {precision}: rows alone (1, "
            "3, 17, 128) equal the same rows in a 4096-row batch, bit for "
            "bit")
        del dense
        twice = dict(kernel_operands(ops, x, y, precision, block_m, block_n,
                                     h), **pruned_operands(
            ops, sp, x, y, precision, block_m, block_n, h, index))
        for name in SCORE_PASSES + KDE_PASSES:
            a, b = twice[name]["kernel"](), twice[name]["kernel"]()
            sync()
            if not torch.equal(a, b):
                raise AssertionError(f"{name} {precision}: two launches on "
                                     "the same inputs differ")
        log(f"  {', '.join(SCORE_PASSES + KDE_PASSES)} {precision}: two "
            "launches equal, bit for bit")
        out[precision] = True
        del twice
    return out


def phase_kernels(ops, sp, mixture, mix1, gen, block_m, block_n) -> dict:
    log("== phase 3: kernels against their plain versions on the card")
    results = {}
    cases = [("ragged", SMALL), ("main", (N_TRAIN, N_TRAIN, D))]
    for label, (n, m, d) in cases:
        x = mixture.sample(n, gen)
        y = mixture.sample(m, gen)
        h = 0.78
        index = sp.build_index(x, seed=SEED)
        for precision in TIERS:
            opnds = kernel_operands(ops, x, y, precision, block_m, block_n,
                                    h)
            # the ragged case empties row tile 1 of both visit lists
            pruned = pruned_operands(
                ops, sp, x, y, precision, block_m, block_n, h, index,
                empty_row=1 if label == "ragged" else None)
            if label == "ragged":
                check_zero_tile(pruned, block_m, precision,
                                ("flash_score_pruned",) + PRUNED_KDE_PASSES)
            opnds.update(pruned)
            for name, c in opnds.items():
                res = check_kernel(name, c, precision, h,
                                   f"{label} n={n} m={m} d={d}")
                if label == "main":
                    results.setdefault(name, {})[precision] = res
            del opnds, pruned
        if label != "main":
            continue
        # serving requests: B2, B4, B5 and B6 at 1, 3 and 17 query rows
        # (real rows only) against the main shape's train set
        for k in (1, 3, 17):
            for precision in TIERS:
                opnds = dict(kernel_operands(
                    ops, x, y[:k], precision, block_m, block_n, h),
                    **pruned_operands(ops, sp, x, y[:k], precision, block_m,
                                      block_n, h, index))
                for name in KDE_PASSES:
                    check_kernel(name, opnds[name], precision, h,
                                 f"request of {k} rows, n={n} d={d}")
                del opnds
        results["bitwise"] = check_bitwise(ops, sp, x, y, index, block_m,
                                           block_n, h)
    # B1-B6 at tiles that do not fill the kernels' own 64 rows x 128
    # columns: block_m 96 (a half-idle block), block_n 100 (element
    # copies, one masked chunk a tile) and 200 (two chunks, one masked)
    n, m, d = SMALL
    x, y = mixture.sample(n, gen), mixture.sample(m, gen)
    index = sp.build_index(x, seed=SEED)
    for bm, bn in ODD_BLOCKS:
        for precision in TIERS:
            opnds = dict(kernel_operands(ops, x, y, precision, bm, bn, h),
                         **pruned_operands(ops, sp, x, y, precision, bm, bn,
                                           h, index))
            for name in SCORE_PASSES + KDE_PASSES:
                check_kernel(name, opnds[name], precision, h,
                             f"blocks {bm} x {bn}, n={n} m={m} d={d}")
            del opnds
    # the clustered set, where B3 and B4 skip most tiles; row tile 1's
    # lists emptied
    cx, cy = clustered_set(gen.device)
    cindex = sp.build_index(cx, seed=SEED)
    clustered_passes = ("flash_score_pruned",) + PRUNED_KDE_PASSES
    for precision in TIERS:
        pruned = pruned_operands(ops, sp, cx, cy, precision, block_m,
                                 block_n, CLU_H, cindex, empty_row=1)
        check_zero_tile(pruned, block_m, precision, clustered_passes)
        for name in clustered_passes:
            check_kernel(name, pruned[name], precision, CLU_H,
                         f"clustered n={N_TRAIN} m={N_QUERY} d={D}, "
                         f"occupancy {pruned[name]['occupancy']:.4f}")
        del pruned
    # B1, B2, B3, B5 and B6 at d = 24 and 64 on the ragged shape
    for wd in WIDE_DS:
        n, m = SMALL[0], SMALL[1]
        x = torch.randn(n, wd, generator=gen, device=gen.device)
        y = torch.randn(m, wd, generator=gen, device=gen.device)
        hw = 0.5 * math.sqrt(wd)
        windex = sp.build_index(x, seed=SEED)
        for precision in TIERS:
            opnds = dict(kernel_operands(ops, x, y, precision, block_m,
                                         block_n, hw),
                         **pruned_operands(ops, sp, x, y, precision, block_m,
                                           block_n, hw, windex))
            for name in WIDE_PASSES:
                check_kernel(name, opnds[name], precision, hw,
                             f"n={n} d={wd} h={hw:.3f}")
            del opnds
    # d = 1, Fig. 4's largest shape: the dense kernels' DMAX = 4 build,
    # with coordinates past d zero in shared memory
    n, m = FIG4_NS[-1], FIG4_NS[-1] // 8
    x, y = mix1.sample(n, gen), mix1.sample(m, gen)
    for precision in TIERS:
        opnds = kernel_operands(ops, x, y, precision, block_m, block_n,
                                FIG4_H)
        for name, c in opnds.items():
            check_kernel(name, c, precision, FIG4_H, f"d=1 n={n} m={m}")
        del opnds
    # B7, unfused and fused: the ragged shapes, then Falcon-Mamba-7B's
    # layer shape
    from repro_torch.kernels import selective_scan as ss

    for shape in SCAN_RAGGED + (SCAN_MAIN,):
        for tname, dtype in SCAN_DTYPES.items():
            label = f"{tname} (B, S, D, N)={shape}"
            args = scan_inputs(shape, dtype, gen)
            res = check_scan(ss, args, label)
            del args
            args = fused_scan_inputs(shape, dtype, gen)
            fres = check_fused_scan(ss, args, label)
            del args
            if shape == SCAN_MAIN:
                results.setdefault("selective_scan", {})[tname] = res
                results.setdefault("mamba_scan", {})[tname] = fres
    return results


def reset_counts(fs, fk, fp, fl) -> None:
    from repro_torch.kernels import selective_scan as ss

    ss.launches = 0
    ss.fused_launches = 0
    fs.launches = 0
    fk.launches = 0
    fl.laplace_launches = 0
    fl.sq_moment_launches = 0
    fp.score_counts.reset()
    fp.kde_counts.reset()
    fp.laplace_counts.reset()


def read_counts(fs, fk, fp, fl) -> dict:
    from repro_torch.kernels import selective_scan as ss

    return {"flash_score": fs.launches, "flash_kde": fk.launches,
            "flash_score_pruned": fp.score_counts.launches,
            "flash_kde_pruned": fp.kde_counts.launches,
            "flash_laplace": fl.laplace_launches,
            "sq_moment": fl.sq_moment_launches,
            "flash_kde_pruned laplace": fp.laplace_counts.launches,
            "selective_scan": ss.launches,
            "mamba_scan": ss.fused_launches}


def check_launches(counts: dict, ran, what: str) -> None:
    """Every kernel in ``ran`` launched, and no other."""
    idle = [k for k in counts if k not in ran]
    if min(counts[k] for k in ran) < 1 or max(counts[k] for k in idle):
        raise AssertionError(f"{what} must launch {sorted(ran)} and no "
                             f"other kernel: {counts}")


def drive_estimator(est, x, y) -> dict:
    """fit(x) and two evaluate(y) (the first call may also build the
    clustered columns); densities and host times."""
    out = {}
    _, out["fit_ms"] = host_ms(lambda: est.fit(x))
    evals = []
    for _ in range(2):
        dens, ms = host_ms(lambda: est.evaluate(y))
        evals.append(ms)
    out.update(est=est, dens=dens, evaluate_first_ms=evals[0],
               evaluate_ms=evals[1])
    return out


def drive_engine(serve, x, y, method, prune, h=None) -> dict:
    """A ServeEngine registering x and answering two rounds of ragged
    requests and one query_many; answers, latencies and host times."""
    out = {}
    eng = serve.ServeEngine(serve.ServeConfig(backend="flash",
                                              method=method, prune=prune))
    _, out["register_ms"] = host_ms(lambda: eng.register("bench", x, h=h))
    out["h"] = eng.registry.get("bench").h
    answers, latencies, served, by_size = [], [], [], {}
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
                by_size[m] = ans.latency_s * 1e3
    many_sl, start = [], 0
    for m in MANY_SIZES:
        many_sl.append(slice(start, start + m))
        start += m
    many, out["query_many_ms"] = host_ms(lambda: eng.query_many(
        [serve.QueryRequest(key="bench", points=y[s]) for s in many_sl]))
    answers += [(s, a.value) for s, a in zip(many_sl, many)]
    lat = sorted(latencies)
    out.update(
        answers=answers, latency_ms_by_rows=by_size,
        p50_ms=lat[len(lat) // 2] * 1e3,
        p99_ms=lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)] * 1e3,
        qps=sum(served) / sum(latencies))
    return out


def drive(est_mod, serve, x, y, prune, h=None) -> dict:
    """The main path once: SDKDE fit + two evaluates, then the engine."""
    out = drive_estimator(est_mod.SDKDE(h, config=est_mod.EstimatorConfig(
        backend="flash", prune=prune)), x, y)
    out.update(drive_engine(serve, x, y, "sdkde", prune, out["est"].h))
    return out


def phase_main_path(mixture, gen, est_mod, kdemod, serve, fk, fs, fp,
                    fl) -> dict:
    log("== phase 4: main path")
    x = mixture.sample(N_TRAIN, gen)
    y = mixture.sample(N_QUERY, gen)
    sync()
    runs, launches = {}, {}
    for prune in ("auto", "off"):
        reset_counts(fs, fk, fp, fl)
        runs[prune] = r = drive(est_mod, serve, x, y, prune)
        sync()
        launches[prune] = counts = read_counts(fs, fk, fp, fl)
        log(f"  prune={prune!r}: SDKDE fit {N_TRAIN}x{D} "
            f"{r['fit_ms']:.2f} ms (h={r['est'].h:.6f}); evaluate "
            f"{N_QUERY} queries: first {r['evaluate_first_ms']:.2f} ms, "
            f"second {r['evaluate_ms']:.2f} ms; ServeEngine register "
            f"{r['register_ms']:.2f} ms; served (warm round) p50 "
            f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, "
            f"{r['qps']:.0f} query rows/s; query_many "
            f"{r['query_many_ms']:.3f} ms for {sum(MANY_SIZES)} rows")
        log(f"  prune={prune!r} ServeEngine latency by request rows (warm "
            "round, ms): " + ", ".join(f"{k}: {v:.3f}" for k, v in
                                       r["latency_ms_by_rows"].items()))
        log(f"  prune={prune!r} launches: {json.dumps(counts)}")
        if prune == "auto":
            occupancy = {"flash_score_pruned": fp.score_counts.occupancy,
                         "flash_kde_pruned": fp.kde_counts.occupancy}
            log(f"  occupancy of the pruned launches: B3 "
                f"{fp.score_counts.occupancy:.4f} "
                f"({fp.score_counts.tiles_visited}/"
                f"{fp.score_counts.tiles_total} tiles), B4 "
                f"{fp.kde_counts.occupancy:.4f} "
                f"({fp.kde_counts.tiles_visited}/"
                f"{fp.kde_counts.tiles_total} tiles)")
            ran = ("flash_score_pruned", "flash_kde_pruned")
        else:
            ran = ("flash_score", "flash_kde")
        check_launches(counts, ran, f"SDKDE prune={prune!r}")

    # the "torch" backend on the card is the reference; the flash paths
    # are held against it and against float64 on the first N_F64 queries
    auto, off = runs["auto"], runs["off"]
    h = auto["est"].h
    reset_counts(fs, fk, fp, fl)
    ref_dens = est_mod.SDKDE(h, est_mod.EstimatorConfig(
        backend="torch")).fit(x).evaluate(y)
    sync()
    if any(read_counts(fs, fk, fp, fl).values()):
        raise AssertionError("the torch backend launched a flash kernel")
    bar = TIER_BAR["f32"]
    compare(auto["dens"], off["dens"], bar, "SDKDE pruned (auto) vs dense "
            "(off)")
    compare(auto["dens"], ref_dens, bar, "SDKDE pruned vs torch backend")
    compare(off["dens"], ref_dens, bar, "SDKDE dense vs torch backend")
    for prune, r in runs.items():
        got = torch.cat([v for _, v in r["answers"]])
        want = torch.cat([ref_dens[s] for s, _ in r["answers"]])
        compare(got, want, bar, f"ServeEngine prune={prune!r} answers vs "
                "torch backend")
    f64 = kdemod.sdkde_eval(x.double(), y[:N_F64].double(), h)
    compare(auto["dens"][:N_F64], f64, bar,
            f"SDKDE pruned vs float64 ({N_F64} q)")
    compare(off["dens"][:N_F64], f64, bar,
            f"SDKDE dense vs float64 ({N_F64} q)")
    compare(ref_dens[:N_F64], f64, bar,
            f"SDKDE torch backend vs float64 ({N_F64} q)")

    true = mixture.pdf(y.double()).float()
    kde = est_mod.KDE(config=est_mod.EstimatorConfig(backend="flash"))
    kde_dens = kde.fit(x).evaluate(y)
    sd_err = float(((auto["dens"] - true).abs() / true).mean())
    kde_err = float(((kde_dens - true).abs() / true).mean())
    log(f"  mean relative error vs the mixture's pdf (information): "
        f"SD-KDE {sd_err:.4f}, KDE {kde_err:.4f}")
    keep = ("fit_ms", "evaluate_ms", "evaluate_first_ms", "register_ms",
            "p50_ms", "p99_ms", "qps", "query_many_ms",
            "latency_ms_by_rows")
    return {
        # for phase 10, not printed
        "data": {"x": x, "y": y, "h": h, "f64": f64,
                 "auto_dens": auto["dens"], "x_sd": off["est"].x_sd},
        "launches": {**{k: launches["off"][k]
                        for k in ("flash_score", "flash_kde")},
                     **{k: launches["auto"][k]
                        for k in ("flash_score_pruned",
                                  "flash_kde_pruned")}},
        "occupancy": occupancy,
        "auto": {k: auto[k] for k in keep},
        "off": {k: off[k] for k in keep},
        "sdkde_mean_rel_err": sd_err, "kde_mean_rel_err": kde_err,
    }


# (label, prune, fused) of the Laplace runs, and the kernels each must
# launch (and no other): "auto" prunes at this size
LAPLACE_RUNS = {"auto": ("auto", True, ("flash_kde_pruned laplace",)),
                "off": ("off", True, ("flash_laplace",)),
                "nonfused": ("auto", False, ("flash_kde", "sq_moment"))}
# ServeEngine(method="laplace") by prune, and the kernels each must launch
LAPLACE_SERVE_RUNS = {"auto": ("flash_kde_pruned laplace",),
                      "off": ("flash_laplace",)}


def phase_laplace_path(mixture, gen, est_mod, kdemod, serve, fk, fs, fp,
                       fl) -> dict:
    log(f"== phase 4c: Laplace path, {N_TRAIN} x {D} train, {N_QUERY} "
        "queries")
    x = mixture.sample(N_TRAIN, gen)
    y = mixture.sample(N_QUERY, gen)
    sync()
    runs, launches = {}, {}
    for label, (prune, fused, ran) in LAPLACE_RUNS.items():
        reset_counts(fs, fk, fp, fl)
        runs[label] = r = drive_estimator(est_mod.LaplaceKDE(
            config=est_mod.EstimatorConfig(backend="flash", prune=prune),
            fused=fused), x, y)
        sync()
        launches[label] = counts = read_counts(fs, fk, fp, fl)
        log(f"  LaplaceKDE {label} (prune={prune!r}, fused={fused}): fit "
            f"{r['fit_ms']:.2f} ms (h={r['est'].h:.6f}); evaluate "
            f"{N_QUERY} queries: first {r['evaluate_first_ms']:.2f} ms, "
            f"second {r['evaluate_ms']:.2f} ms; launches "
            f"{json.dumps(counts)}")
        check_launches(counts, ran, f"LaplaceKDE {label}")
        if label == "auto":
            occupancy = fp.laplace_counts.occupancy
            log(f"  occupancy of the pruned Laplace launches: "
                f"{occupancy:.4f} ({fp.laplace_counts.tiles_visited}/"
                f"{fp.laplace_counts.tiles_total} tiles)")
    h = runs["auto"]["est"].h

    engines = {}
    for prune, ran in LAPLACE_SERVE_RUNS.items():
        what = f"ServeEngine(method='laplace', prune={prune!r})"
        reset_counts(fs, fk, fp, fl)
        engines[prune] = eng = drive_engine(serve, x, y, "laplace", prune)
        sync()
        launches[f"serve_{prune}"] = counts = read_counts(fs, fk, fp, fl)
        log(f"  {what}: register {eng['register_ms']:.2f} ms (h="
            f"{eng['h']:.6f}); served (warm round) p50 {eng['p50_ms']:.3f} "
            f"ms, p99 {eng['p99_ms']:.3f} ms, {eng['qps']:.0f} query "
            f"rows/s; query_many {eng['query_many_ms']:.3f} ms for "
            f"{sum(MANY_SIZES)} rows; launches {json.dumps(counts)}")
        log(f"  {what} latency by request rows (warm round, ms): "
            + ", ".join(f"{k}: {v:.3f}" for k, v in
                        eng["latency_ms_by_rows"].items()))
        check_launches(counts, ran, what)
        if eng["h"] != h:
            raise AssertionError(f"the engine's Silverman h {eng['h']} is "
                                 f"not the estimator's {h}")
        served = sum(v.shape[0] for _, v in eng["answers"])
        if served != 2 * sum(SERVE_SIZES) + sum(MANY_SIZES):
            raise AssertionError(f"{what} answered {served} rows")

    # the "torch" backend on the card is the reference; every pair is
    # held per row within bar·(absolute mass), float64 on N_F64 queries
    reset_counts(fs, fk, fp, fl)
    ref_dens = est_mod.LaplaceKDE(h, est_mod.EstimatorConfig(
        backend="torch")).fit(x).evaluate(y)
    sync()
    if any(read_counts(fs, fk, fp, fl).values()):
        raise AssertionError("the torch backend launched a flash kernel")
    mass = laplace_mass(kdemod, x, y, h)
    bar = f32_bar(torch.cat([x, y]), 1 / (2 * h * h))
    auto, off, nonf = (runs[k]["dens"] for k in ("auto", "off", "nonfused"))
    errors = {
        "fused_vs_nonfused": compare_mass(
            auto, nonf, mass, bar, "Laplace fused (pruned) vs non-fused"),
        "pruned_vs_dense": compare_mass(
            auto, off, mass, bar, "Laplace pruned (auto) vs dense (off)"),
        "dense_vs_nonfused": compare_mass(
            off, nonf, mass, bar, "Laplace dense fused vs non-fused"),
        "fused_vs_torch": compare_mass(
            auto, ref_dens, mass, bar, "Laplace fused vs torch backend"),
        "nonfused_vs_torch": compare_mass(
            nonf, ref_dens, mass, bar, "Laplace non-fused vs torch backend"),
    }
    for prune, eng in engines.items():
        got = torch.cat([v for _, v in eng["answers"]])
        sl = torch.cat([torch.arange(s.start, s.stop, device=y.device)
                        for s, _ in eng["answers"]])
        errors[f"serve_{prune}_vs_torch"] = compare_mass(
            got, ref_dens[sl], mass[sl], bar,
            f"ServeEngine(method='laplace', prune={prune!r}) answers vs "
            "torch backend")
    f64 = kdemod.laplace_kde_eval(x.double(), y[:N_F64].double(), h)
    m64 = mass[:N_F64]
    for name, dens in (("auto", auto), ("off", off), ("nonfused", nonf),
                       ("torch", ref_dens)):
        errors[f"{name}_vs_f64"] = compare_mass(
            dens[:N_F64], f64, m64, bar,
            f"Laplace {name} vs float64 ({N_F64} q)")
    neg = float((auto < 0).double().mean())
    log(f"  share of queries with a negative Laplace density "
        f"(information): {neg:.4f}")
    keep = ("fit_ms", "evaluate_first_ms", "evaluate_ms")
    return {
        "launches": launches, "bar": bar, "errors": errors,
        "negative_share": neg, "occupancy": occupancy,
        "ms": {**{label: {k: runs[label][k] for k in keep}
                  for label in runs},
               **{f"serve_{prune}": {k: eng[k] for k in (
                   "register_ms", "p50_ms", "p99_ms", "qps",
                   "query_many_ms", "latency_ms_by_rows")}
                  for prune, eng in engines.items()}},
    }


def phase_clustered(ops, sp, kdemod, fp, dev) -> dict:
    log(f"== phase 4b: clustered check, {N_TRAIN} x {D} from {CLU_K} "
        f"centres in [0, {CLU_SPREAD:g}]^{D}, sigma 1, h {CLU_H}")
    x, y = clustered_set(dev)
    h = CLU_H
    bar = f32_bar(torch.cat([x, y]), 1 / (2 * h * h))
    fp.score_counts.reset()
    fp.kde_counts.reset()
    s0p, s1p = ops.flash_score_stats(x, h, prune=0.0)
    dens0 = ops.flash_kde(x, y, h, prune=0.0)
    sync()
    occ = {"flash_score_pruned": fp.score_counts.occupancy,
           "flash_kde_pruned": fp.kde_counts.occupancy}
    log(f"  occupancy at prune=0.0: B3 {occ['flash_score_pruned']:.4f} "
        f"({fp.score_counts.tiles_visited}/{fp.score_counts.tiles_total} "
        f"tiles), B4 {occ['flash_kde_pruned']:.4f} "
        f"({fp.kde_counts.tiles_visited}/{fp.kde_counts.tiles_total})")
    if max(occ.values()) > CLU_MAX_OCCUPANCY:
        raise AssertionError(f"clustered check: occupancy {occ} above "
                             f"{CLU_MAX_OCCUPANCY}: tiles are not skipped")
    # information: k-means starts from random points, so how well the
    # set prunes depends on the index's seed
    spread = {}
    for seed in range(4):
        index = sp.build_index(x, seed=seed)
        lay = sp.cluster_layout(x, index.labels, 128, total_multiple=128)
        meta = sp.tile_metadata(lay.points, lay.real, block=128)
        keep = sp.tile_map(lay.points, meta, ops._inv2h2(h, dev), 0.0,
                           block_m=128, kind="score").keep
        spread[seed] = sp.visit_lists(keep).occupancy
    log("  score-pass occupancy by k-means seed (information): "
        + ", ".join(f"seed {k} {v:.4f}" for k, v in spread.items()))
    s0d, s1d = ops.flash_score_stats(x, h, prune="off")
    dense = ops.flash_kde(x, y, h, prune="off")
    compare(s0p, s0d, bar, "S0 prune=0.0 vs dense")
    compare(s1p, s1d, 0.0, "S1 prune=0.0 vs dense (against the peak)",
            atol_frac=bar)
    compare(dens0, dense, bar, "KDE prune=0.0 vs dense")

    # prune=1e-7: every row's float64 error within its certificate
    yq = y[:N_CLU_F64]
    cols = ops.prepare_train_columns(x, block_n=128, clustered=True)
    got = ops._pruned_eval_sums(yq, cols, h, CLU_EPS, precision="f32",
                                block_m=128, block_n=128).double()
    ql = sp.cluster_layout(yq, sp.assign(yq, cols.index), 128,
                           bucket_rows=True)
    tm = sp.tile_map(ql.points, cols.meta, ops._inv2h2(h, dev), CLU_EPS,
                     block_m=128, kind="kde")
    row_err = tm.err_bound.double()[ql.slots // 128]
    exact = kdemod.kde_eval(x.double(), yq.double(), h) * (
        N_TRAIN * (2 * math.pi) ** (D / 2) * h**D)
    excess = (got - exact).abs() - (row_err * (1 + 1e-5) + bar * exact
                                    + 1e-30)
    eps_occ = sp.visit_lists(tm.keep).occupancy
    log(f"  prune={CLU_EPS:g}: occupancy {eps_occ:.4f}, max certificate "
        f"{float(row_err.max()):.3e}, max |f64 error| "
        f"{float((got - exact).abs().max()):.3e}, worst margin "
        f"{float(excess.max()):.3e} (must be <= 0)")
    if float(excess.max()) > 0:
        raise AssertionError("clustered check: a row's float64 error "
                             "exceeds its certificate")
    return {"x": x, "y": y, "occupancy": occ, "eps_occupancy": eps_occ,
            "occupancy_by_seed": spread}


def timed_entry(name, c, precision, h, errors) -> dict:
    """The kernel's device time (``graph_ms``) and its wrapper call's time
    (CUDA events around one call, host work included), the plain
    version's call time and the bound."""
    ms = graph_ms(c["kernel"])
    call = cuda_ms(c["kernel"], 10)
    plain = cuda_ms(c["plain"], 3)
    bms, by = bound_ms(c["kind"], precision, c["pairs"], D, c["moved"])
    occ = (f", occupancy {c['occupancy']:.4f}, max_visits "
           f"{c['max_visits']}" if "occupancy" in c else "")
    log(f"  {name} {precision}: kernel {ms:.4f} ms (call {call:.4f} ms), "
        f"plain {plain:.3f} ms, bound {bms:.4f} ms ({by}), "
        f"{bms / ms * 100:.1f}% of bound{occ}")
    entry = {"ms": ms, "call_ms": call, "plain_ms": plain, "bound_ms": bms,
             "bound_by": by, "pairs": c["pairs"]}
    if "occupancy" in c:
        entry.update(occupancy=c["occupancy"], max_visits=c["max_visits"])
    if errors is not None:
        entry.update(errors[name][precision])
    return entry


def phase_timings(ops, sp, mixture, gen, block_m, block_n, errors,
                  clustered) -> dict:
    log(f"== phase 5: timings at the main path's shape "
        f"(n={N_TRAIN}, m={N_TRAIN}, d={D})")
    x = mixture.sample(N_TRAIN, gen)
    h = 0.78
    index, index_ms = host_ms(lambda: sp.build_index(x, seed=SEED))
    entries = {}
    prep_times = {"main": {"kmeans": index_ms}}
    for precision in TIERS:
        opnds = kernel_operands(ops, x, x, precision, block_m, block_n, h)
        pre_t = prep_times["main"] if precision == "f32" else None
        opnds.update(pruned_operands(ops, sp, x, x, precision, block_m,
                                     block_n, h, index, times=pre_t))
        for name, c in opnds.items():
            entries.setdefault(name, {})[precision] = timed_entry(
                name, c, precision, h, errors)
        del opnds
    log("  host prepass at the main shape, f32 (ms, synchronized): "
        + ", ".join(f"{k} {v:.2f}" for k, v in prep_times["main"].items()))

    log(f"  one serving request of {REQUEST_ROWS} query rows against "
        f"n={N_TRAIN}:")
    for precision in TIERS:
        opnds = dict(kernel_operands(ops, x, x[:REQUEST_ROWS], precision,
                                     block_m, block_n, h),
                     **pruned_operands(ops, sp, x, x[:REQUEST_ROWS],
                                       precision, block_m, block_n, h,
                                       index))
        for name in KDE_PASSES:
            c = opnds[name]
            rows = c["args"][0].shape[0] if name in DENSE_KDE_PASSES else \
                c["real"].shape[0]
            entry = timed_entry(f"{name} request", c, precision, h, None)
            entry["rows_launched"] = rows
            entries[name].setdefault("request", {})[precision] = entry
        del opnds

    log(f"  clustered set (h={CLU_H}):")
    cx, cy = clustered["x"], clustered["y"]
    cindex, cms = host_ms(lambda: sp.build_index(cx, seed=SEED))
    prep_times["clustered"] = {"kmeans": cms}
    for precision in TIERS:
        pruned = pruned_operands(
            ops, sp, cx, cy, precision, block_m, block_n, CLU_H, cindex,
            times=prep_times["clustered"] if precision == "f32" else None)
        for name in ("flash_score_pruned", "flash_kde_pruned",
                     "flash_kde_pruned laplace"):
            c = pruned[name]
            check_kernel(name, c, precision, CLU_H, "clustered")
            entries[name].setdefault("clustered", {})[precision] = \
                timed_entry(name, c, precision, CLU_H, None)
        del pruned
    log("  host prepass on the clustered set, f32 (ms, synchronized): "
        + ", ".join(f"{k} {v:.2f}"
                    for k, v in prep_times["clustered"].items()))

    from repro_torch.kernels import selective_scan as ss

    modes = {"selective_scan": (scan_inputs, ss.selective_scan_cuda,
                                ss.selective_scan_plain, False),
             "mamba_scan": (fused_scan_inputs, ss.mamba_scan_cuda,
                            ss.mamba_scan_plain, True)}
    for tname, dtype in SCAN_DTYPES.items():
        for mode, (inputs, kernel, plain_fn, fused) in modes.items():
            args = inputs(SCAN_MAIN, dtype, gen)
            ms = graph_ms(lambda: kernel(*args))
            call = cuda_ms(lambda: kernel(*args), 10)
            plain = cuda_ms(lambda: plain_fn(*args), 3)
            bms, by = scan_bound_ms(SCAN_MAIN, dtype, fused=fused)
            log(f"  {mode} {tname} (B, S, D, N)={SCAN_MAIN}: kernel "
                f"{ms:.4f} ms (call {call:.4f} ms), plain {plain:.3f} ms, "
                f"bound {bms:.4f} ms ({by}), {bms / ms * 100:.1f}% of bound")
            entries.setdefault(mode, {})[tname] = dict(
                ms=ms, call_ms=call, plain_ms=plain, bound_ms=bms,
                bound_by=by, max_abs_err=errors[mode][tname]["max_abs_err"])
            del args
    return {"entries": entries, "prepass_ms": prep_times}


def fusion_case(ops, fk, fl, kdemod, x, y, h, block_m, block_n) -> dict:
    """Fused (B5) against non-fused (B2 + B6) on one shape: the kernels
    alone on the same prepared operands, and the ops wrappers end to end
    (padding, norms, transposes, normalization; fused with prune="off",
    as the non-fused baseline is always dense).  CUDA-event medians in
    the order fused, non-fused, non-fused, fused; each side's two
    medians are averaged."""
    y_ops, xt_ops, nrm_y, nrm_x = ops._prep_eval(x, y, block_m, block_n,
                                                 "f32")
    args = (y_ops[0], nrm_y, xt_ops[0], nrm_x, ops._inv2h2(h, x.device))
    bk = dict(block_m=block_m, block_n=block_n)
    pairs = {
        "kernels": (lambda: fl.flash_laplace_cuda(*args, **bk),
                    lambda: (fk.flash_kde_cuda(*args, **bk),
                             fl.sq_moment_cuda(*args, **bk))),
        "ops": (lambda: ops.flash_laplace_kde(x, y, h, prune="off", **bk),
                lambda: ops.laplace_kde_nonfused(x, y, h, **bk)),
    }
    out = {}
    for level, (fused, nonfused) in pairs.items():
        f1, n1, n2, f2 = (cuda_ms(fn, 20)
                          for fn in (fused, nonfused, nonfused, fused))
        out[level] = {"fused_ms": (f1 + f2) / 2,
                      "nonfused_ms": (n1 + n2) / 2,
                      "fused_runs": [f1, f2], "nonfused_runs": [n1, n2]}
        out[level]["speedup"] = (out[level]["nonfused_ms"]
                                 / out[level]["fused_ms"])
    out["blocks"] = -(-y.shape[0] // block_m)
    bar = f32_bar(torch.cat([x, y]), 1 / (2 * h * h))
    compare_mass(ops.flash_laplace_kde(x, y, h, prune="off", **bk),
                 ops.laplace_kde_nonfused(x, y, h, **bk),
                 laplace_mass(kdemod, x, y, h), bar,
                 f"fusion n={x.shape[0]} m={y.shape[0]} d={x.shape[1]}: "
                 "fused vs non-fused")
    return out


def phase_fusion(ops, fk, fl, kdemod, mixture, mix1, gen, block_m,
                 block_n) -> dict:
    log("== phase 5b: fusion, fused (B5) vs non-fused (B2 + B6), f32")
    cases = {"main": (mixture.sample(N_TRAIN, gen),
                      mixture.sample(N_QUERY, gen), 0.78)}
    for n in FIG4_NS:
        cases[f"fig4 n={n}"] = (mix1.sample(n, gen), mix1.sample(n // 8, gen),
                                FIG4_H)
    out = {}
    for label, (x, y, h) in cases.items():
        r = out[label] = fusion_case(ops, fk, fl, kdemod, x, y, h, block_m,
                                     block_n)
        r.update(n=x.shape[0], m=y.shape[0], d=x.shape[1], h=h)
        k, o = r["kernels"], r["ops"]
        log(f"  {label} (n={r['n']}, m={r['m']}, d={r['d']}, {r['blocks']} "
            f"blocks of {block_m} rows): kernels fused {k['fused_ms']:.4f} "
            f"ms vs non-fused {k['nonfused_ms']:.4f} ms "
            f"({k['speedup']:.2f}x); ops fused {o['fused_ms']:.4f} ms vs "
            f"non-fused {o['nonfused_ms']:.4f} ms ({o['speedup']:.2f}x)")
    return out


def oracle_allowance(torch_vals, mass, bar):
    """Per-point allowance |flash − torch| may reach: bar·mass for the
    Laplace densities, bar·|p̂| for the positive KDE and SD-KDE sums.  No
    absolute floor: the integrals weigh a point by 1/q, which is huge in
    the tails, so a floor would integrate to nothing meaningful there;
    bar·|p̂| integrates to bar·∫|p̂|."""
    if mass is not None:
        return bar * mass
    return bar * torch_vals.double().abs()


def phase_oracle(est_mod, bw, metrics, mixtures, kdemod, dev) -> dict:
    log("== phase 7: oracle errors (MISE, MIAE, negative mass) against "
        "the known mixture, Silverman h, seed 0")
    settings = {"fig3 1-d": (mixtures.benchmark_mixture_1d(), ORACLE_N_1D),
                "fig2 16-d": (mixtures.benchmark_mixture_16d(), N_TRAIN)}
    out = {}
    for label, (mix, n) in settings.items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        x = mix.sample(n, gen)
        h = float(bw.silverman_bandwidth(x))
        if mix.dim == 1:
            span = float(mix.stds.max()) * 6.0
            lo = float(mix.means.min()) - span
            hi = float(mix.means.max()) + span
            z = torch.linspace(lo, hi, 2048, dtype=torch.float32,
                               device=dev)[:, None]
            weight = torch.full((2048,), (hi - lo) / 2047,
                                dtype=torch.float64, device=dev)

            def errors(fn):
                return metrics.oracle_errors(fn, mix, device="cuda")
        else:
            z = metrics.widened_proposal(mix).sample(N_MC, gen)
            weight = 1.0 / metrics.widened_proposal(mix).pdf(
                z.double()).clamp(min=metrics.Q_FLOOR) / N_MC

            def errors(fn):
                return metrics.oracle_errors_at(fn, mix, z)
        p = mix.pdf(z.double())
        mass = laplace_mass(kdemod, x, z, h)
        bar = f32_bar(torch.cat([x, z]), 1 / (2 * h * h))
        res, vals = {}, {}
        for backend in ("flash", "torch"):
            cfg = est_mod.EstimatorConfig(backend=backend)
            ests = {"kde": est_mod.KDE(h, cfg),
                    "sdkde": est_mod.SDKDE(h, cfg),
                    "laplace": est_mod.LaplaceKDE(h, cfg),
                    "laplace_nonfused": est_mod.LaplaceKDE(h, cfg,
                                                           fused=False)}
            for name, est in ests.items():
                est.fit(x)
                v = vals[(name, backend)] = est.evaluate(z)
                e = errors(lambda pts, v=v: v)
                res[(name, backend)] = e
        out[label] = {"n": n, "h": h, "points": z.shape[0], "bar": bar}
        log(f"  {label}: n={n}, h={h:.6f}, "
            + ("grid of 2048 points" if mix.dim == 1
               else f"{N_MC} importance samples (widened proposal)"))
        for name in ORACLE_METHODS:
            f, t = res[(name, "flash")], res[(name, "torch")]
            fv, tv = vals[(name, "flash")], vals[(name, "torch")]
            lap = name.startswith("laplace")
            allow = oracle_allowance(tv, mass if lap else None, bar)
            diff = (fv.double() - tv.double()).abs()
            ratio = float((diff / allow.clamp(min=1e-300)).max())
            if float((diff - allow).max()) > 0:
                raise AssertionError(f"{label} {name}: flash vs torch "
                                     "densities outside the per-point bar "
                                     f"(worst |diff|/allowance {ratio})")
            err = (tv.double() - p).abs()
            mise_tol = float(((2 * err * allow + allow**2) * weight).sum())
            miae_tol = float((allow * weight).sum())
            if (abs(f.mise - t.mise) > mise_tol
                    or abs(f.miae - t.miae) > miae_tol):
                raise AssertionError(
                    f"{label} {name}: flash MISE/MIAE {f.mise}/{f.miae} vs "
                    f"torch {t.mise}/{t.miae} beyond {mise_tol}/{miae_tol}")
            out[label][name] = {
                "mise": f.mise, "miae": f.miae, "neg_mass": f.neg_mass,
                "torch_mise": t.mise, "torch_miae": t.miae,
                "torch_neg_mass": t.neg_mass, "mise_tol": mise_tol,
                "miae_tol": miae_tol, "worst_point_ratio": ratio}
            log(f"    {name:17s} flash MISE {f.mise:.6e} MIAE {f.miae:.6e} "
                f"neg mass {f.neg_mass:.6e} | torch MISE {t.mise:.6e} "
                f"(|diff| {abs(f.mise - t.mise):.2e} <= {mise_tol:.2e}) "
                f"MIAE {t.miae:.6e} (|diff| {abs(f.miae - t.miae):.2e} <= "
                f"{miae_tol:.2e}); worst point |diff|/allowance "
                f"{ratio:.3f}")
        compare_mass(vals[("laplace", "flash")],
                     vals[("laplace_nonfused", "flash")], mass, bar,
                     f"{label}: Laplace fused vs non-fused at the points")
        order = sorted(ORACLE_METHODS, key=lambda k: out[label][k]["mise"])
        out[label]["mise_order"] = order
        log(f"    MISE order, lowest first (information): "
            f"{' < '.join(order)}")
    return out


def phase_paper_scale(mixture, gen, est_mod, fs, fk, fp, fl) -> dict:
    n, m = 1_048_576, 131_072
    log(f"== phase 6: paper scale, {n} x {D} train, {m} queries")
    # the fit's score pass (B1, and B3 at any visit width) runs one split:
    # the row blocks alone fill the card, no scratch, no second pass
    cfg = est_mod.EstimatorConfig()
    plans = {"off": fs.plan_score_splits(n, cfg.block_n, D),
             "auto": fs.plan_score_splits(n, cfg.block_n, D,
                                          n // cfg.block_n)}
    for prune, plan in plans.items():
        log(f"  score-pass plan, prune={prune!r}: {plan.splits} split(s) "
            f"of {plan.per_split} slots, scratch "
            f"{plan.scratch_shape(n)}")
        if plan.splits != 1 or plan.scratch_shape(n) is not None:
            raise AssertionError(f"paper-scale score pass must run one "
                                 f"split with no scratch: {plan}")
    x = mixture.sample(n, gen)
    y = mixture.sample(m, gen)
    sync()
    out, dens = {}, {}
    true = mixture.pdf(y.double()).float()
    for prune in ("auto", "off"):
        reset_counts(fs, fk, fp, fl)
        est = est_mod.SDKDE(config=est_mod.EstimatorConfig(
            backend="flash", prune=prune))
        _, fit_ms = host_ms(lambda: est.fit(x))
        dens[prune], eval_ms = host_ms(lambda: est.evaluate(y))
        d = dens[prune]
        if not bool(torch.isfinite(d).all()) or d.shape != (m,):
            raise AssertionError("paper-scale densities are not finite")
        err = float(((d - true).abs() / true).mean())
        out[prune] = {"fit_s": fit_ms / 1e3, "evaluate_s": eval_ms / 1e3,
                      "score_splits": plans[prune].splits,
                      "total_s": (fit_ms + eval_ms) / 1e3,
                      "launches": read_counts(fs, fk, fp, fl),
                      "mean_rel_err_vs_pdf": err}
        occ = (f"; occupancy B3 {fp.score_counts.occupancy:.4f}, B4 "
               f"{fp.kde_counts.occupancy:.4f}" if prune == "auto" else "")
        log(f"  prune={prune!r}: fit {fit_ms / 1e3:.3f} s, evaluate "
            f"{eval_ms / 1e3:.3f} s, end to end "
            f"{(fit_ms + eval_ms) / 1e3:.3f} s; mean relative error vs pdf "
            f"{err:.4f}; launches {json.dumps(out[prune]['launches'])}"
            f"{occ}")
        del est
    compare(dens["auto"], dens["off"], TIER_BAR["f32"],
            "paper scale: auto vs off densities")
    return out


def compare_model(got, want, what: str) -> dict:
    """f32 logits or states of two forms of one model: rtol MODEL_RTOL,
    atol MODEL_ATOL of the largest magnitude (see MODEL_RTOL)."""
    return compare(got, want, MODEL_RTOL, what, atol_frac=MODEL_ATOL)


GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "gemv")
# elementwise work of the Mamba block's eager glue, counted by name in a
# profile: with the fused scan no softplus runs, and silu once a layer
# (the conv's; the gate's runs inside B7)
GLUE_WORDS = ("softplus", "silu")
_DEMANGLED_SCAN = re.compile(
    r"selective_scan_kernel<(float|__nv_bfloat16), (\d+), (true|false)>")
_FUNCTOR = re.compile(r"\w+Functor\w*|\w+_kernel\w*")
_WRAPPERS = ("BinaryFunctor", "AUnaryFunctor", "BUnaryFunctor",
             "gpu_kernel_impl", "gpu_kernel_impl_nocast")
TOP_OTHER = 12


def short_kernel_name(name: str) -> str:
    """A profiled kernel's name, short: B7's mode and instantiation,
    PyTorch's elementwise kernels as "kernel functor", any other name cut
    to 80 characters."""
    m = _DEMANGLED_SCAN.search(name)
    if m:
        mode = "mamba_scan" if m.group(3) == "true" else "selective_scan"
        return (f"B7 {mode}<{'f32' if m.group(1) == 'float' else 'bf16'},"
                f"{m.group(2)}>")
    outer = re.match(r"(?:void )?(?:\w+::)*(\w+)<", name)
    if outer is None or "at::native" not in name:
        return name[:80]
    inner = [f for f in _FUNCTOR.findall(name, outer.end())
             if f not in _WRAPPERS]
    return f"{outer.group(1)} {inner[0] if inner else '?'}"


def device_breakdown(fn, label: str) -> dict:
    """One warm call of ``fn`` under torch.profiler: the device kernels'
    time summed by class (GEMMs, B7, everything else), the "other" class
    by kernel name with launch counts (the top ``TOP_OTHER``), launches
    whose name holds a ``GLUE_WORDS`` word, and the device's busy time
    (the union of the kernels' intervals), beside the call's host-clock
    time; the idle share is 1 − busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        _, wall_ms = host_ms(fn)
    classes = {"gemm": 0.0, "B7": 0.0, "other": 0.0}
    glue = dict.fromkeys(GLUE_WORDS, 0)
    by_name, other, spans = {}, {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        name = e.name.lower()
        kind = ("B7" if "selective_scan" in name else
                "gemm" if any(k in name for k in GEMM_KERNELS) else "other")
        classes[kind] += (t1 - t0) / 1e3
        for word in GLUE_WORDS:
            glue[word] += word in name
        short = short_kernel_name(e.name)
        for table in (by_name, other) if kind == "other" else (by_name,):
            ms, count = table.get(short, (0.0, 0))
            table[short] = (ms + (t1 - t0) / 1e3, count + 1)
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    busy /= 1e3

    def ranked(table, k):
        return [{"ms": t, "count": c, "kernel": n} for t, c, n in
                sorted(((ms, c, n) for n, (ms, c) in table.items()),
                       reverse=True)[:k]]

    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall_ms if busy else None,
           "by_class_ms": classes, "glue_launches": glue,
           "top": ranked(by_name, 6), "other_by_kernel": ranked(other,
                                                                TOP_OTHER)}
    if not busy:
        log(f"  {label}: the profiler recorded no device time (not "
            f"measured); host clock {wall_ms:.1f} ms")
        return out
    log(f"  {label}: host clock {wall_ms:.1f} ms, device busy {busy:.1f} ms"
        f" (idle share {out['idle_share']:.3f}); kernel time by class: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in classes.items())
        + "; top kernels: "
        + "; ".join(f"{r['kernel']} {r['ms']:.2f} ms x{r['count']}"
                    for r in out["top"][:4]))
    log(f"    other by kernel (top {TOP_OTHER}): "
        + "; ".join(f"{r['kernel']} {r['ms']:.2f} ms x{r['count']}"
                    for r in out["other_by_kernel"])
        + "; launches naming " + ", ".join(f"{k} {v}"
                                           for k, v in glue.items()))
    return out


def check_monitor(ops, mon: dict) -> dict:
    """The monitor's launches on the serving path, held against their
    plain versions on the same operands: B1 on the projected reference's
    fit rows, B2 on the debiased fit rows against the held-out rows and
    against the scored requests.  d is the monitor's projection width (8:
    the dense kernels' DMAX = 8 build, which no other phase runs) and the
    fit rows fill less than one 128-row tile.  Bars as ``check_kernel``
    holds every dense launch: the tier's, never below the f32 norm-trick
    model."""
    m = mon["fitted"]
    est, cfg = m._est, m.config
    _, held_z = m.split(m._project(mon["ref_acts"]))
    score_z = m._project(mon["acts"])
    cases = (("flash_score", est.x_train, est.x_train, cfg.score_h or est.h,
              "fit rows"),
             ("flash_kde", est.x_sd, held_z, est.h, "held-out rows"),
             ("flash_kde", est.x_sd, score_z, est.h, "scored requests"))
    out = {}
    for name, x, y, h, label in cases:
        c = kernel_operands(ops, x, y, cfg.precision, cfg.block_m,
                            cfg.block_n, h)[name]
        out[f"{name} {label}"] = check_kernel(
            name, c, cfg.precision, h, f"monitor {label}: n={x.shape[0]} "
            f"m={y.shape[0]} d={x.shape[1]}")
    return out


def phase_ssm_serve(ops, fs, fk, fp, fl) -> dict:
    import dataclasses

    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import common, transformer
    from repro_torch.models import ssm as ssm_mod

    cfg = serve_mod.build_config(SERVE_ARCH, layers=SERVE_LAYERS)
    full = serve_mod.build_config(SERVE_ARCH)
    log(f"== phase 8: SSM serving path, {SERVE_ARCH} at full width "
        f"(d_model {cfg.d_model}, d_inner {cfg.d_inner}, N "
        f"{cfg.ssm_state}, vocab {cfg.vocab_size}, {cfg.dtype}), "
        f"{cfg.n_layers} of {full.n_layers} layers")
    if cfg.n_layers < full.n_layers:
        log(f"  depth cut to {cfg.n_layers} layers (width kept)")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params, init_ms = host_ms(lambda: common.init_params(cfg, gen, "cuda"))
    n_params = common.param_count(cfg)
    gb = sum(nbytes(t) for t in params.values()) / 1e9
    log(f"  {n_params} parameters ({gb:.2f} GB) initialised on the card "
        f"in {init_ms:.0f} ms")
    reset_counts(fs, fk, fp, fl)
    ss.plain_calls = 0
    ss.fused_plain_calls = 0
    ssm_mod.assoc_scans = 0
    r, gen_ms = host_ms(lambda: serve_mod.generate(
        SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
        gen=SERVE_GEN, seed=SEED, layers=SERVE_LAYERS, monitor=True,
        monitor_len=MONITOR_LEN, params=params))
    counts = read_counts(fs, fk, fp, fl)
    scans = r["scan_counts"]
    n_l = cfg.n_layers
    log(f"  launches: {json.dumps(counts)}; scan paths per stage: "
        f"{json.dumps(scans)}")
    # the fused B7 once a layer per forward pass (the monitor's: 8
    # reference batches and the requests), no other scan path
    want = {stage: {"selective_scan": 0, "selective_scan_plain": 0,
                    "mamba_scan": k * n_l, "mamba_scan_plain": 0,
                    "assoc_scan": 0}
            for stage, k in (("prefill", 1), ("decode", 0), ("monitor", 9))}
    if scans != want:
        raise AssertionError(f"scan paths {scans}, expected {want}")
    if counts["mamba_scan"] != 10 * n_l or ss.plain_calls or \
            ss.fused_plain_calls or ssm_mod.assoc_scans:
        raise AssertionError("another scan path ran on the serving path")
    check_launches(counts, ("mamba_scan", "flash_score", "flash_kde"),
                   "the SSM serving path")
    mon_checks = check_monitor(ops, r["monitor"])
    toks = r["tokens"]
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_GEN + 1) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.padded_vocab:
        raise AssertionError(f"generated ids {tuple(toks.shape)} out of "
                             "range")
    mon = r["monitor"]
    ids = lm_batch(cfg, SEED, 0, SERVE_BATCH, SERVE_PROMPT, "cuda")["tokens"]
    with torch.inference_mode():
        _, warm_ms = host_ms(lambda: transformer.prefill(params, ids, cfg))
        prof_prefill = device_breakdown(
            lambda: transformer.prefill(params, ids, cfg),
            f"prefill {SERVE_BATCH} x {SERVE_PROMPT}, profiled")
        _, cache = transformer.prefill(params, ids, cfg)
        tok = ids[:, -1:]
        prof_decode = device_breakdown(
            lambda: transformer.decode_step(params, cache, tok, cfg),
            f"one decode step, batch {SERVE_BATCH}, profiled")
        del cache
    glue = prof_prefill["glue_launches"]
    if prof_prefill["device_busy_ms"] and (glue["softplus"] or
                                           glue["silu"] > n_l):
        raise AssertionError(f"the prefill ran eager glue the fused B7 "
                             f"takes in (softplus 0 and silu <= {n_l}, the "
                             f"conv's, expected): {glue}")
    out = {"layers": n_l, "params": n_params, "init_ms": init_ms,
           "prefill_ms": r["prefill_ms"], "prefill_warm_ms": warm_ms,
           "decode_s": r["decode_s"], "decode_tok_s": r["decode_tok_s"],
           "generate_ms": gen_ms,
           "peak_memory_gib": r["peak_memory_bytes"] / 2**30,
           "peak_memory_gib_by_stage": {
               k: v / 2**30 for k, v in r["peak_memory_by_stage"].items()},
           "monitor_ms": mon["ms"], "monitor_len": mon["monitor_len"],
           "monitor_flags": int(mon["flags"].sum()),
           "monitor_checks": mon_checks, "launches": counts,
           "prefill_launches": scans["prefill"]["mamba_scan"],
           "profile": {"prefill": prof_prefill, "decode_step": prof_decode}}
    log(f"  prefill {SERVE_BATCH} x {SERVE_PROMPT} tokens: "
        f"{r['prefill_ms']:.1f} ms (first call), {warm_ms:.1f} ms (again); "
        f"decode {SERVE_GEN} steps x batch {SERVE_BATCH}: "
        f"{r['decode_s']:.3f} s, {r['decode_tok_s']:.1f} tok/s; peak memory "
        f"{out['peak_memory_gib']:.2f} GiB ("
        + ", ".join(f"{k} {v:.2f}" for k, v in
                    out["peak_memory_gib_by_stage"].items())
        + f"); monitor ({mon['ref_rows']} "
        f"reference sequences of {mon['monitor_len']} tokens) "
        f"{mon['ms']:.0f} ms, {out['monitor_flags']}/{SERVE_BATCH} flagged; "
        f"logits finite; generate {gen_ms:.0f} ms in all")
    del params, r, mon
    torch.cuda.empty_cache()

    # the two checks of the path at full width, depth 2, f32
    c32 = dataclasses.replace(
        serve_mod.build_config(SERVE_ARCH, layers=CHECK_LAYERS),
        dtype=torch.float32, param_dtype=torch.float32)
    p32 = common.init_params(c32, gen, "cuda")
    ids = lm_batch(c32, SEED, 1, CHECK_BATCH, CHECK_PROMPT + 1,
                   "cuda")["tokens"]
    log(f"  checks at full width, {CHECK_LAYERS} layers, f32, batch "
        f"{CHECK_BATCH}, prompt {CHECK_PROMPT}:")
    with torch.inference_mode():
        k_logits, k_cache = transformer.prefill(p32, ids[:, :-1], c32)
        a_logits, a_cache = transformer.prefill(
            p32, ids[:, :-1], dataclasses.replace(c32, ssm_kernel=False))
        sync()
        out["checks"] = {
            "kernel_vs_assoc_logits": compare_model(
                k_logits, a_logits, "prefill through the fused B7 vs the "
                "associative scan, logits"),
            "kernel_vs_assoc_ssm": compare_model(
                k_cache["ssm"], a_cache["ssm"], "prefill through the fused "
                "B7 vs the associative scan, SSM states")}
        del a_cache
        # decode_step advances k_cache in place
        step, cache = transformer.decode_step(p32, k_cache, ids[:, -1:],
                                              c32)
        longer, lcache = transformer.prefill(p32, ids, c32)
        sync()
        out["checks"].update({
            "decode_vs_prefill_logits": compare_model(
                step, longer, "prefill(p[:S]) + one decode step vs "
                "prefill(p[:S+1]), logits"),
            "decode_vs_prefill_ssm": compare_model(
                cache["ssm"], lcache["ssm"], "prefill(p[:S]) + one decode "
                "step vs prefill(p[:S+1]), SSM states"),
            "decode_vs_prefill_conv": compare_model(
                cache["conv"], lcache["conv"], "prefill(p[:S]) + one "
                "decode step vs prefill(p[:S+1]), conv windows")})
    del p32
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: streaming
# ---------------------------------------------------------------------------

# (label: method, prune, the one kernel the stream's queries must launch)
STREAM_RUNS = {"sdkde auto": ("sdkde", "auto", "flash_kde_pruned"),
               "sdkde off": ("sdkde", "off", "flash_kde"),
               "laplace off": ("laplace", "off", "flash_laplace")}
STREAM_TIERS = ("f32", "bf16x2")


def sync_counted(fn) -> tuple:
    """(result, ms, where): one call on the host clock, synchronized
    before and after, and ``where`` the synchronizing CUDA calls it made,
    as PyTorch's sync debug mode reports them: for each of its warnings,
    the Python line that made the call and the innermost line of the
    port that led there."""
    import traceback
    import warnings

    where = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if "repro_torch" in f.filename]
        site = (f" from {Path(ours[-1].filename).name}:{ours[-1].lineno}"
                if ours else "")
        where.append("/".join(Path(filename).parts[-2:]) + f":{lineno}"
                     + site)

    sync()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    return out, (time.perf_counter() - t0) * 1e3, where


def stream_answers(serve, eng, key, y, tier) -> torch.Tensor:
    """Ragged requests over ``y`` (sizes ``STREAM_SIZES``) and one
    query_many over the rest, pinned to ``tier``; the densities in ``y``'s
    row order, and the largest staleness an answer reported."""
    parts, lag, off = [], 0, 0
    for m in STREAM_SIZES:
        ans = eng.query(serve.QueryRequest(key=key, points=y[off:off + m],
                                           precision=tier))
        parts.append(ans.value)
        lag = max(lag, ans.staleness)
        off += m
    rest = y[off:]
    cut = [0, rest.shape[0] // 3, 2 * rest.shape[0] // 3, rest.shape[0]]
    many = eng.query_many([serve.QueryRequest(
        key=key, points=rest[a:b], precision=tier)
        for a, b in zip(cut, cut[1:])])
    parts += [a.value for a in many]
    lag = max([lag] + [a.staleness for a in many])
    return torch.cat(parts), lag


def stream_updates(eng, key, xa, rng) -> torch.Tensor:
    """8 appends of 256, one eviction of 512 (ids drawn with numpy, so
    sentinels land mid-tile), 4 slides of 256, then a flush; every point
    the stream ever held, indexed by id."""
    st = eng.registry.get(key).stream
    b = STREAM_BATCH
    for i in range(STREAM_APPENDS):
        eng.registry.append(key, xa[i * b:(i + 1) * b])
    eng.registry.evict_ids(key, rng.choice(st.ids, STREAM_EVICT,
                                           replace=False))
    for i in range(STREAM_SLIDES):
        j = (STREAM_APPENDS + i) * b
        eng.registry.slide(key, xa[j:j + b])
    st.ensure(0)
    return st


def stream_parity(serve, kdemod, x, xa, y, h, fs, fk, fp, fl) -> dict:
    """Phase 9a: the three streams against a fresh registration of their
    live set and against float64, and the kernels each launched."""
    out, launches = {}, {}
    for label, (method, prune, kernel) in STREAM_RUNS.items():
        reset_counts(fs, fk, fp, fl)
        eng = serve.ServeEngine(serve.ServeConfig(
            backend="flash", method=method, prune=prune, stream=True))
        _, reg_ms = host_ms(lambda: eng.register("s", x, h=h))
        for tier in STREAM_TIERS:          # both tiers through the updates
            eng.query(serve.QueryRequest(key="s", points=y[:5],
                                         precision=tier))
        rng = np.random.default_rng(SEED + 90)
        st, upd_ms = host_ms(lambda: stream_updates(eng, "s", xa, rng))
        got = {t: stream_answers(serve, eng, "s", y, t) for t in
               STREAM_TIERS}
        sync()
        launches[label] = counts = read_counts(fs, fk, fp, fl)
        check_launches(counts, (kernel,), f"stream {label}")
        every = torch.cat([x, xa])
        live = every[torch.as_tensor(st.ids, device=x.device)]
        log(f"  stream {label}: register {reg_ms:.1f} ms, "
            f"{STREAM_APPENDS} appends + evict {STREAM_EVICT} + "
            f"{STREAM_SLIDES} slides + flush {upd_ms:.1f} ms, gen "
            f"{st.gen}, n_live {st.n_live}, rebuilds {st.rebuilds}; "
            f"launches {json.dumps(counts)}")
        if st.n_live != x.shape[0] + (STREAM_APPENDS - 2) * STREAM_BATCH:
            raise AssertionError(f"stream {label}: n_live {st.n_live}")
        fresh = serve.ServeEngine(serve.ServeConfig(
            backend="flash", method=method, prune=prune))
        fresh.register("f", live, h=h)
        if method == "laplace":
            f64 = kdemod.laplace_kde_eval(live.double(), y.double(), h)
            mass = laplace_mass(kdemod, live, y, h)
        else:
            f64 = kdemod.sdkde_eval(live.double(), y.double(), h)
        res = {"launches": counts, "register_ms": reg_ms,
               "updates_ms": upd_ms}
        for tier, (dens, lag) in got.items():
            if lag != 0:
                raise AssertionError(f"stream {label}: lag {lag} at "
                                     "budget 0")
            want = fresh.query(serve.QueryRequest(key="f", points=y,
                                                  precision=tier)).value
            bar = tier_bar(tier, torch.cat([live, y]), h)
            what = f"stream {label} {tier}"
            if method == "laplace":
                res[tier] = {
                    "vs_refit": compare_mass(dens, want, mass, bar,
                                             f"{what} vs a fresh "
                                             "registration"),
                    "vs_f64": compare_mass(dens, f64, mass, bar,
                                           f"{what} vs float64")}
            else:
                res[tier] = {
                    "vs_refit": compare(dens, want, bar, f"{what} vs a "
                                        "fresh registration"),
                    "vs_f64": compare(dens, f64, bar, f"{what} vs "
                                      "float64")}
        out[label] = res
    return out


def tile_bytes(cols, t: int, block: int) -> list:
    sl = slice(t * block, (t + 1) * block)
    parts = [cols.xt[:, sl], cols.nrm_x[:, sl]]
    if cols.xt_lo is not None:
        parts.append(cols.xt_lo[:, sl])
    return parts + [getattr(cols.meta, f)[t] for f in cols.meta._fields]


def stream_clean_tiles(serve, ops, sp, kdemod, dev, fp) -> dict:
    """Phase 9b: 256 points around one centre of the clustered set refresh
    only their slab's tiles and the tiles their weights reach; every
    other tile keeps its bytes; an evicted slab leaves B4 right."""
    from repro_torch.stream import delta

    x, y = clustered_set(dev)
    h = CLU_H
    eng = serve.ServeEngine(serve.ServeConfig(
        backend="flash", method="sdkde", prune="auto", stream=True))
    eng.register("c", x, h=h)
    st = eng.registry.get("c").stream
    for tier in STREAM_TIERS:
        eng.query(serve.QueryRequest(key="c", points=y[:5], precision=tier))
    snap0 = st.ensure(0)
    cols0 = {t: st.columns_for(t, snap0) for t in STREAM_TIERS}
    rng = np.random.default_rng(SEED + 91)
    centres = np.random.default_rng(SEED).uniform(0.0, CLU_SPREAD,
                                                  (CLU_K, D))
    xa = torch.as_tensor((centres[0] + rng.standard_normal(
        (STREAM_BATCH, D))).astype(np.float32), device=dev)
    # the tiles the append may touch: its own slots' tiles and those of
    # every live point whose weight from an appended one reaches
    # FLT_MIN (float64, with a factor 2 of margin for the f32 rounding)
    phi_max = torch.exp(-(kdemod.sqdist(x.double(), xa.double())
                          / (2 * h * h)).min(dim=1).values)
    reached = np.flatnonzero((phi_max >= delta.FLT_MIN / 2).cpu().numpy())
    st.append(xa)
    block = st.block_n
    expect = set((st._slots[reached] // block).tolist())
    expect |= set((st._slots[-STREAM_BATCH:] // block).tolist())
    snap1 = st.ensure(0)
    if snap1.layout_epoch != snap0.layout_epoch:
        raise AssertionError(f"clustered append rebuilt the layout "
                             f"({st.last_rebuild_reason})")
    log(f"  clustered append of {STREAM_BATCH} around one centre: "
        f"affected {snap1.affected_tiles} of {snap1.total_tiles} tiles, "
        f"at most {len(expect)} expected ({len(reached)} live points "
        f"reached above FLT_MIN)")
    if snap1.affected_tiles > len(expect):
        raise AssertionError("the append refreshed more tiles than its "
                             "slab and its weights reach")
    clean = [t for t in range(snap1.total_tiles) if t not in expect]
    for tier in STREAM_TIERS:
        cols1 = st.columns_for(tier, snap1)
        for t in clean:
            if not all(torch.equal(a, b) for a, b in zip(
                    tile_bytes(cols0[tier], t, block),
                    tile_bytes(cols1, t, block))):
                raise AssertionError(f"clean tile {t} changed its bytes "
                                     f"({tier})")
        fresh = ops.columns_from_layout(snap1.xp, snap1.real, snap1.index,
                                        block_n=block, precision=tier)
        planes = all(torch.equal(getattr(cols1, f), getattr(fresh, f))
                     for f in ("xt", "xt_lo", "nrm_x")
                     if getattr(fresh, f) is not None)
        meta = all(torch.equal(a, b) for a, b in zip(cols1.meta, fresh.meta))
        log(f"  {tier}: {len(clean)} clean tiles equal bit for bit (xt, "
            f"nrm_x{', xt_lo' if tier == 'bf16x2' else ''}, metadata); "
            f"refreshed columns equal a fresh build bit for bit: planes "
            f"{planes}, metadata {meta}")
        if not planes:
            raise AssertionError(f"refreshed planes differ from a fresh "
                                 f"build ({tier})")
    # evict one whole slab (and every 5th point elsewhere): empty tiles,
    # sentinels mid-tile
    lab = int(np.bincount(st._labels[-STREAM_BATCH:]).argmax())
    gone = st.ids[(st._labels == lab) | (np.arange(st.n_live) % 5 == 0)]
    slab = set((st._slots[st._labels == lab] // block).tolist())
    eng.registry.evict_ids("c", gone)
    snap2 = st.ensure(0)
    counts = st.columns_for("f32", snap2).meta.counts.cpu().numpy()
    empty = int((counts == 0).sum())
    if any(counts[t] for t in slab):
        raise AssertionError("an evicted slab's tiles kept a count")
    every = torch.cat([x, xa])
    live = every[torch.as_tensor(st.ids, device=dev)]
    yq = y[:N_CLU_F64]
    fp.kde_counts.reset()
    got = eng.query(serve.QueryRequest(key="c", points=yq)).value
    sync()
    if fp.kde_counts.launches < 1:
        raise AssertionError("the clustered stream did not launch B4")
    f64 = kdemod.sdkde_eval(live.double(), yq.double(), h)
    bar = f32_bar(torch.cat([live, yq]), 1 / (2 * h * h))
    err = compare(got, f64, bar, f"clustered stream after evicting a slab "
                  f"({len(gone)} points, {empty} empty tiles; B4 occupancy "
                  f"{fp.kde_counts.occupancy:.4f}) vs float64")
    return {"affected_tiles": snap1.affected_tiles,
            "total_tiles": snap1.total_tiles, "expected_at_most": len(expect),
            "clean_tiles": len(clean), "empty_tiles_after_evict": empty,
            "evicted_slab_vs_f64": err}


def stream_staleness(serve, kdemod, x, xa, y, h, obs) -> dict:
    """Phase 9c: the staleness gate, one rebuild on slack overflow, the
    background flush, and the stream's metrics."""
    from repro_torch import fault_injection
    from repro_torch.obs import lint_prometheus

    out = {}
    obs.registry.reset()
    yq = y[:REQUEST_ROWS]
    eng = serve.ServeEngine(serve.ServeConfig(
        backend="flash", prune="auto", stream=True, staleness_budget=2))
    eng.register("g", x, h=h)
    lags = [eng.query(serve.QueryRequest(key="g", points=yq)).staleness]
    for i in range(6):
        eng.registry.append("g", xa[i * 64:(i + 1) * 64])
        lags.append(eng.query(serve.QueryRequest(key="g",
                                                 points=yq)).staleness)
    summ = eng.staleness_summary()
    log(f"  staleness_budget=2: lags by query {lags}, summary {summ}")
    if max(lags) > 2 or summ["max"] != max(lags) \
            or summ["count"] != len(lags):
        raise AssertionError("staleness outside its budget or the summary "
                             "disagrees")
    out["lags"], out["summary"] = lags, summ

    # slack overflow: 2048 points around one train point overflow its slab
    eng = serve.ServeEngine(serve.ServeConfig(
        backend="flash", method="kde", prune="auto", stream=True,
        stream_slack=0.02))
    eng.register("o", x, h=h)
    st = eng.registry.get("o").stream
    burst = x[:1] + 0.05 * torch.randn(
        (2048, D), generator=torch.Generator(device=x.device).manual_seed(
            SEED + 92), device=x.device)
    eng.registry.append("o", burst)
    got = eng.query(serve.QueryRequest(key="o", points=y[:N_F64])).value
    live = torch.cat([x, burst])
    rebuilds = obs.metrics_snapshot().get(
        "stream.rebuilds{reason=slack-overflow}", {}).get("value", 0)
    log(f"  slack overflow: rebuilds {st.rebuilds} "
        f"({st.last_rebuild_reason}), stream.rebuilds counter {rebuilds}, "
        f"layout epoch {st.layout_epoch}")
    if st.rebuilds != 1 or st.last_rebuild_reason != "slack-overflow" \
            or rebuilds != 1:
        raise AssertionError("slack overflow did not make one rebuild")
    f64 = kdemod.kde_eval(live.double(), y[:N_F64].double(), h)
    out["overflow_vs_f64"] = compare(
        got, f64, tier_bar("f32", torch.cat([live, y]), h),
        "stream after a slack-overflow rebuild vs float64")

    # background flush: g serves while g+1 builds on the worker, whose
    # flush the chaos hook stalls so that the query surely lands mid-build
    eng = serve.ServeEngine(serve.ServeConfig(
        backend="flash", prune="auto", stream=True, staleness_budget=1,
        stream_background=True))
    eng.register("b", x, h=h)
    eng.query(serve.QueryRequest(key="b", points=yq))  # bucket built
    st = eng.registry.get("b").stream
    stall = fault_injection.FaultInjector(fault_injection.ChaosConfig(
        staleness_blowout=1.0, slow_ms=BACKGROUND_STALL_MS))
    with fault_injection.installed(stall):
        eng.registry.append("b", xa[:STREAM_BATCH])
        alive_before = st._worker.is_alive()
        stale = eng.query(serve.QueryRequest(key="b", points=yq)).staleness
        alive_after = st._worker.is_alive()
        st._worker.join(timeout=120)
    caught = st.snapshot().gen == st.gen
    ans = eng.query(serve.QueryRequest(key="b", points=y[:N_F64]))
    live = torch.cat([x, xa[:STREAM_BATCH]])
    log(f"  background flush (worker stalled {BACKGROUND_STALL_MS:.0f} ms): "
        f"worker building when the query was dispatched {alive_before} "
        f"and when it returned {alive_after}; the query answered {stale} "
        f"generation(s) behind; after the worker, published gen "
        f"{st.snapshot().gen} of {st.gen}, answer lag {ans.staleness}")
    if not (alive_before and alive_after) or stale != 1:
        raise AssertionError("the query did not serve g while g+1 built")
    if not caught or ans.staleness != 0:
        raise AssertionError("the background flush did not catch up")
    f64 = kdemod.sdkde_eval(live.double(), y[:N_F64].double(), h)
    out["background_vs_f64"] = compare(
        ans.value, f64, tier_bar("f32", torch.cat([live, y]), h),
        "stream after a background flush vs float64")
    out["background_stale_lag"] = stale

    reg = eng.metrics()["registry"]
    want = ("stream.appends", "stream.append_points", "stream.evictions",
            "stream.evict_points", "stream.publishes", "stream.dirty_tiles",
            "stream.slack_occupancy", "stream.rebuilds{reason=slack-overflow}",
            "serve.staleness_gen")
    missing = [k for k in want if k not in reg]
    problems = lint_prometheus(obs.prometheus_text())
    log(f"  engine.metrics(): {len(reg)} instruments, stream.* "
        + ", ".join(f"{k} {reg[k].get('value', reg[k].get('count'))}"
                    for k in want if k in reg and k.startswith("stream."))
        + f"; prometheus lint problems {len(problems)}")
    if missing or problems:
        raise AssertionError(f"metrics missing {missing}, lint {problems}")
    return out


def stream_scale(serve, kdemod, mixture, gen, h_of) -> dict:
    """Phase 9d: repro's streaming acceptance size, 262144 x 16, batches
    of 256, prune="auto": printed, not gated (the check is the answers)."""
    from repro_torch.stream import delta

    n = STREAM_SCALE_N
    x = mixture.sample(n, gen)
    xa = mixture.sample(STREAM_SCALE_UPDATES * STREAM_BATCH, gen)
    y = mixture.sample(N_F64, gen)
    sync()
    h = h_of(x)
    torch.cuda.reset_peak_memory_stats()
    _, stats_ms = host_ms(lambda: delta.initial_stats(x, h))
    eng = serve.ServeEngine(serve.ServeConfig(backend="flash", prune="auto",
                                              stream=True))
    _, reg_ms = host_ms(lambda: eng.register("big", x, h=h))
    st = eng.registry.get("big").stream
    yq = y[:REQUEST_ROWS]

    def p50() -> float:
        lat = sorted(eng.query(serve.QueryRequest(key="big", points=yq))
                     .latency_s * 1e3 for _ in range(21))
        return lat[len(lat) // 2]

    eng.query(serve.QueryRequest(key="big", points=yq))
    before = p50()
    # the process's first switch into sync debug mode reports itself as a
    # synchronizing call (torch/cuda/__init__.py, no frame of the port):
    # switch once before the updates are counted
    sync_counted(lambda: None)
    rows = []
    for i in range(STREAM_SCALE_UPDATES):
        reads0 = dict(st.host_reads)
        b = xa[i * STREAM_BATCH:(i + 1) * STREAM_BATCH]
        _, a_ms, n_app = sync_counted(lambda: st.append(b))
        snap, f_ms, n_flush = sync_counted(lambda: st.ensure(0))
        rows.append({"append_ms": a_ms, "flush_ms": f_ms,
                     "affected": snap.affected_tiles,
                     "total": snap.total_tiles,
                     "reads_append": st.host_reads["append"]
                     - reads0["append"],
                     "reads_flush": st.host_reads["flush"] - reads0["flush"],
                     "sync_calls_append": n_app,
                     "sync_calls_flush": n_flush})
    after = p50()
    for r in rows:
        if (r["reads_append"], r["reads_flush"]) != (1, 1):
            raise AssertionError(f"host reads per update {r}")
    live = torch.cat([x, xa])
    refit_eng = serve.ServeEngine(serve.ServeConfig(backend="flash",
                                                    prune="auto"))
    refit_eng.register("big", live, h=h)              # warm-up, same size
    refits = sorted(host_ms(lambda: refit_eng.register(
        "big", live, h=h, refit=True))[1] for _ in range(REFIT_REPEATS))
    refit_ms = refits[len(refits) // 2]
    med = sorted(r["append_ms"] + r["flush_ms"] for r in rows)
    upd = med[len(med) // 2]
    am = sorted(r["append_ms"] for r in rows)[len(rows) // 2]
    fm = sorted(r["flush_ms"] for r in rows)[len(rows) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = eng.query(serve.QueryRequest(key="big", points=y)).value
    want = refit_eng.query(serve.QueryRequest(key="big", points=y)).value
    err = compare(got, want, tier_bar("f32", torch.cat([live, y]), h),
                  f"stream at {n} x {D} after {STREAM_SCALE_UPDATES} appends "
                  "vs a refit of its live set")
    log(f"  scale {n} x {D}, h {h:.6f}: initial statistics "
        f"{stats_ms / 1e3:.3f} s (register {reg_ms / 1e3:.3f} s); per batch "
        f"of {STREAM_BATCH} (median of {len(rows)}): append {am:.2f} ms, "
        f"flush {fm:.2f} ms, together {upd:.2f} ms, "
        f"{1e3 * upd / STREAM_BATCH:.2f} us a point; affected tiles "
        + ", ".join(f"{r['affected']}/{r['total']}" for r in rows)
        + f"; refit of the live set through the registry (median of "
        f"{REFIT_REPEATS} after a warm-up, s: "
        + ", ".join(f"{t / 1e3:.3f}" for t in refits)
        + f") {refit_ms / 1e3:.3f} s; refit / (append + flush) "
        f"{refit_ms / upd:.1f}x (repro's gate: >= 10x); one "
        f"{REQUEST_ROWS}-row request p50 {before:.3f} ms before, "
        f"{after:.3f} ms after; host reads per append / flush "
        f"{rows[0]['reads_append']} / {rows[0]['reads_flush']}, "
        f"synchronizing calls (sync debug mode, information) "
        + ", ".join(f"{len(r['sync_calls_append'])}/"
                    f"{len(r['sync_calls_flush'])}" for r in rows)
        + " (first update's at: append "
        + (", ".join(rows[0]["sync_calls_append"]) or "none") + "; flush "
        + (", ".join(rows[0]["sync_calls_flush"]) or "none") + ")"
        + f"; peak memory {peak:.2f} GiB")
    return {"n": n, "h": h, "initial_stats_s": stats_ms / 1e3,
            "register_s": reg_ms / 1e3, "updates": rows,
            "append_ms": am, "flush_ms": fm, "append_flush_ms": upd,
            "us_per_point": 1e3 * upd / STREAM_BATCH,
            "refit_s": refit_ms / 1e3,
            "refit_runs_s": [t / 1e3 for t in refits],
            "refit_over_update": refit_ms / upd,
            "request_p50_ms_before": before, "request_p50_ms_after": after,
            "peak_gib": peak, "vs_refit": err}


def phase_stream(mixture, gen, serve, ops, sp, kdemod, bw, obs, dev, fs,
                 fk, fp, fl) -> dict:
    log(f"== phase 9: streaming, {N_TRAIN} x {D} live, {N_F64} queries")
    x = mixture.sample(N_TRAIN, gen)
    xa = mixture.sample((STREAM_APPENDS + STREAM_SLIDES) * STREAM_BATCH, gen)
    y = mixture.sample(N_F64, gen)
    sync()
    h = float(bw.sdkde_bandwidth(x))
    out = {"parity": stream_parity(serve, kdemod, x, xa, y, h, fs, fk, fp,
                                   fl)}
    out["clean_tiles"] = stream_clean_tiles(serve, ops, sp, kdemod, dev, fp)
    out["staleness"] = stream_staleness(serve, kdemod, x, xa, y, h, obs)
    out["scale"] = stream_scale(serve, kdemod, mixture, gen,
                                lambda pts: float(bw.sdkde_bandwidth(pts)))
    return out


# ---------------------------------------------------------------------------
# phase 10: the decision layer
# ---------------------------------------------------------------------------


def tuner_case(autotune, label, rows, cols, out_width, card, dev,
               pruned=False) -> dict:
    """One measured resolve: the model's shortlist, the probed candidates
    (modeled vs measured device time and the model's ratio), the winner
    and the default (128, 128) tile's time on the same probe; then a
    second resolve, which must hit the cache without a probe."""
    cands = autotune.shortlist(rows, cols, D, out_width=out_width,
                               occupancy_fn=(lambda bn: autotune.
                                             expected_occupancy(
                                                 rows, cols, D, bn))
                               if pruned else None)
    before = len(autotune.probe_log())
    blocks, resolve_ms = host_ms(lambda: autotune.resolve_blocks(
        "auto", "auto", rows, cols, D, out_width=out_width, measure=True,
        pruned=pruned, device=dev))
    probes = autotune.probe_log()[before:]
    if not probes:
        raise AssertionError(f"{label}: the measured resolve probed nothing")
    probe = autotune._probe_time_fn(rows, cols, D, out_width, "f32", dev)
    default_s = probe(128, 128)
    again = autotune.resolve_blocks("auto", "auto", rows, cols, D,
                                    out_width=out_width, measure=True,
                                    pruned=pruned, device=dev)
    if again != blocks or len(autotune.probe_log()) != before + len(probes):
        raise AssertionError(f"{label}: a second resolve re-tuned")
    log(f"  {label}: shortlist (block_m, block_n: modeled ms) "
        + ", ".join(f"{c.block_m}x{c.block_n}: {c.step_time * 1e3:.4f}"
                    for c in cands[:6]))
    for pr in probes:
        log(f"    probed {pr['block_m']}x{pr['block_n']}: modeled "
            f"{pr['modeled_s'] * 1e3:.4f} ms, measured "
            f"{pr['measured_s'] * 1e3:.4f} ms, measured/modeled "
            f"{pr['measured_s'] / pr['modeled_s']:.3f} [{card}]")
    log(f"    winner {blocks[0]}x{blocks[1]}; default 128x128 "
        f"{default_s * 1e3:.4f} ms; resolve with its probes "
        f"{resolve_ms:.1f} ms; second resolve: cache hit, no probe [{card}]")
    return {"winner": list(blocks), "resolve_ms": resolve_ms,
            "default_128x128_ms": default_s * 1e3,
            "shortlist": [[c.block_m, c.block_n, c.step_time * 1e3]
                          for c in cands[:6]],
            "probes": [{"blocks": [p["block_m"], p["block_n"]],
                        "modeled_ms": p["modeled_s"] * 1e3,
                        "measured_ms": p["measured_s"] * 1e3,
                        "ratio": p["measured_s"] / p["modeled_s"]}
                       for p in probes]}


def decisions_tuner(data, clustered, est_mod, ops, card, dev) -> dict:
    """Phase 10a: measured resolves of B2, B1 and (pruned) B4, and an
    SD-KDE with "auto" tiles against explicit ones and float64."""
    from repro_torch.kernels import autotune

    autotune.clear_cache()
    out = {"B2 4096x32768": tuner_case(autotune, "B2 rows 4096 x cols "
                                       f"{N_TRAIN}", 4096, N_TRAIN, 1, card,
                                       dev),
           "B1 32768^2": tuner_case(autotune, f"B1 {N_TRAIN}^2", N_TRAIN,
                                    N_TRAIN, D + 1, card, dev)}
    # B4: the pruned pass on the clustered set feeds the occupancy
    # profile (launch width 128 = the fine probe's), then the resolve
    # prices candidates at it; the probe times B2 dense, as repro's does
    cx, cy = clustered["x"], clustered["y"]
    ops.flash_kde(cx, cy, CLU_H, prune="auto")
    occ = autotune.expected_occupancy(cy.shape[0], cx.shape[0], D, 128)
    log(f"  clustered occupancy profile at block_n 128: {occ:.4f}")
    out["B4 clustered"] = tuner_case(
        autotune, f"B4 clustered rows {cy.shape[0]} x cols {cx.shape[0]} "
        "(pruned model; probe B2 dense)", cy.shape[0], cx.shape[0], 1, card,
        dev, pruned=True)
    out["B4 clustered"]["occupancy"] = occ

    x, y, f64 = data["x"], data["y"], data["f64"]
    est = est_mod.SDKDE(data["h"], est_mod.EstimatorConfig(
        block_m="auto", block_n="auto"))
    _, fit_ms = host_ms(lambda: est.fit(x))
    dens, ev_ms = host_ms(lambda: est.evaluate(y))
    bar = TIER_BAR["f32"]
    out["sdkde_auto"] = {
        "fit_ms": fit_ms, "evaluate_ms": ev_ms,
        "vs_explicit": compare(dens, data["auto_dens"], bar,
                               'SDKDE block_m/block_n="auto" vs explicit '
                               "128x128 tiles"),
        "vs_f64": compare(dens[:N_F64], f64, bar,
                          f'SDKDE "auto" tiles vs float64 ({N_F64} q)')}
    log(f"  SDKDE \"auto\" tiles: fit {fit_ms:.2f} ms, evaluate "
        f"{ev_ms:.2f} ms (first use, probes included) [{card}]")
    return out


def decisions_rff(data, card) -> dict:
    """Phase 10b: fit the RFF tier on the main path's debiased points,
    evaluate the 16384 queries at f32 and bf16x2, hold every row's
    realized error against phase 4's float64 sums within its band, hit
    fractions by target, and one 4096-row evaluation beside B2 and B4
    for the same rows."""
    from repro_torch.kernels import flash_rff

    x_sd, y, h, f64 = data["x_sd"], data["y"], data["h"], data["f64"]
    st, fit_ms = host_ms(lambda: flash_rff.fit(
        x_sd, h, n_features=RFF_FEATURES, n_pilot=RFF_PILOT,
        groups=RFF_GROUPS))
    srv = st.serving()
    log(f"  RFF fit on {N_TRAIN} x {D} debiased points, D {RFF_FEATURES}, "
        f"K {RFF_PILOT}, G {RFF_GROUPS}: {fit_ms:.2f} ms; p_scale "
        f"{st.p_scale:.4e} [{card}]")
    out = {"fit_ms": fit_ms, "p_scale": st.p_scale, "tiers": {}}
    for tier in ("f32", "bf16x2"):
        (p, band), ms = host_ms(lambda: flash_rff.eval_density(
            srv, y, precision=tier))
        if not (bool(torch.isfinite(p).all()) and p.shape == (N_QUERY,)):
            raise AssertionError(f"RFF {tier}: bad densities")
        real = flash_rff.realized_error(p[:N_F64], f64, st.p_scale)
        b = band[:N_F64].double().cpu().numpy()
        worst = float((real / b).max())
        hits = {t: float((band <= t).double().mean()) for t in
                CASCADE_TARGETS}
        log(f"  RFF eval {N_QUERY} queries {tier}: {ms:.3f} ms; realized "
            f"error / band max {worst:.3f} over {N_F64} rows (must be <= "
            f"1); median band {float(band.median()):.4e}; hit fraction "
            + ", ".join(f"{t:g}: {v:.4f}" for t, v in hits.items())
            + f" [{card}]")
        if worst > 1.0:
            raise AssertionError(f"RFF {tier}: a row's realized error "
                                 f"exceeds its band ({worst:.3f})")
        out["tiers"][tier] = {"evaluate_ms": ms, "max_realized_over_band":
                              worst, "median_band": float(band.median()),
                              "hit_fraction": hits}
    # one request of RFF_ROWS rows: the RFF evaluation beside B2 (dense)
    # and B4 (pruned, prepass included) on the same rows
    from repro_torch.kernels import ops

    yq = y[:RFF_ROWS]
    rff_ms = cuda_ms(lambda: flash_rff.eval_density(srv, yq), 10)
    b2_ms = cuda_ms(lambda: ops.flash_kde(x_sd, yq, h, prune="off"), 10)
    b4_ms = cuda_ms(lambda: ops.flash_kde(x_sd, yq, h, prune=0.0), 10)
    model_ms = flash_rff.modeled_query_cost_us(
        RFF_ROWS, D, n_features=RFF_FEATURES, n_pilot=RFF_PILOT) / 1e3
    log(f"  one {RFF_ROWS}-row request (CUDA-event medians, host work "
        f"included): RFF {rff_ms:.4f} ms (modeled {model_ms:.4f}), B2 "
        f"through ops {b2_ms:.4f} ms, B4 through ops {b4_ms:.4f} ms "
        f"[{card}]")
    out.update(request_rff_ms=rff_ms, request_rff_modeled_ms=model_ms,
               request_b2_ms=b2_ms, request_b4_ms=b4_ms)
    return out


def decisions_cascade(data, serve, fs, fk, fp, fl, card) -> dict:
    """Phase 10c: ServeEngine with the RFF tier at the three targets,
    prune "auto" and "off": hits + escalated = rows, escalations launch
    B4 (B2) only, every row within its bound against float64, p50 of a
    4096-row request and the host reads a request makes."""
    from repro_torch.kernels import flash_rff

    x, y, h, f64 = data["x"], data["y"], data["h"], data["f64"]
    yq = y[:RFF_ROWS]
    out = {}
    for prune, kernel in (("auto", "flash_kde_pruned"), ("off",
                                                        "flash_kde")):
        eng = serve.ServeEngine(serve.ServeConfig(
            backend="flash", method="sdkde", prune=prune, rff="on",
            rff_features=RFF_FEATURES, rff_pilot=RFF_PILOT,
            rff_groups=RFF_GROUPS))
        _, reg_ms = host_ms(lambda: eng.register("c", x, h=h))
        p_scale = eng.registry.get("c").rff.state.p_scale
        rows = {}
        for t in CASCADE_TARGETS:
            req = serve.QueryRequest(key="c", points=yq, accuracy_target=t)
            eng.query(req)                       # builds the bucket
            reset_counts(fs, fk, fp, fl)
            ans, _, syncs = sync_counted(lambda: eng.query(req))
            counts = read_counts(fs, fk, fp, fl)
            if ans.rff_hits + ans.escalated != RFF_ROWS:
                raise AssertionError(f"cascade {prune} {t}: hits + "
                                     f"escalated != rows")
            if ans.escalated:
                check_launches(counts, (kernel,),
                               f"cascade escalations prune={prune!r}")
            elif any(counts.values()):
                raise AssertionError(f"cascade {prune} {t}: a kernel "
                                     f"launched with nothing escalated")
            real = flash_rff.realized_error(ans.value[:N_F64], f64, p_scale)
            over = float((real / ans.rel_err_bounds[:N_F64]).max())
            if over > 1.0:
                raise AssertionError(f"cascade {prune} {t}: a row's error "
                                     f"exceeds its bound ({over:.3f})")
            lat = sorted(eng.query(req).latency_s * 1e3
                         for _ in range(CASCADE_REPEATS))
            rows[t] = {"hits": ans.rff_hits, "escalated": ans.escalated,
                       "launches": counts[kernel], "p50_ms":
                       lat[len(lat) // 2], "max_err_over_bound": over,
                       "sync_calls": len(syncs)}
            log(f"  cascade prune={prune!r} target {t:g}: {ans.rff_hits} "
                f"hits, {ans.escalated} escalated ({kernel} launches "
                f"{counts[kernel]}), max error/bound {over:.3f}, p50 "
                f"{rows[t]['p50_ms']:.3f} ms for {RFF_ROWS} rows, "
                f"synchronizing calls a request {len(syncs)} [{card}]")
        out[prune] = {"register_ms": reg_ms, "targets": rows}
    return out


def decisions_cascade_1d(mix1, gen, serve, kdemod, fs, fk, fp, fl,
                         card) -> dict:
    """Phase 10c, the fast tier answering: on the 16-d mixture the bands
    exceed every target and all rows escalate, so the 1-D setting of
    Fig. 3 (n = 8192, h 0.3, kde, prune "off") shows rows answered at
    the RFF tier on the card, each within its band against float64.  An
    escalated row is held to the f32 tier's bar with the norm-trick
    model (``tier_bar``): at h 0.3 that model, not the ladder's 1e-5
    (``exact_bound``, repro's), bounds an f32 row (ROADMAP C)."""
    from repro_torch.kernels import flash_rff
    from repro_torch.serve import cascade

    x = mix1.sample(ORACLE_N_1D, gen)
    y = mix1.sample(RFF_ROWS, gen)
    eng = serve.ServeEngine(serve.ServeConfig(
        backend="flash", method="kde", prune="off", rff="on",
        rff_features=RFF_FEATURES, rff_pilot=RFF_PILOT,
        rff_groups=RFF_GROUPS))
    eng.register("c1", x, h=FIG4_H)
    p_scale = eng.registry.get("c1").rff.state.p_scale
    want = kdemod.kde_eval(x.double(), y.double(), FIG4_H)
    req = serve.QueryRequest(key="c1", points=y, accuracy_target=1e-2)
    eng.query(req)
    reset_counts(fs, fk, fp, fl)
    ans = eng.query(req)
    counts = read_counts(fs, fk, fp, fl)
    if ans.rff_hits < 1 or ans.rff_hits + ans.escalated != RFF_ROWS:
        raise AssertionError(f"1-D cascade: {ans.rff_hits} hits, "
                             f"{ans.escalated} escalated")
    if ans.escalated:
        check_launches(counts, ("flash_kde",), "1-D cascade escalations")
    real = flash_rff.realized_error(ans.value, want, p_scale)
    exact = ans.rel_err_bounds == cascade.exact_bound("f32", "off")
    bound = np.where(exact, np.maximum(
        ans.rel_err_bounds, tier_bar("f32", torch.cat([x, y]), FIG4_H)),
        ans.rel_err_bounds)
    over = float((real / bound).max())
    if over > 1.0:
        raise AssertionError(f"1-D cascade: a row's error exceeds its "
                             f"bound ({over:.3f})")
    lat = sorted(eng.query(req).latency_s * 1e3
                 for _ in range(CASCADE_REPEATS))
    log(f"  cascade 1-D (n {ORACLE_N_1D}, h {FIG4_H}, prune 'off') target "
        f"1e-2: {ans.rff_hits} hits, {ans.escalated} escalated (flash_kde "
        f"launches {counts['flash_kde']}), max error/bound {over:.3f}, p50 "
        f"{lat[len(lat) // 2]:.3f} ms for {RFF_ROWS} rows [{card}]")
    return {"hits": ans.rff_hits, "escalated": ans.escalated,
            "max_err_over_bound": over, "p50_ms": lat[len(lat) // 2]}


def decisions_planner(data, serve, card) -> dict:
    """Phase 10d: the planner's decisions at the main and clustered
    shapes equal the golden fixture's; plan="auto" registers and answers
    within the planned tier's bar of float64; the planner times nothing."""
    from repro_torch import plan as plan_mod
    from repro_torch.kernels import autotune

    golden = plan_mod.load_golden()["plans"]
    bench = plan_mod.golden_bench()
    probes0 = len(autotune.probe_log())
    out = {}
    for label, req in plan_mod.golden_requests():
        if label not in ("main", "clustered"):
            continue
        p = plan_mod.plan(req, bench=bench)
        want = golden[plan_mod.request_key(req)]["plan"]
        if p.as_dict() != want:
            raise AssertionError(f"plan {label} {req.accuracy:g} differs "
                                 f"from the golden fixture: {p.as_dict()} "
                                 f"vs {want}")
        out[f"{label} {req.accuracy:g}"] = p.plan_id
        log(f"  plan {label} (n {req.n}, d {req.d}, q {req.q}) accuracy "
            f"{req.accuracy:g}: {p.plan_id}, modeled "
            f"{p.modeled_cost_s * 1e6:.1f} us ({p.bound}), rff {p.rff} "
            "= golden")
    x, y, h, f64 = data["x"], data["y"], data["h"], data["f64"]
    eng = serve.ServeEngine(serve.ServeConfig(plan="auto"))
    prep, reg_ms = host_ms(lambda: eng.register("p", x, h=h))
    if len(autotune.probe_log()) != probes0:
        raise AssertionError("planning timed the card")
    ans = eng.query(serve.QueryRequest(key="p", points=y[:N_F64]))
    err = compare(ans.value, f64, TIER_BAR[prep.plan.precision],
                  f'ServeConfig(plan="auto") {prep.plan.plan_id} vs float64')
    log(f"  plan=\"auto\" registered in {reg_ms:.2f} ms (prewarm included), "
        f"answer plan_id {ans.plan_id} [{card}]")
    out["served"] = {"plan_id": prep.plan.plan_id, "register_ms": reg_ms,
                     "vs_f64": err}
    return out


def decisions_stream(data, serve, mixture, gen, card) -> dict:
    """Phase 10e: the RFF tier on a stream of 32768 live points: after 8
    appends of 256 and an eviction of 512 the synced feature sums equal
    a fresh fit's within the f32 phase model, the sync's and a refit's
    times, and the sync's host reads."""
    from repro_torch.kernels import flash_rff

    x, h = data["x"], data["h"]
    xa = mixture.sample(STREAM_APPENDS * STREAM_BATCH, gen)
    eng = serve.ServeEngine(serve.ServeConfig(
        backend="flash", prune="auto", stream=True, rff="on",
        rff_features=RFF_FEATURES, rff_pilot=RFF_PILOT,
        rff_groups=RFF_GROUPS))
    eng.register("s", x, h=h)
    prep = eng.registry.get("s")
    eng.registry.rff_serving(prep)                  # the first fit
    tier = prep.rff
    pts0 = prep.stream.snapshot().points
    for i in range(STREAM_APPENDS):
        eng.registry.append("s", xa[i * STREAM_BATCH:(i + 1) * STREAM_BATCH])
    rng = np.random.default_rng(SEED + 100)
    eng.registry.evict_ids("s", rng.choice(prep.stream.ids, STREAM_EVICT,
                                           replace=False))
    snap = prep.stream.ensure(0)
    syncs0, fits0 = tier.syncs, tier.fits
    _, sync_ms, where = sync_counted(lambda: eng.registry.rff_serving(
        prep, snap=snap))
    if tier.syncs != syncs0 + 1 or tier.fits != fits0:
        raise AssertionError("the stream's RFF tier refitted instead of "
                             "syncing")
    fresh, refit_ms = host_ms(lambda: flash_rff.fit(
        snap.points, h, n_features=RFF_FEATURES, n_pilot=RFF_PILOT,
        groups=RFF_GROUPS))
    # the two sums differ by the f32 phase rounding of the fits that made
    # them (the synced one's first fit over the registered points, the
    # fresh one over the live points; the deltas are float64): a phase
    # w·x within d·eps·Σ|w_k x_k|, cos and sin within 2 eps each term
    eps = torch.finfo(torch.float32).eps
    w_abs = tier.state.w.abs().T

    def phase_model(points):
        p = points.double().abs()
        return D * eps * (p @ w_abs).sum(0) + 2 * eps * p.shape[0]

    model = phase_model(pts0) + phase_model(snap.points)
    diffs = [(tier.state.z_cos - fresh.z_cos).abs(),
             (tier.state.z_sin - fresh.z_sin).abs()]
    ratio = max(float((dz / model).max()) for dz in diffs)
    log(f"  RFF on a stream ({N_TRAIN} live, {STREAM_APPENDS} appends of "
        f"{STREAM_BATCH}, eviction of {STREAM_EVICT}, {snap.n_live} live): "
        f"sync {sync_ms:.2f} ms vs refit {refit_ms:.2f} ms; synced sums vs "
        f"a fresh fit: max |diff| / f32 phase model {ratio:.3e} (bar 1); "
        f"synchronizing calls (host reads) a sync {len(where)} (must be 0)"
        f" [{card}]")
    if ratio > 1.0 or tier.state.n != snap.n_live:
        raise AssertionError(f"synced RFF sums off a fresh fit's by "
                             f"{ratio:.3f} of the model")
    if where:
        raise AssertionError(f"the RFF sync read the card: {where}")
    return {"sync_ms": sync_ms, "refit_ms": refit_ms,
            "diff_over_model": ratio, "sync_calls": len(where),
            "n_live": snap.n_live}


def decisions_density(data, est_mod, kdemod, card) -> dict:
    """Phase 10f: density weights at 32768 x 16 against float64 weights.
    |Δw/w| <= alpha·(the densities' bar) + the mean's, 2·alpha·bar."""
    from repro_torch.data.density import density_weights

    x, h = data["x"], data["h"]
    w, ms = host_ms(lambda: density_weights(x, alpha=DENSITY_ALPHA, h=h))
    p64 = torch.clamp(kdemod.sdkde_eval(x.double(), x.double(), h),
                      min=1e-12)
    w64 = p64 ** (-DENSITY_ALPHA)
    w64 = w64 / w64.mean()
    bar = 2 * DENSITY_ALPHA * tier_bar("f32", x, h)
    err = compare(w, w64, bar, f"density weights {N_TRAIN} x {D} vs "
                  "float64")
    log(f"  density_weights {N_TRAIN} x {D}: {ms:.2f} ms [{card}]")
    return {"ms": ms, "vs_f64": err}


def phase_decisions(data, clustered, mixture, mix1, gen, serve, est_mod,
                    ops, kdemod, fs, fk, fp, fl, card, dev) -> dict:
    log(f"== phase 10: decisions (tuner, RFF tier, cascade, planner, "
        f"density weighting) at {N_TRAIN} x {D}, {N_QUERY} queries [{card}]")
    out = {"tuner": decisions_tuner(data, clustered, est_mod, ops, card,
                                    dev)}
    out["rff"] = decisions_rff(data, card)
    out["cascade"] = decisions_cascade(data, serve, fs, fk, fp, fl, card)
    out["cascade"]["1d"] = decisions_cascade_1d(mix1, gen, serve, kdemod,
                                                fs, fk, fp, fl, card)
    out["planner"] = decisions_planner(data, serve, card)
    out["stream"] = decisions_stream(data, serve, mixture, gen, card)
    out["density"] = decisions_density(data, est_mod, kdemod, card)
    return out


def prefill_profile(checkout: Path) -> int:
    """Phase 8's prefill alone (full-width Falcon-Mamba-7B, seeded
    weights, batch ``SERVE_BATCH`` x ``SERVE_PROMPT``) with the port
    found under ``checkout``/src: three warm calls on the host clock and
    one profiled.  Prints one JSON line; the card's name and power limit
    come first."""
    src = checkout / "src"
    if not (src / "repro_torch").is_dir():
        raise FileNotFoundError(f"no port under {src}")
    sys.path.insert(0, str(src))
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import common, transformer

    phase_device()
    cfg = serve_mod.build_config(SERVE_ARCH, layers=SERVE_LAYERS)
    params = common.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    ids = lm_batch(cfg, SEED, 0, SERVE_BATCH, SERVE_PROMPT, "cuda")["tokens"]
    with torch.inference_mode():
        transformer.prefill(params, ids, cfg)
        warm = [host_ms(lambda: transformer.prefill(params, ids, cfg))[1]
                for _ in range(3)]
        prof = device_breakdown(lambda: transformer.prefill(params, ids, cfg),
                                f"prefill {SERVE_BATCH} x {SERVE_PROMPT}, "
                                f"{checkout}")
    print(json.dumps({"prefill_profile": str(checkout), "warm_ms": warm,
                      **prof}), flush=True)
    return 0


SOURCES = {
    "flash_score": ("src/repro_torch/kernels/csrc/flash_score.cu",
                    "src/repro/kernels/flash_score.py:78"),
    "flash_kde": ("src/repro_torch/kernels/csrc/flash_kde.cu",
                  "src/repro/kernels/flash_kde.py:57"),
    "flash_score_pruned": ("src/repro_torch/kernels/csrc/flash_pruned.cu",
                           "src/repro/kernels/flash_pruned.py:174"),
    "flash_kde_pruned": ("src/repro_torch/kernels/csrc/flash_pruned.cu",
                         "src/repro/kernels/flash_pruned.py:81"),
    "flash_laplace": ("src/repro_torch/kernels/csrc/flash_laplace.cu",
                      "src/repro/kernels/flash_laplace.py:127"),
    "sq_moment": ("src/repro_torch/kernels/csrc/flash_laplace.cu",
                  "src/repro/kernels/flash_laplace.py:138"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:89"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paper-scale", action="store_true",
                    help="also fit and evaluate at 1,048,576 x 16 / 131,072")
    ap.add_argument("--prefill-profile", metavar="CHECKOUT", type=Path,
                    help="only profile one warm full-width prefill with the "
                         "port under CHECKOUT/src (e.g. an unpacked parent "
                         "commit), to compare two commits on one card")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if args.prefill_profile is not None:
        return prefill_profile(args.prefill_profile.resolve())
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_mod
    from repro_torch import obs, serve
    from repro_torch.core import bandwidth as bw
    from repro_torch.core import estimator as est_mod
    from repro_torch.core import kde as kdemod
    from repro_torch.core import metrics, mixtures
    from repro_torch.kernels import _build, ops, spatial
    from repro_torch.kernels import flash_kde as fk
    from repro_torch.kernels import flash_laplace as fl
    from repro_torch.kernels import flash_pruned as fp
    from repro_torch.kernels import flash_score as fs

    dev = device_mod.resolve("cuda")
    name, card = phase_device()
    hmma, scan_regs = phase_build(_build)
    mixture = mixtures.benchmark_mixture_16d()
    mix1 = mixtures.benchmark_mixture_1d()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cfg = est_mod.EstimatorConfig()
    errors = phase_kernels(ops, spatial, mixture, mix1, gen, cfg.block_m,
                           cfg.block_n)
    main_path = phase_main_path(mixture, gen, est_mod, kdemod, serve, fk,
                                fs, fp, fl)
    data = main_path.pop("data")
    clustered = phase_clustered(ops, spatial, kdemod, fp, dev)
    laplace = phase_laplace_path(mixture, gen, est_mod, kdemod, serve, fk,
                                 fs, fp, fl)
    timings = phase_timings(ops, spatial, mixture, gen, cfg.block_m,
                            cfg.block_n, errors, clustered)
    fusion = phase_fusion(ops, fk, fl, kdemod, mixture, mix1, gen,
                          cfg.block_m, cfg.block_n)
    paper = None
    if args.paper_scale:
        paper = phase_paper_scale(mixture, gen, est_mod, fs, fk, fp, fl)
    oracle = phase_oracle(est_mod, bw, metrics, mixtures, kdemod, dev)
    ssm_serve = phase_ssm_serve(ops, fs, fk, fp, fl)
    stream = phase_stream(mixture, gen, serve, ops, spatial, kdemod, bw, obs,
                          dev, fs, fk, fp, fl)
    stream_launches = {k: r["launches"] for k, r in stream["parity"].items()}
    decisions = phase_decisions(data, clustered, mixture, mix1, gen, serve,
                                est_mod, ops, kdemod, fs, fk, fp, fl, card,
                                dev)

    # launches: each kernel's count from the path that runs it, with its
    # counts set to 0 just before and read just after (phases 4 and 4c)
    lap = laplace["launches"]
    launches = {**{k: main_path["launches"][k] for k in SOURCES
                   if k in main_path["launches"]},
                "flash_laplace": lap["off"]["flash_laplace"],
                "sq_moment": lap["nonfused"]["sq_moment"],
                "selective_scan": ssm_serve["launches"]["selective_scan"]
                + ssm_serve["launches"]["mamba_scan"]}
    kernels = []
    for kname, (src, replaces) in SOURCES.items():
        if kname == "selective_scan":
            # both modes of B7; the top level is the fused mode, which the
            # serving path launches
            fused = timings["entries"]["mamba_scan"]
            b, s_, d_, n_ = SCAN_MAIN
            kernels.append({
                "name": kname, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[kname],
                "launches_prefill": ssm_serve["prefill_launches"],
                "mode": "fused (mamba_scan)",
                **{k: fused["bf16"][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by")},
                "library_ms": None,
                "library_note": "no single PyTorch call computes this scan",
                "dtype": "bf16", "shape": {"B": b, "S": s_, "D": d_,
                                           "N": n_},
                "dtypes": fused,
                "unfused": {
                    "launches": ssm_serve["launches"]["selective_scan"],
                    "dtypes": timings["entries"]["selective_scan"]},
                "ptxas": scan_regs})
            continue
        tiers = timings["entries"][kname]
        main_tier = tiers["f32"]
        entry = {
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": main_tier["max_abs_err"],
            "ms": main_tier["ms"], "plain_ms": main_tier["plain_ms"],
            "bound_ms": main_tier["bound_ms"],
            "bound_by": main_tier["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes these sums",
            "tier": "f32", "shape": {"rows": N_TRAIN, "cols": N_TRAIN,
                                     "d": D},
            "tiers": tiers,
        }
        lib = {"flash_score": "flash_score", "flash_kde": "flash_kde",
               "flash_laplace": "flash_laplace",
               "sq_moment": "flash_laplace"}.get(kname, "flash_pruned")
        body = "score_pass<" if kname in SCORE_PASSES else "kde_pass<"
        weight = {"flash_laplace": ",laplace>",
                  "sq_moment": ",sq_moment>"}.get(kname, "")
        entry["tensor_ops_in_sass"] = (
            {k: v for k, v in hmma[lib].items()
             if k.startswith(body) and k.endswith(weight)}
            if lib in hmma else "not available")
        entry["bitwise"] = errors["bitwise"]
        if kname == "flash_kde":
            entry["launches_laplace_path"] = lap["nonfused"]["flash_kde"]
            entry["launches_stream"] = stream_launches["sdkde off"][kname]
        if kname == "flash_laplace":
            entry["launches_serve"] = lap["serve_off"]["flash_laplace"]
            entry["launches_stream"] = stream_launches["laplace off"][kname]
        if kname == "flash_kde_pruned":
            entry["launches_stream"] = stream_launches["sdkde auto"][kname]
            # B4's laplace flag: the fused Laplace pass when pruning
            entry["laplace"] = {
                "launches": lap["auto"]["flash_kde_pruned laplace"],
                "launches_serve": lap["serve_auto"][
                    "flash_kde_pruned laplace"],
                "tiers": timings["entries"]["flash_kde_pruned laplace"]}
        kernels.append(entry)
    summary = {k: v for k, v in main_path.items()}
    summary["clustered_occupancy"] = clustered["occupancy"]
    summary["clustered_occupancy_by_seed"] = clustered["occupancy_by_seed"]
    summary["prepass_ms"] = timings["prepass_ms"]
    summary["laplace"] = laplace
    summary["fusion"] = fusion
    summary["oracle"] = oracle
    summary["ssm_serve"] = ssm_serve
    summary["stream"] = stream
    summary["decisions"] = decisions
    if paper is not None:
        summary["paper_scale"] = paper
    log("main path: " + json.dumps(summary))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
