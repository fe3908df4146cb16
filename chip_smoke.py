#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                # the default run, one card
    python3 chip_smoke.py --paper-scale  # plus 1,048,576 x 16 train /
                                         # 131,072 queries, "auto" and
                                         # "off", timed
    python3 chip_smoke.py --prefill-profile DIR  # only phase 8's prefill,
                                         # profiled, with the port under
                                         # DIR/src (another checkout)
    python3 chip_smoke.py --long-prefill DIR     # only phase 14's 8192-
                                         # token prefill, timed, with the
                                         # port under DIR/src

Run from the repository root.  Phases, each printing its lines:

  1. device       the card's name and power limit (nvidia-smi);
  2. build        the five CUDA sources (B1, B2, B3/B4, B5/B6, B7)
                  compiled with nvcc for sm_90a, in parallel; ptxas's
                  registers and spills (a score-pass instantiation at
                  d <= 32 must not spill, nor a dense KDE-pass one, B2,
                  B5 or B6, at any d); the HMMA/HGMMA instructions in
                  the SASS of each B1-B6 instantiation (cuobjdump; the
                  bf16 tiers and the f32 score pass, B1 and B3, must
                  have them, the f32 KDE pass none, and none may be
                  TF32); B7's
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
                  B1, B2, B5 and B6 also at d = 1 (Fig. 4's dimension);
                  B1 in its rectangular form (m rows against n other
                  columns, a ring block) at m 8192 x n 32768, m 32768 x
                  n 8192 and a 128-row block against 32768, every tier.
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
                  Falcon-Mamba-7B's layer shape; B1's square time beside
                  its time before the rectangular form (PERF.md) and
                  B1 rectangular at m 8192 x n 32768;
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
                  one silu a layer (the conv's) may run there; one
                  more warm prefill is counted by FlopCounterMode (its
                  aten products' FLOPs, for phase 13d).  The
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
                  32768 x 16 within 2·alpha·bar of float64 weights;
 11. resilient    the ResilientEngine and the AsyncFrontend on the card,
                  every time with the card's name and power limit:
                  (a) S 2 x R 2 over the main path's data, prune "off"
                  and "auto": register (one B1 / B3 launch, prewarm
                  included), requests of 1, 128 and 4096 rows held
                  against a plain ServeEngine (f32 bar) and float64,
                  launches a request (each shard's B2 or B4 once),
                  synchronizing calls, warm p50 / p99 beside the plain
                  engine's, and under "off" one cascade request; (b)
                  60 requests of 128 rows through each of: a kill of
                  shard 0 / replica 0 over requests 20-40 (all exact,
                  retries > 0), a slow replica with a 5 ms hedge timer
                  (hedges fired and won), NaN poison at 0.2 (no
                  non-finite answer), a broken bucket callable on one
                  replica (its breaker opens); (c) the clustered set at
                  S 4 with both replicas of shard 3 killed: rows around
                  shard 0's centres get certified degraded answers
                  (each row's float64 error within its bound, plus the
                  answer's f32 bar; SD-KDE and Laplace's two-sided
                  bound), rows around shard 3's a typed Degraded; (d)
                  AsyncFrontend(workers 2, max_queue 64) over (a)'s
                  "off" engine, 512 open-loop arrivals at 4x the probed
                  capacity, shedding rung bf16x2: every future resolves
                  typed, nothing is unaccounted, backpressure is
                  reached, answers hold their tier's bar (and, as
                  information, the default bf16 rung's error); (e) ``launch.serve_kde.main`` run in
                  this process with --shards 2 --replicas 2 --chaos
                  shard_kill --verify, and --open-loop --expect-shed;
 12. ring         the ring backend over the main path's data, f32: (a)
                  SDKDE(backend="ring") fit + evaluate and
                  LaplaceKDE(backend="ring") as a ring of one, with no
                  process group and in a one-rank NCCL group: one B1 and
                  one B2 launch (one B5), held against backend="flash",
                  prune="off" at the f32 bar (Laplace per row, bar times
                  the absolute mass), host times beside the flash
                  path's; (b) 4 gloo ranks spawned on the one card (NCCL
                  refuses two ranks on one GPU): the 1-D ring, the
                  two-level ring (pod 2 x data 2), ring2d (data 2 x
                  model 2) and the Laplace ring, each rank 4 launches of
                  B1 and of B2 a ring (B5 for Laplace; one each for
                  ring2d), the gathered answers held to (a)'s, times
                  labelled gloo, host-staged; (c) ServeEngine(backend=
                  "ring") at world 1, register (one B1) and requests of 1,
                  128 and 4096 rows (one B2 each) against the flash
                  engine, then ``python -m repro_torch.launch.serve_kde
                  --backend ring --n 32768 --verify`` must exit 0;
 13. measurement  ROADMAP C's watch item first: B4 on the clustered set
                  at phase 10a's tuner winner against 128 x 128, every
                  tier (CUDA-graph device time); (a) the measured-cell
                  writer (``repro_torch.plan.cells``) run again to a
                  temporary file, each cell held to the committed
                  ``plan/h100_cells.json``: occupancy within 0.01,
                  pruning error within 10x (or both under their epsilon-0
                  run's reorder noise), RFF hit fraction within 0.02;
                  (b) ServeConfig(plan="auto") with the default cells
                  at repro's 262144 x 16 clustered regime and the main
                  set, accuracy 1e-5 and 5e-4: the plan, one request's
                  launches (B4 when it prunes, B2 when not) and its
                  answer against float64 within the tier's bar plus the
                  cell's measured pruning error; (c) Fig. 5: SDKDE
                  prune="off" fit + evaluate at k = 4096 ... 32768 (k/8
                  queries, d 16, f32; and 1M with --paper-scale), the
                  paper's FLOP count over time x the FP32 peak, beside
                  B1 + B2's bound; (d) roofline rows
                  (``repro_torch.analysis``): B1 and B2 at the main shape
                  and the SSM prefill (model FLOPs over phase 8's warm
                  prefill, FlopCounterMode's aten FLOPs beside them);
 14. attention    the dense and hybrid families at full width and depth,
                  bf16, weights drawn on the card from the seed, through
                  launch.serve.generate at batch 4, prompt 1024: (a)
                  Gemma-2-2B, 32 greedy tokens, the SD-KDE monitor on:
                  B1 must launch once (the fit) and B2 twice (threshold,
                  scores), no other kernel, and the monitor's launches
                  are held against their plain versions; a warm prefill
                  and one decode step profiled; (b) Minitron-8B,
                  Phi-3-mini, ChatGLM3-6B and Hymba-1.5B, 8 tokens each,
                  each freed before the next: no kernel but Hymba's
                  fused B7, exactly once a layer in its prefill, no
                  other scan path; then the fused B7 at Hymba's layer
                  shape against its plain version; (c) Gemma-2 on one
                  8192-token prompt: chunked_attention in every layer
                  (no run of (a) or (b) may reach it), logits finite;
                  (d) f32 at 2 layers of full width: prefill(p[:S]) plus
                  one decode step against prefill(p[:S+1]), logits and
                  every cache entry, for Gemma-2, ChatGLM3 and Hymba
                  (phase 8's bars), and chunked_attention against
                  full_attention at Gemma-2's head shapes, S 8192,
                  softcap 50, window 4096 and none.  Prefill ms, decode
                  tok/s, KV cache bytes and peak memory by stage are
                  printed beside the card's name and power limit;
 15. families     the MoE, VLM and audio families, bf16, weights drawn
                  on the card from the seed, one model resident at a
                  time, through launch.serve.generate at batch 4: (a)
                  Granite-3.0-MoE-3B-A800M at full width and depth
                  (3,375,072,768 parameters), prompt 1024, 32 tokens,
                  the monitor on: B1 once, B2 twice, no other kernel;
                  the monitor's launches against their plain versions;
                  the share of (token, choice) pairs dropped in the
                  prefill and each decode step; a warm prefill and one
                  decode step profiled; (b) Kimi-K2 at full width (384
                  experts of 7168 x 2048, the shared expert, vocab
                  163840), depth 1 of 61, prompt 1024, 8 tokens; its MoE
                  layer on the prefill's hidden states against an
                  independent per-expert f32 loop over the same bf16
                  weights and routing, per element within the bf16 bar
                  times the terms' absolute mass; (c) LLaVA-NeXT-34B at
                  full width, depth 16 of 60, 2880 patches + 1024
                  tokens, 8 tokens; (d) Whisper-large-v3 whole (32
                  encoder + 32 decoder layers, 1500 frames), prompt
                  440, 8 tokens; none of (b)-(d) may launch a kernel;
                  (e) f32 at 2 layers of full width: LLaVA (the cache
                  position after the patch prefix) and Whisper
                  prefill(p[:S]) + one decode step against
                  prefill(p[:S+1]); Granite the same at capacity factor
                  E/k (nothing drops; a top-k set that flips between
                  the paths on a near tie, gap <= 2e-4, is reported and
                  its row left out, a wider flip fails); Granite at its
                  default capacity factor, each layer's MoE output
                  against the per-expert f32 loop (phase 8's bars).
                  Prefill ms (first, warm), decode tok/s, KV bytes and
                  peak memory by stage are printed beside the card's
                  name and power limit;
 16. training     (a) each of the eight CUDA wrappers (B1-B6, B7's two
                  modes), given card operands that require grad, refuses
                  under grad mode (C1: a launch has no backward) and runs
                  under no_grad on the same inputs; (b) every family's
                  reduced config (f32) takes 3 steps of
                  launch.steps.make_train_step on the card and on the CPU
                  from the same parameters and batches (4 x 16, 2
                  microbatches), loss, grad norm, lr, every parameter and
                  optimizer-state leaf held at the model bar (the Mamba
                  families' and the bf16 accumulators' gradient-derived
                  leaves at their own bars), and no B1-B7 launch; (c)
                  Gemma-2-2B whole (2,614,341,888 bf16 parameters, AdamW
                  with f32 master, moments and accumulator, remat
                  "full", loss_chunk 512), batch 4 x 1024 in 2
                  microbatches, 3 steps: step ms (first, warm), tokens/s,
                  peak memory, MFU over the bf16 peak, one warm step
                  profiled (device busy by class, idle share), finite
                  loss and grad norm, no B1-B7 launch; then f32 at 2
                  layers of full width against the same step in float64
                  on the card (loss, grad norm, lr, parameters, moments;
                  the model bar); (d) the ~100M Gemma-2-family config of
                  examples/train_lm.py, built from its fields, 300 steps
                  of 8 x 128: the mean of the last 10 losses below the
                  first 10's by more than 1.0 (repro's assert), tokens/s;
                  (e) ``python -m repro_torch.launch.train`` at the
                  reduced Gemma-2 as three processes: --inject-failure 7
                  exits 42, the same command resumes at step 5, and its
                  step-10 checkpoint equals an uninterrupted run's bit
                  for bit; the saves' host-snapshot ms and bytes.
  17. dry run      (a) ``python -m repro_torch.launch.dryrun`` over listed
                  production cells on fake worlds of 256 / 512 ranks, in
                  a child process; (b) on a one-rank NCCL (1, 1) mesh,
                  Gemma-2-2B's train step and Granite-MoE's decode step
                  against the mesh-less ones; (c) the flash_sdkde_32k
                  cell (B1 once, B2 once) against SDKDE flash;
 18. mesh train   the launcher over a world: (a) reduced Gemma-2 through
                  ``torchrun --standalone --nproc-per-node 1 -m
                  repro_torch.launch.train`` (one NCCL rank, mesh (1,
                  1)): --inject-failure 7 exits 42, the same command
                  resumes at step 5, and its step-10 checkpoint (sharded
                  entries) equals an uninterrupted world run's and the
                  one-device launcher's (16e) bit for bit; the saves'
                  host-snapshot ms and bytes, the restore ms and the
                  launcher's own kernel counts; (b)
                  that checkpoint restored whole on the
                  card, the one-device one restored onto the (1, 1) mesh,
                  each equal to its source bit for bit, and one train
                  step from each held at the model bar, no B1-B7 launch;
                  (c) Gemma-2-2B whole (16c's shape, 5 steps) through
                  both launchers, each its own process: losses equal bit
                  for bit, step ms (first, every warm one, their median)
                  and the launchers' kernel counts printed.  The elastic
                  restart across worlds of several ranks is a CPU test:
                  NCCL refuses two ranks on one card.

Before the last line it prints one JSON object ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises and exits non-zero with no result line, as does a machine with no
CUDA device or a directory without the repository's ``src/``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def _load_profile():
    """``repro_torch.analysis.profile`` (the profiler accounting and the
    CUDA-event / CUDA-graph timers), loaded by path: it imports torch
    alone, and ``--prefill-profile`` imports another checkout's
    ``repro_torch`` into this process."""
    path = ROOT / "src" / "repro_torch" / "analysis" / "profile.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_profile", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


profile = _load_profile()
cuda_ms, graph_ms = profile.cuda_ms, profile.graph_ms
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
# phase 11: resilient serving.  repro's defaults, S 2 x R 2, at the main
# path's size, timed over RES_REPEATS warm requests a size; the chaos
# runs' traffic, kill window and faults; the clustered set at S 4 with
# shard 3 lost; the admission burst at ADMIT_LOAD x the probed capacity
RES_SHARDS, RES_REPLICAS = 2, 2
RES_SIZES = (1, 128, 4096)
RES_REPEATS = 11
RES_HEDGE_MS = 1000.0
CHAOS_REQUESTS, CHAOS_ROWS, CHAOS_WINDOW = 60, 128, (20, 40)
CHAOS_SLOW_MS, CHAOS_HEDGE_MS, CHAOS_NAN = 25.0, 5.0, 0.2
DEG_SHARDS, DEG_LOST, DEG_ROWS = 4, 3, 256
ADMIT_WORKERS, ADMIT_QUEUE, ADMIT_ARRIVALS, ADMIT_LOAD = 2, 64, 512, 4.0
ADMIT_PROBE = 64                        # requests of the capacity probe
# the shedding rung serves bf16x2, not the default bf16: on the 16-d
# mixture's tails the bf16 tier misses its ladder rtol (5e-2) against f32
# (10.8% at most over 16384 queries, the plain version at 32768 x 16 on
# the CPU; phase 11d prints the card's), so answers browned to bf16
# could not be held to their tier's bar
ADMIT_BROWNOUT = (None, None, "bf16x2")
# B1 over rectangular blocks (a ring step's resident rows x a visiting
# block): (rows, columns) in phase 3, the first timed in phase 5
RECT_SHAPES = ((8192, 32768), (32768, 8192), (128, 32768))
# B1's square time at the main shape before the rectangular form (PERF.md
# §6's kernel table; NVIDIA H100 80GB HBM3, 700 W), by tier, printed
# beside phase 5's
B1_SQUARE_BEFORE_MS = {"f32": 2.726, "bf16x2": 1.876, "bf16": 1.029}
# phase 12: the ring.  Four gloo ranks on the one card (NCCL refuses two
# ranks on one GPU), the requests of 12c, and serve_kde's time limit
RING_RANKS = 4
RING_SIZES = (1, 128, 4096)
RING_TIMEOUT_S = 300


# phase 14: the attention families at full width and depth, weights drawn
# on the card, through launch.serve.generate.  Gemma-2-2B serves like
# phase 8 (monitor on); the other four decode ATTN_GEN tokens; Gemma-2
# then prefills one LONG_PROMPT-token prompt (the only run that reaches
# chunked_attention, and where the 4096 window masks anything); the f32
# checks run at CHECK_LAYERS of full width (phase 8's bars), and
# chunked_attention against full_attention at Gemma-2's head shapes
ATTN_MAIN = "gemma2_2b"
ATTN_OTHERS = ("minitron_8b", "phi3_mini_3p8b", "chatglm3_6b", "hymba_1p5b")
ATTN_GEN = 8
LONG_PROMPT = 8192
ATTN_CHECKS = ("gemma2_2b", "chatglm3_6b", "hymba_1p5b")
CHUNK_WINDOWS = (4096, None)
# the published sizes (tests/test_torch_dense.py holds param_count to them)
ATTN_PARAMS = {"gemma2_2b": 2_614_341_888, "minitron_8b": 7_734_562_816,
               "phi3_mini_3p8b": 3_822_259_200,
               "chatglm3_6b": 6_243_454_976, "hymba_1p5b": 1_663_131_200}


# phase 15: the MoE, VLM and audio families, weights drawn on the card,
# one model resident at a time.  Granite-MoE serves like phase 14's
# Gemma-2 (full width and depth, monitor on); Kimi-K2 at full width and a
# depth of KIMI_LAYERS of 61 (two layers, 73 GB, do not fit beside the
# activations); LLaVA-NeXT at full width and VLM_LAYERS of 60 (each layer
# materialises 13.7 GB of f32 scores over 2880 patches + 1024 tokens);
# Whisper full, its prompt AUDIO_PROMPT tokens (the decoder's 448-token
# context less FAM_GEN).  The f32 checks run at CHECK_LAYERS of full
# width (Whisper: CHECK_LAYERS encoder and decoder layers)
FAM_MOE = "granite_moe_3b_a800m"
FAM_KIMI, KIMI_LAYERS = "kimi_k2_1t_a32b", 1
FAM_VLM, VLM_LAYERS = "llava_next_34b", 16
FAM_AUDIO, AUDIO_PROMPT = "whisper_large_v3", 440
FAM_GEN = 8
# LLaVA's prefill + decode against the longer prefill, f32: rtol 1e-5
# with atol 1e-5 of the largest logit (the CPU test's bar,
# tests/test_torch_families.py); with the cache position left at S, as
# repro's prefill leaves it, the step misses by far more than the logits'
# own scale
VLM_RTOL = 1e-5
# the published sizes (tests/test_torch_families.py holds param_count to
# them)
FAM_PARAMS = {"granite_moe_3b_a800m": 3_375_072_768,
              "kimi_k2_1t_a32b": 1_043_853_440_000,
              "llava_next_34b": 34_440_297_472,
              "whisper_large_v3": 1_536_652_800}

# phase 16: training.  Gemma-2-2B whole (bf16 weights; AdamW with f32
# master, moments and accumulator; remat "full"; loss_chunk 512, which at
# S - 1 = 1023 takes the whole sequence, repro's rule), batch 4 x 1024 in
# 2 microbatches of 2 (phase 14's serving batch), TRAIN_STEPS steps; its
# f32 check at TRAIN_CHECK_LAYERS of full width against float64; every
# family's reduced config on the card against the CPU; the ~100M config
# of examples/train_lm.py (its fields; 300 steps of 8 x 128)
TRAIN_ARCH = "gemma2_2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB, TRAIN_STEPS = 4, 1024, 2, 3
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 256
TRAIN_CHECK_LR = 1e-7
TRAIN_REDUCED_BATCH, TRAIN_REDUCED_SEQ, TRAIN_REDUCED_STEPS = 4, 16, 3
# the gradient-derived leaves' bars (tests/test_torch_train_step.py): the
# families with a Mamba block, whose f32 gradients' noise floor lies
# above the model bar, and bf16 accumulators (three bf16 roundings, 3
# ulps, doubled in the second moments; of the leaf's largest magnitude
# too, since two microbatches' gradients can cancel)
TRAIN_SSM_ATOL = 2e-4
TRAIN_BF16_BAR = 6 * 2.0**-8
HUNDRED_M = dict(n_layers=6, d_model=512, n_heads=8, n_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab_size=32768,
                 dtype=torch.float32, param_dtype=torch.float32,
                 remat="none", loss_chunk=128, sliding_window=64)
HUNDRED_M_STEPS, HUNDRED_M_BATCH, HUNDRED_M_SEQ = 300, 8, 128
# the H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet, 700 W),
# the MFU denominator
BF16_PEAK = 989e12


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


def close_stats(got, want, rtol: float, what: str,
                atol_frac: float = 1e-6) -> tuple:
    """(errors, excess) of allclose(rtol, atol = atol_frac·peak): the
    largest absolute and relative errors and how far the worst element
    lies outside the bar (> 0 is a miss); raises on a non-finite value."""
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
    return {"max_abs_err": float(diff.max()), "max_rel_err": rel,
            "rtol": rtol, "atol": atol}, excess


def compare(got, want, rtol: float, what: str, *,
            atol_frac: float = 1e-6) -> dict:
    """allclose(rtol, atol = atol_frac·peak) on the card, logged; raises
    on a miss.  Sums that cross zero (Laplace) go through
    ``compare_mass``."""
    out, excess = close_stats(got, want, rtol, what, atol_frac)
    log(f"  {what}: max rel err {out['max_rel_err']:.3e} (bar rtol "
        f"{rtol:.1e}, atol {out['atol']:.2e}), max abs err "
        f"{out['max_abs_err']:.3e}")
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
# (their mnemonic with its shape and types, HMMA.16816.F32.BF16)
_TENSOR_OPS = re.compile(r"\b(?:HMMA|HGMMA)\b[\w.]*")


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
    """{kernel<...>: (HMMA/HGMMA instructions, those of them on BF16
    operands, those on TF32 operands)} in the SASS of library ``name``
    (cuobjdump -sass), or None where the toolkit has no cuobjdump."""
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
            counts[fn] = (0, 0, 0)
        elif fn is not None:
            ops = _TENSOR_OPS.findall(ln)
            counts[fn] = tuple(
                c + n for c, n in zip(counts[fn], (
                    len(ops), sum(".BF16" in o for o in ops),
                    sum(".TF32" in o for o in ops))))
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
    # B1-B6: the bf16 tiers' products run on the tensor cores, and so do
    # the f32 score pass's (B1, B3: three exact bf16 planes a side); the
    # f32 KDE pass's (B2, B4, B5, B6) run on FP32 FMAs; none on TF32
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
        log(f"  {name}: HMMA/HGMMA instructions (on BF16, on TF32) per "
            "split-column instantiation: " + ", ".join(
                f"{k} {v} ({b}, {t})"
                for k, (v, b, t) in sorted(passes.items())))
        wrong = [k for k, (v, b, t) in passes.items()
                 if t or (v if k.startswith("kde_pass<f32,") else not b)]
        if not passes or wrong:
            raise AssertionError(
                f"{name}: the bf16 tiers and the f32 score pass must use "
                "BF16 tensor instructions, the f32 KDE pass none, and none "
                f"TF32: {wrong or counts}")
        hmma[name] = {k: v for k, (v, _, _) in passes.items()}
    return hmma, scan_regs


def score_mass_args(args, i):
    """B1's or B3's arguments with |[X|1]| for xaug (at ``args[i]``; at
    f32, where it is None, made from xt at ``args[i - 1]``) and its lo
    plane (the last argument): the plain pass then gives each value's
    absolute mass, sum_j phi_ij |[x_j | 1]_k| (at bf16x2 an upper bound,
    |hi| + |lo|).  S1 cancels between points on either side of x_i, so
    the score pass's error is absolute, bar times this mass (as the
    Laplace sums are held); for the ones column, S0, the mass is S0
    itself."""
    from repro_torch.kernels import flash_score as fs

    out = list(args)
    if out[i] is None:
        out[i] = fs.ones_augmented(out[i - 1])
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


def rect_score_operands(ops, rows, cols, precision, block_m, block_n, h):
    """Rectangular B1 at one tier: m resident rows against n other
    columns, each side cast and normed as ``ops._score_operands`` makes
    them (the ring's blocks are f32; the tiers are checked all the
    same), with the kernel, plain and mass callables."""
    from repro_torch.kernels import flash_score as fs

    inv = ops._inv2h2(h, rows.device)
    r_ops, _, _, nrm_y, rrec = ops._score_operands(
        ops._pad_to(rows, block_m), precision)
    _, c_xt, c_aug, nrm_x, crec = ops._score_operands(
        ops._pad_to(cols, block_n), precision)
    args = (r_ops[0], nrm_y, c_xt[0], c_aug[0], inv, r_ops[1], c_xt[1],
            c_aug[1])
    nx = nrm_x.reshape(1, -1)
    m, n, d = rows.shape[0], cols.shape[0], rows.shape[1]
    return dict(
        kind="score",
        kernel=lambda: fs.flash_score_cuda(*args, nrm_x=nx, block_m=block_m,
                                           block_n=block_n),
        plain=lambda: fs.flash_score_plain(*args, nrm_x=nx, block_n=512),
        mass=lambda: fs.flash_score_plain(*score_mass_args(args, 3),
                                          nrm_x=nx, block_n=512),
        real=slice(0, m), pairs=m * n,
        moved=nbytes(*args, nx) + m * (d + 1) * 4,
        pts=torch.cat([rrec[:m], crec[:n]]))


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
    [0, 20]^16, sigma 1, train and queries drawn with numpy from SEED;
    and the centres."""
    rng = np.random.default_rng(SEED)
    centres = rng.uniform(0.0, CLU_SPREAD, (CLU_K, D))
    return (clustered_points(rng, centres, N_TRAIN, dev),
            clustered_points(rng, centres, N_QUERY, dev), centres)


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
    cx, cy, _ = clustered_set(gen.device)
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
    # B1 over rectangular blocks: a ring step's rows against a visiting
    # block of other points, wide, tall and one 128-row block
    h = 0.78
    for m, n in RECT_SHAPES:
        rows, cols = mixture.sample(m, gen), mixture.sample(n, gen)
        for precision in TIERS:
            c = rect_score_operands(ops, rows, cols, precision, block_m,
                                    block_n, h)
            res = check_kernel("flash_score", c, precision, h,
                               f"rectangular m={m} n={n} d={D}")
            results.setdefault("flash_score rect", {}).setdefault(
                f"{m}x{n}", {})[precision] = res
            del c
        del rows, cols
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
    x, y, _ = clustered_set(dev)
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
             "bound_by": by, "pairs": c["pairs"], "moved": c["moved"]}
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
    log("  B1 square at the main shape against its time before the "
        "rectangular form (PERF.md): " + ", ".join(
            f"{t} {entries['flash_score'][t]['ms']:.4f} ms (was "
            f"{B1_SQUARE_BEFORE_MS[t]:.3f}, "
            f"{entries['flash_score'][t]['ms'] / B1_SQUARE_BEFORE_MS[t]:.3f}"
            "x)" for t in TIERS))
    m, n = RECT_SHAPES[0]
    rows, cols = x[:m], mixture.sample(n, gen)
    log(f"  B1 rectangular, m={m} rows x n={n} columns:")
    for precision in TIERS:
        c = rect_score_operands(ops, rows, cols, precision, block_m,
                                block_n, h)
        entry = timed_entry("flash_score rect", c, precision, h, None)
        entry.update(errors["flash_score rect"][f"{m}x{n}"][precision],
                     rows=m, cols=n)
        entries.setdefault("flash_score rect", {})[precision] = entry
        del c

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


def device_breakdown(fn, label: str) -> dict:
    """One warm call of ``fn`` under torch.profiler, accounted by
    ``repro_torch.analysis.profile`` (device time by class: GEMMs, B7,
    everything else; the "other" class by kernel name; launches naming a
    ``GLUE_WORDS`` word; the device's busy time and idle share beside the
    call's host clock), and logged."""
    out = profile.device_breakdown(fn)
    busy, wall_ms, classes = (out["device_busy_ms"], out["wall_ms"],
                              out["by_class_ms"])
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
    log(f"    other by kernel (top {profile.TOP_OTHER}): "
        + "; ".join(f"{r['kernel']} {r['ms']:.2f} ms x{r['count']}"
                    for r in out["other_by_kernel"])
        + "; launches naming " + ", ".join(
            f"{k} {v}" for k, v in out["glue_launches"].items()))
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
        # the aten products' FLOPs of one prefill (phase 13d's roofline)
        aten_flops = profile.flop_count(transformer.prefill, params, ids,
                                        cfg)
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
           "generate_ms": gen_ms, "prefill_aten_flops": aten_flops,
           "param_bytes": gb * 1e9,
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

    x, y, _ = clustered_set(dev)
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


# ---------------------------------------------------------------------------
# phase 11: resilient serving and admission
# ---------------------------------------------------------------------------


def res_engine(serve, prune: str, *, method: str = "sdkde",
               shards: int = RES_SHARDS, chaos=None, **rkw):
    """A ResilientEngine on the card: repro's defaults but for ``rkw``."""
    return serve.ResilientEngine(
        serve.ServeConfig(backend="flash", method=method, prune=prune),
        serve.ResilienceConfig(shards=shards, replicas=RES_REPLICAS,
                               seed=SEED, **rkw), chaos=chaos)


def shard_kernels(ops, table) -> list:
    """The kernel each shard's replicas launch for a request: B4 where
    ``prune`` engages for the shard's size (``ops.resolve_prune``), else
    B2 (B4's Laplace flag / B5 for ``method="laplace"``)."""
    out = []
    for s, row in enumerate(table.engines):
        prep = row[0].registry.get(table.skeys[s])
        pruned = ops.resolve_prune(prep.config.prune, prep.n_true,
                                   prep.block_n) is not None
        laplace = prep.config.method == "laplace"
        out.append(("flash_kde_pruned laplace" if laplace else
                    "flash_kde_pruned") if pruned else
                   ("flash_laplace" if laplace else "flash_kde"))
    return out


def within(got, want, rtol: float, what: str) -> float:
    """``compare`` without its log line (for the many answers of phase
    11); the largest relative error."""
    out, excess = close_stats(got, want, rtol, what)
    if excess > 0:
        raise AssertionError(f"{what}: outside rtol {rtol:.1e} by "
                             f"{excess:.3e}")
    return out["max_rel_err"]


def pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def resilient_exact(data, serve, ops, fs, fk, fp, fl, card) -> dict:
    """Phase 11a: ResilientEngine(S 2 x R 2) on the main path's data,
    prune "off" and "auto": register (one B1 / B3 launch), requests of
    1, 128 and 4096 rows against a plain ServeEngine (f32 bar) and
    float64, warm p50 / p99 beside the plain engine's, launches and
    synchronizing calls a request; under "off" also one cascade request
    (the full-set RFF band read once, its rows escalated).  Returns the
    "off" engine open, for 11d."""
    x, y, h, f64 = data["x"], data["y"], data["h"], data["f64"]
    bar = TIER_BAR["f32"]
    out, keep = {"launches": {}}, None
    for prune, fit in (("off", "flash_score"),
                       ("auto", "flash_score_pruned")):
        reset_counts(fs, fk, fp, fl)
        # no hedge within a second: an abandoned duplicate would launch
        # after the count it belongs to (11b exercises hedging)
        eng = res_engine(serve, prune, hedge_after_ms=RES_HEDGE_MS)
        table, reg_ms = host_ms(lambda: eng.register("r", x, h=h))
        reg = read_counts(fs, fk, fp, fl)
        total = dict(reg)
        kernels = shard_kernels(ops, table)
        log(f"  prune={prune!r}: register {N_TRAIN} x {D} as {table.n_shards}"
            f" shards x {table.n_replicas} replicas (shard sizes "
            f"{table.shard_n}, shard kernels {kernels}): {reg_ms:.2f} ms "
            f"with prewarm; launches {json.dumps(reg)} [{card}]")
        other = ({"flash_score", "flash_score_pruned"} - {fit}).pop()
        if reg[fit] != 1 or reg[other]:
            raise AssertionError(f"resilient register prune={prune!r} must "
                                 f"fit with one {fit} launch: {reg}")
        plain = serve.ServeEngine(serve.ServeConfig(
            backend="flash", method="sdkde", prune=prune))
        plain.register("p", x, h=h)
        rows = {}
        for m in RES_SIZES:
            req = serve.QueryRequest(key="r", points=y[:m])
            preq = serve.QueryRequest(key="p", points=y[:m])
            want = plain.query(preq).value
            eng.query(req)
            reset_counts(fs, fk, fp, fl)
            ans, _, syncs = sync_counted(lambda: eng.query(req))
            counts = read_counts(fs, fk, fp, fl)
            for k, v in counts.items():
                total[k] += v
            expect = {k: kernels.count(k) for k in set(kernels)}
            got = {k: v for k, v in counts.items() if v}
            if got != expect:
                raise AssertionError(f"resilient prune={prune!r} {m} rows: "
                                     f"launches {got}, expected {expect}")
            err = within(ans.value, want, bar,
                         f"resilient prune={prune!r} {m} rows vs plain")
            lat = [eng.query(req).latency_s * 1e3
                   for _ in range(RES_REPEATS)]
            plat = [plain.query(preq).latency_s * 1e3
                    for _ in range(RES_REPEATS)]
            rows[m] = {"p50_ms": pct(lat, 0.5), "p99_ms": pct(lat, 0.99),
                       "plain_p50_ms": pct(plat, 0.5),
                       "plain_p99_ms": pct(plat, 0.99),
                       "launches": got, "hedges": ans.hedges,
                       "sync_calls": len(syncs), "sync_sites": syncs,
                       "max_rel_err_vs_plain": err}
            log(f"  prune={prune!r} {m} rows: resilient p50 "
                f"{rows[m]['p50_ms']:.3f} / p99 {rows[m]['p99_ms']:.3f} ms, "
                f"plain ServeEngine p50 {rows[m]['plain_p50_ms']:.3f} / p99 "
                f"{rows[m]['plain_p99_ms']:.3f} ms (host clock, "
                f"{RES_REPEATS} warm requests); launches {got}; "
                f"synchronizing calls {len(syncs)}; max rel err vs plain "
                f"{err:.3e} [{card}]")
        ans = eng.query(serve.QueryRequest(key="r", points=y[:N_F64]))
        f64_err = compare(ans.value, f64, bar,
                          f"resilient prune={prune!r} vs float64 "
                          f"({N_F64} q, bound {ans.rel_err_bound:g})")
        entry = {"register_ms": reg_ms, "shard_n": table.shard_n,
                 "shard_kernels": kernels, "register_launches": reg,
                 "requests": rows, "vs_f64": f64_err}
        if prune == "off":
            creq = serve.QueryRequest(key="r", points=y[:RFF_ROWS],
                                      accuracy_target=CASCADE_TARGETS[-1])
            eng.query(creq)                      # fits the RFF tier
            reset_counts(fs, fk, fp, fl)
            cans, cms, csync = sync_counted(lambda: eng.query(creq))
            counts = read_counts(fs, fk, fp, fl)
            for k, v in counts.items():
                total[k] += v
            if cans.rff_hits + cans.escalated != RFF_ROWS:
                raise AssertionError("resilient cascade: hits + escalated "
                                     "!= rows")
            cerr = within(cans.value, plain.query(serve.QueryRequest(
                key="p", points=y[:RFF_ROWS])).value, bar,
                "resilient cascade vs plain")
            entry["cascade"] = {"hits": cans.rff_hits,
                                "escalated": cans.escalated, "ms": cms,
                                "sync_calls": len(csync),
                                "sync_sites": csync,
                                "launches": {k: v for k, v in
                                             counts.items() if v}}
            log(f"  cascade request, {RFF_ROWS} rows at target "
                f"{CASCADE_TARGETS[-1]:g}: {cans.rff_hits} hits, "
                f"{cans.escalated} escalated to the shards, {cms:.3f} ms, "
                f"synchronizing calls {len(csync)} (the band read and the "
                f"NaN guard's), max rel err vs plain {cerr:.3e} [{card}]")
            keep = eng
        else:
            eng.close()
        out[prune] = entry
        out["launches"][prune] = {k: v for k, v in total.items() if v}
    return out, keep


def chaos_run(serve, x, y, h, want, name, chaos, rkw, card) -> dict:
    """One chaos scenario: CHAOS_REQUESTS requests of CHAOS_ROWS rows,
    every answer held to the f32 bar against the plain engine's."""
    errors, nonfinite, worst, lat = {}, 0, 0.0, []
    with res_engine(serve, "off", chaos=chaos, **rkw) as eng:
        eng.register("c", x, h=h)
        for i in range(CHAOS_REQUESTS):
            rows = slice(i * CHAOS_ROWS, (i + 1) * CHAOS_ROWS)
            try:
                ans = eng.query(serve.QueryRequest(key="c", points=y[rows]))
            except serve.ServeError as e:
                errors[type(e).__name__] = errors.get(
                    type(e).__name__, 0) + 1
                continue
            if not bool(torch.isfinite(ans.value).all()):
                nonfinite += 1
                continue
            worst = max(worst, within(ans.value, want[rows],
                                      TIER_BAR["f32"], f"{name} #{i}"))
            lat.append(ans.latency_s * 1e3)
        st = dict(eng.stats)
        breakers = {k: v for k, v in eng.breaker_states().items()
                    if v != "closed"}
        injected = {k: v for k, v in eng.injector.snapshot().items() if v}
    out = {"answered": len(lat), "errors": errors, "nonfinite": nonfinite,
           "max_rel_err": worst, "p50_ms": pct(lat, 0.5),
           "p99_ms": pct(lat, 0.99), "stats": st,
           "breakers_not_closed": breakers, "injected": injected}
    log(f"  {name}: answered {len(lat)}/{CHAOS_REQUESTS} (max rel err vs "
        f"plain {worst:.3e}), typed errors {errors}, non-finite answers "
        f"{nonfinite}; retries {st['retries']}, hedges {st['hedges']} (won "
        f"{st['hedge_wins']}), dropped {st['dropped']}; breakers not closed "
        f"{breakers}; injected {injected}; p50 {out['p50_ms']:.3f} / p99 "
        f"{out['p99_ms']:.3f} ms [{card}]")
    if nonfinite:
        raise AssertionError(f"{name}: a non-finite answer reached the "
                             f"caller")
    return out


def resilient_chaos(data, serve, fi, card) -> dict:
    """Phase 11b: four chaos scenarios on the main path's data, prune
    "off": a kill of shard 0 / replica 0 over requests 20-40 (every
    answer exact, retries > 0), a slow replica with a hedge timer
    (hedges fired and won), NaN poison at 0.2 (no non-finite answer), a
    broken bucket callable on one replica (a breaker opens, traffic
    routes around it)."""
    x, y, h = data["x"], data["y"], data["h"]
    plain = serve.ServeEngine(serve.ServeConfig(backend="flash",
                                                method="sdkde", prune="off"))
    plain.register("p", x, h=h)
    n = CHAOS_REQUESTS * CHAOS_ROWS
    want = torch.cat([plain.query(serve.QueryRequest(
        key="p", points=y[i:i + CHAOS_ROWS])).value
        for i in range(0, n, CHAOS_ROWS)])
    lo, hi = CHAOS_WINDOW
    runs = {
        "shard_kill s0r0": (fi.ChaosConfig(events=(fi.ChaosEvent(
            "shard_kill", shard=0, replica=0, start=lo, stop=hi),),
            seed=SEED), {}),
        "slow_shard s0r0": (fi.ChaosConfig(events=(fi.ChaosEvent(
            "slow_shard", shard=0, replica=0, start=lo, stop=hi),),
            slow_ms=CHAOS_SLOW_MS, seed=SEED),
            {"hedge_after_ms": CHAOS_HEDGE_MS}),
        f"nan_poison {CHAOS_NAN:g}": (fi.ChaosConfig(nan_poison=CHAOS_NAN,
                                                     seed=SEED), {}),
        "compile_fail s0r0": (fi.ChaosConfig(events=(fi.ChaosEvent(
            "compile_fail", shard=0, replica=0),), seed=SEED), {}),
    }
    out = {name: chaos_run(serve, x, y, h, want, name, chaos, rkw, card)
           for name, (chaos, rkw) in runs.items()}
    kill = out["shard_kill s0r0"]
    if kill["errors"] or kill["stats"]["retries"] == 0:
        raise AssertionError(f"shard_kill: every request must be answered "
                             f"exactly, with retries: {kill}")
    slow = out["slow_shard s0r0"]
    if slow["errors"] or not (slow["stats"]["hedges"] > 0
                              and slow["stats"]["hedge_wins"] > 0):
        raise AssertionError(f"slow_shard: hedges must fire and win: {slow}")
    if not out[f"nan_poison {CHAOS_NAN:g}"]["injected"].get("nan_poison"):
        raise AssertionError("nan_poison: nothing was poisoned")
    broken = out["compile_fail s0r0"]
    if broken["errors"] or not any(
            k.startswith("c/s0r0") for k in broken["breakers_not_closed"]):
        raise AssertionError(f"compile_fail: a breaker of replica (0, 0) "
                             f"must open and traffic route around it: "
                             f"{broken}")
    return out


def resilient_degraded(serve, fi, kdemod, dev, card) -> dict:
    """Phase 11c: the clustered set, S 4 x R 2, both replicas of shard 3
    killed.  Queries drawn around the centres whose points all lie in
    shard 0 get certified degraded answers: each row's error against the
    float64 full-set density within its bound (plus the answer's own f32
    bar); queries around shard 3's centres get a typed Degraded; one
    Laplace request uses the two-sided bound."""
    x, _, centres = clustered_set(dev)
    h = CLU_H
    bar = tier_bar("f32", x, h)
    chaos = fi.ChaosConfig(events=(fi.ChaosEvent("shard_kill",
                                                 shard=DEG_LOST),),
                           seed=SEED)
    rng = np.random.default_rng(SEED + 11)
    c_t = torch.as_tensor(centres, dtype=torch.float32, device=dev)
    x64 = x.double()
    out = {}
    for method in ("sdkde", "laplace"):
        with res_engine(serve, "off", method=method, shards=DEG_SHARDS,
                        chaos=chaos) as eng:
            table, reg_ms = host_ms(lambda: eng.register("d", x, h=h))
            # the centre owning each shard's points, and the centres whose
            # points all lie in one shard
            owner, near = np.full(CLU_K, -1), []
            for s in range(table.n_shards):
                pts = table.engines[s][0].registry.get(table.skeys[s]).points
                near.append(torch.cdist(pts, c_t).argmin(1).cpu().numpy())
                for c in np.unique(near[s]):
                    owner[c] = s if owner[c] == -1 else -2
            live_c = np.flatnonzero(owner == 0)
            lost_c = np.flatnonzero(owner == DEG_LOST)
            if not (live_c.size and lost_c.size):
                raise AssertionError(f"degraded: no centre lies wholly in "
                                     f"shard 0 or {DEG_LOST}: {owner}")

            def around(cs):
                pick = rng.choice(cs, DEG_ROWS)
                return torch.as_tensor(
                    centres[pick] + rng.standard_normal((DEG_ROWS, D)),
                    dtype=torch.float32, device=dev)

            if method == "sdkde":
                yq = around(live_c)
            else:
                # a blob's radius away from every point the Laplace sums
                # are negative (1 + d/2 < sq/2h² there), and no bound is
                # two-sided below zero: rows next to shard 0's own points
                pts0 = table.engines[0][0].registry.get(table.skeys[0]).points
                own = np.flatnonzero(np.isin(near[0], live_c))
                pick = torch.as_tensor(rng.choice(own, DEG_ROWS), device=dev)
                yq = pts0[pick] + 0.05 * torch.as_tensor(
                    rng.standard_normal((DEG_ROWS, D)), dtype=torch.float32,
                    device=dev)
            ans, q_ms = host_ms(lambda: eng.query(
                serve.QueryRequest(key="d", points=yq)))
            if not (ans.degraded and ans.missing_shards == (DEG_LOST,)):
                raise AssertionError(f"degraded {method}: expected a "
                                     f"degraded answer without shard "
                                     f"{DEG_LOST}: {ans.missing_shards}")
            if method == "sdkde":
                f = kdemod.sdkde_eval(x64, yq.double(), h)
                slack = bar * ans.value.double().abs()
            else:
                f = kdemod.laplace_kde_eval(x64, yq.double(), h)
                slack = bar * laplace_mass(kdemod, x, yq, h)
            got = ans.value.double()
            err = (got - f).abs()
            bound = torch.as_tensor(ans.rel_err_bounds, device=dev)
            excess = float((err - bound * f.abs() - slack).max())
            realized = err / f.abs()
            ratio = (realized / bound).cpu().numpy()
            entry = {"register_ms": reg_ms, "query_ms": q_ms,
                     "shard_n": table.shard_n,
                     "centres_shard0": int(live_c.size),
                     "centres_lost": int(lost_c.size),
                     "bound_median": float(np.median(ans.rel_err_bounds)),
                     "bound_max": float(ans.rel_err_bounds.max()),
                     "realized_over_bound_median": float(np.median(ratio)),
                     "realized_over_bound_max": float(ratio.max()),
                     "rows_over_bound": int((ratio > 1).sum()),
                     "worst_margin": excess, "f32_bar": bar,
                     "retries": ans.retries}
            where = (f"around {live_c.size} centres" if method == "sdkde"
                     else f"next to the points of {live_c.size} centres")
            log(f"  degraded {method}: S {table.n_shards} (sizes "
                f"{table.shard_n}), shard {DEG_LOST} lost; {DEG_ROWS} rows "
                f"{where} of shard 0: bound median "
                f"{entry['bound_median']:.4e}, max {entry['bound_max']:.4e}"
                f"; realized / bound median "
                f"{entry['realized_over_bound_median']:.6f}, max "
                f"{entry['realized_over_bound_max']:.6f} ({entry['rows_over_bound']}"
                f" rows above 1, within the answer's f32 bar {bar:.1e}); "
                f"worst margin {excess:.3e} (must be <= 0); query "
                f"{q_ms:.2f} ms, retries {ans.retries} [{card}]")
            if excess > 0:
                raise AssertionError(f"degraded {method}: a row's error "
                                     f"exceeds its certified bound")
            if method == "sdkde":
                try:
                    eng.query(serve.QueryRequest(key="d",
                                                 points=around(lost_c)))
                except serve.Degraded as e:
                    entry["lost_shard_rows"] = {"bound": e.bound,
                                                "target": e.target}
                    log(f"  rows around shard {DEG_LOST}'s {lost_c.size} "
                        f"centres: typed Degraded (bound {e.bound:.3e} > "
                        f"target {e.target:g})")
                else:
                    raise AssertionError("degraded: rows around the lost "
                                         "shard were answered")
        out[method] = entry
    return out


def resilient_admission(data, serve, eng, card) -> dict:
    """Phase 11d: AsyncFrontend(workers 2, max_queue 64) over 11a's
    engine ("off"): a capacity probe (ADMIT_PROBE requests of 128 rows
    at once, drained), then ADMIT_ARRIVALS open-loop arrivals paced at
    ADMIT_LOAD x that capacity on the host clock.  Every future resolves
    as an answer, Overloaded, DeadlineExceeded or Degraded, nothing is
    unaccounted, the state machine reaches backpressure, and answered
    rows hold their tier's bar against phase 4's f32 densities."""
    from repro_torch.serve.frontend import BACKPRESSURE

    y, ref = data["y"], data["auto_dens"]
    bar = {t: tier_bar(t, data["x"], data["h"]) for t in TIERS}
    spans = [slice(o, o + CHAOS_ROWS) for o in range(
        0, N_QUERY - CHAOS_ROWS, CHAOS_ROWS)]
    with serve.AsyncFrontend(eng, serve.FrontendConfig(
            workers=ADMIT_WORKERS, max_queue=ADMIT_PROBE + 8,
            default_deadline_ms=60_000.0)) as probe:
        t0 = time.perf_counter()
        for i in range(ADMIT_PROBE):
            probe.submit(serve.QueryRequest(key="r",
                                            points=y[spans[i % len(spans)]]))
        probe.drain(timeout=60.0)
        capacity = ADMIT_PROBE / (time.perf_counter() - t0)
    rate = ADMIT_LOAD * capacity
    fe = serve.AsyncFrontend(eng, serve.FrontendConfig(
        workers=ADMIT_WORKERS, max_queue=ADMIT_QUEUE,
        brownout_tiers=ADMIT_BROWNOUT))
    futs, sheds, t_next = [], 0, 0.0
    start = time.perf_counter()
    for i in range(ADMIT_ARRIVALS):
        while (now := time.perf_counter() - start) < t_next:
            time.sleep(min(2e-3, t_next - now))
        t_next += 1.0 / rate
        sl = spans[i % len(spans)]
        try:
            futs.append((sl, fe.submit(serve.QueryRequest(key="r",
                                                          points=y[sl]))))
        except serve.Overloaded:
            sheds += 1
    arrive_s = time.perf_counter() - start
    drained = fe.drain(timeout=60.0)
    outcomes = {"answered": 0, "Overloaded": sheds, "DeadlineExceeded": 0,
                "Degraded": 0}
    waits, tiers, worst = [], {}, {}
    for sl, f in futs:
        if not f.done():
            raise AssertionError("admission: a future did not resolve")
        err = f.exception()
        if err is None:
            ans = f.result()
            outcomes["answered"] += 1
            waits.append(ans.queued_ms)
            tiers[ans.tier] = tiers.get(ans.tier, 0) + 1
            rel = within(ans.value, ref[sl], bar[ans.tier],
                         f"admission answer at {ans.tier}")
            worst[ans.tier] = max(worst.get(ans.tier, 0.0), rel)
        elif type(err).__name__ in outcomes:
            outcomes[type(err).__name__] += 1
        else:
            raise err
    rep = fe.report()
    unaccounted = fe.unaccounted()
    fe.close()
    visited = [t.split("->")[1] for t in rep["transitions"]]
    out = {"capacity_rps": capacity, "offered_rps": ADMIT_ARRIVALS / arrive_s,
           "outcomes": outcomes, "tiers": tiers, "max_rel_err": worst,
           "queue_wait_p50_ms": pct(waits, 0.5) if waits else 0.0,
           "queue_wait_p99_ms": pct(waits, 0.99) if waits else 0.0,
           "states": rep["transitions"], "rejected_by": rep["rejected_by"],
           "unaccounted": unaccounted, "drained": drained}
    log(f"  admission: capacity probe {capacity:.0f} requests/s of "
        f"{CHAOS_ROWS} rows; {ADMIT_ARRIVALS} arrivals paced for "
        f"{ADMIT_LOAD:g}x, offered at {out['offered_rps']:.0f}/s "
        f"({out['offered_rps'] / capacity:.2f}x); outcomes "
        f"{outcomes}; answered by tier {tiers} (max rel err {worst}); "
        f"rejected by {rep['rejected_by']}; states {rep['transitions']}; "
        f"queue wait of answered p50 {out['queue_wait_p50_ms']:.3f} / p99 "
        f"{out['queue_wait_p99_ms']:.3f} ms; unaccounted {unaccounted} "
        f"[{card}]")
    # information: the default shedding rung, bf16, on RFF_ROWS rows
    b16 = eng.query(serve.QueryRequest(key="r", points=y[:RFF_ROWS],
                                       precision="bf16")).value.double()
    want = ref[:RFF_ROWS].double()
    rel = (b16 - want).abs() / want.abs()
    over = int(((b16 - want).abs() > TIER_BAR["bf16"] * want.abs()
                + 1e-6 * want.abs().max()).sum())
    out["bf16_rung"] = {"max_rel_err": float(rel.max()),
                        "median_rel_err": float(rel.median()),
                        "rows_over_bar": over}
    log(f"  the default shedding rung, bf16, on {RFF_ROWS} rows against "
        f"f32 (information): max rel err {float(rel.max()):.3e}, median "
        f"{float(rel.median()):.3e}, {over} rows over its 5e-2 bar "
        f"[{card}]")
    if unaccounted or not drained:
        raise AssertionError(f"admission: {unaccounted} unaccounted")
    if BACKPRESSURE not in visited:
        raise AssertionError(f"admission: the state machine never reached "
                             f"backpressure: {rep['transitions']}")
    return out


def resilient_launcher(card) -> dict:
    """Phase 11e: the serve_kde launcher in this process, twice: sharded
    serving through a replica kill with --verify, and the open loop with
    --expect-shed (a client_burst surge into a queue of 16)."""
    import contextlib
    import io

    from repro_torch.launch import serve_kde

    runs = {
        "chaos": ["--n", str(N_TRAIN), "--d", str(D), "--shards", "2",
                  "--replicas", "2", "--chaos", "shard_kill", "--verify"],
        "open-loop": ["--n", str(N_TRAIN), "--d", str(D), "--open-loop",
                      "--requests", "120", "--burst", "8", "--max-queue",
                      "16", "--chaos", "client_burst", "--expect-shed"],
    }
    out = {}
    for name, argv in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, ms = host_ms(lambda: serve_kde.main(argv))
        text = buf.getvalue().splitlines()
        log(f"  serve_kde {' '.join(argv)}: exit {rc}, {ms:.0f} ms [{card}]")
        for line in text:
            log(f"    {line}")
        if rc != 0:
            raise AssertionError(f"serve_kde {name}: exit code {rc}")
        out[name] = {"argv": argv, "ms": ms, "stdout": text}
    return out


def phase_resilient(data, serve, ops, kdemod, fs, fk, fp, fl, card,
                    dev) -> dict:
    from repro_torch import fault_injection as fi

    log(f"== phase 11: resilient serving and admission, {N_TRAIN} x {D}, "
        f"S {RES_SHARDS} x R {RES_REPLICAS} [{card}]")
    t0 = time.perf_counter()
    out, eng = resilient_exact(data, serve, ops, fs, fk, fp, fl, card)
    try:
        out["chaos"] = resilient_chaos(data, serve, fi, card)
        out["degraded"] = resilient_degraded(serve, fi, kdemod, dev, card)
        out["admission"] = resilient_admission(data, serve, eng, card)
    finally:
        eng.close()
    out["launcher"] = resilient_launcher(card)
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 11 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the ring
# ---------------------------------------------------------------------------


def ring_counts(fs, fk, fl) -> dict:
    return {"flash_score": fs.launches, "flash_kde": fk.launches,
            "flash_laplace": fl.laplace_launches}


def ring_expect(counts: dict, want: dict, what: str) -> None:
    """The ring's launches: exactly ``want`` (B1, B2, B5), and no other
    flash kernel."""
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def ring_estimators(data, est_mod, fs, fk, fp, fl, card, label) -> dict:
    """SDKDE fit + evaluate and LaplaceKDE evaluate on the ring of the
    current default mesh, each with its launches (counts zeroed just
    before, read just after) and host-clock ms."""
    x, y, h = data["x"], data["y"], data["h"]
    cfg = est_mod.EstimatorConfig(backend="ring")
    out = {}
    reset_counts(fs, fk, fp, fl)
    sd = est_mod.SDKDE(h, cfg)
    _, fit_ms = host_ms(lambda: sd.fit(x))
    dens, eval_ms = host_ms(lambda: sd.evaluate(y))
    out["sdkde"] = {"dens": dens, "fit_ms": fit_ms, "evaluate_ms": eval_ms,
                    "launches": ring_counts(fs, fk, fl),
                    "launches_all": read_counts(fs, fk, fp, fl)}
    reset_counts(fs, fk, fp, fl)
    lap = est_mod.LaplaceKDE(data["lap_h"], cfg).fit(x)
    ldens, lms = host_ms(lambda: lap.evaluate(y))
    out["laplace"] = {"dens": ldens, "evaluate_ms": lms,
                      "launches": ring_counts(fs, fk, fl),
                      "launches_all": read_counts(fs, fk, fp, fl)}
    for k, r in out.items():
        log(f"  {label} {k}: launches {r['launches']}, "
            + (f"fit {r['fit_ms']:.2f} ms, " if "fit_ms" in r else "")
            + f"evaluate {r['evaluate_ms']:.2f} ms [{card}]")
    return out


def ring_rank(rank: int, world_size: int, store: str, out_dir: str) -> None:
    """Phase 12b, one of RING_RANKS gloo ranks on cuda:0: the 1-D ring,
    the two-level ring (pod 2 x data 2), ring2d (data 2 x model 2) and
    the Laplace ring over the main path's data; each rank checks its own
    launches, rank 0 writes the gathered answers and every rank its
    times."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import ring, ring2d, world
    from repro_torch.kernels import flash_kde as fk
    from repro_torch.kernels import flash_laplace as fl
    from repro_torch.kernels import flash_pruned as fp
    from repro_torch.kernels import flash_score as fs

    torch.cuda.set_device(0)
    world.init(rank, world_size, store)
    import torch.distributed as dist

    d = torch.load(Path(out_dir) / "data.pt")
    x, y = d["x"].cuda(), d["y"].cuda()
    h, lap_h, n = d["h"], d["lap_h"], x.shape[0]
    meshes = {
        "1d": init_device_mesh("cpu", (RING_RANKS,),
                               mesh_dim_names=("data",)),
        "pod": init_device_mesh("cpu", (2, RING_RANKS // 2),
                                mesh_dim_names=("pod", "data")),
        "2d": init_device_mesh("cpu", (2, RING_RANKS // 2),
                               mesh_dim_names=("data", "model")),
    }

    def run_ring(mesh, axes, fn, pod=None):
        xs = ring.shard_points(x, mesh, axes)
        ys = ring.shard_points(y, mesh, axes)
        return ring.gather_rows(fn(xs, ys, mesh, pod), mesh, axes)

    variants = {
        "1d": (lambda: run_ring(meshes["1d"], ("data",), lambda xs, ys, m, p:
                                ring.ring_sdkde(xs, ys, h, n_true=n,
                                                mesh=m)),
               {"flash_score": RING_RANKS, "flash_kde": RING_RANKS,
                "flash_laplace": 0}),
        "pod": (lambda: run_ring(meshes["pod"], ("pod", "data"),
                                 lambda xs, ys, m, p: ring.ring_sdkde(
                                     xs, ys, h, n_true=n, mesh=m,
                                     pod_axis="pod")),
                {"flash_score": RING_RANKS, "flash_kde": RING_RANKS,
                 "flash_laplace": 0}),
        "2d": (lambda: ring2d.ring2d_sdkde(x, y, h, mesh=meshes["2d"]),
               {"flash_score": 1, "flash_kde": 1, "flash_laplace": 0}),
        "laplace": (lambda: run_ring(meshes["1d"], ("data",),
                                     lambda xs, ys, m, p:
                                     ring.ring_laplace_kde(
                                         xs, ys, lap_h, n_true=n, mesh=m)),
                    {"flash_score": 0, "flash_kde": 0,
                     "flash_laplace": RING_RANKS}),
    }
    out = {}
    for name, (fn, want) in variants.items():
        fn()                                    # warm: groups, buffers
        dist.barrier()
        reset_counts(fs, fk, fp, fl)
        dens, ms = host_ms(fn)
        counts = ring_counts(fs, fk, fl)
        others = {k: v for k, v in read_counts(fs, fk, fp, fl).items()
                  if k not in counts and v}
        if counts != want or others:
            raise AssertionError(f"rank {rank} ring {name}: launches "
                                 f"{counts} {others}, expected {want}")
        out[name] = {"ms": ms, "launches": counts,
                     "dens": dens.cpu() if rank == 0 else None}
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def ring_serving(data, serve, fs, fk, fp, fl, card) -> dict:
    """Phase 12c: ServeEngine(backend="ring") at world 1 against the
    flash engine (prune "off"): register, then requests of RING_SIZES
    rows; then serve_kde --backend ring --n N_TRAIN --verify."""
    x, y, h = data["x"], data["y"], data["h"]
    out = {}
    engines = {}
    for backend in ("flash", "ring"):
        eng = serve.ServeEngine(serve.ServeConfig(backend=backend,
                                                  prune="off"))
        reset_counts(fs, fk, fp, fl)
        prep, reg_ms = host_ms(lambda: eng.register("r", x, h=h))
        engines[backend] = eng
        out[backend] = {"register_ms": reg_ms,
                        "register_launches": ring_counts(fs, fk, fl)}
    ring_expect(out["ring"]["register_launches"],
                {"flash_score": 1, "flash_kde": 0, "flash_laplace": 0},
                "ServeEngine(ring) register")
    bar = f32_bar(torch.cat([x, y]), 1 / (2 * h * h))
    for m in RING_SIZES:
        q = serve.QueryRequest(key="r", points=y[:m])
        for backend, eng in engines.items():
            eng.query(q)                        # builds the bucket
            reset_counts(fs, fk, fp, fl)
            ans, ms = host_ms(lambda: eng.query(q))
            out[backend][m] = {"ms": ms,
                               "launches": ring_counts(fs, fk, fl),
                               "value": ans.value}
        ring_expect(out["ring"][m]["launches"],
                    {"flash_score": 0, "flash_kde": 1, "flash_laplace": 0},
                    f"ServeEngine(ring) request of {m} rows")
        compare(out["ring"][m].pop("value"), out["flash"][m].pop("value"),
                bar, f"ServeEngine ring vs flash, {m} rows")
        log(f"  request of {m} rows: ring {out['ring'][m]['ms']:.3f} ms, "
            f"flash {out['flash'][m]['ms']:.3f} ms (host clock, warm) "
            f"[{card}]")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_kde",
           "--backend", "ring", "--n", str(N_TRAIN), "--verify"]
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    proc, ms = host_ms(lambda: subprocess.run(
        cmd, cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=RING_TIMEOUT_S))
    for line in proc.stdout.splitlines():
        log(f"    {line}")
    log(f"  {' '.join(cmd[1:])}: exit {proc.returncode}, {ms:.0f} ms "
        f"[{card}]")
    if proc.returncode != 0:
        raise AssertionError(f"serve_kde --backend ring exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    out["serve_kde"] = {"argv": cmd[1:], "ms": ms,
                        "stdout": proc.stdout.splitlines()}
    return out


def phase_ring(data, est_mod, serve, kdemod, fs, fk, fp, fl, card) -> dict:
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed import world

    log(f"== phase 12: the ring, {N_TRAIN} x {D} train, {N_QUERY} queries, "
        f"f32 [{card}]")
    t0 = time.perf_counter()
    x, y, h = data["x"], data["y"], data["h"]
    lap_h = est_mod.LaplaceKDE(config=est_mod.EstimatorConfig(
        prune="off")).fit(x).h
    data = dict(data, lap_h=lap_h)
    bar = f32_bar(torch.cat([x, y]), 1 / (2 * h * h))
    lap_bar = f32_bar(torch.cat([x, y]), 1 / (2 * lap_h * lap_h))
    out = {}
    # 12a: the flash path (prune "off": B1 + B2, B5), then the ring of one
    # with no group and in a one-rank NCCL group
    flash = {}
    cfg = est_mod.EstimatorConfig(prune="off")
    reset_counts(fs, fk, fp, fl)
    sd = est_mod.SDKDE(h, cfg)
    _, flash["fit_ms"] = host_ms(lambda: sd.fit(x))
    flash["sdkde"], flash["evaluate_ms"] = host_ms(lambda: sd.evaluate(y))
    flash["laplace"], flash["laplace_ms"] = host_ms(
        lambda: est_mod.LaplaceKDE(lap_h, cfg).fit(x).evaluate(y))
    log(f"  flash (prune off): SDKDE fit {flash['fit_ms']:.2f} ms, evaluate "
        f"{flash['evaluate_ms']:.2f} ms, LaplaceKDE evaluate "
        f"{flash['laplace_ms']:.2f} ms [{card}]")
    lap_mass = laplace_mass(kdemod, x, y, lap_h)
    runs = {"no group": ring_estimators(data, est_mod, fs, fk, fp, fl,
                                        card, "ring of one, no group")}
    with tempfile.TemporaryDirectory() as tmp:
        world.init(0, 1, os.path.join(tmp, "store"), backend="nccl")
        try:
            runs["nccl 1"] = ring_estimators(data, est_mod, fs, fk, fp, fl,
                                             card,
                                             "ring of one, NCCL world of 1")
        finally:
            dist.destroy_process_group()
    for label, r in runs.items():
        ring_expect(r["sdkde"]["launches"],
                    {"flash_score": 1, "flash_kde": 1, "flash_laplace": 0},
                    f"SDKDE ring ({label})")
        ring_expect(r["laplace"]["launches"],
                    {"flash_score": 0, "flash_kde": 0, "flash_laplace": 1},
                    f"LaplaceKDE ring ({label})")
        for k in ("sdkde", "laplace"):
            if any(v for n, v in r[k]["launches_all"].items()
                   if n not in r[k]["launches"]):
                raise AssertionError(f"ring {label} {k} launched another "
                                     f"kernel: {r[k]['launches_all']}")
        compare(r["sdkde"]["dens"], flash["sdkde"], bar,
                f"SDKDE ring ({label}) vs flash")
        compare_mass(r["laplace"]["dens"], flash["laplace"], lap_mass,
                     lap_bar, f"LaplaceKDE ring ({label}) vs flash")
    ref = runs["no group"]
    out["world1"] = {
        "flash": {k: flash[k] for k in ("fit_ms", "evaluate_ms",
                                        "laplace_ms")},
        **{label: {k: {kk: vv for kk, vv in v.items()
                       if kk not in ("dens", "launches_all")}
                   for k, v in r.items()} for label, r in runs.items()}}
    # 12b: RING_RANKS gloo ranks on the one card
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"x": x.cpu(), "y": y.cpu(), "h": h, "lap_h": lap_h},
                   Path(tmp) / "data.pt")
        _, spawn_ms = host_ms(lambda: world.spawn(
            ring_rank, RING_RANKS, tmp, timeout=RING_TIMEOUT_S))
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt")
                 for r in range(RING_RANKS)]
    want = {"1d": ref["sdkde"]["dens"], "pod": ref["sdkde"]["dens"],
            "2d": ref["sdkde"]["dens"], "laplace": ref["laplace"]["dens"]}
    out["world4"] = {"spawn_ms": spawn_ms}
    for name, w in want.items():
        got = ranks[0][name]["dens"].to(w.device)[:w.shape[0]]
        if name == "laplace":
            compare_mass(got, w, lap_mass, lap_bar,
                         f"{RING_RANKS} gloo ranks, ring {name} vs 12a")
        else:
            compare(got, w, bar, f"{RING_RANKS} gloo ranks, ring {name} "
                    "vs 12a")
        ms = [rk[name]["ms"] for rk in ranks]
        out["world4"][name] = {"ms_by_rank": ms,
                               "launches_by_rank": [rk[name]["launches"]
                                                    for rk in ranks]}
        log(f"  {RING_RANKS} ranks, ring {name}: launches a rank "
            f"{ranks[0][name]['launches']}; ms by rank "
            + ", ".join(f"{v:.1f}" for v in ms)
            + f" (gloo, host-staged) [{card}]")
    log(f"  the {RING_RANKS}-rank spawn took {spawn_ms:.0f} ms, rank "
        "start-up included")
    # 12c: serving
    out["serving"] = ring_serving(data, serve, fs, fk, fp, fl, card)
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 12 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: the measurement layer
# ---------------------------------------------------------------------------

# 13a: a measured cell against the committed one (plan/h100_cells.json):
# occupancy within CELL_OCC_TOL absolute (the k-means start is seeded; a
# card's reductions may still move a label), pruning error within a
# factor CELL_ERR_FACTOR (or both under their epsilon-0 run's reorder
# noise), hit fraction within CELL_HIT_TOL absolute
CELL_OCC_TOL, CELL_ERR_FACTOR, CELL_HIT_TOL = 0.01, 10.0, 0.02
# 13b: plan="auto" at two accuracy targets (f32-grade, bf16x2-grade)
PLAN_TARGETS = (1e-5, 5e-4)
# 13c: Fig. 5's sizes (k train, k/8 queries, d 16, f32)
FIG5_KS = (4096, 8192, 16384, 32768)
FIG5_REPS = 5


def watch_b4_tiles(ops, sp, clustered, winner, card) -> dict:
    """ROADMAP C's watch item: B4 on the clustered set at the launch
    tuner's winner (phase 10a, whose probe times B2 dense) against
    128 x 128, every tier, CUDA-graph device time."""
    cx, cy = clustered["x"], clustered["y"]
    index = sp.build_index(cx, seed=SEED)
    out = {}
    for bm, bn in (tuple(winner), (128, 128)):
        row = {}
        for tier in TIERS:
            c = pruned_operands(ops, sp, cx, cy, tier, bm, bn, CLU_H,
                                index)["flash_kde_pruned"]
            bms, by = bound_ms("kde", tier, c["pairs"], D, c["moved"])
            row[tier] = {"ms": graph_ms(c["kernel"]), "bound_ms": bms,
                         "bound_by": by, "occupancy": c["occupancy"],
                         "pairs": c["pairs"]}
            del c
        out[f"{bm}x{bn}"] = row
    win, base = out[f"{winner[0]}x{winner[1]}"], out["128x128"]
    for tier in TIERS:
        log(f"  B4 clustered {tier}: tuner winner {winner[0]}x{winner[1]} "
            f"{win[tier]['ms']:.4f} ms (occupancy "
            f"{win[tier]['occupancy']:.4f}, bound {win[tier]['bound_ms']:.4f}"
            f"), 128x128 {base[tier]['ms']:.4f} ms (occupancy "
            f"{base[tier]['occupancy']:.4f}, bound "
            f"{base[tier]['bound_ms']:.4f}); winner / 128x128 "
            f"{win[tier]['ms'] / base[tier]['ms']:.3f} [{card}]")
    return {"winner": list(winner), "tiles": out}


def _cell_label(key) -> str:
    kind, nb, d, x = key
    return (f"{kind} n<={nb} d {d} "
            + (f"eps {x:g}" if kind == "pruning" else f"target {x:g}"))


def measure_cells(card) -> dict:
    """13a: the writer run again, to a temporary file, every cell held
    to the committed one."""
    import tempfile

    from repro_torch.plan import cells, planner

    committed = json.loads(planner.CELLS_PATH.read_text())
    t0 = time.perf_counter()
    doc = cells.measure()
    with tempfile.TemporaryDirectory() as tmp:
        cells.write(doc, Path(tmp) / "cells.json")
        doc = json.loads((Path(tmp) / "cells.json").read_text())
    writer_s = time.perf_counter() - t0
    log(f"  writer: {len(doc['cells'])} cells in {writer_s:.1f} s, on "
        f"{doc['meta']['card']}, {doc['meta']['power_limit']}; committed: "
        f"{committed['meta']['card']}, {committed['meta']['power_limit']} "
        f"({committed['meta']['date']})")
    want = {cells.cell_key(c): c for c in committed["cells"]}
    got = {cells.cell_key(c): c for c in doc["cells"]}
    if set(want) != set(got):
        raise AssertionError(f"measured cell keys {sorted(got)} differ "
                             f"from the committed {sorted(want)}")
    gaps = {"occupancy": 0.0, "prune_rel_err_ratio": 1.0,
            "rff_hit_frac": 0.0}
    for key, c in want.items():
        m = got[key]
        if key[0] == "pruning":
            occ = abs(m["occupancy"] - c["occupancy"])
            e_m, e_c = m["prune_rel_err"], c["prune_rel_err"]
            quiet = e_m <= m["reorder_noise"] and e_c <= c["reorder_noise"]
            ratio = (max(e_m, e_c) / min(e_m, e_c) if min(e_m, e_c) > 0
                     else (1.0 if e_m == e_c else math.inf))
            ok = occ <= CELL_OCC_TOL and (ratio <= CELL_ERR_FACTOR or quiet)
            log(f"  {_cell_label(key)}: occupancy {m['occupancy']:.4f} vs "
                f"{c['occupancy']:.4f}, prune_rel_err {e_m:.3e} vs "
                f"{e_c:.3e} (reorder noise {m['reorder_noise']:.2e} / "
                f"{c['reorder_noise']:.2e}), B4 {m['pruned_kernel_ms']:.4f}"
                f" ms, B2 {m['dense_kernel_ms']:.4f} ms [{card}]")
            gaps["occupancy"] = max(gaps["occupancy"], occ)
            if not quiet:
                gaps["prune_rel_err_ratio"] = max(
                    gaps["prune_rel_err_ratio"], ratio)
        else:
            hit = abs(m["rff_hit_frac"] - c["rff_hit_frac"])
            ok = hit <= CELL_HIT_TOL
            log(f"  {_cell_label(key)}: rff_hit_frac "
                f"{m['rff_hit_frac']:.4f} vs {c['rff_hit_frac']:.4f} "
                f"({m['rff_hits']}/{m['rows']} rows), worst realized - "
                f"bound {m['worst_cert_slack']:.2e} [{card}]")
            gaps["rff_hit_frac"] = max(gaps["rff_hit_frac"], hit)
        if not ok:
            raise AssertionError(f"{_cell_label(key)}: the card measured "
                                 f"{m}, the committed cell says {c}")
    log(f"  largest gaps: occupancy {gaps['occupancy']:.2e} (tolerance "
        f"{CELL_OCC_TOL}), prune_rel_err ratio "
        f"{gaps['prune_rel_err_ratio']:.3f} (tolerance {CELL_ERR_FACTOR:g}"
        f"), rff_hit_frac {gaps['rff_hit_frac']:.2e} (tolerance "
        f"{CELL_HIT_TOL})")
    return {"writer_s": writer_s, "gaps": gaps, "cells": doc["cells"],
            "meta": doc["meta"]}


def serve_planned(data, serve, kdemod, fs, fk, fp, fl, card) -> dict:
    """13b: ServeConfig(plan="auto") with the default measured cells at
    repro's 262144 x 16 clustered regime and the main set, at each of
    PLAN_TARGETS: the plan, the launches of one request (B4 when it
    prunes, B2 when not) and its answer against float64 within the
    tier's bar plus the cell's measured pruning error."""
    from repro_torch.plan import cells, planner

    bench = planner.BenchModel.load()
    acc = cells.PRUNE_REGIMES[0]
    ax, ay = acc.draw(acc.n, N_F64, data["x"].device)
    regimes = {"repro acceptance": (ax, ay, acc.h, kdemod.sdkde_eval(
                   ax.double(), ay.double(), acc.h)),
               "main": (data["x"], data["y"][:N_F64], data["h"],
                        data["f64"])}
    out = {}
    for name, (x, y, h, f64) in regimes.items():
        n, d = x.shape
        for target in PLAN_TARGETS:
            eng = serve.ServeEngine(serve.ServeConfig(
                plan="auto", accuracy_target=target))
            prep, reg_ms = host_ms(lambda: eng.register("p", x, h=h))
            p = prep.plan
            req = serve.QueryRequest(key="p", points=y)
            eng.query(req)
            reset_counts(fs, fk, fp, fl)
            ans, q_ms = host_ms(lambda: eng.query(req))
            counts = read_counts(fs, fk, fp, fl)
            kernel = "flash_kde" if p.prune == "off" else "flash_kde_pruned"
            check_launches(counts, (kernel,),
                           f'plan="auto" {name} target {target:g}')
            err = (bench.measured_rel_err(n, d, p.prune) or 0.0
                   if p.prune != "off" else 0.0)
            bar = tier_bar(p.precision, torch.cat([x, y]), h) + err
            what = (f'plan="auto" {name} ({n} x {d}) target {target:g}: '
                    f"{p.plan_id}, rff {p.rff}, occupancy priced "
                    f"{p.occupancy:.4f}; answer vs float64")
            res = compare(ans.value, f64, bar, what)
            log(f"    register {reg_ms:.1f} ms, one {y.shape[0]}-row request "
                f"{q_ms:.3f} ms, launches {kernel} {counts[kernel]}, bar "
                f"{bar:.3e} (tier + measured prune_rel_err {err:.2e}) "
                f"[{card}]")
            out[f"{name} {target:g}"] = {
                "plan": p.as_dict(), "plan_id": p.plan_id,
                "register_ms": reg_ms, "request_ms": q_ms,
                "launches": counts[kernel], "bar": bar, "vs_f64": res}
            del eng
    return out


def fig5_utilization(mixture, gen, est_mod, paper, card) -> dict:
    """13c: Fig. 5 on the card.  SDKDE prune="off" fit + evaluate at k
    train and k/8 queries, d 16, f32 (CUDA-event medians); utilization is
    the paper's §4.1 count (an exp at 8 FLOPs) over time × the FP32
    peak; beside it B1 + B2's bound (``tuning.pair_bound``)."""
    from repro_torch.analysis import flops as fl_mod
    from repro_torch.kernels import tuning

    rows = {}

    def row(k, m, ms, how):
        work = fl_mod.sdkde_flops(k, D, n_test=m)
        util = work / (ms / 1e3 * tuning.FP32_FLOPS)
        b1 = tuning.pair_bound("score", "f32", k * k, D,
                               4 * k * (4 * D + 3))[0]
        b2 = tuning.pair_bound("kde", "f32", k * m, D,
                               4 * (m * (D + 2) + k * (D + 1)))[0]
        bound = (b1 + b2) * 1e3
        rows[k] = {"queries": m, "ms": ms, "paper_flops": work,
                   "utilization": util, "bound_ms": bound,
                   "bound_share": bound / ms, "timed": how}
        log(f"  k {k}, {m} queries: fit + evaluate {ms:.3f} ms ({how}); "
            f"{work:.4e} FLOPs (paper's model), {work / ms / 1e9:.3f} "
            f"TFLOP/s, utilization {util * 100:.2f}% of FP32 "
            f"{tuning.FP32_FLOPS / 1e12:g} TFLOP/s; B1 + B2 bound "
            f"{bound:.3f} ms ({bound / ms * 100:.1f}% of the time) [{card}]")

    for k in FIG5_KS:
        m = k // 8
        x = mixture.sample(k, gen)
        y = mixture.sample(m, gen)
        est = est_mod.SDKDE(config=est_mod.EstimatorConfig(prune="off"))
        row(k, m, cuda_ms(lambda: est.fit(x).evaluate(y), FIG5_REPS),
            f"CUDA-event median of {FIG5_REPS}")
        del est, x, y
    if paper is not None:
        off = paper["off"]
        row(1_048_576, 131_072, off["total_s"] * 1e3,
            "phase 6, host clock, one run")
    return rows


def roofline_rows(timings, ssm, card) -> dict:
    """13d: roofline rows (``analysis.roofline.format_table``): B1 and B2
    at the main shape from their per-pair operations and bytes
    (``tuning.pair_operations``: B1's plane products at the tensor-core
    peak, B2's FP32 operations at the FP32 peak) beside their measured
    time.  B2's model FLOPs are that count; B1's are the function's own
    products, 2d + 2(d+1) a pair, not the split's six plane products, so
    its MFU counts no redundant work.  And the SSM prefill: 2·N·D
    model FLOPs over phase 8's warm prefill (its MFU at the bf16 peak)
    and the aten products' FLOPs FlopCounterMode counted there."""
    from repro_torch.analysis import flops as fl_mod
    from repro_torch.analysis import roofline
    from repro_torch.kernels import tuning
    from repro_torch.launch import serve as serve_mod

    terms, measured = [], {}
    for name, kind, key in (("B1 flash_score", "score", "flash_score"),
                            ("B2 flash_kde", "kde", "flash_kde")):
        e = timings["entries"][key]["f32"]
        gemm, elem = tuning.pair_operations(kind, "f32", D)
        tensor = tuning.on_tensor_cores(kind, "f32")
        work = e["pairs"] * (gemm if tensor else gemm + elem)
        own = e["pairs"] * (4 * D + 2) if kind == "score" else work
        t = roofline.roofline_from_counts(
            arch=name, shape=f"{N_TRAIN}x{N_TRAIN}x{D} f32", flops=work,
            bytes=e["moved"], model_flops=own,
            hw=roofline.HW if tensor else roofline.HW_FP32)
        terms.append(t)
        measured[name] = e["ms"]
    cfg = serve_mod.build_config(SERVE_ARCH, layers=SERVE_LAYERS)
    tokens = SERVE_BATCH * SERVE_PROMPT
    t = roofline.roofline_from_counts(
        arch=f"{SERVE_ARCH} prefill", shape=f"{SERVE_BATCH}x{SERVE_PROMPT} "
        "bf16", flops=ssm["prefill_aten_flops"], bytes=ssm["param_bytes"],
        model_flops=fl_mod.model_flops(cfg, tokens, training=False),
        bytes_per_device=ssm["peak_memory_gib_by_stage"]["prefill"] * 2**30)
    terms.append(t)
    measured[t.arch] = ssm["prefill_warm_ms"]
    for line in roofline.format_table(terms).splitlines():
        log("  " + line)
    out = {}
    for t in terms:
        ms = measured[t.arch]
        out[t.arch] = {**t.row(), "peak_flops": t.hw.peak_flops,
                       "measured_ms": ms,
                       "roofline_share": t.step_time * 1e3 / ms,
                       "mfu_measured": t.mfu_at(ms / 1e3)}
        log(f"  {t.arch}: measured {ms:.4f} ms against the roofline's "
            f"{t.step_time * 1e3:.4f} ms ({t.bound}), "
            f"{t.step_time * 1e3 / ms * 100:.1f}% of it; model FLOPs / "
            f"counted {t.useful_flops_ratio:.4f}; MFU at the measured time "
            f"{t.mfu_at(ms / 1e3) * 100:.2f}% of "
            f"{t.hw.peak_flops / 1e12:g} TFLOP/s [{card}]")
    return out


def phase_measurement(data, clustered, mixture, gen, serve, est_mod, ops,
                      sp, kdemod, fs, fk, fp, fl, decisions, timings, ssm,
                      paper, card) -> dict:
    log(f"== phase 13: measurement (measured cells, plan=\"auto\" from "
        f"them, Fig. 5, roofline) [{card}]")
    t0 = time.perf_counter()
    out = {"watch_b4": watch_b4_tiles(
        ops, sp, clustered, decisions["tuner"]["B4 clustered"]["winner"],
        card)}
    log("  13a: measured cells against the committed ones")
    out["cells"] = measure_cells(card)
    log("  13b: plan=\"auto\" from the default cells")
    out["plans"] = serve_planned(data, serve, kdemod, fs, fk, fp, fl, card)
    log("  13c: Fig. 5, SDKDE utilization")
    out["fig5"] = fig5_utilization(mixture, gen, est_mod, paper, card)
    log("  13d: roofline rows")
    out["roofline"] = roofline_rows(timings, ssm, card)
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 13 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14: the attention families
# ---------------------------------------------------------------------------


class ChunkedCalls:
    """Counts ``models.attention.chunked_attention`` calls (the dispatch in
    ``attention`` looks the function up at each call) while installed."""

    def __init__(self, attn_mod):
        self.mod, self.fn, self.calls = attn_mod, attn_mod.chunked_attention, 0

    def __enter__(self):
        def counted(*a, **k):
            self.calls += 1
            return self.fn(*a, **k)

        self.mod.chunked_attention = counted
        return self

    def __exit__(self, *exc):
        self.mod.chunked_attention = self.fn


def init_on_card(common, cfg, gen) -> tuple:
    """The config's parameters drawn on the card; (params, ms, GB)."""
    params, ms = host_ms(lambda: common.init_params(cfg, gen, "cuda"))
    gb = sum(nbytes(t) for t in params.values()) / 1e9
    return params, ms, gb


def serve_model(arch, params, layers, prompt, gen_tokens, monitor,
                counts_fns, serve_mod, card, chunked=None) -> tuple:
    """One model served through ``generate`` at batch SERVE_BATCH: the
    kernels' launches with every count set to 0 just before and read
    just after, one more (warm) prefill on the same inputs, the greedy
    ids in range and the KV bytes (the patch prefix included); with
    ``chunked`` (a ``ChunkedCalls``), no chunked attention (S < 8192).
    Returns (report, launches, summary)."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer

    reset_counts(*counts_fns)
    ss.plain_calls = ss.fused_plain_calls = ssm_mod.assoc_scans = 0
    if chunked is not None:
        chunked.calls = 0
    r, gen_ms = host_ms(lambda: serve_mod.generate(
        arch, batch=SERVE_BATCH, prompt_len=prompt, gen=gen_tokens,
        seed=SEED, layers=layers, monitor=monitor, monitor_len=MONITOR_LEN,
        params=params))
    counts = read_counts(*counts_fns)
    if chunked is not None and chunked.calls:
        raise AssertionError(f"{arch}: chunked_attention ran at S {prompt} "
                             "(threshold 8192)")
    cfg = r["cfg"]
    inputs = lm_batch(cfg, SEED, 0, SERVE_BATCH, prompt, "cuda")
    ids = inputs.pop("tokens")
    with torch.inference_mode():
        _, warm_ms = host_ms(lambda: transformer.prefill(params, ids, cfg,
                                                         **inputs))
    del inputs
    toks = r["tokens"]
    if tuple(toks.shape) != (SERVE_BATCH, gen_tokens + 1) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.padded_vocab:
        raise AssertionError(f"{arch}: generated ids {tuple(toks.shape)} "
                             "out of range")
    held = prompt + (cfg.n_patches if cfg.family == "vlm" else 0)
    kv = cfg.n_layers * SERVE_BATCH * (held + gen_tokens) * \
        cfg.n_kv_heads * cfg.hd * 2 * torch.finfo(cfg.dtype).bits // 8
    if r["kv_cache_bytes"] != kv or r["cache"]["pos"] != held + gen_tokens:
        raise AssertionError(f"{arch}: KV cache {r['kv_cache_bytes']} bytes"
                             f" at pos {r['cache']['pos']}, expected {kv} at "
                             f"{held + gen_tokens}")
    out = {"params": r["params"], "layers": cfg.n_layers, "prompt": prompt,
           "positions_prefilled": held, "gen": gen_tokens,
           "prefill_ms": r["prefill_ms"], "prefill_warm_ms": warm_ms,
           "decode_s": r["decode_s"], "decode_tok_s": r["decode_tok_s"],
           "generate_ms": gen_ms, "kv_cache_bytes": r["kv_cache_bytes"],
           "cache_bytes": r["cache_bytes"],
           "peak_memory_gib": r["peak_memory_bytes"] / 2**30,
           "peak_memory_gib_by_stage": {
               k: v / 2**30 for k, v in r["peak_memory_by_stage"].items()},
           "launches": counts, "kernel_counts": r["kernel_counts"],
           "scan_counts": r["scan_counts"], "card": card}
    drop = ""
    if "moe_dropped" in r:
        md = r["moe_dropped"]
        out["moe_dropped"] = md
        drop = (f"; pairs dropped: prefill {md['prefill']:.4f}, decode "
                f"steps {min(md['decode']):.4f}-{max(md['decode']):.4f} "
                f"(mean {sum(md['decode']) / len(md['decode']):.4f})")
    log(f"  {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV of {cfg.hd}, "
        f"{r['params']} parameters): prefill {SERVE_BATCH} x {held} "
        f"positions {r['prefill_ms']:.1f} ms (first call), {warm_ms:.1f} ms "
        f"(warm); decode {gen_tokens} x {SERVE_BATCH} in "
        f"{r['decode_s']:.3f} s, {r['decode_tok_s']:.1f} tok/s; KV cache "
        f"{r['kv_cache_bytes'] / 2**20:.1f} MiB (all entries "
        f"{r['cache_bytes'] / 2**20:.1f} MiB); peak memory "
        f"{out['peak_memory_gib']:.2f} GiB ("
        + ", ".join(f"{k} {v:.2f}" for k, v in
                    out["peak_memory_gib_by_stage"].items())
        + f"){drop}; logits finite; launches {json.dumps(counts)} [{card}]")
    return r, counts, out


def extend_cache(transformer, cfg, pcache, max_len, batch) -> dict:
    """A prefill cache copied into ``max_len`` positions, as
    ``launch.serve.generate`` does (K / V left-aligned)."""
    cache = transformer.init_cache(cfg, batch, max_len, "cuda")
    s = pcache["pos"]
    for k, v in pcache.items():
        if k == "pos":
            cache[k] = v
        elif k in ("k", "v"):
            cache[k][:, :, :s].copy_(v)
        else:
            cache[k].copy_(v)
    return cache


def attention_checks(serve_mod, common, transformer, attn_mod, gen) -> dict:
    """(d): f32 at CHECK_LAYERS of full width, prefill(p[:S]) + one decode
    step against prefill(p[:S+1]), for Gemma-2 (softcaps, sandwich
    norms, a local and a global layer), ChatGLM3 (half RoPE, 16 query
    heads a KV head) and Hymba (attention beside the fused B7): the
    logits; the K / V the decode step carried over (positions < S, every
    layer) equal to the short prefill's bit for bit; and the new
    position's K / V in layer 0, whose input (the embedding) is the same
    on both paths.  A later layer's K / V carries the two paths'
    differences through a layer unaveraged (products of another length
    summed in another order, and in Hymba the Mamba block's state), so
    the logits hold the path end to end; then chunked_attention
    against full_attention at Gemma-2's head shapes, S LONG_PROMPT,
    softcap 50, with its window and without one."""
    import dataclasses

    from repro_torch.data.synthetic import lm_batch

    out = {}
    for arch in ATTN_CHECKS:
        c32 = dataclasses.replace(
            serve_mod.build_config(arch, layers=CHECK_LAYERS),
            dtype=torch.float32, param_dtype=torch.float32)
        p32 = common.init_params(c32, gen, "cuda")
        ids = lm_batch(c32, SEED, 1, CHECK_BATCH, CHECK_PROMPT + 1,
                       "cuda")["tokens"]
        with torch.inference_mode():
            _, pcache = transformer.prefill(p32, ids[:, :-1], c32)
            cache = extend_cache(transformer, c32, pcache, CHECK_PROMPT + 1,
                                 CHECK_BATCH)
            step, cache = transformer.decode_step(p32, cache, ids[:, -1:],
                                                  c32)
            s_ = CHECK_PROMPT
            for k in ("k", "v"):
                if not torch.equal(cache[k][:, :, :s_], pcache[k]):
                    raise AssertionError(f"{arch}: the decode step changed "
                                         f"{k} at positions < S")
            del pcache
            longer, lcache = transformer.prefill(p32, ids, c32)
            sync()
            res = {"logits": compare_model(
                step, longer, f"{arch}, {CHECK_LAYERS} layers f32: "
                f"prefill(p[:S]) + one decode step vs prefill(p[:S+1]), "
                "logits"), "carried_bitwise": True}
            for k in ("k", "v"):
                res[f"{k} new layer 0"] = compare_model(
                    cache[k][0, :, s_], lcache[k][0, :, s_],
                    f"{arch}: the same, {k} at position S, layer 0")
        out[arch] = res
        del p32, cache, lcache
        torch.cuda.empty_cache()
    cfg = serve_mod.build_config(ATTN_MAIN)
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    # logits q·k/sqrt(hd) of standard deviation 9: the softcap of 50 bends
    # the largest of them
    q = torch.randn((1, LONG_PROMPT, cfg.n_heads, cfg.hd), generator=g,
                    device="cuda") * 3
    k = torch.randn((1, LONG_PROMPT, cfg.n_kv_heads, cfg.hd), generator=g,
                    device="cuda") * 3
    v = torch.randn((1, LONG_PROMPT, cfg.n_kv_heads, cfg.hd), generator=g,
                    device="cuda")
    for window in CHUNK_WINDOWS:
        with torch.inference_mode():
            full = attn_mod.full_attention(q, k, v, window=window,
                                           cap=cfg.attn_softcap)
            chunk, ms = host_ms(lambda: attn_mod.chunked_attention(
                q, k, v, window=window, cap=cfg.attn_softcap))
        out[f"chunked_vs_full window {window}"] = dict(
            compare_model(chunk, full, f"chunked_attention vs "
                          f"full_attention, S {LONG_PROMPT}, Hq "
                          f"{cfg.n_heads} / Hkv {cfg.n_kv_heads}, hd "
                          f"{cfg.hd}, window {window}, softcap "
                          f"{cfg.attn_softcap}, f32"), chunked_ms=ms)
        del full, chunk
    del q, k, v
    torch.cuda.empty_cache()
    return out


def phase_attention(ops, fs, fk, fp, fl, card) -> dict:
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import common, transformer

    log(f"== phase 14: attention families at full width and depth, batch "
        f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, bf16, weights drawn on the "
        f"card [{card}]")
    t_phase = time.perf_counter()
    counts_fns = (fs, fk, fp, fl)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"models": {}}
    torch.cuda.empty_cache()
    with ChunkedCalls(attn_mod) as chunked:
        # (a) Gemma-2-2B with the monitor: B1 once (the fit), B2 twice
        # (threshold, scores), nothing else
        cfg = serve_mod.build_config(ATTN_MAIN)
        params, init_ms, gb = init_on_card(common, cfg, gen)
        log(f"  (a) {ATTN_MAIN}: {common.param_count(cfg)} parameters "
            f"({gb:.2f} GB) initialised on the card in {init_ms:.0f} ms")
        if common.param_count(cfg) != ATTN_PARAMS[ATTN_MAIN]:
            raise AssertionError(f"{ATTN_MAIN}: parameter count")
        r, counts, summ = serve_model(
            ATTN_MAIN, params, None, SERVE_PROMPT, SERVE_GEN, True,
            counts_fns, serve_mod, card, chunked)
        want = dict({k: 0 for k in counts}, flash_score=1, flash_kde=2)
        if counts != want:
            raise AssertionError(f"{ATTN_MAIN}: launches {counts}, expected "
                                 f"{want}")
        if r["kernel_counts"]["monitor"] != {
                "flash_score": 1, "flash_kde": 2, "selective_scan": 0,
                "mamba_scan": 0} or any(
                v for st in ("prefill", "decode")
                for v in r["kernel_counts"][st].values()):
            raise AssertionError(f"{ATTN_MAIN}: launches by stage "
                                 f"{r['kernel_counts']}")
        mon = r["monitor"]
        summ.update(init_ms=init_ms, param_bytes=gb * 1e9,
                    monitor_ms=mon["ms"],
                    monitor_flags=int(mon["flags"].sum()),
                    monitor_checks=check_monitor(ops, mon))
        log(f"    monitor ({mon['ref_rows']} reference sequences of "
            f"{mon['monitor_len']} tokens) {mon['ms']:.0f} ms, "
            f"{summ['monitor_flags']}/{SERVE_BATCH} flagged")
        del r, mon
        ids = lm_batch(cfg, SEED, 0, SERVE_BATCH, SERVE_PROMPT,
                       "cuda")["tokens"]
        with torch.inference_mode():
            summ["profile"] = {"prefill": device_breakdown(
                lambda: transformer.prefill(params, ids, cfg),
                f"{ATTN_MAIN} prefill {SERVE_BATCH} x {SERVE_PROMPT}, "
                "profiled")}
            _, pcache = transformer.prefill(params, ids, cfg)
            # two positions: device_breakdown steps once warm, once traced
            cache = extend_cache(transformer, cfg, pcache, SERVE_PROMPT + 2,
                                 SERVE_BATCH)
            del pcache
            summ["profile"]["decode_step"] = device_breakdown(
                lambda: transformer.decode_step(params, cache, ids[:, -1:],
                                                cfg),
                f"{ATTN_MAIN} one decode step, batch {SERVE_BATCH}, "
                "profiled")
            del cache
        out["models"][ATTN_MAIN] = summ

        # (c) one LONG_PROMPT-token prompt: chunked attention in every
        # layer, the local layers' window masking
        long_ids = lm_batch(cfg, SEED, 2, 1, LONG_PROMPT, "cuda")["tokens"]
        chunked.calls = 0
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            (logits, lcache), long_ms = host_ms(
                lambda: transformer.prefill(params, long_ids, cfg))
        if chunked.calls != cfg.n_layers:
            raise AssertionError(f"the {LONG_PROMPT}-token prefill ran "
                                 f"chunked_attention {chunked.calls} times, "
                                 f"expected {cfg.n_layers}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits in the long prefill")
        out["long_prefill"] = {
            "prompt": LONG_PROMPT, "ms": long_ms,
            "chunked_calls": chunked.calls,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "kv_bytes": nbytes(lcache["k"], lcache["v"])}
        log(f"  (c) {ATTN_MAIN} prefill of 1 x {LONG_PROMPT} tokens: "
            f"{long_ms:.1f} ms, chunked_attention in all {chunked.calls} "
            f"layers (window {cfg.sliding_window} on the even ones), logits "
            f"finite, KV {out['long_prefill']['kv_bytes'] / 2**20:.1f} MiB, "
            f"peak memory {out['long_prefill']['peak_memory_gib']:.2f} GiB "
            f"[{card}]")
        del params, logits, lcache
        torch.cuda.empty_cache()

        # (b) the other four at full width and depth, ATTN_GEN tokens
        for arch in ATTN_OTHERS:
            cfg = serve_mod.build_config(arch)
            params, init_ms, gb = init_on_card(common, cfg, gen)
            if common.param_count(cfg) != ATTN_PARAMS[arch]:
                raise AssertionError(f"{arch}: parameter count")
            log(f"  (b) {arch}: {gb:.2f} GB initialised on the card in "
                f"{init_ms:.0f} ms")
            r, counts, summ = serve_model(
                arch, params, None, SERVE_PROMPT, ATTN_GEN, False,
                counts_fns, serve_mod, card, chunked)
            fused = cfg.n_layers if cfg.family == "hybrid" else 0
            want = dict({k: 0 for k in counts}, mamba_scan=fused)
            scans = {"prefill": {"selective_scan": 0,
                                 "selective_scan_plain": 0,
                                 "mamba_scan": fused, "mamba_scan_plain": 0,
                                 "assoc_scan": 0}}
            scans["decode"] = dict(scans["prefill"], mamba_scan=0)
            if counts != want or r["scan_counts"] != scans:
                raise AssertionError(
                    f"{arch}: launches {counts}, scan paths "
                    f"{r['scan_counts']}; expected {want}, {scans}")
            summ.update(init_ms=init_ms, param_bytes=gb * 1e9)
            out["models"][arch] = summ
            del r, params
            torch.cuda.empty_cache()

        # B7 at Hymba's layer shape, fused mode, against its plain version
        hcfg = serve_mod.build_config("hymba_1p5b")
        shape = (SERVE_BATCH, SERVE_PROMPT, hcfg.d_inner, hcfg.ssm_state)
        args = fused_scan_inputs(shape, torch.bfloat16, gen)
        check = check_fused_scan(ss, args, f"bf16 (B, S, D, N)={shape}, "
                                 "Hymba's layer")
        ms = graph_ms(lambda: ss.mamba_scan_cuda(*args))
        plain = cuda_ms(lambda: ss.mamba_scan_plain(*args), 3)
        bms, by = scan_bound_ms(shape, torch.bfloat16, fused=True)
        log(f"  mamba_scan bf16 {shape} (Hymba): kernel {ms:.4f} ms, plain "
            f"{plain:.3f} ms, bound {bms:.4f} ms ({by}), "
            f"{bms / ms * 100:.1f}% of bound")
        out["hymba_scan"] = {"shape": shape, "ms": ms, "plain_ms": plain,
                             "bound_ms": bms, "bound_by": by,
                             "max_abs_err": check["max_abs_err"]}
        del args

        # (d) the f32 checks
        log(f"  (d) f32 checks at full width, {CHECK_LAYERS} layers, batch "
            f"{CHECK_BATCH}, prompt {CHECK_PROMPT}:")
        chunked.calls = 0
        out["checks"] = attention_checks(serve_mod, common, transformer,
                                         attn_mod, gen)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 14 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the MoE, VLM and audio families
# ---------------------------------------------------------------------------


class MoECapture:
    """Records each ``models.moe.moe_ffn`` call's input, layer weights and
    output (the layer looks the function up in ``models.transformer`` at
    each call) while installed."""

    def __init__(self, transformer):
        self.mod, self.fn, self.calls = transformer, transformer.moe_ffn, []

    def __enter__(self):
        def captured(x, lp, cfg):
            out = self.fn(x, lp, cfg)
            self.calls.append((x, lp, out[0]))
            return out

        self.mod.moe_ffn = captured
        return self

    def __exit__(self, *exc):
        self.mod.moe_ffn = self.fn


def moe_loop(x, lp, cfg, r, mass: bool = False):
    """An independent MoE layer: each expert's kept (token, choice)
    pairs, from the routing ``r`` the layer made (``models.moe.route``:
    the same choices, weights and drops), through that expert's weights
    upcast to f32 in turn, weighted and added in f32; then the shared
    experts in f32.  Returns (T, d) f32 and, with ``mass``, each
    output's absolute mass: the weighted |h| @ |W_down| of its terms
    (and |s_h| @ |W_shared_down|), the scale of a rounding error in any
    of the sums."""
    from repro_torch.models.layers import _act

    t, d = x.shape
    xf = x.to(torch.float32)
    keep = r.keep.view(t, cfg.top_k)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    tot = torch.zeros_like(out)

    def ffn(rows, up, gate, down):
        u = rows @ up.to(torch.float32)
        h = (_act(rows @ gate.to(torch.float32), cfg.act) * u if cfg.gated
             else _act(u, cfg.act))
        dn = down.to(torch.float32)
        return h @ dn, (h.abs() @ dn.abs() if mass else None)

    for e in range(cfg.n_experts):
        tok, choice = torch.nonzero((r.expert_idx == e) & keep,
                                    as_tuple=True)
        if tok.numel() == 0:
            continue
        y, m = ffn(xf[tok], lp["experts_up"][e],
                   lp["experts_gate"][e] if cfg.gated else None,
                   lp["experts_down"][e])
        w = r.weights[tok, choice][:, None]
        out.index_add_(0, tok, y * w)
        if mass:
            tot.index_add_(0, tok, m * w)
    if cfg.n_shared_experts:
        y, m = ffn(xf, lp["shared_up"], lp.get("shared_gate"),
                   lp["shared_down"])
        out += y
        if mass:
            tot += m
    return (out, tot) if mass else out


def routing_flips(pre, step, whole, batch: int, k: int) -> list:
    """Where two routings of the same tokens choose other experts: ``pre``
    and ``step`` the records (``models.moe.recording``) of a prefill of S
    tokens and one decode step, ``whole`` of a prefill of S + 1, one
    record a layer each.  Each (layer, row, position) whose top-k set
    differs, with ``gap`` = (p_k − p_{k+1}) / p_k of the whole prefill's
    probabilities: how near a tie the choice was."""
    flips = []
    for layer, (a, b, w) in enumerate(zip(pre, step, whole)):
        split = torch.cat([a.expert_idx.view(batch, -1, k),
                           b.expert_idx.view(batch, 1, k)], dim=1)
        full = w.expert_idx.view(batch, -1, k)
        diff = (split.sort(-1).values != full.sort(-1).values).any(-1)
        logits = w.logits.view(batch, full.shape[1], -1)
        for row, pos in diff.nonzero().tolist():
            top = torch.softmax(logits[row, pos], -1).sort(
                descending=True).values
            flips.append({"layer": layer, "row": row, "position": pos,
                          "gap": float((top[k - 1] - top[k]) / top[k - 1])})
    return flips


def check_moe_layers(transformer, moe_mod, params, cfg, ids, bf16: bool,
                     label: str) -> dict:
    """Each MoE layer's output in one prefill of ``ids``, on the hidden
    states it was given, against ``moe_loop`` with the routing it made:
    in bf16 per element within TIER_BAR["bf16"] of the terms' absolute
    mass; in f32 to MODEL_RTOL / MODEL_ATOL."""
    out = {}
    with torch.inference_mode(), MoECapture(transformer) as cap, \
            moe_mod.recording() as rec:
        transformer.prefill(params, ids, cfg)
        for i, ((x, lp, got), r) in enumerate(zip(cap.calls, rec)):
            what = (f"{label}, layer {i}: moe_ffn vs the per-expert f32 "
                    f"loop, {x.shape[0]} tokens, {r.cap} rows an expert, "
                    f"dropped {moe_mod.dropped_share([r]):.4f}")
            if bf16:
                want, mass = moe_loop(x, lp, cfg, r, mass=True)
                res = compare_mass(got, want, mass, TIER_BAR["bf16"], what)
            else:
                res = compare_model(got, moe_loop(x, lp, cfg, r), what)
            out[f"layer {i}"] = dict(res, dropped=moe_mod.dropped_share([r]))
        cap.calls.clear()
    return out


def family_identity(transformer, moe_mod, p32, c32, arch) -> dict:
    """(e): f32, prefill(p[:S]) + one decode step against prefill(p[:S +
    1]) on the same patches / frames: the logits, and the K / V carried
    over (positions before the step) equal to the short prefill's bit
    for bit.  For MoE the routing of both paths is compared token by
    token: a row where a top-k set flips on a near tie (gap at most
    MODEL_RTOL) is reported and left out of the logits comparison, a
    flip with a wider gap fails, and so does a check with every row
    left out.  LLaVA's logits are held to VLM_RTOL (relative and of the
    largest magnitude), the bar that shows the position after the patch
    prefix; the others to MODEL_RTOL / MODEL_ATOL."""
    from repro_torch.data.synthetic import lm_batch

    prompt = AUDIO_PROMPT if c32.family == "audio" else CHECK_PROMPT
    batch = lm_batch(c32, SEED, 1, CHECK_BATCH, prompt + 1, "cuda")
    ids = batch.pop("tokens")
    with torch.inference_mode():
        with moe_mod.recording() as pre:
            _, pcache = transformer.prefill(p32, ids[:, :-1], c32, **batch)
        held = pcache["pos"]
        cache = extend_cache(transformer, c32, pcache, held + 1, CHECK_BATCH)
        with moe_mod.recording() as dec:
            step, cache = transformer.decode_step(p32, cache, ids[:, -1:],
                                                  c32)
        for k in ("k", "v"):
            if not torch.equal(cache[k][:, :, :held], pcache[k]):
                raise AssertionError(f"{arch}: the decode step changed {k} "
                                     "at positions it did not write")
        del pcache, cache
        with moe_mod.recording() as whole:
            longer, _ = transformer.prefill(p32, ids, c32, **batch)
        sync()
    rows = list(range(CHECK_BATCH))
    res = {"positions": held + 1, "carried_bitwise": True}
    if c32.family == "moe":
        if moe_mod.dropped_share(pre + dec + whole):
            raise AssertionError(f"{arch}: pairs dropped at capacity_factor "
                                 f"{c32.capacity_factor}")
        flips = routing_flips(pre, dec, whole, CHECK_BATCH, c32.top_k)
        wide = [f for f in flips if f["gap"] > MODEL_RTOL]
        if wide:
            raise AssertionError(f"{arch}: top-k choices differ between the "
                                 f"two paths beyond a near tie: {wide}")
        rows = sorted(set(rows) - {f["row"] for f in flips})
        if not rows:
            raise AssertionError(f"{arch}: every row flipped on a near tie")
        res["near_tie_flips"] = flips
        log(f"  {arch}: routing of the two paths: {len(flips)} top-k set(s) "
            f"flipped on a near tie (gap <= {MODEL_RTOL:.0e}), rows "
            f"compared {rows}")
    what = (f"{arch}, {c32.n_layers} layers f32: prefill({held} positions) "
            f"+ one decode step vs prefill({held + 1}), logits")
    if c32.family == "vlm":     # the position after the patch prefix
        res["logits"] = compare(step, longer, VLM_RTOL, what,
                                atol_frac=VLM_RTOL)
    else:
        res["logits"] = compare_model(step[rows], longer[rows], what)
    return res


def family_checks(serve_mod, common, transformer, moe_mod, gen) -> dict:
    """(e) the f32 checks at CHECK_LAYERS of full width: LLaVA-NeXT and
    Whisper (CHECK_LAYERS encoder layers too) prefill + decode against a
    longer prefill (for LLaVA the check of the cache position after the
    patch prefix); Granite-MoE the same at capacity_factor = E/k, where
    nothing drops; Granite-MoE at its default capacity factor, each
    layer's MoE output against the per-expert f32 loop."""
    import dataclasses

    from repro_torch.data.synthetic import lm_batch

    out = {}
    for arch in (FAM_VLM, FAM_AUDIO, FAM_MOE):
        c32 = dataclasses.replace(
            serve_mod.build_config(arch, layers=CHECK_LAYERS),
            dtype=torch.float32, param_dtype=torch.float32)
        if c32.family == "audio":
            c32 = dataclasses.replace(c32, n_enc_layers=CHECK_LAYERS)
        p32 = common.init_params(c32, gen, "cuda")
        if c32.family == "moe":
            ident = dataclasses.replace(
                c32, capacity_factor=c32.n_experts / c32.top_k)
            out[f"{arch} identity"] = family_identity(
                transformer, moe_mod, p32, ident, arch)
            ids = lm_batch(c32, SEED, 2, CHECK_BATCH, CHECK_PROMPT,
                           "cuda")["tokens"]
            out[f"{arch} layers"] = check_moe_layers(
                transformer, moe_mod, p32, c32, ids, False,
                f"{arch} f32, capacity factor {c32.capacity_factor}")
        else:
            out[arch] = family_identity(transformer, moe_mod, p32, c32, arch)
        del p32
        torch.cuda.empty_cache()
    return out


def phase_families(ops, fs, fk, fp, fl, card) -> dict:
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import common, transformer
    from repro_torch.models import moe as moe_mod

    log(f"== phase 15: MoE, VLM and audio families, batch {SERVE_BATCH}, "
        f"bf16, weights drawn on the card, one model at a time [{card}]")
    t_phase = time.perf_counter()
    counts_fns = (fs, fk, fp, fl)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"models": {}}
    torch.cuda.empty_cache()
    for arch, want in FAM_PARAMS.items():
        got = common.param_count(serve_mod.build_config(arch))
        if got != want:
            raise AssertionError(f"{arch}: {got} parameters, published "
                                 f"{want}")

    # (a) Granite-3.0-MoE at full width and depth with the monitor: B1
    # once (the fit), B2 twice (threshold, scores), nothing else
    cfg = serve_mod.build_config(FAM_MOE)
    params, init_ms, gb = init_on_card(common, cfg, gen)
    log(f"  (a) {FAM_MOE}: {common.param_count(cfg)} parameters ({gb:.2f} "
        f"GB; {common.active_param_count(cfg)} active a token) initialised "
        f"on the card in {init_ms:.0f} ms")
    r, counts, summ = serve_model(FAM_MOE, params, None, SERVE_PROMPT,
                                   SERVE_GEN, True, counts_fns, serve_mod,
                                   card)
    want = dict({k: 0 for k in counts}, flash_score=1, flash_kde=2)
    if counts != want or r["kernel_counts"]["monitor"] != {
            "flash_score": 1, "flash_kde": 2, "selective_scan": 0,
            "mamba_scan": 0}:
        raise AssertionError(f"{FAM_MOE}: launches {counts}, by stage "
                             f"{r['kernel_counts']}; expected {want}, all "
                             "in the monitor")
    mon = r["monitor"]
    summ.update(init_ms=init_ms, param_bytes=gb * 1e9, monitor_ms=mon["ms"],
                monitor_flags=int(mon["flags"].sum()),
                monitor_checks=check_monitor(ops, mon))
    log(f"    monitor ({mon['ref_rows']} reference sequences of "
        f"{mon['monitor_len']} tokens) {mon['ms']:.0f} ms, "
        f"{summ['monitor_flags']}/{SERVE_BATCH} flagged")
    del r, mon
    ids = lm_batch(cfg, SEED, 0, SERVE_BATCH, SERVE_PROMPT, "cuda")["tokens"]
    with torch.inference_mode():
        summ["profile"] = {"prefill": device_breakdown(
            lambda: transformer.prefill(params, ids, cfg),
            f"{FAM_MOE} prefill {SERVE_BATCH} x {SERVE_PROMPT}, profiled")}
        _, pcache = transformer.prefill(params, ids, cfg)
        cache = extend_cache(transformer, cfg, pcache, SERVE_PROMPT + 2,
                             SERVE_BATCH)
        del pcache
        summ["profile"]["decode_step"] = device_breakdown(
            lambda: transformer.decode_step(params, cache, ids[:, -1:], cfg),
            f"{FAM_MOE} one decode step, batch {SERVE_BATCH}, profiled")
        del cache
    out["models"][FAM_MOE] = summ
    del params
    torch.cuda.empty_cache()

    # (b) Kimi-K2 at full width, KIMI_LAYERS of 61; its MoE layer on the
    # prefill's hidden states against the per-expert f32 loop (bf16 bar)
    cfg = serve_mod.build_config(FAM_KIMI, layers=KIMI_LAYERS)
    params, init_ms, gb = init_on_card(common, cfg, gen)
    log(f"  (b) {FAM_KIMI}: depth cut to {KIMI_LAYERS} of 61, "
        f"{common.param_count(cfg)} parameters ({gb:.2f} GB) initialised on "
        f"the card in {init_ms:.0f} ms")
    r, counts, summ = serve_model(FAM_KIMI, params, KIMI_LAYERS,
                                   SERVE_PROMPT, FAM_GEN, False, counts_fns,
                                   serve_mod, card)
    if any(counts.values()):
        raise AssertionError(f"{FAM_KIMI}: launches {counts}, expected none")
    del r
    ids = lm_batch(cfg, SEED, 0, SERVE_BATCH, SERVE_PROMPT, "cuda")["tokens"]
    summ.update(init_ms=init_ms, param_bytes=gb * 1e9, cut={
        "layers": [KIMI_LAYERS, 61]}, moe_check=check_moe_layers(
            transformer, moe_mod, params, cfg, ids, True,
            f"{FAM_KIMI} bf16 prefill"))
    out["models"][FAM_KIMI] = summ
    del params
    torch.cuda.empty_cache()

    # (c) LLaVA-NeXT at full width, VLM_LAYERS of 60; (d) Whisper full
    for arch, layers, prompt in ((FAM_VLM, VLM_LAYERS, SERVE_PROMPT),
                                 (FAM_AUDIO, None, AUDIO_PROMPT)):
        cfg = serve_mod.build_config(arch, layers=layers)
        params, init_ms, gb = init_on_card(common, cfg, gen)
        cut = "" if layers is None else f"depth cut to {layers} of 60, "
        log(f"  ({'c' if arch == FAM_VLM else 'd'}) {arch}: {cut}"
            f"{common.param_count(cfg)} parameters ({gb:.2f} GB) "
            f"initialised on the card in {init_ms:.0f} ms")
        r, counts, summ = serve_model(arch, params, layers, prompt,
                                       FAM_GEN, False, counts_fns, serve_mod,
                                       card)
        if any(counts.values()):
            raise AssertionError(f"{arch}: launches {counts}, expected none")
        summ.update(init_ms=init_ms, param_bytes=gb * 1e9)
        if layers is not None:
            summ["cut"] = {"layers": [layers, 60]}
        out["models"][arch] = summ
        del r, params
        torch.cuda.empty_cache()

    log(f"  (e) f32 checks at full width, {CHECK_LAYERS} layers, batch "
        f"{CHECK_BATCH}, prompt {CHECK_PROMPT} ({AUDIO_PROMPT} Whisper):")
    out["checks"] = family_checks(serve_mod, common, transformer, moe_mod,
                                  gen)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 15 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: training
# ---------------------------------------------------------------------------


def grad_refusals(ops) -> dict:
    """(a) Each of the eight CUDA wrappers, given card operands of which
    the floating ones require grad, refuses under grad mode (C1: a
    launch has no backward) and runs under no_grad on the same inputs,
    its output finite and of its plain version's shape."""
    from repro_torch.kernels import flash_kde as fk
    from repro_torch.kernels import flash_laplace as fl
    from repro_torch.kernels import flash_pruned as fp
    from repro_torch.kernels import flash_score as fs
    from repro_torch.kernels import selective_scan as ss

    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(256, 4, generator=g, device="cuda")
    y = torch.randn(128, 4, generator=g, device="cuda")
    y_ops, xt_ops, nrm_y, nrm_x = ops._prep_eval(x, y, 128, 128, "f32")
    inv = ops._inv2h2(0.5, x.device)
    kde = (y_ops[0], nrm_y, xt_ops[0], nrm_x, inv)
    xs, xts, xaug, nrm, _ = ops._score_operands(y, "f32")
    score = (xs[0], nrm, xts[0], xaug[0], inv)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    tmap = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    blocks = {"block_m": 128, "block_n": 128}
    bsz, s, d, n = 2, 64, 32, 16
    xi, dt, z = (torch.randn(bsz, s, d, generator=g, device="cuda")
                 for _ in range(3))
    b, c = (torch.randn(bsz, s, n, generator=g, device="cuda")
            for _ in range(2))
    a = -torch.rand(d, n, generator=g, device="cuda") - 0.5
    h0 = torch.zeros(bsz, d, n, device="cuda")
    dt = 0.1 * dt
    fused = (xi, dt, b, c, a, h0, torch.zeros(d, device="cuda"),
             torch.ones(d, device="cuda"), z)
    cases = {
        "flash_score": (fs.flash_score_cuda, fs.flash_score_plain, score,
                        {}),
        "flash_kde": (fk.flash_kde_cuda, fk.flash_kde_plain, kde, {}),
        "flash_score_pruned": (fp.flash_score_pruned_cuda,
                               fp.flash_score_pruned_plain,
                               (one, tmap) + score, blocks),
        "flash_kde_pruned": (fp.flash_kde_pruned_cuda,
                             fp.flash_kde_pruned_plain, (one, tmap) + kde,
                             blocks),
        "flash_laplace": (fl.flash_laplace_cuda, fl.flash_laplace_plain,
                          kde, {}),
        "sq_moment": (fl.sq_moment_cuda, fl.sq_moment_plain, kde, {}),
        "selective_scan": (ss.selective_scan_cuda, ss.selective_scan_plain,
                           (xi, dt, b, c, a, h0), {}),
        "mamba_scan": (ss.mamba_scan_cuda, ss.mamba_scan_plain, fused, {}),
    }
    out = {}
    for name, (cuda, plain, args, kw) in cases.items():
        graded = tuple(t.detach().clone().requires_grad_()
                       if t.is_floating_point() else t for t in args)
        try:
            cuda(*graded, **kw)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            msg = str(e)
        else:
            raise AssertionError(f"{name}_cuda launched on inputs that "
                                 "require grad under grad mode (C1)")
        with torch.no_grad():
            got = cuda(*graded, **kw)
            want = plain(*graded, **({} if "scan" in name else
                                     {"block_n": 128}))
        got = got[0] if isinstance(got, tuple) else got
        want = want[0] if isinstance(want, tuple) else want
        sync()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}_cuda under no_grad: shape "
                                 f"{tuple(got.shape)} (plain "
                                 f"{tuple(want.shape)}) or non-finite")
        out[name] = {"refused": msg.split(":")[0], "no_grad_shape":
                     list(got.shape)}
    log(f"  (a) all eight wrappers refuse a grad-requiring input under "
        f"grad mode and run under no_grad: {', '.join(out)}")
    return out


def train_bars(arch, leaf: str) -> tuple:
    """(rtol, atol fraction) for a train-step metric or state leaf: the
    model bar; the gradient-derived leaves (grad norm, moments) at
    TRAIN_SSM_ATOL for the families with a Mamba block and at
    TRAIN_BF16_BAR for bf16 accumulators (tests/test_torch_train_step.py
    states both)."""
    from_grads = leaf == "grad_norm" or leaf.split("/")[0] in ("mu", "nu",
                                                              "v")
    if from_grads and arch.accum_dtype == "bfloat16":
        return TRAIN_BF16_BAR, TRAIN_BF16_BAR
    if from_grads and arch.model.family in ("ssm", "hybrid"):
        return MODEL_RTOL, TRAIN_SSM_ATOL
    return MODEL_RTOL, MODEL_ATOL


def state_leaves(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(state_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def to_card(tree):
    """A copy of a nest of dicts of tensors on the card."""
    if isinstance(tree, dict):
        return {k: to_card(v) for k, v in tree.items()}
    return tree.to("cuda", copy=True)


def reduced_steps(counts_fns, card) -> dict:
    """(b) Each family's reduced config (f32) takes TRAIN_REDUCED_STEPS
    steps on the card and on the CPU from the same parameters and
    batches, held leaf by leaf; no kernel of B1-B7 may launch."""
    import dataclasses

    from repro_torch.configs import ARCH_IDS, ShapeCfg, get_arch
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_train_step

    shape = ShapeCfg("reduced", "train", TRAIN_REDUCED_SEQ,
                     TRAIN_REDUCED_BATCH, microbatches=2)
    out = {}
    for arch_id in ARCH_IDS:
        arch = get_arch(arch_id)
        arch = dataclasses.replace(
            arch, model=arch.model.reduced(dtype=torch.float32))
        p_cpu, o_cpu = train_mod.init_state(arch, SEED, "cpu")
        p_gpu, o_gpu = to_card(p_cpu), to_card(o_cpu)
        step_cpu = make_train_step(arch, shape, device="cpu")
        step_gpu = make_train_step(arch, shape, device="cuda")
        reset_counts(*counts_fns)
        step_ms, worst = [], 0.0
        for i in range(TRAIN_REDUCED_STEPS):
            batch = train_mod.shaped_batch(arch.model, SEED, i, shape, "cpu")
            p_cpu, o_cpu, m_cpu = step_cpu(p_cpu, o_cpu, batch)
            gb = {k: v.cuda() for k, v in batch.items()}
            (p_gpu, o_gpu, m_gpu), ms = host_ms(
                lambda: step_gpu(p_gpu, o_gpu, gb))
            step_ms.append(ms)
            for k in ("loss", "grad_norm", "lr"):
                rtol, atol = train_bars(arch, k)
                r = close_stats(m_gpu[k].cpu().reshape(1),
                                m_cpu[k].reshape(1), rtol,
                                f"{arch_id} step {i} {k}", atol)
                if r[1] > 0:
                    raise AssertionError(f"{arch_id} step {i} {k}: card "
                                         f"{float(m_gpu[k])} CPU "
                                         f"{float(m_cpu[k])}")
        counts = read_counts(*counts_fns)
        if any(counts.values()):
            raise AssertionError(f"{arch_id} training launched {counts}")
        want = {**{f"params/{k}": v for k, v in p_cpu.items()},
                **state_leaves(o_cpu)}
        got = {**{f"params/{k}": v for k, v in p_gpu.items()},
               **state_leaves(o_gpu)}
        for k, w in want.items():
            if k == "step":
                if int(got[k]) != int(w):
                    raise AssertionError(f"{arch_id}: step {int(got[k])}")
                continue
            rtol, atol = train_bars(arch, k.removeprefix("params/"))
            stats, excess = close_stats(got[k].cpu(), w, rtol, k, atol)
            if excess > 0:
                raise AssertionError(f"{arch_id} {k}: card against CPU "
                                     f"outside the bar ({stats})")
            worst = max(worst, stats["max_abs_err"]
                        / max(float(w.abs().max()), 1e-30))
        out[arch_id] = {"loss": [float(m_gpu["loss"])],
                        "step_ms": step_ms, "launches": counts,
                        "worst_err_over_max": worst}
    log(f"  (b) reduced configs, {TRAIN_REDUCED_STEPS} f32 steps each, "
        f"batch {TRAIN_REDUCED_BATCH} x {TRAIN_REDUCED_SEQ} in 2 "
        f"microbatches, card against CPU leaf by leaf, no B1-B7 launch: "
        + "; ".join(f"{k} {v['step_ms'][-1]:.1f} ms/step (worst "
                    f"{v['worst_err_over_max']:.1e} of max)"
                    for k, v in out.items()) + f" [{card}]")
    return out


def full_width_training(counts_fns, card) -> dict:
    """(c) Gemma-2-2B whole (bf16 weights, AdamW with f32 master, moments
    and accumulator, remat "full", loss_chunk 512), batch TRAIN_BATCH x
    TRAIN_SEQ in TRAIN_MB microbatches: TRAIN_STEPS steps timed, peak
    memory, MFU, one more step profiled; no B1-B7 launch."""
    from repro_torch.analysis import flops
    from repro_torch.configs import ShapeCfg, get_arch
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import common

    arch = get_arch(TRAIN_ARCH)
    cfg = arch.model
    if common.param_count(cfg) != ATTN_PARAMS[TRAIN_ARCH]:
        raise AssertionError(f"{TRAIN_ARCH}: {common.param_count(cfg)} "
                             "parameters")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (params, opt), init_ms = host_ms(
        lambda: train_mod.init_state(arch, SEED, "cuda"))
    state_gib = torch.cuda.memory_allocated() / 2**30
    shape = ShapeCfg("train", "train", TRAIN_SEQ, TRAIN_BATCH,
                     microbatches=TRAIN_MB)
    step = make_train_step(arch, shape, device="cuda")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    reset_counts(*counts_fns)
    step_ms, losses, norms = [], [], []
    for i in range(TRAIN_STEPS):
        batch = train_mod.shaped_batch(cfg, SEED, i, shape, "cuda")
        (params, opt, m), ms = host_ms(lambda: step(params, opt, batch))
        step_ms.append(ms)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    counts = read_counts(*counts_fns)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(counts.values()):
        raise AssertionError(f"{TRAIN_ARCH} training launched {counts}")
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{TRAIN_ARCH}: loss {losses}, grad norm "
                             f"{norms}")
    warm = min(step_ms[1:])
    mfu = flops.model_flops(cfg, tokens, training=True) / (
        warm / 1e3 * BF16_PEAK)
    out = {"params": common.param_count(cfg), "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "microbatches": TRAIN_MB,
           "init_ms": init_ms, "state_gib": state_gib,
           "step_ms": step_ms, "first_step_ms": step_ms[0],
           "warm_step_ms": warm, "tokens_per_s": tokens / warm * 1e3,
           "peak_memory_gib": peak, "mfu_bf16": mfu, "loss": losses,
           "grad_norm": norms, "launches": counts, "card": card}
    log(f"  (c) {TRAIN_ARCH} whole ({out['params']} parameters, state "
        f"{state_gib:.2f} GiB after init), batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} in {TRAIN_MB} microbatches: steps "
        + ", ".join(f"{v:.1f}" for v in step_ms)
        + f" ms (first {step_ms[0]:.1f}, warm {warm:.1f}); "
        f"{out['tokens_per_s']:.0f} tokens/s; peak memory {peak:.2f} GiB; "
        f"MFU {100 * mfu:.2f}% of bf16 {BF16_PEAK / 1e12:.0f} TFLOP/s; "
        f"loss {losses}, grad norm {norms}; launches {json.dumps(counts)}"
        f" [{card}]")
    batch = train_mod.shaped_batch(cfg, SEED, TRAIN_STEPS, shape, "cuda")
    out["profile"] = device_breakdown(
        lambda: step(params, opt, batch),
        f"{TRAIN_ARCH} one warm train step, profiled")
    del params, opt, batch, step
    torch.cuda.empty_cache()
    return out


def f64_check(card) -> dict:
    """(c) f32 at TRAIN_CHECK_LAYERS of full width against the same step
    in float64 on the card: loss, grad norm, the moments and the updated
    parameters.  One step at lr TRAIN_CHECK_LR (warmup 0): an Adam step
    moves a weight by about lr·sign(g), so a gradient element that rounds
    to the other sign moves it by 2·lr, which at this rate stays below
    the bar's atol for every leaf (the embedding's, 2e-5 of ~0.012, is
    the smallest) while the step still moves each weight by ~100 ulps."""
    import dataclasses

    from repro_torch.configs import ShapeCfg, get_arch
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import common
    from repro_torch.optim import AdamWConfig, adamw_init

    arch = get_arch(TRAIN_ARCH)
    c32 = dataclasses.replace(arch.model, n_layers=TRAIN_CHECK_LAYERS,
                              dtype=torch.float32,
                              param_dtype=torch.float32)
    c64 = dataclasses.replace(c32, dtype=torch.float64,
                              param_dtype=torch.float64)
    shape = ShapeCfg("check", "train", TRAIN_CHECK_SEQ, TRAIN_CHECK_BATCH,
                     microbatches=TRAIN_CHECK_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p32 = common.init_params(c32, gen, "cuda")
    batch = train_mod.shaped_batch(c32, SEED, 0, shape, "cuda")
    res = {}
    for label, cfg, acc, mom in (("f64", c64, "float64", torch.float64),
                                 ("f32", c32, "float32", torch.float32)):
        a = dataclasses.replace(arch, model=cfg, accum_dtype=acc)
        p = {k: v.to(cfg.param_dtype, copy=True) for k, v in p32.items()}
        o = adamw_init(p, AdamWConfig(moment_dtype=mom))
        step = make_train_step(a, shape, peak_lr=TRAIN_CHECK_LR, warmup=0,
                               device="cuda")
        p, o, m = step(p, o, batch)
        res[label] = (p, o, m)
        sync()
    (p64, o64, m64), (p32n, o32, m32) = res["f64"], res["f32"]
    out = {}
    for k in ("loss", "grad_norm", "lr"):
        out[k] = compare_model(m32[k].reshape(1), m64[k].reshape(1),
                               f"f32 against f64 {k}")
    worst = {}
    for part, got, want in (("params", p32n, p64), ("mu", o32["mu"],
                                                     o64["mu"]),
                            ("nu", o32["nu"], o64["nu"])):
        for k in want:
            stats, excess = close_stats(got[k], want[k], MODEL_RTOL,
                                        f"{part}/{k}", MODEL_ATOL)
            if excess > 0:
                raise AssertionError(f"f32 against f64 {part}/{k}: outside "
                                     f"the model bar ({stats})")
            worst[f"{part}/{k}"] = stats["max_abs_err"] / max(
                float(want[k].abs().max()), 1e-300)
    moved = max(float((p32n[k] - p32[k]).abs().max()) for k in p32)
    top = max(worst, key=worst.get)
    log(f"  (c) f32 against f64 on the card, {TRAIN_CHECK_LAYERS} layers of "
        f"full width, batch {TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SEQ}, one "
        f"step at lr {TRAIN_CHECK_LR:.0e}: loss, grad norm, lr, every "
        f"parameter, mu and nu within rtol {MODEL_RTOL:.0e} / atol "
        f"{MODEL_ATOL:.0e} of max (worst {top} {worst[top]:.2e} of max); "
        f"largest weight move {moved:.2e} [{card}]")
    out["worst_err_over_max"] = worst
    out["largest_move"] = moved
    del res, p32, p64, o64, p32n, o32
    torch.cuda.empty_cache()
    return out


def hundred_m(card) -> dict:
    """(d) The ~100M Gemma-2-family config of examples/train_lm.py, built
    here from its fields: HUNDRED_M_STEPS steps of HUNDRED_M_BATCH x
    HUNDRED_M_SEQ in 2 microbatches, peak lr 3e-3, warmup 20; the mean of
    the last 10 losses must fall below the first 10's by more than 1.0
    (repro's own assert)."""
    import dataclasses

    from repro_torch.configs import ShapeCfg, get_arch
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import common

    base = get_arch(TRAIN_ARCH)
    cfg = dataclasses.replace(base.model, **HUNDRED_M)
    arch = dataclasses.replace(base, model=cfg)
    params, opt = train_mod.init_state(arch, SEED, "cuda")
    shape = ShapeCfg("100m", "train", HUNDRED_M_SEQ, HUNDRED_M_BATCH,
                     microbatches=2)
    step = make_train_step(arch, shape, peak_lr=3e-3, warmup=20,
                           total_steps=max(HUNDRED_M_STEPS, 100),
                           device="cuda")
    losses = []
    sync()
    t0 = time.perf_counter()
    for i in range(HUNDRED_M_STEPS):
        batch = train_mod.shaped_batch(cfg, SEED, i, shape, "cuda")
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"])
    losses = [float(v) for v in losses]
    sync()
    secs = time.perf_counter() - t0
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    tps = HUNDRED_M_STEPS * HUNDRED_M_BATCH * HUNDRED_M_SEQ / secs
    log(f"  (d) ~100M config ({common.param_count(cfg)} parameters, f32), "
        f"{HUNDRED_M_STEPS} steps of {HUNDRED_M_BATCH} x {HUNDRED_M_SEQ}: "
        f"loss {first:.3f} -> {last:.3f} (first and last 10; ln V = "
        f"{math.log(cfg.vocab_size):.2f}), {secs:.1f} s, {tps:.0f} "
        f"tokens/s [{card}]")
    if not last < first - 1.0:
        raise AssertionError(f"the ~100M config did not converge: {first} "
                             f"-> {last}")
    del params, opt
    torch.cuda.empty_cache()
    return {"params": common.param_count(cfg), "first10": first,
            "last10": last, "losses": losses, "seconds": secs,
            "tokens_per_s": tps}


def kill_and_resume(card, whole_dir: str) -> dict:
    """(e) The launcher's kill and resume as three processes on the card,
    reduced Gemma-2: --inject-failure 7 must exit 42, the same command
    again resumes at step 5, and its step-10 checkpoint equals an
    uninterrupted run's bit for bit.  The uninterrupted run's checkpoints
    stay in ``whole_dir`` (phase 18 holds the world's against them)."""
    import tempfile

    from repro_torch.checkpoint import restore_pytree

    def run(ckpt, *extra):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               TRAIN_ARCH, "--steps", "10", "--ckpt-every", "5",
               "--log-every", "1", "--ckpt-dir", ckpt, *extra]
        r, ms = host_ms(lambda: subprocess.run(
            cmd, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")}))
        return r, ms

    with tempfile.TemporaryDirectory() as tmp:
        a, b = f"{tmp}/a", whole_dir
        killed, ms1 = run(a, "--inject-failure", "7")
        if killed.returncode != 42:
            raise AssertionError(f"--inject-failure 7 exited "
                                 f"{killed.returncode}: {killed.stderr}")
        resumed, ms2 = run(a, "--inject-failure", "7")
        whole, ms3 = run(b)
        for name, r in (("resume", resumed), ("whole", whole)):
            if r.returncode != 0:
                raise AssertionError(f"{name} exited {r.returncode}: "
                                     f"{r.stderr[-2000:]}")
        if "restored checkpoint at step 5" not in resumed.stdout:
            raise AssertionError(f"the rerun did not resume at step 5: "
                                 f"{resumed.stdout}")
        ta = restore_pytree(f"{a}/step_000000010", "cpu")
        tb = restore_pytree(f"{b}/step_000000010", "cpu")
        fa, fb = state_leaves(ta), state_leaves(tb)
        if set(fa) != set(fb) or not all(
                fa[k].dtype == fb[k].dtype and
                fa[k].reshape(-1).view(torch.uint8).equal(
                    fb[k].reshape(-1).view(torch.uint8)) for k in fa):
            raise AssertionError("the resumed run's step-10 checkpoint "
                                 "differs from the uninterrupted run's")
    snaps = [(float(mo.group(1)), int(mo.group(2))) for mo in re.finditer(
        r"host snapshot ([0-9.]+) ms, (\d+) bytes", whole.stdout)]
    log(f"  (e) launcher on the card: --inject-failure 7 exited 42 "
        f"({ms1 / 1e3:.1f} s), the rerun resumed at step 5 ({ms2 / 1e3:.1f}"
        f" s), an uninterrupted run ({ms3 / 1e3:.1f} s): step-10 "
        f"checkpoints equal bit for bit ({len(fa)} leaves); host snapshots "
        + ", ".join(f"{m:.2f} ms / {n} bytes" for m, n in snaps)
        + f" [{card}]")
    return {"process_s": [ms1 / 1e3, ms2 / 1e3, ms3 / 1e3],
            "snapshots": [{"ms": m, "bytes": n} for m, n in snaps],
            "leaves": len(fa)}


def phase_training(ops, fs, fk, fp, fl, card, whole_dir: str) -> dict:
    log(f"== phase 16: training [{card}]")
    t_phase = time.perf_counter()
    counts_fns = (fs, fk, fp, fl)
    torch.cuda.empty_cache()
    out = {"refusals": grad_refusals(ops)}
    out["reduced"] = reduced_steps(counts_fns, card)
    out["full"] = full_width_training(counts_fns, card)
    out["f64_check"] = f64_check(card)
    out["hundred_m"] = hundred_m(card)
    out["kill_resume"] = kill_and_resume(card, whole_dir)
    out["launches"] = out["full"]["launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 16 took {out['phase_s']:.1f} s")
    return out


# phase 17: the dry run.  (a) in a child process (a fake world must not
# meet this one's process group), beside (b) and (c), with DRYRUN_TIMEOUT,
# the cells below on fake worlds of 256 / 512 ranks, DRYRUN_JOBS cells at
# a time (the main process keeps two of the 8 cores); (b) a
# one-rank NCCL world, mesh (1, 1) over (data, model): Gemma-2-2B's train
# step (phase 16's shape) through build_cell against the mesh-less step
# from the same seeded state, and Granite-MoE's decode step through the
# stationary path against the mesh-less one; (c) the flash_sdkde_32k cell
# (make_kde_step) on that mesh against SDKDE(backend="flash", prune="off")
DRYRUN_CELLS = ("flash_sdkde_32k,flash_sdkde_1m,gemma2_2b/train_4k,"
                "gemma2_2b/prefill_32k,gemma2_2b/decode_32k,"
                "gemma2_2b/long_500k,granite_moe_3b_a800m/train_4k,"
                "granite_moe_3b_a800m/decode_32k,kimi_k2_1t_a32b/decode_32k,"
                "falcon_mamba_7b/long_500k,kimi_k2_1t_a32b/train_4k@multi")
DRYRUN_JOBS, DRYRUN_TIMEOUT = 6, 400
KDE_CELL_H = 0.725
DECODE_CHECK_PROMPT = 1024


def start_dryrun(tmp: str):
    """(a) ``python -m repro_torch.launch.dryrun`` on DRYRUN_CELLS in a
    child process, started now and read by ``dryrun_cells``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
         "single", "--cells", DRYRUN_CELLS, "--jobs", str(DRYRUN_JOBS),
         "--out", tmp], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def dryrun_cells(child, tmp: str, t0: float, card) -> dict:
    """(a) the child's records: every cell ``ok`` or a listed skip."""
    try:
        stdout, stderr = child.communicate(
            timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    wall = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"the dry run failed (rc {child.returncode}):"
                             "\n" + stdout[-4000:] + stderr[-4000:])
    records = []
    for m in ("single", "multi"):
        records += json.loads((Path(tmp) / f"dryrun_{m}.json").read_text())
    done = [ln for ln in stdout.splitlines() if ln.startswith("DONE")]
    for r in records:
        if r["status"] == "skip":
            log(f"  (a) {r['arch']}/{r['shape']} @ {r['mesh']}: skip "
                f"({r['reason']})")
            continue
        if r["status"] != "ok":
            raise AssertionError(f"dry run {r}")
        log(f"  (a) {r['arch']}/{r['shape']} @ {r['mesh']}: peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB a rank (fits 80 GB: "
            f"{r['fits']}), {r['hlo_flops']:.3e} FLOPs and "
            f"{r['collective_bytes']:.3e} collective bytes a rank; terms "
            f"{r['t_compute_s'] * 1e3:.2f} / {r['t_memory_s'] * 1e3:.2f} / "
            f"{r['t_collective_s'] * 1e3:.2f} ms (data-sheet model), bound "
            f"{r['bound']}, useful {r['useful_ratio']:.3f}, "
            f"{r['compile_s']:.1f} s")
    launches = {}
    for r in records:
        for k, n in r.get("kernel_launches", {}).items():
            launches[k] = launches.get(k, 0) + n
    log(f"  (a) {done[-1] if done else '?'}; {wall:.1f} s wall beside (b) "
        f"and (c), {DRYRUN_JOBS} jobs (this machine's CPU); kernel "
        f"launches over the cells {launches} [{card}]")
    return {"records": records, "wall_s": wall, "done": done[-1],
            "launches": launches}


def _wrap_tree(tree, abstract, mesh):
    """``tree``'s tensors as DTensors over the (1, 1) mesh, sharing their
    storage (on one rank every shard is the whole tensor)."""
    from repro_torch.models.parallel import Abstract, from_local

    if isinstance(abstract, Abstract):
        return from_local(tree, mesh, abstract.spec, abstract.shape)
    if isinstance(abstract, dict):
        return {k: _wrap_tree(tree[k], abstract[k], mesh) for k in tree}
    return tree


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def mesh_train_check(mesh, card) -> dict:
    """(b) Gemma-2-2B whole, phase 16's batch: the mesh-less step's
    results copied to the host, the state drawn again from the seed, the
    cell's step (build_cell) on it; every leaf held at the model bar."""
    import dataclasses

    from repro_torch.configs import ShapeCfg, get_arch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod

    arch = dataclasses.replace(get_arch(TRAIN_ARCH), train_microbatches=None)
    shape = ShapeCfg("train", "train", TRAIN_SEQ, TRAIN_BATCH,
                     microbatches=TRAIN_MB)
    torch.cuda.empty_cache()
    batch = train_mod.shaped_batch(arch.model, SEED, 0, shape, "cuda")
    params, opt = train_mod.init_state(arch, SEED, "cuda")
    plain = steps_mod.make_train_step(arch, shape, device="cuda")
    (params, opt, m0), plain_ms = host_ms(lambda: plain(params, opt, batch))
    want = {"loss": m0["loss"].cpu(), "grad_norm": m0["grad_norm"].cpu()}
    want.update({f"params/{k}": v.cpu() for k, v in params.items()})
    want.update({k: v.cpu() for k, v in state_leaves(opt).items()})
    del params, opt, m0
    torch.cuda.empty_cache()
    params, opt = train_mod.init_state(arch, SEED, "cuda")
    fn, abstract, _ = steps_mod.build_cell(arch, shape, mesh)
    args = (_wrap_tree(params, abstract[0], mesh),
            _wrap_tree(opt, abstract[1], mesh),
            _wrap_tree(batch, abstract[2], mesh))
    del params, opt
    (p1, o1, m1), mesh_ms = host_ms(lambda: fn(*args))
    got = {"loss": _local(m1["loss"]), "grad_norm": _local(m1["grad_norm"])}
    got.update({f"params/{k}": _local(v) for k, v in p1.items()})
    got.update({k: _local(v) for k, v in state_leaves(o1).items()})
    worst, bitwise = 0.0, True
    for k, w in want.items():
        g = got[k]
        bitwise &= bool(torch.equal(g.cpu(), w))
        if k.endswith("step"):
            continue
        w = w.to("cuda", torch.float64)
        g = g.to(torch.float64)
        err = float((g - w).abs().max())
        bar = 2e-4 * w.abs() + 2e-5 * float(w.abs().max())
        if bool((g - w).abs().gt(bar).any()):
            raise AssertionError(f"mesh train step {k}: max |err| {err:.3e}"
                                 " outside the model bar")
        worst = max(worst, err / max(float(w.abs().max()), 1e-30))
        del w, g
    out = {"plain_ms": plain_ms, "mesh_ms": mesh_ms,
           "loss": float(want["loss"]), "grad_norm": float(want["grad_norm"]),
           "worst_rel_to_leaf_max": worst, "bitwise_equal": bitwise,
           "leaves": len(want)}
    log(f"  (b) {TRAIN_ARCH} train step {TRAIN_BATCH} x {TRAIN_SEQ} in "
        f"{TRAIN_MB} microbatches on the (1, 1) mesh: {len(want)} leaves "
        f"within the model bar (worst |err| {worst:.2e} of the leaf's max), "
        f"bit for bit: {bitwise}; host ms: mesh-less {plain_ms:.1f}, "
        f"DTensor {mesh_ms:.1f} (first call) [{card}]")
    del p1, o1, m1, args, got, want
    torch.cuda.empty_cache()
    return out


def mesh_decode_check(mesh, card) -> dict:
    """(b) Granite-MoE whole: a mesh-less prefill of SERVE_BATCH x
    DECODE_CHECK_PROMPT, then one decode step mesh-less and one through
    the cell's step (the stationary MoE path) on copies of the cache."""
    from repro_torch.configs import ShapeCfg, get_arch
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import common, transformer

    arch = get_arch(FAM_MOE)
    cfg = arch.model
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = common.init_params(cfg, gen, "cuda")
    b = lm_batch(cfg, SEED, 0, SERVE_BATCH, DECODE_CHECK_PROMPT, "cuda")
    with torch.inference_mode():
        _, pre = transformer.prefill(params, b["tokens"], cfg)
    seq = DECODE_CHECK_PROMPT + 1
    cache = transformer.init_cache(cfg, SERVE_BATCH, seq, "cuda")
    for k in cache:
        if k != "pos":
            cache[k][:, :, :DECODE_CHECK_PROMPT] = pre[k]
    cache["pos"] = DECODE_CHECK_PROMPT
    tokens = b["tokens"][:, -1:]
    c0 = {k: (v.clone() if torch.is_tensor(v) else v)
          for k, v in cache.items()}
    with torch.no_grad():
        transformer.decode_step(params, c0, tokens, cfg)
        c0["pos"] = DECODE_CHECK_PROMPT
        (want, c0), plain_ms = host_ms(
            lambda: transformer.decode_step(params, c0, tokens, cfg))
    shape = ShapeCfg("d", "decode", seq, SERVE_BATCH)
    fn, abstract, _ = steps_mod.build_cell(arch, shape, mesh)
    c1 = {k: (v.clone() if torch.is_tensor(v) else v)
          for k, v in cache.items()}
    args = (_wrap_tree(params, abstract[0], mesh),
            _wrap_tree(c1, abstract[1], mesh),
            _wrap_tree(tokens, abstract[2], mesh))
    fn(*args)
    args[1]["pos"] = DECODE_CHECK_PROMPT
    (got, c1w), mesh_ms = host_ms(lambda: fn(*args))
    got = _local(got)
    err = float((got.double() - want.double()).abs().max())
    bar = 2e-4 * want.double().abs() + 2e-5 * float(want.abs().max())
    if bool((got.double() - want.double()).abs().gt(bar).any()):
        raise AssertionError(f"{FAM_MOE} mesh decode logits: max |err| "
                             f"{err:.3e} outside the model bar")
    for k in ("k", "v"):
        if not torch.equal(_local(c1w[k]), c0[k]):
            raise AssertionError(f"{FAM_MOE} mesh decode cache {k} differs")
    out = {"plain_ms": plain_ms, "mesh_ms": mesh_ms, "max_abs_err": err,
           "bitwise_equal": bool(torch.equal(got, want))}
    log(f"  (b) {FAM_MOE} decode step (stationary MoE path) at batch "
        f"{SERVE_BATCH}, cache {seq}: logits max |err| {err:.3e} within the "
        f"model bar, bit for bit: {out['bitwise_equal']}; warm host ms: "
        f"mesh-less {plain_ms:.2f}, DTensor {mesh_ms:.2f} [{card}]")
    del params, cache, c0, c1, args, pre
    torch.cuda.empty_cache()
    return out


def mesh_kde_check(mesh, counts_fns, card) -> dict:
    """(c) make_kde_step for flash_sdkde_32k on the (1, 1) mesh: B1 once
    and B2 once, held against SDKDE(backend="flash", prune="off")."""
    from repro_torch.configs import KDE_WORKLOADS
    from repro_torch.core import estimator as est_mod
    from repro_torch.core import mixtures
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.parallel import shard_from_full

    wl = KDE_WORKLOADS["flash_sdkde_32k"]
    mix = mixtures.benchmark_mixture_16d()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = mix.sample(wl.n_train, gen)
    y = mix.sample(wl.n_test, gen)
    fn, (ax, ay), _ = steps_mod.make_kde_step(wl, mesh, h=KDE_CELL_H)
    xd = shard_from_full(x, mesh, ax.spec)
    yd = shard_from_full(y, mesh, ay.spec)
    fn(xd, yd)
    reset_counts(*counts_fns)
    dens, ms = host_ms(lambda: fn(xd, yd))
    counts = read_counts(*counts_fns)
    want_counts = dict({k: 0 for k in counts}, flash_score=1, flash_kde=1)
    if counts != want_counts:
        raise AssertionError(f"KDE cell launched {counts}")
    ref = est_mod.SDKDE(KDE_CELL_H, est_mod.EstimatorConfig(
        backend="flash", prune="off")).fit(x).evaluate(y)
    bar = f32_bar(torch.cat([x, y]), 1 / (2 * KDE_CELL_H ** 2))
    got = _local(dens)
    stats = compare(got, ref, bar, "KDE cell vs SDKDE flash")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn(xd, yd)
    e1.record()
    torch.cuda.synchronize()
    out = {"launches": counts, "host_ms": ms, "device_ms":
           e0.elapsed_time(e1), "bar": bar, **stats}
    log(f"  (c) flash_sdkde_32k cell ({wl.n_train} x {wl.n_test} x "
        f"{wl.dim}, h {KDE_CELL_H}) on the (1, 1) mesh: launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}; vs SDKDE "
        f"flash {json.dumps(stats)}; {ms:.2f} ms host, "
        f"{out['device_ms']:.2f} ms between events [{card}]")
    return out


def phase_dryrun(fs, fk, fp, fl, card) -> dict:
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import world
    from repro_torch.models import parallel

    log(f"== phase 17: the dry run [{card}]")
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        child = start_dryrun(tmp)
        try:
            world.init(0, 1, os.path.join(tmp, "store"), backend="nccl")
            try:
                mesh = init_device_mesh("cuda", (1, 1),
                                        mesh_dim_names=("data", "model"))
                out["train"] = mesh_train_check(mesh, card)
                out["decode"] = mesh_decode_check(mesh, card)
                out["kde"] = mesh_kde_check(mesh, (fs, fk, fp, fl), card)
            finally:
                parallel.set_mesh(None)
                dist.destroy_process_group()
        finally:
            out["dryrun"] = dryrun_cells(child, tmp, t_phase, card)
    out["launches"] = out["kde"]["launches"]
    out["fake_world_launches"] = out["dryrun"]["launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 17 took {out['phase_s']:.1f} s")
    return out


# phase 18: training over a mesh.  (a) reduced Gemma-2 through the
# launcher in a one-rank NCCL world started by torchrun: --inject-failure
# MESH_FAIL exits 42, the same command resumes at the last save, and its
# step-MESH_STEPS checkpoint (per-rank shards) equals an uninterrupted
# world run's and the one-device launcher's (phase 16e's uninterrupted
# run) bit for bit, f32 (on a mesh of one device the model's hints are
# the identity: tests/test_torch_train_one_rank.py); (b) that checkpoint
# restored with no mesh on the card, the one-device checkpoint restored
# onto the (1, 1) mesh, and one counted train step on each; (c)
# Gemma-2-2B whole through both launchers, each its own process, phase
# 16c's shape, MESH_FULL_STEPS steps.  Each launcher run that reaches
# its end prints its own kernel counts ("kernel launches: {...}", zeroed
# before its loop).  NCCL refuses two ranks on one card and DTensor over gloo
# wants a CPU mesh, so the elastic restart across worlds of several ranks
# stays a CPU test (tests/test_torch_elastic.py,
# tests/test_torch_train_mesh.py).
MESH_STEPS, MESH_EVERY, MESH_FAIL = 10, 5, 7
MESH_FULL_STEPS = 5
LAUNCH_TIMEOUT = 600
STEP_LINE = re.compile(r"step\s+(\d+) loss (\S+) gnorm \S+ lr \S+ "
                       r"\(([0-9.]+) ms/step\)")
SNAPSHOT_LINE = re.compile(r"checkpoint step (\d+): host snapshot ([0-9.]+) "
                           r"ms, (\d+) bytes")
RESTORE_LINE = re.compile(r"restored checkpoint at step (\d+) \(([0-9.]+) "
                          r"ms\)")
LAUNCH_LINE = re.compile(r"^kernel launches: (\{.*\})$", re.M)


def launcher_args(*args) -> list:
    return ["-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH,
            "--log-every", "1", *args]


def run_launcher(world: bool, args: list):
    """The launcher as its own process: in a one-rank NCCL world started
    by torchrun (``world``), or on one device.  (result, host ms)."""
    cmd = [sys.executable]
    if world:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "1"]
    cmd += args
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return host_ms(lambda: subprocess.run(
        cmd, capture_output=True, text=True, timeout=LAUNCH_TIMEOUT,
        env=env, cwd=ROOT))


def launcher_ok(r, what: str) -> None:
    if r.returncode != 0:
        raise AssertionError(f"{what} exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")


def launcher_launches(r, what: str) -> dict:
    """The kernel counts a launcher run printed after its loop."""
    m = LAUNCH_LINE.search(r.stdout)
    if m is None:
        raise AssertionError(f"{what} printed no kernel counts:\n"
                             f"{r.stdout[-2000:]}")
    return json.loads(m.group(1))


def leaves_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and not leaves_differing(a, b)


def leaves_differing(a: dict, b: dict) -> list:
    """(leaf, max |a - b|) of each leaf of both trees whose bits differ."""
    out = []
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            out.append((k, float("nan")))
        elif not x.reshape(-1).view(torch.uint8).equal(
                y.reshape(-1).view(torch.uint8)):
            out.append((k, float((x.double() - y.double()).abs().max())))
    return out


def model_bar_worst(got: dict, want: dict, what: str) -> float:
    """The largest |got - want| over a leaf's largest magnitude; raises
    where an element lies outside the model bar (rtol 2e-4, atol 2e-5 of
    the leaf's largest magnitude)."""
    worst = 0.0
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        scale = float(w.abs().max()) if w.numel() else 0.0
        if bool((g - w).abs().gt(2e-4 * w.abs() + 2e-5 * scale).any()):
            raise AssertionError(f"{what}: {k} outside the model bar")
        if w.numel():
            worst = max(worst, float((g - w).abs().max()) / max(scale, 1e-30))
    return worst


def world_resume(whole_dir: str, tmp: str, card) -> dict:
    """(a) the killed world run beside an uninterrupted one, then the
    resumed run: its step-MESH_STEPS checkpoint equal to the
    uninterrupted world run's and the one-device launcher's (phase
    16e's) bit for bit."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.checkpoint import restore_pytree

    ckpt, whole_world = f"{tmp}/world", f"{tmp}/world_whole"
    common = launcher_args("--steps", str(MESH_STEPS), "--ckpt-every",
                           str(MESH_EVERY))
    args = common + ["--ckpt-dir", ckpt, "--inject-failure", str(MESH_FAIL)]
    with ThreadPoolExecutor(max_workers=2) as pool:
        other = pool.submit(run_launcher, True,
                            common + ["--ckpt-dir", whole_world])
        killed, ms1 = run_launcher(True, args)
        whole, ms0 = other.result()
    launcher_ok(whole, "the uninterrupted world run")
    if (killed.returncode == 0 or f"injected failure at step {MESH_FAIL}"
            not in killed.stdout
            or not re.search(r"exitcode\s*:\s*42\b", killed.stderr)):
        raise AssertionError(f"--inject-failure {MESH_FAIL} under torchrun "
                             f"exited {killed.returncode}, not 42:\n"
                             f"{killed.stdout[-2000:]}\n"
                             f"{killed.stderr[-4000:]}")
    resumed, ms2 = run_launcher(True, args)
    launcher_ok(resumed, "the resumed world run")
    for want in ("world=1 device=cuda", "mesh: (1, 1) ('data', 'model')"):
        if want not in resumed.stdout:
            raise AssertionError(f"the world run did not print {want!r}:\n"
                                 f"{resumed.stdout[-2000:]}")
    restored = RESTORE_LINE.search(resumed.stdout)
    if restored is None or int(restored.group(1)) != MESH_EVERY:
        raise AssertionError(f"the rerun did not resume at step "
                             f"{MESH_EVERY}: {resumed.stdout[-2000:]}")
    step_dir = f"step_{MESH_STEPS:09d}"
    manifest = json.loads((Path(ckpt) / step_dir / "manifest.json")
                          .read_text())
    sharded = sum(bool(m.get("sharded")) for m in manifest.values())
    if not sharded:
        raise AssertionError("the world run's checkpoint holds no sharded "
                             "entry")
    tw = state_leaves(restore_pytree(f"{ckpt}/{step_dir}", "cpu"))
    tu = state_leaves(restore_pytree(f"{whole_world}/{step_dir}", "cpu"))
    to = state_leaves(restore_pytree(f"{whole_dir}/{step_dir}", "cpu"))
    if not leaves_equal(tw, tu):
        raise AssertionError(f"the resumed world run's step-{MESH_STEPS} "
                             "checkpoint differs from the uninterrupted "
                             f"one's: {leaves_differing(tw, tu)[:12]}")
    if not leaves_equal(tw, to):
        raise AssertionError(f"the world run's step-{MESH_STEPS} checkpoint "
                             "differs from the one-device launcher's: "
                             f"{leaves_differing(tw, to)[:12]} of "
                             f"{len(tw)} leaves")
    snaps = [{"step": int(m.group(1)), "ms": float(m.group(2)),
              "bytes": int(m.group(3))}
             for r in (killed, resumed)
             for m in SNAPSHOT_LINE.finditer(r.stdout)]
    out = {"process_s": [ms1 / 1e3, ms2 / 1e3, ms0 / 1e3],
           "snapshots": snaps, "restore_ms": float(restored.group(2)),
           "leaves": len(tw), "sharded_entries": sharded,
           "entries": len(manifest), "checkpoint": f"{ckpt}/{step_dir}",
           "launches": {"uninterrupted": launcher_launches(
                            whole, "the uninterrupted world run"),
                        "resumed": launcher_launches(
                            resumed, "the resumed world run")}}
    log(f"  (a) torchrun, one NCCL rank, mesh (1, 1), reduced {TRAIN_ARCH} "
        f"(f32): --inject-failure {MESH_FAIL} exited 42 ({ms1 / 1e3:.1f} s, "
        f"beside an uninterrupted world run, {ms0 / 1e3:.1f} s), the rerun "
        f"restored step {MESH_EVERY} in {out['restore_ms']:.1f} ms and ran "
        f"on ({ms2 / 1e3:.1f} s); its step-{MESH_STEPS} checkpoint "
        f"({sharded} of {len(manifest)} entries sharded) equals the "
        f"uninterrupted world run's and the one-device launcher's bit for "
        f"bit ({len(tw)} leaves); the launcher's kernel counts "
        f"{json.dumps(out['launches'])}; host snapshots " + ", ".join(f"step {s['step']}: {s['ms']:.2f} ms "
                                      f"/ {s['bytes']} bytes" for s in snaps)
        + f" [{card}]")
    return out


def mesh_restores(world_ckpt: str, whole_dir: str, tmp: str, counts_fns,
                  card) -> dict:
    """(b) the world's checkpoint restored whole on the card and the
    one-device checkpoint restored onto the (1, 1) mesh of a one-rank
    NCCL world in this process, each equal to its source bit for bit;
    then one train step from each (counted) held at the model bar."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.checkpoint import restore_pytree
    from repro_torch.configs import ShapeCfg, get_arch
    from repro_torch.distributed import world
    from repro_torch.distributed.elastic import make_mesh, plan_mesh
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import common, parallel

    arch = get_arch(TRAIN_ARCH)
    arch = dataclasses.replace(arch, model=arch.model.reduced(
        dtype=torch.float32))
    cfg = arch.model
    shape = ShapeCfg("train", "train", 128, 8, microbatches=2)
    whole_step = f"{whole_dir}/step_{MESH_STEPS:09d}"
    src_world = state_leaves(restore_pytree(world_ckpt, "cpu"))
    src_whole = state_leaves(restore_pytree(whole_step, "cpu"))
    got, ms_whole = host_ms(lambda: restore_pytree(world_ckpt, "cuda"))
    if not leaves_equal({k: v.cpu() for k, v in state_leaves(got).items()},
                        src_world):
        raise AssertionError("the world checkpoint restored whole differs")
    world.init(0, 1, os.path.join(tmp, "store"), backend="nccl")
    try:
        mesh = make_mesh(plan_mesh(1, model_parallel=1))
        layout = {"params": common.abstract_params(cfg, mesh),
                  "opt": steps_mod.abstract_opt_state(arch, mesh)}
        # the first restore onto a mesh pays the process's first DTensor
        # construction; the second is timed warm
        host_ms(lambda: restore_pytree(whole_step, "cuda", layout=layout,
                                       mesh=mesh))
        on_mesh, ms_mesh = host_ms(lambda: restore_pytree(
            whole_step, "cuda", layout=layout, mesh=mesh))
        local = {k: _local(v).cpu() for k, v in
                 state_leaves(on_mesh).items()}
        if not leaves_equal(local, src_whole) or not all(
                parallel.is_dtensor(v)
                for v in state_leaves(on_mesh).values()):
            raise AssertionError("the one-device checkpoint restored onto "
                                 "the (1, 1) mesh differs")
        batch = train_mod.shaped_batch(cfg, SEED, MESH_STEPS, shape, "cpu")
        plain = restore_pytree(whole_step, "cuda")
        p0, _, m0 = steps_mod.make_train_step(arch, shape, device="cuda")(
            plain["params"], plain["opt"],
            {k: v.cuda() for k, v in batch.items()})
        parallel.set_mesh(mesh)
        step = steps_mod.make_train_step(arch, shape, mesh=mesh)
        reset_counts(*counts_fns)
        p1, _, m1 = step(on_mesh["params"], on_mesh["opt"],
                         steps_mod.shard_train_batch(cfg, batch, mesh, shape,
                                                     "cuda"))
        torch.cuda.synchronize()
        counts = read_counts(*counts_fns)
        got = {k: _local(v) for k, v in p1.items()}
        got["loss"] = _local(m1["loss"])
        want = {**p0, "loss": m0["loss"]}
        worst = model_bar_worst(got, want, "mesh step from the restored "
                                "state")
        bitwise = leaves_equal({k: v.cpu() for k, v in got.items()},
                               {k: v.cpu() for k, v in want.items()})
    finally:
        parallel.set_mesh(None)
        dist.destroy_process_group()
    if any(counts.values()):
        raise AssertionError(f"the mesh train step launched {counts}")
    out = {"restore_whole_ms": ms_whole, "restore_mesh_ms": ms_mesh,
           "launches": counts, "step_worst_rel": worst,
           "step_bitwise": bitwise}
    log(f"  (b) the world checkpoint restored whole on the card "
        f"({ms_whole:.1f} ms) and the one-device one onto the (1, 1) mesh "
        f"({ms_mesh:.1f} ms warm), each equal to its source bit for bit; one "
        f"train step from each within the model bar (worst "
        f"{worst:.2e} of a leaf's max; bit for bit: {bitwise}), the mesh "
        f"step's launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})} [{card}]")
    return out


def full_width_launchers(card) -> dict:
    """(c) Gemma-2-2B whole, TRAIN_BATCH x TRAIN_SEQ in TRAIN_MB
    microbatches, MESH_FULL_STEPS steps, no checkpoint: the world
    launcher and the one-device launcher, one process each; their losses
    equal.  "Warm" is every step after the first, and their median."""
    args = launcher_args("--full", "--steps", str(MESH_FULL_STEPS),
                         "--global-batch", str(TRAIN_BATCH), "--seq",
                         str(TRAIN_SEQ), "--microbatches", str(TRAIN_MB))
    out = {}
    for name, in_world in (("world", True), ("one_device", False)):
        torch.cuda.empty_cache()
        r, ms = run_launcher(in_world, args)
        launcher_ok(r, f"the full-width {name} launcher")
        steps = [(int(m.group(1)), m.group(2), float(m.group(3)))
                 for m in STEP_LINE.finditer(r.stdout)]
        if [s for s, _, _ in steps] != list(range(MESH_FULL_STEPS)):
            raise AssertionError(f"{name}: steps {steps}")
        if f"params={ATTN_PARAMS[TRAIN_ARCH] / 1e6:.2f}M" not in r.stdout:
            raise AssertionError(f"{name}: not the whole model:\n"
                                 f"{r.stdout[:500]}")
        step_ms = [v for _, _, v in steps]
        out[name] = {"process_s": ms / 1e3, "loss": [v for _, v, _ in steps],
                     "step_ms": step_ms, "first_step_ms": step_ms[0],
                     "warm_step_ms": step_ms[1:],
                     "warm_median_ms": statistics.median(step_ms[1:]),
                     "launches": launcher_launches(
                         r, f"the full-width {name} launcher")}
    if out["world"]["loss"] != out["one_device"]["loss"]:
        raise AssertionError(f"full-width losses differ: world "
                             f"{out['world']['loss']}, one device "
                             f"{out['one_device']['loss']}")
    if not all(math.isfinite(float(v)) for v in out["world"]["loss"]):
        raise AssertionError(f"non-finite loss {out['world']['loss']}")
    w, o = out["world"], out["one_device"]
    ratios = [a / b for a in w["warm_step_ms"] for b in o["warm_step_ms"]]
    out["warm_ratio_range"] = [min(ratios), max(ratios)]
    log(f"  (c) {TRAIN_ARCH} whole ({ATTN_PARAMS[TRAIN_ARCH]} parameters), "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MB} microbatches, "
        f"{MESH_FULL_STEPS} steps: losses equal ({', '.join(w['loss'])}); "
        f"step ms, launcher in a one-rank NCCL world "
        + ", ".join(f"{v:.1f}" for v in w["step_ms"])
        + f" (first {w['first_step_ms']:.1f}, warm median "
        f"{w['warm_median_ms']:.1f}); one-device launcher "
        + ", ".join(f"{v:.1f}" for v in o["step_ms"])
        + f" (first {o['first_step_ms']:.1f}, warm median "
        f"{o['warm_median_ms']:.1f}); a world warm step over a one-device "
        f"one {min(ratios):.2f}-{max(ratios):.2f}x; kernel counts, world "
        f"{json.dumps(w['launches'])}, one device "
        f"{json.dumps(o['launches'])}; processes {w['process_s']:.1f} / "
        f"{o['process_s']:.1f} s [{card}]")
    return out


def phase_mesh_training(fs, fk, fp, fl, card, whole_dir: str) -> dict:
    log(f"== phase 18: training over a mesh [{card}]")
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["resume"] = world_resume(whole_dir, tmp, card)
        out["restores"] = mesh_restores(out["resume"]["checkpoint"],
                                        whole_dir, tmp, (fs, fk, fp, fl),
                                        card)
    out["full"] = full_width_launchers(card)
    # each launcher run's own counts, and 18b's counted mesh step
    out["launches"] = {
        "launcher_world_reduced_uninterrupted":
            out["resume"]["launches"]["uninterrupted"],
        "launcher_world_reduced_resumed":
            out["resume"]["launches"]["resumed"],
        "launcher_world_full": out["full"]["world"]["launches"],
        "launcher_one_device_full": out["full"]["one_device"]["launches"],
        "mesh_step": out["restores"]["launches"]}
    for run, counts in out["launches"].items():
        if any(counts.values()):
            raise AssertionError(f"{run} launched {counts} in training")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 18 took {out['phase_s']:.1f} s")
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


def long_prefill(checkout: Path) -> int:
    """Phase 14's LONG_PROMPT-token prefill alone (Gemma-2-2B at full width
    and depth, seeded weights, chunked attention in every layer) with the
    port found under ``checkout``/src: one call to warm, then three, each
    on the host clock and with CUDA events.  Prints one JSON line; the
    card's name and power limit come first."""
    src = checkout / "src"
    if not (src / "repro_torch").is_dir():
        raise FileNotFoundError(f"no port under {src}")
    sys.path.insert(0, str(src))
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import common, transformer

    _, card = phase_device()
    cfg = serve_mod.build_config(ATTN_MAIN)
    params = common.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    ids = lm_batch(cfg, SEED, 2, 1, LONG_PROMPT, "cuda")["tokens"]
    host, device = [], []
    with torch.inference_mode():
        transformer.prefill(params, ids, cfg)
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            (logits, _), ms = host_ms(
                lambda: transformer.prefill(params, ids, cfg))
            e1.record()
            torch.cuda.synchronize()
            host.append(ms)
            device.append(e0.elapsed_time(e1))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits in the long prefill")
    print(json.dumps({"long_prefill": str(checkout), "arch": ATTN_MAIN,
                      "prompt": LONG_PROMPT, "host_ms": host,
                      "device_ms": device, "card": card}), flush=True)
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
    ap.add_argument("--long-prefill", metavar="CHECKOUT", type=Path,
                    help="only time phase 14's 8192-token Gemma-2-2B "
                         "prefill with the port under CHECKOUT/src")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if args.prefill_profile is not None:
        return prefill_profile(args.prefill_profile.resolve())
    if args.long_prefill is not None:
        return long_prefill(args.long_prefill.resolve())
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
    resilient = phase_resilient(data, serve, ops, kdemod, fs, fk, fp, fl,
                                card, dev)
    res_launches = resilient["launches"]
    ring_out = phase_ring(data, est_mod, serve, kdemod, fs, fk, fp, fl,
                          card)
    measurement = phase_measurement(data, clustered, mixture, gen, serve,
                                    est_mod, ops, spatial, kdemod, fs, fk,
                                    fp, fl, decisions, timings, ssm_serve,
                                    paper, card)
    attention = phase_attention(ops, fs, fk, fp, fl, card)
    attn_launches = {arch: m["launches"]
                     for arch, m in attention["models"].items()}
    families = phase_families(ops, fs, fk, fp, fl, card)
    fam_launches = {arch: m["launches"]
                    for arch, m in families["models"].items()}
    with tempfile.TemporaryDirectory() as whole_dir:
        training = phase_training(ops, fs, fk, fp, fl, card, whole_dir)
        dryrun = phase_dryrun(fs, fk, fp, fl, card)
        mesh_training = phase_mesh_training(fs, fk, fp, fl, card,
                                            whole_dir)
    train_launches = {"full": training["launches"],
                      **{arch: r["launches"]
                         for arch, r in training["reduced"].items()}}

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
                # phase 14, counts zeroed before each model's run: Hymba's
                # fused launches, one a layer in its prefill
                "launches_attention": {
                    arch: c["mamba_scan"] + c["selective_scan"]
                    for arch, c in attn_launches.items()},
                "launches_families": {
                    arch: c["mamba_scan"] + c["selective_scan"]
                    for arch, c in fam_launches.items()},
                "hymba": attention["hymba_scan"],
                # phase 16, counts zeroed before each run: training (the
                # SSM trains through the associative scan) launches none
                "launches_training": {
                    run: c["mamba_scan"] + c["selective_scan"]
                    for run, c in train_launches.items()},
                "grad_refusal": {m: training["refusals"][m]
                                 for m in ("selective_scan", "mamba_scan")},
                # phase 17, as the other kernels' entries
                "launches_dryrun": {
                    k: c["mamba_scan"] + c["selective_scan"]
                    for k, c in (("kde_cell", dryrun["launches"]),
                                 ("fake_world",
                                  dryrun["fake_world_launches"]))},
                # phase 18, as the other kernels' entries
                "launches_mesh_training": {
                    run: c["mamba_scan"] + c["selective_scan"]
                    for run, c in mesh_training["launches"].items()},
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
        # phase 11a, counts zeroed before each engine's run (register,
        # requests of 1/128/4096 rows, under "off" a cascade request)
        entry["launches_resilient"] = {
            prune: res_launches[prune].get(kname, 0)
            for prune in ("off", "auto")}
        if kname == "flash_kde":
            entry["launches_laplace_path"] = lap["nonfused"]["flash_kde"]
            entry["launches_stream"] = stream_launches["sdkde off"][kname]
        if kname == "flash_laplace":
            entry["launches_serve"] = lap["serve_off"]["flash_laplace"]
            entry["launches_stream"] = stream_launches["laplace off"][kname]
        if kname in ("flash_score", "flash_kde", "flash_laplace"):
            # phase 12, counts zeroed before each run: the ring of one
            # (fit + evaluate, Laplace evaluate) and each of the gloo
            # ranks on the card (every rank launched as many)
            one = ring_out["world1"]["no group"]
            entry["launches_ring"] = {
                "world1": one["sdkde"]["launches"][kname]
                + one["laplace"]["launches"][kname],
                "world4_per_rank": {
                    name: r["launches_by_rank"][0][kname]
                    for name, r in ring_out["world4"].items()
                    if isinstance(r, dict)}}
        if kname in ("flash_score", "flash_kde"):
            # phase 14, counts zeroed before each model's run: Gemma-2's
            # monitor (B1 its fit, B2 its threshold and scores)
            entry["launches_attention"] = {
                arch: c[kname] for arch, c in attn_launches.items()}
            # phase 15, the same: Granite-MoE's monitor
            entry["launches_families"] = {
                arch: c[kname] for arch, c in fam_launches.items()}
        # phase 16, counts zeroed before each run: no training run
        # launches a kernel; under grad mode the wrapper refuses an input
        # that requires grad (C1)
        entry["launches_training"] = {run: c[kname] for run, c in
                                      train_launches.items()}
        entry["grad_refusal"] = training["refusals"][kname]
        # phase 17c, counts zeroed before the run: the flash_sdkde_32k
        # cell's step (rectangular B1 once, B2 once); 17a, counts zeroed
        # in the dry run's workers before each cell's step and summed
        # over the cells
        entry["launches_dryrun"] = {
            "kde_cell": dryrun["launches"][kname],
            "fake_world": dryrun["fake_world_launches"][kname]}
        # phase 18, counts zeroed by each launcher run before its loop
        # and printed after it (18a's world runs that reach their end,
        # 18c's two), and before 18b's mesh step: none
        entry["launches_mesh_training"] = {
            run: c[kname] for run, c in mesh_training["launches"].items()}
        if kname == "flash_score":
            entry["rect"] = timings["entries"]["flash_score rect"]
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
    summary["resilient"] = resilient
    summary["ring"] = ring_out
    summary["measurement"] = measurement
    summary["attention"] = attention
    summary["families"] = families
    summary["training"] = training
    summary["dryrun"] = dryrun
    summary["mesh_training"] = mesh_training
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
