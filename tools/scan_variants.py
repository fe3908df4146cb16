#!/usr/bin/env python3
"""Time kernel B7 (``csrc/selective_scan.cu``) under edits of its source.

    python3 tools/scan_variants.py 8 16 8:noexp 8:twoexp 8:noload \\
        8:noloadall 8:noglue 8:nocompute --mufu

Run from the repository root on a machine with one NVIDIA GPU and nvcc.
Each spec is ``kChunk[:edit]``: the kernel built with that chunk length
and, optionally, one edit that shows what bounds it:

  * ``noexp``     the decay's exp2 left out (decay = its argument);
  * ``twoexp``    two exp2 a term instead of one;
  * ``noload``    xi and dt not read (constants in their place);
  * ``noloadall`` no input read in the loop (xi, dt, z, B, C constants);
  * ``noglue``    the fused mode's softplus and silu left out;
  * ``nocompute`` the recurrence left out (only staging, the reduction
                  and the writes remain).

Every variant is compiled (all at once) from a copy under
``build/scan_variants/``; an unedited one is also held against the plain
versions at two shapes as ``chip_smoke.py`` holds B7.  Each is timed with
CUDA-graph replays (``chip_smoke.graph_ms``, twice) at Falcon-Mamba-7B's
layer shape, both modes and input types.  ``--mufu`` also measures the
card's MUFU.EX2 and FFMA rates on a microbenchmark, per clock and SM at
the boost clock.  Edited kernels compute wrong values: only their times
mean anything.  Prints one JSON line per variant.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402

OUT = ROOT / "build" / "scan_variants"
EDITS = {
    "noexp": [("fmaf(ex2(del * a2[j]), h[j]", "fmaf(del * a2[j], h[j]")],
    "twoexp": [("fmaf(ex2(del * a2[j]), h[j]",
                "fmaf(ex2(del * a2[j]) * ex2(dx * a2[j]), h[j]")],
    "noload": [("to_f32(xp[k * xstep])", "0.01f * (k + 1)"),
               ("to_f32(dp[k * xstep])", "0.02f * (k + 1)")],
    "noloadall": [("to_f32(xp[k * xstep])", "0.01f * (k + 1)"),
                  ("to_f32(dp[k * xstep])", "0.02f * (k + 1)"),
                  ("to_f32(zp[k * zstep])", "0.05f * (k + 1)"),
                  ("to_f32(bp[t * brow + n])", "0.03f * n"),
                  ("to_f32(cp[t * crow + n])", "0.04f * n")],
    "noglue": [("round_to<T>(softplus_f32(v))", "v"),
               ("round_to<T>(silu_f32(zn[k]))", "zn[k]")],
    "nocompute": [("h[j] = fmaf(ex2(del * a2[j]), h[j], dx * bv[j]);", "")],
}
CHECK_SHAPES = ((2, 200, 1000, 5), cs.SCAN_MAIN)

MUFU_SRC = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
// eight independent chains a thread: MUFU.EX2 (and one FADD) or FFMA
template <bool kEx2>
__global__ void chains(float* out, int iters) {
  float a[8];
  for (int i = 0; i < 8; ++i) a[i] = -1e-3f * (threadIdx.x + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = kEx2 ? ex2(a[i]) - 1.0f : fmaf(a[i], 0.999f, 1e-4f);
  }
  float s = 0.f;
  for (int i = 0; i < 8; ++i) s += a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int ex2, float* out, int blocks, int threads, int iters) {
  if (ex2) chains<true><<<blocks, threads>>>(out, iters);
  else chains<false><<<blocks, threads>>>(out, iters);
  return cudaGetLastError();
}
"""


def variant_source(chunk: int, edit: str | None) -> str:
    src = (_build.CSRC / "selective_scan.cu").read_text()
    src, n = re.subn(r"constexpr int kChunk = \d+;",
                     f"constexpr int kChunk = {chunk};", src)
    assert n == 1, "kChunk not found"
    for old, new in EDITS.get(edit, []):
        assert old in src, f"{edit}: {old!r} not in the source"
        src = src.replace(old, new)
    return src


def build_all(specs):
    """{spec: (library path, ptxas rows)}, nvcc started for all at once."""
    procs = {}
    for spec in specs:
        chunk, _, edit = spec.partition(":")
        d = OUT / spec.replace(":", "_")
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / "selective_scan.cu").write_text(variant_source(int(chunk),
                                                            edit or None))
        lib = d / "libselective_scan.so"
        procs[spec] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(d / "selective_scan.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for spec, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {spec}:\n{log}")
        built[spec] = (lib, cs.ptxas_summary(log))
    return built


def time_variant(spec, lib, rows, gen) -> dict:
    _build._loaded["selective_scan"] = ctypes.CDLL(str(lib))
    if ":" not in spec:
        for shape in CHECK_SHAPES:
            cs.check_scan(ss, cs.scan_inputs(shape, torch.bfloat16, gen),
                          f"{spec} {shape}")
            cs.check_fused_scan(ss, cs.fused_scan_inputs(
                shape, torch.bfloat16, gen), f"{spec} {shape}")
    out = {"variant": spec, "ptxas": {k: [r, sp] for k, r, sp in rows
                                      if k.endswith(",16>")}}
    for tname, dtype in cs.SCAN_DTYPES.items():
        a = cs.scan_inputs(cs.SCAN_MAIN, dtype, gen)
        f = cs.fused_scan_inputs(cs.SCAN_MAIN, dtype, gen)
        out[f"unfused {tname} ms"] = [cs.graph_ms(
            lambda: ss.selective_scan_cuda(*a)) for _ in range(2)]
        out[f"fused {tname} ms"] = [cs.graph_ms(
            lambda: ss.mamba_scan_cuda(*f)) for _ in range(2)]
        del a, f
    return out


def mufu_rates() -> dict:
    d = OUT / "mufu"
    d.mkdir(parents=True, exist_ok=True)
    (d / "mufu.cu").write_text(MUFU_SRC)
    lib_path = d / "libmufu.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(d / "mufu.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = sms * 8, 128, 4096
    buf = torch.empty(blocks * threads, device="cuda")
    rates = {}
    for ex2, name in ((1, "MUFU.EX2"), (0, "FFMA")):
        ms = cs.cuda_ms(lambda: lib.run(ex2, buf.data_ptr(), blocks, threads,
                                        iters), 5)
        ops = blocks * threads * iters * 8
        rates[name] = ops / (ms * 1e-3) / sms / 1.98e9
    return {"per_clock_per_sm_at_1.98GHz": rates}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("specs", nargs="+", help="kChunk[:edit]")
    ap.add_argument("--mufu", action="store_true",
                    help="also measure MUFU.EX2 and FFMA rates")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 2
    for spec in args.specs:
        edit = spec.partition(":")[2]
        if not spec.partition(":")[0].isdigit() or (edit and
                                                     edit not in EDITS):
            ap.error(f"bad spec {spec!r}: kChunk[:{'|'.join(EDITS)}]")
    cs.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for spec, (lib, rows) in build_all(args.specs).items():
        print(json.dumps(time_variant(spec, lib, rows, gen)), flush=True)
    if args.mufu:
        print(json.dumps(mufu_rates()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
