"""The multi-pod dry run (``repro.launch.dryrun``): every (architecture ×
shape × mesh) cell built whole, at full width and depth, on a fake world
of 256 or 512 ranks, with nothing allocated.

``repro``'s dry run lowers and compiles each cell for 512 placeholder host
devices and reads XLA's per-device cost and memory analysis.  Here each
process opens its own fake world (``torch.distributed``'s "fake" backend:
collectives that move nothing), builds the production mesh
(``launch.mesh.make_production_mesh``), and runs each cell once as rank 0
with its inputs as DTensors over shards that take no memory: meta
tensors for the LM cells, ``FakeTensorMode`` CPU tensors for the KDE
cells (the kernels' plain versions run there, as ``repro`` lowers
``ring2d``'s plain ``jnp``).  ``analysis.rank.RankCounter`` counts the
rank's work on its local shards, and ``analysis.roofline`` turns the
counts into the three terms on H100 data-sheet rates (modelled, not
measured; the collective term prices every axis at NVLink 4, though a
16-wide ``model`` axis spans two 8-GPU nodes).

For every cell:
  1. ``launch.steps.build_cell`` / ``make_kde_step`` give (step_fn,
     abstract_inputs, donate);
  2. the inputs become DTensors over unallocated shards;
  3. the step runs under ``RankCounter``: per-rank FLOPs, HBM bytes, the
     eager peak of live local storage, and each collective's wire bytes;
  4. the record (``repro``'s keys; ``hlo_flops`` / ``hlo_bytes`` hold the
     counter's numbers; ``model_flops`` counts only what a token
     multiplies, ``lm_model_flops``) gains ``peak_bytes``, ``fits``
     (≤ 80 GB), ``collectives`` and ``kernel_launches`` (the kernels'
     launch counts, zeroed before the step), and goes to
     ``results/dryrun_<mesh>.json``.

Usage:
  python -m repro_torch.launch.dryrun       # every cell, both meshes
  python -m repro_torch.launch.dryrun --mesh single --arch gemma2_2b
  python -m repro_torch.launch.dryrun --arch flash_sdkde_1m
  python -m repro_torch.launch.dryrun \
      --cells gemma2_2b/decode_32k,kimi_k2_1t_a32b/train_4k@multi

``--jobs N`` spreads a mesh's cells over N worker processes, each with
its own fake world.  It prints ``DONE: n ok, m skips, k FAILURES`` and
exits 1 if any cell failed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import List, Tuple

from repro_torch.analysis.flops import sdkde_flops
from repro_torch.analysis.rank import RankCounter
from repro_torch.analysis.roofline import HBM_BYTES, roofline_from_counts
from repro_torch.configs import (KDE_WORKLOADS, LM_SHAPES, SHAPES,
                                 get_arch, list_archs)
from repro_torch.launch.mesh import PRODUCTION, make_production_mesh, mesh_desc
from repro_torch.launch.steps import build_cell, make_kde_step, materialize
from repro_torch.models import parallel
from repro_torch.models.common import active_param_count

MESHES = {"single": False, "multi": True}


def open_fake_world(ranks: int) -> None:
    """This process as rank 0 of a fake world of ``ranks`` (any earlier
    world closed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == ranks and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)


def production_mesh(name: str):
    """The production mesh ``name`` ("single" or "multi") on a fake world
    of its size."""
    shape, _ = PRODUCTION[MESHES[name]]
    n = 1
    for s in shape:
        n *= s
    open_fake_world(n)
    return make_production_mesh(multi_pod=MESHES[name])


def _inputs(abstract, mesh, device: str):
    return materialize(abstract, lambda a: parallel.empty_like_abstract(
        a, mesh, device=device))


def lm_model_flops(arch, shape) -> float:
    """6·N·D (train) or 2·N·D over the parameters a token multiplies:
    ``repro``'s ``model_flops`` (N the active parameters, D the tokens of
    a step, one a sequence for a decode step) less what no token
    multiplies.  An untied input embedding is looked up, never
    multiplied; a prefill applies the output head (``lm_head``, or the
    tied embedding) at each sequence's last position only, as
    ``repro``'s does.  Counted whole, the two would read useful > 1 in
    Falcon-Mamba's decode (its 266M-row table is 3.7% of N) and prefill
    (its head another 3.7%), where nothing else outweighs them."""
    cfg = arch.model
    table = cfg.padded_vocab * cfg.d_model
    n = active_param_count(cfg) - (0 if cfg.tie_embeddings else table)
    per_token = (6 if shape.kind == "train" else 2) * n
    if shape.kind == "decode":
        return float(per_token) * shape.global_batch
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return (2.0 * (n - table) * tokens
                + 2.0 * table * shape.global_batch)
    return float(per_token) * tokens


def _launch_counters():
    """The kernel modules whose wrappers count their launches."""
    from repro_torch.kernels import flash_kde, flash_laplace, flash_pruned
    from repro_torch.kernels import flash_score, selective_scan

    return flash_score, flash_kde, flash_pruned, flash_laplace, selective_scan


def reset_launches() -> None:
    """Set the launch count of every kernel (B1–B7) to 0."""
    fs, fk, fp, fl, ss = _launch_counters()
    fs.launches = fk.launches = 0
    fl.laplace_launches = fl.sq_moment_launches = 0
    ss.launches = ss.fused_launches = 0
    for counts in (fp.score_counts, fp.kde_counts, fp.laplace_counts):
        counts.reset()


def read_launches() -> dict:
    """Each kernel's launches since ``reset_launches``, by wrapper."""
    fs, fk, fp, fl, ss = _launch_counters()
    return {"flash_score": fs.launches, "flash_kde": fk.launches,
            "flash_score_pruned": fp.score_counts.launches,
            "flash_kde_pruned": fp.kde_counts.launches,
            "flash_laplace": fl.laplace_launches,
            "sq_moment": fl.sq_moment_launches,
            "selective_scan": ss.launches, "mamba_scan": ss.fused_launches}


def count_step(fn, abstract, mesh, *, fake_cpu: bool = False) -> dict:
    """``RankCounter.summary()`` of one call of ``fn`` on DTensors over
    unallocated shards of ``abstract``: meta tensors, or with
    ``fake_cpu`` ``FakeTensorMode`` CPU tensors (where the kernels' plain
    versions run)."""
    if fake_cpu:
        from torch._subclasses.fake_tensor import FakeTensorMode

        mode, device = FakeTensorMode(allow_non_fake_inputs=True), "cpu"
    else:
        mode, device = contextlib.nullcontext(), "meta"
    counter = RankCounter()
    reset_launches()
    try:
        with mode:
            args = _inputs(abstract, mesh, device)
            counter.track(args)
            with counter:
                out = fn(*args)
                del out, args
    finally:
        parallel.set_mesh(None)
    return {**counter.summary(), "kernel_launches": read_launches()}


def record(arch_id: str, shape_name: str, mesh, counts: dict,
           model_flops_: float, seconds: float) -> dict:
    """The cell's record: ``repro``'s keys (``RooflineTerms.row()``), its
    status and time, and ``peak_bytes``, ``fits``, ``collectives`` and
    ``kernel_launches`` (each kernel's launches in the step: 0, since
    fake and meta tensors take the plain versions)."""
    terms = roofline_from_counts(
        arch=arch_id, shape=shape_name, flops=counts["flops"],
        bytes=counts["bytes"], collective_bytes=counts["collective_bytes"],
        model_flops=model_flops_, mesh=mesh_desc(mesh), chips=mesh.size(),
        bytes_per_device=counts["peak_bytes"])
    rec = terms.row()
    rec.update(status="ok", compile_s=seconds,
               peak_bytes=counts["peak_bytes"],
               fits=counts["peak_bytes"] <= HBM_BYTES,
               collectives=counts["collectives"],
               kernel_launches=counts["kernel_launches"],
               memory_analysis=(f"eager peak of live local storage "
                                f"{counts['peak_bytes']} B a rank"))
    return rec


def run_cell(arch_id: str, shape_name: str, mesh, *,
             verbose: bool = True) -> dict:
    """Build and run one cell on ``mesh`` under ``RankCounter``; returns
    its record (``status`` "ok" or "skip")."""
    t0 = time.time()
    if arch_id in KDE_WORKLOADS:
        wl = KDE_WORKLOADS[arch_id]
        fn, abstract, _ = make_kde_step(wl, mesh)
        mf = sdkde_flops(wl.n_train, wl.dim, n_test=wl.n_test)
        shape_name = f"{wl.n_train}x{wl.n_test}xd{wl.dim}"
        counts = count_step(fn, abstract, mesh, fake_cpu=True)
    else:
        arch = get_arch(arch_id)
        shape = SHAPES[shape_name]
        skip = arch.shape_applicable(shape)
        if skip:
            return {"arch": arch_id, "shape": shape_name,
                    "mesh": mesh_desc(mesh), "status": "skip",
                    "reason": skip}
        fn, abstract, _ = build_cell(arch, shape, mesh)
        mf = lm_model_flops(arch, shape)
        counts = count_step(fn, abstract, mesh)
    rec = record(arch_id, shape_name, mesh, counts, mf, time.time() - t0)
    if verbose:
        print(f"== {arch_id} / {shape_name} @ {rec['mesh']} ==")
        print("   peak %.2f GiB a rank (fits 80 GB: %s)  flops/rank=%.3e  "
              "bytes/rank=%.3e  collective bytes/rank=%.3e"
              % (rec["peak_bytes"] / 2**30, rec["fits"], rec["hlo_flops"],
                 rec["hlo_bytes"], rec["collective_bytes"]))
        print("   roofline (H100 data sheet): t_comp=%.2fms t_mem=%.2fms "
              "t_coll=%.2fms bound=%s MFU@roofline=%.1f%% useful=%.2f"
              % (rec["t_compute_s"] * 1e3, rec["t_memory_s"] * 1e3,
                 rec["t_collective_s"] * 1e3, rec["bound"],
                 rec["mfu"] * 100, rec["useful_ratio"]))
        print(f"   took {rec['compile_s']:.1f}s", flush=True)
    return rec


def cells_for(arch: str, shape: str) -> List[Tuple[str, str]]:
    arch_ids = (list(list_archs()) + list(KDE_WORKLOADS)
                if arch == "all" else [arch])
    out = []
    for a in arch_ids:
        if a in KDE_WORKLOADS:
            out.append((a, "paper"))
        elif shape == "all":
            out.extend((a, s.name) for s in LM_SHAPES)
        else:
            out.append((a, shape))
    return out


def _run_or_fail(mesh_name: str, arch_id: str, shape_name: str) -> dict:
    """``run_cell`` on the production mesh ``mesh_name`` of this process;
    a failure becomes a "FAIL" record (a bug in the port)."""
    mesh = production_mesh(mesh_name)
    try:
        return run_cell(arch_id, shape_name, mesh)
    except Exception as e:
        traceback.print_exc()
        print(f"FAIL {arch_id}/{shape_name} @ {mesh_name}", flush=True)
        return {"arch": arch_id, "shape": shape_name,
                "mesh": mesh_desc(mesh), "status": "FAIL",
                "error": f"{type(e).__name__}: {e}"}


def run_cells(plan: List[Tuple[str, str, str]], jobs: int = 1) -> List[dict]:
    """The records of every (mesh name, arch, shape) of ``plan``, in its
    order: in this process, or spread over ``jobs`` worker processes,
    each with its own fake world."""
    if jobs > 1 and len(plan) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(jobs, len(plan)),
                                 mp_context=ctx) as pool:
            return list(pool.map(_run_or_fail, *zip(*plan)))
    return [_run_or_fail(*cell) for cell in plan]


def write_records(mesh_name: str, records: List[dict],
                  out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"dryrun_{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
    print(f"wrote {path} ({len(records)} cells)")
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id, kde workload id, or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch/shape[@single|multi] "
                         "(overrides --arch/--shape; default mesh: --mesh)")
    ap.add_argument("--out", default="results")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes, each with its own fake world")
    args = ap.parse_args(argv)
    names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    plan: List[Tuple[str, str, str]] = []
    if args.cells:
        for item in args.cells.split(","):
            cell, _, where = item.partition("@")
            a, _, s = cell.partition("/")
            plan += [(m, a, s or "paper") for m in ([where] if where
                                                     else names)]
    else:
        plan = [(m, a, s) for m in names
                for a, s in cells_for(args.arch, args.shape)]
    t0 = time.time()
    records = run_cells(plan, args.jobs)
    total = {"ok": 0, "skip": 0, "FAIL": 0}
    for rec in records:
        total[rec["status"]] += 1
        if rec["status"] == "skip":
            print(f"-- skip {rec['arch']}/{rec['shape']}: {rec['reason']}")
    for m in dict.fromkeys(c[0] for c in plan):
        mine = [r for c, r in zip(plan, records) if c[0] == m]
        print(f"mesh {m}: {len(mine)} cells, "
              f"{sum(r.get('compile_s', 0.0) for r in mine):.1f} s of "
              "cell time")
        if args.out:
            write_records(m, mine, args.out)
    print(f"wall {time.time() - t0:.1f} s with {args.jobs} job(s)")
    print(f"DONE: {total['ok']} ok, {total['skip']} skips, "
          f"{total['FAIL']} FAILURES")
    raise SystemExit(1 if total["FAIL"] else 0)


if __name__ == "__main__":
    main()
