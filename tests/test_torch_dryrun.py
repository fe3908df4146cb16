"""The dry run (``launch/dryrun.py``) on fake worlds, after
``tests/test_launch_cells.py``.

Every family (dense Gemma-2, MoE Granite-MoE and Kimi-K2 with its 2-D
experts, SSM Falcon-Mamba, hybrid Hymba, VLM LLaVA-NeXT, audio Whisper)
× every shape kind (train with 2 microbatches, prefill, decode with rows
over the batch axes, decode at batch 1 with the sequence over every
axis) at ``repro``'s reduced sizes in bf16 with remat, on a fake world of
8 ranks, mesh (2, 2, 2) over (pod, data, model): each cell builds
(``build_cell``) and runs under the rank counter, and its record has
positive FLOPs, bytes and peak, collective bytes wherever a dim is cut
over more than one rank, and a useful ratio ≤ 1.  One production cell,
Gemma-2-2B decode_32k on the (16, 16) mesh of 256 fake ranks, and the
flash_sdkde_32k cell go through the command line.  The fake worlds run
in child processes, so this process's ``torch.distributed`` stays
closed.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("gemma2_2b", "granite_moe_3b_a800m", "kimi_k2_1t_a32b",
            "falcon_mamba_7b", "hymba_1p5b", "llava_next_34b",
            "whisper_large_v3")
KINDS = ("train", "prefill", "decode", "long")

_CHILD = r"""
import dataclasses, json, sys, time
from concurrent.futures import ProcessPoolExecutor
import multiprocessing
import torch

FAMILIES, KINDS = json.loads(sys.argv[1]), json.loads(sys.argv[2])

def cell(arch_id, kind):
    from repro_torch.configs import ShapeCfg, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_desc
    from repro_torch.launch.steps import build_cell
    from torch.distributed.device_mesh import init_device_mesh
    import torch.distributed as dist
    if not dist.is_initialized():
        dryrun.open_fake_world(8)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    shape = {"train": ShapeCfg("train", "train", 128, 16, microbatches=2),
             "prefill": ShapeCfg("prefill", "prefill", 256, 8),
             "decode": ShapeCfg("decode", "decode", 256, 8),
             "long": ShapeCfg("long", "decode", 1024, 1)}[kind]
    arch = get_arch(arch_id)
    small = arch.model.reduced(dtype=torch.bfloat16, remat="full",
                               loss_chunk=64)
    arch = dataclasses.replace(arch, model=small, train_microbatches=None)
    t0 = time.time()
    fn, abstract, _ = build_cell(arch, shape, mesh)
    counts = dryrun.count_step(fn, abstract, mesh)
    return dryrun.record(arch_id, kind, mesh, counts,
                         dryrun.lm_model_flops(arch, shape),
                         time.time() - t0)

if __name__ == "__main__":
    plan = [(a, k) for a in FAMILIES for k in KINDS]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(4, mp_context=ctx) as pool:
        recs = list(pool.map(cell, *zip(*plan)))
    print("RECORDS " + json.dumps(recs))
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.fixture(scope="module")
def records():
    with tempfile.TemporaryDirectory() as tmp:
        script = Path(tmp) / "cells.py"
        script.write_text(_CHILD)
        run = subprocess.run(
            [sys.executable, str(script), json.dumps(FAMILIES),
             json.dumps(KINDS)], cwd=ROOT, env=_env(), capture_output=True,
            text=True, timeout=600)
    line = [ln for ln in run.stdout.splitlines()
            if ln.startswith("RECORDS ")]
    assert run.returncode == 0 and line, run.stdout[-3000:] + \
        run.stderr[-5000:]
    recs = json.loads(line[0][len("RECORDS "):])
    return {(r["arch"], r["shape"]): r for r in recs}


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_shape_kind_runs_on_a_fake_world(records, arch):
    for kind in KINDS:
        r = records[(arch, kind)]
        assert r["status"] == "ok", (arch, kind)
        assert r["chips"] == 8 and r["mesh"].startswith("2x2x2")
        assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0
        assert 0 < r["peak_bytes"] == r["bytes_per_device"]
        assert r["fits"]
        assert 0 < r["useful_ratio"] <= 1, (arch, kind, r["useful_ratio"])
        assert r["bound"] in ("compute", "memory", "collective")
        # every kind cuts its weights over ``model``: some collective
        assert r["collective_bytes"] > 0, (arch, kind)
        assert r["collective_bytes"] == sum(
            c["bytes"] for c in r["collectives"].values())


@pytest.mark.parametrize("kind", KINDS)
def test_a_train_step_does_more_than_its_forward(records, kind):
    """Per rank, a train cell's FLOPs exceed its prefill's (a forward of
    the same rows and twice the backward)."""
    for arch in FAMILIES:
        train, prefill = records[(arch, "train")], records[(arch, "prefill")]
        assert train["hlo_flops"] > prefill["hlo_flops"] / 2
        assert records[(arch, kind)]["t_compute_s"] > 0


def test_a_production_cell_through_the_command_line():
    with tempfile.TemporaryDirectory() as tmp:
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
             "single", "--cells", "gemma2_2b/decode_32k,flash_sdkde_32k",
             "--out", tmp], cwd=ROOT, env=_env(), capture_output=True,
            text=True, timeout=300)
        assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
        assert "DONE: 2 ok, 0 skips, 0 FAILURES" in run.stdout
        recs = json.loads((Path(tmp) / "dryrun_single.json").read_text())
    lm, kde = recs
    assert lm["arch"] == "gemma2_2b" and lm["chips"] == 256
    assert lm["status"] == "ok" and lm["fits"]
    assert 0 < lm["useful_ratio"] <= 1
    # a rank holds 8 of the 128 rows, 2048 of the 32768 cached positions
    # (4 KV heads do not divide 16: the sequence is cut over ``model``)
    # and 1/16 of the weights: a few GiB
    assert 1 * 2**30 < lm["peak_bytes"] < 16 * 2**30
    assert lm["collectives"]
    assert kde["shape"] == "32768x4096xd16" and kde["status"] == "ok"
    assert kde["collective_bytes"] > 0
    # fake and meta tensors take the kernels' plain versions
    for rec in recs:
        assert set(rec["kernel_launches"]) >= {"flash_score", "flash_kde",
                                               "selective_scan"}
        assert not any(rec["kernel_launches"].values())
