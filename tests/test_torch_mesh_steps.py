"""The sharded steps of ``launch.steps.build_cell`` on a world of 8 gloo
ranks (mesh (2, 2, 2) over (pod, data, model)) against the port's
one-device steps, for reduced Gemma-2, Granite-MoE and Kimi-K2 (f32,
``repro``'s reduced sizes); ``test_torch_mesh_steps_families.py`` runs
Falcon-Mamba, LLaVA-NeXT and Whisper through the same worker.

Each rank builds the full seeded parameters, optimizer state, batch and
cache, runs the one-device step on them, and runs the cell's step on
DTensors cut from the same values by the cell's specs
(``models.parallel.shard_from_full``):

* train: global batch 16 of seq 16 in 2 microbatches (8 rows a
  microbatch over the 4 batch shards), one AdamW / Adafactor step;
* prefill: batch 8 of 16 tokens; the logits and every cache entry;
* decode: one token against a seeded cache of 16 positions at position
  15, batch 8 (rows over (pod, data); KV heads or the sequence over
  ``model``) and batch 1 (the sequence over every axis); the logits and
  the updated cache.

Tolerance: the model bar, rtol 2e-4 and atol 2e-5 of a leaf's largest
magnitude; the gradient-derived leaves (grad norm, moments) of the Mamba
family at atol 2e-4 and those of bf16 accumulators (Kimi-K2, LLaVA-NeXT)
at 6·2⁻⁸, as ``tests/test_torch_train_step.py`` holds them against
``repro``.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.distributed import world

ARCHS = ("gemma2_2b", "granite_moe_3b_a800m", "kimi_k2_1t_a32b")
KINDS = ("train", "prefill", "decode", "long")
RTOL, ATOL = 2e-4, 2e-5
SSM_ATOL = 2e-4
BF16_RTOL = 6 * 2.0**-8


def _arch(arch_id):
    from repro_torch.configs import get_arch

    a = get_arch(arch_id)
    return dataclasses.replace(a, model=a.model.reduced(
        dtype=torch.float32), train_microbatches=None)


def _shapes():
    from repro_torch.configs import ShapeCfg

    return {"train": ShapeCfg("t", "train", 16, 16, microbatches=2),
            "prefill": ShapeCfg("p", "prefill", 16, 8),
            "decode": ShapeCfg("d", "decode", 16, 8),
            "long": ShapeCfg("l", "decode", 16, 1)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _distribute(full, abstract, mesh):
    """``full``'s tensors cut by the specs of the matching ``Abstract``
    leaves; everything else as it is."""
    from repro_torch.models.parallel import Abstract, shard_from_full

    if isinstance(abstract, Abstract):
        return shard_from_full(full, mesh, abstract.spec)
    if isinstance(abstract, dict):
        return {k: _distribute(full[k], abstract[k], mesh) for k in full}
    if isinstance(abstract, tuple):
        return tuple(_distribute(f, a, mesh) for f, a in zip(full, abstract))
    return full


def _whole(tree):
    from torch.distributed.tensor import DTensor

    return {k: (v.full_tensor() if isinstance(v, DTensor) else
                torch.as_tensor(v)).detach().clone()
            for k, v in _flat(tree).items()}


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else
            (v.clone() if torch.is_tensor(v) else v)
            for k, v in tree.items()}


def _run(arch_id, kind, mesh):
    """(one-device results, mesh results), flat dicts of whole tensors."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch.steps import build_cell, make_train_step
    from repro_torch.launch.train import shaped_batch
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import (cache_spec, decode_step,
                                                prefill)
    from repro_torch.optim.adafactor import adafactor_init
    from repro_torch.optim.adamw import adamw_init

    arch = _arch(arch_id)
    cfg = arch.model
    shape = _shapes()[kind]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    fn, abstract, _ = build_cell(arch, shape, mesh)
    if kind == "train":
        opt = (adafactor_init(params) if arch.optimizer == "adafactor"
               else adamw_init(params))
        batch = shaped_batch(cfg, 0, 0, shape, device="cpu")
        full = (params, opt, batch)
        p1, o1, m1 = make_train_step(arch, shape, device="cpu")(
            _clone(params), _clone(opt), batch)
        want = {**_whole({"params": p1, "opt": o1}),
                "loss": m1["loss"], "grad_norm": m1["grad_norm"]}
        p2, o2, m2 = fn(*_distribute(full, abstract, mesh))
        got = {**_whole({"params": p2, "opt": o2}),
               **_whole({"loss": m2["loss"], "grad_norm": m2["grad_norm"]})}
        return want, got
    if kind == "prefill":
        batch = lm_batch(cfg, 0, 0, shape.global_batch, shape.seq_len,
                         device="cpu")
        with torch.no_grad():
            logits, cache = prefill(params, batch["tokens"], cfg,
                                    patches=batch.get("patches"),
                                    frames=batch.get("frames"))
        cache.pop("pos")
        want = _whole({"logits": logits, "cache": cache})
        logits2, cache2 = fn(*_distribute((params, batch), abstract, mesh))
        cache2.pop("pos")
        return want, _whole({"logits": logits2, "cache": cache2})
    gen = torch.Generator().manual_seed(1)
    b = shape.global_batch
    cache = {k: torch.randn(s, generator=gen, dtype=torch.float32).to(dt)
             for k, (s, dt) in cache_spec(cfg, b, shape.seq_len).items()}
    cache["pos"] = shape.seq_len - 1
    tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen)
    full = (params, _clone(cache), tokens)
    with torch.no_grad():
        logits, c1 = decode_step(params, cache, tokens, cfg)
    c1.pop("pos")
    want = _whole({"logits": logits, "cache": c1})
    logits2, c2 = fn(*_distribute(full, abstract, mesh))
    assert c2.pop("pos") == shape.seq_len
    return want, _whole({"logits": logits2, "cache": c2})


def _worker(rank, world_size, store, out_dir, archs):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)         # 8 ranks share the host's cores
    world.init(rank, world_size, store)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    res = {}
    for arch_id in archs:
        for kind in KINDS:
            want, got = _run(arch_id, kind, mesh)
            assert set(want) == set(got), (arch_id, kind)
            for k in want:
                res[f"{arch_id}|{kind}|want|{k}"] = want[k]
                res[f"{arch_id}|{kind}|got|{k}"] = got[k]
    if rank == 0:
        np.savez(os.path.join(out_dir, "steps.npz"),
                 **{k: v.to(torch.float64).numpy() for k, v in res.items()})
    dist.destroy_process_group()


def spawn_results(archs):
    """The worker's results over ``archs`` on the world of 8."""
    with tempfile.TemporaryDirectory() as tmp:
        world.spawn(_worker, 8, tmp, archs, timeout=300)
        return dict(np.load(os.path.join(tmp, "steps.npz")))


def check(results, arch, kind):
    keys = [k.split("|", 3)[3] for k in results
            if k.startswith(f"{arch}|{kind}|want|")]
    assert keys
    for leaf in keys:
        want = results[f"{arch}|{kind}|want|{leaf}"]
        got = results[f"{arch}|{kind}|got|{leaf}"]
        rtol, atol = _bars(arch, leaf)
        np.testing.assert_allclose(
            got, want, rtol=rtol,
            atol=atol * max(float(np.abs(want).max()), 1e-30),
            err_msg=f"{arch} {kind} {leaf}")


@pytest.fixture(scope="module")
def results():
    return spawn_results(ARCHS)


def _bars(arch_id, leaf):
    arch = _arch(arch_id)
    from_grads = leaf == "grad_norm" or leaf.split("/")[:2] in (
        ["opt", "mu"], ["opt", "nu"], ["opt", "v"])
    if from_grads and arch.accum_dtype == "bfloat16":
        return BF16_RTOL, BF16_RTOL
    if from_grads and arch.model.family in ("ssm", "hybrid"):
        return RTOL, SSM_ATOL
    return RTOL, ATOL


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_device(results, arch, kind):
    check(results, arch, kind)
