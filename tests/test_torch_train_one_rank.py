"""One f32 train step of reduced Gemma-2 (AdamW, clipping active) on a
(1, 1) mesh of one gloo rank against the mesh-less step, stage by stage,
bit for bit: each microbatch's raw gradients, the accumulated gradient
handed to clipping, the global norm, the updated master weights and the
parameters.

On a mesh of one device ``models.parallel.hint`` is the identity, and
every stage is equal.  Forcing the hints to redistribute there (the
data do not move, but each adds an autograd node) makes the raw
gradients of the first microbatch the first stage to differ: the node
between the residual stream and the norm it feeds regroups the sum of
that tensor's gradient contributions.  So a (1, 1) run of the train
launcher can be held to the one-device launcher bit for bit.
"""

import json
import os
import tempfile

import pytest
import torch

from repro_torch.distributed import world

STAGES = ("raw", "accumulated", "gnorm", "master", "params")


def _local(t):
    from repro_torch.models import parallel

    return (t.to_local() if parallel.is_dtensor(t) else t).detach().clone()


def _step_stages(arch, shape, batch, mesh):
    """Run one step from the seeded state, mesh-less without ``mesh``;
    {stage: [tensors]} of what it computed."""
    from repro_torch.launch import steps, train

    got = {s: [] for s in STAGES}
    accumulate, clip = steps._accumulate, steps.clip_by_global_norm

    def spy_accumulate(acc, g):
        got["raw"].append(_local(g))
        accumulate(acc, g)

    def spy_clip(acc, max_norm):
        got["accumulated"] += [_local(acc[k]) for k in sorted(acc)]
        grads, norm = clip(acc, max_norm)
        got["gnorm"].append(_local(norm))
        return grads, norm

    params, opt = train.init_state(arch, 0, "cpu")
    if mesh is None:
        step = steps.make_train_step(arch, shape, device="cpu")
    else:
        params, opt = steps.shard_state(arch, params, opt, mesh)
        batch = steps.shard_train_batch(arch.model, batch, mesh, shape)
        step = steps.make_train_step(arch, shape, mesh=mesh)
    steps._accumulate, steps.clip_by_global_norm = spy_accumulate, spy_clip
    try:
        params, opt, _ = step(params, opt, batch)
    finally:
        steps._accumulate, steps.clip_by_global_norm = accumulate, clip
    got["master"] = [_local(opt["master"][k]) for k in sorted(opt["master"])]
    got["params"] = [_local(params[k]) for k in sorted(params)]
    return got


def _first_difference(a, b):
    for s in STAGES:
        if len(a[s]) != len(b[s]) or any(
                x.dtype != y.dtype or x.shape != y.shape
                or not torch.equal(x.reshape(-1).view(torch.uint8),
                                   y.reshape(-1).view(torch.uint8))
                for x, y in zip(a[s], b[s])):
            return s
    return None


def _one_rank(rank, world_size, store, out):
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import ShapeCfg, get_arch
    from repro_torch.distributed.elastic import make_mesh, plan_mesh
    from repro_torch.launch import train
    from repro_torch.models import parallel, transformer

    torch.set_num_threads(1)
    world.init(rank, world_size, store)
    arch = get_arch("gemma2_2b")
    arch = dataclasses.replace(arch, model=arch.model.reduced(
        dtype=torch.float32))
    shape = ShapeCfg("t", "train", 16, 8, microbatches=2)
    batch = train.shaped_batch(arch.model, 0, 0, shape, "cpu")
    mesh = make_mesh(plan_mesh(1, model_parallel=1))
    plain = _step_stages(arch, shape, batch, None)
    res = {"gnorm": float(plain["gnorm"][0]),
           "raw_leaves": len(plain["raw"])}

    def redistributing(x, *entries):
        m = parallel.get_mesh()
        return parallel.relayout(x, parallel.placements(
            m, parallel.resolve(m, x.shape, entries)))

    hint = transformer.hint
    parallel.set_mesh(mesh)
    try:
        res["hint"] = _first_difference(
            plain, _step_stages(arch, shape, batch, mesh))
        transformer.hint = redistributing
        res["redistributing"] = _first_difference(
            plain, _step_stages(arch, shape, batch, mesh))
    finally:
        transformer.hint = hint
        parallel.set_mesh(None)
    with open(os.path.join(out, "stages.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def stages():
    with tempfile.TemporaryDirectory() as tmp:
        world.spawn(_one_rank, 1, tmp, timeout=180)
        with open(os.path.join(tmp, "stages.json")) as f:
            yield json.load(f)


def test_one_rank_mesh_step_equals_the_meshless_step_at_every_stage(stages):
    # clipping scales every gradient, so a change in the norm's last bit
    # would reach every updated leaf
    assert stages["gnorm"] > 1.0
    assert stages["raw_leaves"] > 0
    assert stages["hint"] is None


def test_a_redistribution_on_one_device_first_changes_the_raw_gradients(
        stages):
    assert stages["redistributing"] == "raw"
