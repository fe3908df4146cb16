"""The elastic restart on the port (``tests/test_elastic_e2e.py``'s, on
gloo ranks): train on a mesh, checkpoint per-rank shards, restore them
onto a smaller mesh in a new world and train on; and a checkpoint that
``repro`` wrote, restored onto a mesh of 4 ranks and trained on.

Reduced Gemma-2 in f32, ``ShapeCfg("t", "train", 32, 8,
microbatches=2)``, ``peak_lr=1e-3``, ``warmup=2``, batches from
``launch.train.shaped_batch`` (seed 0):

* a world of 8 on mesh (4, 2) over (data, model) trains 6 steps from the
  seeded state, saves, and trains 4 more: the reference;
* a new world of 4 on mesh (2, 2) restores that checkpoint and trains
  the same 4 steps: its losses continue the reference's within
  ``repro``'s bar, rtol 2e-4 and atol 1e-4 (the reduction order
  changes with the mesh, so not bit for bit);
* ``repro`` trains 2 steps on one CPU device (f32, batch 4 of 16 in 2
  microbatches) and checkpoints whole arrays, as
  ``tests/test_torch_checkpoint.py`` makes one; the world of 4 restores
  it onto (2, 2) and takes the next step on ``repro``'s next batch: loss,
  grad norm, lr and every parameter within the model bar of ``repro``'s
  step (rtol 2e-4, atol 2e-5 of a leaf's largest magnitude).
"""

import dataclasses
import json
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.distributed import world

RTOL, ATOL = 2e-4, 1e-4          # the elastic bar (test_elastic_e2e.py)
MODEL_RTOL, MODEL_ATOL = 2e-4, 2e-5
FIRST, MORE = 6, 4


def _arch():
    from repro_torch.configs import get_arch

    a = get_arch("gemma2_2b")
    return dataclasses.replace(a, model=a.model.reduced(dtype=torch.float32))


def _step(arch, shape, mesh):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import parallel

    parallel.set_mesh(mesh)
    return make_train_step(arch, shape, peak_lr=1e-3, warmup=2, mesh=mesh)


def _train(fn, arch, shape, mesh, params, opt, start, steps):
    from repro_torch.launch.steps import shard_train_batch
    from repro_torch.launch.train import shaped_batch

    losses = []
    for s in range(start, start + steps):
        batch = shard_train_batch(
            arch.model, shaped_batch(arch.model, 0, s, shape, "cpu"), mesh,
            shape)
        params, opt, m = fn(params, opt, batch)
        losses.append(float(m["loss"].full_tensor()))
    return params, opt, losses


def _layout(arch, mesh):
    from repro_torch.launch.steps import abstract_opt_state
    from repro_torch.models.common import abstract_params

    return {"params": abstract_params(arch.model, mesh),
            "opt": abstract_opt_state(arch, mesh)}


def _mesh(n_data):
    from repro_torch.distributed.elastic import MeshPlan, make_mesh

    return make_mesh(MeshPlan((n_data, 2), ("data", "model")))


def _shape():
    from repro_torch.configs import ShapeCfg

    return ShapeCfg("t", "train", 32, 8, microbatches=2)


def _first_world(rank, world_size, store, out):
    """World of 8, mesh (4, 2): 6 steps, save, 4 more (the reference)."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.steps import shard_state
    from repro_torch.launch.train import init_state

    torch.set_num_threads(1)
    world.init(rank, world_size, store)
    arch, shape, mesh = _arch(), _shape(), _mesh(4)
    fn = _step(arch, shape, mesh)
    params, opt = shard_state(arch, *init_state(arch, 0, "cpu"), mesh)
    params, opt, first = _train(fn, arch, shape, mesh, params, opt, 0, FIRST)
    mgr = CheckpointManager(os.path.join(out, "ckpt"))
    mgr.save(FIRST, {"params": params, "opt": opt}, blocking=True)
    mgr.close()
    _, _, ref = _train(fn, arch, shape, mesh, params, opt, FIRST, MORE)
    if rank == 0:
        with open(os.path.join(out, "reference.json"), "w") as f:
            json.dump({"first": first, "reference": ref}, f)
    dist.destroy_process_group()


def _second_world(rank, world_size, store, out, repro_dir):
    """World of 4, mesh (2, 2): the elastic restore and 4 steps; then
    repro's checkpoint restored and one step on repro's next batch."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.steps import shard_train_batch

    torch.set_num_threads(1)
    world.init(rank, world_size, store)
    arch, shape, mesh = _arch(), _shape(), _mesh(2)
    mgr = CheckpointManager(os.path.join(out, "ckpt"))
    assert mgr.latest_step() == FIRST
    state = mgr.restore("cpu", layout=_layout(arch, mesh), mesh=mesh)
    mgr.close()
    fn = _step(arch, shape, mesh)
    _, _, resumed = _train(fn, arch, shape, mesh, state["params"],
                           state["opt"], FIRST, MORE)

    jshape = ShapeCfg("t", "train", 16, 4, microbatches=2)
    jmgr = CheckpointManager(repro_dir)
    state = jmgr.restore("cpu", layout=_layout(arch, mesh), mesh=mesh)
    jmgr.close()
    tokens = torch.as_tensor(np.load(os.path.join(repro_dir, "batch.npy")))
    batch = shard_train_batch(arch.model, {"tokens": tokens.long()}, mesh,
                              jshape)
    p, o, m = _step(arch, jshape, mesh)(state["params"], state["opt"],
                                        batch)
    got = {f"params/{k}": v.full_tensor() for k, v in p.items()}
    got.update({k: m[k].full_tensor() for k in ("loss", "grad_norm", "lr")})
    got["step"] = o["step"].full_tensor()
    if rank == 0:
        np.savez(os.path.join(out, "repro_step.npz"),
                 **{k: v.numpy() for k, v in got.items()})
        with open(os.path.join(out, "resumed.json"), "w") as f:
            json.dump(resumed, f)
    dist.destroy_process_group()


def _repro_checkpoint(d):
    """repro's reduced Gemma-2 after 2 steps, checkpointed whole; its next
    batch (saved beside) and its next step's results."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.checkpoint import CheckpointManager as JCheckpointManager
    from repro.configs import ShapeCfg as JShapeCfg
    from repro.configs import get_arch as jget_arch
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.launch.train import shaped_batch as jshaped_batch
    from repro.models import common as jcommon
    from repro.optim.adamw import adamw_init as jadamw_init

    ja = jget_arch("gemma2_2b")
    ja = dataclasses.replace(ja, model=ja.model.reduced(dtype=jnp.float32))
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    jshape = JShapeCfg("t", "train", 16, 4, microbatches=2)
    fn, _, _ = jmake_train_step(ja, mesh, jshape, peak_lr=1e-3, warmup=2)
    jstep = jax.jit(fn)
    jp = jcommon.init_params(ja.model, jax.random.PRNGKey(0))
    jo = jadamw_init(jp)
    for s in range(2):
        jp, jo, _ = jstep(jp, jo, jshaped_batch(ja.model, 0, s, jshape))
    ck = JCheckpointManager(d)
    ck.save(2, {"params": jp, "opt": jo}, blocking=True)
    b = np.asarray(jshaped_batch(ja.model, 0, 2, jshape)["tokens"])
    np.save(os.path.join(d, "batch.npy"), b)
    jp, jo, jm = jstep(jp, jo, {"tokens": b})
    want = {f"params/{k}": np.asarray(v) for k, v in jp.items()}
    want.update({k: np.asarray(jm[k]) for k in ("loss", "grad_norm", "lr")})
    want["step"] = np.asarray(jo["step"])
    return want


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as tmp:
        repro_dir = os.path.join(tmp, "repro")
        # repro's run (jit compiles, one process) beside the world of 8
        with ThreadPoolExecutor(max_workers=1) as pool:
            first = pool.submit(world.spawn, _first_world, 8, tmp,
                                timeout=300)
            want = _repro_checkpoint(repro_dir)
            first.result()
        world.spawn(_second_world, 4, tmp, repro_dir, timeout=300)
        ref = json.load(open(os.path.join(tmp, "reference.json")))
        resumed = json.load(open(os.path.join(tmp, "resumed.json")))
        got = dict(np.load(os.path.join(tmp, "repro_step.npz")))
        yield ref, resumed, want, got


def test_elastic_restart_preserves_trajectory(runs):
    ref, resumed, _, _ = runs
    assert len(ref["first"]) == FIRST and all(
        np.isfinite(ref["first"] + ref["reference"]))
    np.testing.assert_allclose(resumed, ref["reference"], rtol=RTOL,
                               atol=ATOL)


def test_a_checkpoint_repro_wrote_trains_on_over_a_mesh(runs):
    _, _, want, got = runs
    assert set(got) == set(want)
    assert int(got["step"]) == int(want["step"]) == 3
    for k, w in want.items():
        if k == "step":
            continue
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(
            got[k], w, rtol=MODEL_RTOL,
            atol=MODEL_ATOL * max(float(np.abs(w).max()), 1e-30),
            err_msg=k)
