"""The rest of the port's ``distributed`` package and ``launch/mesh.py``
against ``repro``'s.

  * ``straggler``: ``repro``'s cases (``tests/test_fault_tolerance.py``)
    on the port's ``DuplicateDispatcher`` / ``pick_backup``;
  * ``compression``: ``compress`` / ``decompress`` on the same numpy
    inputs as ``repro``'s (the int8 payloads equal, scales and residuals
    within f32 rounding), error feedback and convergence, and
    ``compressed_psum`` over a spawned gloo world of 2 against the mean of
    the dequantized members;
  * ``elastic.make_mesh`` / ``reshard_specs`` and the mesh helpers on a
    spawned gloo world of 4 (2 × 2 meshes), and on a mesh of one against
    ``repro``'s test.

JAX and ``repro`` are imported inside the tests: the spawned ranks import
this module and need neither.
"""

import os
import tempfile
import time

import numpy as np
import pytest
import torch

from repro_torch.distributed import compression, elastic, ring, world
from repro_torch.distributed.straggler import DuplicateDispatcher, pick_backup
from repro_torch.launch import mesh as mesh_mod

# -- straggler dispatch ------------------------------------------------------


def test_duplicate_dispatch_backup_wins():
    d = DuplicateDispatcher(deadline=0.05)

    def work(host):
        if host == 0:
            time.sleep(0.5)    # straggling primary
        return host

    result, winner = d.run(work, primary=0, backup=1)
    assert winner == 1 and result == 1
    d.close()


def test_duplicate_dispatch_primary_fast_path():
    d = DuplicateDispatcher(deadline=1.0)
    result, winner = d.run(lambda h: h, primary=0, backup=1)
    assert winner == 0 and result == 0
    d.close()


def test_duplicate_dispatch_without_backup_blocks_out():
    d = DuplicateDispatcher(deadline=0.01)

    def slow(host):
        time.sleep(0.05)
        return host

    assert d.run(slow, primary=2) == (2, 2)
    d.close()


@pytest.mark.parametrize("times,straggler", [
    ({0: 5.0, 1: 1.0, 2: 2.0}, 0), ({0: 1.0, 1: 1.0}, 1), ({3: 1.0}, 3),
    ({0: 3.0, 1: 2.0, 2: 2.0}, 2)])
def test_pick_backup_matches_repro(times, straggler):
    from repro.distributed.straggler import pick_backup as jpick

    assert pick_backup(times, straggler) == jpick(times, straggler)


# -- compression ---------------------------------------------------------------


def _grads(seed, shape=(3, 5)):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal(shape) * 0.3).astype(np.float32),
            "b": rng.standard_normal(shape[-1]).astype(np.float32)}


def test_compress_matches_repro():
    import jax.numpy as jnp

    from repro.distributed import compression as jcomp

    g = _grads(0)
    res = _grads(1)
    res = {k: 0.01 * v for k, v in res.items()}
    jq, js, jr = jcomp.compress({k: jnp.asarray(v) for k, v in g.items()},
                                {k: jnp.asarray(v) for k, v in res.items()})
    q, s, r = compression.compress(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in res.items()})
    for k in g:
        assert q[k].dtype == torch.int8
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
        np.testing.assert_allclose(float(s[k]), float(js[k]), rtol=1e-6)
        np.testing.assert_allclose(r[k].numpy(), np.asarray(jr[k]),
                                   rtol=1e-5, atol=1e-7)
    jout = jcomp.decompress(jq, js)
    out = compression.decompress(q, s)
    for k in g:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-6)


def test_int8_compression_error_feedback():
    g = {"w": torch.tensor([[0.5, -0.25], [1.0, 0.003]])}
    res = compression.init_residual(g)
    assert res["w"].dtype == torch.float32 and not res["w"].any()
    q, s, res1 = compression.compress(g, res)
    assert q["w"].dtype == torch.int8
    out = compression.decompress(q, s)
    torch.testing.assert_close(out["w"] + res1["w"], g["w"], rtol=1e-6,
                               atol=0)


def test_compression_converges_with_feedback():
    rng = np.random.default_rng(0)
    true_sum = torch.zeros(64)
    got_sum = torch.zeros(64)
    res = {"g": torch.zeros(64)}
    for _ in range(50):
        g = {"g": torch.from_numpy(rng.standard_normal(64).astype(
            np.float32))}
        q, s, res = compression.compress(g, res)
        got_sum += compression.decompress(q, s)["g"]
        true_sum += g["g"]
    err = float((got_sum - true_sum).norm() / true_sum.norm())
    assert err < 0.02, err


def _psum_worker(rank, world_size, store, out_dir):
    import torch.distributed as dist

    world.init(rank, world_size, store)
    g = {k: torch.from_numpy(v) for k, v in _grads(10 + rank).items()}
    res = compression.init_residual(g)
    mean, new_res = compression.compressed_psum(g, res)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{f"mean_{k}": v.numpy() for k, v in mean.items()},
             **{f"res_{k}": v.numpy() for k, v in new_res.items()})
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def psum_results():
    with tempfile.TemporaryDirectory() as tmp:
        world.spawn(_psum_worker, 2, tmp, timeout=120)
        return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                for r in range(2)]


@pytest.mark.parametrize("key", ["w", "b"])
def test_compressed_psum_over_a_world_of_two(psum_results, key):
    """The mean of the members' dequantized int8 payloads, added in rank
    order: the same bits on both ranks, and each rank's residual is its
    own quantization error."""
    members = []
    for r in range(2):
        g = {k: torch.from_numpy(v) for k, v in _grads(10 + r).items()}
        q, s, res = compression.compress(g, compression.init_residual(g))
        members.append(compression.decompress(q, s)[key])
        np.testing.assert_array_equal(psum_results[r][f"res_{key}"],
                                      res[key].numpy())
    want = ((members[0] + members[1]) / 2).numpy()
    for r in range(2):
        np.testing.assert_array_equal(psum_results[r][f"mean_{key}"], want)
    g0 = _grads(10)[key] / 2 + _grads(11)[key] / 2
    np.testing.assert_allclose(want, g0, atol=0.02)


# -- elastic meshes and the production-mesh helpers ------------------------------


def test_make_mesh_of_one_and_reshard_specs_match_repro():
    """repro's test on a one-device mesh: axes that vanished are dropped,
    (pod, data) becomes data, and the placements say so."""
    from torch.distributed.tensor import Replicate, Shard

    from repro.distributed import elastic as jelastic

    plan = elastic.plan_mesh(1, model_parallel=1)
    mesh = elastic.make_mesh(plan)
    assert isinstance(mesh, ring.SoloMesh)
    assert mesh.mesh_dim_names == ("data", "model")
    specs = elastic.reshard_specs(
        {"w": (("pod", "data"), "model"), "b": (None, "pod")},
        ("pod", "data", "model"), mesh)
    assert specs["w"] == (Shard(0), Shard(1))
    assert specs["b"] == (Replicate(), Replicate())
    from jax.sharding import PartitionSpec as P

    jspecs = jelastic.reshard_specs(
        {"w": P(("pod", "data"), "model"), "b": P(None, "pod")},
        ("pod", "data", "model"), jelastic.make_mesh(
            jelastic.plan_mesh(1, model_parallel=1)))
    assert jspecs["w"].spec == P(("data",), "model")
    assert jspecs["b"].spec == P(None, None)


def test_mesh_helpers_refuse_without_a_world():
    with pytest.raises(ValueError, match="256"):
        mesh_mod.make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        mesh_mod.make_production_mesh(multi_pod=True)
    solo = ring.SoloMesh(("pod", "data", "model"))
    assert mesh_mod.batch_axes(solo) == ("pod", "data")
    assert mesh_mod.mesh_desc(solo) == "1x1x1 (pod,data,model)"


def _mesh_worker(rank, world_size, store, out_dir):
    import json

    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    world.init(rank, world_size, store)
    out = {}
    dm = elastic.make_mesh(elastic.MeshPlan((2, 2), ("data", "model")))
    pd = elastic.make_mesh(elastic.MeshPlan((2, 2), ("pod", "data")))
    small = elastic.make_mesh(elastic.MeshPlan((2,), ("data",)))
    out["dm"] = {"desc": mesh_mod.mesh_desc(dm),
                 "batch": list(mesh_mod.batch_axes(dm)),
                 "coord": dm.get_coordinate()}
    out["pd"] = {"desc": mesh_mod.mesh_desc(pd),
                 "batch": list(mesh_mod.batch_axes(pd))}
    out["small"] = {"coord": small.get_coordinate()}
    # a (pod, data, model) logical sharding after the pod axis vanished
    specs = elastic.reshard_specs(
        {"w": (("pod", "data"), "model"), "b": (None, "pod"),
         "v": ("model",)}, ("pod", "data", "model"), dm)
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    shapes = {}
    for name, pl in specs.items():
        t = full if name != "v" else full[:, 0].contiguous()
        dt = distribute_tensor(t, dm, pl)
        shapes[name] = list(dt.to_local().shape)
        # the local piece is the right block of the whole tensor
        assert torch.equal(dt.full_tensor(), t)
    out["shapes"] = shapes
    out["placements"] = {k: [repr(p) for p in v] for k, v in specs.items()}
    try:
        mesh_mod.make_production_mesh()
    except ValueError as e:
        out["production"] = str(e)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_results():
    import json

    with tempfile.TemporaryDirectory() as tmp:
        world.spawn(_mesh_worker, 4, tmp, timeout=120)
        out = []
        for r in range(4):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out


def test_make_mesh_lays_ranks_out_row_major(mesh_results):
    assert [r["dm"]["coord"] for r in mesh_results] == [
        [0, 0], [0, 1], [1, 0], [1, 1]]
    # a plan smaller than the world: ranks past the grid hold no place
    assert [r["small"]["coord"] for r in mesh_results] == [
        [0], [1], None, None]


def test_mesh_desc_and_batch_axes_on_gloo_meshes(mesh_results):
    for r in mesh_results:
        assert r["dm"]["desc"] == "2x2 (data,model)"
        assert r["dm"]["batch"] == ["data"]
        assert r["pd"]["desc"] == "2x2 (pod,data)"
        assert r["pd"]["batch"] == ["pod", "data"]


def test_reshard_specs_place_tensors_on_a_gloo_mesh(mesh_results):
    """w (8, 6) over (data, model) after pod vanished: (4, 3) a rank; b
    replicated; v (8,) sharded over model: (4,)."""
    for r in mesh_results:
        assert r["shapes"] == {"w": [4, 3], "b": [8, 6], "v": [4]}
        assert r["placements"]["b"] == ["Replicate()", "Replicate()"]


def test_production_mesh_refuses_a_world_of_four(mesh_results):
    for r in mesh_results:
        assert "256" in r["production"] and "4" in r["production"]


def test_make_mesh_refuses_a_plan_larger_than_the_world():
    """Without a world a plan of more than one device cannot be built."""
    with pytest.raises(ValueError, match="ranks"):
        elastic.make_mesh(elastic.MeshPlan((2, 2), ("data", "model")))
