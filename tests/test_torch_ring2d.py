"""The port's 2-D block partition (``repro_torch.distributed.ring2d``)
against ``repro.distributed.ring2d``.

Rows shard over ``model``, train columns over (pod, data); each rank runs
one block (rectangular B1, B2 or B5; their plain versions here) and the
column partials are gathered and added in rank order.  A mesh of one
(``SoloMesh`` over (data, model)) is held against ``repro``'s ring2d on
one CPU device; worlds of 4 gloo ranks spawned on the CPU, at data 2 ×
model 2 and pod 2 × data 2 × model 1, against ``repro``'s on 8 forced
host devices in a child Python (as ``tests/test_distributed_kde.py`` runs
it).  Tolerance: rtol 2e-4 (``repro``'s bar there) with an atol of
1e-6·peak.  JAX and ``repro`` are imported inside the tests: the spawned
ranks import this module and need neither.
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import kde as tkde
from repro_torch.distributed import ring, ring2d, world

ROOT = Path(__file__).resolve().parents[1]
N, M, D, H = 256, 64, 8, 0.6
NORM = N * (2 * np.pi) ** (D / 2) * H**D


def assert_close(got, want, rtol=2e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * np.max(np.abs(want)))


def data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((M, D)).astype(np.float32))


# ---------------------------------------------------------------------------
# A mesh of one.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def solo():
    return ring.SoloMesh(("data", "model"))


@pytest.fixture(scope="module")
def jmesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))


def test_col_axes_and_pad_for_mesh(solo):
    assert ring2d.col_axes(solo) == ("data",)
    assert ring2d.col_axes(ring.SoloMesh(("pod", "data", "model"))) == (
        "pod", "data")
    x = torch.ones((5, 2))
    assert ring2d.pad_for_mesh(x, solo).shape == (5, 2)


@pytest.mark.parametrize("chunk", [32, 100, 2048])
def test_score_stats_on_a_mesh_of_one_match_repro(solo, jmesh, chunk):
    import jax.numpy as jnp

    from repro.distributed import ring2d as jring2d

    x, _ = data(1)
    js0, js1 = jring2d.ring2d_score_stats(jnp.asarray(x), jnp.asarray(x), H,
                                          mesh=jmesh, chunk=chunk)
    t = torch.from_numpy(x)
    s0, s1 = ring2d.ring2d_score_stats(t, t, H, mesh=solo, chunk=chunk)
    assert_close(s0, js0)
    assert_close(s1, js1)
    ps0, ps1 = tkde.score_stats(t, t, H)
    assert_close(s0, ps0, 1e-5)
    assert_close(s1, ps1, 1e-5)


@pytest.mark.parametrize("laplace", [False, True])
def test_kde_sums_on_a_mesh_of_one_match_repro(solo, jmesh, laplace):
    import jax.numpy as jnp

    from repro.distributed import ring2d as jring2d

    x, y = data(2)
    want = jring2d.ring2d_kde_sums(jnp.asarray(y), jnp.asarray(x), H,
                                   mesh=jmesh, chunk=32, laplace=laplace)
    got = ring2d.ring2d_kde_sums(torch.from_numpy(y), torch.from_numpy(x), H,
                                 mesh=solo, chunk=32, laplace=laplace)
    assert got.shape == (M,)
    assert_close(got, want)
    fn = tkde.laplace_kde_eval if laplace else tkde.kde_eval
    assert_close(got / NORM, fn(torch.from_numpy(x), torch.from_numpy(y), H),
                 1e-5)


@pytest.mark.parametrize("laplace_final", [False, True])
def test_sdkde_on_a_mesh_of_one_matches_repro(solo, jmesh, laplace_final):
    import jax.numpy as jnp

    from repro.distributed import ring2d as jring2d

    x, y = data(3)
    want = jring2d.ring2d_sdkde(jnp.asarray(x), jnp.asarray(y), H,
                                mesh=jmesh, chunk=32,
                                laplace_final=laplace_final)
    got = ring2d.ring2d_sdkde(torch.from_numpy(x), torch.from_numpy(y), H,
                              mesh=solo, chunk=32,
                              laplace_final=laplace_final)
    assert got.shape == (M,)
    assert_close(got, want)


# ---------------------------------------------------------------------------
# Worlds of 4 gloo ranks.
# ---------------------------------------------------------------------------

_JAX_CHILD = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core.bandwidth import gaussian_norm_const
from repro.distributed.ring2d import (ring2d_kde_sums, ring2d_score_stats,
                                      ring2d_sdkde)

out = sys.argv[1]
rng = np.random.default_rng(0)
x = rng.standard_normal((256, 8)).astype(np.float32)
y = rng.standard_normal((64, 8)).astype(np.float32)
h = 0.6
devs = np.asarray(jax.devices()[:4])
meshes = {'dm': Mesh(devs.reshape(2, 2), ('data', 'model')),
          'pdm': Mesh(devs.reshape(2, 2, 1), ('pod', 'data', 'model'))}
res = {}
for name, mesh in meshes.items():
    res[f'sdkde_{name}'] = ring2d_sdkde(jnp.asarray(x), jnp.asarray(y), h,
                                        mesh=mesh, chunk=32)
    res[f'laplace_{name}'] = ring2d_kde_sums(jnp.asarray(y), jnp.asarray(x),
                                             h, mesh=mesh, chunk=32,
                                             laplace=True)
    s0, s1 = ring2d_score_stats(jnp.asarray(x), jnp.asarray(x), h,
                                mesh=mesh, chunk=32)
    res[f's0_{name}'], res[f's1_{name}'] = s0, s1
np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
print('ALL_OK')
"""

MESHES = {"dm": ((2, 2), ("data", "model")),
          "pdm": ((2, 2, 1), ("pod", "data", "model"))}


def _world_worker(rank, world_size, store, out_dir):
    """One rank of the world of 4: ring2d at each mesh, results made whole
    (score stats and Laplace sums gathered over ``model``); rank 0 and
    rank 3 write theirs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world.init(rank, world_size, store)
    x, y = (torch.from_numpy(a) for a in data(0))
    res = {}
    for name, (shape, axes) in MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        cols = ring2d.col_axes(mesh)
        res[f"sdkde_{name}"] = ring2d.ring2d_sdkde(x, y, H, mesh=mesh,
                                                   chunk=32)
        rows_y = ring.shard_points(y, mesh, ("model",))
        rows_x = ring.shard_points(x, mesh, ("model",))
        x_cols = ring.shard_points(x, mesh, cols)
        lap = ring2d.ring2d_kde_sums(rows_y, x_cols, H, mesh=mesh, chunk=32,
                                     laplace=True)
        res[f"laplace_{name}"] = ring.gather_rows(lap, mesh, ("model",))
        s0, s1 = ring2d.ring2d_score_stats(rows_x, x_cols, H, mesh=mesh,
                                           chunk=32)
        res[f"s0_{name}"] = ring.gather_rows(s0, mesh, ("model",))
        res[f"s1_{name}"] = ring.gather_rows(s1, mesh, ("model",))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: v.numpy() for k, v in res.items()})
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world_results():
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        jpath = os.path.join(tmp, "jax.npz")
        child = subprocess.Popen([sys.executable, "-c", _JAX_CHILD, jpath],
                                 env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        try:
            world.spawn(_world_worker, 4, tmp, timeout=240)
            out, err = child.communicate(timeout=300)
        finally:
            child.kill()            # no-op once it has exited
            child.wait()
        assert "ALL_OK" in out, out + err
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(4)]
        return ranks, dict(np.load(jpath))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("what", ["sdkde", "laplace", "s0", "s1"])
def test_world_of_four_ring2d_matches_repro(world_results, mesh, what):
    ranks, jax_res = world_results
    want = jax_res[f"{what}_{mesh}"]
    for res in ranks:
        assert_close(res[f"{what}_{mesh}"][:want.shape[0]], want)


def test_world_of_four_column_sums_are_the_same_bits_on_every_rank(
        world_results):
    """The column reduction adds the gathered partials in rank order on
    every rank: replicas of a result agree bit for bit."""
    ranks, _ = world_results
    for key in ranks[0]:
        for res in ranks[1:]:
            np.testing.assert_array_equal(res[key], ranks[0][key])
