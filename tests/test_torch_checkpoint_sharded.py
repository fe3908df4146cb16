"""Sharded checkpoints (``repro_torch.checkpoint``) on a world of 4 gloo
ranks, mesh (2, 2) over (data, model), held against the whole state and
against ``repro``'s ``restore_pytree``.

Each rank builds the same seeded state of reduced Gemma-2 (AdamW) and
reduced Kimi-K2 (Adafactor, its experts' d_ff over ``data``) in f32,
every leaf drawn at random (no zero moment hides a misplaced block), cuts
it onto the mesh by ``abstract_params`` / ``abstract_opt_state``
(``launch.steps.cut_tree``) and saves it.  A small tree adds uneven
cuts: rows 5 over ``data`` and columns 3 over ``model``, and a dim of 1
over ``data`` (one empty block).  Checks, bit for bit:

* (a) the port's ``restore_pytree`` with no layout gives the whole state;
* (b) ``repro``'s ``restore_pytree`` (CPU, ``shardings=None``) reads the
  same directories into the same arrays;
* (c) restored onto (2, 2) and onto (1, 2) (ranks 0-1), each rank's
  shard equals ``shard_from_full`` of the whole state;
* (d) the npz files hold each distinct block once;
* (e) a step directory missing a rank's file or its marker is skipped by
  ``latest_step`` on every rank, and a save whose write raised on one
  rank raises there and commits nothing;
* (f) ``repro``'s multi-host layout (``src/repro/checkpoint/
  manager.py:80-96``) loses a host's rows when two hosts write it; the
  port's layout of the same leaf does not; ``repro``'s sharded entry
  from one host restores into the port.
"""

import dataclasses
import json
import math
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.distributed import world

ARCHS = ("gemma2_2b", "kimi_k2_1t_a32b")
MESH22 = ((2, 2), ("data", "model"))
MESH12 = ((1, 2), ("data", "model"))
# the small tree: (shape, spec on a (data, model) mesh)
SMALL = {"w": ((4, 2), ("data", None)),
         "u": ((5, 3), ("data", "model")),
         "e": ((1, 4), ("data", None)),
         "step": ((), ())}


def _arch(arch_id):
    from repro_torch.configs import get_arch

    a = get_arch(arch_id)
    return dataclasses.replace(a, model=a.model.reduced(dtype=torch.float32))


def _layout(name, mesh):
    """The ``Abstract`` tree of a saved tree on ``mesh``."""
    from repro_torch.launch.steps import abstract_opt_state
    from repro_torch.models.common import abstract_params
    from repro_torch.models.parallel import Abstract

    if name == "small":
        return {k: Abstract(s, torch.int32 if k == "step" else torch.float32,
                            spec) for k, (s, spec) in SMALL.items()}
    arch = _arch(name)
    return {"params": abstract_params(arch.model, mesh),
            "opt": abstract_opt_state(arch, mesh)}


def _full(name):
    """The whole seeded tree (the same in every process)."""
    from repro_torch.launch.steps import materialize
    from repro_torch.models.parallel import MeshShape

    gen = torch.Generator().manual_seed(0)

    def make(a):
        if not a.dtype.is_floating_point:
            return torch.tensor(7, dtype=a.dtype)
        return torch.randn(a.shape, generator=gen).to(a.dtype)

    return materialize(_layout(name, MeshShape(*MESH22)), make)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _check_layout(got, full, layout, mesh, errors, what):
    from repro_torch.models.parallel import placements, shard_from_full

    fg, ff, fl = _flat(got), _flat(full), _flat(layout)
    if set(fg) != set(ff):
        errors.append(f"{what}: leaves {sorted(set(fg) ^ set(ff))}")
        return
    for k, g in fg.items():
        want = shard_from_full(ff[k], mesh, fl[k].spec)
        if list(g.placements) != placements(mesh, fl[k].spec) or not (
                torch.equal(g.to_local(), want.to_local())):
            errors.append(f"{what}: {k}")


def _worker(rank, world_size, store, out):
    import torch.distributed as dist

    from repro_torch.checkpoint import (CheckpointManager, manager,
                                        save_pytree)
    from repro_torch.distributed.elastic import MeshPlan, make_mesh
    from repro_torch.launch.steps import cut_tree

    torch.set_num_threads(1)
    world.init(rank, world_size, store)
    mesh22 = make_mesh(MeshPlan(*MESH22))
    mesh12 = make_mesh(MeshPlan(*MESH12))
    res = {"c": [], "e": [], "latest": {}}
    for name in ARCHS + ("small",):
        full = _full(name)
        state = cut_tree(_full(name), _layout(name, mesh22), mesh22, None)
        mgr = CheckpointManager(os.path.join(out, name))
        mgr.save(1, state, blocking=True)
        got = mgr.restore("cpu", layout=_layout(name, mesh22), mesh=mesh22)
        _check_layout(got, full, _layout(name, mesh22), mesh22, res["c"],
                      f"{name} (2, 2)")
        if rank < 2:
            got = mgr.restore("cpu", layout=_layout(name, mesh12),
                              mesh=mesh12)
            _check_layout(got, full, _layout(name, mesh12), mesh12,
                          res["c"], f"{name} (1, 2)")
        if name == "small":
            # (e) torn directories, then a write that raises on rank 2
            root = os.path.join(out, name)
            if rank == 0:
                src = os.path.join(root, "step_000000001")
                for step, drop in ((3, "shard_2.npz"), (4, "_COMMITTED")):
                    dst = os.path.join(root, f"step_{step:09d}")
                    shutil.copytree(src, dst)
                    os.remove(os.path.join(dst, drop))
            dist.barrier()
            res["latest"]["torn"] = mgr.latest_step()
            real = manager._write

            def failing(host, directory, fname):
                if rank == 2:
                    raise OSError("disk full (injected)")
                real(host, directory, fname)

            manager._write = failing
            try:
                mgr.save(5, state)
                mgr.wait()
                res["e"].append(f"rank {rank}: the failed save did not raise")
            except OSError as e:
                res["raised"] = f"OSError: {e}"
            except RuntimeError as e:
                res["raised"] = f"RuntimeError: {e}"
            finally:
                manager._write = real
            res["latest"]["failed"] = mgr.latest_step()
        mgr.close()
    try:
        save_pytree(state, os.path.join(out, "direct"))
        res["e"].append(f"rank {rank}: save_pytree in a world did not raise")
    except RuntimeError as e:
        res["direct"] = str(e)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def saved():
    with tempfile.TemporaryDirectory() as tmp:
        world.spawn(_worker, 4, tmp, timeout=240)
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(4)]
        yield tmp, ranks


def _step_dir(tmp, name):
    return os.path.join(tmp, name, "step_000000001")


def _assert_bitwise(got, want, what):
    assert got.dtype == want.dtype and tuple(got.shape) == tuple(
        want.shape), what
    assert np.array_equal(got.reshape(-1).view(np.uint8),
                          want.reshape(-1).view(np.uint8)), what


@pytest.mark.parametrize("name", ARCHS + ("small",))
def test_restore_without_layout_is_the_whole_state(saved, name):
    from repro_torch.checkpoint import restore_pytree

    tmp, _ = saved
    got = _flat(restore_pytree(_step_dir(tmp, name), "cpu"))
    want = _flat(_full(name))
    assert set(got) == set(want)
    for k, w in want.items():
        _assert_bitwise(got[k].numpy(), w.numpy(), f"{name} {k}")


@pytest.mark.parametrize("name", ARCHS + ("small",))
def test_repros_restore_reads_the_ports_sharded_entries(saved, name):
    from repro.checkpoint import restore_pytree as jrestore_pytree

    tmp, _ = saved
    manifest = json.load(open(os.path.join(_step_dir(tmp, name),
                                           "manifest.json")))
    assert any(m.get("sharded") for m in manifest.values())
    got = _flat(jrestore_pytree(_step_dir(tmp, name)))
    want = _flat(_full(name))
    assert set(got) == set(want)
    for k, w in want.items():
        _assert_bitwise(np.asarray(got[k]), w.numpy(), f"{name} {k}")


def test_restore_onto_another_mesh_cuts_every_leaf(saved):
    _, ranks = saved
    errors = [e for r in ranks for e in r["c"]]
    assert not errors, errors[:10]


def _distinct_blocks(shape, spec, sizes):
    """The non-empty blocks of a cut, counted from the shape: each dim in
    ceil-sized pieces over the product of its axes' sizes."""
    n = 1
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        parts = math.prod(sizes[a] for a in axes)
        n *= len(torch.arange(dim).chunk(parts)) if dim else 0
    return n


@pytest.mark.parametrize("name", ARCHS + ("small",))
def test_a_block_held_twice_is_stored_once(saved, name):
    from repro_torch.models.parallel import MeshShape

    tmp, _ = saved
    d = _step_dir(tmp, name)
    stored = 0
    for f in os.listdir(d):
        if f.endswith(".npz"):
            with np.load(os.path.join(d, f)) as z:
                stored += len(z.files)
    sizes = dict(zip(MESH22[1], MESH22[0]))
    layout = _flat(_layout(name, MeshShape(*MESH22)))
    want = 0
    for a in layout.values():
        cut = any(e is not None for e in a.spec)
        want += _distinct_blocks(a.shape, a.spec, sizes) if cut else 1
    assert stored == want
    assert json.load(open(os.path.join(d, "_COMMITTED"))) == {
        "shards": [f"shard_{r}.npz" for r in range(4)]}


def test_torn_and_failed_steps_are_skipped_on_every_rank(saved):
    tmp, ranks = saved
    assert [r["latest"] for r in ranks] == [{"torn": 1, "failed": 1}] * 4
    assert all(not r["e"] for r in ranks), [r["e"] for r in ranks]
    assert ranks[2]["raised"].startswith("OSError: disk full")
    assert all(r["raised"].startswith("RuntimeError") for i, r in
               enumerate(ranks) if i != 2)
    root = os.path.join(tmp, "small")
    assert not os.path.exists(os.path.join(root, "step_000000005",
                                           "_COMMITTED"))


def test_save_pytree_refuses_a_world(saved):
    """Within a world only the manager saves: its writer group carries
    the commit, so ``save_pytree`` raises on every rank and writes
    nothing."""
    tmp, ranks = saved
    assert all("CheckpointManager" in r["direct"] for r in ranks)
    assert all(not r["e"] for r in ranks), [r["e"] for r in ranks]
    assert not os.path.exists(os.path.join(tmp, "direct"))


def _repro_host_files(d, rows):
    """Two hosts' files for a (4, 2) f32 leaf cut in row halves, written
    as ``repro``'s ``save_pytree`` writes a non-addressable array
    (``src/repro/checkpoint/manager.py:80-96``): each host numbers its
    own shards from 0 and writes the manifest with its own index."""
    os.makedirs(d)
    for host in (0, 1):
        lo, hi = 2 * host, 2 * host + 2
        np.savez(os.path.join(d, f"shard_{host}.npz"), a0_s0=rows[lo:hi])
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump({"w": {"shape": [4, 2], "dtype": "float32",
                             "key": "a0", "sharded": True,
                             "shard_index": [[[lo, hi], [0, 2]]]}}, f)
        with open(os.path.join(d, "_COMMITTED"), "w") as f:
            f.write("ok")


def test_repros_multihost_entries_collide(saved, tmp_path):
    from repro.checkpoint import restore_pytree as jrestore_pytree
    from repro_torch.checkpoint import restore_pytree

    rows = np.arange(1, 9, dtype=np.float32).reshape(4, 2)
    _repro_host_files(str(tmp_path / "repro"), rows)
    got = np.asarray(jrestore_pytree(str(tmp_path / "repro"))["w"])
    assert np.array_equal(got[2:], rows[2:])
    assert not got[:2].any()                  # host 0's rows came back 0
    with pytest.raises(ValueError, match="cover 4 of 8"):
        restore_pytree(str(tmp_path / "repro"), "cpu")
    tmp, _ = saved
    want = _full("small")["w"].numpy()
    manifest = json.load(open(os.path.join(_step_dir(tmp, "small"),
                                           "manifest.json")))
    assert manifest["w"]["shard_index"] == [[[0, 2], [0, 2]],
                                            [[2, 4], [0, 2]]]
    got = np.asarray(jrestore_pytree(_step_dir(tmp, "small"))["w"])
    _assert_bitwise(got, want, "the port's row halves")


def test_repros_one_host_sharded_entry_restores_into_the_port(tmp_path):
    """A sharded entry as ``repro``'s ``save_pytree`` writes it from one
    host (its shards in one file, ``a0_s0`` and ``a0_s1``) restores into
    the port as ``repro``'s own restore reads it."""
    from repro.checkpoint import restore_pytree as jrestore_pytree
    from repro_torch.checkpoint import restore_pytree

    rows = np.arange(1, 9, dtype=np.float32).reshape(4, 2)
    np.savez(tmp_path / "shard_0.npz", a0_s0=rows[:2], a0_s1=rows[2:])
    (tmp_path / "manifest.json").write_text(json.dumps(
        {"w": {"shape": [4, 2], "dtype": "float32", "key": "a0",
               "sharded": True,
               "shard_index": [[[0, 2], [0, 2]], [[2, 4], [0, 2]]]}}))
    (tmp_path / "_COMMITTED").write_text("ok")
    got = restore_pytree(str(tmp_path), "cpu")["w"].numpy()
    _assert_bitwise(got, rows, "repro's one-host sharded entry")
    _assert_bitwise(np.asarray(jrestore_pytree(str(tmp_path))["w"]), rows,
                    "repro's own restore")
