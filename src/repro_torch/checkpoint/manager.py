"""Asynchronous checkpoints with rotation, whole or as per-rank shards, and
the elastic restore (``repro.checkpoint.manager``).

``repro``'s layout, so that a checkpoint written by either package
restores into the other::

    <dir>/step_000000123/
        manifest.json      # path -> {"shape", "dtype", "key"}, and for a
                           # sharded entry "sharded": true, "shard_index"
        shard_<rank>.npz   # whole arrays under a{i}, blocks under a{i}_s{j}
        _COMMITTED         # written last: {"shards": [the world's files]}

A tree is a nest of dicts whose leaves are tensors; a leaf's path joins
its keys with ``\x1f``, in sorted order.  numpy has no bfloat16, and
``repro``'s npz stores one as a 2-byte void type (``|V2``): the port
writes and reads bf16 leaves through a 16-bit integer view, so no
``ml_dtypes`` is needed and the bits are kept.  (``repro``'s own
``restore_pytree`` cannot read that type back: ``jnp.asarray`` refuses a
void array; ROADMAP C.)

**Entries.**  A plain tensor, or a DTensor replicated on every mesh dim,
is written whole by rank 0 under ``a{i}``: ``repro``'s non-sharded
entry.  A DTensor cut on some mesh dim is a sharded entry: its distinct
non-empty blocks (``models.parallel.cut`` at every mesh coordinate, so an
uneven cut's real extents), numbered ``j`` over the whole world in the
row-major order of the mesh coordinates that first hold them.  Each
block is written once, by the lowest rank that holds it, under
``a{i}_s{j}``; ``shard_index[j]`` is its ``[[start, stop], ...]`` per
dim.  Every rank derives the same manifest from the leaf's shape,
placements and mesh, so no rank needs another's entries; rank 0 writes
it.  ``repro``'s ``restore_pytree`` reads such a directory: its keys
never collide (``repro``'s own multi-host writes do: ROADMAP C).

**Commit.**  Within a ``torch.distributed`` world every manager makes
a gloo group of its own, once, which only the thread that writes uses, so no collective of a save ever interleaves with
the training's.  A save: rank 0 clears the step's directory (a torn
attempt at the same step) and all ranks meet; each rank writes
``shard_<rank>.npz`` (under a temporary name, then renamed); the ranks
agree (all-reduce MIN) whether every write succeeded; if so rank 0
writes the manifest, then ``_COMMITTED`` naming the world's files; the
ranks meet again on the outcome, so each rank's ``wait`` returns with
the commit visible and ``latest_step`` answers the same on every rank.
A failed write leaves the step uncommitted, and ``wait`` raises on every
rank.  ``committed_steps`` counts a directory only if its marker and
every file the marker names are there.

**Snapshot.**  ``CheckpointManager.save`` copies the blocks this rank
writes (a DTensor's local shard, never the whole array) to host memory
when it is called and writes them on a background thread, one save in
flight at a time (the next save waits for it), so the train loop neither
blocks on the disk nor races the in-place optimizer with the writer.
After each write the newest ``keep`` committed checkpoints stay.

**Restore.**  Each leaf is assembled whole on the host from its blocks
(a missing block raises); with a ``layout`` (a tree of
``models.parallel.Abstract`` over ``mesh``, as ``launch.steps.
abstract_params`` / ``abstract_opt_state`` give it for the current mesh)
it is cut with ``parallel.shard_from_full`` onto ``mesh``, whatever mesh
wrote it (``repro``'s ``shardings`` argument, the elastic restart);
without one it is placed whole on ``device``.  It reads ``repro``'s
whole and sharded entries and the port's.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import json
import math
import os
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod

_COMMIT = "_COMMITTED"
_MANIFEST = "manifest.json"
_BF16_NPZ = np.dtype("V2")     # how repro's npz holds a bfloat16 leaf
_GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}\x1f"))
        return out
    out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("\x1f")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _host_copy(leaf: torch.Tensor) -> torch.Tensor:
    """A CPU copy of a plain tensor that later writes to it do not
    reach."""
    return leaf.detach().to("cpu", copy=True)


def _dtype_name(dt: torch.dtype) -> str:
    if dt == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dt).numpy().dtype)


def _torch_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=name)).dtype


def _to_npz(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_NPZ)
    return t.numpy()


def _from_npz(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype))


# ---------------------------------------------------------------------------
# Entries: which rank writes what.
# ---------------------------------------------------------------------------


def _cut_placements(leaf) -> Optional[list]:
    """A DTensor's placements if it is cut on some mesh dim; None for a
    plain tensor or a DTensor replicated everywhere.  A partial sum has
    no value to write without a reduction: it raises."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    if not isinstance(leaf, DTensor):
        return None
    pls = list(leaf.placements)
    if any(isinstance(p, Partial) for p in pls):
        raise ValueError(f"a partial DTensor ({pls}) has no value to save: "
                         "reduce it first")
    return pls if any(isinstance(p, Shard) for p in pls) else None


def _local(leaf) -> torch.Tensor:
    """A DTensor's shard on this rank; a plain tensor itself."""
    from torch.distributed.tensor import DTensor

    return leaf.to_local() if isinstance(leaf, DTensor) else leaf


def _blocks(shape, mesh, pls) -> List[Tuple[tuple, int]]:
    """The distinct non-empty blocks of a tensor of global ``shape`` cut
    by ``pls`` over ``mesh``, each with the lowest rank that holds it:
    ``[(((start, stop), ...), rank)]`` in the row-major order of the
    coordinates that first hold them."""
    from repro_torch.models import parallel

    ranks = mesh.mesh
    writer: Dict[tuple, int] = {}
    for coord in itertools.product(*(range(n) for n in ranks.shape)):
        shp, off = parallel.cut(shape, mesh, pls, coord)
        if math.prod(shp) == 0:
            continue
        idx = tuple((o, o + n) for o, n in zip(off, shp))
        r = int(ranks[coord])
        writer[idx] = min(r, writer.get(idx, r))
    return list(writer.items())


def _snapshot(tree: Any, rank: int
              ) -> Tuple[Dict[str, dict], Dict[str, torch.Tensor]]:
    """(the manifest, the host copies of what ``rank`` writes): whole
    leaves on rank 0; of a cut DTensor the blocks whose lowest holder is
    ``rank``, which are its own local shards."""
    manifest: Dict[str, dict] = {}
    host: Dict[str, torch.Tensor] = {}
    for i, (path, leaf) in enumerate(_flatten(tree).items()):
        key = f"a{i}"
        meta = {"shape": list(leaf.shape), "dtype": _dtype_name(leaf.dtype),
                "key": key}
        manifest[path] = meta
        pls = _cut_placements(leaf)
        if pls is None:
            if rank == 0:
                host[key] = _host_copy(_local(leaf))
            continue
        meta["sharded"] = True
        meta["shard_index"] = []
        for j, (idx, writer) in enumerate(
                _blocks(tuple(leaf.shape), leaf.device_mesh, pls)):
            meta["shard_index"].append([list(p) for p in idx])
            if writer == rank:
                local = leaf.to_local()
                if list(local.shape) != [b - a for a, b in idx]:
                    raise AssertionError(
                        f"{path}: rank {rank}'s shard {tuple(local.shape)} "
                        f"is not its block {idx}")
                host[f"{key}_s{j}"] = _host_copy(local)
    return manifest, host


# ---------------------------------------------------------------------------
# Writing and committing.
# ---------------------------------------------------------------------------


def _replace_into(directory: str, name: str, write) -> None:
    """``write(f)`` into ``directory/name`` through a temporary file and a
    rename: a file that exists under its name is whole."""
    tmp = os.path.join(directory, f".{name}.tmp")
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, os.path.join(directory, name))


def _write(host: Dict[str, torch.Tensor], directory: str, name: str) -> None:
    """This rank's arrays into ``directory/name``."""
    arrays = {k: _to_npz(t) for k, t in host.items()}
    _replace_into(directory, name, lambda f: np.savez(f, **arrays))


def _commit(manifest: Dict[str, dict], directory: str,
            files: List[str]) -> None:
    _replace_into(directory, _MANIFEST,
                  lambda f: f.write(json.dumps(manifest).encode()))
    _replace_into(directory, _COMMIT,
                  lambda f: f.write(json.dumps({"shards": files}).encode()))


def _in_world() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _own_group():
    """A gloo group over the whole world for the writer's collectives
    (every rank must call it, in the same order); None without a world."""
    import torch.distributed as dist

    if not _in_world():
        return None
    return dist.new_group(backend="gloo", timeout=_GROUP_TIMEOUT)


def _agree(flag: bool, group) -> bool:
    """Whether ``flag`` holds on every rank of ``group``."""
    import torch.distributed as dist

    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return bool(t.item())


def _files(host_id: int) -> Tuple[int, str, List[str]]:
    """(this process's rank, its file, every file of the step): a world's
    ranks write ``shard_<rank>.npz``; a process outside a world is rank 0
    and writes ``shard_<host_id>.npz`` (``repro``'s name)."""
    import torch.distributed as dist

    if not _in_world():
        name = f"shard_{host_id}.npz"
        return 0, name, [name]
    rank = dist.get_rank()
    files = [f"shard_{r}.npz" for r in range(dist.get_world_size())]
    return rank, files[rank], files


def _save(manifest: Dict[str, dict], host: Dict[str, torch.Tensor],
          directory: str, rank: int, name: str, files: List[str],
          group) -> None:
    """One step's files by the commit protocol (the module docstring);
    raises on every rank when the step is not committed."""
    err: Optional[BaseException] = None

    def attempt(fn) -> None:
        nonlocal err
        if err is None:
            try:
                fn()
            except Exception as e:      # decided on together below
                err = e

    if rank == 0:
        shutil.rmtree(directory, ignore_errors=True)
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group=group)
    attempt(lambda: os.makedirs(directory, exist_ok=True))
    attempt(lambda: _write(host, directory, name))
    written = err is None if group is None else _agree(err is None, group)
    if written and rank == 0:
        attempt(lambda: _commit(manifest, directory, files))
    done = err is None if group is None else _agree(err is None, group)
    if err is not None:
        raise err
    if not done:
        raise RuntimeError(f"{directory}: another rank's write failed; the "
                           "step is not committed")


def save_pytree(tree: Any, directory: str, *, host_id: int = 0) -> None:
    """Synchronous save of one tree into ``directory`` by a process
    outside a world, as ``shard_<host_id>.npz``.  Within a world it
    raises: the ranks save through one ``CheckpointManager``, whose
    writer group carries the commit."""
    if _in_world():
        raise RuntimeError("save_pytree is for one process; within a "
                           "torch.distributed world every rank saves "
                           "through one CheckpointManager")
    rank, name, files = _files(host_id)
    manifest, host = _snapshot(tree, rank)
    _save(manifest, host, directory, rank, name, files, None)


# ---------------------------------------------------------------------------
# Reading.
# ---------------------------------------------------------------------------


def _marker_files(directory: str) -> Optional[List[str]]:
    """The files a commit marker names; None for ``repro``'s marker
    (which names none) or no marker."""
    try:
        with open(os.path.join(directory, _COMMIT)) as f:
            text = f.read()
    except FileNotFoundError:
        return None
    try:
        return list(json.loads(text)["shards"])
    except (ValueError, KeyError, TypeError):
        return None


def _is_committed(directory: str) -> bool:
    """Whether ``directory`` holds a whole step: its marker, and every
    file the marker names."""
    if not os.path.exists(os.path.join(directory, _COMMIT)):
        return False
    files = _marker_files(directory)
    return files is None or all(
        os.path.exists(os.path.join(directory, f)) for f in files)


class _Arrays:
    """A step's arrays by key, each read from its file when asked for (a
    key in two files: the later file's, as ``repro``'s merge)."""

    def __init__(self, npz: list):
        self._where = {k: z for z in npz for k in z.files}

    def __getitem__(self, key: str) -> np.ndarray:
        return self._where[key][key]


def _assemble(meta: dict, arrays: _Arrays) -> torch.Tensor:
    """One leaf, whole, on the host: a whole entry as it is; a sharded
    one from its blocks, which must cover it."""
    if not meta.get("sharded"):
        return _from_npz(arrays[meta["key"]], meta["dtype"])
    full = torch.zeros(meta["shape"], dtype=_torch_dtype(meta["dtype"]))
    seen = set()
    for j, idx in enumerate(meta["shard_index"]):
        idx = tuple(tuple(p) for p in idx)
        block = _from_npz(arrays[f"{meta['key']}_s{j}"], meta["dtype"])
        full[tuple(slice(a, b) for a, b in idx)] = block
        seen.add(idx)
    covered = sum(math.prod(b - a for a, b in idx) for idx in seen)
    if covered != full.numel():
        raise ValueError(f"{meta['key']}: its blocks cover {covered} of "
                         f"{full.numel()} elements (a shard file is missing,"
                         " or two hosts wrote the same keys: ROADMAP C)")
    return full


def restore_pytree(directory: str, device: "str | torch.device" = "cuda",
                   *, layout: Any = None, mesh=None) -> Any:
    """The tree saved in ``directory``.  With ``layout`` (a tree of
    ``models.parallel.Abstract``, the same paths) each leaf is cut onto
    ``mesh`` by its spec, this rank's shard on ``device``; leaves the
    layout does not name, and every leaf without one, are whole on
    ``device`` (the card unless "cpu")."""
    from repro_torch.models import parallel

    dev = device_mod.resolve(device)
    want = _flatten(layout) if layout is not None else {}
    if want and mesh is None:
        raise ValueError("a layout needs the mesh it is laid out over")
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)
    missing = set(want) - set(manifest)
    if missing:
        raise ValueError(f"{directory} holds no leaf {sorted(missing)}")
    files = _marker_files(directory)
    if files is None:
        files = sorted(n for n in os.listdir(directory)
                       if n.startswith("shard_") and n.endswith(".npz"))
    flat = {}
    with contextlib.ExitStack() as stack:
        arrays = _Arrays([stack.enter_context(np.load(
            os.path.join(directory, n))) for n in files])
        for path, meta in manifest.items():
            full = _assemble(meta, arrays)
            a = want.get(path)
            if a is None:
                flat[path] = full.to(dev)
                continue
            if tuple(a.shape) != tuple(full.shape) or a.dtype != full.dtype:
                raise ValueError(f"{path}: saved {tuple(full.shape)} "
                                 f"{full.dtype}, the layout wants "
                                 f"{tuple(a.shape)} {a.dtype}")
            flat[path] = parallel.shard_from_full(full, mesh, a.spec, dev)
            del full
    return _unflatten(flat)


# ---------------------------------------------------------------------------
# The manager.
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Asynchronous save, rotation and restore for the train loop, on one
    process or on every rank of a world (which must all construct it at
    the same point: it makes the writer's gloo group).
    ``last_snapshot`` holds the latest save's host-snapshot time (ms)
    and the bytes of this rank's share."""

    def __init__(self, directory: str, *, keep: int = 3, host_id: int = 0):
        self.directory = directory
        self.keep = keep
        self.host_id = host_id
        self.last_snapshot: Dict[str, float] = {}
        self._rank, self._name, self._files = _files(host_id)
        self._group = _own_group()
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def committed_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and _is_committed(
                    os.path.join(self.directory, name)):
                steps.append(int(name[5:]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Snapshot this rank's share of ``tree`` to host memory now;
        write it on the background thread (after the previous save has
        finished).  Every rank of a world calls it with the same step."""
        self.wait()
        t0 = time.perf_counter()
        manifest, host = _snapshot(tree, self._rank)
        self.last_snapshot = {
            "ms": (time.perf_counter() - t0) * 1e3,
            "bytes": sum(t.numel() * t.element_size() for t in host.values())}

        def work():
            _save(manifest, host, self._step_dir(step), self._rank,
                  self._name, self._files, self._group)
            if self._rank == 0:
                self._rotate()

        self._pending = self._pool.submit(work)
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Wait for the save in flight; raises what its write raised."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def restore(self, device: "str | torch.device" = "cuda",
                step: Optional[int] = None, *, layout: Any = None,
                mesh=None) -> Any:
        """The tree of ``step`` (the latest committed by default) on
        ``device``, or cut onto ``mesh`` by ``layout``
        (``restore_pytree``)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint in {self.directory}")
        return restore_pytree(self._step_dir(step), device, layout=layout,
                              mesh=mesh)

    def close(self) -> None:
        """Finish the save in flight and stop the writer thread."""
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def _rotate(self) -> None:
        with self._lock:
            for s in self.committed_steps()[:-self.keep]:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)


__all__ = ["CheckpointManager", "save_pytree", "restore_pytree"]
