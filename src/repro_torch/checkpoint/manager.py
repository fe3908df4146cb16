"""Asynchronous checkpoints with rotation (``repro.checkpoint.manager``).

``repro``'s layout, so that a checkpoint written by ``repro`` restores
into the port::

    <dir>/step_000000123/
        manifest.json      # path -> {"shape", "dtype", "key"}
        shard_<host>.npz   # one array a leaf, under keys a0, a1, ...
        _COMMITTED         # written last: a directory without it is torn

A tree is a nest of dicts whose leaves are tensors; a leaf's path joins
its keys with ``\x1f``, in sorted order.  numpy has no bfloat16, and
``repro``'s npz stores one as a 2-byte void type (``|V2``): the port
writes and reads bf16 leaves through a 16-bit integer view, so no
``ml_dtypes`` is needed and the bits are kept.  (``repro``'s own
``restore_pytree`` cannot read that type back: ``jnp.asarray`` refuses a
void array; ROADMAP C.)  ``repro``'s multi-host entries (``"sharded"``)
are still to port (the last items of ROADMAP A); restoring one raises.

``CheckpointManager.save`` snapshots the tree to host copies when it is
called and writes them on a background thread, one save in flight at a
time (the next save waits for it), so the train loop neither blocks on
the disk nor races the in-place optimizer with the writer.  After each
write the newest ``keep`` committed checkpoints stay; ``latest_step``
skips torn directories; ``restore`` places the tree on a device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import device as device_mod

_COMMIT = "_COMMITTED"
_BF16_NPZ = np.dtype("V2")     # how repro's npz holds a bfloat16 leaf


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
    """A CPU copy of a leaf that later writes to the leaf do not reach."""
    return leaf.detach().to("cpu", copy=True)


def _to_npz(t: torch.Tensor):
    """(array for the npz, dtype name for the manifest)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_NPZ), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_npz(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype))


def _write(host: Dict[str, torch.Tensor], directory: str,
           host_id: int) -> None:
    os.makedirs(directory, exist_ok=True)
    manifest, arrays = {}, {}
    for i, (path, t) in enumerate(host.items()):
        arr, dtype = _to_npz(t)
        manifest[path] = {"shape": list(arr.shape), "dtype": dtype,
                          "key": f"a{i}"}
        arrays[f"a{i}"] = arr
    np.savez(os.path.join(directory, f"shard_{host_id}.npz"), **arrays)
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(directory, _COMMIT), "w") as f:
        f.write("ok")


def save_pytree(tree: Any, directory: str, *, host_id: int = 0) -> None:
    """Synchronous save of one tree into ``directory``."""
    _write({p: _host_copy(v) for p, v in _flatten(tree).items()},
           directory, host_id)


def restore_pytree(directory: str,
                   device: "str | torch.device" = "cuda") -> Any:
    """The tree saved in ``directory``, its tensors on ``device`` (the
    card unless "cpu")."""
    dev = device_mod.resolve(device)
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    data: Dict[str, np.ndarray] = {}
    for fname in sorted(os.listdir(directory)):
        if fname.startswith("shard_") and fname.endswith(".npz"):
            with np.load(os.path.join(directory, fname)) as z:
                data.update({k: z[k] for k in z.files})
    flat = {}
    for path, meta in manifest.items():
        if meta.get("sharded"):
            raise NotImplementedError(
                f"{path}: a multi-host (sharded) entry; restoring one is "
                "still to port (ROADMAP A)")
        flat[path] = _from_npz(data[meta["key"]], meta["dtype"]).to(dev)
    return _unflatten(flat)


class CheckpointManager:
    """Asynchronous save, rotation and restore for the train loop.
    ``last_snapshot`` holds the latest save's host-snapshot time (ms)
    and bytes."""

    def __init__(self, directory: str, *, keep: int = 3, host_id: int = 0):
        self.directory = directory
        self.keep = keep
        self.host_id = host_id
        self.last_snapshot: Dict[str, float] = {}
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def committed_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, _COMMIT)):
                steps.append(int(name[5:]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Snapshot ``tree`` to host memory now; write it on the
        background thread (after the previous save has finished)."""
        self.wait()
        t0 = time.perf_counter()
        host = {p: _host_copy(v) for p, v in _flatten(tree).items()}
        self.last_snapshot = {
            "ms": (time.perf_counter() - t0) * 1e3,
            "bytes": sum(t.numel() * t.element_size() for t in host.values())}

        def work():
            _write(host, self._step_dir(step), self.host_id)
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
                step: Optional[int] = None) -> Any:
        """The tree of ``step`` (the latest committed by default) on
        ``device``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint in {self.directory}")
        return restore_pytree(self._step_dir(step), device)

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
