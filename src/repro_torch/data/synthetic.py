"""Deterministic synthetic token batches (``repro.data.synthetic``).

A batch is a pure function of (seed, step): the generator is seeded from
both, so a restart or a re-dispatched batch is identical.  Token streams
are Zipf-distributed (low ids far more frequent, like real text).  The
ids differ from ``repro``'s for the same seed (``torch.Generator`` is not
``jax.random``); tests hand both packages the same numpy ids.  They
also differ between a CPU and a CUDA generator for the same (seed,
step), so the train launcher (``launch.train.shaped_batch``) and
``host_local_batch`` draw every global batch on the CPU, as ``repro``'s
host callback does, and then move it to the card or cut it over a mesh:
a world of any size, and one device, train on the same ids.  VLM
patches and audio frames are Gaussian stub embeddings (the frontends are
stubs, as in ``repro``), drawn in f32 after the tokens from the same
generator and cast to the activation type.  ``PrefetchLoader`` makes
step t + 1's batch on a thread while step t runs.  ``batch_pspecs``
shards a batch's rows over the batch axes (``repro``'s specs as tuples,
``models/parallel.py``), ``batch_specs`` gives the dry run's unallocated
inputs and ``host_local_batch`` the batch of (seed, step) as DTensors on
a mesh.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, check_family


def _zipf_tokens(gen: torch.Generator, shape, vocab: int,
                 alpha: float = 1.1) -> torch.Tensor:
    """Zipf-ish token ids via the inverse CDF of a bounded power law:
    p(r) ∝ r^{-alpha} on [1, V], CDF⁻¹(u) = (1 + u·(V^{1-a}−1))^{1/(1-a)}."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    a = 1.0 - alpha
    r = (1.0 + u * (float(vocab) ** a - 1.0)) ** (1.0 / a)
    r = torch.clamp(r, 1.0, float(vocab))
    return (r - 1.0).to(torch.int64)


def _generator(seed: int, step: int,
               device: "str | torch.device") -> torch.Generator:
    """The generator of batch (seed, step) on ``device``."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def lm_batch(cfg: ModelConfig, seed: int, step: int, batch: int, seq: int,
             device: "str | torch.device" = "cuda") -> Dict[str, torch.Tensor]:
    """The batch of (seed, step) on ``device``: ``{"tokens": (batch,
    seq) int64}``, with ``"patches"`` (batch, n_patches, d_model) for
    VLM and ``"frames"`` (batch, enc_frames, d_model) for audio in
    ``cfg.dtype``."""
    check_family(cfg)
    gen = _generator(seed, step, device)
    out = {"tokens": _zipf_tokens(gen, (batch, seq), cfg.vocab_size)}
    stub = {"vlm": ("patches", cfg.n_patches),
            "audio": ("frames", cfg.enc_frames)}.get(cfg.family)
    if stub is not None:
        name, rows = stub
        out[name] = torch.randn((batch, rows, cfg.d_model), generator=gen,
                                device=gen.device,
                                dtype=torch.float32).to(cfg.dtype)
    return out


class PrefetchLoader:
    """Double-buffered loader: a background thread makes the batches of
    steps ``start_step``, ``start_step + 1``, ... with ``make_batch(step)``
    and holds up to ``depth`` of them ahead of the consumer.  Iterating
    yields ``(step, batch)``; ``close`` stops the thread (also on leaving
    a ``with`` block).  A batch the maker raises on is raised to the
    consumer."""

    def __init__(self, make_batch: Callable[[int], Any], start_step: int = 0,
                 depth: int = 2):
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, self._make(step), None)
            except Exception as e:          # handed to the consumer
                item = (step, None, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[2] is not None:
                return
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch, err = self._q.get()
        if err is not None:
            raise err
        return step, batch

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def batch_pspecs(cfg: ModelConfig, batch_axes=("data",)) -> Dict[str, tuple]:
    """Rows over the batch axes; sequence and features replicated."""
    ax = tuple(batch_axes)
    specs = {"tokens": (ax, None)}
    if cfg.family == "vlm":
        specs["patches"] = (ax, None, None)
    if cfg.family == "audio":
        specs["frames"] = (ax, None, None)
    return specs


def batch_specs(cfg: ModelConfig, mesh, batch: int, seq: int,
                batch_axes=("data",)) -> Dict[str, Any]:
    """Each input's ``parallel.Abstract`` (shape, dtype, spec): the dry
    run's, nothing allocated.  Token ids are int64 (``lm_batch``'s)."""
    from repro_torch.models.parallel import Abstract

    specs = batch_pspecs(cfg, batch_axes)
    shapes = {"tokens": ((batch, seq), torch.int64)}
    if cfg.family == "vlm":
        shapes["patches"] = ((batch, cfg.n_patches, cfg.d_model), cfg.dtype)
    if cfg.family == "audio":
        shapes["frames"] = ((batch, cfg.enc_frames, cfg.d_model), cfg.dtype)
    return {k: Abstract(s, dt, specs[k]) for k, (s, dt) in shapes.items()}


def host_local_batch(cfg: ModelConfig, seed: int, step: int, batch: int,
                     seq: int, mesh, batch_axes=("data",),
                     device: "str | torch.device" = "cuda"
                     ) -> Dict[str, torch.Tensor]:
    """The batch of (seed, step) as DTensors on ``mesh``, rows over
    ``batch_axes``.  As ``repro``'s, it draws the global batch on the
    host (``lm_batch`` on the CPU: the same values on every rank) and
    keeps this rank's rows, which alone go to ``device``."""
    from repro_torch.models.parallel import shard_from_full

    specs = batch_pspecs(cfg, batch_axes)
    full = lm_batch(cfg, seed, step, batch, seq, device="cpu")
    return {k: shard_from_full(v, mesh, specs[k], device=device)
            for k, v in full.items()}


__all__ = ["lm_batch", "PrefetchLoader", "batch_pspecs", "batch_specs",
           "host_local_batch"]
