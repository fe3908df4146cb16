"""Deterministic synthetic token batches (``repro.data.synthetic``).

A batch is a pure function of (seed, step): the generator is seeded from
both, so a restart or a re-dispatched batch is identical.  Token streams
are Zipf-distributed (low ids far more frequent, like real text).  The
ids differ from ``repro``'s for the same seed (``torch.Generator`` is not
``jax.random``); tests hand both packages the same numpy ids.  VLM
patches and audio frames are Gaussian stub embeddings (the frontends are
stubs, as in ``repro``), drawn in f32 after the tokens from the same
generator and cast to the activation type.
"""

from __future__ import annotations

from typing import Dict

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


__all__ = ["lm_batch"]
