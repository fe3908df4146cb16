"""Deterministic synthetic token batches (``repro.data.synthetic``).

A batch is a pure function of (seed, step): the generator is seeded from
both, so a restart or a re-dispatched batch is identical.  Token streams
are Zipf-distributed (low ids far more frequent, like real text).  The
ids differ from ``repro``'s for the same seed (``torch.Generator`` is not
``jax.random``); tests hand both packages the same numpy ids.  The
modality stubs (VLM patches, audio frames) wait with their families
(ROADMAP A15).
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
    """The batch of (seed, step): ``{"tokens": (batch, seq) int64}`` on
    ``device``."""
    check_family(cfg)
    gen = _generator(seed, step, device)
    return {"tokens": _zipf_tokens(gen, (batch, seq), cfg.vocab_size)}


__all__ = ["lm_batch"]
