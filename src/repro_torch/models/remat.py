"""Rematerialization of a layer: ``repro``'s ``jax.checkpoint`` of the
scanned layer body under ``cfg.remat == "full"``
(``repro.models.transformer._scan_layers``, ``encdec.encode`` and
``encdec_hidden``).

With grad enabled, the layer runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: its
forward saves only its inputs, and the backward runs it again to get the
activations it needs.  Without grad (serving runs under
``inference_mode``), or under ``remat == "none"``, the layer just runs.
The recomputation routes a MoE layer's tokens a second time, so it runs
under ``moe.paused()``: ``moe.recording()`` sees each layer once.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import moe
from repro_torch.models.common import ModelConfig


def remat_call(cfg: ModelConfig, fn: Callable, *args):
    """``fn(*args)``, rematerialized in the backward under
    ``cfg.remat == "full"`` when grad is enabled."""
    if cfg.remat != "full" or not torch.is_grad_enabled():
        return fn(*args)
    first = True

    def run(*a):
        nonlocal first
        if first:
            first = False
            return fn(*a)
        with moe.paused():
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


__all__ = ["remat_call"]
