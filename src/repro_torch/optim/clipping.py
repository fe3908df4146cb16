"""Global-gradient-norm clipping (``repro.optim.clipping``)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.layers import wide


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, each leaf summed in f32
    (or wider) and the leaves added in sorted name order, as
    ``jax.tree.leaves`` walks a dict."""
    total = None
    for k in sorted(tree):
        leaf = tree[k]
        sq = torch.sum(torch.square(leaf.to(wide(leaf.dtype))))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient by min(1, max_norm / max(norm, 1e-12)), in
    place (each product in f32, rounded to the gradient's type); returns
    (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads.values():
        if g.dtype == wide(g.dtype):
            g.mul_(scale)
        else:
            # a narrower gradient times the f32 scale: the product in f32,
            # rounded once (an in-place product would round the scale to
            # the gradient's type first)
            g.copy_(g.to(wide(g.dtype)) * scale)
    return grads, norm


__all__ = ["global_norm", "clip_by_global_norm"]
