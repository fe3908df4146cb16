"""Rotary position embeddings: full-dim and half-dim (ChatGLM's 2-D)
variants (``repro.models.rope``).

The rotation pairs element i of the head dim with element i + D/2 (the
two halves), as ``repro``'s ``_rotate`` does, though its docstring says
"interleaved-pair".  Frequencies are theta^(−i/half) in f32, the angles
f32 (f64 for f64 inputs: ``layers.wide``), and the rotated values go
back to the input's type.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import wide


def _rotate(x: torch.Tensor, positions: torch.Tensor,
            theta: float) -> torch.Tensor:
    """RoPE over the whole last dim.  x: (..., S, H, D), D even;
    positions: (..., S) integers."""
    half = x.shape[-1] // 2
    wt = wide(x.dtype)
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=wt,
                                          device=x.device) / half))
    ang = positions[..., :, None].to(wt) * freqs             # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]                    # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0, variant: str = "full") -> torch.Tensor:
    """Apply RoPE.  ``variant='half'`` rotates only the first half of the
    head dim (ChatGLM's 2-D RoPE, with the same split inside that half)
    and leaves the rest as it is."""
    if variant == "half":
        d = x.shape[-1]
        rot = _rotate(x[..., : d // 2], positions, theta)
        return torch.cat([rot, x[..., d // 2:]], dim=-1)
    if variant != "full":
        raise ValueError(f"unknown RoPE variant {variant!r}")
    return _rotate(x, positions, theta)


__all__ = ["apply_rope"]
