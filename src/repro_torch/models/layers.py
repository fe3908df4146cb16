"""Shared building blocks: norms, MLPs, embeddings, logits
(``repro.models.layers``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig
from repro_torch.models.parallel import embedding, linear


def wide(dtype: torch.dtype) -> torch.dtype:
    """The type ``repro`` takes norms, attention scores, RoPE angles,
    logits and the loss in: float32, or ``dtype`` where it is wider, so
    that a float64 reference run stays float64 end to end (bf16 and f32
    runs are unchanged)."""
    return torch.promote_types(dtype, torch.float32)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, one_plus: bool = False,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(wide(dt))
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = w.to(x.dtype)
    scale = 1.0 + w if one_plus else w
    return (x * scale).to(dt)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(x)
    if kind in ("geglu", "gelu"):
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def mlp(x: torch.Tensor, lp: dict, cfg: ModelConfig,
        prefix: str = "") -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or plain (GELU/ReLU²) feed-forward."""
    up = linear(x, lp[prefix + "w_up"].to(x.dtype))
    if cfg.gated:
        h = _act(linear(x, lp[prefix + "w_gate"].to(x.dtype)), cfg.act) * up
    else:
        h = _act(up, cfg.act)
    return linear(h, lp[prefix + "w_down"].to(x.dtype))


def embed_tokens(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    x = embedding(params["embed"], tokens).to(cfg.dtype)
    # common convention (gemma/whisper): scale by sqrt(d)
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype)
    return x


def logits_head(params: dict, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params["embed"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    return softcap(linear(x, w).to(wide(x.dtype)), cfg.final_softcap)


__all__ = ["wide", "rmsnorm", "softcap", "mlp", "embed_tokens", "logits_head"]
