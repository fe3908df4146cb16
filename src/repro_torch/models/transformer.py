"""Decoder-only LM: forward, prefill and decode with a cache
(``repro.models.transformer``), for the SSM family.

``repro`` scans one layer body over the stacked ``layers/*`` parameters
with ``lax.scan``; here a Python loop indexes layer i of each stacked
tensor.  The cache is ``repro``'s: ``conv`` (L, B, dc-1, d_inner) in the
activation type, ``ssm`` (L, B, d_inner, N) f32 and the position
``pos``.  Layers take no positions or attention windows (the SSM
family has no attention).  ``decode_step`` writes the new states into
the cache it is given, in place (``repro``'s serving loop donates the
cache for the same reason: one copy of the state, not two) and returns
it.  Every other family raises ``NotImplementedError`` naming ROADMAP
A15.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.common import (ModelConfig, check_family,
                                       init_params, layer_params)
from repro_torch.models.layers import embed_tokens, logits_head, rmsnorm
from repro_torch.models.ssm import mamba_block, mamba_decode_step


def _norm(x, lp, key, cfg):
    return rmsnorm(x, lp[key], one_plus=cfg.rms_one_plus)


def decoder_layer(x: torch.Tensor, lp: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> torch.Tensor:
    """One layer.  ``repro``'s also returns an auxiliary loss, which only
    MoE layers make; the SSM family has none."""
    check_family(cfg)
    return x + mamba_block(_norm(x, lp, "ssm_norm", cfg), lp, cfg)


def forward_hidden(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Token ids -> final hidden states (after the final norm)."""
    check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    for i in range(cfg.n_layers):
        x = decoder_layer(x, layer_params(params, i), cfg)
    return rmsnorm(x, params["final_norm"], one_plus=cfg.rms_one_plus)


def prefill_layer(x: torch.Tensor, lp: Dict[str, torch.Tensor],
                  cfg: ModelConfig):
    """One layer of prompt processing; returns (x', cache entries)."""
    check_family(cfg)
    out, conv, ssm = mamba_block(_norm(x, lp, "ssm_norm", cfg), lp, cfg,
                                 return_state=True)
    return x + out, {"conv": conv.to(cfg.dtype), "ssm": ssm}


def prefill(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Prompt pass: (last-position logits (B, V) f32, decode cache)."""
    check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    caches = []
    for i in range(cfg.n_layers):
        x, ce = prefill_layer(x, layer_params(params, i), cfg)
        caches.append(ce)
    x = rmsnorm(x, params["final_norm"], one_plus=cfg.rms_one_plus)
    logits = logits_head(params, x[:, -1:], cfg)
    cache = {k: torch.stack([ce[k] for ce in caches]) for k in caches[0]}
    cache["pos"] = tokens.shape[1]
    return logits[:, 0], cache


def cache_spec(cfg: ModelConfig, batch: int,
               max_len: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Shapes and dtypes of the decode cache.  The SSM family's does not
    grow with ``max_len``: the conv window and the state are O(1)."""
    check_family(cfg)
    l = cfg.n_layers
    return {
        "conv": ((l, batch, cfg.ssm_conv - 1, cfg.d_inner), cfg.dtype),
        "ssm": ((l, batch, cfg.d_inner, cfg.ssm_state), torch.float32),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: "str | torch.device" = "cuda") -> Dict:
    cache = {name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt) in cache_spec(cfg, batch,
                                                  max_len).items()}
    cache["pos"] = 0
    return cache


def decode_layer(x: torch.Tensor, lp: Dict[str, torch.Tensor],
                 cache_l: Dict[str, torch.Tensor], cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode through one layer; returns (x', new states)."""
    check_family(cfg)
    out, conv, ssm = mamba_decode_step(_norm(x, lp, "ssm_norm", cfg),
                                       cache_l["conv"], cache_l["ssm"], lp,
                                       cfg)
    return x + out, {"conv": conv, "ssm": ssm}


def decode_step(params: Dict[str, torch.Tensor], cache: Dict,
                tokens: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict]:
    """One serving step: logits (B, V) f32 for the next token, and the
    cache with its states updated in place and ``pos`` advanced."""
    check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    for i in range(cfg.n_layers):
        cache_l = {k: cache[k][i] for k in ("conv", "ssm")}
        x, new = decode_layer(x, layer_params(params, i), cache_l, cfg)
        for k, v in new.items():
            cache[k][i].copy_(v)
    x = rmsnorm(x, params["final_norm"], one_plus=cfg.rms_one_plus)
    logits = logits_head(params, x, cfg)
    cache["pos"] = cache["pos"] + 1
    return logits[:, 0], cache


class LM(nn.Module):
    """The decoder as a module: holds the flat parameter dict (names as
    in ``repro``, e.g. ``layers/in_proj``) and calls the functions
    above.  Inference only: the parameters do not require gradients."""

    def __init__(self, cfg: ModelConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None, *,
                 gen: Optional[torch.Generator] = None,
                 device: "str | torch.device" = "cuda"):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, gen, device)
        self.weights = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in params.items()})

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.weights.items())

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward_hidden(self.params, tokens, self.cfg)

    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        return prefill(self.params, tokens, self.cfg)

    def init_cache(self, batch: int, max_len: int) -> Dict:
        return init_cache(self.cfg, batch, max_len,
                          self.weights["embed"].device)

    def decode_step(self, cache: Dict,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        return decode_step(self.params, cache, tokens, self.cfg)


__all__ = ["decoder_layer", "forward_hidden", "prefill_layer", "prefill",
           "cache_spec", "init_cache", "decode_layer", "decode_step", "LM"]
