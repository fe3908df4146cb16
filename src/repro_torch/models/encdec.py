"""Whisper-style encoder-decoder backbone (``repro.models.encdec``).

The audio frontend is a stub, as in ``repro``: the encoder reads
precomputed frame embeddings (B, enc_frames, d_model), adds the learned
positions ``enc_pos`` and runs a bidirectional transformer (no RoPE, no
causal mask).  The decoder is ``transformer``'s layer stack with a
cross-attention to the encoder output after its self-attention; in
serving the cross K / V are computed once per request
(``prefill_cross_cache``, or ``transformer.prefill``'s ``xk`` / ``xv``
cache entries) and read by every decode step.  The encoder's and the
cross-attention's norms are plain RMSNorm (``repro``'s too).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import ModelConfig, layer_list
from repro_torch.models.layers import embed_tokens, mlp, rmsnorm
from repro_torch.models.parallel import linear, split_heads
from repro_torch.models.remat import remat_call


def _heads(x: torch.Tensor, w: torch.Tensor, heads: int,
           cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d) @ w, split into (B, S, heads, hd)."""
    b, s, _ = x.shape
    return split_heads(linear(x, w.to(x.dtype)), heads, cfg.hd)


def encoder_layer(x: torch.Tensor, lp: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, lp["attn_norm"])
    q = _heads(h, lp["wq"], cfg.n_heads, cfg)
    k = _heads(h, lp["wk"], cfg.n_kv_heads, cfg)
    v = _heads(h, lp["wv"], cfg.n_kv_heads, cfg)
    o = attn.attention(q, k, v, causal=False)      # bidirectional, no RoPE
    x = x + linear(o.reshape(*x.shape[:-1], cfg.q_dim), lp["wo"].to(h.dtype))
    return x + mlp(rmsnorm(x, lp["mlp_norm"]), lp, cfg)


def encode(params: Dict[str, torch.Tensor], frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """Frame embeddings (B, enc_frames, d) -> encoder hidden states."""
    x = frames.to(cfg.dtype) + params["enc_pos"].to(cfg.dtype)[None]
    for lp in layer_list(params, cfg.n_enc_layers, "enc_layers/"):
        x = remat_call(cfg, encoder_layer, x, lp, cfg)
    return rmsnorm(x, params["enc_final_norm"])


def cross_kv(enc: torch.Tensor, lp: Dict[str, torch.Tensor],
             cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross K / V (B, enc_frames, Hkv, hd) of the
    encoder output."""
    return (_heads(enc, lp["xwk"], cfg.n_kv_heads, cfg),
            _heads(enc, lp["xwv"], cfg.n_kv_heads, cfg))


def cross_attend(h: torch.Tensor, lp: Dict[str, torch.Tensor],
                 xk: torch.Tensor, xv: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The cross-attention sublayer's output for the normed input ``h``:
    its queries against the cross K / V, every frame visible, through
    xwo."""
    q = _heads(h, lp["xwq"], cfg.n_heads, cfg)
    o = attn.attention(q, xk, xv, causal=False)
    return linear(o.reshape(*h.shape[:-1], cfg.q_dim), lp["xwo"].to(h.dtype))


def _cross_attend(x, lp, enc, cfg: ModelConfig) -> torch.Tensor:
    """``repro``'s name: the cross-attention to the encoder output."""
    return cross_attend(rmsnorm(x, lp["xattn_norm"]), lp,
                        *cross_kv(enc, lp, cfg), cfg)


def decoder_layer(x: torch.Tensor, lp: Dict[str, torch.Tensor],
                  enc: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, window: int) -> torch.Tensor:
    """One decoder layer of the training forward: causal self-attention,
    the cross-attention to the encoder output ``enc``, the MLP."""
    q, k, v = attn.qkv_project(rmsnorm(x, lp["attn_norm"]), lp, cfg,
                               positions)
    o = attn.attention(q, k, v, causal=True, window=window,
                       cap=cfg.attn_softcap)
    x = x + linear(o.reshape(*x.shape[:-1], cfg.q_dim), lp["wo"].to(x.dtype))
    x = x + _cross_attend(x, lp, enc, cfg)
    return x + mlp(rmsnorm(x, lp["mlp_norm"]), lp, cfg)


def encdec_hidden(params: Dict[str, torch.Tensor], frames: torch.Tensor,
                  tokens: torch.Tensor,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole encoder-decoder to the decoder's final hidden states;
    returns (h, aux), aux 0 (no router).  Each encoder and decoder layer
    is rematerialized under ``cfg.remat == "full"`` with grad enabled."""
    from repro_torch.models.transformer import layer_windows

    enc = encode(params, frames, cfg)
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp, window in zip(layer_list(params, cfg.n_layers),
                          layer_windows(cfg)):
        x = remat_call(cfg, decoder_layer, x, lp, enc, cfg, positions,
                       window)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rmsnorm(x, params["final_norm"]), aux


def prefill_cross_cache(params: Dict[str, torch.Tensor],
                        frames: torch.Tensor,
                        cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Every decoder layer's cross K / V from the encoder output, stacked
    (L, B, enc_frames, Hkv, hd) in the activation type (serving)."""
    enc = encode(params, frames, cfg)
    kvs = [cross_kv(enc, lp, cfg) for lp in layer_list(params, cfg.n_layers)]
    return {"xk": torch.stack([k for k, _ in kvs]).to(cfg.dtype),
            "xv": torch.stack([v for _, v in kvs]).to(cfg.dtype)}


__all__ = ["encoder_layer", "encode", "cross_kv", "cross_attend",
           "decoder_layer", "encdec_hidden", "prefill_cross_cache"]
