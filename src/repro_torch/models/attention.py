"""GQA attention: full, chunked (online softmax) and decode
(``repro.models.attention``).

Grouped-query attention with causal and sliding-window masks, logit
softcapping (Gemma-2) and the RoPE variants.  ``repro`` computes all of
it in plain ``jnp`` (no Pallas kernel), so its counterpart here is plain
PyTorch.  What keeps the two equal:

* scores in f32: ``repro`` asks for an f32 product of the (bf16) q and k
  (``preferred_element_type``), so q and k are widened to f32 before the
  product; a bf16 product rounded afterwards moves Gemma-2's softcapped
  probabilities by 10-25%;
* the finite mask value ``NEG_INF = -1e30``: in ``chunked_attention`` a
  KV chunk wholly outside a query chunk's window gives ``p = exp(0) = 1``
  until a later valid chunk's correction ``exp(-1e30 - m) = 0`` wipes it
  out; the KV chunks are walked in ascending order, as ``lax.scan`` does;
* query head h reads KV head h // G (``reshape(b, s, hkv, g, hd)``).

``scaled_dot_product_attention`` is not used: it cannot softcap the
logits, and its numerics are not ``repro``'s.

Shapes: q (B, S, Hq, hd), k / v (B, S, Hkv, hd); G = Hq // Hkv.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import softcap, wide
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30
CHUNKED_THRESHOLD = 8192   # the online-softmax path from this S on
Q_CHUNK = 1024
KV_CHUNK = 1024


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= ``target`` (prompts that are
    not chunk multiples are still tiled exactly)."""
    target = min(target, n)
    for c in range(target, 0, -1):
        if n % c == 0:
            return c
    return 1


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) bool: key visible from query (``kpos <= qpos`` when
    causal, ``qpos - kpos < window`` when windowed)."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= (qpos[:, None] - kpos[None, :]) < window
    return m


def _group(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Sq, Hq, hd) -> (B, Hkv, G·Sq, hd): query head h = kv·G + g
    reads KV head kv, rows ordered (g, q)."""
    b, sq, hq, hd = q.shape
    g = hq // hkv
    return q.reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4).reshape(
        b, hkv, g * sq, hd)


def _ungroup(o: torch.Tensor, sq: int) -> torch.Tensor:
    """(B, Hkv, G·Sq, hd) -> (B, Sq, Hq, hd), the inverse of ``_group``."""
    b, hkv, gs, hd = o.shape
    g = gs // sq
    return o.reshape(b, hkv, g, sq, hd).permute(0, 3, 1, 2, 4).reshape(
        b, sq, hkv * g, hd)


def _scores(qg: torch.Tensor, k: torch.Tensor, scale: float,
            cap: Optional[float]) -> torch.Tensor:
    """qg (B, Hkv, G·Sq, hd), k (B, Sk, Hkv, hd) -> f32 (B, Hkv, G·Sq,
    Sk): the product of the operands widened to f32 (``layers.wide``),
    times ``scale``, softcapped.  The in-place scaling is safe under
    autograd: the product's backward reads its operands, not its
    output."""
    wt = wide(qg.dtype)
    kt = k.permute(0, 2, 3, 1).to(wt)                      # (B, Hkv, hd, Sk)
    s = torch.matmul(qg.to(wt), kt)
    s.mul_(scale)
    return softcap(s, cap)


def _masked(s: torch.Tensor, mask: torch.Tensor, g: int) -> torch.Tensor:
    """``where(mask, s, NEG_INF)`` with the (Sq, Sk) mask repeated over
    the G query groups of s's rows; in place."""
    return s.masked_fill_(~mask.repeat(g, 1), NEG_INF)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window=None,
                   cap: Optional[float] = None) -> torch.Tensor:
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    s = _scores(_group(q, hkv), k, 1.0 / math.sqrt(hd), cap)
    dev = q.device
    mask = _mask(torch.arange(sq, device=dev), torch.arange(sk, device=dev),
                 causal=causal, window=window)
    p = torch.softmax(_masked(s, mask, g), dim=-1).to(v.dtype)
    o = torch.matmul(p, v.permute(0, 2, 1, 3))             # (B, Hkv, G·Sq, hd)
    return _ungroup(o, sq)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window=None,
                      cap: Optional[float] = None, q_chunk: int = Q_CHUNK,
                      kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """Online-softmax attention over KV chunks: O(S·chunk) memory.  Each
    query chunk walks every KV chunk in ascending order, carrying the
    running max m, the sum l and the f32 accumulator, as ``repro``'s
    ``lax.scan``."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    wt = wide(q.dtype)
    q_chunk = _pick_chunk(sq, q_chunk)
    kv_chunk = _pick_chunk(sk, kv_chunk)
    dev = q.device
    vt = v.permute(0, 2, 1, 3)                             # (B, Hkv, Sk, hd)
    out = torch.empty_like(q)
    for q0 in range(0, sq, q_chunk):
        qg = _group(q[:, q0:q0 + q_chunk], hkv)
        qpos = q0 + torch.arange(q_chunk, device=dev)
        rows = g * q_chunk
        m = torch.full((b, hkv, rows), NEG_INF, dtype=wt, device=dev)
        l = torch.zeros((b, hkv, rows), dtype=wt, device=dev)
        acc = torch.zeros((b, hkv, rows, hd), dtype=wt, device=dev)
        for k0 in range(0, sk, kv_chunk):
            s = _scores(qg, k[:, k0:k0 + kv_chunk], scale, cap)
            kpos = k0 + torch.arange(kv_chunk, device=dev)
            s = _masked(s, _mask(qpos, kpos, causal=causal, window=window),
                        g)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.matmul(p.to(v.dtype).to(wt),
                              vt[:, :, k0:k0 + kv_chunk].to(wt))
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, q0:q0 + q_chunk] = _ungroup(o, q_chunk).to(q.dtype)
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window=None,
              cap: Optional[float] = None) -> torch.Tensor:
    """Full attention for short sequences, chunked from
    ``CHUNKED_THRESHOLD`` on."""
    if q.shape[1] >= CHUNKED_THRESHOLD or k.shape[1] >= CHUNKED_THRESHOLD:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 cap=cap)
    return full_attention(q, k, v, causal=causal, window=window, cap=cap)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *, window=None,
                     cap: Optional[float] = None) -> torch.Tensor:
    """One new token's query (B, 1, Hq, hd) against the KV cache (B,
    max_len, Hkv, hd), keys past ``pos`` (and, with a window, at or
    beyond ``window`` behind it) masked."""
    b, _, hq, hd = q.shape
    sk, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    s = _scores(_group(q, hkv), k_cache, 1.0 / math.sqrt(hd), cap)
    kpos = torch.arange(sk, device=q.device)
    valid = kpos <= pos
    if window is not None:
        valid &= (pos - kpos) < window
    s.masked_fill_(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.matmul(p, v_cache.permute(0, 2, 1, 3))       # (B, Hkv, G, hd)
    return _ungroup(o, 1)


def qkv_project(x: torch.Tensor, lp: dict, cfg: ModelConfig,
                positions: torch.Tensor, prefix: str = "w"):
    """Project to q / k / v heads and apply RoPE to q and k."""
    b, s, _ = x.shape
    q = (x @ lp[prefix + "q"].to(x.dtype)).reshape(b, s, cfg.n_heads, cfg.hd)
    k = (x @ lp[prefix + "k"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads,
                                                   cfg.hd)
    v = (x @ lp[prefix + "v"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads,
                                                   cfg.hd)
    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   variant=cfg.rope_variant)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   variant=cfg.rope_variant)
    return q, k, v


__all__ = ["NEG_INF", "CHUNKED_THRESHOLD", "Q_CHUNK", "KV_CHUNK",
           "full_attention", "chunked_attention", "attention",
           "decode_attention", "qkv_project"]
