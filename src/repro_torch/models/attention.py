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

On DTensors (a registered mesh, ``models/parallel.py``) ``attention``
and ``decode_attention`` run each rank's shards through the functions
above (``_sharded_attention``, ``_sharded_decode``): q keeps its rows,
sequence (``_seq_shard_qkv``) or head sharding, K / V are laid out to
match (rows as q's, heads as q's where they divide, otherwise every KV
head on every rank, from which each rank takes those its query heads
read), and the causal and window masks take each shard's global
positions.  A decode cache whose sequence is sharded (split KV) is read
flash-decoding style: each rank's max and sums over its keys, combined
by an all-reduce over the sequence's axes.  In the backward the K / V
gradients of a rank that holds only some queries are partial sums, and
are declared so.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import softcap, wide
from repro_torch.models.parallel import is_dtensor, linear, split_heads
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
                   cap: Optional[float] = None,
                   q_offset: int = 0) -> torch.Tensor:
    """Attention of the queries at positions ``q_offset`` + 0..S_q-1
    against keys at 0..S_k-1."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    s = _scores(_group(q, hkv), k, 1.0 / math.sqrt(hd), cap)
    dev = q.device
    mask = _mask(q_offset + torch.arange(sq, device=dev),
                 torch.arange(sk, device=dev), causal=causal, window=window)
    p = torch.softmax(_masked(s, mask, g), dim=-1).to(v.dtype)
    o = torch.matmul(p, v.permute(0, 2, 1, 3))             # (B, Hkv, G·Sq, hd)
    return _ungroup(o, sq)


def _chunk_masked(q0: int, q_chunk: int, k0: int, kv_chunk: int, *,
                  causal: bool, window) -> bool:
    """Whether every key of KV chunk [k0, k0 + kv_chunk) is masked for
    every query of [q0, q0 + q_chunk): after the last query (causal) or
    at least ``window`` behind the first.  Skipping such a chunk leaves
    the online softmax's result as it is: before a row's first visible
    chunk the next correction exp(NEG_INF − m) = 0 wipes what it added,
    after one it adds exp(NEG_INF − m) = 0 times a correction of 1."""
    if causal and k0 > q0 + q_chunk - 1:
        return True
    return window is not None and q0 - (k0 + kv_chunk - 1) >= window


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window=None,
                      cap: Optional[float] = None, q_chunk: int = Q_CHUNK,
                      kv_chunk: int = KV_CHUNK,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks: O(S·chunk) memory.  Each
    query chunk walks the KV chunks in ascending order, carrying the
    running max m, the sum l and the f32 accumulator, as ``repro``'s
    ``lax.scan``; the chunks no query of it can see are skipped
    (``_chunk_masked``), which ``repro``'s scan computes and discards."""
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
        qpos = q_offset + q0 + torch.arange(q_chunk, device=dev)
        rows = g * q_chunk
        m = torch.full((b, hkv, rows), NEG_INF, dtype=wt, device=dev)
        l = torch.zeros((b, hkv, rows), dtype=wt, device=dev)
        acc = torch.zeros((b, hkv, rows, hd), dtype=wt, device=dev)
        for k0 in range(0, sk, kv_chunk):
            if _chunk_masked(q_offset + q0, q_chunk, k0, kv_chunk,
                             causal=causal, window=window):
                continue
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
              cap: Optional[float] = None,
              q_offset: int = 0) -> torch.Tensor:
    """Full attention for short sequences, chunked from
    ``CHUNKED_THRESHOLD`` on (the global lengths); DTensors through
    ``_sharded_attention``."""
    if is_dtensor(q):
        return _sharded_attention(q, k, v, causal=causal, window=window,
                                  cap=cap)
    if (q_offset + q.shape[1] >= CHUNKED_THRESHOLD
            or k.shape[1] >= CHUNKED_THRESHOLD):
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 cap=cap, q_offset=q_offset)
    return full_attention(q, k, v, causal=causal, window=window, cap=cap,
                          q_offset=q_offset)


def _kv_layout(q, hkv: int):
    """(placements of K / V, their gradients' placements, whether K / V
    hold every head while q holds some) for the DTensor ``q`` (B, S, Hq,
    hd): rows as q's; heads as q's when the KV heads divide the same
    axes, else replicated; everything else replicated.  Where q is cut
    (sequence or heads) and K / V are not, each rank's K / V gradient is
    a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    head_axes = [i for i, p in enumerate(q.placements)
                 if isinstance(p, Shard) and p.dim == 2]
    heads_ok = hkv % math.prod(mesh.size(i) for i in head_axes) == 0
    pl, grad = [], []
    for p in q.placements:
        if isinstance(p, Shard) and p.dim == 0:
            pl.append(Shard(0))
            grad.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2 and heads_ok:
            pl.append(Shard(2))
            grad.append(Shard(2))
        elif isinstance(p, Shard):
            pl.append(Replicate())
            grad.append(Partial())
        else:
            pl.append(Replicate())
            grad.append(Replicate())
    return pl, grad, bool(head_axes) and not heads_ok


def _q_placements(q):
    """q's placements with a cut head dim kept, any other cut of hd and
    any partial sum replaced by replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return [p if isinstance(p, Shard) and p.dim in (0, 1, 2) else
            Replicate() for p in q.placements]


def _local_kv_heads(kl, h0: int, hq_l: int, g: int):
    """The KV heads that query heads h0 .. h0+hq_l-1 read (h // G), one
    for each query head, from all of them."""
    idx = torch.arange(h0, h0 + hq_l, device=kl.device) // g
    return kl.index_select(2, idx)


def _sharded_attention(q, k, v, *, causal, window, cap):
    """``attention`` of DTensors: each rank's queries against the keys
    they read (module docstring); the output laid out as q."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.parallel import contiguous_stride, cut, relayout

    mesh = q.device_mesh
    hq, hkv = q.shape[2], k.shape[2]
    q = relayout(q, _q_placements(q))
    kv_pl, kv_grad, pick = _kv_layout(q, hkv)
    k, v = relayout(k, kv_pl), relayout(v, kv_pl)
    ql = q.to_local(grad_placements=q.placements)
    kl = k.to_local(grad_placements=kv_grad)
    vl = v.to_local(grad_placements=kv_grad)
    _, off = cut(q.shape, mesh, q.placements)
    if pick:
        kl = _local_kv_heads(kl, off[2], ql.shape[2], hq // hkv)
        vl = _local_kv_heads(vl, off[2], ql.shape[2], hq // hkv)
    # the global lengths choose the path, as on one device
    fn = (chunked_attention if max(q.shape[1], k.shape[1])
          >= CHUNKED_THRESHOLD else full_attention)
    o = fn(ql, kl, vl, causal=causal, window=window, cap=cap,
           q_offset=off[1])
    return DTensor.from_local(o.contiguous(), mesh, q.placements,
                              run_check=False, shape=q.shape,
                              stride=contiguous_stride(q.shape))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *, window=None,
                     cap: Optional[float] = None) -> torch.Tensor:
    """One new token's query (B, 1, Hq, hd) against the KV cache (B,
    max_len, Hkv, hd), keys past ``pos`` (and, with a window, at or
    beyond ``window`` behind it) masked.  DTensors through
    ``_sharded_decode``."""
    if is_dtensor(q):
        return _sharded_decode(q, k_cache, v_cache, pos, window=window,
                               cap=cap)
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


def cache_query_placements(cache_pl) -> list:
    """The placements a query (B, 1, Hq, hd) or a new K / V row takes
    against a cache view (B, S, Hkv, hd) laid out by ``cache_pl``: rows
    and heads as the cache's, replicated over the axes that cut the
    cache's sequence."""
    from torch.distributed.tensor import Replicate, Shard

    return [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
            for p in cache_pl]


def _sharded_decode(q, k_cache, v_cache, pos: int, *, window, cap):
    """``decode_attention`` of DTensors: each rank's query heads against
    its shard of the cache; over the axes that cut the cache's sequence
    the per-rank max, sums and outputs are combined by all-reduces
    (flash decoding).  The output is laid out as the query."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.models.parallel import contiguous_stride, cut, relayout

    mesh = k_cache.device_mesh
    cpl = list(k_cache.placements)
    q = relayout(q, cache_query_placements(cpl))
    v_cache = relayout(v_cache, cpl)
    ql, kl, vl = q.to_local(), k_cache.to_local(), v_cache.to_local()
    _, off = cut(k_cache.shape, mesh, cpl)
    seq_axes = [i for i, p in enumerate(cpl)
                if isinstance(p, Shard) and p.dim == 1]
    hkv_l = kl.shape[2]
    hd = ql.shape[-1]
    s = _scores(_group(ql, hkv_l), kl, 1.0 / math.sqrt(hd), cap)
    kpos = off[1] + torch.arange(kl.shape[1], device=ql.device)
    valid = kpos <= pos
    if window is not None:
        valid &= (pos - kpos) < window
    s.masked_fill_(~valid, NEG_INF)
    vt = vl.permute(0, 2, 1, 3)
    if not seq_axes:
        p = torch.softmax(s, dim=-1).to(vl.dtype)
        o = torch.matmul(p, vt)
    else:
        m = s.amax(dim=-1, keepdim=True)
        for i in seq_axes:
            m = funcol.all_reduce(m, "max", (mesh, i))
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, vt.to(p.dtype))
        for i in seq_axes:
            l = funcol.all_reduce(l, "sum", (mesh, i))
            o = funcol.all_reduce(o, "sum", (mesh, i))
        o = (o / l).to(vl.dtype)
    o = _ungroup(o, 1)
    return DTensor.from_local(o.contiguous(), mesh, q.placements,
                              run_check=False, shape=q.shape,
                              stride=contiguous_stride(q.shape))


def qkv_project(x: torch.Tensor, lp: dict, cfg: ModelConfig,
                positions: torch.Tensor, prefix: str = "w"):
    """Project to q / k / v heads and apply RoPE to q and k."""
    b, s, _ = x.shape
    q = split_heads(linear(x, lp[prefix + "q"].to(x.dtype)), cfg.n_heads,
                    cfg.hd)
    k = split_heads(linear(x, lp[prefix + "k"].to(x.dtype)),
                    cfg.n_kv_heads, cfg.hd)
    v = split_heads(linear(x, lp[prefix + "v"].to(x.dtype)),
                    cfg.n_kv_heads, cfg.hd)
    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   variant=cfg.rope_variant)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   variant=cfg.rope_variant)
    return q, k, v


__all__ = ["NEG_INF", "CHUNKED_THRESHOLD", "Q_CHUNK", "KV_CHUNK",
           "full_attention", "chunked_attention", "attention",
           "decode_attention", "cache_query_placements", "qkv_project"]
