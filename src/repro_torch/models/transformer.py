"""Decoder LM: forward, prefill and decode with a cache
(``repro.models.transformer``), for every family of ``repro``'s.

``repro`` scans one layer body over the stacked ``layers/*`` parameters
with ``lax.scan``; here a Python loop walks the layers' views of the
stacked tensors (``common.layer_list``), and each layer's attention window is a Python int
(``layer_windows``: Gemma-2's even layers local, odd ones global, a
global window being ``GLOBAL_WINDOW``).  The families:

* ssm (Falcon-Mamba): x + Mamba(norm(x));
* dense (Gemma-2, Minitron, Phi-3, ChatGLM3): x + attention(norm(x)),
  then x + MLP(norm(x)), each sublayer's output normed again under
  ``post_norms`` (Gemma-2's sandwich norms);
* hybrid (Hymba): attention and the Mamba block read the same normed
  input, and x + fuse_attn_scale·attention + fuse_ssm_scale·norm(Mamba),
  then the MLP;
* moe (Granite-MoE, Kimi-K2): the dense layer with ``models/moe.py``'s
  routed experts in place of the MLP; each layer also returns the
  router's auxiliary loss, which ``forward_hidden`` sums (training reads
  it; serving drops it);
* vlm (LLaVA-NeXT): the dense layers over the projected patch embeddings
  (``patch_proj``) followed by the tokens;
* audio (Whisper): the encoder (``models/encdec.py``) runs once, each
  decoder layer adds a cross-attention to its output after the
  self-attention, and the cache carries each layer's cross K / V.

The cache is ``repro``'s: ``k`` / ``v`` (L, B, max_len, Hkv, hd) in the
activation type (int8 with ``k_scale`` / ``v_scale`` (L, B, max_len,
Hkv) f32 under ``kv_quant``) unless the model is attention-free;
``conv`` (L, B, dc-1, d_inner) and ``ssm`` (L, B, d_inner, N) f32 for
the SSM and hybrid families; ``xk`` / ``xv`` (L, B, enc_frames, Hkv, hd)
for audio; and the position ``pos``.  After a VLM prefill ``pos`` is
n_patches + S, the positions the cache holds.  ``repro``'s ``prefill``
sets S, so its first decode step takes RoPE position S, overwrites the
K / V the prefill wrote there and masks every position after it
(ROADMAP C); the port does not copy that.  ``decode_step`` writes the
new position's K / V (and scales) and the new SSM states into the cache
it is given, in place (``repro``'s serving loop donates the cache for
the same reason: one copy, not two), and returns it.
Under a mesh registered in ``models/parallel.py`` the layers run on
DTensors and take ``repro``'s hints, each a no-op without one: the
training forward shards attention's Q and output over the sequence on
``model`` when the heads do not divide that axis (``_seq_shard_qkv``,
Kimi-K2 by its ``seq_shard_attn`` override), and every FFN sublayer
first gathers its input over ``model``.  ``models/attention.py`` runs
the attention of sharded q / k / v on each rank's shards.

Training: ``loss_fn`` (``lm_loss``'s chunked vocab cross-entropy plus
0.01 × the MoE aux loss) is differentiated by ``launch.steps``.  The
forward unbinds each stacked ``layers/*`` tensor once
(``common.layer_list``) and, under ``cfg.remat == "full"`` with grad
enabled, recomputes each layer in the backward (``models/remat.py``, as
``repro``'s ``jax.checkpoint``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import (ModelConfig, check_family,
                                       init_params, layer_list)
from repro_torch.models.encdec import (cross_attend, cross_kv, encdec_hidden,
                                       encode)
from repro_torch.models.layers import (embed_tokens, logits_head, mlp,
                                       rmsnorm, wide)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.parallel import (axis_sizes, get_mesh, hint,
                                         is_dtensor, linear, relayout,
                                         split_heads)
from repro_torch.models.remat import remat_call
from repro_torch.models.ssm import mamba_block, mamba_decode_step

GLOBAL_WINDOW = 2**30     # a window no key reaches past: global attention


def layer_windows(cfg: ModelConfig,
                  n_layers: Optional[int] = None) -> List[int]:
    """Each layer's attention window: Gemma-2's even layers local
    (``sliding_window``), odd ones global; every layer the window when
    only ``sliding_window`` is set; else global."""
    n = n_layers or cfg.n_layers
    if cfg.local_global_alt and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else GLOBAL_WINDOW
                for i in range(n)]
    return [cfg.sliding_window or GLOBAL_WINDOW] * n


def _norm(x, lp, key, cfg):
    return rmsnorm(x, lp[key], one_plus=cfg.rms_one_plus)


def seq_shard_attn(cfg: ModelConfig, mesh) -> bool:
    """Whether the training forward shards attention over the sequence
    on ``mesh``: ``cfg.seq_shard_attn``, or when unset whether the head
    count leaves the ``model`` axis indivisible (``repro``'s rule: 8, 20,
    24, 25 or 56 heads on 16 ranks)."""
    use = cfg.seq_shard_attn
    if use is None:
        use = cfg.n_heads % axis_sizes(mesh)["model"] != 0
    return bool(use)


def _seq_shard_qkv(q, k, v, cfg: ModelConfig):
    """Under a registered mesh and ``seq_shard_attn``: Q over the sequence
    on ``model`` and K / V replicated over it, rows over the batch axes,
    so that every (S_loc × S) score tile stays on its rank (``repro``'s
    §Perf fix).  Returns the inputs themselves otherwise."""
    mesh = get_mesh()
    if mesh is None or not seq_shard_attn(cfg, mesh):
        return q, k, v
    return (hint(q, "dp", "model", None, None),
            hint(k, "dp", None, None, None),
            hint(v, "dp", None, None, None))


def _attend(h, lp, cfg, positions, window, seq_shard=False):
    """Self-attention over the normed input ``h``, projected through wo;
    returns (output, k, v), k and v being the cache's entries.  With
    ``seq_shard`` (the training forward) Q is laid out by
    ``_seq_shard_qkv`` and the output hinted back to it."""
    q, k, v = attn.qkv_project(h, lp, cfg, positions)
    q2, k2, v2 = _seq_shard_qkv(q, k, v, cfg) if seq_shard else (q, k, v)
    o = attn.attention(q2, k2, v2, causal=True, window=window,
                       cap=cfg.attn_softcap)
    if q2 is not q:
        o = hint(o, "dp", "model", None, None)
    return linear(o.reshape(*h.shape[:-1], cfg.q_dim),
                  lp["wo"].to(h.dtype)), k, v


def _attn_sublayer(x, lp, cfg, positions, window, seq_shard=False):
    o, k, v = _attend(_norm(x, lp, "attn_norm", cfg), lp, cfg, positions,
                      window, seq_shard)
    if cfg.post_norms:
        o = _norm(o, lp, "post_attn_norm", cfg)
    return o, k, v


def _ffn_sublayer(x, lp, cfg):
    """The FFN sublayer's (output, aux): the MLP (aux None), or for MoE
    the routed experts over the flattened tokens and their aux loss.
    Under a mesh its input is first gathered over ``model`` (``repro``:
    with sequence-sharded activations GSPMD gathered the (d, d_ff)
    weights instead)."""
    x = hint(x, "dp", None, None)
    h = _norm(x, lp, "mlp_norm", cfg)
    if cfg.family == "moe":
        b, s, d = h.shape
        out, aux = moe_ffn(h.reshape(b * s, d), lp, cfg)
        out = out.reshape(b, s, d)
    else:
        out, aux = mlp(h, lp, cfg), None
    if cfg.post_norms:
        out = _norm(out, lp, "post_mlp_norm", cfg)
    return out, aux


def _fuse(x, lp, a, s, cfg):
    """The hybrid's residual: x + fuse_attn_scale·a + fuse_ssm_scale·s',
    s' the Mamba output normed with the layer's ``ssm_norm``."""
    s = rmsnorm(s, lp["ssm_norm"], one_plus=cfg.rms_one_plus)
    return x + (lp["fuse_attn_scale"].to(x.dtype) * a
                + lp["fuse_ssm_scale"].to(x.dtype) * s)


def decoder_layer(x: torch.Tensor, lp: Dict[str, torch.Tensor],
                  cfg: ModelConfig, positions: torch.Tensor,
                  window: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer; returns (x', aux), aux the MoE router's loss (None for
    the other families, where ``repro``'s is 0)."""
    if cfg.family == "ssm":
        return x + mamba_block(_norm(x, lp, "ssm_norm", cfg), lp, cfg), None
    if cfg.family == "hybrid":
        h = _norm(x, lp, "attn_norm", cfg)
        a, _, _ = _attend(h, lp, cfg, positions, window, seq_shard=True)
        x = _fuse(x, lp, a, mamba_block(h, lp, cfg), cfg)
    else:
        o, _, _ = _attn_sublayer(x, lp, cfg, positions, window,
                                 seq_shard=True)
        x = x + o
    out, aux = _ffn_sublayer(x, lp, cfg)
    return x + out, aux


def _embed(params, tokens, cfg, patches):
    """The token embeddings, after the projected patch embeddings for
    VLM (which needs ``patches`` (B, n_patches, d))."""
    x = embed_tokens(params, tokens, cfg)
    if cfg.family != "vlm":
        return x
    if patches is None:
        raise ValueError(f"{cfg.name}: a VLM forward needs the patch "
                         "embeddings (patches=)")
    p = linear(patches.to(cfg.dtype), params["patch_proj"].to(cfg.dtype))
    return torch.cat([p, x], dim=1)


def forward_hidden(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   cfg: ModelConfig, *,
                   patches: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids (after the patch prefix for VLM) -> (final hidden
    states after the final norm, the layers' summed aux loss f32).  The
    audio family's forward is ``encdec.encdec_hidden``: ``repro``'s
    ``forward_hidden`` would run its decoder without the cross-attention,
    so this one raises for it."""
    check_family(cfg)
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name}: the encoder-decoder's forward is "
                         "models.encdec.encdec_hidden (it needs frames)")
    x = _embed(params, tokens, cfg, patches)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    windows = layer_windows(cfg)
    for lp, window in zip(layer_list(params, cfg.n_layers), windows):
        x, a = remat_call(cfg, decoder_layer, x, lp, cfg, positions, window)
        if a is not None:
            aux = aux + a
    return rmsnorm(x, params["final_norm"], one_plus=cfg.rms_one_plus), aux


def lm_loss(params: Dict[str, torch.Tensor], hidden: torch.Tensor,
            targets: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of ``hidden`` (B, S, d) against
    ``targets`` (B, S), the vocab product taken ``cfg.loss_chunk``
    positions at a time: the (B, chunk, V) f32 logits are the temporary.
    As in ``repro``, a chunk that does not divide S (or 0) takes the
    whole sequence at once: at S − 1 = 1023 or 4095 and the default 512,
    that is every assigned training shape."""
    b, s, _ = hidden.shape
    chunk = min(cfg.loss_chunk or s, s)
    if s % chunk:
        chunk = s
    tot = torch.zeros((), dtype=wide(hidden.dtype), device=hidden.device)
    for c0 in range(0, s, chunk):
        logits = logits_head(params, hidden[:, c0:c0 + chunk], cfg)
        if _vocab_cut(logits):
            tot = tot + torch.sum(_vocab_parallel_nll(
                logits, targets[:, c0:c0 + chunk]))
            continue
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[:, c0:c0 + chunk, None])
        tot = tot + torch.sum(logz - gold[..., 0])
    return tot / (b * s)


def _vocab_cut(logits) -> bool:
    """Whether DTensor ``logits`` have their vocab cut over more than one
    rank (a mesh dim of size 1 cuts nothing: the plain formula then runs
    on each rank's whole vocab)."""
    from torch.distributed.tensor import Shard

    if not is_dtensor(logits):
        return False
    last = logits.ndim - 1
    return any(isinstance(p, Shard) and p.dim == last
               and logits.device_mesh.size(i) > 1
               for i, p in enumerate(logits.placements))


def _vocab_parallel_nll(logits, targets):
    """logsumexp(logits) − logits[target] for DTensor logits whose vocab
    is cut over ``model``, on each rank's shard (Megatron's vocab-parallel
    cross-entropy): the rows' max over the vocab (no gradient, as in
    logsumexp's own backward) and, as partial sums completed by
    all-reduces, the sum of exp(logits − max) and the target's logit
    (from the rank that holds it).  The cut vocab is never gathered, and
    no (B, chunk, V) tensor leaves its rank (DTensor's strategies for the
    same ops replicate rows cut over (pod, data))."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models.parallel import contiguous_stride, cut

    mesh = logits.device_mesh
    last = logits.ndim - 1
    pl = [p if isinstance(p, Shard) else Replicate()
          for p in logits.placements]
    logits = relayout(logits, pl)
    vocab = [i for i, p in enumerate(pl) if p == Shard(last)]
    t_pl = [Replicate() if i in vocab else p for i, p in enumerate(pl)]
    targets = relayout(targets, t_pl)
    ll = logits.to_local(grad_placements=pl)
    tl = targets.to_local()
    _, off = cut(logits.shape, mesh, pl)
    m = ll.detach().amax(dim=-1, keepdim=True)
    for i in vocab:
        m = funcol.all_reduce(m, "max", (mesh, i))
    m = m * 1                       # wait for the collective
    sumexp = torch.exp(ll - m).sum(dim=-1)
    rel = tl - off[last]
    hit = (rel >= 0) & (rel < ll.shape[-1])
    gold = torch.gather(ll, -1, rel.clamp(0, ll.shape[-1] - 1)[..., None])
    gold = gold[..., 0] * hit.to(ll.dtype)
    shape, stride = targets.shape, contiguous_stride(targets.shape)
    part = [Partial() if i in vocab else p for i, p in enumerate(t_pl)]

    def whole(t, pls):
        d = DTensor.from_local(t, mesh, pls, run_check=False, shape=shape,
                               stride=stride)
        return relayout(d, t_pl)

    return (whole(m[..., 0], t_pl) + torch.log(whole(sumexp, part))
            - whole(gold, part))


def loss_fn(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """Next-token LM loss over ``batch`` (``{"tokens"}``, with
    ``"patches"`` for VLM and ``"frames"`` for audio), plus 0.01 × the
    MoE routers' aux loss.  The targets are the tokens rolled one to the
    left, the last position dropped; the VLM loss counts only the text
    positions after the patch prefix."""
    tokens = batch["tokens"]
    if cfg.family == "audio":
        hidden, aux = encdec_hidden(params, batch["frames"], tokens, cfg)
    else:
        hidden, aux = forward_hidden(params, tokens, cfg,
                                     patches=batch.get("patches"))
        hidden = hidden[:, -tokens.shape[1]:]
    # each position's target is the next token (the last position has
    # none): ``repro``'s roll by one, its wrapped last column dropped
    loss = lm_loss(params, hidden[:, :-1], tokens[:, 1:], cfg)
    return loss + 0.01 * aux


def prefill_layer(x: torch.Tensor, lp: Dict[str, torch.Tensor],
                  cfg: ModelConfig, positions: torch.Tensor, window: int, *,
                  enc: Optional[torch.Tensor] = None):
    """One layer of prompt processing; returns (x', cache entries): the
    layer's K / V after RoPE, the SSM family's and the hybrid's conv
    window and state at the end of the prompt, and for audio the cross
    K / V of the encoder output ``enc``."""
    if cfg.family == "ssm":
        out, conv, ssm = mamba_block(_norm(x, lp, "ssm_norm", cfg), lp, cfg,
                                     return_state=True)
        return x + out, {"conv": conv.to(cfg.dtype), "ssm": ssm}
    if cfg.family == "hybrid":
        h = _norm(x, lp, "attn_norm", cfg)
        a, k, v = _attend(h, lp, cfg, positions, window)
        s, conv, ssm = mamba_block(h, lp, cfg, return_state=True)
        x = _fuse(x, lp, a, s, cfg)
        return x + _ffn_sublayer(x, lp, cfg)[0], {
            "k": k, "v": v, "conv": conv.to(cfg.dtype), "ssm": ssm}
    o, k, v = _attn_sublayer(x, lp, cfg, positions, window)
    x = x + o
    ce = {"k": k, "v": v}
    if cfg.family == "audio":
        ce["xk"], ce["xv"] = cross_kv(enc, lp, cfg)
        x = x + cross_attend(_norm(x, lp, "xattn_norm", cfg), lp, ce["xk"],
                             ce["xv"], cfg)
    return x + _ffn_sublayer(x, lp, cfg)[0], ce


def prefill(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            cfg: ModelConfig, *, patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """Prompt pass: (last-position logits (B, V) f32, decode cache).  VLM
    needs ``patches`` (B, n_patches, d), audio ``frames`` (B, enc_frames,
    d).  The cache's max_len is the positions processed (the patch
    prefix included), and so is ``pos``; ``launch.serve.generate``
    copies it into a longer one to decode."""
    check_family(cfg)
    x = _embed(params, tokens, cfg, patches)
    enc = None
    if cfg.family == "audio":
        if frames is None:
            raise ValueError(f"{cfg.name}: an audio prefill needs the frame "
                             "embeddings (frames=)")
        enc = encode(params, frames, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    caches = []
    for lp, window in zip(layer_list(params, cfg.n_layers),
                          layer_windows(cfg)):
        x, ce = prefill_layer(x, lp, cfg, positions, window, enc=enc)
        caches.append(ce)
    x = rmsnorm(x, params["final_norm"], one_plus=cfg.rms_one_plus)
    logits = logits_head(params, x[:, -1:], cfg)
    cache = {}
    for k in list(caches[0]):
        cache[k] = torch.stack([ce.pop(k) for ce in caches])
    cache["pos"] = x.shape[1]
    return logits[:, 0], cache


def cache_spec(cfg: ModelConfig, batch: int,
               max_len: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Shapes and dtypes of the decode cache.  The SSM states do not grow
    with ``max_len``; the KV cache does."""
    check_family(cfg)
    l, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    spec: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if not cfg.attn_free:
        kv_dt = torch.int8 if cfg.kv_quant else cfg.dtype
        spec["k"] = ((l, batch, max_len, hkv, hd), kv_dt)
        spec["v"] = ((l, batch, max_len, hkv, hd), kv_dt)
        if cfg.kv_quant:
            spec["k_scale"] = ((l, batch, max_len, hkv), torch.float32)
            spec["v_scale"] = ((l, batch, max_len, hkv), torch.float32)
    if cfg.family in ("ssm", "hybrid"):
        spec["conv"] = ((l, batch, cfg.ssm_conv - 1, cfg.d_inner), cfg.dtype)
        spec["ssm"] = ((l, batch, cfg.d_inner, cfg.ssm_state),
                       torch.float32)
    if cfg.family == "audio":
        spec["xk"] = ((l, batch, cfg.enc_frames, hkv, hd), cfg.dtype)
        spec["xv"] = ((l, batch, cfg.enc_frames, hkv, hd), cfg.dtype)
    return spec


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: "str | torch.device" = "cuda") -> Dict:
    cache = {name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt) in cache_spec(cfg, batch,
                                                  max_len).items()}
    cache["pos"] = 0
    return cache


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (position, head): the scale max|x| / 127 (at
    least 1e-12), values rounded half to even and clipped to ±127."""
    xf = x.to(torch.float32)
    s = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-12)
    q8 = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q8.to(torch.int8), s


def _write_position(cache_t, pos: int, new) -> None:
    """``cache_t[:, pos] = new`` for a DTensor cache view (B, S, Hkv, hd)
    and row (B, 1, Hkv, hd): the row laid out as the cache's rows and
    heads, written by the ranks whose sequence shard holds ``pos``."""
    from repro_torch.models.parallel import cut

    new = new.redistribute(new.device_mesh, attn.cache_query_placements(
        cache_t.placements))
    shp, off = cut(cache_t.shape, cache_t.device_mesh, cache_t.placements)
    if off[1] <= pos < off[1] + shp[1]:
        local = cache_t.to_local()
        local[:, pos - off[1]] = new.to_local()[:, 0].to(local.dtype)


def _decode_attend(h, lp, cache_l, cfg, positions, pos, window):
    """The new token's attention: its K / V (quantized under
    ``kv_quant``) written at ``pos`` of the layer's cache, in place, then
    its query against the cache, projected through wo.  A DTensor cache
    (under a mesh) is written shard-locally (``_write_position``); a
    quantized one is refused there."""
    q, k, v = attn.qkv_project(h, lp, cfg, positions)
    if is_dtensor(cache_l["k"]):
        if cfg.kv_quant:
            raise NotImplementedError(
                f"{cfg.name}: an int8 KV cache on a mesh (no assigned "
                "configuration sets kv_quant)")
        _write_position(cache_l["k"], pos, k)
        _write_position(cache_l["v"], pos, v)
        o = attn.decode_attention(q, cache_l["k"], cache_l["v"], pos,
                                  window=window, cap=cfg.attn_softcap)
        return linear(o.reshape(h.shape[0], 1, cfg.q_dim),
                      lp["wo"].to(h.dtype))
    if cfg.kv_quant:
        for name, t in (("k", k), ("v", v)):
            t8, ts = _quant(t)
            cache_l[name][:, pos] = t8[:, 0]
            cache_l[name + "_scale"][:, pos] = ts[:, 0]
        k_full, v_full = (
            cache_l[n].to(h.dtype) * cache_l[n + "_scale"][..., None].to(
                h.dtype) for n in ("k", "v"))
    else:
        cache_l["k"][:, pos] = k[:, 0].to(cache_l["k"].dtype)
        cache_l["v"][:, pos] = v[:, 0].to(cache_l["v"].dtype)
        k_full, v_full = cache_l["k"], cache_l["v"]
    o = attn.decode_attention(q, k_full, v_full, pos, window=window,
                              cap=cfg.attn_softcap)
    return linear(o.reshape(h.shape[0], 1, cfg.q_dim), lp["wo"].to(h.dtype))


def _decode_ssm(h, lp, cache_l, cfg):
    """The Mamba block's step: the new conv window and state copied into
    the layer's cache, in place."""
    out, conv, ssm = mamba_decode_step(h, cache_l["conv"], cache_l["ssm"],
                                       lp, cfg)
    cache_l["conv"].copy_(conv)
    cache_l["ssm"].copy_(ssm)
    return out


def _decode_cross(h, lp, cache_l, cfg):
    """The new token's cross-attention: its query against the layer's
    cross K / V in the cache, every frame visible (``repro`` masks past
    position enc_frames - 1, which is none)."""
    q = split_heads(linear(h, lp["xwq"].to(h.dtype)), cfg.n_heads, cfg.hd)
    o = attn.decode_attention(q, cache_l["xk"], cache_l["xv"],
                              cfg.enc_frames - 1)
    return linear(o.reshape(h.shape[0], 1, cfg.q_dim), lp["xwo"].to(h.dtype))


def decode_layer(x: torch.Tensor, lp: Dict[str, torch.Tensor],
                 cache_l: Dict[str, torch.Tensor], cfg: ModelConfig,
                 positions: torch.Tensor, pos: int,
                 window: int) -> torch.Tensor:
    """Single-token decode through one layer; ``cache_l`` holds the
    layer's views of the cache, which it updates in place.  ``positions``
    is ``pos`` as a one-element tensor on the activations' device."""
    if cfg.family == "ssm":
        return x + _decode_ssm(_norm(x, lp, "ssm_norm", cfg), lp, cache_l,
                               cfg)
    h = _norm(x, lp, "attn_norm", cfg)
    a = _decode_attend(h, lp, cache_l, cfg, positions, pos, window)
    if cfg.family == "hybrid":
        x = _fuse(x, lp, a, _decode_ssm(h, lp, cache_l, cfg), cfg)
        return x + _ffn_sublayer(x, lp, cfg)[0]
    if cfg.post_norms:
        a = _norm(a, lp, "post_attn_norm", cfg)
    x = x + a
    if cfg.family == "audio":
        x = x + _decode_cross(_norm(x, lp, "xattn_norm", cfg), lp, cache_l,
                              cfg)
    return x + _ffn_sublayer(x, lp, cfg)[0]


def decode_step(params: Dict[str, torch.Tensor], cache: Dict,
                tokens: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict]:
    """One serving step: logits (B, V) f32 for the next token, and the
    cache with the new position written in place and ``pos`` advanced."""
    check_family(cfg)
    pos = cache["pos"]
    if "k" in cache and pos >= cache["k"].shape[2]:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} positions;"
                         f" position {pos} does not fit")
    x = embed_tokens(params, tokens, cfg)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    names = [k for k in cache if k != "pos"]
    layers = layer_list(params, cfg.n_layers)
    for i, window in enumerate(layer_windows(cfg)):
        x = decode_layer(x, layers[i], {k: cache[k][i] for k in names}, cfg,
                         positions, pos, window)
    x = rmsnorm(x, params["final_norm"], one_plus=cfg.rms_one_plus)
    logits = logits_head(params, x, cfg)
    cache["pos"] = pos + 1
    return logits[:, 0], cache


class LM(nn.Module):
    """The decoder as a module for serving: holds the flat parameter dict
    (names as in ``repro``, e.g. ``layers/wq``) and calls the functions
    above.  Its parameters do not require gradients.  Training takes the
    flat dict itself: ``loss_fn`` above, the step of
    ``launch.steps.make_train_step`` and the loop of ``launch.train``."""

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

    def forward(self, tokens: torch.Tensor, *,
                patches: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return forward_hidden(self.params, tokens, self.cfg, patches=patches)

    def prefill(self, tokens: torch.Tensor, *,
                patches: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
        return prefill(self.params, tokens, self.cfg, patches=patches,
                       frames=frames)

    def init_cache(self, batch: int, max_len: int) -> Dict:
        return init_cache(self.cfg, batch, max_len,
                          self.weights["embed"].device)

    def decode_step(self, cache: Dict,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        return decode_step(self.params, cache, tokens, self.cfg)


__all__ = ["GLOBAL_WINDOW", "layer_windows", "seq_shard_attn",
           "decoder_layer",
           "forward_hidden", "lm_loss", "loss_fn", "prefill_layer", "prefill", "cache_spec",
           "init_cache", "decode_layer", "decode_step", "LM"]
