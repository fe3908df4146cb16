"""Model configuration and parameters (``repro.models.common``).

One ``ModelConfig`` carries every field of ``repro``'s, with dtypes as
``torch.dtype``.  ``param_shapes(cfg)`` is the single source of truth for
every parameter's shape and dtype: ``param_count`` sums it without
allocating, ``init_params`` materializes it on a device from a
``torch.Generator``.  Every family of ``repro``'s is ported: SSM,
dense, hybrid, MoE, VLM (a patch projection before the tokens) and audio
(an encoder stack and cross-attention in the decoder).
``param_shape_specs`` adds ``repro``'s PartitionSpec of each parameter
(a tuple, ``models/parallel.py``); ``abstract_params`` gives the dry
run's unallocated inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Literal, Optional, Tuple

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
PORTED_FAMILIES = ("ssm", "dense", "hybrid", "moe", "vlm", "audio")


#: Fields that one family alone reads (the router and experts, the patch
#: prefix, the encoder).  Another family takes each at its default only,
#: so a value set there raises rather than changing nothing.  The widths
#: n_heads, n_kv_heads, head_dim and d_ff stay free: ``repro``'s
#: Falcon-Mamba carries them unused and ``reduced()`` shrinks them; so do
#: remat and loss_chunk, which shape only a train step
#: (``models/remat.py``, ``transformer.lm_loss``).
FAMILY_FIELDS = {
    "moe": ("n_experts", "top_k", "moe_dff", "n_shared_experts",
            "capacity_factor"),
    "vlm": ("n_patches",),
    "audio": ("n_enc_layers", "enc_frames"),
}

#: Fields only a device mesh reads: ``repro``'s sequence-sharded
#: attention (``transformer._seq_shard_qkv``) and the 2-D expert layout
#: (``param_shape_specs``, ``moe``'s mesh paths).  They act only under a
#: mesh registered in ``models/parallel.py``; without one ``repro``
#: ignores both and so does the port (Kimi-K2 sets both).
MESH_ONLY_FIELDS = ("seq_shard_attn", "expert_2d_sharding")

#: Fields only the attention and MLP layers read: an attention-free (SSM)
#: config takes each at its default, so a value set there raises too.
ATTENTION_FIELDS = (
    "act", "post_norms", "rope_variant", "rope_theta", "attn_softcap",
    "sliding_window", "local_global_alt", "kv_quant")


def check_family(cfg: "ModelConfig") -> None:
    """Raise unless the port has ``cfg``'s family, ``cfg`` sets no field
    of another family's ``FAMILY_FIELDS`` (nor, attention-free, of
    ``ATTENTION_FIELDS``) away from its default, and a MoE config has
    experts to route to."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not a family of "
            "repro's (ROADMAP A15); the port has "
            + ", ".join(PORTED_FAMILIES))
    odd = [f for fam, fields in FAMILY_FIELDS.items() if fam != cfg.family
           for f in fields if getattr(cfg, f) != _DEFAULTS[f]]
    if odd:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(odd)} select features of another "
            f"family than {cfg.family!r}, which does not read them "
            "(ROADMAP A15)")
    if cfg.attn_free != (cfg.family == "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: attn_free={cfg.attn_free} with the "
            f"{cfg.family!r} family (the port's attention-free family is "
            "the SSM family; ROADMAP A15)")
    odd = [f for f in ATTENTION_FIELDS if getattr(cfg, f) != _DEFAULTS[f]]
    if cfg.attn_free and odd:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(odd)} select attention features the "
            "attention-free SSM family does not read (ROADMAP A15)")
    if cfg.family == "moe" and not 1 <= cfg.top_k <= cfg.n_experts:
        raise ValueError(f"{cfg.name}: a MoE config routes to top_k of "
                         f"n_experts, got {cfg.top_k} of {cfg.n_experts}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    act: str = "swiglu"                # swiglu | geglu | gelu | relu2
    rms_one_plus: bool = False         # gemma-style (1 + w) RMSNorm scale
    post_norms: bool = False           # gemma2 sandwich norms
    rope_variant: str = "full"         # full | half (chatglm 2d rope)
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_alt: bool = False     # gemma2 alternating local/global
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0                   # per-expert FFN width
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    expert_2d_sharding: bool = False
    # SSM (mamba1)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_free: bool = False            # falcon-mamba: no attention at all
    # enc-dec (whisper) — frontend is a stub
    n_enc_layers: int = 0
    enc_frames: int = 1500
    # VLM (llava) — patch frontend is a stub
    n_patches: int = 0
    # numerics
    dtype: Any = torch.bfloat16        # activations
    param_dtype: Any = torch.float32
    remat: str = "full"                # none | full
    loss_chunk: int = 512              # sequence chunking for the vocab loss
    seq_shard_attn: Optional[bool] = None
    kv_quant: bool = False
    # Mamba path: kernel B7 (kernels/selective_scan.py) instead of the
    # associative scan over the materialized (B, S, d_inner, N) tensors.
    ssm_kernel: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256, as in ``repro`` (lane alignment; padded ids
        are never produced and their logits are free to float)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, math.ceil(self.d_model / 16))

    @property
    def gated(self) -> bool:
        return self.act in ("swiglu", "geglu")

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family variant for CPU tests (``repro``'s sizes)."""
        shrink = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_dff=32 if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            sliding_window=8 if self.sliding_window else None,
            n_enc_layers=2 if self.n_enc_layers else 0,
            enc_frames=16 if self.n_enc_layers else 1500,
            n_patches=8 if self.n_patches else 0,
            dtype=torch.float32,
            param_dtype=torch.float32,
            remat="none",
            loss_chunk=0,
        )
        shrink.update(overrides)
        return dataclasses.replace(self, **shrink)


_DEFAULTS = {f.name: f.default for f in dataclasses.fields(ModelConfig)}

ShapeSpec = Tuple[Tuple[int, ...], Any]  # (shape, dtype)
#: (shape, dtype, spec): ``repro``'s ``param_shapes`` entries, the spec a
#: tuple of PartitionSpec entries (``models/parallel.py``)
ShapeSpecP = Tuple[Tuple[int, ...], Any, Tuple[Any, ...]]


def _attn_shapes(cfg: ModelConfig) -> Dict[str, ShapeSpecP]:
    d, pd = cfg.d_model, cfg.param_dtype
    return {
        "attn_norm": ((d,), pd, (None,)),
        "wq": ((d, cfg.q_dim), pd, (None, "model")),
        "wk": ((d, cfg.kv_dim), pd, (None, "model")),
        "wv": ((d, cfg.kv_dim), pd, (None, "model")),
        "wo": ((cfg.q_dim, d), pd, ("model", None)),
    }


def _mlp_shapes(cfg: ModelConfig, d_ff: int) -> Dict[str, ShapeSpecP]:
    d, pd = cfg.d_model, cfg.param_dtype
    out: Dict[str, ShapeSpecP] = {
        "mlp_norm": ((d,), pd, (None,)),
        "w_up": ((d, d_ff), pd, (None, "model")),
        "w_down": ((d_ff, d), pd, ("model", None)),
    }
    if cfg.gated:
        out["w_gate"] = ((d, d_ff), pd, (None, "model"))
    return out


def _moe_shape_specs(cfg: ModelConfig) -> Dict[str, ShapeSpecP]:
    """The router, the stacked experts (E, d, f) / (E, f, d) and the
    shared experts, f·n_shared_experts wide.  The experts' specs are
    ``repro``'s: over ``model`` by expert (EP) when E divides 16, else by
    the per-expert d_ff (TP-in-expert); under ``expert_2d_sharding``
    experts over ``model`` and d_ff over ``data``."""
    d, pd, e, f = cfg.d_model, cfg.param_dtype, cfg.n_experts, cfg.moe_dff
    if cfg.expert_2d_sharding:
        es, es_down = ("model", None, "data"), ("model", "data", None)
    elif e % 16 == 0:
        es = es_down = ("model", None, None)
    else:
        es, es_down = (None, None, "model"), (None, "model", None)
    out: Dict[str, ShapeSpecP] = {
        "mlp_norm": ((d,), pd, (None,)),
        "router": ((d, e), pd, (None, None)),
        "experts_up": ((e, d, f), pd, es),
        "experts_down": ((e, f, d), pd, es_down),
    }
    if cfg.gated:
        out["experts_gate"] = ((e, d, f), pd, es)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        out["shared_up"] = ((d, fs), pd, (None, "model"))
        out["shared_down"] = ((fs, d), pd, ("model", None))
        if cfg.gated:
            out["shared_gate"] = ((d, fs), pd, (None, "model"))
    return out


def _moe_shapes(cfg: ModelConfig) -> Dict[str, ShapeSpec]:
    """(shape, dtype) of ``_moe_shape_specs``."""
    return {k: (s, dt) for k, (s, dt, _) in _moe_shape_specs(cfg).items()}


def _ssm_shapes(cfg: ModelConfig) -> Dict[str, ShapeSpecP]:
    d, pd = cfg.d_model, cfg.param_dtype
    di, n, dtr, dc = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    return {
        "ssm_norm": ((d,), pd, (None,)),
        "in_proj": ((d, 2 * di), pd, (None, "model")),
        "conv_w": ((dc, di), pd, (None, "model")),
        "conv_b": ((di,), pd, ("model",)),
        "x_proj": ((di, dtr + 2 * n), pd, ("model", None)),
        "dt_proj": ((dtr, di), pd, (None, "model")),
        "dt_bias": ((di,), pd, ("model",)),
        "A_log": ((di, n), pd, ("model", None)),
        "D": ((di,), pd, ("model",)),
        "out_proj": ((di, d), pd, ("model", None)),
    }


def _layer_shapes(cfg: ModelConfig) -> Dict[str, ShapeSpecP]:
    """One layer's parameters: the Mamba block (SSM); attention, the
    Mamba block, the two fuse scales and the MLP (hybrid); attention and
    the MLP (the router and experts for MoE), with the sandwich norms
    under ``post_norms`` (dense, MoE, VLM, audio's decoder)."""
    d, pd = cfg.d_model, cfg.param_dtype
    if cfg.family == "ssm":
        return _ssm_shapes(cfg)
    shapes: Dict[str, ShapeSpecP] = dict(_attn_shapes(cfg))
    if cfg.family == "hybrid":
        shapes.update(_ssm_shapes(cfg))
        shapes["fuse_attn_scale"] = ((d,), pd, (None,))
        shapes["fuse_ssm_scale"] = ((d,), pd, (None,))
        shapes.update(_mlp_shapes(cfg, cfg.d_ff))
        return shapes
    if cfg.family == "moe":
        shapes.update(_moe_shape_specs(cfg))
    else:
        shapes.update(_mlp_shapes(cfg, cfg.d_ff))
    if cfg.post_norms:
        shapes["post_attn_norm"] = ((d,), pd, (None,))
        shapes["post_mlp_norm"] = ((d,), pd, (None,))
    return shapes


def _enc_layer_shapes(cfg: ModelConfig) -> Dict[str, ShapeSpecP]:
    """Whisper's encoder layer: bidirectional attention and the MLP."""
    shapes = dict(_attn_shapes(cfg))
    shapes.update(_mlp_shapes(cfg, cfg.d_ff))
    return shapes


def _dec_cross_shapes(cfg: ModelConfig) -> Dict[str, ShapeSpecP]:
    """The decoder layer's cross-attention to the encoder output."""
    d, pd = cfg.d_model, cfg.param_dtype
    return {
        "xattn_norm": ((d,), pd, (None,)),
        "xwq": ((d, cfg.q_dim), pd, (None, "model")),
        "xwk": ((d, cfg.kv_dim), pd, (None, "model")),
        "xwv": ((d, cfg.kv_dim), pd, (None, "model")),
        "xwo": ((cfg.q_dim, d), pd, ("model", None)),
    }


def _stack(layer_shapes: Dict[str, ShapeSpecP], n_layers: int,
           prefix: str) -> Dict[str, ShapeSpecP]:
    """Prepend the stacked-layer axis (replicated in the spec)."""
    return {f"{prefix}{k}": ((n_layers, *shape), dt, (None, *spec))
            for k, (shape, dt, spec) in layer_shapes.items()}


def param_shape_specs(cfg: ModelConfig) -> Dict[str, ShapeSpecP]:
    """Flat dict path -> (shape, dtype, spec), ``repro``'s
    ``param_shapes``: per-layer parameters stacked on a leading layer
    axis under ``layers/`` (the encoder's under ``enc_layers/``), with
    Megatron tensor parallelism over ``model`` (embeddings and lm_head by
    vocab, column-parallel q/k/v, up and gate, row-parallel wo and down,
    the SSM's d_inner) and everything else replicated."""
    check_family(cfg)
    d, v, pd = cfg.d_model, cfg.padded_vocab, cfg.param_dtype
    shapes: Dict[str, ShapeSpecP] = {
        "embed": ((v, d), pd, ("model", None)),
        "final_norm": ((d,), pd, (None,)),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((d, v), pd, (None, "model"))
    shapes.update(_stack(_layer_shapes(cfg), cfg.n_layers, "layers/"))
    if cfg.family == "audio":
        # the conv frontend is a stub: the encoder reads frame embeddings
        shapes["enc_pos"] = ((cfg.enc_frames, d), pd, (None, None))
        shapes["enc_final_norm"] = ((d,), pd, (None,))
        shapes.update(_stack(_enc_layer_shapes(cfg), cfg.n_enc_layers,
                             "enc_layers/"))
        shapes.update(_stack(_dec_cross_shapes(cfg), cfg.n_layers,
                             "layers/"))
    if cfg.family == "vlm":
        # the patch frontend is a stub: one learned projection of the
        # patch embeddings
        shapes["patch_proj"] = ((d, d), pd, (None, "model"))
    return shapes


def param_shapes(cfg: ModelConfig) -> Dict[str, ShapeSpec]:
    """Flat dict path -> (shape, dtype) of ``param_shape_specs``."""
    return {k: (s, dt) for k, (s, dt, _) in param_shape_specs(cfg).items()}


def param_pspecs(cfg: ModelConfig) -> Dict[str, Tuple[Any, ...]]:
    """Flat dict path -> spec (``repro``'s ``param_pspecs``)."""
    return {k: spec for k, (_, _, spec) in param_shape_specs(cfg).items()}


def abstract_params(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """Each parameter's ``parallel.Abstract`` (shape, dtype, spec): the
    dry run's inputs, nothing allocated.  ``mesh`` must hold every axis
    the specs name."""
    from repro_torch.models.parallel import Abstract, entry_axes

    names = set(mesh.mesh_dim_names)
    out = {}
    for k, (shape, dt, spec) in param_shape_specs(cfg).items():
        missing = {a for e in spec for a in entry_axes(e)} - names
        if missing:
            raise ValueError(f"{k}: the mesh has no axis {sorted(missing)}")
        out[k] = Abstract(tuple(shape), dt, spec)
    return out


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(s) for s, _ in param_shapes(cfg).values())


def active_param_count(cfg: ModelConfig) -> int:
    """Activated parameters per token (MoE: top_k of n_experts); every
    other family activates all of ``param_count``."""
    if cfg.family != "moe" or not cfg.n_experts:
        return param_count(cfg)
    total = 0
    for name, (shape, _) in param_shapes(cfg).items():
        n = math.prod(shape)
        if "experts_" in name:
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return total


def _init_one(gen: torch.Generator, name: str, shape, dtype,
              device: torch.device) -> torch.Tensor:
    """``repro``'s rules: ones for norms, conv_b, dt_bias and D; A_log =
    log(1..N) on every channel; 0.5 for the hybrid's fuse scales;
    normal/√fan_in elsewhere, fan_in = shape[-2].  The normal values are
    drawn in f32 one matrix (the last two axes) at a time, in row-major
    order of the leading axes (a stacked parameter layer by layer, a
    stacked expert tensor expert by expert within each layer), each
    scaled and cast before the next is drawn: the f32 transient is one
    expert's matrix, not a layer's 384 (Kimi-K2).  On the CPU generator
    the split does not change the values wherever a matrix holds a
    multiple of 16 elements (it draws normals in blocks of 16)."""
    if not shape or shape[-1] == 0:
        return torch.zeros(shape, dtype=dtype, device=device)
    last = name.split("/")[-1]
    if "norm" in last or last in ("conv_b", "dt_bias", "D"):
        return torch.ones(shape, dtype=dtype, device=device)
    if last == "A_log":
        n = shape[-1]
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(shape).to(dtype).contiguous()
    if last in ("fuse_attn_scale", "fuse_ssm_scale"):
        return torch.full(shape, 0.5, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(shape, dtype=dtype, device=device)
    parts = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for part in parts:
        part.copy_(torch.randn(part.shape, generator=gen, device=device,
                               dtype=torch.float32) * scale)
    return out


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: "str | torch.device" = "cuda"
                ) -> Dict[str, torch.Tensor]:
    """Every parameter of ``param_shapes(cfg)``, allocated on ``device``
    and drawn from ``gen`` (a generator on that device) in sorted name
    order.  The values differ from ``repro``'s for the same seed; carry
    ``repro``'s over with ``convert.lm_params_from_state``."""
    dev = torch.device(device)
    return {name: _init_one(gen, name, shape, dt, dev)
            for name, (shape, dt) in sorted(param_shapes(cfg).items())}


def layer_tree(params: Dict[str, torch.Tensor], prefix: str = "layers/"):
    """Sub-dict of stacked per-layer params (leading axis = layer)."""
    plen = len(prefix)
    return {k[plen:]: v for k, v in params.items() if k.startswith(prefix)}


def layer_params(params: Dict[str, torch.Tensor], i: int,
                 prefix: str = "layers/") -> Dict[str, torch.Tensor]:
    """Layer ``i``'s parameters alone: a view of each stacked tensor (the
    models' loops take every layer's at once, ``layer_list``)."""
    return {k: v[i] for k, v in layer_tree(params, prefix).items()}


def layer_list(params: Dict[str, torch.Tensor], n: int,
               prefix: str = "layers/") -> List[Dict[str, torch.Tensor]]:
    """The ``n`` layers' parameters, each stacked tensor unbound once.
    Under autograd the backward of an unbind is one stack of the layers'
    gradients, where indexing each layer (``layer_params``) writes a zero
    tensor the size of the whole stack for every layer: 26 × 4.05 GB a
    microbatch for Gemma-2-2B's bf16 stacks."""
    cols = {k: torch.unbind(v) for k, v in layer_tree(params, prefix).items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


__all__ = ["Family", "PORTED_FAMILIES", "FAMILY_FIELDS", "MESH_ONLY_FIELDS",
           "ATTENTION_FIELDS",
           "ModelConfig",
           "ShapeSpec", "ShapeSpecP",
           "check_family", "param_shape_specs", "param_shapes",
           "param_pspecs", "abstract_params", "param_count",
           "active_param_count",
           "init_params",
           "layer_tree", "layer_params", "layer_list"]
