"""Kimi-K2 1T-A32B, a trillion-parameter MoE [arXiv:2501.kimi2; unverified].

61 layers, d_model 7168, 64 heads (GQA, 8 KV heads) of 112, vocab
163840, a MoE FFN in every layer: 384 experts of width 2048 (SwiGLU),
top 8, and one always-on shared expert; bf16: 1,043,853,440,000
parameters (17.07e9 a layer), 33,747,596,288 active a token.  GQA
attention (not MLA), as ``repro`` specifies.  Pure full attention, so
long_500k is an assigned skip.

``expert_2d_sharding`` and ``seq_shard_attn`` are ``repro``'s mesh
layout (experts over ``model``, d_ff over ``data``; sequence-sharded
attention): on one device both are ignored, in ``repro`` and here
(``models.common.MESH_ONLY_FIELDS``).  Training follows ``repro``'s
policy for the ~1T configuration: Adafactor (factored second moments, no
first moment), bf16 gradient accumulators and 2 microbatches.
"""

import torch

from repro_torch.configs import FULL_ATTN_LONG_SKIP, ArchSpec
from repro_torch.models.common import ModelConfig

MODEL = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,                   # dense-equivalent width unused; experts rule
    vocab_size=163840,
    head_dim=112,                # 7168 / 64
    act="swiglu",
    n_experts=384,
    top_k=8,
    moe_dff=2048,
    n_shared_experts=1,
    rope_theta=50000.0,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
    expert_2d_sharding=True,
    seq_shard_attn=True,
)

ARCH = ArchSpec(
    arch_id="kimi_k2_1t_a32b",
    model=MODEL,
    skips={"long_500k": FULL_ATTN_LONG_SKIP},
    source="arXiv:2501.kimi2 (paper-table); unverified",
    optimizer="adafactor",
    accum_dtype="bfloat16",
    train_microbatches=2,
)
