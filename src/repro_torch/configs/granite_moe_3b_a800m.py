"""Granite-3.0 MoE 3B-A800M [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

32 layers, d_model 1536, 24 heads (GQA, 8 KV heads) of 64, vocab 49155,
a MoE FFN in every layer: 40 experts of width 512 (SwiGLU), top 8,
capacity factor 1.25; bf16: 3,375,072,768 parameters, 959,153,664
active a token.  Pure full attention, so long_500k is an assigned skip.
"""

import torch

from repro_torch.configs import FULL_ATTN_LONG_SKIP, ArchSpec
from repro_torch.models.common import ModelConfig

MODEL = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    act="swiglu",
    n_experts=40,
    top_k=8,
    moe_dff=512,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

ARCH = ArchSpec(
    arch_id="granite_moe_3b_a800m",
    model=MODEL,
    skips={"long_500k": FULL_ATTN_LONG_SKIP},
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
