"""Phi-3-mini 3.8B [arXiv:2404.14219; unverified].

32 layers, d_model 3072, 32 heads (32 KV heads: multi-head attention)
of 96, d_ff 8192 (SwiGLU), vocab 32064, RoPE, bf16: 3,822,259,200
parameters.  Pure full-attention, so long_500k is an assigned skip.
"""

import torch

from repro_torch.configs import FULL_ATTN_LONG_SKIP, ArchSpec
from repro_torch.models.common import ModelConfig

MODEL = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    act="swiglu",
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

ARCH = ArchSpec(
    arch_id="phi3_mini_3p8b",
    model=MODEL,
    skips={"long_500k": FULL_ATTN_LONG_SKIP},
    source="arXiv:2404.14219; unverified",
)
