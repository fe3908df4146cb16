"""ChatGLM3-6B [arXiv:2406.12793; hf].

28 layers, d_model 4096, 32 heads (GQA, 2 KV heads: 16 query heads a KV
head) of 128, d_ff 13696 (SwiGLU), vocab 65024, bf16: 6,243,454,976
parameters.  2-D RoPE: only the first half of the head dim rotates.
Pure full-attention, so long_500k is an assigned skip.
"""

import torch

from repro_torch.configs import FULL_ATTN_LONG_SKIP, ArchSpec
from repro_torch.models.common import ModelConfig

MODEL = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    head_dim=128,
    act="swiglu",
    rope_variant="half",         # chatglm 2d rope
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

ARCH = ArchSpec(
    arch_id="chatglm3_6b",
    model=MODEL,
    skips={"long_500k": FULL_ATTN_LONG_SKIP},
    source="arXiv:2406.12793; hf",
)
