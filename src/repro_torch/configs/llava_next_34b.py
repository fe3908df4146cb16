"""LLaVA-NeXT 34B backbone [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified].

60 layers, d_model 7168, 56 heads (GQA, 8 KV heads) of 128, d_ff 20480
(SwiGLU), vocab 64000; bf16: 34,440,297,472 parameters.  The vision
frontend is a stub, as in ``repro``: precomputed anyres patch
embeddings (B, 2880, d) (4 high-resolution tiles and the base tile, 576
patches each) pass one learned projection and go before the text
tokens.  Pure full attention, so long_500k is an assigned skip.
Training accumulates gradients in bf16, as ``repro``'s policy says.
"""

import torch

from repro_torch.configs import FULL_ATTN_LONG_SKIP, ArchSpec
from repro_torch.models.common import ModelConfig

MODEL = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    act="swiglu",
    n_patches=2880,              # anyres: (4 tiles + base) x 576
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

ARCH = ArchSpec(
    arch_id="llava_next_34b",
    model=MODEL,
    skips={"long_500k": FULL_ATTN_LONG_SKIP},
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (anyres tiling); unverified",
    accum_dtype="bfloat16",
)
