"""Minitron-8B, a width- and depth-pruned Nemotron-4 [arXiv:2407.14679;
hf].

32 layers, d_model 4096, 32 heads (GQA, 8 KV heads) of 128, d_ff 16384
(squared-ReLU FFN), vocab 256000, bf16: 7,734,562,816 parameters.  A
pure full-attention dense decoder, so long_500k is an assigned skip.
"""

import torch

from repro_torch.configs import FULL_ATTN_LONG_SKIP, ArchSpec
from repro_torch.models.common import ModelConfig

MODEL = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    head_dim=128,
    act="relu2",                 # nemotron uses squared-ReLU FFN
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

ARCH = ArchSpec(
    arch_id="minitron_8b",
    model=MODEL,
    skips={"long_500k": FULL_ATTN_LONG_SKIP},
    source="arXiv:2407.14679 (pruned nemotron); hf",
)
