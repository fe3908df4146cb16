"""Falcon-Mamba 7B — pure Mamba-1, attention-free [arXiv:2410.05355].

64 layers, d_model 4096 (no attention), vocab 65024, ssm_state 16,
expand 2 (d_inner 8192), conv 4, bf16: 7,272,665,088 parameters.  The
decode state is O(1) per sequence (the conv window and the SSM state),
with no KV cache.
"""

import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.common import ModelConfig

MODEL = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=32,                  # unused (attention-free), as in repro
    n_kv_heads=8,
    d_ff=0,
    vocab_size=65024,
    head_dim=128,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    attn_free=True,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

ARCH = ArchSpec(
    arch_id="falcon_mamba_7b",
    model=MODEL,
    skips={},
    source="arXiv:2410.05355; unverified",
)
