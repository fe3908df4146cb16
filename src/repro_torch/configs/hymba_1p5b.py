"""Hymba-1.5B, parallel attention and Mamba heads [arXiv:2411.13676; hf].

32 layers, d_model 1600, 25 heads (GQA, 5 KV heads) of 64, d_ff 5504
(SwiGLU), vocab 32001, SSM state 16, expand 2 (d_inner 3200), conv 4,
bf16: 1,663,131,200 parameters.  Each layer runs attention and a Mamba
block (kernel B7's fused mode) in parallel on the same normed input and
fuses them with learned per-channel scales (the ``hybrid`` family of
models/transformer.py).  The SSM half keeps an O(1) decode state, so
long_500k runs.
"""

import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.common import ModelConfig

MODEL = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,                 # 1600 / 25
    act="swiglu",
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

ARCH = ArchSpec(
    arch_id="hymba_1p5b",
    model=MODEL,
    skips={},
    source="arXiv:2411.13676; hf",
)
