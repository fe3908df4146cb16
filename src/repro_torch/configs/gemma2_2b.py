"""Gemma-2 2B [arXiv:2408.00118; hf].

26 layers, d_model 2304, 8 heads (GQA, 4 KV heads) of 256, d_ff 9216
(GeGLU), vocab 256000, bf16: 2,614,341,888 parameters.  Alternating
local (4096-token window) and global layers, attention and final logit
softcapping, sandwich norms, (1 + w) RMSNorm, tied embeddings scaled by
sqrt(d).  long_500k runs for this arch: decode against a 524k cache is
O(S) a token, and the local layers bound half the cache traffic to the
window.
"""

import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.common import ModelConfig

MODEL = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    act="geglu",
    rms_one_plus=True,
    post_norms=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_alt=True,
    tie_embeddings=True,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

ARCH = ArchSpec(
    arch_id="gemma2_2b",
    model=MODEL,
    skips={},
    source="arXiv:2408.00118; hf",
)
