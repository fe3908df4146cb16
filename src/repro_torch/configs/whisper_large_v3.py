"""Whisper large-v3 backbone [arXiv:2212.04356; unverified].

An encoder-decoder: 32 encoder layers over 1500 frame embeddings (the
conv frontend is a stub, as in ``repro``: the encoder reads
precomputed (B, 1500, d) frames), 32 decoder layers with self- and
cross-attention; d_model 1280, 20 heads (MHA) of 64, d_ff 5120 (GELU),
vocab 51866, tied embeddings; bf16: 1,536,652,800 parameters.  Decode
reads the self-attention cache and the cross K / V computed once from
the encoder; long_500k is an assigned skip (a full-attention decoder).
"""

import torch

from repro_torch.configs import FULL_ATTN_LONG_SKIP, ArchSpec
from repro_torch.models.common import ModelConfig

MODEL = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    act="gelu",
    n_enc_layers=32,
    enc_frames=1500,
    tie_embeddings=True,         # whisper ties decoder embed / proj
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
)

ARCH = ArchSpec(
    arch_id="whisper_large_v3",
    model=MODEL,
    skips={"long_500k": FULL_ATTN_LONG_SKIP},
    source="arXiv:2212.04356; unverified",
)
