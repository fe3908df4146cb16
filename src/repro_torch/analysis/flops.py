"""FLOP models: 2·N·D / 6·N·D for LMs, and the paper's SD-KDE flop/byte
model (§4.1) — ``repro.analysis.flops``, the same formulas and defaults.

``sdkde_flops`` is the paper's tile-aware accounting: FLOPs_d(k) =
(4d + 12 + d/4 + 3/2)·k² with n_test = k/8, each exp budgeted at 8 FLOPs
(the paper's 128:16 FP32:SFU ratio), which gives the paper's 81.5·k² at
d = 16.  Fig. 5's utilization is this count over (time × FP32 peak).
The hand-written kernels are invisible to a profiler's FLOP counter, so
their work comes from these models (and from ``kernels.tuning.
pair_bound``'s per-pair operations).
"""

from __future__ import annotations

from repro_torch.models.common import ModelConfig, active_param_count

EXP_FLOPS = 8  # the paper's SFU accounting: 1 exp == 8 FP32 flops


# ---------------------------------------------------------------------------
# LM model FLOPs.
# ---------------------------------------------------------------------------


def model_flops(cfg: ModelConfig, tokens: int, *, training: bool = True) -> float:
    """MODEL_FLOPS = 6·N·D (training) or 2·N·D (inference); N_active for MoE."""
    n = active_param_count(cfg)
    per_token = 6 * n if training else 2 * n
    return float(per_token) * tokens


# ---------------------------------------------------------------------------
# Paper §4.1: d-dimensional SD-KDE flop / byte / intensity model.
# ---------------------------------------------------------------------------


def sdkde_flops(k: int, d: int = 16, *, n_test: int | None = None) -> float:
    """Paper's FLOP model with n_test defaulting to k/8.

    Stages (§4.1): score Gram 2dk², score numerator GEMM 2dk² (+4k² scalar
    +8k² exp), final KDE 2dk·n_test (+4 k·n_test scalar +8 k·n_test exp).
    With n_test=k/8 this collapses to (4d + 12 + d/4 + 3/2)·k².
    """
    nt = k / 8 if n_test is None else n_test
    gram = 2.0 * d * k * k
    numer = 2.0 * d * k * k + (4.0 + EXP_FLOPS) * k * k
    final = 2.0 * d * k * nt + (4.0 + EXP_FLOPS) * k * nt
    return gram + numer + final


def sdkde_flops_coefficient(d: int = 16) -> float:
    """The k² coefficient (4d + 12 + d/4 + 3/2); 81.5 for d=16."""
    return 4.0 * d + 12.0 + d / 4.0 + 1.5


def sdkde_bytes(
    k: int,
    d: int = 16,
    *,
    block_m: int = 64,
    block_n: int = 1024,
    itemsize: int = 4,
) -> float:
    """Paper's tile-aware GDDR/HBM byte model (§4.1).

    Per tile: row tile loads (block_m·d), streamed column tile (block_n·d),
    partial output writes (block_m·(d+1) ≈ block_m·d + block_m); the full
    problem runs (k/block_m)·(k/block_n) tiles.
    """
    per_tile = itemsize * (
        2 * block_m * d + block_n * d + block_m
    )
    tiles = (k / block_m) * (k / block_n)
    return per_tile * tiles


def sdkde_intensity(k: int, d: int = 16, **kw) -> float:
    """Arithmetic intensity (flops/byte); ≈72 for d=16 at the paper's tiles."""
    return sdkde_flops(k, d) / sdkde_bytes(k, d, **kw)


def sdkde_flops_1d(k: int, *, n_test: int | None = None) -> float:
    """Appendix A 1-D model: c1·k² + c2·k·n_test with c1≈16, c2≈14."""
    nt = k / 8 if n_test is None else n_test
    return 16.0 * k * k + 14.0 * k * nt


__all__ = ["EXP_FLOPS", "model_flops", "sdkde_flops",
           "sdkde_flops_coefficient", "sdkde_bytes", "sdkde_intensity",
           "sdkde_flops_1d"]
