"""Architecture / workload registry (``repro.configs``).

Every architecture ``repro`` knows keeps its id here, each a module
exporting ``ARCH`` (an ``ArchSpec`` with the published numbers and
``repro``'s training policy); the port builds all ten (``PORTED``).  The
assigned input shapes, each architecture's skipped cells and the paper's
SD-KDE workloads are registered alongside with ``repro``'s values;
``launch.train`` builds its own train shape, and the dry run
(``launch/dryrun.py``) walks every arch's ``arch_cells`` and both KDE
workloads.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

from repro_torch.models.common import ModelConfig

# ---------------------------------------------------------------------------
# Shapes (the assigned input-shape set; identical across LM architectures).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One assigned input shape.  ``kind``: ``train`` (train step, grad
    accumulation over ``microbatches``), ``prefill`` (forward over
    ``seq_len`` tokens building the cache) or ``decode`` (one new token
    against a ``seq_len``-token cache)."""

    name: str
    kind: str                # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatches: int = 1    # train only: grad-accumulation steps


TRAIN_4K = ShapeCfg("train_4k", "train", 4096, 256, microbatches=8)
PREFILL_32K = ShapeCfg("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeCfg("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeCfg("long_500k", "decode", 524288, 1)

LM_SHAPES: Tuple[ShapeCfg, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                   LONG_500K)
SHAPES: Dict[str, ShapeCfg] = {s.name: s for s in LM_SHAPES}


# ---------------------------------------------------------------------------
# Architecture spec.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """An architecture's published model configuration, the assigned
    cells it skips (shape name -> reason, e.g. long_500k on a pure
    full-attention model) and its training policy, ``repro``'s:
    ``optimizer`` ("adamw" or "adafactor"), the gradient accumulator's
    type ``accum_dtype`` (a ``torch`` dtype's name) and
    ``train_microbatches``, which overrides a train shape's count."""

    arch_id: str
    model: ModelConfig
    skips: Dict[str, str] = dataclasses.field(default_factory=dict)
    source: str = ""
    optimizer: str = "adamw"          # adamw | adafactor
    accum_dtype: str = "float32"      # gradient-accumulator dtype
    train_microbatches: Optional[int] = None

    def shape_applicable(self, shape: ShapeCfg) -> Optional[str]:
        """None if the (arch, shape) cell runs; else the skip reason."""
        return self.skips.get(shape.name)


FULL_ATTN_LONG_SKIP = (
    "long_500k requires sub-quadratic attention; this arch is pure "
    "full-attention (see DESIGN.md §Arch-applicability)"
)


# ---------------------------------------------------------------------------
# SD-KDE workloads (the paper's own tables).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KdeWorkload:
    arch_id: str
    n_train: int
    n_test: int
    dim: int
    source: str = "Flash-SD-KDE paper §6"


KDE_WORKLOADS: Dict[str, KdeWorkload] = {
    # Figure 1 / Table 1 scale: 32k train, n_test = n/8.
    "flash_sdkde_32k": KdeWorkload("flash_sdkde_32k", 32768, 4096, 16),
    # "1M-sample 16-dimensional task evaluated on 131k queries" (§1, §7).
    "flash_sdkde_1m": KdeWorkload("flash_sdkde_1m", 1048576, 131072, 16),
}


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "minitron_8b",
    "phi3_mini_3p8b",
    "gemma2_2b",
    "chatglm3_6b",
    "kimi_k2_1t_a32b",
    "granite_moe_3b_a800m",
    "hymba_1p5b",
    "llava_next_34b",
    "whisper_large_v3",
    "falcon_mamba_7b",
)
#: the architectures the port can build: all of them
PORTED = ARCH_IDS

_ALIASES = {
    "minitron-8b": "minitron_8b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "gemma2-2b": "gemma2_2b",
    "chatglm3-6b": "chatglm3_6b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "hymba-1.5b": "hymba_1p5b",
    "llava-next-34b": "llava_next_34b",
    "whisper-large-v3": "whisper_large_v3",
    "falcon-mamba-7b": "falcon_mamba_7b",
}


def get_arch(arch_id: str) -> ArchSpec:
    arch_id = _ALIASES.get(arch_id, arch_id).replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.ARCH


def list_archs() -> Tuple[str, ...]:
    return ARCH_IDS


def arch_cells(arch: ArchSpec):
    """Every (shape, skip reason or None) cell of ``arch``, the skips
    included, so that the dry run's table records why a cell is absent."""
    return [(s, arch.shape_applicable(s)) for s in LM_SHAPES]


__all__ = ["ShapeCfg", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "LM_SHAPES", "SHAPES", "ArchSpec", "FULL_ATTN_LONG_SKIP",
           "KdeWorkload", "KDE_WORKLOADS",
           "ARCH_IDS", "PORTED", "get_arch", "list_archs", "arch_cells"]
