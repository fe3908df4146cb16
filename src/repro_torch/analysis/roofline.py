"""Three-term roofline of one NVIDIA H100 SXM (``repro.analysis.roofline``
with the card's numbers)::

    compute term    = flops / peak FLOP/s of the work's type
    memory term     = bytes / 3.35e12 B/s                 [HBM3]
    collective term = per-device wire bytes / 450e9 B/s   [NVLink 4, a direction]

The peaks are ``kernels/tuning.py``'s (NVIDIA's H100 SXM data sheet,
dense rates at the 700 W power limit), so the card has one source of
truth; the same data sheet gives NVLink 4's 900 GB/s (both directions
together) and the 80 GB of HBM.  A card set below 700 W runs slower:
state its power limit beside any share of these peaks.

``repro`` reads flops and bytes from the compiled HLO of a dry run.  The
port has no HLO; :func:`roofline_from_counts` takes the counts of a work
model instead: ``analysis.flops`` (``sdkde_flops`` / ``sdkde_bytes``,
``model_flops``), the per-pair operations and bytes of
``kernels.tuning.pair_bound`` for one kernel, or
``analysis.profile.flop_count`` for the aten products of a model.  Each
term is reported in seconds with ``bound`` = the largest; their sum
means nothing (the terms overlap on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.kernels import tuning

NVLINK_BW = 900e9     # NVLink 4 a GPU, both directions together (data sheet)
HBM_BYTES = 80e9      # HBM3 capacity a card


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm"
    peak_flops: float = tuning.BF16_FLOPS    # bf16 tensor-core FLOP/s, dense
    hbm_bw: float = tuning.HBM_BW            # bytes/s
    link_bw: float = NVLINK_BW / 2           # bytes/s a direction
    hbm_bytes: float = HBM_BYTES             # capacity


#: The card at its bf16 tensor-core peak (the model's GEMMs).
HW = Hardware()
#: The same card at its FP32 peak outside the tensor cores (the f32 tier
#: of B1-B6, Fig. 5's utilization).
HW_FP32 = dataclasses.replace(HW, name="h100-sxm fp32",
                              peak_flops=tuning.FP32_FLOPS)


@dataclasses.dataclass
class RooflineTerms:
    """One program's three terms.  ``row()`` keeps ``repro``'s keys
    (``hlo_flops``, ``hlo_bytes``) so the two packages' tables read
    alike; here they hold the work model's counts."""

    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                      # per-device FLOPs (one execution)
    bytes_moved: float                # per-device HBM bytes
    collective_bytes: float           # per-device wire bytes
    model_flops: float = 0.0          # 2·N·D / 6·N·D, or the paper's model
    bytes_per_device: float = 0.0     # peak memory a device
    collective_detail: Optional[Dict[str, float]] = None
    hw: Hardware = HW

    # -- the three terms, in seconds --------------------------------------

    @property
    def t_compute(self) -> float:
        return self.flops / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_moved / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.hw.link_bw

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Lower-bound step time: max of the three overlapping terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / executed FLOPs — the waste detector.
        model_flops is global; flops is per-device."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def mfu_at(self, seconds: float) -> float:
        """Model-FLOPs utilization of a step that takes ``seconds``."""
        if not seconds:
            return 0.0
        return self.model_flops / (seconds * self.chips * self.hw.peak_flops)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline-limited step time."""
        return self.mfu_at(self.step_time)

    def row(self) -> Dict[str, Any]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bound": self.bound,
            "step_time_s": self.step_time,
            "hlo_flops": self.flops,
            "hlo_bytes": self.bytes_moved,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
            "bytes_per_device": self.bytes_per_device,
        }


def roofline_from_counts(
    *,
    arch: str,
    shape: str,
    flops: float,
    bytes: float,
    collective_bytes: float = 0.0,
    model_flops: float = 0.0,
    mesh: str = "1",
    chips: int = 1,
    bytes_per_device: float = 0.0,
    hw: Hardware = HW,
) -> RooflineTerms:
    """RooflineTerms from a work model's per-device counts (the port's
    counterpart of ``repro``'s ``roofline_from_compiled``)."""
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh, chips=chips, flops=float(flops),
        bytes_moved=float(bytes), collective_bytes=float(collective_bytes),
        model_flops=float(model_flops),
        bytes_per_device=float(bytes_per_device), hw=hw)


def format_table(rows) -> str:
    """Markdown roofline table (``repro``'s columns)."""
    hdr = (
        "| arch | shape | mesh | t_comp (ms) | t_mem (ms) | t_coll (ms) "
        "| bound | model/HLO flops | MFU@roofline | GB/device |"
    )
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        d = r.row() if isinstance(r, RooflineTerms) else r
        lines.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} "
            f"| {d['t_compute_s']*1e3:.2f} | {d['t_memory_s']*1e3:.2f} "
            f"| {d['t_collective_s']*1e3:.2f} | {d['bound']} "
            f"| {d['useful_ratio']:.2f} | {d['mfu']*100:.1f}% "
            f"| {d['bytes_per_device']/2**30:.2f} |"
        )
    return "\n".join(lines)


__all__ = ["NVLINK_BW", "HBM_BYTES", "Hardware", "HW", "HW_FP32",
           "RooflineTerms", "roofline_from_counts", "format_table"]
