"""Work models, the H100 roofline and the measured side
(``repro.analysis``).

``repro``'s ``hlo.py`` and ``hlo_exec.py`` parse XLA HLO text and have no
counterpart: ``profile`` (torch.profiler accounting and
``FlopCounterMode``) takes their place, and collective bytes come from
the ring's shard sizes.
"""

from repro_torch.analysis.flops import model_flops, sdkde_bytes, sdkde_flops
from repro_torch.analysis.profile import device_breakdown, flop_count
from repro_torch.analysis.roofline import (HW, HW_FP32, Hardware,
                                           RooflineTerms, format_table,
                                           roofline_from_counts)

__all__ = [
    "RooflineTerms",
    "roofline_from_counts",
    "format_table",
    "Hardware",
    "HW",
    "HW_FP32",
    "model_flops",
    "sdkde_flops",
    "sdkde_bytes",
    "device_breakdown",
    "flop_count",
]
