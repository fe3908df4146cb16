"""Learning-rate schedules (``repro.optim.schedules``): functions of the
step index, a 0-d integer tensor (the optimizer state's ``step``), that
return a 0-d f32 tensor on its device, so that a train step reads no
value back to the host."""

from __future__ import annotations

import math

import torch


def linear_warmup(step: torch.Tensor, peak_lr: float,
                  warmup_steps: int) -> torch.Tensor:
    s = torch.clamp(step.to(torch.float32), max=warmup_steps)
    return peak_lr * s / max(warmup_steps, 1)


def cosine_schedule(step: torch.Tensor, peak_lr: float, warmup_steps: int,
                    total_steps: int, final_frac: float = 0.1
                    ) -> torch.Tensor:
    """Linear warmup, then a cosine decay to ``final_frac * peak_lr``."""
    s = step.to(torch.float32)
    warm = linear_warmup(step, peak_lr, warmup_steps)
    prog = torch.clamp((s - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1.0 - final_frac) * 0.5 * (
        1.0 + torch.cos(math.pi * prog))
    return torch.where(s < warmup_steps, warm, peak_lr * cos)


__all__ = ["linear_warmup", "cosine_schedule"]
