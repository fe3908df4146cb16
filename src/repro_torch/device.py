"""Device resolution for the port: the card by default, the CPU on request.

``resolve("cuda")`` raises when no card is present rather than running on
the CPU.  It also pins PyTorch's float32 matrix products and cuDNN
convolutions to IEEE float32 (TF32 off), so the ``f32`` tier stays an f32
tier on the card instead of a ~1e-3 one.
"""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve(device: "str | torch.device" = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises if the card is absent."""
    dev = torch.device(device)
    if dev.type not in DEVICES:
        raise ValueError(f"unsupported device {device!r} (choose from "
                         f"{DEVICES})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


__all__ = ["DEVICES", "resolve", "synchronize"]
