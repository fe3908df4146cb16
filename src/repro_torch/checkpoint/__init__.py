"""Asynchronous checkpoints with rotation, whole or as per-rank shards,
and the elastic restore onto another mesh (``repro.checkpoint``)."""

from repro_torch.checkpoint.manager import (CheckpointManager, restore_pytree,
                                            save_pytree)

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree"]
