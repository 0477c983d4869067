"""Checkpointing: atomic, async, restorable onto any device."""

from repro_torch.checkpoint.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
