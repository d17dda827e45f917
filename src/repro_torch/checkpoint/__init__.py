"""Atomic, async checkpoints in the reference package's on-disk layout."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
