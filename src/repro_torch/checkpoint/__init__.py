"""Atomic, async checkpoints in the reference package's on-disk layout,
and their restore onto another group of ranks."""
from .manager import CheckpointManager, LaneShard, restore_resharded

__all__ = ["CheckpointManager", "LaneShard", "restore_resharded"]
