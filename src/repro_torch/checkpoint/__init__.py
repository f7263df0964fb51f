"""Checkpointing (the port of ``repro.checkpoint``): an npz shard + JSON
manifest per step, atomic rename, async writer thread, integrity hashes and
verified fallback on restore."""
from .manager import CheckpointManager, CheckpointMismatch

__all__ = ["CheckpointManager", "CheckpointMismatch"]
