"""Durable checkpoints of the port (same layout as ``repro.checkpoint``)."""

from repro_torch.checkpoint.ckpt import (
    CheckpointError,
    CheckpointManager,
    latest_step,
    load_leaves,
    load_manifest,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointError", "CheckpointManager", "latest_step", "load_leaves",
    "load_manifest", "restore_checkpoint", "save_checkpoint",
]
