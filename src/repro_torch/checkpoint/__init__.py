"""Fault-tolerant checkpointing in the reference's format: atomic writes,
rotation, async, auto-resume."""
from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    load_pytree, restore_checkpoint, save_checkpoint, snapshot,
)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
