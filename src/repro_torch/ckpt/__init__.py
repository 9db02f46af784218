"""Checkpoint store of the port (counterpart of ``repro/ckpt``)."""

from .checkpoint import (CheckpointManager, latest_step,  # noqa: F401
                         load_checkpoint, load_named_tree, restore_or_none,
                         save_checkpoint)
