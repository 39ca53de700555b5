"""Checkpoints of array trees: store snapshots and train states."""
from .checkpoint import (CheckpointManager, latest_step,  # noqa: F401
                         restore_checkpoint, save_checkpoint)
