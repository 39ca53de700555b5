"""Snapshots of named numpy arrays (the store's durability layout)."""
from .checkpoint import (latest_step, restore_checkpoint,  # noqa: F401
                         save_checkpoint)
