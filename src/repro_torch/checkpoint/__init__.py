"""Checkpointing of the port (``repro/checkpoint``)."""
from .store import latest_step, restore_checkpoint, save_checkpoint, wait_for_saves

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "wait_for_saves",
]
