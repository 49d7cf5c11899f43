"""Optimisers of the port (``repro/optim``)."""
from .optimizers import (
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    sgd,
)

__all__ = [
    "Optimizer",
    "adamw",
    "adafactor",
    "sgd",
    "cosine_schedule",
    "clip_by_global_norm",
]
