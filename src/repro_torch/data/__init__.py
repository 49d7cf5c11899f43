"""Synthetic data of the port (``repro/data``)."""
from .pipeline import batch_shapes, synthetic_batch

__all__ = ["batch_shapes", "synthetic_batch"]
