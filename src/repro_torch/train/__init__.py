"""The training step of the port (``repro/train``)."""
from .step import TrainState, init_train_state, make_train_step

__all__ = ["TrainState", "make_train_step", "init_train_state"]
