"""Training state, the torch-path step, and (in ``train.loop``) the engine."""

from .state import ADAM_B1, ADAM_B2, ADAM_EPS, TrainState, adam_update_, moment_dtype
from .step import eval_step, generate, sample_z, train_chunk

__all__ = [
    "ADAM_B1", "ADAM_B2", "ADAM_EPS", "TrainState", "adam_update_", "moment_dtype",
    "eval_step", "generate", "sample_z", "train_chunk",
]
