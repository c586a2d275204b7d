"""Training of the port: paramwise AdamW with poly lr, train state, train step,
checkpoints."""

from .checkpoint import CheckpointManager
from .optim import OptimConfig, build_optimizer, paramwise_multipliers, poly_schedule
from .state import TrainState
from .step import device_normalize, make_train_step

__all__ = [
    "CheckpointManager",
    "OptimConfig",
    "build_optimizer",
    "paramwise_multipliers",
    "poly_schedule",
    "TrainState",
    "device_normalize",
    "make_train_step",
]
