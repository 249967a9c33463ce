"""The fault-tolerant trainer."""
from .trainer import (  # noqa: F401
    SimulatedFailure, Trainer, TrainerConfig, TrainerState, failure_at,
)
