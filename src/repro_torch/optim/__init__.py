"""Optimisers for the sparse fine-tune and the baselines (float32 moment
math)."""
from .optimizers import (  # noqa: F401
    Optimizer, adam, apply_updates, clip_by_global_norm, momentum, sgd,
)
