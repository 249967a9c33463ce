"""Optimisers for the sparse fine-tune (float32 moment math)."""
from .optimizers import Optimizer, adam, apply_updates  # noqa: F401
