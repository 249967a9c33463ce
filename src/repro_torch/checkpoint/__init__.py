"""Atomic keep-N checkpoints in the JAX package's on-disk format."""
from .manager import CheckpointError, CheckpointManager  # noqa: F401
