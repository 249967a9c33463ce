"""Optimisers for the sparse fine-tune, the baselines and the training
launcher (float32 moment math), and their lr schedules."""
from .optimizers import (  # noqa: F401
    Optimizer, adam, apply_updates, clip_by_global_norm, momentum, sgd,
)
from .schedule import constant, warmup_cosine  # noqa: F401
from .compress import int8_compress, int8_decompress, ef_state_init  # noqa: F401
