"""Synthetic data (numpy, host side)."""
from .synthetic import (  # noqa: F401
    Episode, augment_lm_support, lm_episode, markov_tokens,
)
