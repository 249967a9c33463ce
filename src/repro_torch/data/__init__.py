"""Synthetic data and its resumable loaders (numpy, host side)."""
from .pipeline import EpisodeStream, TokenLoader  # noqa: F401
from .synthetic import (  # noqa: F401
    DOMAINS, Episode, augment_encdec_support, augment_lm_support,
    augment_support, encdec_episode, lm_episode, markov_tokens,
    sample_episode,
)
