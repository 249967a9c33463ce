"""Serving: the continuous-batching engine on contiguous KV caches."""
from .engine import (  # noqa: F401
    OUTCOME_NAMES, PendingBuffer, Request, ServeEngine, SlotState,
    SubmitResult,
)
