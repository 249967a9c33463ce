"""Serving: the continuous-batching engine on contiguous or paged KV
caches."""
from .engine import (  # noqa: F401
    OUTCOME_NAMES, PendingBuffer, Request, ServeEngine, SlotState,
    SubmitResult,
)
from .paging import PagePool, PagingSpec  # noqa: F401
