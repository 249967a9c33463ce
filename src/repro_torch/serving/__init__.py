"""Serving: the continuous-batching engine on contiguous or paged KV
caches, with sampling, fault injection, per-slot personalisation and its
online refresh loop."""
from .engine import (  # noqa: F401
    OUTCOME_NAMES, DeltaSet, PendingBuffer, Request, ServeEngine, SlotState,
    SubmitResult,
)
from .faults import FaultConfig, parse_inject  # noqa: F401
from .paging import PagePool, PagingSpec  # noqa: F401
from .personalise import Personaliser  # noqa: F401
