"""Serving: the continuous-batching engine on contiguous or paged KV
caches, with sampling, fault injection, per-slot personalisation and its
online refresh loop, and the fleet router over engine replicas with the
delta exchange's wire codec."""
from .engine import (  # noqa: F401
    OUTCOME_NAMES, DeltaSet, PendingBuffer, Request, ServeEngine, SlotState,
    SubmitResult,
)
from .faults import FaultConfig, parse_inject  # noqa: F401
from .fleet import (  # noqa: F401
    FleetRouter, decode_delta_payload, encode_delta_payload,
)
from .paging import PagePool, PagingSpec  # noqa: F401
from .personalise import Personaliser  # noqa: F401
