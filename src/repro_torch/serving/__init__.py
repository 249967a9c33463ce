"""Serving: the continuous-batching engine on contiguous or paged KV
caches, with sampling, fault injection, per-slot personalisation and its
online refresh loop, and the fleet router over engine replicas with the
delta exchange's wire codec."""
from .engine import (  # noqa: F401
    OUTCOME_NAMES, DeltaSet, PendingBuffer, Request, ServeEngine, SlotState,
    SubmitResult, fold_deltas,
)
from .faults import FaultConfig, parse_inject  # noqa: F401
from .fleet import (  # noqa: F401
    FleetRouter, decode_delta_payload, encode_delta_payload,
)
from .paging import (  # noqa: F401
    PagePool, PagingSpec, extend, free_page_count, make_pool, pages_in_use,
    release, reserve,
)
from .personalise import Personaliser  # noqa: F401
