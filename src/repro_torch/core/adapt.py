"""Blocking host-transfer telemetry (the adaptation engine arrives with its
own slice).

Every device->host read on the serving path goes through :func:`_fetch`,
so tests and ``ServeEngine.last_run_report["host_syncs"]`` count the
transfers instead of trusting them.
"""
from __future__ import annotations

from typing import Any

import torch

from ..utils import tree_map

_HOST_SYNCS = [0]


def host_sync_count() -> int:
    """Blocking device->host transfer events since the last reset."""
    return _HOST_SYNCS[0]


def reset_host_sync_count() -> None:
    _HOST_SYNCS[0] = 0


def _fetch(tree: Any) -> Any:
    """Materialise a tree of tensors on the host as numpy arrays: one
    blocking transfer event."""
    _HOST_SYNCS[0] += 1
    return tree_map(
        lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else x, tree)
