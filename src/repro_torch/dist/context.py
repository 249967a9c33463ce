"""Process-wide sharding context: the port of ``repro.dist.context``.

Launchers publish layout decisions here and the code below them reads
them, so the decisions need not thread through every call signature:

    with context.sharding_context(fleet_mesh=mesh):
        run(...)

Keys in use:
  - ``fleet_mesh``: :class:`~.mesh.Mesh` | None: the fleet-adaptation
    mesh, published by ``TinyTrainSession.adapt_many`` around its fleet
    fine-tune so ``EpisodeStepCache.vmap_scan_steps`` splits the task axis
    over the mesh's data positions.
  - ``fleet_hosts``: int | None: the number of hosts for per-host episode
    ingestion; ``adapt_many`` reads it as the default of its ``hosts``
    argument, so a launcher can opt a whole run into it.

Everything defaults to None, so single-device code never touches this
module.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator

_STATE: Dict[str, Any] = {}
_MISSING = object()


def get(key: str, default: Any = None) -> Any:
    return _STATE.get(key, default)


def set(key: str, value: Any) -> None:  # noqa: A001 - mirrors the dict API
    _STATE[key] = value


@contextlib.contextmanager
def sharding_context(**kwargs: Any) -> Iterator[None]:
    """Set context keys for the duration of a ``with`` block (re-entrant)."""
    saved = {k: _STATE.get(k, _MISSING) for k in kwargs}
    _STATE.update(kwargs)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is _MISSING:
                _STATE.pop(k, None)
            else:
                _STATE[k] = v
