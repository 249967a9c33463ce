"""Mesh construction for the fleet path: the port of ``repro.launch.mesh``.

``make_debug_mesh`` lays ("data", "model") positions over the given
devices, or every visible CUDA device, round-robin; devices may repeat, so
a mesh of 2 or 8 data positions sits on one card or on the CPU:

    mesh = make_debug_mesh(2, devices=["cuda:0", "cuda:0"])
    session.adapt_many(tasks, profile, mesh=mesh)

(``make_production_mesh``, a TPU pod's 256 or 512 chips, waits for
ROADMAP item 22 with ``launch/dryrun.py``; ``launch.train
--production-mesh`` raises until then.)
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..dist.mesh import Mesh, make_mesh
from ..utils import DeviceLike


def make_debug_mesh(n_devices: int = 1, model: int = 1,
                    devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A (data, model) mesh of ``n_devices`` positions (data = n_devices //
    model, at least 1)."""
    data = max(1, n_devices // model)
    return make_mesh((data, model), ("data", "model"), devices)
