"""Mesh construction: the port of ``repro.launch.mesh``.

Both builders lay named positions over the given devices, or every visible
CUDA device, round-robin (:func:`~..dist.mesh.make_mesh`); devices may
repeat, so a mesh of many positions sits on one card, on the CPU or, for
the dry run's shapes only, on the meta device:

    mesh = make_debug_mesh(2, devices=["cuda:0", "cuda:0"])
    session.adapt_many(tasks, profile, mesh=mesh)

``make_production_mesh`` is the JAX package's pod layout, ("data",
"model") = (16, 16), or ("pod", "data", "model") = (2, 16, 16) with
``multi_pod``: ``launch.dryrun`` plans every cell on it and ``launch.train
--production-mesh`` prints it.  Larger topologies only change the sizes.
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


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[DeviceLike]] = None
                         ) -> Mesh:
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the (2,
    16, 16) ("pod", "data", "model") one: 256 or 512 positions."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), devices)
    return make_mesh((16, 16), ("data", "model"), devices)
