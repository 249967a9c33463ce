"""A mesh of device positions driven from one process.

The JAX package's fleet path drives every local device from one host with
one dispatch (``shard_map`` over a ``jax.sharding.Mesh``).  The port keeps
that shape: a :class:`Mesh` names its axes, their sizes and one
``torch.device`` per position, and the fleet code runs each data shard's
work on its position's device from the same process.  (``torch.distributed``'s
``DeviceMesh`` needs one process per device, which is not this path.)
Devices may repeat, so a ("data",) mesh of 2 or 8 positions can sit on one
card or on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import DeviceLike, resolve_device


def resolve_devices(devices: Optional[Sequence[DeviceLike]],
                    what: str) -> List[torch.device]:
    """``devices`` as torch devices, a bare "cuda" as the current card; by
    default every visible CUDA device, and with none visible ``what``
    raises (pass ``devices=["cpu"]`` for the plain path): never a silent
    fall-back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what}: no CUDA device is visible; pass devices= (e.g. "
                "['cpu']) to run on the plain path")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError(f"{what} needs at least one device")
    return out


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of given sizes over one device a position, row-major."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"axis sizes must be >= 1, got {self.sizes}")
        if len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size} positions")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis -> size, as ``jax.sharding.Mesh.shape`` reads."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    def device_at(self, index: Sequence[int]) -> torch.device:
        """The device of the position at ``index`` (one coordinate an
        axis)."""
        return self.devices[int(np.ravel_multi_index(tuple(index),
                                                     self.sizes))]


def make_mesh(sizes: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh over ``devices`` taken round-robin in position order, by
    default every visible CUDA device (:func:`resolve_devices`)."""
    devs = resolve_devices(devices, "make_mesh")
    n = int(np.prod([int(s) for s in sizes]))
    return Mesh(tuple(axis_names), tuple(int(s) for s in sizes),
                tuple(devs[i % len(devs)] for i in range(n)))
