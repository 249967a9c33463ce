"""Carry the JAX package's trees into the port and back, as numpy.

The JAX package draws weights with ``jax.random``, which torch cannot
reproduce, so parity runs load the reference's own weights.  The caller
converts a JAX tree to numpy (``jax.tree_util.tree_map(np.asarray,
tree)``); this module turns that numpy tree into tensors, keeping the
``stacks/g{i}`` grouping and the ``(d_in, d_out)`` layout so ``x @ W``
matches leaf for leaf.  Delta packs (``{"L{i}": {kind: {weight: ...}}}``),
optimiser states (``{"step", "m", "v"}``) and the error-feedback
compressor's trees (int8 codes, 0-d float32 scales, float32 residuals)
cross the same way in both directions, so tests compare them leaf for
leaf.  Paged KV stores cross
with :func:`page_store_from_numpy`, which keeps the port's arena layout.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .models.api import ArchConfig
from .models.transformer import check_supported
from .serving import paging as PG
from .utils import DeviceLike, resolve_device, tree_map


def tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """One numpy array as a tensor on ``device``.  bfloat16 arrays (numpy
    has no such type; JAX hands them over as ``ml_dtypes.bfloat16``) go
    through float32, which holds every bfloat16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(cfg: ArchConfig, tree: Any, *,
                      device: DeviceLike = "cuda") -> Any:
    """The JAX parameter tree, as numpy arrays, as the port's params."""
    check_supported(cfg)
    return tree_from_numpy(tree, device=device)


def tree_from_numpy(tree: Any, *, device: DeviceLike = "cuda") -> Any:
    """Any numpy tree (params, delta packs, optimiser states) as tensors."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree)


def tree_to_numpy(tree: Any) -> Any:
    """A tree of tensors as numpy arrays (bfloat16 as float32, exactly)."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, tree)


def page_store_from_numpy(store: Any, *, device: DeviceLike = "cuda") -> Any:
    """A JAX page store (``{"pages": (n_pages, page_size, *feat)[,
    "scale"]}`` as numpy) as the port's, laid out as
    ``paging.store_init`` lays it out (with the spare row behind the
    arena that dropped writes go to)."""
    pages = np.asarray(store["pages"])
    spec = PG.PagingSpec(page_size=pages.shape[1], n_pages=pages.shape[0],
                         max_pages=1, int8=pages.dtype == np.int8)
    dtype = tensor_from_numpy(pages[:0], torch.device("cpu")).dtype
    out = PG.store_init(spec, pages.shape[2:], dtype, resolve_device(device))
    for name, t in out.items():
        t.copy_(tensor_from_numpy(store[name], t.device))
    return out
