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

The edge CNNs' trees (params as a list of ``{"w", "b"}``, delta packs
``{"L{i}": {"conv": {"w"}}}`` and Adam states over them) cross with
:func:`cnn_tree_from_numpy` / :func:`cnn_tree_to_numpy`: every 4-d leaf
is a conv kernel, HWIO in the JAX package and OIHW in the port (a
depthwise ``(k, k, 1, C)`` is ``(C, 1, k, k)``), and the other leaves
cross unchanged.  TinyTL's adapters (``{"b{i}": {"w1", "w2"}}``, 4-d
kernels) cross with :func:`tinytl_adapters_from_numpy`, checked against
the port's own adapter shapes.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from .models.api import ArchConfig
from .models.edge_cnn import CnnConfig
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


def params_from_numpy(cfg: Union[ArchConfig, CnnConfig], tree: Any, *,
                      device: DeviceLike = "cuda") -> Any:
    """The JAX parameter tree, as numpy arrays, as the port's params (an
    LM's or an edge CNN's, by the config's type)."""
    if isinstance(cfg, CnnConfig):
        return cnn_params_from_numpy(cfg, tree, device=device)
    check_supported(cfg)
    return tree_from_numpy(tree, device=device)


def cnn_params_from_numpy(cfg: CnnConfig, tree: Any, *,
                          device: DeviceLike = "cuda") -> Any:
    """An edge CNN's JAX params (a list of ``{"w": HWIO, "b"}``) as the
    port's OIHW params, checked layer by layer against ``cfg``."""
    if len(tree) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(tree)} layers of params for "
                         f"{cfg.n_layers} conv layers")
    out = cnn_tree_from_numpy(tree, device=device)
    for i, (spec, p) in enumerate(zip(cfg.layers, out)):
        c_in = 1 if spec.kind == "dw" else spec.c_in
        if tuple(p["w"].shape) != (spec.c_out, c_in, spec.k, spec.k):
            raise ValueError(f"{cfg.name} layer {i}: weight of shape "
                             f"{tuple(p['w'].shape)} for {spec}")
    return out


def cnn_tree_from_numpy(tree: Any, *, device: DeviceLike = "cuda") -> Any:
    """An edge CNN's numpy tree (params, delta packs, Adam states) as
    tensors, every 4-d leaf HWIO -> OIHW."""
    dev = resolve_device(device)

    def one(a):
        t = tensor_from_numpy(a, dev)
        return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t

    return tree_map(one, tree)


def tinytl_adapters_from_numpy(cfg: CnnConfig, tree: Any, *,
                               device: DeviceLike = "cuda") -> Any:
    """The JAX package's TinyTL adapters (``tinytl_adapter_init``: HWIO
    ``w1`` (3, 3, c_in, r) and ``w2`` (1, 1, r, c_out) a block) as the
    port's OIHW adapters, checked block by block against
    ``core.baselines.tinytl_blocks``."""
    from .core.baselines import tinytl_blocks

    want = {f"b{b}": {"w1": (r, cin, 3, 3), "w2": (cout, r, 1, 1)}
            for b, cin, r, cout in tinytl_blocks(cfg)}
    out = cnn_tree_from_numpy(tree, device=device)
    got = {k: {w: tuple(t.shape) for w, t in v.items()}
           for k, v in out.items()}
    if got != want:
        raise ValueError(f"{cfg.name}: TinyTL adapters of shapes {got}, "
                         f"expected {want}")
    return out


def cnn_tree_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`cnn_tree_from_numpy`: every 4-d leaf OIHW ->
    HWIO, as numpy."""
    return tree_map(lambda a: (np.ascontiguousarray(a.transpose(2, 3, 1, 0))
                               if a.ndim == 4 else a), tree_to_numpy(tree))


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
