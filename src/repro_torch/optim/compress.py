"""Int8 packing: the port of ``repro.optim.compress``.

Two users.  **Error feedback** (``int8_compress``/``int8_decompress`` and
the state ``ef_state_init``): the personalisation path ships every
refreshed delta set as int8 codes and one float32 scale per tensor, 4x
fewer bytes than float32, and carries the quantisation residual per user
into the next round, so the exchange stays unbiased over rounds.  A leaf
on the card goes through the hand-written grad_quant kernel
(``kernels.ops.grad_quant``, one launch, no host read of the scale); a
leaf on the CPU through its plain version.  **Per-row packing**
(``rowwise_quant``/``rowwise_dequant``): the pack side of the paged int8
KV store (``serving/paging.py``), where a row is one token's head×dim
block and its own absmax scale keeps incremental cache appends exact.

The arithmetic is the JAX package's, step for step in float32: ``scale =
absmax/127 + 1e-12``, ``q = clip(round(x / scale), -127, 127)``.
``torch.round`` and ``jnp.round`` both round half to even, so the codes
come out equal, not merely close.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..kernels import ops
from ..utils import tree_leaves, tree_map

PyTree = Any


def _quant_one(g: torch.Tensor, err: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf: (q int8, scale 0-d float32, new_err float32)."""
    return ops.grad_quant(g, err)


def int8_compress(grads: PyTree, ef: PyTree
                  ) -> Tuple[PyTree, PyTree, PyTree]:
    """Returns (int8 tree, scale tree, new error-feedback tree), each with
    the structure of ``grads``; ``ef`` is the float32 residual tree of the
    previous round (``ef_state_init`` for the first)."""
    # each leaf becomes a (q, scale, new_err) tuple: flattened, they come
    # out in leaf order three at a time
    flat = tree_leaves(tree_map(_quant_one, grads, ef))

    def unflatten(leaves):
        it = iter(leaves)
        return tree_map(lambda _: next(it), grads)

    return tuple(unflatten(flat[i::3]) for i in range(3))


def int8_decompress(q: PyTree, scales: PyTree,
                    dtype: torch.dtype = torch.float32) -> PyTree:
    return tree_map(lambda qi, si: (qi.float() * si).to(dtype), q, scales)


def ef_state_init(params: PyTree) -> PyTree:
    """A zero float32 residual per leaf of ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def rowwise_quant(x: torch.Tensor, n_feature_axes: int = 1,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 pack, without error feedback.

    The trailing ``n_feature_axes`` axes form one quantisation row; the
    returned float32 ``scale`` has the leading (row-index) shape."""
    axes = tuple(range(x.dim() - n_feature_axes, x.dim()))
    x32 = x.float()
    scale = x32.abs().amax(dim=axes) / 127.0 + 1e-12
    sc = scale.reshape(scale.shape + (1,) * n_feature_axes)
    q = torch.clamp(torch.round(x32 / sc), -127, 127).to(torch.int8)
    return q, scale


def rowwise_dequant(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Unpack :func:`rowwise_quant` output: broadcast each row's scale over
    its feature axes."""
    sc = scale.reshape(scale.shape + (1,) * (q.dim() - scale.dim()))
    return (q.float() * sc).to(dtype)
