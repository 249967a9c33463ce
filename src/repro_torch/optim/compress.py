"""Per-row int8 packing: the port of ``repro.optim.compress``'s
``rowwise_quant`` and ``rowwise_dequant``.

The pack side of the paged int8 KV store (``serving/paging.py``): a row
is one token's head×dim block, and its own absmax scale keeps incremental
cache appends exact (a page never needs requantising).  The arithmetic is
the JAX package's, step for step in float32: ``scale = absmax/127 +
1e-12``, ``q = clip(round(x / scale), -127, 127)``.  ``torch.round`` and
``jnp.round`` both round half to even, so the codes come out equal, not
merely close.

The error-feedback compressor (``int8_compress``/``int8_decompress`` and
its state) arrives with ROADMAP queue 1, item 15.
"""
from __future__ import annotations

from typing import Tuple

import torch


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
