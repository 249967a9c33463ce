"""The JAX package's sample draws in torch: Threefry-2x32 keys, bits, the
uniform and the Gumbel noise of ``jax.random`` under its default
implementation (``threefry2x32`` with the partitionable bit layout).

The serving engine samples token ``t`` of request ``s`` from
``fold_in(fold_in(key(seed), s), t)``, as the JAX engine does, so a port
stream draws the JAX engine's own samples.  Every word is a uint32 held in
an int64 tensor and masked to 32 bits after each add and rotate, so no
intermediate reaches 2^63 and no ``torch.uint32`` op is needed.  All of it
runs on the device of its inputs with no host read, so a sampled tick
stays free of syncs.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32's smallest normal: the uniform's lower bound in jax.random.gumbel
_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds on broadcastable int64 words in
    [0, 2^32): returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s words, (2,) int64, as JAX makes them
    with 64-bit integers off: (0, seed mod 2**32) for any integer seed, so
    a negative seed wraps and a seed of 2**32 or more loses its high
    bits."""
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` row by row: ``keys`` (..., 2), ``data`` (...)
    integers (negative ones wrap to uint32, as a cast does).  Returns the
    new keys, (..., 2) int64."""
    d = data.to(torch.int64) & _M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` for each row of ``keys`` (R, 2):
    the partitionable layout counts (0, i) and xors the two output words.
    Returns (R, n) int64 in [0, 2^32)."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), minval=tiny, maxval=1)`` per row, the
    uniform under ``jax.random.gumbel``: 23 bits as a float in [1, 2),
    minus 1, scaled to [tiny, 1)."""
    b = (bits(keys, n) >> 9) | 0x3F800000
    u = b.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(u * (1.0 - _TINY) + _TINY, _TINY)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` per row: ``-log(-log(u))``."""
    return -torch.log(-torch.log(uniform(keys, n)))
