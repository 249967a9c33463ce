"""Public entry points of the port's kernels, dispatched by device.

A tensor on the CPU runs the kernel's plain PyTorch version; a tensor on a
card launches the hand-written kernel and never the plain version (the
kernel wrapper raises on what it does not take).  Each entry counts its
kernel launches in a plain integer attribute, ``<entry>.launches``, so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_cached_cuda
from .ref import flash_attention_cached_ref


def flash_attention_cached(q, k, v, *, q_offset, kv_len, causal=True,
                           window=0) -> torch.Tensor:
    """Cached block attention: sample b's queries sit at absolute positions
    ``q_offset[b] + i`` against cache rows ``kpos < kv_len[b]`` (see
    ``ref.flash_attention_cached_ref`` for the contract)."""
    if q.device.type == "cpu":
        return flash_attention_cached_ref(q, k, v, q_offset=q_offset,
                                          kv_len=kv_len, causal=causal,
                                          window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    out = flash_attention_cached_cuda(
        q, k, v, q_offset=q_offset.to(torch.int32),
        kv_len=kv_len.to(torch.int32), causal=causal, window=window)
    flash_attention_cached.launches += 1
    return out


flash_attention_cached.launches = 0
