"""Public entry points of the port's kernels, dispatched by device.

A tensor on the CPU runs the kernel's plain PyTorch version; a tensor on a
card launches the hand-written kernel and never the plain version (the
kernel wrapper raises on what it does not take).  Each entry counts its
kernel launches in a plain integer attribute, ``<entry>.launches``, so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from .fisher import fisher_cuda
from .flash_attention import flash_attention_cached_cuda
from .flash_paged import flash_attention_paged_cuda
from .grad_quant import grad_quant_cuda
from .ref import (
    fisher_ref, fisher_tapgrads_ref, flash_attention_cached_ref,
    flash_attention_paged_ref, grad_quant_ref,
)


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def _mask_f32(mask):
    return None if mask is None else mask.to(torch.float32).contiguous()


def fisher(a, g, *, mask=None) -> torch.Tensor:
    """Fused Eq. 2 reduction of materialised activations and gradients,
    a, g (N, D, C) -> (C,) float32.  ``mask`` is an optional (N,) validity
    vector: padded rows contribute zero and the 1/(2N) normaliser uses the
    valid count, so bucket-padded batches score like unpadded ones."""
    if a.dim() != 3 or a.shape != g.shape:
        raise ValueError(f"expected matching (N, D, C) operands, got "
                         f"{tuple(a.shape)} vs {tuple(g.shape)}")
    if not _on_card(g):
        return fisher_ref(a, g, mask)
    out = fisher_cuda(g.contiguous(), a.contiguous(), mask=_mask_f32(mask),
                      scale=0.5 if mask is not None else 1.0 / (2 * a.shape[0]),
                      mask_norm=mask is not None)
    fisher.launches += 1
    return out


fisher.launches = 0


def fisher_auto(a, g, *, mask=None) -> torch.Tensor:
    """The JAX package's production entry for the materialised probe.
    There it picks Pallas blocks or falls back to the plain formula for
    shapes no block tiles; the CUDA kernel masks its own ragged edges, so
    here every shape goes to :func:`fisher`."""
    return fisher(a, g, mask=mask)


def fisher_tapgrads(g, n, mask=None) -> torch.Tensor:
    """Eq. 2 channel scores from the probe's tap gradients, g (L, B, C) ->
    (L, C) float32: Δ = Σ_b g² / (2n), rows weighted by the optional (B,)
    validity ``mask``; ``n`` (a Python number) is the valid-sample count.
    The kernel reads g in place with no activation operand."""
    if g.dim() != 3:
        raise ValueError(f"expected (L, B, C) tap gradients, got "
                         f"{tuple(g.shape)}")
    if not _on_card(g):
        return fisher_tapgrads_ref(g, n, mask)
    out = fisher_cuda(g.contiguous(), mask=_mask_f32(mask),
                      scale=1.0 / (2.0 * float(n)), per_layer=True)
    fisher_tapgrads.launches += 1
    return out


fisher_tapgrads.launches = 0


def flash_attention_cached(q, k, v, *, q_offset, kv_len, causal=True,
                           window=0) -> torch.Tensor:
    """Cached block attention: sample b's queries sit at absolute positions
    ``q_offset[b] + i`` against cache rows ``kpos < kv_len[b]`` (see
    ``ref.flash_attention_cached_ref`` for the contract)."""
    if not _on_card(q):
        return flash_attention_cached_ref(q, k, v, q_offset=q_offset,
                                          kv_len=kv_len, causal=causal,
                                          window=window)
    out = flash_attention_cached_cuda(
        q, k, v, q_offset=q_offset.to(torch.int32),
        kv_len=kv_len.to(torch.int32), causal=causal, window=window)
    flash_attention_cached.launches += 1
    return out


flash_attention_cached.launches = 0


def flash_attention_paged(q, k_pages, v_pages, page_table, *, q_offset,
                          kv_len) -> torch.Tensor:
    """Causal cached block attention over a paged arena: sample b's cache
    row r lives in page ``page_table[b, r // page_size]`` (see
    ``ref.flash_attention_paged_ref`` for the contract)."""
    if not _on_card(q):
        return flash_attention_paged_ref(q, k_pages, v_pages, page_table,
                                         q_offset=q_offset, kv_len=kv_len)
    out = flash_attention_paged_cuda(
        q, k_pages, v_pages, page_table.to(torch.int32).contiguous(),
        q_offset=q_offset.to(torch.int32), kv_len=kv_len.to(torch.int32))
    flash_attention_paged.launches += 1
    return out


flash_attention_paged.launches = 0


def grad_quant(g, err):
    """Int8 error-feedback quantisation of one tensor: (q int8, scale 0-d
    float32, new_err float32), ``scale = max|g + err|/127 + 1e-12`` (see
    ``ref.grad_quant_ref``).  On the card the scale stays on the device:
    nothing here reads it."""
    if not _on_card(g):
        return grad_quant_ref(g, err)
    out = grad_quant_cuda(g.contiguous(), err.contiguous())
    grad_quant.launches += 1
    return out


grad_quant.launches = 0
