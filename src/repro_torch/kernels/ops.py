"""Public entry points of the port's kernels, dispatched by device.

A tensor on the CPU (or the meta device of the dry run) runs the kernel's
plain PyTorch version; a tensor on a card launches the hand-written kernel
and never the plain version (the kernel wrapper raises on what it does not
take).  Each entry counts its kernel launches in a plain integer
attribute, ``<entry>.launches``, so a run can show that its main path went
through the kernel (``ssd_scan`` also counts its backward's in
``ssd_scan.bwd_launches``; its two ``torch.autograd.Function`` classes
count where they launch, so a launch that a ``torch.func.vmap`` folds for
many tasks counts once).

Entries: ``fisher``/``fisher_auto``/``fisher_tapgrads`` (Eq. 2),
``flash_attention`` (aligned: whole sequences, positions from 0),
``flash_attention_cached`` (a query block per slot against its cache),
``flash_attention_paged`` (the same over a paged arena), ``grad_quant``
(int8 error feedback) and ``ssd_scan`` (the Mamba2 scan, with its
backward under autograd).
"""
from __future__ import annotations

import torch

from .fisher import fisher_cuda, tapgrads_cuda
from .flash_aligned import flash_attention_aligned_cuda
from .flash_attention import flash_attention_cached_cuda
from .flash_paged import flash_attention_paged_cuda
from .grad_quant import grad_quant_cuda
from .ref import (
    fisher_ref, fisher_tapgrads_ref, flash_attention_cached_ref,
    flash_attention_paged_ref, flash_attention_ref, grad_quant_ref,
    ssd_scan_ref,
)
from .ssd_scan import SSDScanFn


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` goes to the kernel: on a card yes; on the CPU, and on
    the meta device (the dry run's shape-only tensors, which no kernel can
    read), the plain version runs and no launch is counted."""
    if t.device.type in ("cpu", "meta"):
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
    The kernel reads g in place with no activation operand.

    With a task axis (a fleet's probe), g (T, L, B, C), mask (T, B) and n
    a (T,) tensor of valid counts -> (T, L, C).  Either form is one launch
    of the task-axis route, which reads n on the device (one task's is
    T = 1); task t's scores equal a one-task call's on g[t]."""
    if g.dim() not in (3, 4):
        raise ValueError(f"expected (L, B, C) or (T, L, B, C) tap gradients, "
                         f"got {tuple(g.shape)}")
    if not _on_card(g):
        return fisher_tapgrads_ref(g, n, mask)
    one = g.dim() == 3
    mask = _mask_f32(mask)
    if one:
        g, mask = g[None], None if mask is None else mask[None]
        n = torch.full((1,), float(n), dtype=torch.float32, device=g.device)
    else:
        n = torch.as_tensor(n, device=g.device).to(torch.float32)
    out = tapgrads_cuda(g.contiguous(), n.contiguous(),
                        None if mask is None else mask.contiguous())
    fisher_tapgrads.launches += 1
    return out[0] if one else out


fisher_tapgrads.launches = 0


def flash_attention(q, k, v, *, causal=True, window=0) -> torch.Tensor:
    """Aligned attention of whole sequences: q (B, Sq, Hq, D) against k, v
    (B, Sk, Hkv, D), positions from 0 on both axes, causal and/or a
    sliding ``window`` (see ``ref.flash_attention_ref``)."""
    if not _on_card(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    out = flash_attention_aligned_cuda(q, k, v, causal=causal, window=window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


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


def ssd_scan(x, dt, a, bmat, cmat, *, chunk=256, init_state=None,
             want_state=True, out_dtype=None):
    """Mamba2 SSD scan: (y (B, S, H, P), final state (B, H, P, N) float32,
    or None when not ``want_state`` on the card), the recurrence ``S_t =
    exp(dt_t·a) S_{t-1} + (x_t·dt_t) ⊗ B_t``, ``y_t = S_t C_t`` from
    ``init_state`` (zeros when None).  y comes in ``out_dtype``, by default
    x's dtype as ``ssd_scan_pallas`` returns it.  ``S % min(chunk, S)``
    must be 0, as ``ssd_chunked`` asserts.  On the card the forward and,
    under autograd, the backward are the hand-written kernels
    (:class:`~.ssd_scan.SSDScanFn`); gradients reach x, dt, B and C.
    Under ``torch.func.vmap`` the task axis folds into the kernels' batch:
    one launch each way for every task."""
    out_dtype = out_dtype or x.dtype
    if not _on_card(x):
        q = min(int(chunk), x.shape[1])
        if q < 1 or x.shape[1] % q:
            raise ValueError(f"sequence length {x.shape[1]} is not a multiple "
                             f"of the chunk {q}")
        y, st = ssd_scan_ref(x.float(), dt, a, bmat, cmat, init_state)
        return y.to(out_dtype), st
    y, st = SSDScanFn.apply(
        x.contiguous(), dt.contiguous(), a.contiguous(), bmat.contiguous(),
        cmat.contiguous(), None if init_state is None
        else init_state.float().contiguous(), int(chunk), bool(want_state))
    return y.to(out_dtype), st


ssd_scan.launches = 0
ssd_scan.bwd_launches = 0
