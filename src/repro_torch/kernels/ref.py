"""Plain PyTorch versions of the port's kernels.

The CPU tests run them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  Nothing on the main path calls them when the
tensors lie on a card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _sum_sq_rows(u: torch.Tensor, mask: Optional[torch.Tensor], scale: float,
                 mask_norm: bool) -> torch.Tensor:
    """The Fisher kernel's reduction over rows: u (..., N, C) float32 ->
    (..., C) = scale · Σ_n m_n² u_n², divided by max(Σ m, 1) when
    ``mask_norm``.  Rows with m == 0 contribute exactly 0, whatever they
    hold."""
    u2 = u * u
    if mask is not None:
        m = mask.float()
        u2 = torch.where((m != 0)[:, None], u2 * (m * m)[:, None], 0.0)
    out = u2.sum(dim=-2) * scale
    if mask is not None and mask_norm:
        out = out / torch.clamp(m.sum(), min=1.0)
    return out


def fisher_ref(a: torch.Tensor, g: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 2: Δ_o = 1/(2N) Σ_n (Σ_d a·g)², a, g (N, D, C) -> (C,) float32.

    With a (N,) ``mask`` the rows weigh m_n² (0 for padding) and the
    normaliser is the valid count ``max(Σ m, 1)``, so a bucket-padded batch
    scores like the unpadded one (the JAX package's ``ops.fisher``)."""
    u = (a.float() * g.float()).sum(dim=1)                     # (N, C)
    if mask is None:
        return _sum_sq_rows(u, None, 1.0 / (2.0 * a.shape[0]), False)
    return _sum_sq_rows(u, mask, 0.5, True)


def fisher_tapgrads_ref(g: torch.Tensor, n: float,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 2 from tap gradients: g (L, B, C) is already the inner sum u, so
    Δ = Σ_b m_b² g² / (2n) -> (L, C) float32, ``n`` the valid-sample
    count."""
    return _sum_sq_rows(g.float(), mask, 1.0 / (2.0 * float(n)), False)


def flash_attention_cached_ref(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k: torch.Tensor,         # (B, Sk, Hkv, D)
    v: torch.Tensor,
    *,
    q_offset: torch.Tensor,  # (B,) int: absolute position of q[:, 0]
    kv_len: torch.Tensor,    # (B,) int: valid cache rows
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Cached block attention with the CUDA kernel's exact contract.

    Query ``i`` of sample ``b`` sits at absolute position
    ``q_offset[b] + i`` and attends to cache rows ``kpos`` with
    ``kpos < kv_len[b]``, plus ``kpos <= qpos`` when causal and
    ``kpos > qpos - window`` when ``window > 0``.  Query head ``h`` reads
    kv head ``h // (Hq / Hkv)``.  Scores are scaled by ``1/sqrt(D)``; the
    softmax statistics and the sum are float32; a row with no valid key
    gives 0.  Cache rows that no query of the sample can see are never
    read, as in the kernel, so a non-finite stale row (left by an earlier
    stream in the slot) cannot reach the output.  Returns (B, Sq, Hq, D)
    in q's dtype.
    """
    return _attend_rows(q, k, v, q_offset=q_offset, kv_len=kv_len,
                        causal=causal, window=window)


def _attend_rows(q, k, v, *, q_offset, kv_len, causal, window,
                 row_ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The cached attention over logical cache rows k/v (B, Sk, Hkv, D);
    ``row_ok`` (B, Sk) marks the rows that exist (a row behind an unmapped
    page does not), and a row that does not is masked and never read."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    q_offset, kv_len = q_offset.to(torch.int64), kv_len.to(torch.int64)
    kpos = torch.arange(sk, device=q.device)[None, None, :]     # (1, 1, Sk)
    hi = torch.minimum(kv_len, q_offset + sq) if causal else kv_len
    seen = kpos[:, 0] < hi[:, None]                              # (B, Sk)
    if window > 0:
        seen = seen & (kpos[:, 0] > q_offset[:, None] - window)
    if row_ok is not None:
        seen = seen & row_ok
    seen = seen[:, :, None, None]

    def rows(x):
        x = torch.where(seen, x.float(), 0.0)
        return x.repeat_interleave(group, dim=2)

    kf, vf = rows(k), rows(v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(d)
    qpos = q_offset[:, None] + torch.arange(sq, device=q.device)[None, :]
    mask = kpos < kv_len[:, None, None]
    if row_ok is not None:
        mask = mask & row_ok[:, None, :]
    if causal:
        mask = mask & (kpos <= qpos[..., None])
    if window > 0:
        mask = mask & (kpos > qpos[..., None] - window)
    mask = mask[:, None]                                         # (B,1,Sq,Sk)
    s = torch.where(mask, s, torch.full_like(s, -math.inf))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - torch.where(mask, m, 0.0)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    out = out / l.clamp_min(1e-30).permute(0, 2, 1, 3)
    return out.to(q.dtype)


def flash_attention_paged_ref(
    q: torch.Tensor,           # (B, Sq, Hq, D)
    k_pages: torch.Tensor,     # (n_pages, page_size, Hkv, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int; -1 = unmapped
    *,
    q_offset: torch.Tensor,    # (B,) int
    kv_len: torch.Tensor,      # (B,) int
) -> torch.Tensor:
    """Causal cached block attention over a paged arena, the paged CUDA
    kernel's contract: logical cache row ``r`` of sample ``b`` is row
    ``r % page_size`` of page ``page_table[b, r // page_size]``; a row
    behind a -1 entry is masked and never read.  Otherwise the contract
    of :func:`flash_attention_cached_ref` with ``causal=True`` and no
    window: float32 statistics, a row that sees no key gives 0, and rows
    no query can see (stale rows of a recycled page) never reach the
    output.  Returns (B, Sq, Hq, D) in q's dtype."""
    n_pages, ps = k_pages.shape[:2]
    b, mp = page_table.shape
    table = page_table.long()
    page = table.clamp(0, n_pages - 1)
    k = k_pages[page].reshape((b, mp * ps) + tuple(k_pages.shape[2:]))
    v = v_pages[page].reshape((b, mp * ps) + tuple(v_pages.shape[2:]))
    row_ok = (table >= 0).repeat_interleave(ps, dim=1)        # (B, cap)
    return _attend_rows(q, k, v, q_offset=q_offset, kv_len=kv_len,
                        causal=True, window=0, row_ok=row_ok)


def grad_quant_ref(g: torch.Tensor, err: torch.Tensor):
    """Int8 error-feedback quantisation of one tensor, in float32: (q int8,
    scale 0-d float32, new_err float32), all on g's device.

    ``scale = max|g32|/127 + 1e-12`` with ``g32 = float(g) + err``, ``q =
    clip(round(g32/scale), -127, 127)`` (round half to even) and ``new_err
    = g32 - q·scale``.  Both divisions divide by a tensor: on the card,
    PyTorch turns a division by a Python number into a multiplication by
    its reciprocal, which can round differently from the kernel's and the
    JAX package's division."""
    g32 = g.float() + err
    scale = g32.abs().amax() / torch.full((), 127.0, device=g.device) + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale, g32 - q.float() * scale
