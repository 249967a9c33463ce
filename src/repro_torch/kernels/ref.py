"""Plain PyTorch versions of the port's kernels.

The CPU tests run them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  Nothing on the main path calls them when the
tensors lie on a card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _sum_sq_rows(u: torch.Tensor, mask: Optional[torch.Tensor], scale,
                 mask_norm: bool) -> torch.Tensor:
    """The Fisher kernel's reduction over rows: u (..., N, C) float32 ->
    (..., C) = scale · Σ_n m_n² u_n², divided by max(Σ m, 1) when
    ``mask_norm``.  Rows with m == 0 contribute exactly 0, whatever they
    hold.  A task axis rides in front: u (T, L, N, C) with a (T, N) mask
    and a (T,) tensor ``scale``, each task reduced as it would be alone."""
    u2 = u * u
    if mask is not None:
        m = mask.float()
        # (N,) or (T, N) against u's rows: (..., N, 1)
        w = m.reshape(*m.shape[:-1], *[1] * (u.dim() - m.dim() - 1),
                      m.shape[-1], 1)
        u2 = torch.where(w != 0, u2 * (w * w), 0.0)
    if isinstance(scale, torch.Tensor):
        scale = scale.reshape(-1, *[1] * (u.dim() - 2))
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


def fisher_tapgrads_ref(g: torch.Tensor, n,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 2 from tap gradients: g (L, B, C) is already the inner sum u, so
    Δ = Σ_b m_b² g² / (2n) -> (L, C) float32, ``n`` the valid-sample
    count.  With a task axis, g (T, L, B, C), mask (T, B) and n (T,) ->
    (T, L, C), task t scaled by the float32 1 / (2 n_t), which is the
    one-task scale: each task's scores equal its own call's bit for bit."""
    if g.dim() == 4:
        n = torch.as_tensor(n, dtype=torch.float32, device=g.device)
        return _sum_sq_rows(g.float(), mask, 1.0 / (2.0 * n), False)
    return _sum_sq_rows(g.float(), mask, 1.0 / (2.0 * float(n)), False)


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    block: int = 512,
) -> torch.Tensor:
    """Aligned attention, the aligned CUDA kernel's contract: positions run
    from 0 on both axes, query ``i`` sees key ``j`` when ``j <= i``
    (causal) and ``j > i - window`` (``window > 0``); query head ``h``
    reads kv head ``h // (Hq / Hkv)`` (kv heads not repeated by the
    caller).  Scores scaled by ``1/sqrt(D)``, everything in float32, a row
    that sees no key gives 0 (the JAX oracle's NaN -> 0).  Query rows go
    ``block`` at a time, so a plain run at (1, 8192, 32, 8, 128) fits on a
    card.  Returns (B, Sq, Hq, D) in q's dtype."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(hq // hkv, dim=2)
    vf = v.float().repeat_interleave(hq // hkv, dim=2)
    kpos = torch.arange(sk, device=q.device)[None, :]
    out = torch.empty_like(q)
    for i0 in range(0, sq, block):
        qb = q[:, i0:i0 + block].float()
        qpos = torch.arange(i0, i0 + qb.shape[1], device=q.device)[:, None]
        mask = torch.ones((qb.shape[1], sk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (kpos > qpos - window)
        s = torch.einsum("bqhd,bkhd->bhqk", qb, kf) / math.sqrt(d)
        s = torch.where(mask, s, -math.inf)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.permute(0, 2, 1, 3)
        out[:, i0:i0 + block] = o.to(q.dtype)
    return out


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


def ssd_scan_ref(
    x: torch.Tensor,          # (B, S, H, P)
    dt: torch.Tensor,         # (B, S, H)
    a: torch.Tensor,          # (H,)
    bmat: torch.Tensor,       # (B, S, N)
    cmat: torch.Tensor,       # (B, S, N)
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
):
    """Sequential SSD recurrence, the JAX package's oracle in float32:
    ``S_t = exp(dt_t·a) S_{t-1} + (x_t·dt_t) ⊗ B_t`` and ``y_t = S_t C_t``
    token by token from ``init_state`` (zeros when None).  Returns (y in
    x's dtype, final state float32), as ``ssd_scan_pallas`` does."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    xf, dtf = x.float(), dt.float()
    bf, cf, af = bmat.float(), cmat.float(), a.float()
    st = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        dta = torch.exp(dtf[:, t] * af[None, :])                    # (B, H)
        st = st * dta[:, :, None, None] + torch.einsum(
            "bn,bhp->bhpn", bf[:, t], xf[:, t] * dtf[:, t, :, None])
        ys.append(torch.einsum("bhpn,bn->bhp", st, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), st
