"""Building blocks of the dense transformer: the port of
``repro.models.layers``.

Pure functions over explicit parameter dicts in the JAX package's layout:
weights are ``(d_in, d_out)`` so ``x @ W`` matches.  ``mlp_apply`` and
``attention_apply`` take a TinyTrain channel delta (``delta`` plus the
selected channel indices, as a tensor): the MLP's over d_ff neurons
(``w_gate``/``w_up`` ``(D, K)``, ``w_down`` ``(K, D)``), attention's over
query heads (``wq`` ``(D, K·Dh)``, ``wo`` ``(K·Dh, D)``), with the column
math in ``models.overlay``.  The projections a serving overlay can
replace (``wq``, ``wo`` and the MLP's) go through :func:`bmm`, which also
takes per-slot weights.  MLA, MoE and cross-attention arrive with later
slices.

KV caches are updated **in place**: a per-layer cache holds views into the
layer-stacked cache tensors, and the scatter writes land there, so a
serving tick never copies the cache.  The JAX package returns new arrays
instead; the values are the same.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import overlay as OV

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def apply_norm(cfg_norm: str, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg_norm == "rmsnorm":
        return rms_norm(x, p["w"])
    return layer_norm(x, p["w"], p["b"])


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin tables (..., S, dim/2), float32."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D) with cos/sin (B, S, D/2); the two halves rotate
    together (not interleaved pairs)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, or a product per slot when ``w`` carries a leading slot
    axis ``(B, d, f)`` (the serving engine's per-slot delta overlay): row b
    of ``x`` (B, ..., d) against its own weight matrix."""
    if w.dim() == 2:
        return x @ w
    b = x.shape[0]
    y = torch.bmm(x.reshape(b, -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain GELU)
# ---------------------------------------------------------------------------


def _act(act: str, x: torch.Tensor) -> torch.Tensor:
    if act == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def mlp_apply(p: Params, x: torch.Tensor, act: str,
              delta: Optional[Params] = None,
              idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    if act in ("swiglu", "geglu"):
        g = bmm(x, p["w_gate"])
        u = bmm(x, p["w_up"])
        if delta is not None:
            g = OV.delta_out_cols(g, x, delta["w_gate"], idx)
            u = OV.delta_out_cols(u, x, delta["w_up"], idx)
        h = _act(act, g) * u
    else:
        h = bmm(x, p["w_up"])
        if delta is not None:
            h = OV.delta_out_cols(h, x, delta["w_up"], idx)
        h = _act(act, h)
    y = bmm(h, p["w_down"])
    if delta is not None:
        y = OV.delta_in_rows(y, h, delta["w_down"], idx)
    return y


# ---------------------------------------------------------------------------
# Attention (GQA / MQA, contiguous or paged KV cache)
# ---------------------------------------------------------------------------


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def dot_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain masked attention. q: (B,Sq,H,D), k/v: (B,Sk,Hkv,D).

    Query i sits at position i; ``kv_len`` (B,) masks cache rows per
    sample.  Masked scores are -1e30, so a row with no valid key averages
    every row of v, as the JAX package's version does.  Unlike it, rows at
    or past ``kv_len`` are zeroed in v first: a stale non-finite row left
    in the slot by an earlier stream would otherwise turn its zero weight
    into NaN (ROADMAP queue 3).  For finite caches the result is the same.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    dev = q.device
    kpos = torch.arange(sk, device=dev)[None, None, :]
    if kv_len is not None:
        seen = kpos[0] < kv_len[:, None]                   # (B, Sk)
        v = torch.where(seen[:, :, None, None], v, torch.zeros_like(v))
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(d)
    qpos = torch.arange(sq, device=dev)[None, :]   # (1, sq)
    mask = torch.ones((1, sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos[..., None])
    if window > 0:
        mask = mask & (kpos > qpos[..., None] - window)
    if kv_len is not None:
        mask = mask & (kpos < kv_len[:, None, None])
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def _scatter_block_rows(buf: torch.Tensor, vals: torch.Tensor,
                        lens: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Write slot b's valid block rows into ``buf`` at its own cursor, in
    place.

    buf: (B, S_max, ...), vals: (B, S, ...), lens/valid: (B,) / (B, S).
    Row ``lens[b] + j`` receives ``vals[b, j]`` when valid; invalid rows
    rewrite their original value (clip collisions at the last row all
    carry that same original value).  Valid rows must fit:
    ``lens + sum(valid) <= S_max``.
    """
    b, s = vals.shape[:2]
    s_max = buf.shape[1]
    rows = (lens[:, None].long()
            + torch.arange(s, device=buf.device)[None, :]).clamp(0, s_max - 1)
    bidx = torch.arange(b, device=buf.device)[:, None]
    vm = valid.reshape(valid.shape + (1,) * (vals.dim() - 2))
    buf[bidx, rows] = torch.where(vm, vals.to(buf.dtype), buf[bidx, rows])
    return buf


def _block_cached_attention(
    q: torch.Tensor,   # (B, S, H, D) query block
    ck: torch.Tensor,  # (B, S_max, Hkv, D) cache keys (block rows written)
    cv: torch.Tensor,
    *,
    lens: torch.Tensor,   # (B,) tokens in cache before this block
    n_new: torch.Tensor,  # (B,) valid tokens written by this block
) -> torch.Tensor:
    """Causal block attention of a prompt block against a contiguous
    (non-rolling) cache: each slot's queries sit at absolute positions
    ``lens + j``.  Always the cached flash kernel (its plain version on
    the CPU); the kernel masks ragged edges itself, so no shape gate."""
    return ops.flash_attention_cached(
        q, ck, cv, q_offset=lens, kv_len=lens + n_new, causal=True)


def _paged_block_attention(
    q: torch.Tensor,     # (B, S, H, D) query block
    kst: Params,         # paged K/V stores ({"pages", ...}), rows written
    vst: Params,
    table: torch.Tensor,  # (B, max_pages) page table
    spec,                 # serving.paging.PagingSpec
    *,
    lens: torch.Tensor,   # (B,) tokens in cache before this block
    n_new: torch.Tensor,  # (B,) valid tokens written by this block
) -> torch.Tensor:
    """Causal block attention against a paged cache.  fp pages go through
    the paged flash kernel, which reads the arena through the table with
    no gather.  int8 pages are gathered and dequantised to q's dtype
    (``paging.read_rows``) and go through the cached flash kernel: the
    JAX package runs its masked ``dot_attention`` there on every backend,
    which is the same function."""
    from ..serving import paging as PG

    kv_len = lens + n_new
    if not spec.int8:
        return ops.flash_attention_paged(
            q, kst["pages"], vst["pages"], table, q_offset=lens,
            kv_len=kv_len)
    vk = PG.read_rows(kst, table, spec, q.dtype)
    vv = PG.read_rows(vst, table, spec, q.dtype)
    return ops.flash_attention_cached(q, vk, vv, q_offset=lens,
                                      kv_len=kv_len, causal=True)


def attention_apply(
    p: Params,
    x: torch.Tensor,
    cfg,
    *,
    positions: torch.Tensor,
    cache: Optional[Params] = None,
    causal: bool = True,
    valid: Optional[torch.Tensor] = None,
    delta: Optional[Params] = None,
    head_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Multi-head attention with GQA/MQA, RoPE, a contiguous or paged KV
    cache and an optional channel delta over the query heads ``head_idx``.

    Returns (output, updated_cache).  A contiguous cache is {"k": (B,
    S_max, Hkv, Dh), "v": ..., "len": (B,)}; a paged one is {"k": store,
    "v": store, "page_table": (B, max_pages), "len": (B,)} with the stores
    of ``serving.paging``.  Rows are written in place and the returned
    cache holds the same tensors with the new lengths.  ``valid`` (B, S)
    switches the cache path into block-prefill mode: each slot writes its
    left-aligned valid tokens at its own cursor and attends causally from
    its own offset.
    """
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = bmm(x, p["wq"])
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if delta is not None:
        cols = OV.head_cols(head_idx, dh)
        q = OV.delta_out_cols(q, x, delta["wq"], cols)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    if cfg.rope_theta > 0:
        cos, sin = rope_tables(positions, dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if cache is None:
        new_cache = None
        out = dot_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    elif "page_table" in cache:
        # paged cache: write rows through the page table in place, attend
        # on the pages (block prefill) or on their gathered view (decode)
        from ..serving import paging as PG

        spec = PG.spec_from(cache)
        table, lens = cache["page_table"], cache["len"]
        vmask = (valid if valid is not None
                 else torch.ones((b, s), dtype=torch.bool, device=x.device))
        n_new = vmask.sum(dim=1, dtype=torch.int32)
        kst = PG.write_rows(cache["k"], table, spec, lens, k, vmask)
        vst = PG.write_rows(cache["v"], table, spec, lens, v, vmask)
        new_cache = {"k": kst, "v": vst, "page_table": table,
                     "len": lens + n_new}
        if valid is not None:
            out = _paged_block_attention(q, kst, vst, table, spec,
                                         lens=lens, n_new=n_new)
        else:
            rdt = q.dtype if spec.int8 else kst["pages"].dtype
            vk = PG.read_rows(kst, table, spec, rdt)
            vv = PG.read_rows(vst, table, spec, rdt)
            out = dot_attention(q, vk, vv, causal=False,
                                kv_len=torch.clamp(lens + s, max=spec.cap))
    else:
        ck, cv, lens = cache["k"], cache["v"], cache["len"]
        s_max = ck.shape[1]
        if cfg.sliding_window > 0 and s_max == cfg.sliding_window:
            raise NotImplementedError(
                "rolling sliding-window caches arrive with a later slice "
                "(ROADMAP queue 1, item 11.1)")
        if valid is not None:
            # block prefill: per-slot scatter of the valid rows only (the
            # serving engine's submit() validation guarantees they fit)
            n_new = valid.sum(dim=1, dtype=torch.int32)
            _scatter_block_rows(ck, k, lens, valid)
            _scatter_block_rows(cv, v, lens, valid)
            new_cache = {"k": ck, "v": cv, "len": lens + n_new}
            out = _block_cached_attention(q, ck, cv, lens=lens, n_new=n_new)
        else:
            if s == 1:
                pos = lens.clamp(max=s_max - 1).long()
                bidx = torch.arange(b, device=x.device)
                ck[bidx, pos] = k[:, 0].to(ck.dtype)
                cv[bidx, pos] = v[:, 0].to(cv.dtype)
            else:  # batch-aligned prefill write, start clamped to fit
                start = lens[0].clamp(0, s_max - s).long()
                rows = start + torch.arange(s, device=x.device)
                ck[:, rows] = k.to(ck.dtype)
                cv[:, rows] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv, "len": lens + s}
            kv_len = (lens + s).clamp(max=s_max)
            out = dot_attention(q, ck, cv, causal=False, kv_len=kv_len)

    out_flat = out.reshape(b, s, h * dh)
    y = bmm(out_flat, p["wo"])
    if delta is not None:
        y = OV.delta_in_rows(y, out_flat, delta["wo"], cols)
    return y, new_cache
