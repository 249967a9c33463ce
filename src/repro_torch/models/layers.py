"""Building blocks of the dense transformer: the port of
``repro.models.layers``.

Pure functions over explicit parameter dicts in the JAX package's layout:
weights are ``(d_in, d_out)`` so ``x @ W`` matches.  ``mlp_apply`` and
``attention_apply`` take a TinyTrain channel delta (``delta`` plus the
selected channel indices, as a tensor): the MLP's over d_ff neurons
(``w_gate``/``w_up`` ``(D, K)``, ``w_down`` ``(K, D)``), attention's over
query heads (``wq`` ``(D, K·Dh)``, ``wo`` ``(K·Dh, D)``), with the column
math in ``models.overlay``.  The projections a serving overlay can
replace (``wq``, ``wo``, MLA's ``w_uq`` and the MLP's) go through
:func:`bmm`, which also takes per-slot weights; the MoE's expert stacks
take a per-slot ``(B, E, D, F)`` overlay through the per-row dispatch.
MLA (deepseek-v3: a latent KV cache read in the absorbed form) and the
MoE (sort-free capacity dispatch, a shared expert, the Switch aux loss)
are here, and so is cross-attention (``attention_apply(cross_hidden=)``:
K and V from the encoder's output through the layer's own ``wk``/``wv``,
no RoPE, no cache), which the encoder-decoder family's decoder runs.

Cache-free attention switches to :func:`chunked_attention`, an online
softmax over query and key chunks, at the JAX package's thresholds
(``S·Sk > 1024²`` for self- and cross-attention, ``S² > 4096²`` for MLA),
so its float32 rounding is the JAX package's on both sides of them; the
whisper encoder's 1500 frames take it.  Where autograd records, each
query chunk is recomputed in the backward (:func:`remat`), as the JAX
package's ``jax.checkpoint`` does.

A sliding-window config whose cache holds exactly the window rolls it:
row ``len % window`` takes the next token, and a block prefill folds its
tokens position by position (write, attend, advance), so a block that
wraps never overwrites a row an earlier query of the block still reads.

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
import torch.utils.checkpoint

from ..kernels import ops
from . import overlay as OV
from .overlay import delta_in_rows, delta_out_cols  # noqa: F401  (re-export)

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
    of ``x`` (B, ..., d) against its own weight matrix.

    Slot b's rows are taken from the whole block's product with ``w[b]``,
    the very product a folded copy of those weights runs (same shape, same
    kernel), so a slot's values are bit for bit its folded engine's.  A
    batched product is not: on the card cuBLAS picks another reduction
    order for it, and greedy bf16 streams at full width part (PERF.md §6,
    PR 30).  The bytes read are the same, every ``w[b]`` once."""
    if w.dim() == 2:
        return x @ w
    b = x.shape[0]
    flat = x.reshape(-1, x.shape[-1])
    ys = torch.stack([flat @ wi for wi in w.unbind(0)])  # (B, B * n, f)
    # slot b's rows of its own product: the (b, b) blocks
    y = ys.view(b, b, -1, ys.shape[-1]).diagonal(dim1=0, dim2=1)
    # contiguous: the kernels downstream (q into kernel 2) take no strides
    return y.permute(2, 0, 1).contiguous().reshape(*x.shape[:-1],
                                                   w.shape[-1])


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


def mlp_delta_init(d_model: int, d_ff_sel: int, act: str,
                   dtype: torch.dtype = torch.float32, device=None) -> Params:
    """Zero delta pack for ``d_ff_sel`` selected d_ff neurons."""

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if act in ("swiglu", "geglu"):
        return {"w_gate": z(d_model, d_ff_sel), "w_up": z(d_model, d_ff_sel),
                "w_down": z(d_ff_sel, d_model)}
    return {"w_up": z(d_model, d_ff_sel), "w_down": z(d_ff_sel, d_model)}


# ---------------------------------------------------------------------------
# Attention (GQA / MQA, contiguous or paged KV cache)
# ---------------------------------------------------------------------------


def attn_delta_init(cfg, n_sel_heads: int, dtype: torch.dtype = torch.float32,
                    device=None) -> Params:
    """Zero delta pack for ``n_sel_heads`` selected query heads (the
    cross-attention's too: its projections have attention's shapes)."""
    k = n_sel_heads * cfg.head_dim
    return {"wq": torch.zeros((cfg.d_model, k), dtype=dtype, device=device),
            "wo": torch.zeros((k, cfg.d_model), dtype=dtype, device=device)}


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
    q_offset=0,
    kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain masked attention. q: (B,Sq,H,D), k/v: (B,Sk,Hkv,D).

    Query i sits at position ``q_offset + i``: ``q_offset`` is a scalar
    or a per-sample (B,) vector (a block prefill's queries start at each
    slot's own cache length).  ``kv_len``, a scalar or (B,), masks cache
    rows per sample.  Masked scores are -1e30, so a row with no valid key
    averages every row of v, as the JAX package's version does.  Unlike
    it, rows at or past ``kv_len`` are zeroed in v first: a stale
    non-finite row left in the slot by an earlier stream would otherwise
    turn its zero weight into NaN (ROADMAP queue 3).  For finite caches
    the result is the same.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    dev = q.device
    kpos = torch.arange(sk, device=dev)[None, None, :]
    if kv_len is not None:
        if not torch.is_tensor(kv_len) or kv_len.dim() == 0:
            kv_len = torch.as_tensor(kv_len, device=dev).expand(b)
        seen = kpos[0] < kv_len[:, None]                   # (B, Sk)
        v = torch.where(seen[:, :, None, None], v, torch.zeros_like(v))
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(d)
    qpos = torch.arange(sq, device=dev)[None, :]      # (1, sq)
    if torch.is_tensor(q_offset) and q_offset.dim():  # per-sample: (B, sq)
        qpos = q_offset.to(dev)[:, None] + qpos
    else:
        qpos = qpos + q_offset
    mask = torch.ones((qpos.shape[0], sq, sk), dtype=torch.bool, device=dev)
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


def under_func_transform() -> bool:
    """Whether a ``torch.func`` transform (``vmap``, ``grad``) is running,
    as in the fleet fine-tune and the batched probe."""
    return torch._C._functorch.peek_interpreter_stack() is not None


def remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward (a
    non-reentrant ``torch.utils.checkpoint``): the port of
    ``jax.checkpoint``.  Under ``no_grad`` it is ``fn(*args)``: there is
    no backward.  A ``torch.func`` transform refuses the checkpoint's
    saved-tensor hooks, so there it raises rather than keep every
    activation unasked."""
    if not torch.is_grad_enabled():
        return fn(*args)
    if under_func_transform():
        raise RuntimeError(
            "remat: torch.utils.checkpoint cannot run under a torch.func "
            "transform (the fleet fine-tune of adapt_many); adapt each task "
            "with adapt(), or drop the policy's meta['remat'] / lm_loss's "
            "logit_chunk there")
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _pick(s: int, target: int) -> int:
    """The largest divisor of ``s`` at or below ``target``."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Flash-style online-softmax attention in plain torch, the JAX
    package's ``chunked_attention``: q (B, Sq, H, D), k (B, Sk, Hkv, D), v
    (B, Sk, Hkv, Dv) (MLA's value dim may differ) -> (B, Sq, H, Dv).

    Chunk sizes are the largest divisors of Sq and Sk at or below
    ``q_chunk`` / ``kv_chunk`` (whisper's 1500 frames: 500 and 750).  Each
    query chunk runs a float32 online softmax over the key chunks with the
    -1e30 mask and ``acc / max(l, 1e-30)``, so scores are O(S · chunk)
    and never S × S.  Query i sits at position i, key j at j (causal: j
    <= i; a window keeps j > i - window).  Where autograd records, each
    query chunk's scores are recomputed in the backward (:func:`remat`)."""
    b, sq, h, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    n_rep = h // hkv
    q_chunk, kv_chunk = _pick(sq, q_chunk), _pick(sk, kv_chunk)
    nk = sk // kv_chunk
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    kr = k.reshape(b, nk, kv_chunk, hkv, d)
    vr = v.reshape(b, nk, kv_chunk, hkv, dv)
    kpos0 = torch.arange(kv_chunk, device=dev)

    def q_step(qc, q0: int):
        qpos = q0 + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((b, h, q_chunk, dv), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, h, q_chunk), float("-inf"), dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kc = _repeat_kv(kr[:, ki], n_rep)
            vc = _repeat_kv(vr[:, ki], n_rep)
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kc).float() * scale
            kpos = ki * kv_chunk + kpos0
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vc.dtype), vc).float()
            m = m_new
        return (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)

    # recompute in the backward only where plain autograd records: the
    # encoder of a frozen model records nothing, and under torch.func,
    # which refuses the checkpoint, each chunk keeps its scores for the
    # backward (O(S·Sk) saved; cache-free attention takes this path only
    # past 1024² scores)
    grad = (torch.is_grad_enabled() and not under_func_transform()
            and (q.requires_grad or k.requires_grad or v.requires_grad))
    outs = [remat(q_step, q[:, q0:q0 + q_chunk], q0) if grad
            else q_step(q[:, q0:q0 + q_chunk], q0)
            for q0 in range(0, sq, q_chunk)]
    # (B, H, Sq, Dv) -> (B, Sq, H, Dv)
    return torch.cat(outs, dim=2).transpose(1, 2)


def _cache_free_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool, window: int = 0,
                          limit: int = 1024 * 1024) -> torch.Tensor:
    """Cache-free attention, chunked past ``Sq · Sk > limit`` as in the JAX
    package (1024² for self- and cross-attention, 4096² for MLA)."""
    if q.shape[1] * k.shape[1] > limit:
        return chunked_attention(q, k, v, causal=causal, window=window)
    return dot_attention(q, k, v, causal=causal, window=window)


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


def _write_token(ck: torch.Tensor, cv: torch.Tensor, k1: torch.Tensor,
                 v1: torch.Tensor, pos: torch.Tensor,
                 step_valid: Optional[torch.Tensor], n_new):
    """Write one token a slot, ``k1``/``v1`` (B, ...), at row ``pos`` (B,)
    of the caches ``ck``/``cv`` (B, S_max, ...), in place.  A slot masked
    by ``step_valid`` rewrites the row it already holds.  Returns the
    tokens each slot advances: ``n_new``, or the mask as int32."""
    bidx = torch.arange(ck.shape[0], device=ck.device)
    kr, vr = k1.to(ck.dtype), v1.to(cv.dtype)
    if step_valid is not None:
        m = step_valid.reshape((-1,) + (1,) * (kr.dim() - 1))
        kr = torch.where(m, kr, ck[bidx, pos])
        vr = torch.where(m, vr, cv[bidx, pos])
        n_new = step_valid.to(torch.int32)
    ck[bidx, pos] = kr
    cv[bidx, pos] = vr
    return n_new


def _rolling_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ck: torch.Tensor, cv: torch.Tensor, lens: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Block prefill into a rolling window cache, in place: the JAX
    package's per-position fold.  Each position writes its valid token at
    row ``cur % S_max``, attends to the buffer with ``kv_len = min(cur +
    1, S_max)`` and advances ``cur``, exactly as token-by-token decode
    does; a parallel write-then-attend would let a later token of a
    wrapping block overwrite a row an earlier query still reads."""
    s_max = ck.shape[1]
    cur = lens
    outs = []
    for j in range(q.shape[1]):
        _write_token(ck, cv, k[:, j], v[:, j], (cur % s_max).long(),
                     valid[:, j], 0)
        outs.append(dot_attention(q[:, j:j + 1], ck, cv, causal=False,
                                  kv_len=torch.clamp(cur + 1, max=s_max)))
        cur = cur + valid[:, j].to(cur.dtype)
    return torch.cat(outs, dim=1)


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
    cross_hidden: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    step_valid: Optional[torch.Tensor] = None,
    delta: Optional[Params] = None,
    head_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Multi-head attention with GQA/MQA, RoPE, a contiguous or paged KV
    cache and an optional channel delta over the query heads ``head_idx``.
    ``cross_hidden`` (B, Se, D) makes it cross-attention, as in the JAX
    package: K and V are the encoder's hidden states through this layer's
    ``wk``/``wv`` (no bias, no RoPE, RoPE on no query either), no mask, no
    cache (``cache`` is returned as it came).

    Returns (output, updated_cache).  A contiguous cache is {"k": (B,
    S_max, Hkv, Dh), "v": ..., "len": (B,)}; a paged one is {"k": store,
    "v": store, "page_table": (B, max_pages), "len": (B,)} with the stores
    of ``serving.paging``.  Rows are written in place and the returned
    cache holds the same tensors with the new lengths.  ``valid`` (B, S)
    switches the cache path into block-prefill mode: each slot writes its
    left-aligned valid tokens at its own cursor and attends causally from
    its own offset.  ``step_valid`` (B,) masks slots of a single-token
    decode: a masked slot writes no row and keeps its length (its output
    row is meaningless).
    """
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = bmm(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if delta is not None:
        cols = OV.head_cols(head_idx, dh)
        q = OV.delta_out_cols(q, x, delta["wq"], cols)
    q = q.reshape(b, s, h, dh)
    if cross_hidden is not None:
        se = cross_hidden.shape[1]
        k = (cross_hidden @ p["wk"]).reshape(b, se, hkv, dh)
        v = (cross_hidden @ p["wv"]).reshape(b, se, hkv, dh)
        out = _cache_free_attention(q, k, v, causal=False)
        new_cache = cache
        return _attn_out(p, out, delta, head_idx, dh), new_cache
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    if cfg.rope_theta > 0:
        cos, sin = rope_tables(positions, dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if cache is None:
        new_cache = None
        out = _cache_free_attention(q, k, v, causal=causal,
                                    window=cfg.sliding_window)
    elif "page_table" in cache:
        # paged cache: write rows through the page table in place, attend
        # on the pages (block prefill) or on their gathered view (decode)
        from ..serving import paging as PG

        spec = PG.spec_from(cache)
        table, lens = cache["page_table"], cache["len"]
        if valid is not None:
            vmask = valid
        elif step_valid is not None:
            vmask = step_valid[:, None].expand(b, s)
        else:
            vmask = torch.ones((b, s), dtype=torch.bool, device=x.device)
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
        # the JAX package's condition: a cache of exactly the window rolls
        rolling = cfg.sliding_window > 0 and s_max == cfg.sliding_window
        if valid is not None and rolling:
            out = _rolling_block(q, k, v, ck, cv, lens, valid)
            new_cache = {"k": ck, "v": cv,
                         "len": lens + valid.sum(dim=1, dtype=torch.int32)}
        elif valid is not None:
            # block prefill: per-slot scatter of the valid rows only (the
            # serving engine's submit() validation guarantees they fit)
            n_new = valid.sum(dim=1, dtype=torch.int32)
            _scatter_block_rows(ck, k, lens, valid)
            _scatter_block_rows(cv, v, lens, valid)
            new_cache = {"k": ck, "v": cv, "len": lens + n_new}
            out = _block_cached_attention(q, ck, cv, lens=lens, n_new=n_new)
        else:
            n_new = s
            if s == 1:
                pos = (lens % s_max if rolling
                       else lens.clamp(max=s_max - 1)).long()
                n_new = _write_token(ck, cv, k[:, 0], v[:, 0], pos,
                                     step_valid, n_new)
            else:  # batch-aligned prefill write, start clamped to fit
                # (the JAX package's dynamic_update_slice clamps the
                # start to fit, a rolling one included)
                start = (lens[0] % s_max if rolling else lens[0]).clamp(
                    0, s_max - s).long()
                rows = start + torch.arange(s, device=x.device)
                ck[:, rows] = k.to(ck.dtype)
                cv[:, rows] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv, "len": lens + n_new}
            kv_len = (lens + s).clamp(max=s_max)
            out = dot_attention(q, ck, cv, causal=False, kv_len=kv_len)
    return _attn_out(p, out, delta, head_idx, dh), new_cache


def _attn_out(p: Params, out: torch.Tensor, delta: Optional[Params],
              head_idx: Optional[torch.Tensor], dh: int) -> torch.Tensor:
    """The output projection of (B, S, H, Dh) heads, with the delta's
    ``wo`` rows at the selected heads."""
    b, s = out.shape[:2]
    out_flat = out.reshape(b, s, -1)
    y = bmm(out_flat, p["wo"])
    if delta is not None:
        y = OV.delta_in_rows(y, out_flat, delta["wo"],
                             OV.head_cols(head_idx, dh))
    return y


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v3): low-rank latent KV + decoupled RoPE
# ---------------------------------------------------------------------------


def mla_delta_init(cfg, n_sel_heads: int, dtype: torch.dtype,
                   device) -> Params:
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "w_uq": torch.zeros((cfg.q_lora_rank, n_sel_heads * qk), dtype=dtype,
                            device=device),
        "wo": torch.zeros((n_sel_heads * cfg.v_head_dim, cfg.d_model),
                          dtype=dtype, device=device),
    }


def mla_apply(
    p: Params,
    x: torch.Tensor,
    cfg,
    *,
    positions: torch.Tensor,
    cache: Optional[Params] = None,
    valid: Optional[torch.Tensor] = None,
    step_valid: Optional[torch.Tensor] = None,
    delta: Optional[Params] = None,
    head_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """MLA forward, as the JAX package's ``mla_apply``.  Without a cache
    it materialises per-head K/V (query/key dim ``qk_nope + qk_rope``,
    value dim ``v_head_dim``) and runs :func:`dot_attention`, chunked past
    ``S² > 4096²``.  With one it
    writes the compressed latent rows (``{"ckv": (B, S, kv_lora_rank),
    "krope": (B, S, qk_rope_dim), "len"}``, or the same two as page
    stores with a ``page_table``) in place and attends in the *absorbed*
    form: ``W_uk`` folds into the query, the logits against the latent
    cache are float32, and ``W_uv`` applies after the weighted sum.
    ``valid`` (B, S) is block prefill (per-slot writes at each cursor, a
    per-query causal mask); ``step_valid`` (B,) masks slots of a
    single-token decode, which then write no row and keep their length.
    The latent cache never rolls.  Rows at or past ``kv_len`` are zeroed
    before the weighted sum, as :func:`dot_attention` does, so a stale
    non-finite row cannot reach a live stream."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)

    cq = rms_norm(x @ p["w_dq"], p["q_norm"])
    q = bmm(cq, p["w_uq"])
    if delta is not None:
        q = OV.delta_out_cols(q, cq, delta["w_uq"],
                              OV.head_cols(head_idx, dn + dr))
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    ckv = rms_norm(x @ p["w_dkv"], p["kv_norm"])
    k_rope = (x @ p["w_kr"]).reshape(b, s, 1, dr)
    cos, sin = rope_tables(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    scale = 1.0 / math.sqrt(dn + dr)

    new_cache = None
    if cache is None:
        k_nope = (ckv @ p["w_uk"]).reshape(b, s, h, dn)
        v = (ckv @ p["w_uv"]).reshape(b, s, h, dv)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
        out = _cache_free_attention(torch.cat([q_nope, q_rope], dim=-1), k,
                                    v, causal=True, limit=4096 * 4096)
        out_flat = out.reshape(b, s, h * dv)
    else:
        lens = cache["len"]
        kr1 = k_rope[:, :, 0, :]
        if "page_table" in cache:
            from ..serving import paging as PG

            spec = PG.spec_from(cache)
            table, s_max = cache["page_table"], spec.cap
            if valid is not None:
                vmask = valid
            elif step_valid is not None:
                vmask = step_valid[:, None].expand(b, s)
            else:
                vmask = torch.ones((b, s), dtype=torch.bool, device=x.device)
            n_new = vmask.sum(dim=1, dtype=torch.int32)
            cst = PG.write_rows(cache["ckv"], table, spec, lens, ckv, vmask)
            rst = PG.write_rows(cache["krope"], table, spec, lens, kr1, vmask)
            new_cache = {"ckv": cst, "krope": rst, "page_table": table,
                         "len": lens + n_new}
            rdt = x.dtype if spec.int8 else cst["pages"].dtype
            cckv = PG.read_rows(cst, table, spec, rdt)
            ckr = PG.read_rows(rst, table, spec, rdt)
            kv_len = torch.clamp(lens + n_new, max=s_max)
        else:
            cckv, ckr = cache["ckv"], cache["krope"]
            s_max = cckv.shape[1]
            if valid is not None:
                n_new = valid.sum(dim=1, dtype=torch.int32)
                _scatter_block_rows(cckv, ckv, lens, valid)
                _scatter_block_rows(ckr, kr1, lens, valid)
                kv_len = torch.clamp(lens + n_new, max=s_max)
            elif s == 1:
                pos = lens.clamp(max=s_max - 1).long()
                n_new = _write_token(cckv, ckr, ckv[:, 0], kr1[:, 0], pos,
                                     step_valid, s)
                kv_len = torch.clamp(lens + s, max=s_max)
            else:  # batch-aligned write, start clamped to fit
                n_new = s
                start = lens[0].clamp(0, s_max - s).long()
                rows = start + torch.arange(s, device=x.device)
                cckv[:, rows] = ckv.to(cckv.dtype)
                ckr[:, rows] = kr1.to(ckr.dtype)
                kv_len = torch.clamp(lens + s, max=s_max)
            new_cache = {"ckv": cckv, "krope": ckr, "len": lens + n_new}
        # absorbed attention: W_uk folds into the query, (B, S, H, r)
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope,
                             p["w_uk"].reshape(r, h, dn))
        logits = (torch.einsum("bshr,btr->bhst", q_lat.float(),
                               cckv.float())
                  + torch.einsum("bshd,btd->bhst", q_rope.float(),
                                 ckr.float())) * scale
        tpos = torch.arange(s_max, device=x.device)
        seen = tpos[None, :] < kv_len[:, None]             # (B, T)
        mask = seen[:, None, None, :]
        if valid is not None:
            # query j attends rows at positions <= lens + j (rows are
            # positions here: the latent cache never rolls)
            qpos = lens[:, None] + torch.arange(s, device=x.device)[None, :]
            mask = mask & (tpos[None, None, None, :]
                           <= qpos[:, None, :, None])
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        w = torch.softmax(logits, dim=-1)
        cv = torch.where(seen[:, :, None], cckv, torch.zeros_like(cckv))
        o_lat = torch.einsum("bhst,btr->bshr", w.to(cv.dtype), cv)
        out = torch.einsum("bshr,rhd->bshd", o_lat,
                           p["w_uv"].reshape(r, h, dv))
        out_flat = out.reshape(b, s, h * dv)

    y = bmm(out_flat, p["wo"])
    if delta is not None:
        y = OV.delta_in_rows(y, out_flat, delta["wo"],
                             OV.head_cols(head_idx, dv))
    return y, new_cache


# ---------------------------------------------------------------------------
# Mixture of experts (sort-free capacity dispatch)
# ---------------------------------------------------------------------------


def moe_delta_init(cfg, n_sel_experts: int, dtype: torch.dtype,
                   device) -> Params:
    d, f = cfg.d_model, cfg.d_expert

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"w_gate": z(n_sel_experts, d, f), "w_up": z(n_sel_experts, d, f),
            "w_down": z(n_sel_experts, f, d)}


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of the last axis, largest first and equal values
    by lower index, as ``lax.top_k`` orders them (``torch.topk`` promises
    no order among ties, and float32 router probabilities of bf16 logits
    tie often): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits: torch.Tensor, e: int, k: int):
    """Router softmax -> (probs, normalised gates, selected experts, the
    Switch load-balance aux) over the last axis of float32 ``logits``."""
    probs = torch.softmax(logits, dim=-1)
    gate, sel = top_k(probs, k)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    experts = torch.arange(e, device=logits.device)
    density = (sel[..., 0].reshape(-1, 1) == experts).float().mean(dim=0)
    aux = e * torch.sum(density * probs.reshape(-1, e).mean(dim=0))
    return gate, sel, aux


def _queue_slots(sel: torch.Tensor, e: int, cap: int):
    """Each (token, choice)'s slot in its expert's queue: the cumsum rank,
    token-major and choice-minor, along axis -2 of the flattened choices.
    ``sel`` (..., T, K) -> (slot (..., T*K), keep, flat_sel), the dropped
    choices (rank >= cap) at the trash slot ``e * cap``.  No one-hot of
    ``F.one_hot`` (it reads its input's range on the host)."""
    flat_sel = sel.reshape(*sel.shape[:-2], -1)
    onehot = (flat_sel[..., None]
              == torch.arange(e, device=sel.device)).to(torch.int32)
    pos = ((onehot.cumsum(dim=-2) - 1) * onehot).sum(dim=-1)
    keep = pos < cap
    slot = torch.where(keep, flat_sel * cap + pos,
                       torch.full_like(pos, e * cap))
    return slot, keep, flat_sel


def _expert_ffn(buf: torch.Tensor, p: Params, delta: Optional[Params],
                expert_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """SwiGLU of every expert queue of ``buf`` (B, E, C, D) against shared
    (E, D, F) or per-slot (B, E, D, F) weights; with ``delta``, the K
    selected experts' queues run again with their delta added (the JAX
    package's form: the base products are reused, the down projection
    split)."""
    g = torch.matmul(buf, p["w_gate"])
    u = torch.matmul(buf, p["w_up"])
    y = torch.matmul(F.silu(g) * u, p["w_down"])
    if delta is None:
        return y
    dt = buf.dtype
    xs = buf.index_select(1, expert_idx)
    g_full = g.index_select(1, expert_idx) + torch.matmul(
        xs, delta["w_gate"].to(dt))
    u_full = u.index_select(1, expert_idx) + torch.matmul(
        xs, delta["w_up"].to(dt))
    h_sel = F.silu(g_full) * u_full
    w_down = p["w_down"].index_select(p["w_down"].dim() - 3, expert_idx)
    y_sel = (torch.matmul(h_sel, w_down)
             + torch.matmul(h_sel, delta["w_down"].to(dt)))
    return y.index_copy(1, expert_idx, y_sel)


def moe_apply(
    p: Params,
    x: torch.Tensor,
    cfg,
    *,
    delta: Optional[Params] = None,
    expert_idx: Optional[torch.Tensor] = None,
    tap: Optional[torch.Tensor] = None,
    drop_free: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based token dispatch -> batched expert FFN -> combine, the
    JAX package's ``moe_apply``.  Returns (output, Switch aux loss).

    One queue over all tokens: a (token, choice) takes the next slot of
    its expert's queue (cumsum rank, token-major); past the capacity it
    parks in a trash slot and contributes nothing.  ``drop_free`` sizes
    every queue for the worst case (T: ``top_k`` picks distinct experts,
    so one expert sees at most one choice a token), the serving contract:
    a stream must not depend on which tokens share its dispatch.
    Training keeps the capped queue ``max(int(cf * T * K / E), 4)``.
    ``tap`` (B, E) scales each gathered (sample, expert) row: the probe's
    Eq. 2 inner sum.  ``delta`` holds the K selected experts' FFN deltas
    (``expert_idx``).  Per-slot expert weights (B, E, D, F), the serving
    overlay, take the per-row dispatch (:func:`_moe_apply_rows`); the
    global queue is that dispatch over one row of all B * S tokens (both
    capacities agree at one row)."""
    if p["w_gate"].dim() == 4:
        return _moe_apply_rows(p, x, cfg, delta=delta,
                               expert_idx=expert_idx, tap=tap,
                               drop_free=drop_free)
    b, s, d = x.shape
    if tap is not None:
        tap = tap[:, None].expand(b, s, tap.shape[-1]).reshape(1, b * s, -1)
    y, aux = _moe_apply_rows(p, x.reshape(1, b * s, d), cfg, delta=delta,
                             expert_idx=expert_idx, tap=tap,
                             drop_free=drop_free)
    return y.reshape(b, s, d), aux


def _moe_apply_rows(
    p: Params,
    x: torch.Tensor,
    cfg,
    *,
    delta: Optional[Params] = None,
    expert_idx: Optional[torch.Tensor] = None,
    tap: Optional[torch.Tensor] = None,
    drop_free: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch-row MoE dispatch, the JAX package's ``_moe_apply_rows``:
    each row has its own expert queues of capacity ``S`` (drop-free) or
    ``max(4, int(cf * S * K / E))``, so a slot's tokens meet its own
    expert stack when the weights carry a slot axis (B, E, D, F).  At
    drop-free capacities it computes what the global dispatch does.
    ``tap`` is (B, E), or (B, S, E) with a row per token."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    gate, sel, aux = _route((x @ p["router"]).float(), e, k)  # (b, s, k)
    cap = s if drop_free else max(4, int(cfg.capacity_factor * s * k / e))
    slot, keep, flat_sel = _queue_slots(sel, e, cap)          # (b, s*k)

    # invert slot -> token; the dropped choices all land on the trash
    # slot, which no kept row reads
    tok = (torch.arange(s * k, device=x.device) // k).expand(b, s * k)
    bidx = torch.arange(b, device=x.device)[:, None]
    slot_tok = torch.zeros((b, e * cap + 1), dtype=torch.long,
                           device=x.device).index_put_((bidx, slot), tok)
    filled = torch.zeros((b, e * cap + 1), dtype=torch.bool,
                         device=x.device).index_put_(
        (bidx, slot), torch.ones_like(keep))
    # indexing, not ``gather``: gather's backward keeps its whole source
    # (the (E * cap, D) expert outputs of every layer), indexing only the
    # indices
    buf = torch.where(filled[:, :e * cap, None], x[bidx, slot_tok[:, :e * cap]],
                      x.new_zeros(()))
    y_buf = _expert_ffn(buf.reshape(b, e, cap, d), p, delta, expert_idx)

    gathered = y_buf.reshape(b, e * cap, d)[bidx, slot.clamp(max=e * cap - 1)]
    gathered = torch.where(keep[..., None], gathered,
                           x.new_zeros(()))
    if tap is not None:
        if tap.dim() == 2:
            tap = tap[:, None].expand(b, s, tap.shape[-1])
        tap_val = tap.gather(2, sel).reshape(b, s * k)
        gathered = gathered * tap_val[..., None].to(gathered.dtype)
    y = (gathered.reshape(b, s, k, d) * gate[..., None].to(x.dtype)).sum(dim=2)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x.reshape(b * s, d),
                          "swiglu").reshape(b, s, d)
    return y, aux


# the per-kind zero delta packs, attached to the overlay registry's specs
# (the shapes live here)
OV.set_delta_init("mlp", lambda cfg, lid, k, dtype, device: mlp_delta_init(
    cfg.d_model, k, cfg.act, dtype, device))
OV.set_delta_init("attn", lambda cfg, lid, k, dtype, device: attn_delta_init(
    cfg, k, dtype, device))
OV.set_delta_init("xattn", lambda cfg, lid, k, dtype, device: attn_delta_init(
    cfg, k, dtype, device))
OV.set_delta_init("mla", lambda cfg, lid, k, dtype, device: mla_delta_init(
    cfg, k, dtype, device))
OV.set_delta_init("moe", lambda cfg, lid, k, dtype, device: moe_delta_init(
    cfg, k, dtype, device))
