"""Mamba2 SSD (state-space duality) block: the port of ``repro.models.ssm``.

The chunked SSD algorithm (Dao & Gu, 2024) splits the sequence into chunks
of ``Q`` tokens: attention-like products inside a chunk plus a linear
recurrence of a (P, N) state across chunks.  On a card,
:func:`ssd_chunked` is the hand-written scan (``kernels.ops.ssd_scan``:
forward and, under autograd, backward kernels); on the CPU it runs its own
chunked body, op for op the JAX package's XLA ``ssd_chunked``, so the CPU
tests compare the two directly.

:func:`ssd_apply` is the whole block (projections, causal conv, SSD,
gated norm, output projection) in three modes, as in the JAX package:
cache-free (the chunked scan: adaptation, probe, features), single-token
recurrent decode, and block prefill with ``valid``.  The two cache modes
stay the sequential recurrence in both packages, so a stream prefilled in
blocks is bit for bit the stream fed one token a step; serving therefore
launches no SSD kernel.  TinyTrain channel deltas select SSD heads
(``w_z``/``w_x`` output columns, ``w_out`` input rows, ``ssm_head_dim``
each).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import layers as L
from . import overlay as OV

Params = Dict[str, Any]


def ssd_init(cfg, generator: torch.Generator, *, dtype: torch.dtype,
             device, lead: Tuple[int, ...]) -> Params:
    """Random SSD block weights in the JAX package's layout and
    distributions (uniform ±1/sqrt(d_in) projections, ``conv_w`` N(0,
    0.1²), zero ``dt_bias`` and norm weights, unit ``d_skip``, ``a_log =
    log(linspace(1, 16, H))``), with leading stack dims ``lead``; the
    numbers are ``generator``'s."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads

    def dense(d_in, d_out):
        s = 1.0 / d_in ** 0.5
        u = torch.rand(lead + (d_in, d_out), generator=generator,
                       device=device)
        return (u * (2 * s) - s).to(dtype)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=device))
    return {
        "w_z": dense(d, di), "w_x": dense(d, di),
        "w_b": dense(d, n), "w_c": dense(d, n), "w_dt": dense(d, h),
        "dt_bias": full((h,), 0.0),
        "a_log": a_log.to(dtype).expand(lead + (h,)).clone(),
        "d_skip": full((h,), 1.0),
        "conv_w": (torch.randn(lead + (cfg.d_conv, di + 2 * n),
                               generator=generator, device=device)
                   * 0.1).to(dtype),
        "norm_w": full((di,), 0.0),
        "w_out": dense(di, d),
    }


def ssd_delta_init(cfg, n_sel_heads: int, dtype: torch.dtype,
                   device) -> Params:
    """Zero delta pack for ``n_sel_heads`` selected SSD heads."""
    d, k = cfg.d_model, n_sel_heads * cfg.ssm_head_dim

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"w_z": z(d, k), "w_x": z(d, k), "w_out": z(k, d)}


def _ein(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """``einsum`` with JAX's type promotion (torch's refuses mixed
    dtypes): every operand in the operands' result type."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(spec, *(o.to(dt) for o in ops))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` as XLA computes it
    (torch's softplus switches to x above a threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, x (B, S, C), w (K, C).  Returns (silu(y),
    new_state: the last K-1 inputs, or None when K == 1)."""
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device) if state is None else state)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return F.silu(y), new_state


def _segsum(dta: torch.Tensor) -> torch.Tensor:
    """dta (..., Q) -> (..., Q, Q): L[i, j] = sum_{j<k<=i} dta[k] on and
    below the diagonal, -inf above."""
    q = dta.shape[-1]
    cs = torch.cumsum(dta, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dta.device))
    return torch.where(mask, seg, torch.full_like(seg, -float("inf")))


def ssd_chunked(
    x: torch.Tensor,       # (B, S, H, P) inputs (not yet dt-scaled)
    dt: torch.Tensor,      # (B, S, H) softplus'd step sizes
    a: torch.Tensor,       # (H,) negative decay rates
    bmat: torch.Tensor,    # (B, S, N)
    cmat: torch.Tensor,    # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    *,
    need_state: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Chunked SSD scan.  Returns (y (B, S, H, P), final state (B, H, P,
    N) in ``init_state``'s dtype, else x's).  y is float32 whenever dt is
    (the dt-scaled path promotes).

    On a card the scan is the kernel pair behind ``ops.ssd_scan`` (float32
    inside, gradients for x, dt, B and C); ``need_state=False`` then skips
    the final state, which comes back None.  On the CPU it is
    :func:`ssd_chunked_plain`, and on the meta device too, so the dry run
    counts the XLA form that the JAX package's dry run compiles."""
    if x.device.type in ("cpu", "meta"):
        return ssd_chunked_plain(x, dt, a, bmat, cmat, chunk, init_state)
    from ..kernels import ops

    y, fin = ops.ssd_scan(x, dt, a, bmat, cmat, chunk=chunk,
                          init_state=init_state, want_state=need_state,
                          out_dtype=torch.promote_types(x.dtype, dt.dtype))
    st_dtype = init_state.dtype if init_state is not None else x.dtype
    return y, None if fin is None else fin.to(st_dtype)


def ssd_chunked_plain(x, dt, a, bmat, cmat, chunk: int,
                      init_state: Optional[torch.Tensor] = None):
    """The JAX package's XLA ``ssd_chunked``, op for op, on any device: the
    CPU path of :func:`ssd_chunked`, and the plain version that the card's
    tests hold the backward kernel against (through autograd)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {q}")
    nc = s // q
    xr = x.reshape(b, nc, q, h, p)
    dtr = dt.reshape(b, nc, q, h)
    br = bmat.reshape(b, nc, q, n)
    cr = cmat.reshape(b, nc, q, n)
    dta = dtr * a[None, None, None, :]                   # (b, nc, q, h)

    # intra-chunk: y_intra[i] = sum_{j<=i} C_i.B_j exp(seg(i,j)) dt_j x_j
    seg = _segsum(dta.movedim(-1, -2))                   # (b, nc, h, q, q)
    l_mat = torch.exp(seg)
    scores = _ein("bcin,bcjn->bcij", cr, br)             # (b, nc, q, q)
    w = scores[:, :, None] * l_mat                       # (b, nc, h, q, q)
    xdt = xr * dtr[..., None]                            # (b, nc, q, h, p)
    y_intra = _ein("bchij,bcjhp->bcihp", w.to(x.dtype), xdt)

    # per-chunk local end states: S_c = sum_j exp(cum_end - cum_j) B_j dt_j x_j
    cum = torch.cumsum(dta, dim=2)                       # (b, nc, q, h)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    local_state = _ein("bcqn,bcqhp->bchpn", br,
                       (xdt * decay_to_end[..., None]).to(x.dtype))
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (b, nc, h)

    # inter-chunk recurrence over nc chunks
    st = (init_state if init_state is not None
          else torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = (st * chunk_decay[:, c, :, None, None].to(st.dtype)
              + local_state[:, c])
    prev_states = torch.stack(prev, dim=1)               # (b, nc, h, p, n)

    # inter-chunk contribution: y_inter[i] = C_i exp(cum_i) S_prev
    decay_in = torch.exp(cum)
    y_inter = (_ein("bcqn,bchpn->bcqhp", cr, prev_states)
               * decay_in[..., None].to(x.dtype))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, st


def _recurrent_step(st, xh_j, dt_j, bb_j, cc_j, a):
    """One token of the recurrence, the single-token decode's ops exactly:
    (new state, y_j (B, H, P))."""
    dta = torch.exp(dt_j * a[None, :])                             # (B, H)
    dbx = _ein("bn,bhp->bhpn", bb_j, (xh_j * dt_j[:, :, None]).to(st.dtype))
    st = st * dta[:, :, None, None].to(st.dtype) + dbx
    return st, _ein("bhpn,bn->bhp", st, cc_j.to(st.dtype))


def ssd_apply(
    p: Params,
    x: torch.Tensor,
    cfg,
    *,
    cache: Optional[Params] = None,
    delta: Optional[Params] = None,
    head_idx: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    step_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """The whole Mamba2 block: proj -> conv -> SSD -> gated norm -> out.

    ``cache = {"conv": (B, d_conv-1, C), "ssm": (B, H, P, N), "len": (B,)}``
    for serving; the returned cache holds new tensors (the caller writes
    them back).  With ``valid`` (B, S) the cache path is *block prefill*:
    projections and the causal conv run over the block, then the block
    folds into the state token by token with the single-token update's
    ops (dt is zeroed on invalid positions, so ragged tails and paused
    slots leave the state as it was), and each slot's conv window advances
    by its own valid count.  A slot with no valid token there, or masked
    by ``step_valid`` (B,) in a single-token decode, keeps its conv window
    and state bit for bit.  TinyTrain deltas select SSD heads
    (``head_idx``)."""
    b, s, _ = x.shape
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim

    z = L.bmm(x, p["w_z"])
    xs = L.bmm(x, p["w_x"])
    cols = None
    if delta is not None:
        cols = OV.head_cols(head_idx, hd)
        z = OV.delta_out_cols(z, x, delta["w_z"], cols)
        xs = OV.delta_out_cols(xs, x, delta["w_x"], cols)
    bb = x @ p["w_b"]
    cc = x @ p["w_c"]
    dt = _softplus((x @ p["w_dt"]).float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())

    conv_in = torch.cat([xs, bb, cc], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv_state = _causal_conv(conv_in, p["conv_w"], conv_state)
    xs, bb, cc = (conv_out[..., :di], conv_out[..., di:di + n],
                  conv_out[..., di + n:])

    xh = xs.reshape(b, s, h, hd)
    if cache is not None and (valid is not None or s == 1):
        if valid is None:  # single-token decode: every valid slot takes one
            n_new = (torch.ones((b,), dtype=torch.int32, device=x.device)
                     if step_valid is None else step_valid.to(torch.int32))
        else:
            # block prefill: dt = 0 makes exp(dt a) = 1 and dt x = 0, so
            # the update is the identity on invalid positions
            n_new = valid.to(torch.int32).sum(dim=1)
            dt = dt * valid.to(dt.dtype)[..., None]
            km1 = p["conv_w"].shape[0] - 1
            if km1 > 0:
                # the last (d_conv - 1) valid inputs of each slot
                xp = torch.cat([conv_state, conv_in], dim=1)
                rows = (n_new[:, None].long()
                        + torch.arange(km1, device=x.device)[None, :])
                new_conv_state = torch.gather(
                    xp, 1, rows[..., None].expand(-1, -1, xp.shape[-1]))
        st, ys = cache["ssm"], []
        for j in range(s):
            st, y_j = _recurrent_step(st, xh[:, j], dt[:, j], bb[:, j],
                                      cc[:, j], a)
            ys.append(y_j)
        y = torch.stack(ys, dim=1)                                # (B,S,H,P)
        if valid is not None or step_valid is not None:
            # a slot that took no token keeps its window and state as they
            # were (dt = 0 alone could turn a -0.0 into +0.0)
            keep = (n_new > 0)[:, None, None]
            if new_conv_state is not None:
                new_conv_state = torch.where(keep, new_conv_state,
                                             cache["conv"])
            st = torch.where(keep[..., None], st, cache["ssm"])
        new_cache = {"conv": new_conv_state, "ssm": st,
                     "len": cache["len"] + n_new}
    else:
        init = cache["ssm"] if cache is not None else None
        y, final_state = ssd_chunked(xh, dt, a, bb, cc, cfg.ssm_chunk, init,
                                     need_state=cache is not None)
        new_cache = (None if cache is None else
                     {"conv": new_conv_state, "ssm": final_state,
                      "len": cache["len"] + s})

    # dt-scaled paths promote to float32; settle back to the model dtype
    y = y + xh.to(y.dtype) * p["d_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, s, di)
    gate = F.silu(z.float())
    y = L.rms_norm((y.float() * gate).to(x.dtype), p["norm_w"])
    out = L.bmm(y, p["w_out"])
    if delta is not None:
        out = OV.delta_in_rows(out, y, delta["w_out"], cols)
    return out, new_cache


OV.set_delta_init(
    "ssm", lambda cfg, lid, k, dtype, device: ssd_delta_init(cfg, k, dtype,
                                                             device))
