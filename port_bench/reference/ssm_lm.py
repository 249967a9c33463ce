"""The ssm (Mamba2) and hybrid (zamba2) decoders in plain float32 PyTorch.

Written from the architectures' equations, not from the port: RMS norms
that scale by (1 + w), the Mamba2 block (z, x, B, C and dt projections, a
causal depthwise conv of width ``d_conv`` with SiLU over [x, B, C], the
SSD recurrence h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t + D
x_t, a gated RMS norm and the output projection), and for the hybrid one
weight-shared block (causal attention with half-split rotary embeddings,
then a SwiGLU MLP, each behind its own norm and residual) after every
``hybrid_attn_every``-th layer.  The SSD runs chunk by chunk: exactly the
recurrence, with the in-chunk decays taken from float64 cumulative sums.
The embedding is tied to the output head.

TinyTrain's head deltas add ``x @ dW`` to the selected heads' columns of
``w_z`` and ``w_x`` and ``y[heads] @ dW`` to ``w_out``'s output; the
probe's taps scale each layer's mixer output per (row, channel group).

``Prec`` says how the projections' operands are rounded: ``"f32"`` (the
reference) or ``"fp8"`` (e4m3 with one scale a tensor, float32
accumulation, forward and backward: the control that a lower precision
must fail).  TF32 must be off (``strict_f32``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # largest e4m3 value


def strict_f32() -> None:
    """No TF32 anywhere: a float32 product is a float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` through e4m3 with one scale for the tensor, back in float32."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    s = FP8_MAX / amax
    return (t.float() * s).to(torch.float8_e4m3fn).float() / s


class _Fp8Mm(torch.autograd.Function):
    """a @ b with both operands through e4m3; the backward's products take
    e4m3 operands too."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        while gb.dim() > qb.dim():  # a batched a against one b
            gb = gb.sum(0)
        return ga, gb


class Prec:
    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return a @ b
        return _Fp8Mm.apply(a, b)


F32 = Prec("f32")


def rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def head_cols(heads: torch.Tensor, head_dim: int) -> torch.Tensor:
    return (heads[:, None] * head_dim
            + torch.arange(head_dim, device=heads.device)).reshape(-1)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor, q: int = 64) -> torch.Tensor:
    """y_t = sum_{s<=t} (C_t . B_s) exp(sum_{s<k<=t} dt_k a) dt_s x_s, from
    a zero state; x (B, S, H, P), dt (B, S, H), a (H,), B/C (B, S, N).
    Chunks of ``q`` tokens: pairs inside a chunk directly, the state
    carried across chunks."""
    b, s, h, p = x.shape
    pad = (-s) % q
    if pad:  # dt = 0 past the end: no input, no decay
        x, dt, bm, cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in (x, dt, bm, cm))
    nc = x.shape[1] // q
    x = x.reshape(b, nc, q, h, p)
    dt = dt.reshape(b, nc, q, h)
    bm = bm.reshape(b, nc, q, -1)
    cm = cm.reshape(b, nc, q, -1)
    cs = torch.cumsum((dt * a).double(), dim=2)                # (b,c,q,h)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]         # i - j
    tril = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(seg.masked_fill(~tril[:, :, None], -math.inf)).float()
    xdt = x * dt[..., None]
    g = torch.einsum("bcin,bcjn->bcij", cm, bm)
    y = torch.einsum("bcijh,bcjhp->bcihp", g[..., None] * lmat, xdt)
    to_end = torch.exp(cs[:, :, -1:, :] - cs).float()         # (b,c,q,h)
    local = torch.einsum("bcjn,bcjhp->bchpn", bm, xdt * to_end[..., None])
    chunk_decay = torch.exp(cs[:, :, -1, :]).float()          # (b,c,h)
    state = x.new_zeros(b, h, p, bm.shape[-1])
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + local[:, c]
    prev = torch.stack(prev, dim=1)                           # (b,c,h,p,n)
    decay_in = torch.exp(cs).float()                          # (b,c,q,h)
    y = y + torch.einsum("bcin,bchpn->bcihp", cm, prev) * decay_in[..., None]
    return y.reshape(b, nc * q, h, p)[:, :s]


def layer_weights(params: Dict[str, Any], j: int) -> Dict[str, torch.Tensor]:
    """Layer j's weights in float32."""
    st = params["stacks"]["g0"]
    out = {k: v[j].float() for k, v in st["ssm"].items()}
    out["norm1"] = st["norm1"]["w"][j].float()
    return out


def ssd_mixer(w: Dict[str, torch.Tensor], hdn: torch.Tensor, sz,
              prec: Prec = F32,
              delta: Optional[Tuple[Dict[str, torch.Tensor], torch.Tensor]]
              = None) -> torch.Tensor:
    """The Mamba2 block on a normed input (B, S, D), cache-free."""
    b, s, _ = hdn.shape
    di, n, h, hd = sz.d_inner, sz.ssm_state, sz.n_ssm_heads, sz.ssm_head_dim
    z = prec.mm(hdn, w["w_z"])
    xs = prec.mm(hdn, w["w_x"])
    if delta is not None:
        pack, heads = delta
        cols = head_cols(heads, hd)
        z = z.index_add(-1, cols, prec.mm(hdn, pack["w_z"]))
        xs = xs.index_add(-1, cols, prec.mm(hdn, pack["w_x"]))
    bm = prec.mm(hdn, w["w_b"])
    cm = prec.mm(hdn, w["w_c"])
    dt = F.softplus(prec.mm(hdn, w["w_dt"]) + w["dt_bias"])
    a = -torch.exp(w["a_log"])
    conv_in = torch.cat([xs, bm, cm], dim=-1)
    k = w["conv_w"].shape[0]
    xp = F.pad(conv_in, (0, 0, k - 1, 0))
    conv = F.silu(sum(xp[:, i:i + s] * w["conv_w"][i] for i in range(k)))
    xs, bm, cm = conv[..., :di], conv[..., di:di + n], conv[..., di + n:]
    xh = xs.reshape(b, s, h, hd)
    y = ssd_scan(xh, dt, a, bm, cm) + xh * w["d_skip"][:, None]
    y = rms(y.reshape(b, s, di) * F.silu(z), w["norm_w"])
    out = prec.mm(y, w["w_out"])
    if delta is not None:
        out = out + prec.mm(y.index_select(-1, cols), pack["w_out"])
    return out


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = pos.float()[:, None] * freqs                         # (S, d/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def shared_block(params: Dict[str, Any], x: torch.Tensor, sz,
                 prec: Prec = F32) -> torch.Tensor:
    """zamba2's shared block: causal self-attention then a SwiGLU MLP."""
    sp = params["shared_attn"]
    f = {k: v.float() for k, v in sp["attn"].items()}
    b, s, _ = x.shape
    nh, hd = sz.n_heads, sz.head_dim
    hdn = rms(x, sp["norm1"]["w"].float())
    pos = torch.arange(s, device=x.device)
    q = rope(prec.mm(hdn, f["wq"]).reshape(b, s, nh, hd), pos, sz.rope_theta)
    k = rope(prec.mm(hdn, f["wk"]).reshape(b, s, nh, hd), pos, sz.rope_theta)
    v = prec.mm(hdn, f["wv"]).reshape(b, s, nh, hd)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(sc.masked_fill(~causal, -math.inf), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, nh * hd)
    x = x + prec.mm(o, f["wo"])
    m = {k: v.float() for k, v in sp["mlp"].items()}
    hdn = rms(x, sp["norm2"]["w"].float())
    return x + prec.mm(F.silu(prec.mm(hdn, m["w_gate"]))
                       * prec.mm(hdn, m["w_up"]), m["w_down"])


def forward(params: Dict[str, Any], sz, tokens: torch.Tensor, *,
            prec: Prec = F32,
            taps: Optional[list] = None,
            deltas: Optional[Dict[int, Tuple[Dict[str, torch.Tensor],
                                             torch.Tensor]]] = None,
            horizon: int = 0, remat: bool = False) -> torch.Tensor:
    """Final normed hidden states (B, S, D) in float32.  ``taps``: one
    (B, C) tensor a layer scaling its mixer output in C channel groups;
    ``deltas``: {layer: (pack, heads)}.  Layers below ``horizon`` run
    without autograd; ``remat`` recomputes each layer in the backward."""
    x = params["embed"][tokens.long()].float()
    shared = set(sz.shared_layers)
    for j in range(sz.n_layers):
        tap = taps[j] if taps is not None else None
        dl = (deltas or {}).get(j)

        def block(x_, j=j, tap=tap, dl=dl):
            w = layer_weights(params, j)
            y = ssd_mixer(w, rms(x_, w["norm1"]), sz, prec, dl)
            if tap is not None:
                y = (y.reshape(*y.shape[:2], tap.shape[-1], -1)
                     * tap[:, None, :, None]).reshape(y.shape)
            return x_ + y

        def sblock(x_):
            return shared_block(params, x_, sz, prec)

        below = j < horizon and taps is None
        for fn, on in ((block, True), (sblock, j in shared)):
            if not on:
                continue
            if below or not torch.is_grad_enabled():
                with torch.no_grad():
                    x = fn(x)
            elif remat:
                x = checkpoint(fn, x, use_reentrant=False)
            else:
                x = fn(x)
    return rms(x, params["final_norm"]["w"].float())


def logits(params: Dict[str, Any], hidden: torch.Tensor,
           prec: Prec = F32) -> torch.Tensor:
    """Tied output head: hidden (..., D) -> (..., vocab)."""
    return prec.mm(hidden, params["embed"].float().T)
