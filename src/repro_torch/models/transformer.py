"""The decoder LM (dense and ssm families): the port of
``repro.models.transformer``.

Parameters are nested dicts of tensors in the JAX package's layout: layers
of one homogeneous group are stacked along a leading ``L`` dim under
``params["stacks"]["g{i}"]`` and weights are ``(d_in, d_out)``, so
``repro_torch.bridge`` can load a JAX parameter tree leaf for leaf.  Where
JAX scans a stack, this module loops over its layers in Python.

Modes of :func:`forward_hidden`, as in the JAX package:

- **train** (``deltas`` + ``plan``): the TinyTrain sparse update.  Layers
  below the policy's backprop horizon run under ``torch.no_grad`` (no
  saved activations, no backward work); selected layers add their channel
  deltas; base weights never require grad, so autograd computes gradients
  for the deltas only.
- **probe** (``taps``): every unit's activation is scaled by a ones-valued
  tap, and the gradient of the loss with respect to the taps is Eq. 2's
  inner sum ``u_{n,o} = Σ_d a_nd·g_nd``.
- **serve** (``caches``): ``decode_step`` (one token per slot) and
  ``prefill_block`` (a block of prompt tokens per slot at its own cache
  cursor), on contiguous or paged caches updated in place.  With an
  ``overlay`` (the serving engine's per-slot delta arena) the selected
  layers run on per-slot effective weights, so every slot serves its own
  user's deltas from one shared copy of the base weights.

The ssm family (mamba2) stacks ``models.ssm`` blocks with no FFN: its
selectable unit is the SSD block, channels its SSD heads, and its cache
per slot is a conv window and a (H, P, N) state.  MoE, MLA, hybrid,
encoder-decoder and VLM families and the remat option arrive with later
slices (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import DeviceLike, resolve_device, tree_map
from . import layers as L
from . import overlay as OV
from . import ssm as S
from .api import ArchConfig

Params = Dict[str, Any]


def block_kind(cfg: ArchConfig, layer: int) -> str:
    """Mixer kind of a decoder layer."""
    if cfg.family == "ssm":
        return "ssm"
    if cfg.family == "hybrid":
        return "ssm"
    if cfg.mla:
        return "mla"
    return "attn"


def ffn_kind(cfg: ArchConfig, layer: int) -> str:
    if cfg.family == "ssm" or cfg.family == "hybrid":
        return "none"
    if cfg.n_experts and layer >= cfg.moe_start_layer:
        return "moe"
    return "mlp"


@dataclasses.dataclass(frozen=True)
class UnitDesc:
    """One selectable unit: (layer, kind) with its channel axis size."""

    layer: int
    kind: str  # mlp | attn | ssm
    n_channels: int
    n_params: int
    macs_per_token: int


def unit_descs(cfg: ArchConfig) -> List[UnitDesc]:
    """Selectable units with parameter and MAC costs (Eq. 3 terms)."""
    check_supported(cfg)
    out: List[UnitDesc] = []
    d = cfg.d_model
    for i in range(cfg.n_layers):
        if block_kind(cfg, i) == "ssm":
            di, n = cfg.d_inner, cfg.ssm_state
            np_ = d * (2 * di + 2 * n + cfg.n_ssm_heads) + di * d
            out.append(UnitDesc(i, "ssm", cfg.n_ssm_heads, np_, np_))
        else:
            np_ = d * (cfg.q_dim * 2 + cfg.kv_dim * 2)
            out.append(UnitDesc(i, "attn", cfg.n_heads, np_, np_))
        if ffn_kind(cfg, i) == "mlp":
            mult = 3 if cfg.act in ("swiglu", "geglu") else 2
            np_ = mult * d * cfg.d_ff
            out.append(UnitDesc(i, "mlp", cfg.d_ff, np_, np_))
    return out


def stack_groups(cfg: ArchConfig) -> List[Tuple[str, List[int]]]:
    """Partition decoder layers into homogeneous stack groups."""
    groups: List[Tuple[str, List[int]]] = []
    for i in range(cfg.n_layers):
        sig = block_kind(cfg, i) + "/" + ffn_kind(cfg, i)
        if cfg.n_experts and i < cfg.moe_start_layer:
            sig += "/dense_head"
        if groups and groups[-1][0] == sig:
            groups[-1][1].append(i)
        else:
            groups.append((sig, [i]))
    return groups


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a configuration this slice cannot run."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family} serving arrives with ROADMAP queue 1, "
            "item 14 (encoder-decoder and multimodal serving)")
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: hybrid layers (zamba2's shared attention block) "
            "arrive with ROADMAP queue 1, item 9 (the LM model stack)")
    if cfg.family not in ("dense", "ssm") or cfg.mla or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: only the dense and ssm families run in the port; "
            f"{cfg.family} layers arrive with ROADMAP queue 1, item 9 "
            "(the LM model stack)")


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                device: DeviceLike = "cuda") -> Params:
    """Random weights in the JAX package's layout and distributions
    (uniform ±1/sqrt(d_in) projections, N(0, 0.02²) embedding, zero
    biases, rmsnorm weights 0 since the norm scales by ``1 + w``).  The
    numbers are ``generator``'s, which must live on ``device``; they are
    not ``jax.random``'s — load JAX weights with ``bridge`` instead."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)

    def dense(*shape):  # (..., d_in, d_out)
        s = 1.0 / math.sqrt(shape[-2])
        u = torch.rand(shape, generator=generator, device=dev)
        return (u * (2 * s) - s).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def norm(*lead):
        if cfg.norm == "rmsnorm":
            return {"w": zeros(*lead, cfg.d_model)}
        return {"w": torch.ones(*lead, cfg.d_model, dtype=dtype, device=dev),
                "b": zeros(*lead, cfg.d_model)}

    d = cfg.d_model
    p: Params = {"embed": (torch.randn((cfg.vocab, d), generator=generator,
                                       device=dev) * 0.02).to(dtype),
                 "stacks": {}}
    for gi, (_, ids) in enumerate(stack_groups(cfg)):
        n = len(ids)
        if block_kind(cfg, ids[0]) == "ssm":
            p["stacks"][f"g{gi}"] = {
                "norm1": norm(n),
                "ssm": S.ssd_init(cfg, generator, dtype=dtype, device=dev,
                                  lead=(n,))}
            continue
        attn = {"wq": dense(n, d, cfg.q_dim), "wk": dense(n, d, cfg.kv_dim),
                "wv": dense(n, d, cfg.kv_dim), "wo": dense(n, cfg.q_dim, d)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(n, cfg.q_dim), bk=zeros(n, cfg.kv_dim),
                        bv=zeros(n, cfg.kv_dim))
        if cfg.act in ("swiglu", "geglu"):
            mlp = {"w_gate": dense(n, d, cfg.d_ff), "w_up": dense(n, d, cfg.d_ff),
                   "w_down": dense(n, cfg.d_ff, d)}
        else:
            mlp = {"w_up": dense(n, d, cfg.d_ff), "w_down": dense(n, cfg.d_ff, d)}
        p["stacks"][f"g{gi}"] = {"norm1": norm(n), "attn": attn,
                                 "norm2": norm(n), "mlp": mlp}
    p["final_norm"] = norm()
    if not cfg.tie_embeddings:
        p["unembed"] = dense(d, cfg.vocab)
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _apply_block(cfg: ArchConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, layer: int, *,
                 cache: Optional[Params] = None,
                 valid: Optional[torch.Tensor] = None,
                 step_valid: Optional[torch.Tensor] = None,
                 deltas: Optional[Dict[str, Params]] = None,
                 chan_idx: Optional[Dict[str, torch.Tensor]] = None,
                 taps: Optional[Dict[str, torch.Tensor]] = None,
                 overlay: Optional[Dict[str, Tuple[Any, Any]]] = None,
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    """One decoder layer (attention + MLP, or an SSD block alone).
    Returns (x, new_cache).

    ``deltas``/``chan_idx`` are this layer's delta packs and channel
    indices by unit kind; ``taps`` its (B, C) probe taps by group
    (``mixer``, ``ffn``; the mixer tap's channels are attention or SSD
    heads).  The taps are cast to the activation's dtype: the
    same ones either way, and in bf16 it keeps the residual stream in bf16
    where the JAX package's float32 mixer tap promotes it to float32.

    ``overlay`` maps this layer's unit kinds to slot-stacked ``(delta_pack,
    channel_idx)`` pairs: the affected weights become per-slot effective
    weights ``W ⊕ scatter(ΔW_b, idx_b)`` (the serving path; ``deltas`` and
    ``chan_idx`` are the adaptation path, and the two are not combined)."""
    deltas = deltas or {}
    chan_idx = chan_idx or {}
    taps = taps or {}
    ov = overlay or {}

    def eff(kind: str) -> Params:
        if kind in ov:
            d_stk, i_stk = ov[kind]
            return OV.slot_params(cfg, kind, p[kind], d_stk, i_stk)
        return p[kind]

    h = L.apply_norm(cfg.norm, p["norm1"], x)
    mk = block_kind(cfg, layer)
    if mk == "ssm":
        y, c = S.ssd_apply(eff("ssm"), h, cfg,
                           cache=cache["ssm"] if cache else None,
                           valid=valid, step_valid=step_valid,
                           delta=deltas.get("ssm"),
                           head_idx=chan_idx.get("ssm"))
    else:
        y, c = L.attention_apply(eff("attn"), h, cfg, positions=positions,
                                 cache=cache["attn"] if cache else None,
                                 valid=valid, step_valid=step_valid,
                                 delta=deltas.get("attn"),
                                 head_idx=chan_idx.get("attn"))
    if "mixer" in taps:
        # tap over per-head chunks of the output: scale (B, n_heads)
        tap = taps["mixer"]
        yb = y.reshape(y.shape[0], y.shape[1], tap.shape[-1], -1)
        y = (yb * tap[:, None, :, None].to(y.dtype)).reshape(y.shape)
    x = x + y
    new_cache = {mk: c} if cache is not None else None
    if ffn_kind(cfg, layer) == "none":
        return x, new_cache
    h = L.apply_norm(cfg.norm, p["norm2"], x)
    if "ffn" in taps:
        x = x + _mlp_tapped(p["mlp"], h, cfg.act, taps["ffn"])
    else:
        x = x + L.mlp_apply(eff("mlp"), h, cfg.act, delta=deltas.get("mlp"),
                            idx=chan_idx.get("mlp"))
    return x, new_cache


def _mlp_tapped(p: Params, x: torch.Tensor, act: str,
                tap: torch.Tensor) -> torch.Tensor:
    """MLP with a per-(sample, d_ff-channel) tap scale on the hidden act."""
    if act in ("swiglu", "geglu"):
        h = L._act(act, x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = L._act(act, x @ p["w_up"])
    h = h * tap[:, None, :].to(h.dtype)
    return h @ p["w_down"]


def _layer_chan_idx(plan, chan_idx, lid: int, device) -> Dict[str, Any]:
    """A selected layer's channel indices by kind: the caller's tensors
    (``chan_idx``) where given, else the plan's static numpy indices."""
    ci = (chan_idx or {}).get(lid)
    if ci is None:
        ci = {k: torch.as_tensor(v.astype(np.int64), device=device)
              for k, v in plan.channel_idx.get(lid, {}).items()}
    return ci


def forward_hidden(
    cfg: ArchConfig,
    params: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    caches: Optional[Dict[str, Any]] = None,
    seq_valid: Optional[torch.Tensor] = None,
    step_valid: Optional[torch.Tensor] = None,
    deltas: Optional[Dict[str, Params]] = None,
    plan=None,  # core.policy.SparseUpdatePolicy
    taps: Optional[Dict[str, Any]] = None,
    chan_idx: Optional[Dict[int, Dict[str, torch.Tensor]]] = None,
    overlay: Optional[Dict[int, Dict[str, Tuple[Any, Any]]]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Run the decoder stacks and the final norm.

    At most one of (``deltas`` + ``plan``), ``taps`` and ``caches`` is
    active.  ``taps`` is ``{"g{i}": {"mixer": (L, B, H), "ffn": (L, B,
    d_ff)}}``; each leaf may also be a list of per-layer (B, C) tensors.
    ``chan_idx`` ({layer: {kind: int tensor}}) overrides the plan's static
    channel indices, so one compiled step could serve many tasks.

    With ``caches`` every layer reads and writes its cache in place and
    the same cache tree is returned with new lengths.  ``seq_valid``
    (B, S) enables block-prefill mode (per-slot writes at each slot's own
    cursor, ragged tails masked).  ``step_valid`` (B,) masks slots of a
    single-token decode: a masked slot writes no cache row, keeps its
    length and, in an SSD layer, its conv window and state.  ``overlay``
    ({layer: {kind: (delta_pack, channel_idx)}}, slot-stacked leaves) gives
    those layers per-slot effective weights: the serving engine's
    personalisation path, which passes its policy as ``plan`` with no
    ``deltas``."""
    if plan is not None and (plan.meta or {}).get("remat"):
        raise NotImplementedError(
            "rematerialised backprop spans (policy meta 'remat') arrive "
            "with ROADMAP queue 1, item 9")
    selected = set(plan.selected_layers()) if plan is not None else set()
    horizon = plan.horizon if plan is not None else 0
    for gi, (_, ids) in enumerate(stack_groups(cfg)):
        stack = params["stacks"][f"g{gi}"]
        g_caches = caches.get(f"g{gi}") if caches else None
        g_taps = taps.get(f"g{gi}") if taps else None
        for j, lid in enumerate(ids):
            lp = tree_map(lambda a: a[j], stack)
            cache_in = (tree_map(lambda a: a[j], g_caches)
                        if g_caches is not None else None)
            tap = {k: v[j] for k, v in g_taps.items()} if g_taps else None
            d = ci = None
            if lid in selected and deltas is not None:
                d = deltas.get(f"L{lid}")
                ci = _layer_chan_idx(plan, chan_idx, lid, x.device)
            # below the backprop horizon: forward only, nothing saved
            frozen = (torch.no_grad() if plan is not None and lid < horizon
                      else contextlib.nullcontext())
            with frozen:
                x, nc = _apply_block(cfg, lp, x, positions, lid,
                                     cache=cache_in, valid=seq_valid,
                                     step_valid=step_valid,
                                     deltas=d, chan_idx=ci, taps=tap,
                                     overlay=(overlay or {}).get(lid))
            if g_caches is not None:
                # attention writes its K/V in place; the SSD block returns
                # a new conv window and state
                mk = block_kind(cfg, lid)
                keys = ("conv", "ssm", "len") if mk == "ssm" else ("len",)
                for key in keys:
                    g_caches[mk][key][j] = nc[mk][key]
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return x, caches


def embed_tokens(cfg: ArchConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    e = params["embed"][tokens]
    if (cfg.family in ("vlm", "dense") and cfg.norm == "rmsnorm"
            and cfg.tie_embeddings):
        # gemma-style sqrt(d) embedding scale, rounded to the weight dtype
        # first as the JAX package does; rounded on the host, so the
        # serving tick uploads nothing
        e = e * float(torch.tensor(math.sqrt(cfg.d_model), dtype=e.dtype))
    return e


def unembed(cfg: ArchConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    w = params["unembed"] if not cfg.tie_embeddings else params["embed"].T
    return h @ w


def build_inputs(cfg: ArchConfig, params: Params,
                 batch: Dict[str, torch.Tensor]):
    """A plain token batch -> (x_embed, positions)."""
    tokens = batch["tokens"].long()
    x = embed_tokens(cfg, params, tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None].expand(
            x.shape[:2])
    return x, positions


def lm_loss(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, deltas=None, plan=None, taps=None,
            chan_idx=None) -> torch.Tensor:
    """Next-token cross-entropy (mean over positions with label >= 0)."""
    x, positions = build_inputs(cfg, params, batch)
    h, _ = forward_hidden(cfg, params, x, positions, deltas=deltas,
                          plan=plan, taps=taps, chan_idx=chan_idx)
    labels = batch["labels"].long()
    logits = unembed(cfg, params, h).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (((logz - gold) * mask).sum()
            / torch.clamp(mask.sum(), min=1.0))


def pooled_features(cfg: ArchConfig, params: Params,
                    batch: Dict[str, torch.Tensor], *, deltas=None,
                    plan=None, taps=None, chan_idx=None) -> torch.Tensor:
    """Mean-pooled final hidden state: the feature map f(x) ProtoNet uses
    for few-shot adaptation of an LM backbone (paper Sec. 2.1)."""
    x, positions = build_inputs(cfg, params, batch)
    h, _ = forward_hidden(cfg, params, x, positions, deltas=deltas,
                          plan=plan, taps=taps, chan_idx=chan_idx)
    mask = (batch["tokens"] >= 0).to(h.dtype)
    return ((h * mask[..., None]).sum(dim=1)
            / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0))


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_caches(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
                paging=None, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Decode caches for a slot batch, in the JAX package's layout.

    Contiguous: ``caches["g{i}"]["attn"] = {"k", "v": (L, B, S_max, Hkv,
    Dh), "len": (L, B) int32}``.  Paged (``paging``, a
    ``serving.paging.PagingSpec``; built from the config's knobs when
    omitted and ``cfg.kv_paging`` is set): ``"k"``/``"v"`` are page stores
    ``{"pages": (L, n_pages, page_size, Hkv, Dh)[, "scale"]}`` and
    ``"page_table"`` is a broadcast view ``(L, B, max_pages)`` of one
    table, all -1.  An SSD layer group holds ``caches["g{i}"]["ssm"] =
    {"conv": (L, B, d_conv-1, d_inner + 2N), "ssm": (L, B, H, P, N),
    "len": (L, B) int32}`` (the ssm family has no paged cache yet)."""
    from ..serving import paging as PG  # lazily: serving imports this module

    check_supported(cfg)
    if cfg.family == "ssm" and (paging is not None or cfg.kv_paging):
        raise NotImplementedError(
            "paged caches for the ssm family arrive with ROADMAP queue 1, "
            "item 12.2")
    if paging is None and cfg.kv_paging:
        paging = PG.PagingSpec.build(max_len, page_size=cfg.kv_page_size,
                                     slots=batch, int8=cfg.kv_int8)
    if cfg.sliding_window and cfg.sliding_window <= max_len:
        raise NotImplementedError(
            "rolling sliding-window caches arrive with ROADMAP queue 1, "
            "item 9 (with mixtral, the one config that has a window)")
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)
    feat = (cfg.n_kv_heads, cfg.head_dim)
    caches: Dict[str, Any] = {}
    for gi, (_, ids) in enumerate(stack_groups(cfg)):
        n = len(ids)
        lens = torch.zeros((n, batch), dtype=torch.int32, device=dev)
        if block_kind(cfg, ids[0]) == "ssm":
            conv = (n, batch, cfg.d_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
            state = (n, batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state)
            caches[f"g{gi}"] = {"ssm": {
                "conv": torch.zeros(conv, dtype=dtype, device=dev),
                "ssm": torch.zeros(state, dtype=dtype, device=dev),
                "len": lens,
            }}
            continue
        if paging is not None:
            table = torch.full((batch, paging.max_pages), -1,
                               dtype=torch.int32, device=dev)
            caches[f"g{gi}"] = {"attn": {
                "k": PG.store_init(paging, feat, dtype, dev, lead=(n,)),
                "v": PG.store_init(paging, feat, dtype, dev, lead=(n,)),
                "page_table": table[None].expand(n, *table.shape),
                "len": lens,
            }}
            continue
        shape = (n, batch, max_len) + feat
        caches[f"g{gi}"] = {"attn": {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "len": lens,
        }}
    return caches


def reset_slot_state(caches: Dict[str, Any],
                     mask: torch.Tensor) -> Dict[str, Any]:
    """Reset masked slots to a clean length-0 cache, in place.

    ``mask`` is ``(B,)`` bool over the slot axis.  For attention only the
    lengths zero, for contiguous and paged caches alike: attention masks
    K/V reads by ``kv_len``, so stale rows beyond the reset length (or in
    a recycled page) are never attended to.  An SSD layer's conv window
    and state feed forward with no length mask, so they zero outright,
    with a fill rather than a multiply by 0: a NaN left by a ``numerics``
    stream does not survive into the slot's next occupant."""
    for g in caches.values():
        for kind, c in g.items():
            c["len"].masked_fill_(mask, 0)
            if kind == "ssm":
                for key in ("conv", "ssm"):
                    t = c[key]  # (L, B, ...): the slot axis is 1
                    t.masked_fill_(mask.reshape((1, -1) + (1,) * (t.dim() - 2)),
                                   0)
    return caches


def decode_step(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, 1)
    caches: Dict[str, Any],
    pos: torch.Tensor,     # () shared or (B,) per-slot positions
    valid: Optional[torch.Tensor] = None,  # (B,) bool; None = all valid
    *,
    overlay: Optional[Dict[int, Dict[str, Tuple[Any, Any]]]] = None,
    plan=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: new token -> logits (B, 1, vocab), caches updated
    in place.  A slot masked by ``valid`` writes no K/V row and keeps its
    cache length, SSD conv window and state bit for bit; its logits are
    meaningless, and the other slots' are those of the unmasked call.
    ``overlay`` + ``plan`` decode each slot against its own delta set (see
    :func:`forward_hidden`)."""
    x = embed_tokens(cfg, params, tokens)
    pos = torch.as_tensor(pos, device=tokens.device)
    positions = pos[:, None] if pos.dim() else pos.expand(tokens.shape)
    h, caches = forward_hidden(cfg, params, x, positions, caches=caches,
                               step_valid=valid, overlay=overlay, plan=plan)
    return unembed(cfg, params, h), caches


def prefill_block(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, S) block of prompt tokens, left-aligned valid
    caches: Dict[str, Any],
    pos: torch.Tensor,     # (B,) absolute position of tokens[:, 0]
    valid: Optional[torch.Tensor] = None,  # (B, S) bool; None = all valid
    *,
    overlay: Optional[Dict[int, Dict[str, Tuple[Any, Any]]]] = None,
    plan=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Sequence-mode prompt ingestion: a whole (B, S) block per call.

    Each slot writes its ``valid`` tokens at its own cache cursor and
    attends causally from its own offset through the cached flash kernel.
    ``valid`` must be a left-aligned prefix mask per slot (all-False rows
    are paused slots and advance nothing).  Returns (logits (B, S, vocab),
    caches); only logits at valid positions are meaningful."""
    x = embed_tokens(cfg, params, tokens)
    s = tokens.shape[1]
    positions = (torch.as_tensor(pos, device=tokens.device)[:, None]
                 + torch.arange(s, device=tokens.device)[None, :])
    if valid is None:
        valid = torch.ones(tokens.shape, dtype=torch.bool,
                           device=tokens.device)
    h, caches = forward_hidden(cfg, params, x, positions, caches=caches,
                               seq_valid=valid, overlay=overlay, plan=plan)
    return unembed(cfg, params, h), caches
