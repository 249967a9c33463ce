"""The decoder LM (dense, moe, ssm and hybrid families): the port of
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
per slot is a conv window and a (H, P, N) state.

The hybrid family (zamba2) is the same SSD stack with one weight-shared
attention + MLP block (``params["shared_attn"]``) applied after every
layer ``lid`` with ``(lid + 1) % hybrid_attn_every == 0``, in every mode;
each application has its own attention cache ``caches["shared{lid}"]``
(contiguous or paged, unstacked, as in the JAX package).  The shared block
is not a selectable unit: no tap, delta or overlay reaches it.

The moe family: mixtral-8x7b's layers are attention with a sliding
window and a MoE FFN (units ``attn`` over heads, ``moe`` over experts);
its cache rolls once ``max_len`` passes the window.  deepseek-v3's are
MLA (its heads are the ``attn`` unit, its cache the compressed latent)
over ``moe_start_layer`` dense-head MLP layers of ``dense_d_ff`` and MoE
layers with a shared expert; its MTP head (``params["mtp"]``: a
projection, one block of the last layer's kind, a norm) adds ``0.1 x``
its loss to ``lm_loss``, and the MoE aux adds ``0.01 x``.  The serving
programs run the MoE drop-free (``drop_free=True``), training and the
dry run's decode step capped.

The encoder-decoder family (whisper): :func:`encode` runs a stack of
``n_enc_layers`` non-causal attention + MLP layers (``params["encoder"]``,
then ``enc_norm``) over precomputed frame embeddings; every decoder layer
runs self-attention, its MLP, then cross-attention over the encoder's
output (``norm_x`` + ``xattn``), a unit of its own (``xattn``, over
heads, with a tap group of its own).  A decoder layer with
cross-attention weights and no encoder output refuses to run
(``ValueError``), as the JAX package's does.  The VLM family
(paligemma): ``img_proj`` maps precomputed patch embeddings to a prefix
of ``n_img_tokens`` positions ahead of the tokens; ``lm_loss`` and
``pooled_features`` read the hidden states past it (the pooled mask
counts the prefix).  Serving feeds placeholder tokens there and swaps
their embeddings for the request's prefix rows (``embed_prefix``), and
passes an encoder-decoder request's encoder output as ``enc_out``.

A policy's ``meta["remat"]`` recomputes the layers of the backprop span
in the backward (``layers.remat``), and ``lm_loss(logit_chunk=)`` takes
the cross-entropy over sequence chunks, each chunk's logits recomputed in
the backward, so the (B, S, vocab) logits never exist whole.
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
    kind: str  # mlp | attn | moe | ssm
    n_channels: int
    n_params: int
    macs_per_token: int


def unit_descs(cfg: ArchConfig) -> List[UnitDesc]:
    """Selectable units with parameter and MAC costs (Eq. 3 terms)."""
    check_supported(cfg)
    out: List[UnitDesc] = []
    d = cfg.d_model
    for i in range(cfg.n_layers):
        bk, fk = block_kind(cfg, i), ffn_kind(cfg, i)
        if bk == "ssm":
            di, n = cfg.d_inner, cfg.ssm_state
            np_ = d * (2 * di + 2 * n + cfg.n_ssm_heads) + di * d
            out.append(UnitDesc(i, "ssm", cfg.n_ssm_heads, np_, np_))
        elif bk == "mla":
            np_ = (d * cfg.q_lora_rank
                   + cfg.q_lora_rank * cfg.n_heads
                   * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                   + d * cfg.kv_lora_rank
                   + cfg.kv_lora_rank * cfg.n_heads
                   * (cfg.qk_nope_dim + cfg.v_head_dim)
                   + d * cfg.qk_rope_dim
                   + cfg.n_heads * cfg.v_head_dim * d)
            out.append(UnitDesc(i, "attn", cfg.n_heads, np_, np_))
        else:
            np_ = d * (cfg.q_dim * 2 + cfg.kv_dim * 2)
            out.append(UnitDesc(i, "attn", cfg.n_heads, np_, np_))
            if cfg.is_encoder_decoder:
                # the decoder's cross-attention heads: the same projection
                # shapes, K/V over the encoder's tokens
                out.append(UnitDesc(i, "xattn", cfg.n_heads, np_, np_))
        if fk == "mlp":
            f = mlp_d_ff(cfg, i)
            mult = 3 if cfg.act in ("swiglu", "geglu") else 2
            np_ = mult * d * f
            out.append(UnitDesc(i, "mlp", f, np_, np_))
        elif fk == "moe":
            np_ = cfg.n_experts * 3 * d * cfg.d_expert
            macs = cfg.top_k * 3 * d * cfg.d_expert  # the active experts'
            out.append(UnitDesc(i, "moe", cfg.n_experts, np_, macs))
    return out


def mlp_d_ff(cfg: ArchConfig, layer: int) -> int:
    """d_ff of a layer's MLP: ``dense_d_ff`` in a MoE model's dense head."""
    if cfg.n_experts and layer < cfg.moe_start_layer:
        return cfg.dense_d_ff
    return cfg.d_ff


def cache_kind(cfg: ArchConfig, layer: int) -> str:
    """Key of a layer's serving cache: ``"ssm"``, else ``"attn"`` (MLA's
    latent cache included, as in the JAX package)."""
    return "ssm" if block_kind(cfg, layer) == "ssm" else "attn"


def overlay_kinds(cfg: ArchConfig, layer: int) -> Tuple[str, ...]:
    """The policy unit kinds the per-slot forward applies at ``layer``
    (``overlay=``): its mixer's (``"attn"``, MLA's heads included, or
    ``"ssm"``), its FFN's (``"mlp"`` or ``"moe"``) and, on an
    encoder-decoder config, ``"xattn"``.  An overlay under any other kind
    would be carried and never applied."""
    kinds = ("ssm" if block_kind(cfg, layer) == "ssm" else "attn",)
    if ffn_kind(cfg, layer) != "none":
        kinds += (ffn_kind(cfg, layer),)
    if cfg.is_encoder_decoder:
        kinds += ("xattn",)
    return kinds


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


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a family the port does not know: every
    family of the JAX package runs."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} "
                         f"(known: {FAMILIES})")


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator], *,
                device: DeviceLike = "cuda") -> Params:
    """Random weights in the JAX package's layout and distributions
    (uniform ±1/sqrt(d_in) projections, N(0, 0.02²) embedding, zero
    biases, rmsnorm weights 0 since the norm scales by ``1 + w``).  The
    numbers are ``generator``'s, which must live on ``device``; they are
    not ``jax.random``'s — load JAX weights with ``bridge`` instead.
    On ``device="meta"`` the generator may be None: the tree's shapes and
    dtypes, nothing drawn or allocated (``jax.eval_shape`` of the JAX
    package's ``init_params``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        raise ValueError("init_params needs a generator (None only on "
                         "device='meta')")
    dtype = torch_dtype(cfg)

    def dense(*shape):  # (..., d_in, d_out)
        if dev.type == "meta":
            return torch.empty(shape, dtype=dtype, device=dev)
        s = 1.0 / math.sqrt(shape[-2])
        if len(shape) == 4:
            # an expert stack (L, E, d_in, d_out): filled a matrix at a
            # time, so no float32 copy of the whole stack is ever held
            out = torch.empty(shape, dtype=dtype, device=dev)
            for m in out.view(-1, *shape[-2:]):
                u = torch.rand(shape[-2:], generator=generator, device=dev)
                m.copy_(u * (2 * s) - s)
            return out
        u = torch.rand(shape, generator=generator, device=dev)
        return (u * (2 * s) - s).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def norm(*lead):
        if cfg.norm == "rmsnorm":
            return {"w": zeros(*lead, cfg.d_model)}
        return {"w": torch.ones(*lead, cfg.d_model, dtype=dtype, device=dev),
                "b": zeros(*lead, cfg.d_model)}

    def mlp(lead, f, act):
        if act in ("swiglu", "geglu"):
            return {"w_gate": dense(*lead, d, f), "w_up": dense(*lead, d, f),
                    "w_down": dense(*lead, f, d)}
        return {"w_up": dense(*lead, d, f), "w_down": dense(*lead, f, d)}

    def gqa(*lead):
        attn = {"wq": dense(*lead, d, cfg.q_dim),
                "wk": dense(*lead, d, cfg.kv_dim),
                "wv": dense(*lead, d, cfg.kv_dim),
                "wo": dense(*lead, cfg.q_dim, d)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(*lead, cfg.q_dim),
                        bk=zeros(*lead, cfg.kv_dim),
                        bv=zeros(*lead, cfg.kv_dim))
        return attn

    def stack(ids):
        n, lid = len(ids), ids[0]
        if block_kind(cfg, lid) == "ssm":
            return {"norm1": norm(n),
                    "ssm": S.ssd_init(cfg, generator, dtype=dtype,
                                      device=dev, lead=(n,))}
        if block_kind(cfg, lid) == "mla":
            h, r, q = cfg.n_heads, cfg.kv_lora_rank, cfg.q_lora_rank
            attn = {"w_dq": dense(n, d, q), "q_norm": zeros(n, q),
                    "w_uq": dense(n, q, h * (cfg.qk_nope_dim
                                             + cfg.qk_rope_dim)),
                    "w_dkv": dense(n, d, r), "kv_norm": zeros(n, r),
                    "w_uk": dense(n, r, h * cfg.qk_nope_dim),
                    "w_uv": dense(n, r, h * cfg.v_head_dim),
                    "w_kr": dense(n, d, cfg.qk_rope_dim),
                    "wo": dense(n, h * cfg.v_head_dim, d)}
        else:
            attn = gqa(n)
        out = {"norm1": norm(n), "attn": attn, "norm2": norm(n)}
        if ffn_kind(cfg, lid) == "moe":
            e, f = cfg.n_experts, cfg.d_expert
            out["moe"] = {"router": dense(n, d, e),
                          "w_gate": dense(n, e, d, f),
                          "w_up": dense(n, e, d, f),
                          "w_down": dense(n, e, f, d)}
            if cfg.n_shared_experts:
                out["moe"]["shared"] = mlp((n,), f * cfg.n_shared_experts,
                                           "swiglu")
        else:
            out["mlp"] = mlp((n,), mlp_d_ff(cfg, lid), cfg.act)
        if cfg.is_encoder_decoder:
            # the decoder's cross-attention, after its MLP
            out.update(norm_x=norm(n), xattn=gqa(n))
        return out

    d = cfg.d_model
    p: Params = {"embed": (torch.randn((cfg.vocab, d), generator=generator,
                                       device=dev) * 0.02).to(dtype),
                 "stacks": {}}
    for gi, (_, ids) in enumerate(stack_groups(cfg)):
        p["stacks"][f"g{gi}"] = stack(ids)
    if _shared_every(cfg):
        # zamba2's one weight-shared attention + MLP block
        p["shared_attn"] = {"norm1": norm(), "attn": gqa(), "norm2": norm(),
                            "mlp": mlp((), cfg.d_ff, cfg.act)}
    if cfg.is_encoder_decoder:
        ne = cfg.n_enc_layers
        p["encoder"] = {"norm1": norm(ne), "attn": gqa(ne),
                        "norm2": norm(ne), "mlp": mlp((ne,), cfg.d_ff,
                                                      cfg.act)}
        p["enc_norm"] = norm()
    if cfg.family == "vlm":
        p["img_proj"] = dense(cfg.img_embed_dim, d)
    p["final_norm"] = norm()
    if not cfg.tie_embeddings:
        p["unembed"] = dense(d, cfg.vocab)
    if cfg.mtp:
        # deepseek's multi-token-prediction head: one block of the last
        # layer's kind
        p["mtp"] = {"proj": dense(2 * d, d), "block": stack([cfg.n_layers - 1]),
                    "norm": norm()}
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _apply_block(cfg: ArchConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, layer: int, *,
                 cache: Optional[Params] = None,
                 enc_out: Optional[torch.Tensor] = None,
                 valid: Optional[torch.Tensor] = None,
                 step_valid: Optional[torch.Tensor] = None,
                 deltas: Optional[Dict[str, Params]] = None,
                 chan_idx: Optional[Dict[str, torch.Tensor]] = None,
                 taps: Optional[Dict[str, torch.Tensor]] = None,
                 overlay: Optional[Dict[str, Tuple[Any, Any]]] = None,
                 drop_free: bool = False,
                 ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """One decoder layer (attention or MLA + an MLP or MoE, or an SSD
    block alone; an encoder-decoder layer then cross-attends to
    ``enc_out``).  Returns (x, new_cache, the MoE's aux loss or 0).

    ``deltas``/``chan_idx`` are this layer's delta packs and channel
    indices by unit kind; ``taps`` its (B, C) probe taps by group
    (``mixer``, ``ffn``, ``xattn``; the mixer tap's channels are
    attention, MLA or SSD heads, the FFN's d_ff neurons or experts, the
    xattn tap's cross-attention heads).  A layer with cross-attention
    weights and no ``enc_out`` raises ``ValueError`` rather than skip
    it.  ``drop_free`` sizes
    the MoE's queues so no routed token drops (the serving programs).
    The taps are cast to the activation's dtype: the
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
            spec = OV.get_overlay(OV.resolve_kind(cfg, kind))
            key = getattr(spec, "param_key", kind)  # a raw folder: refused
            return OV.slot_params(cfg, kind, p[key], d_stk, i_stk)
        return p[kind]

    h = L.apply_norm(cfg.norm, p["norm1"], x)
    mk, ck = block_kind(cfg, layer), cache_kind(cfg, layer)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mk == "ssm":
        y, c = S.ssd_apply(eff("ssm"), h, cfg,
                           cache=cache["ssm"] if cache else None,
                           valid=valid, step_valid=step_valid,
                           delta=deltas.get("ssm"),
                           head_idx=chan_idx.get("ssm"))
    else:
        apply = L.mla_apply if mk == "mla" else L.attention_apply
        y, c = apply(eff("attn"), h, cfg, positions=positions,
                     cache=cache["attn"] if cache else None,
                     valid=valid, step_valid=step_valid,
                     delta=deltas.get("attn"), head_idx=chan_idx.get("attn"))
    x = x + _head_tap(y, taps.get("mixer"))
    new_cache = {ck: c} if cache is not None else None
    fk = ffn_kind(cfg, layer)
    if fk != "none":
        h = L.apply_norm(cfg.norm, p["norm2"], x)
        if fk == "moe":
            y, aux = L.moe_apply(eff("moe"), h, cfg, delta=deltas.get("moe"),
                                 expert_idx=chan_idx.get("moe"),
                                 tap=taps.get("ffn"), drop_free=drop_free)
            x = x + y
        elif "ffn" in taps:
            x = x + _mlp_tapped(p["mlp"], h, cfg.act, taps["ffn"])
        else:
            x = x + L.mlp_apply(eff("mlp"), h, cfg.act,
                                delta=deltas.get("mlp"),
                                idx=chan_idx.get("mlp"))
    if "norm_x" in p:
        # the encoder-decoder layer's cross-attention, gated on its own
        # weights: without the encoder's output it must fail, not decode
        # without its conditioning
        if enc_out is None:
            raise ValueError(
                "encoder-decoder layer has cross-attention parameters but "
                "no enc_out was supplied — refusing to silently skip xattn "
                "(pass the encoder outputs / Request.enc_feats)")
        h = L.apply_norm(cfg.norm, p["norm_x"], x)
        y, _ = L.attention_apply(eff("xattn"), h, cfg, positions=positions,
                                 cross_hidden=enc_out,
                                 delta=deltas.get("xattn"),
                                 head_idx=chan_idx.get("xattn"))
        x = x + _head_tap(y, taps.get("xattn"))
    return x, new_cache, aux


def _head_tap(y: torch.Tensor, tap: Optional[torch.Tensor]) -> torch.Tensor:
    """``y`` (B, S, D) scaled per (sample, head chunk) by the probe's
    ``tap`` (B, n_heads); ``y`` itself without one."""
    if tap is None:
        return y
    yb = y.reshape(y.shape[0], y.shape[1], tap.shape[-1], -1)
    return (yb * tap[:, None, :, None].to(y.dtype)).reshape(y.shape)


def _mlp_tapped(p: Params, x: torch.Tensor, act: str,
                tap: torch.Tensor) -> torch.Tensor:
    """MLP with a per-(sample, d_ff-channel) tap scale on the hidden act."""
    if act in ("swiglu", "geglu"):
        h = L._act(act, x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = L._act(act, x @ p["w_up"])
    h = h * tap[:, None, :].to(h.dtype)
    return h @ p["w_down"]


def _shared_every(cfg: ArchConfig) -> int:
    """Layers between two applications of the hybrid family's shared
    block (0: no shared block)."""
    return cfg.hybrid_attn_every if cfg.family == "hybrid" else 0


def _shared_attn_apply(cfg: ArchConfig, p: Params, x: torch.Tensor,
                       positions: torch.Tensor, *,
                       cache: Optional[Params] = None,
                       valid: Optional[torch.Tensor] = None,
                       step_valid: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, Optional[Params]]:
    """zamba2's weight-shared block: attention, then an MLP, each behind
    its own norm and residual.  Returns (x, the attention's cache)."""
    h = L.apply_norm(cfg.norm, p["norm1"], x)
    y, c = L.attention_apply(p["attn"], h, cfg, positions=positions,
                             cache=cache, valid=valid, step_valid=step_valid)
    x = x + y
    h = L.apply_norm(cfg.norm, p["norm2"], x)
    return x + L.mlp_apply(p["mlp"], h, cfg.act), c


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
    enc_out: Optional[torch.Tensor] = None,
    seq_valid: Optional[torch.Tensor] = None,
    step_valid: Optional[torch.Tensor] = None,
    deltas: Optional[Dict[str, Params]] = None,
    plan=None,  # core.policy.SparseUpdatePolicy
    taps: Optional[Dict[str, Any]] = None,
    chan_idx: Optional[Dict[int, Dict[str, torch.Tensor]]] = None,
    overlay: Optional[Dict[int, Dict[str, Tuple[Any, Any]]]] = None,
    drop_free: bool = False,
    with_aux: bool = False,
):
    """Run the decoder stacks and the final norm: (x, caches), or (x,
    caches, the MoE layers' summed aux loss) ``with_aux``.

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
    ``deltas``.  ``drop_free`` runs every MoE layer drop-free.  On a hybrid
    config the shared block runs after every ``hybrid_attn_every``-th
    layer, in every mode, against ``caches["shared{lid}"]`` when
    serving.  ``enc_out`` (B, Se, D) is the encoder's output every
    encoder-decoder layer cross-attends to.

    A policy whose ``meta["remat"]`` is set recomputes in the backward
    every layer of the backprop span that runs without a cache (the JAX
    package checkpoints its selected layers and its tap-free scanned runs
    above the horizon): the same values, with only each layer's input
    kept (``layers.remat``, which raises under ``torch.func``)."""
    selected = set(plan.selected_layers()) if plan is not None else set()
    horizon = plan.horizon if plan is not None else 0
    remat = plan is not None and bool((plan.meta or {}).get("remat", False))
    every = _shared_every(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
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
            below = plan is not None and lid < horizon
            frozen = torch.no_grad() if below else contextlib.nullcontext()

            def block(x_, lp=lp, cache_in=cache_in, tap=tap, d=d, ci=ci,
                      lid=lid):
                return _apply_block(cfg, lp, x_, positions, lid,
                                    cache=cache_in, enc_out=enc_out,
                                    valid=seq_valid, step_valid=step_valid,
                                    deltas=d, chan_idx=ci, taps=tap,
                                    overlay=(overlay or {}).get(lid),
                                    drop_free=drop_free)

            with frozen:
                # the JAX package remats its selected layers and its
                # tap-free runs of unselected ones above the horizon
                if (remat and not below and cache_in is None
                        and (lid in selected or tap is None)):
                    x, nc, aux = L.remat(block, x)
                else:
                    x, nc, aux = block(x)
            aux_total = aux_total + aux
            if g_caches is not None:
                # attention and MLA write their rows in place; the SSD
                # block returns a new conv window and state
                ck = cache_kind(cfg, lid)
                keys = ("conv", "ssm", "len") if ck == "ssm" else ("len",)
                for key in keys:
                    g_caches[ck][key][j] = nc[ck][key]
            if every and (lid + 1) % every == 0:
                sc = caches.get(f"shared{lid}") if caches else None
                with frozen:
                    x, c = _shared_attn_apply(cfg, params["shared_attn"], x,
                                              positions, cache=sc,
                                              valid=seq_valid,
                                              step_valid=step_valid)
                if sc is not None:
                    sc["len"].copy_(c["len"])
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    if with_aux:
        return x, caches, aux_total
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


def encode(cfg: ArchConfig, params: Params,
           frames: torch.Tensor) -> torch.Tensor:
    """The whisper encoder over precomputed frame embeddings (B, Se, D):
    ``n_enc_layers`` of non-causal attention and an MLP, each behind its
    norm and residual, then ``enc_norm``.  Cache-free attention over 1500
    frames is past ``1024²`` and takes ``layers.chunked_attention``."""
    x = frames
    positions = torch.arange(x.shape[1], device=x.device)[None].expand(
        x.shape[:2])
    enc = params["encoder"]
    for j in range(enc["norm1"]["w"].shape[0]):
        lp = tree_map(lambda a: a[j], enc)
        h = L.apply_norm(cfg.norm, lp["norm1"], x)
        y, _ = L.attention_apply(lp["attn"], h, cfg, positions=positions,
                                 causal=False)
        x = x + y
        h = L.apply_norm(cfg.norm, lp["norm2"], x)
        x = x + L.mlp_apply(lp["mlp"], h, cfg.act)
    return L.apply_norm(cfg.norm, params["enc_norm"], x)


def project_image(params: Params, feats: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Patch embeddings through ``img_proj`` in the two operands' promoted
    dtype (float32 features against bf16 weights compute in float32, as
    JAX promotes them), cast to ``dtype``."""
    w = params["img_proj"]
    dt = torch.promote_types(feats.dtype, w.dtype)
    return (feats.to(dt) @ w.to(dt)).to(dtype)


def build_inputs(cfg: ArchConfig, params: Params,
                 batch: Dict[str, torch.Tensor]):
    """A raw batch -> (x_embed, positions, enc_out).  A vlm batch's
    ``image_embeds`` (B, P, img_embed_dim) become a prefix of P positions
    ahead of the token embeddings; an encoder-decoder batch's ``frames``
    (B, Se, D), cast to the model's dtype, go through :func:`encode`, whose
    output every decoder layer cross-attends to (None elsewhere)."""
    tokens = batch["tokens"].long()
    x = embed_tokens(cfg, params, tokens)
    enc_out = None
    if cfg.family == "vlm":
        img = project_image(params, batch["image_embeds"], x.dtype)
        x = torch.cat([img, x], dim=1)
    if cfg.is_encoder_decoder:
        enc_out = encode(cfg, params, batch["frames"].to(x.dtype))
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None].expand(
            x.shape[:2])
    return x, positions, enc_out


def _ce_sums(cfg: ArchConfig, params: Params, h: torch.Tensor,
             labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the NLL, count of labels >= 0) over one hidden chunk."""
    labels = labels.long()
    logits = unembed(cfg, params, h).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def ce_from_hidden(cfg: ArchConfig, params: Params, h: torch.Tensor,
                   labels: torch.Tensor,
                   logit_chunk: int = 0) -> torch.Tensor:
    """Cross-entropy of ``h``'s logits, the mean over labels >= 0.  With
    ``logit_chunk`` > 0 dividing S (and below it) the sums run over
    sequence chunks, in order, each chunk's logits recomputed in the
    backward (``layers.remat``), so the (B, S, vocab) logits never exist
    whole, as in the JAX package's scan."""
    b, s = h.shape[:2]
    if logit_chunk and s > logit_chunk and s % logit_chunk == 0:
        nll = h.new_zeros((), dtype=torch.float32)
        m = h.new_zeros((), dtype=torch.float32)
        for c0 in range(0, s, logit_chunk):
            n_c, m_c = L.remat(
                lambda hc, lc: _ce_sums(cfg, params, hc, lc),
                h[:, c0:c0 + logit_chunk], labels[:, c0:c0 + logit_chunk])
            nll, m = nll + n_c, m + m_c
    else:
        nll, m = _ce_sums(cfg, params, h, labels)
    return nll / torch.clamp(m, min=1.0)


def lm_loss(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, deltas=None, plan=None, taps=None, chan_idx=None,
            logit_chunk: int = 0) -> torch.Tensor:
    """Next-token cross-entropy (mean over positions with label >= 0),
    plus ``0.01 x`` the MoE aux loss on a MoE config and ``0.1 x`` the MTP
    head's loss on an MTP config, as in the JAX package.  On a vlm config
    the labels cover the tokens only: the hidden states of the image
    prefix are cut off first.  ``logit_chunk``: see
    :func:`ce_from_hidden`."""
    x, positions, enc_out = build_inputs(cfg, params, batch)
    h, _, aux = forward_hidden(cfg, params, x, positions, enc_out=enc_out,
                               deltas=deltas, plan=plan, taps=taps,
                               chan_idx=chan_idx, with_aux=True)
    labels = batch["labels"]
    if cfg.family == "vlm":
        h = h[:, -labels.shape[1]:]
    loss = ce_from_hidden(cfg, params, h, labels, logit_chunk)
    if cfg.n_experts:
        loss = loss + 0.01 * aux
    if cfg.mtp:
        loss = loss + 0.1 * _mtp_loss(cfg, params, h, batch, logit_chunk)
    return loss


def _mtp_loss(cfg: ArchConfig, params: Params, h: torch.Tensor,
              batch: Dict[str, torch.Tensor],
              logit_chunk: int = 0) -> torch.Tensor:
    """deepseek's one-deep multi-token prediction: the hidden state at t
    and the embedding of token t + 1 predict label t + 2 through the MTP
    block (capped MoE dispatch, no taps or deltas); zero on a vlm
    config, as in the JAX package."""
    if cfg.family == "vlm":
        return torch.zeros((), dtype=torch.float32, device=h.device)
    nxt = embed_tokens(cfg, params, torch.roll(batch["tokens"].long(), -1, 1))
    z = torch.cat([h[:, :-2], nxt[:, 1:-1].to(h.dtype)], dim=-1)
    z = z @ params["mtp"]["proj"]
    positions = torch.arange(z.shape[1], device=z.device)[None].expand(
        z.shape[:2])
    lp = tree_map(lambda a: a[0], params["mtp"]["block"])
    z, _, _ = _apply_block(cfg, lp, z, positions, cfg.n_layers - 1)
    z = L.apply_norm(cfg.norm, params["mtp"]["norm"], z)
    return ce_from_hidden(cfg, params, z, batch["labels"][:, 2:],
                          logit_chunk)


def pooled_features(cfg: ArchConfig, params: Params,
                    batch: Dict[str, torch.Tensor], *, deltas=None,
                    plan=None, taps=None, chan_idx=None) -> torch.Tensor:
    """Mean-pooled final hidden state: the feature map f(x) ProtoNet uses
    for few-shot adaptation of an LM backbone (paper Sec. 2.1).  A vlm
    batch's image prefix counts in the mean."""
    x, positions, enc_out = build_inputs(cfg, params, batch)
    h, _ = forward_hidden(cfg, params, x, positions, enc_out=enc_out,
                          deltas=deltas, plan=plan, taps=taps,
                          chan_idx=chan_idx)
    mask = (batch["tokens"] >= 0).to(h.dtype)
    if cfg.family == "vlm":
        pad = torch.ones((h.shape[0], h.shape[1] - mask.shape[1]),
                         dtype=h.dtype, device=h.device)
        mask = torch.cat([pad, mask], dim=1)
    return ((h * mask[..., None]).sum(dim=1)
            / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0))


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_caches(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
                paging=None, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Decode caches for a slot batch, in the JAX package's layout.

    Contiguous: ``caches["g{i}"]["attn"] = {"k", "v": (L, B, S_max, Hkv,
    Dh), "len": (L, B) int32}``, with ``S_max = min(max_len, window)`` on a
    sliding-window config (the cache rolls when it holds exactly the
    window).  MLA layers hold the latent ``{"ckv": (L, B, max_len,
    kv_lora_rank), "krope": (L, B, max_len, qk_rope_dim), "len"}``.
    Paged (``paging``, a ``serving.paging.PagingSpec``; built from the
    config's knobs when omitted and ``cfg.kv_paging`` is set): the row
    tensors are page stores ``{"pages": (L, n_pages, page_size, *feat)[,
    "scale"]}`` and ``"page_table"`` is a broadcast view ``(L, B,
    max_pages)`` of one table, all -1; a window below ``max_len`` keeps
    its rolling cache contiguous, as in the JAX package.  An SSD layer
    group holds ``caches["g{i}"]["ssm"] = {"conv": (L, B, d_conv-1,
    d_inner + 2N), "ssm": (L, B, H, P, N), "len": (L, B) int32}``, never
    paged (it is fixed-size; a pure-ssm config under paging has no page
    store at all).  A hybrid config adds one unstacked attention cache an
    application of its shared block, ``caches["shared{lid}"] = {"k", "v":
    (B, max_len, Hkv, Dh), "len": (B,)}``, or paged ``{"k", "v": page
    stores, "page_table": (B, max_pages), "len"}`` whose table is the one
    tensor every paged layer views."""
    from ..serving import paging as PG  # lazily: serving imports this module

    check_supported(cfg)
    if paging is None and cfg.kv_paging:
        paging = PG.PagingSpec.build(max_len, page_size=cfg.kv_page_size,
                                     slots=batch, int8=cfg.kv_int8)
    # the JAX package's conditions: a window below max_len rolls (and
    # stays contiguous); the cache holds min(max_len, window) rows
    rolling = bool(cfg.sliding_window) and cfg.sliding_window < max_len
    s_max = (min(max_len, cfg.sliding_window) if cfg.sliding_window
             else max_len)
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)
    caches: Dict[str, Any] = {}
    table = (torch.full((batch, paging.max_pages), -1, dtype=torch.int32,
                        device=dev) if paging is not None else None)
    for gi, (_, ids) in enumerate(stack_groups(cfg)):
        n, mk = len(ids), block_kind(cfg, ids[0])
        lens = torch.zeros((n, batch), dtype=torch.int32, device=dev)
        if mk == "ssm":
            conv = (n, batch, cfg.d_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
            state = (n, batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state)
            caches[f"g{gi}"] = {"ssm": {
                "conv": torch.zeros(conv, dtype=dtype, device=dev),
                "ssm": torch.zeros(state, dtype=dtype, device=dev),
                "len": lens,
            }}
            continue
        if mk == "mla":
            feats = {"ckv": (cfg.kv_lora_rank,), "krope": (cfg.qk_rope_dim,)}
            rows = max_len
        else:
            feats = {"k": (cfg.n_kv_heads, cfg.head_dim),
                     "v": (cfg.n_kv_heads, cfg.head_dim)}
            rows = s_max
        if paging is not None and (mk == "mla" or not rolling):
            c = {name: PG.store_init(paging, f, dtype, dev, lead=(n,))
                 for name, f in feats.items()}
            c.update(page_table=table[None].expand(n, *table.shape),
                     len=lens)
        else:
            c = {name: torch.zeros((n, batch, rows) + f, dtype=dtype,
                                   device=dev)
                 for name, f in feats.items()}
            c["len"] = lens
        caches[f"g{gi}"] = {"attn": c}
    every = _shared_every(cfg)
    for lid in range(every - 1, cfg.n_layers, every) if every else ():
        feat = (cfg.n_kv_heads, cfg.head_dim)
        if paging is not None and not rolling:
            c = {name: PG.store_init(paging, feat, dtype, dev)
                 for name in ("k", "v")}
            c["page_table"] = table
        else:
            c = {name: torch.zeros((batch, s_max) + feat, dtype=dtype,
                                   device=dev) for name in ("k", "v")}
        c["len"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
        caches[f"shared{lid}"] = c
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
        if "len" in g:  # a hybrid config's shared-block cache
            g["len"].masked_fill_(mask, 0)
            continue
        for kind, c in g.items():
            c["len"].masked_fill_(mask, 0)
            if kind == "ssm":
                for key in ("conv", "ssm"):
                    t = c[key]  # (L, B, ...): the slot axis is 1
                    t.masked_fill_(mask.reshape((1, -1) + (1,) * (t.dim() - 2)),
                                   0)
    return caches


def _swap_prefix(x: torch.Tensor, positions: torch.Tensor,
                 embed_prefix: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings at absolute positions < P replaced by rows of
    ``embed_prefix`` (B, P, D): the serving twin of :func:`build_inputs`'s
    image-prefix concat, applied by position so block prefill and decode
    both take it (the rows enter without the gemma sqrt(d) scale)."""
    if embed_prefix is None:
        return x
    n = embed_prefix.shape[1]
    sel = positions.clamp(0, n - 1).long()
    rows = torch.gather(embed_prefix.to(x.dtype), 1,
                        sel[..., None].expand(*sel.shape, x.shape[-1]))
    return torch.where((positions < n)[..., None], rows, x)


def decode_step(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, 1)
    caches: Dict[str, Any],
    pos: torch.Tensor,     # () shared or (B,) per-slot positions
    valid: Optional[torch.Tensor] = None,  # (B,) bool; None = all valid
    *,
    enc_out: Optional[torch.Tensor] = None,
    embed_prefix: Optional[torch.Tensor] = None,
    overlay: Optional[Dict[int, Dict[str, Tuple[Any, Any]]]] = None,
    plan=None,
    drop_free: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: new token -> logits (B, 1, vocab), caches updated
    in place.  ``enc_out`` (B, Se, D) is each slot's encoder output (an
    encoder-decoder config's cross-attention reads it), ``embed_prefix``
    (B, P, D) each slot's image prefix (a vlm config's placeholder tokens
    at positions < P take its rows).  A slot masked by ``valid`` writes no K/V (or latent) row
    and keeps its cache length, SSD conv window and state bit for bit; its
    logits are meaningless, and the other slots' are those of the unmasked
    call.  ``overlay`` + ``plan`` decode each slot against its own delta
    set (see :func:`forward_hidden`).  ``drop_free=True`` is the serving
    engine's setting: the MoE queues are sized so no routed token drops,
    and a slot's stream does not depend on its batch neighbours.  The
    default, as in the JAX package, is the capped queue of training,
    ``max(4, int(capacity_factor · B · top_k / E))`` over the B tokens of
    the step, which the dry run counts."""
    x = embed_tokens(cfg, params, tokens)
    pos = torch.as_tensor(pos, device=tokens.device)
    positions = pos[:, None] if pos.dim() else pos.expand(tokens.shape)
    x = _swap_prefix(x, positions, embed_prefix)
    h, caches = forward_hidden(cfg, params, x, positions, caches=caches,
                               enc_out=enc_out, step_valid=valid,
                               overlay=overlay, plan=plan,
                               drop_free=drop_free)
    return unembed(cfg, params, h), caches


def prefill_block(
    cfg: ArchConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, S) block of prompt tokens, left-aligned valid
    caches: Dict[str, Any],
    pos: torch.Tensor,     # (B,) absolute position of tokens[:, 0]
    valid: Optional[torch.Tensor] = None,  # (B, S) bool; None = all valid
    *,
    enc_out: Optional[torch.Tensor] = None,
    embed_prefix: Optional[torch.Tensor] = None,
    overlay: Optional[Dict[int, Dict[str, Tuple[Any, Any]]]] = None,
    plan=None,
    drop_free: bool = True,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Sequence-mode prompt ingestion: a whole (B, S) block per call
    (``enc_out`` and ``embed_prefix`` as in :func:`decode_step`).

    Each slot writes its ``valid`` tokens at its own cache cursor and
    attends causally from its own offset through the cached flash kernel
    (a rolling window cache folds the block position by position, an MLA
    layer reads its latent cache in the absorbed form); MoE layers run
    drop-free unless ``drop_free=False`` (the JAX package's default here
    too).
    ``valid`` must be a left-aligned prefix mask per slot (all-False rows
    are paused slots and advance nothing).  Returns (logits (B, S, vocab),
    caches); only logits at valid positions are meaningful."""
    x = embed_tokens(cfg, params, tokens)
    s = tokens.shape[1]
    positions = (torch.as_tensor(pos, device=tokens.device)[:, None]
                 + torch.arange(s, device=tokens.device)[None, :])
    x = _swap_prefix(x, positions, embed_prefix)
    if valid is None:
        valid = torch.ones(tokens.shape, dtype=torch.bool,
                           device=tokens.device)
    h, caches = forward_hidden(cfg, params, x, positions, caches=caches,
                               enc_out=enc_out, seq_valid=valid,
                               overlay=overlay, plan=plan,
                               drop_free=drop_free)
    return unembed(cfg, params, h), caches
