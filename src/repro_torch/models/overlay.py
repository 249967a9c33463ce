"""The unit-kind overlay registry: the port of ``repro.models.overlay``.

A TinyTrain delta edits a few columns or rows of a weight matrix,
``W ⊕ scatter(ΔW, idx)``.  Each unit kind declares that edit once, as a
:class:`UnitOverlay` of :class:`Edit` s, and every consumer derives from
it: :func:`fold_deltas` adds the deltas into a serving copy of the
weights (``UnitOverlay.fold``), the serving engine's per-slot overlay
(:func:`slot_params`) gives every slot its own effective weights
``W ⊕ scatter(ΔW_b, idx_b)`` (``UnitOverlay.slot_weights``), through the
same scatter-add (:func:`_add_at`), so a slot serving a user's deltas
computes with exactly the weights a folded copy holds; :func:`unit_cols`
gives the channel -> column expansion, and :func:`delta_init` the zero
delta pack (attached by the model modules at import, where the shapes
live).

Per edited weight, ``mode`` says what the selected channels index:
``"out"`` output columns (``ΔW`` is ``(D, K)``, added at ``W[:, cols]``),
``"in"`` input rows (``ΔW`` is ``(K, D)``, added at ``W[cols, :]``),
``"lead"`` the leading axis (MoE experts: ``ΔW`` is ``(K, D, F)``, added
at ``W[idx]``).  A head expands to its contiguous columns: ``head_dim``
for attention, ``qk_nope + qk_rope`` (``w_uq``) and ``v_head_dim``
(``wo``) for MLA, ``ssm_head_dim`` for an SSD head.  A policy names MLA's
heads ``"attn"``; :func:`resolve_kind` maps them to ``"mla"`` on an MLA
config, as the JAX package does.  The encoder-decoder family's
cross-attention heads (``xattn``) take attention's edits on the layer's
``xattn`` weights.

New unit kinds plug in with one :func:`register_unit_overlay` call (a
spec registered under a built-in kind's name replaces it); the legacy
:func:`register_unit_folder` decorator takes a raw fold function for
folders that do not fit the declarative shape, which fold offline but
cannot be served per slot.  The per-slot forward
(``models.transformer``) applies the kinds it names at each layer
(``transformer.overlay_kinds``), taking each spec's ``param_key``
weights; the serving engine refuses any other kind under
``personalise=``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


def head_cols(idx: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Head indices -> flat column indices: head h -> its ``head_dim``
    contiguous columns.  Leading axes of ``idx`` (a slot axis) are kept."""
    cols = (idx[..., :, None] * head_dim
            + torch.arange(head_dim, device=idx.device))
    return cols.reshape(*idx.shape[:-1], -1)


def delta_out_cols(y: torch.Tensor, x: torch.Tensor, dw: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """``y[..., idx] += x @ dw``, out of place (dw: (D, K))."""
    return y.index_add(-1, idx, x @ dw.to(x.dtype))


def delta_in_rows(y: torch.Tensor, h: torch.Tensor, dw: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """``y += h[..., idx] @ dw`` (dw: (K, D))."""
    return y + h.index_select(-1, idx) @ dw.to(h.dtype)


# ---------------------------------------------------------------------------
# Declarative per-kind specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Edit:
    """One edited weight matrix of a unit kind."""

    delta_name: str  # key in the unit's delta pack
    param_name: str  # key in the stack's parameter dict
    mode: str  # out | in | lead
    # channel indices -> weight columns (None: channels index directly)
    cols: Optional[Callable[[Any, torch.Tensor], torch.Tensor]] = None
    optional: bool = False  # skip silently when absent from the delta pack

    def col_idx(self, cfg, idx: torch.Tensor) -> torch.Tensor:
        return idx if self.cols is None else self.cols(cfg, idx)


def _add_at(w: torch.Tensor, dw: torch.Tensor, cols: torch.Tensor,
            mode: str) -> None:
    """``w[b] ⊕= scatter(dw[b], cols[b])`` for every b of the leading axis,
    in place and in ``w``'s dtype: ``"out"`` adds dw (N, D, K) at columns,
    ``"in"`` adds dw (N, K, D) at rows and ``"lead"`` dw (N, K, ...) at
    the second axis (the experts).  The one scatter-add of the fold and
    the per-slot overlay."""
    if mode not in ("out", "in", "lead"):
        raise ValueError(f"unknown edit mode {mode!r}")
    b = torch.arange(w.shape[0], device=w.device)[:, None]
    dw = dw.to(w.dtype)
    if mode == "out":
        w[b, :, cols] = w[b, :, cols] + dw.transpose(1, 2)
    else:
        w[b, cols, :] = w[b, cols, :] + dw


@dataclasses.dataclass(frozen=True)
class UnitOverlay:
    """Fold + per-slot overlay of one unit kind, derived from its edits."""

    kind: str
    param_key: str  # key of the parameter sub-dict inside a stack group
    edits: Tuple[Edit, ...]
    # zero delta pack: delta_init(cfg, layer_id, n_channels, dtype, device);
    # attached by the model modules at import (the shapes live there)
    delta_init: Optional[Callable[..., Params]] = None

    def fold(self, cfg, stack: Params, j: int, d: Params, idx) -> None:
        """Add unit ``d`` (channels ``idx``, numpy or a tensor) into layer
        ``j`` of a stack group, in place in the group's tensors:
        :func:`fold_deltas` hands it the copies it may write."""
        sub = stack[self.param_key]
        for e in self.edits:
            if e.optional and e.delta_name not in d:
                continue
            w = sub[e.param_name]
            i = torch.as_tensor(np.asarray(idx, np.int64)
                                if not torch.is_tensor(idx) else idx,
                                device=w.device).long()
            _add_at(w[j:j + 1], d[e.delta_name].to(w.device)[None],
                    e.col_idx(cfg, i)[None], e.mode)

    def slot_weights(self, cfg, params: Params, d_stack: Params,
                     idx_stack: torch.Tensor) -> Params:
        """Per-slot effective weights for one layer's parameter dict.

        ``params`` is the layer's dict (no stack axis), ``d_stack`` the
        slot-stacked delta pack ((B, ...) leaves) and ``idx_stack`` the
        slot-stacked channel indices (B, K).  Returns a copy of ``params``
        in which every edited weight gains a leading slot axis: ``W_eff[b]
        = W ⊕ scatter(ΔW_b, cols(idx_b))``, the scatter-add :meth:`fold`
        performs.  A zero row gives ``W`` itself."""
        out = dict(params)
        idx = idx_stack.long()
        for e in self.edits:
            if e.optional and e.delta_name not in d_stack:
                continue
            w = params[e.param_name]
            w_eff = w.expand(idx.shape[0], *w.shape).clone()
            _add_at(w_eff, d_stack[e.delta_name], e.col_idx(cfg, idx), e.mode)
            out[e.param_name] = w_eff
        return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_UNIT_OVERLAYS: Dict[str, Any] = {}


def register_unit_overlay(spec: UnitOverlay) -> UnitOverlay:
    """Register (or replace) the declarative spec of ``spec.kind``."""
    _UNIT_OVERLAYS[spec.kind] = spec
    return spec


def register_unit_folder(kind: str):
    """Register ``fn(cfg, stack, j, d, idx)`` as the folder for a unit kind.

    The escape hatch for folders that do not fit the declarative
    :class:`Edit` shape: the kind folds offline but has no per-slot
    overlay (the serving engine refuses it under ``personalise=``).
    :func:`fold_deltas` passes the stack group with its sub-dicts copied
    and ``idx`` as an int32 numpy array; the folder assigns new tensors
    into those dicts rather than write into the ones it finds there."""

    def deco(fn):
        _UNIT_OVERLAYS[kind] = fn
        return fn

    return deco


def get_overlay(kind: str):
    """The registered spec (or raw folder) of a registry key."""
    try:
        return _UNIT_OVERLAYS[kind]
    except KeyError:
        raise ValueError(
            f"no unit folder registered for kind {kind!r} "
            f"(known: {sorted(_UNIT_OVERLAYS)})") from None


def resolve_kind(cfg, kind: str) -> str:
    """A policy's unit kind -> its registry key: attention heads are MLA's
    on an MLA config."""
    if kind == "attn" and getattr(cfg, "mla", False):
        return "mla"
    return kind


def unit_cols(cfg, kind: str, param_name: str):
    """The channel -> column expansion of one edited weight:
    ``unit_cols(cfg, 'attn', 'wq')(idx)``."""
    spec = get_overlay(resolve_kind(cfg, kind))
    for e in spec.edits:
        if e.param_name == param_name:
            return lambda idx: e.col_idx(cfg, idx)
    raise ValueError(
        f"kind {kind!r} has no edit for weight {param_name!r} "
        f"(edits: {[e.param_name for e in spec.edits]})")


def set_delta_init(kind: str, fn: Callable[..., Params]) -> None:
    """Attach ``delta_init(cfg, layer_id, n_channels, dtype, device)`` to a
    registered kind (the model modules call this at import, as in the JAX
    package)."""
    _UNIT_OVERLAYS[kind] = dataclasses.replace(_UNIT_OVERLAYS[kind],
                                               delta_init=fn)


def delta_init(cfg, layer_id: int, kind: str, n_channels: int,
               dtype: torch.dtype, device) -> Params:
    """Zero delta pack for one selected unit, via the registry."""
    spec = get_overlay(resolve_kind(cfg, kind))
    if getattr(spec, "delta_init", None) is None:
        raise ValueError(f"kind {kind!r} registered without a delta_init")
    return spec.delta_init(cfg, layer_id, n_channels, dtype, device)


# ---------------------------------------------------------------------------
# Built-in unit kinds.  The column math appears here once; the fold, the
# per-slot overlay and the adaptation forward read it from the registry.
# ---------------------------------------------------------------------------

_ATTN_EDITS = (
    Edit("wq", "wq", "out", lambda cfg, idx: head_cols(idx, cfg.head_dim)),
    Edit("wo", "wo", "in", lambda cfg, idx: head_cols(idx, cfg.head_dim)),
)

register_unit_overlay(UnitOverlay("mlp", "mlp", (
    Edit("w_gate", "w_gate", "out", optional=True),
    Edit("w_up", "w_up", "out"),
    Edit("w_down", "w_down", "in"),
)))
register_unit_overlay(UnitOverlay("attn", "attn", _ATTN_EDITS))
register_unit_overlay(UnitOverlay("xattn", "xattn", _ATTN_EDITS))
register_unit_overlay(UnitOverlay("mla", "attn", (
    Edit("w_uq", "w_uq", "out",
         lambda cfg, idx: head_cols(idx, cfg.qk_nope_dim + cfg.qk_rope_dim)),
    Edit("wo", "wo", "in", lambda cfg, idx: head_cols(idx, cfg.v_head_dim)),
)))
register_unit_overlay(UnitOverlay("ssm", "ssm", (
    Edit("w_z", "w_z", "out",
         lambda cfg, idx: head_cols(idx, cfg.ssm_head_dim)),
    Edit("w_x", "w_x", "out",
         lambda cfg, idx: head_cols(idx, cfg.ssm_head_dim)),
    Edit("w_out", "w_out", "in",
         lambda cfg, idx: head_cols(idx, cfg.ssm_head_dim)),
)))
register_unit_overlay(UnitOverlay("moe", "moe", (
    Edit("w_gate", "w_gate", "lead"),
    Edit("w_up", "w_up", "lead"),
    Edit("w_down", "w_down", "lead"),
)))


# ---------------------------------------------------------------------------
# Fold (a serving copy) and the per-slot overlay
# ---------------------------------------------------------------------------


def fold_deltas(cfg, params: Any, deltas: Any, policy) -> Any:
    """A serving copy with ``W += scatter(ΔW, idx)`` for every policy unit.

    The returned tree shares every untouched tensor with ``params``; each
    weight a spec edits is copied once and then updated in place, in the
    weight's dtype (the delta is cast first, as in the JAX package).  A
    raw folder (:func:`register_unit_folder`) gets the stack group with its
    sub-dicts copied, so the caller's ``params`` are never touched."""
    from .transformer import stack_groups  # late: transformer imports here

    where = {lid: (gi, j) for gi, (_, ids) in enumerate(stack_groups(cfg))
             for j, lid in enumerate(ids)}
    out = dict(params)
    out["stacks"] = {g: {k: dict(v) for k, v in s.items()}
                     for g, s in params["stacks"].items()}
    copied = set()
    for u in policy.units:
        gi, j = where[u.layer]
        stack = out["stacks"][f"g{gi}"]
        d = deltas[f"L{u.layer}"][u.kind]
        idx = np.asarray(u.channels, np.int32)
        spec = get_overlay(resolve_kind(cfg, u.kind))
        if not isinstance(spec, UnitOverlay):
            spec(cfg, stack, j, d, idx)
            continue
        sub = stack[spec.param_key]
        for e in spec.edits:
            key = (gi, spec.param_key, e.param_name)
            if e.delta_name in d and key not in copied:
                sub[e.param_name] = sub[e.param_name].clone()
                copied.add(key)
        spec.fold(cfg, stack, j, d, idx)
    return out


def slot_params(cfg, kind: str, params: Params, d_stack: Params,
                idx_stack: torch.Tensor) -> Params:
    """Per-slot effective weights for one layer (the serving overlay):
    :meth:`UnitOverlay.slot_weights` of the policy kind's spec (``"attn"``
    resolves to MLA's on an MLA config).  Raises for a kind registered
    through :func:`register_unit_folder`: it folds offline but cannot
    overlay per slot."""
    spec = get_overlay(resolve_kind(cfg, kind))
    if not isinstance(spec, UnitOverlay):
        raise ValueError(
            f"kind {kind!r} has no per-slot overlay (registered via the "
            "legacy register_unit_folder; use register_unit_overlay to "
            "serve it per slot)")
    return spec.slot_weights(cfg, params, d_stack, idx_stack)
