"""Channel deltas of every LM unit kind the port runs: the port of
``repro.models.overlay``.

A TinyTrain delta edits a few columns or rows of a weight matrix,
``W ⊕ scatter(ΔW, idx)``.  The column math lives here once: the
adaptation forward (``layers.attention_apply`` / ``mla_apply`` /
``mlp_apply`` / ``moe_apply``) adds the delta's contribution at the
selected columns, and :func:`fold_deltas` adds the delta into a serving
copy of the weights.

Per edited weight, ``mode`` says what the selected channels index:
``"out"`` output columns (``ΔW`` is ``(D, K)``, added at ``W[:, cols]``),
``"in"`` input rows (``ΔW`` is ``(K, D)``, added at ``W[cols, :]``),
``"lead"`` the leading axis (MoE experts: ``ΔW`` is ``(K, D, F)``, added
at ``W[idx]``).  A head expands to its contiguous columns: ``head_dim``
for attention, ``qk_nope + qk_rope`` (``w_uq``) and ``v_head_dim``
(``wo``) for MLA, ``ssm_head_dim`` for an SSD head.  A policy names MLA's
heads ``"attn"``; :func:`resolve_kind` maps them to ``"mla"`` on an MLA
config, as the JAX package does.

The serving engine's per-slot overlay (:func:`slot_params`) gives every
slot its own effective weights ``W ⊕ scatter(ΔW_b, idx_b)`` through the
same scatter-add as :func:`fold_deltas` (:func:`_add_at`), so a slot
serving a user's deltas computes with exactly the weights a folded copy
holds; a MoE unit's overlay is the slot's whole expert stack ``(B, E, D,
F)``, an SSD unit's the slot's ``w_z``/``w_x`` columns and ``w_out`` rows
by SSD head, which ``ssm.ssd_apply`` takes through ``layers.bmm``.  The
encoder-decoder family's cross-attention heads (``xattn``) take
attention's edit tuple on the layer's ``xattn`` weights, in the fold and
the per-slot overlay alike.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

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


def _head_dim(cfg) -> int:
    return cfg.head_dim


def _qk_dim(cfg) -> int:
    return cfg.qk_nope_dim + cfg.qk_rope_dim


def _v_dim(cfg) -> int:
    return cfg.v_head_dim


def _ssm_dim(cfg) -> int:
    return cfg.ssm_head_dim


# kind -> (param sub-dict, ((delta name, mode, head width or None), ...)):
# the head width expands a channel to its columns (None: a channel is one
# column, row or expert); edits named in a delta pack but absent from it
# (w_gate of a plain-GELU MLP) are skipped
EDITS: Dict[str, Tuple[str, Tuple[Tuple[str, str, Any], ...]]] = {
    "attn": ("attn", (("wq", "out", _head_dim), ("wo", "in", _head_dim))),
    "xattn": ("xattn", (("wq", "out", _head_dim), ("wo", "in", _head_dim))),
    "mla": ("attn", (("w_uq", "out", _qk_dim), ("wo", "in", _v_dim))),
    "mlp": ("mlp", (("w_gate", "out", None), ("w_up", "out", None),
                    ("w_down", "in", None))),
    "moe": ("moe", (("w_gate", "lead", None), ("w_up", "lead", None),
                    ("w_down", "lead", None))),
    "ssm": ("ssm", (("w_z", "out", _ssm_dim), ("w_x", "out", _ssm_dim),
                    ("w_out", "in", _ssm_dim))),
}


def resolve_kind(cfg, kind: str) -> str:
    """A policy's unit kind -> its edits' key: attention heads are MLA's
    on an MLA config."""
    if kind == "attn" and getattr(cfg, "mla", False):
        return "mla"
    return kind


def _cols(cfg, width, idx: torch.Tensor) -> torch.Tensor:
    return idx if width is None else head_cols(idx, width(cfg))


# kind -> delta_init(cfg, layer_id, n_channels, dtype, device), for kinds
# whose shapes live in their model module (registered there at import)
_DELTA_INITS: Dict[str, Callable[..., Params]] = {}


def set_delta_init(kind: str, fn: Callable[..., Params]) -> None:
    """Attach a zero-delta builder to a unit kind (the model modules call
    this at import, as in the JAX package)."""
    _DELTA_INITS[kind] = fn


def _edits(cfg, kind: str):
    try:
        return EDITS[resolve_kind(cfg, kind)]
    except KeyError:
        raise ValueError(
            f"no unit kind {kind!r} (known: {sorted(EDITS)})") from None


def _add_at(w: torch.Tensor, dw: torch.Tensor, cols: torch.Tensor,
            mode: str) -> None:
    """``w[b] ⊕= scatter(dw[b], cols[b])`` for every b of the leading axis,
    in place and in ``w``'s dtype: ``"out"`` adds dw (N, D, K) at columns,
    ``"in"`` adds dw (N, K, D) at rows and ``"lead"`` dw (N, K, ...) at
    the second axis (the experts).  The one scatter-add of the fold and
    the per-slot overlay."""
    b = torch.arange(w.shape[0], device=w.device)[:, None]
    dw = dw.to(w.dtype)
    if mode == "out":
        w[b, :, cols] = w[b, :, cols] + dw.transpose(1, 2)
    else:
        w[b, cols, :] = w[b, cols, :] + dw


def delta_init(cfg, layer_id: int, kind: str, n_channels: int,
               dtype: torch.dtype, device) -> Params:
    """Zero delta pack for one selected unit."""
    _edits(cfg, kind)
    kind = resolve_kind(cfg, kind)
    if kind in _DELTA_INITS:
        return _DELTA_INITS[kind](cfg, layer_id, n_channels, dtype, device)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    d = cfg.d_model
    if kind in ("attn", "xattn"):  # cross-attention: attention's shapes
        k = n_channels * cfg.head_dim
        return {"wq": z(d, k), "wo": z(k, d)}
    if cfg.act in ("swiglu", "geglu"):
        return {"w_gate": z(d, n_channels), "w_up": z(d, n_channels),
                "w_down": z(n_channels, d)}
    return {"w_up": z(d, n_channels), "w_down": z(n_channels, d)}


def fold_deltas(cfg, params: Any, deltas: Any, policy) -> Any:
    """A serving copy with ``W += scatter(ΔW, idx)`` for every policy unit.

    The returned tree shares every untouched tensor with ``params``; each
    edited stacked weight is copied once and then updated in place, in the
    weight's dtype (the delta is cast first, as in the JAX package)."""
    from .transformer import stack_groups  # late: transformer imports here

    where = {lid: (gi, j) for gi, (_, ids) in enumerate(stack_groups(cfg))
             for j, lid in enumerate(ids)}
    out = dict(params)
    out["stacks"] = {g: {k: dict(v) for k, v in s.items()}
                     for g, s in params["stacks"].items()}
    copied = set()
    for u in policy.units:
        gi, j = where[u.layer]
        key, edits = _edits(cfg, u.kind)
        sub = out["stacks"][f"g{gi}"][key]
        d = deltas[f"L{u.layer}"][u.kind]
        for name, mode, width in edits:
            if name not in d:
                continue
            if (gi, key, name) not in copied:
                sub[name] = sub[name].clone()
                copied.add((gi, key, name))
            w = sub[name]
            idx = torch.as_tensor(np.asarray(u.channels, np.int64),
                                  device=w.device)
            _add_at(w[j:j + 1], d[name].to(w.device)[None],
                    _cols(cfg, width, idx)[None], mode)
    return out


def slot_params(cfg, kind: str, params: Params, d_stack: Params,
                idx_stack: torch.Tensor) -> Params:
    """Per-slot effective weights for one layer (the serving overlay; the
    port of ``UnitOverlay.slot_weights`` behind ``slot_params``).

    ``params`` is the layer's parameter dict for the unit's kind (no stack
    axis), ``d_stack`` the slot-stacked delta pack ((B, ...) leaves) and
    ``idx_stack`` the slot-stacked channel indices (B, K).  Returns a copy
    of ``params`` in which every edited weight gains a leading slot axis:
    ``W_eff[b] = W ⊕ scatter(ΔW_b, cols(idx_b))``, the scatter-add
    :func:`fold_deltas` performs.  A zero row gives ``W`` itself.  ``kind``
    is the policy's (``"attn"`` resolves to MLA's edits on an MLA
    config)."""
    _, edits = _edits(cfg, kind)
    out = dict(params)
    idx = idx_stack.long()
    for name, mode, width in edits:
        if name not in d_stack:
            continue
        w = params[name]
        w_eff = w.expand(idx.shape[0], *w.shape).clone()
        _add_at(w_eff, d_stack[name], _cols(cfg, width, idx), mode)
        out[name] = w_eff
    return out
