"""Channel deltas of the dense unit kinds: the port of
``repro.models.overlay``.

A TinyTrain delta edits a few columns or rows of a weight matrix,
``W ⊕ scatter(ΔW, idx)``.  The column math lives here once: the
adaptation forward (``layers.attention_apply`` / ``mlp_apply``) adds the
delta's contribution at the selected columns, and :func:`fold_deltas`
adds the delta into a serving copy of the weights.

Per edited weight, ``mode`` says what the selected channels index:
``"out"`` output columns (``ΔW`` is ``(D, K)``, added at ``W[:, cols]``),
``"in"`` input rows (``ΔW`` is ``(K, D)``, added at ``W[cols, :]``).  An
attention head expands to its ``head_dim`` contiguous columns, an SSD head
to its ``ssm_head_dim``.

The serving engine's per-slot overlay (:func:`slot_params`) gives every
slot its own effective weights ``W ⊕ scatter(ΔW_b, idx_b)`` through the
same scatter-add as :func:`fold_deltas` (:func:`_add_at`), so a slot
serving a user's deltas computes with exactly the weights a folded copy
holds.  The SSD kind (``"ssm"``) folds but has no per-slot overlay yet
(ROADMAP queue 1, item 15.2); the MLA, MoE and cross-attention kinds arrive
with item 9.
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


# kind -> (param sub-dict, ((delta name, mode, channels are heads), ...));
# edits named in a delta pack but absent from it (w_gate of a plain-GELU
# MLP) are skipped
EDITS: Dict[str, Tuple[str, Tuple[Tuple[str, str, bool], ...]]] = {
    "attn": ("attn", (("wq", "out", True), ("wo", "in", True))),
    "mlp": ("mlp", (("w_gate", "out", False), ("w_up", "out", False),
                    ("w_down", "in", False))),
    "ssm": ("ssm", (("w_z", "out", True), ("w_x", "out", True),
                    ("w_out", "in", True))),
}

# kind -> delta_init(cfg, layer_id, n_channels, dtype, device), for kinds
# whose shapes live in their model module (registered there at import)
_DELTA_INITS: Dict[str, Callable[..., Params]] = {}


def set_delta_init(kind: str, fn: Callable[..., Params]) -> None:
    """Attach a zero-delta builder to a unit kind (the model modules call
    this at import, as in the JAX package)."""
    _DELTA_INITS[kind] = fn


def _edits(kind: str):
    try:
        return EDITS[kind]
    except KeyError:
        raise NotImplementedError(
            f"unit kind {kind!r}: only the dense kinds {sorted(EDITS)} are "
            "ported; the others arrive with ROADMAP queue 1, item 9") from None


def _add_at(w: torch.Tensor, dw: torch.Tensor, cols: torch.Tensor,
            mode: str) -> None:
    """``w[b] ⊕= scatter(dw[b], cols[b])`` for every b of the leading axis,
    in place and in ``w``'s dtype: ``"out"`` adds dw (N, D, K) at columns,
    ``"in"`` adds dw (N, K, D) at rows.  The one scatter-add of the fold
    and the per-slot overlay."""
    b = torch.arange(w.shape[0], device=w.device)[:, None]
    dw = dw.to(w.dtype)
    if mode == "out":
        w[b, :, cols] = w[b, :, cols] + dw.transpose(1, 2)
    else:
        w[b, cols, :] = w[b, cols, :] + dw


def delta_init(cfg, layer_id: int, kind: str, n_channels: int,
               dtype: torch.dtype, device) -> Params:
    """Zero delta pack for one selected unit."""
    _edits(kind)
    if kind in _DELTA_INITS:
        return _DELTA_INITS[kind](cfg, layer_id, n_channels, dtype, device)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    d = cfg.d_model
    if kind == "attn":
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
        key, edits = _edits(u.kind)
        sub = out["stacks"][f"g{gi}"][key]
        d = deltas[f"L{u.layer}"][u.kind]
        for name, mode, heads in edits:
            if name not in d:
                continue
            if (gi, key, name) not in copied:
                sub[name] = sub[name].clone()
                copied.add((gi, key, name))
            w = sub[name]
            idx = torch.as_tensor(np.asarray(u.channels, np.int64),
                                  device=w.device)
            hd = cfg.ssm_head_dim if u.kind == "ssm" else cfg.head_dim
            cols = head_cols(idx, hd) if heads else idx
            _add_at(w[j:j + 1], d[name].to(w.device)[None], cols[None], mode)
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
    :func:`fold_deltas` performs.  A zero row gives ``W`` itself."""
    if kind == "ssm":
        raise NotImplementedError(
            "the per-slot delta overlay of SSD heads arrives with ROADMAP "
            "queue 1, item 15.2 (online personalisation of the ssm family)")
    _, edits = _edits(kind)
    out = dict(params)
    idx = idx_stack.long()
    for name, mode, heads in edits:
        if name not in d_stack:
            continue
        w = params[name]
        w_eff = w.expand(idx.shape[0], *w.shape).clone()
        cols = head_cols(idx, cfg.head_dim) if heads else idx
        _add_at(w_eff, d_stack[name], cols, mode)
        out[name] = w_eff
    return out
