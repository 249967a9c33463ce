"""TinyTrain's resource-aware multi-objective criterion (Eq. 3) + cost model.

The criterion ranks units by Fisher potential per normalised parameter count
per normalised MAC count.  The cost model mirrors the paper's Appendix A.4
memory accounting: backward-pass memory = (B1) weights-to-update + (B2)
optimizer state + (B3) nonlinearity masks (negligible, ReLU-style) + (B4)
inputs of updated layers; compute = backward MACs (dX over the backprop span
+ dW of the selected channels).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .policy import SelectedUnit, SparseUpdatePolicy


@dataclasses.dataclass(frozen=True)
class UnitCost:
    """Static per-unit cost description supplied by a backbone adapter."""

    layer: int
    kind: str
    n_channels: int
    n_params: int  # full-unit parameter count
    macs: int  # full-unit forward MACs (per probe batch)
    act_in_bytes: int  # bytes of saved inputs needed for this unit's dW (B4)
    dx_macs: int  # MACs to propagate dX *through* this layer once


def multi_objective_scores(
    potentials: np.ndarray,
    costs: Sequence[UnitCost],
    mode: str = "tinytrain",
) -> np.ndarray:
    """Eq. 3 scores (and the paper's Table-3 ablation variants).

    mode: tinytrain | fisher_only | fisher_mem | fisher_compute | l2norm
    (l2norm expects ``potentials`` to carry per-unit weight L2 norms).
    """
    p = np.asarray(potentials, dtype=np.float64)
    w = np.array([c.n_params for c in costs], dtype=np.float64)
    m = np.array([c.macs for c in costs], dtype=np.float64)
    w_n = w / w.max()
    m_n = m / m.max()
    if mode in ("fisher_only", "l2norm"):
        return p
    if mode == "fisher_mem":
        return p / w_n
    if mode == "fisher_compute":
        return p / m_n
    if mode == "tinytrain":
        return p / (w_n * m_n)
    raise ValueError(f"unknown criterion mode: {mode}")


@dataclasses.dataclass
class Budget:
    """Resource budgets for the online stage (Algorithm 1 inputs)."""

    mem_bytes: float  # backward-pass memory budget (B1+B2+B4)
    compute_frac: float  # backward MACs budget as a fraction of full backward
    channel_ratio: float = 0.5  # top-K fraction of channels per selected unit
    opt_slots: int = 2  # optimizer state slots per weight (adam: m, v)
    param_bytes: int = 4


def delta_params_of(cost: UnitCost, k: int) -> int:
    """Parameters of a unit's channel delta when k of n_channels selected."""
    return int(round(cost.n_params * k / max(cost.n_channels, 1)))


def policy_memory_bytes(
    units: Sequence[Tuple[UnitCost, int]],
    budget: Budget,
) -> int:
    """B1 + B2 + B4 bytes for a candidate selection [(unit, k), ...]."""
    total = 0
    for c, k in units:
        dp = delta_params_of(c, k)
        total += dp * budget.param_bytes  # B1 updated weights / grads
        total += dp * budget.param_bytes * budget.opt_slots  # B2 optimizer
        total += c.act_in_bytes  # B4 saved inputs
    return total


def policy_backward_macs(
    all_costs: Sequence[UnitCost],
    selection: Dict[Tuple[int, str], int],
    horizon: int,
) -> int:
    """Backward MACs: dX through every layer >= horizon + dW of selections."""
    total = 0
    for c in all_costs:
        if c.layer >= horizon:
            total += c.dx_macs
        k = selection.get((c.layer, c.kind))
        if k:
            total += int(round(c.macs * k / max(c.n_channels, 1)))
    return total


def full_backward_macs(all_costs: Sequence[UnitCost]) -> int:
    """FullTrain backward MACs: dX + dW everywhere (≈ 2x forward)."""
    return sum(c.dx_macs + c.macs for c in all_costs)
