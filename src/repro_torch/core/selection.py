"""Dynamic layer/channel selection (paper Sec. 2.2, Algorithm 1 lines 1-4).

Layer selection: maximise the number of selected units taken in descending
multi-objective-score order, subject to the memory and compute budgets.
Channel selection: within each selected unit, the top-K channels by Fisher
information Δ_o.

TPU adaptation (see DESIGN.md): when ``shard_channels > 1``, top-K is taken
*per contiguous channel shard* (shard-local top-K), keeping ΔW evenly
TP-sharded and avoiding a Fisher-score all-gather.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .criterion import (
    Budget,
    UnitCost,
    full_backward_macs,
    multi_objective_scores,
    policy_backward_macs,
    policy_memory_bytes,
)
from .policy import SelectedUnit, SparseUpdatePolicy


def round_to_shard(k: int, shard_channels: int, n: int) -> int:
    """Round k to the nearest positive multiple of ``shard_channels`` <= n.

    Keeps shard-local top-K well-defined (equal picks per shard) instead of
    silently falling back to a global top-K whenever k is not already a
    multiple — the fallback would break the even-TP-sharding guarantee the
    shard-local path exists to provide.
    """
    k = int(round(k / shard_channels)) * shard_channels
    return int(min(max(k, shard_channels), n))


def topk_channels(
    delta_o: np.ndarray, k: int, shard_channels: int = 1
) -> np.ndarray:
    """Top-k channel indices by Fisher information, optionally shard-local.

    With ``shard_channels > 1`` and a shardable channel count, k is rounded
    to the nearest shard multiple (see :func:`round_to_shard`) so every
    shard contributes exactly k/shard_channels picks.
    """
    n = delta_o.shape[0]
    k = min(k, n)
    if shard_channels <= 1 or n % shard_channels:
        idx = np.argsort(-delta_o)[:k]
        return np.sort(idx).astype(np.int32)
    if k % shard_channels:
        k = round_to_shard(k, shard_channels, n)
    per = n // shard_channels
    kper = k // shard_channels
    out = []
    for s in range(shard_channels):
        local = delta_o[s * per : (s + 1) * per]
        idx = np.argsort(-local)[:kper] + s * per
        out.append(idx)
    return np.sort(np.concatenate(out)).astype(np.int32)


def select_policy(
    costs: Sequence[UnitCost],
    fisher_potential: np.ndarray,  # per-unit P (Eq. 2 summed over channels)
    fisher_channels: Dict[Tuple[int, str], np.ndarray],  # per-unit Δ_o
    budget: Budget,
    *,
    criterion: str = "tinytrain",
    shard_channels: int = 1,
    min_horizon: int = 0,
) -> SparseUpdatePolicy:
    """Greedy budgeted selection ordered by the multi-objective score."""
    scores = multi_objective_scores(fisher_potential, costs, criterion)
    order = np.argsort(-scores)
    full_bwd = full_backward_macs(costs)

    chosen: List[Tuple[UnitCost, int]] = []
    selection: Dict[Tuple[int, str], int] = {}
    shard_adjustments: Dict[str, Tuple[int, int]] = {}
    for j in order:
        c = costs[int(j)]
        k_raw = max(1, int(round(c.n_channels * budget.channel_ratio)))
        k_options = [k_raw]
        if shard_channels > 1 and c.n_channels % shard_channels == 0:
            # keep K a multiple of the shard count for even TP sharding;
            # fall back to the floored multiple when the nearest one no
            # longer fits the budgets (never lose a unit to rounding up)
            k_near = round_to_shard(k_raw, shard_channels, c.n_channels)
            k_floor = max(shard_channels,
                          (k_raw // shard_channels) * shard_channels)
            k_options = [k_near] if k_near <= k_floor else [k_near, k_floor]
        for k in k_options:
            cand = chosen + [(c, k)]
            cand_sel = dict(selection)
            cand_sel[(c.layer, c.kind)] = k
            horizon = min(u.layer for u, _ in cand)
            horizon = max(horizon, min_horizon)
            mem = policy_memory_bytes(cand, budget)
            macs = policy_backward_macs(costs, cand_sel, horizon)
            if mem > budget.mem_bytes or macs > budget.compute_frac * full_bwd:
                continue  # paper: progressively add while budgets hold
            if k != k_raw:
                shard_adjustments[f"L{c.layer}.{c.kind}"] = (k_raw, k)
            chosen = cand
            selection = cand_sel
            break

    units = []
    for c, k in chosen:
        d = fisher_channels[(c.layer, c.kind)]
        idx = topk_channels(np.asarray(d), k, shard_channels)
        units.append(SelectedUnit(c.layer, c.kind, tuple(int(i) for i in idx)))
    units.sort(key=lambda u: (u.layer, u.kind))
    horizon = min((u.layer for u in units), default=0)
    meta = {
        "criterion": criterion,
        "scores": {f"L{c.layer}.{c.kind}": float(scores[i]) for i, c in enumerate(costs)},
        "mem_bytes": policy_memory_bytes(chosen, budget),
        "backward_macs": policy_backward_macs(costs, selection, horizon),
        "full_backward_macs": full_bwd,
        "budget": {"mem_bytes": budget.mem_bytes, "compute_frac": budget.compute_frac,
                   "channel_ratio": budget.channel_ratio},
    }
    if shard_channels > 1:
        meta["shard_channels"] = shard_channels
        # (requested, used) K per accepted unit whose top-K was rounded to
        # a shard multiple — provenance for the even-TP-sharding adjustment
        meta["shard_k_adjustments"] = {
            key: list(v) for key, v in shard_adjustments.items()
        }
    return SparseUpdatePolicy(horizon=horizon, units=tuple(units), meta=meta)


def static_channel_policy(
    policy: SparseUpdatePolicy,
    costs: Sequence[UnitCost],
    mode: str,
    *,
    rng: Optional[np.random.Generator] = None,
    weight_l2: Optional[Dict[Tuple[int, str], np.ndarray]] = None,
) -> SparseUpdatePolicy:
    """Replace dynamic channel choices with static ones (Fig. 4 ablation).

    mode: random | l2norm — same layers & K, different channel pick.
    """
    rng = rng or np.random.default_rng(0)
    by_key = {(c.layer, c.kind): c for c in costs}
    units = []
    for u in policy.units:
        c = by_key[(u.layer, u.kind)]
        k = u.n_channels
        if mode == "random":
            idx = np.sort(rng.choice(c.n_channels, size=k, replace=False))
        elif mode == "l2norm":
            w = weight_l2[(u.layer, u.kind)]
            idx = np.sort(np.argsort(-np.asarray(w))[:k])
        else:
            raise ValueError(mode)
        units.append(SelectedUnit(u.layer, u.kind, tuple(int(i) for i in idx)))
    return SparseUpdatePolicy(
        horizon=policy.horizon, units=tuple(units),
        meta={**(policy.meta or {}), "channel_mode": mode},
    )
