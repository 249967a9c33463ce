"""Static sparse-update policy — the output of TinyTrain's selection step.

A policy is computed **once per target task** (paper Sec. 2.2: the
dynamic layer/channel selection runs a single time on-device), then baked
into a re-jitted train step.  Channel indices are *static numpy arrays* so
gathers/scatters lower with constant indices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SelectedUnit:
    layer: int
    kind: str  # mlp | attn | moe | ssm | conv
    channels: Tuple[int, ...]  # selected channel indices (sorted)

    @property
    def n_channels(self) -> int:
        return len(self.channels)


@dataclasses.dataclass
class SparseUpdatePolicy:
    """Which layers/channels receive weight updates.

    Attributes:
      horizon: earliest layer index with any backprop.  Layers below run
        forward-only under ``stop_gradient`` (paper's B3/B4 memory savings).
      units: the selected (layer, kind, channels) units.
      meta: free-form record of how the policy was derived (scores, budgets)
        for EXPERIMENTS.md provenance.
    """

    horizon: int
    units: Tuple[SelectedUnit, ...]
    meta: Optional[dict] = None

    def __post_init__(self):
        self.channel_idx: Dict[int, Dict[str, np.ndarray]] = {}
        for u in self.units:
            self.channel_idx.setdefault(u.layer, {})[u.kind] = np.asarray(
                u.channels, dtype=np.int32
            )

    def selected_layers(self) -> List[int]:
        return sorted({u.layer for u in self.units})

    def unit_map(self) -> Dict[Tuple[int, str], SelectedUnit]:
        return {(u.layer, u.kind): u for u in self.units}

    @property
    def n_units(self) -> int:
        return len(self.units)

    def describe(self) -> str:
        per = ", ".join(
            f"L{u.layer}.{u.kind}[{u.n_channels}ch]" for u in self.units
        )
        return f"horizon={self.horizon} units=({per})"


def full_policy(unit_list: Sequence, n_layers: int) -> SparseUpdatePolicy:
    """FullTrain-equivalent policy: every unit, every channel, horizon 0."""
    units = tuple(
        SelectedUnit(u.layer, u.kind, tuple(range(u.n_channels)))
        for u in unit_list
    )
    return SparseUpdatePolicy(horizon=0, units=units, meta={"source": "full"})


def last_layer_policy(unit_list: Sequence, n_layers: int) -> SparseUpdatePolicy:
    """LastLayer baseline: only the final unit, all channels."""
    last = max(unit_list, key=lambda u: (u.layer, u.kind))
    return SparseUpdatePolicy(
        horizon=last.layer,
        units=(SelectedUnit(last.layer, last.kind, tuple(range(last.n_channels))),),
        meta={"source": "last_layer"},
    )
