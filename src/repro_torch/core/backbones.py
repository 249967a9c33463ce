"""Backbone adapters: the port of ``repro.core.backbones`` for the dense
and ssm LM families.

A :class:`Backbone` bundles what the sparse-update engine needs from a
model family: unit costs (the Eq. 3 denominators), Fisher tap
construction, tap-gradient -> Fisher reduction, delta initialisation and
the feature/loss closures.  A layer group has a ``mixer`` tap group
(attention or SSD heads) and, where its layers have an MLP, an ``ffn``
group (d_ff neurons); mamba2's layers have none.  The edge-CNN backbone
arrives with its slice; the MoE, hybrid and encoder-decoder LMs with
ROADMAP queue 1, item 9.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import overlay as OV
from ..models import transformer as T
from ..models.api import ArchConfig
from ..utils import DeviceLike
from .criterion import UnitCost
from .policy import SparseUpdatePolicy

Params = Any


@dataclasses.dataclass
class Backbone:
    kind: str  # lm
    cfg: Any
    unit_costs: List[UnitCost]
    # init(generator) -> params on the generator's device
    init: Callable[[torch.Generator], Params]
    features: Callable[..., torch.Tensor]
    loss: Optional[Callable[..., torch.Tensor]]
    # make_taps(batch, device) -> ones-valued taps
    make_taps: Callable[[int, DeviceLike], Any]
    # host-side Eq. 2 from numpy tap gradients -> (potentials, chans)
    fisher_from_grads: Callable[[Any, int], Tuple[np.ndarray, Dict]]
    # init_deltas(policy, device) -> zero delta packs
    init_deltas: Callable[[SparseUpdatePolicy, DeviceLike], Any]
    # device-side Eq. 2: fisher_reduce(tap_grads, n, mask=None) ->
    # {(layer, kind): Δ_o}; ``n`` the valid-sample count, ``mask`` an
    # optional (B,) validity mask so padded rows contribute exactly zero
    fisher_reduce: Callable[..., Dict]

    def cost_by_key(self) -> Dict[Tuple[int, str], UnitCost]:
        return {(c.layer, c.kind): c for c in self.unit_costs}


def _lm_group_kinds(cfg: ArchConfig, gi: int) -> Tuple[str, str, int, int]:
    """(mixer_kind, ffn_kind, mixer_channels, ffn_channels) of group gi;
    ffn_kind "none" (and 0 channels) for layers with no FFN."""
    T.check_supported(cfg)
    lid = T.stack_groups(cfg)[gi][1][0]
    fk = T.ffn_kind(cfg, lid)
    fc = cfg.d_ff if fk == "mlp" else 0
    if T.block_kind(cfg, lid) == "ssm":
        return "ssm", fk, cfg.n_ssm_heads, fc
    return "attn", fk, cfg.n_heads, fc


def lm_backbone(cfg: ArchConfig, tokens_per_batch: int,
                batch_size: int) -> Backbone:
    T.check_supported(cfg)
    dtype = T.torch_dtype(cfg)
    dtype_bytes = torch.finfo(dtype).bits // 8
    costs = [
        UnitCost(layer=d.layer, kind=d.kind, n_channels=d.n_channels,
                 n_params=d.n_params,
                 macs=d.macs_per_token * tokens_per_batch,
                 act_in_bytes=2 * tokens_per_batch * cfg.d_model * dtype_bytes,
                 dx_macs=d.macs_per_token * tokens_per_batch)
        for d in T.unit_descs(cfg)
    ]
    groups = T.stack_groups(cfg)

    def make_taps(n: int, device: DeviceLike):
        taps = {}
        for gi, (_, ids) in enumerate(groups):
            _, fk, mc, fc = _lm_group_kinds(cfg, gi)
            taps[f"g{gi}"] = {
                "mixer": torch.ones((len(ids), n, mc), device=device)}
            if fk != "none":
                taps[f"g{gi}"]["ffn"] = torch.ones((len(ids), n, fc),
                                                   device=device)
        return taps

    def _per_unit(reduce_one, tg) -> Dict[Tuple[int, str], Any]:
        chans: Dict[Tuple[int, str], Any] = {}
        for gi, (_, ids) in enumerate(groups):
            mk, fk, _, _ = _lm_group_kinds(cfg, gi)
            for tap, kind in (("mixer", mk), ("ffn", fk)):
                if kind == "none":
                    continue
                d = reduce_one(tg[f"g{gi}"][tap])  # (L, C)
                for j, lid in enumerate(ids):
                    chans[(lid, kind)] = d[j]
        return chans

    def fisher_from_grads(tg, n: int):
        chans = _per_unit(
            lambda g: np.sum(np.asarray(g, np.float64) ** 2, axis=1)
            / (2.0 * n), tg)
        potentials = np.array(
            [chans[(c.layer, c.kind)].sum() for c in costs], np.float64)
        return potentials, chans

    def fisher_reduce(tg, n, mask=None):
        # every (L, B, C) group goes through the Fisher kernel (its plain
        # version on the CPU): padded rows (mask 0) drop out exactly and
        # the normaliser is the valid count n
        from ..kernels import ops

        return _per_unit(lambda g: ops.fisher_tapgrads(g, n, mask), tg)

    def init_deltas(policy: SparseUpdatePolicy, device: DeviceLike):
        # deltas follow the model dtype (adam's moment math is f32 anyway)
        deltas: Dict[str, Dict[str, Any]] = {}
        for u in policy.units:
            deltas.setdefault(f"L{u.layer}", {})[u.kind] = OV.delta_init(
                cfg, u.layer, u.kind, u.n_channels, dtype, device)
        return deltas

    def features(params, batch, *, deltas=None, plan=None, taps=None,
                 chan_idx=None):
        return T.pooled_features(cfg, params, batch, deltas=deltas,
                                 plan=plan, taps=taps, chan_idx=chan_idx)

    def loss(params, batch, *, deltas=None, plan=None, taps=None,
             chan_idx=None):
        return T.lm_loss(cfg, params, batch, deltas=deltas, plan=plan,
                         taps=taps, chan_idx=chan_idx)

    return Backbone(
        kind="lm", cfg=cfg, unit_costs=costs,
        init=lambda gen: T.init_params(cfg, gen, device=gen.device),
        features=features, loss=loss, make_taps=make_taps,
        fisher_from_grads=fisher_from_grads, init_deltas=init_deltas,
        fisher_reduce=fisher_reduce)
