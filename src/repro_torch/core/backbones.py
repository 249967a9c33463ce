"""Backbone adapters: the port of ``repro.core.backbones`` for the dense
and ssm LM families and the paper's edge CNNs.

A :class:`Backbone` bundles what the sparse-update engine needs from a
model family: unit costs (the Eq. 3 denominators), Fisher tap
construction, tap-gradient -> Fisher reduction, delta initialisation and
the feature/loss closures.  A layer group has a ``mixer`` tap group
(attention or SSD heads) and, where its layers have an MLP, an ``ffn``
group (d_ff neurons); mamba2's layers have none.  An edge CNN's unit is
one conv layer with its output channels, tapped per layer as a (B, C_i)
tensor (the layers' widths differ, so the taps do not stack).  The MoE,
hybrid and encoder-decoder LMs arrive with ROADMAP queue 1, item 9.

``fisher_reduce_batch`` is Eq. 2 with a leading task axis, for a fleet's
probe: an LM's (T, L, B, C) tap-gradient groups go through the Fisher
kernel's task route, one launch a group; an edge CNN's (T, B, C_i) taps
reduce in plain torch.  ``weight_l2`` gives the per-channel weight norms
the ``l2norm`` criterion ranks channels by.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import edge_cnn as E
from ..models import overlay as OV
from ..models import transformer as T
from ..models.api import ArchConfig
from ..utils import DeviceLike
from .criterion import UnitCost
from .policy import SparseUpdatePolicy

Params = Any


@dataclasses.dataclass
class Backbone:
    kind: str  # lm | cnn
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
    # fisher_reduce_batch(tap_grads, ns, mask=None) -> {(layer, kind): (T,
    # C)}: the task-stacked twin, ``ns`` a (T,) float32 tensor of valid
    # counts and ``mask`` (T, B); task t's row is fisher_reduce's of task t
    fisher_reduce_batch: Callable[..., Dict]
    # weight_l2(params) -> {(layer, kind): per-channel L2 norms, float64}
    weight_l2: Callable[[Params], Dict[Tuple[int, str], np.ndarray]]

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

    def _per_unit(reduce_one, tg, tasks: bool = False
                  ) -> Dict[Tuple[int, str], Any]:
        chans: Dict[Tuple[int, str], Any] = {}
        for gi, (_, ids) in enumerate(groups):
            mk, fk, _, _ = _lm_group_kinds(cfg, gi)
            for tap, kind in (("mixer", mk), ("ffn", fk)):
                if kind == "none":
                    continue
                d = reduce_one(tg[f"g{gi}"][tap])  # (L, C) or (T, L, C)
                for j, lid in enumerate(ids):
                    chans[(lid, kind)] = d[:, j] if tasks else d[j]
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

    def fisher_reduce_batch(tg, ns, mask=None):
        # one Fisher launch a (T, L, B, C) group: every task of a fleet's
        # shape group at once, each masked and scaled by its own count
        from ..kernels import ops

        return _per_unit(lambda g: ops.fisher_tapgrads(g, ns, mask), tg,
                         tasks=True)

    def weight_l2(params) -> Dict[Tuple[int, str], np.ndarray]:
        # float64 on the params' device; only the per-channel norms move
        def sq(w, dims, shape=None):
            w = w.detach().double()
            return (w if shape is None else w.reshape(shape)).square().sum(
                dims)

        def host(t):
            return t.sqrt().cpu().numpy()

        out: Dict[Tuple[int, str], np.ndarray] = {}
        for gi, (_, ids) in enumerate(groups):
            st = params["stacks"][f"g{gi}"]
            mk, fk, _, _ = _lm_group_kinds(cfg, gi)
            for j, lid in enumerate(ids):
                if mk == "attn":
                    h, dh = cfg.n_heads, cfg.head_dim
                    nq = sq(st["attn"]["wq"][j], (0, 2), (-1, h, dh))
                    no = sq(st["attn"]["wo"][j], (1, 2), (h, dh, -1))
                    out[(lid, "attn")] = host(nq + no)
                else:
                    h, p = cfg.n_ssm_heads, cfg.ssm_head_dim
                    out[(lid, "ssm")] = host(
                        sq(st["ssm"]["w_x"][j], (0, 2), (-1, h, p)))
                if fk == "mlp":
                    mlp = st["mlp"]
                    out[(lid, "mlp")] = host(sq(mlp["w_up"][j], 0)
                                             + sq(mlp["w_down"][j], 1))
        return out

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
        fisher_reduce=fisher_reduce, fisher_reduce_batch=fisher_reduce_batch,
        weight_l2=weight_l2)


def cnn_backbone(cfg: E.CnnConfig, batch_size: int) -> Backbone:
    """The edge-CNN adapter: one unit a conv layer, with the reference's
    unit costs at ``batch_size`` images of ``cfg.in_res``.  Eq. 2 reduces
    each layer's (B, C_i) tap gradient in plain torch, as the JAX package
    does (no Pallas kernel there)."""
    layer_costs = E.cnn_layer_costs(cfg)
    costs = [
        UnitCost(
            layer=i, kind="conv", n_channels=c["c_out"],
            n_params=c["params"], macs=c["macs"] * batch_size,
            # B4: the input activation map dW needs (exact for a conv)
            act_in_bytes=4 * batch_size * c["act"] * (
                cfg.layers[i].c_in / max(c["c_out"], 1)),
            dx_macs=c["macs"] * batch_size)
        for i, c in enumerate(layer_costs)
    ]

    def make_taps(n: int, device: DeviceLike):
        return [torch.ones((n, spec.c_out), device=device)
                for spec in cfg.layers]

    def fisher_from_grads(tg, n: int):
        chans = {(i, "conv"): np.sum(np.asarray(g, np.float64) ** 2, axis=0)
                 / (2.0 * n) for i, g in enumerate(tg)}
        potentials = np.array([chans[(i, "conv")].sum()
                               for i in range(cfg.n_layers)])
        return potentials, chans

    def init_deltas(policy: SparseUpdatePolicy, device: DeviceLike):
        return {f"L{u.layer}": {"conv": E.cnn_delta_init(
                    cfg, u.layer, u.n_channels, device)}
                for u in policy.units}

    def fisher_reduce(tg, n, mask=None):
        # mask-weighted: padded support rows drop out of Eq. 2 exactly
        w = 1.0 if mask is None else mask.float()[:, None]
        return {(i, "conv"): torch.sum(g.float().square() * w, dim=0)
                / (2.0 * n) for i, g in enumerate(tg)}

    def fisher_reduce_batch(tg, ns, mask=None):
        # the same sums with a leading task axis: tg[i] (T, B, C_i), ns (T,)
        w = 1.0 if mask is None else mask.float()[:, :, None]
        return {(i, "conv"): torch.sum(g.float().square() * w, dim=1)
                / (2.0 * ns[:, None]) for i, g in enumerate(tg)}

    def weight_l2(params) -> Dict[Tuple[int, str], np.ndarray]:
        # per output channel of an OIHW kernel: the sum over I, H and W
        return {(i, "conv"): p["w"].detach().double().square().sum(
                    (1, 2, 3)).sqrt().cpu().numpy()
                for i, p in enumerate(params)}

    def features(params, batch, *, deltas=None, plan=None, taps=None,
                 chan_idx=None):
        return E.cnn_features(cfg, params, batch["images"], deltas=deltas,
                              plan=plan, taps=taps, chan_idx=chan_idx)

    return Backbone(
        kind="cnn", cfg=cfg, unit_costs=costs,
        init=lambda gen: E.cnn_init(cfg, gen),
        features=features, loss=None, make_taps=make_taps,
        fisher_from_grads=fisher_from_grads, init_deltas=init_deltas,
        fisher_reduce=fisher_reduce, fisher_reduce_batch=fisher_reduce_batch,
        weight_l2=weight_l2)
