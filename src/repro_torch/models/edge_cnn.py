"""Edge CNN backbones, the paper's own model family: the port of
``repro.models.edge_cnn``.

MCUNet / MobileNetV2-0.35 / ProxylessNAS-0.3 style inverted-residual
backbones (the paper's Table 4), matched on depth, width multiplier and
cost envelope; the TinyTrain machinery (Fisher taps, per-layer channel
deltas, backprop horizon) is exact.  A backbone is a flat list of conv
layers (pointwise / depthwise / dense stem and head), each an
independently selectable unit with output-channel granularity; BatchNorm
is folded into the conv bias, as an MCU deployment does.

Layout: PyTorch's NCHW activations and OIHW weights, conv ``(c_out, c_in,
k, k)``, depthwise ``(C, 1, k, k)``; a channel delta is ``(n_sel, c_in, k,
k)``, or ``(n_sel, 1, k, k)`` for a depthwise layer.  Images arrive NHWC
(the episodes' host layout) and are permuted once, at entry.  The
convolutions are ``F.conv2d`` (no Pallas kernel lies on this path in the
JAX package either).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import DeviceLike

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    kind: str  # conv | dw
    c_in: int
    c_out: int
    k: int
    stride: int
    relu: bool
    block: int  # inverted-residual block id (for Fig. 3-style analysis)
    residual_with: int = -1  # layer index whose *input* is added (block res)


@dataclasses.dataclass(frozen=True)
class CnnConfig:
    name: str
    layers: Tuple[ConvSpec, ...]
    in_res: int
    feat_dim: int

    @property
    def n_layers(self) -> int:
        return len(self.layers)


def _c(ch: float, mult: float, div: int = 8) -> int:
    v = max(div, int(ch * mult + div / 2) // div * div)
    return v


def build_ir_net(
    name: str,
    block_specs: Sequence[Tuple[int, int, int, int, int]],  # (t, c, n, s, k)
    width: float,
    stem_c: int,
    head_c: int,
    in_res: int,
) -> CnnConfig:
    """Constructor for inverted-residual edge CNNs.

    ``block_specs`` rows are MobileNetV2-style (expansion t, channels c,
    repeats n, stride s, kernel k)."""
    layers: List[ConvSpec] = []
    c_prev = _c(stem_c, width)
    layers.append(ConvSpec("conv", 3, c_prev, 3, 2, True, 0))
    block = 1
    for (t, c, n, s, k) in block_specs:
        c_out = _c(c, width)
        for i in range(n):
            stride = s if i == 0 else 1
            c_mid = c_prev * t
            start = len(layers)
            res = start if (stride == 1 and c_prev == c_out) else -1
            if t != 1:
                layers.append(ConvSpec("conv", c_prev, c_mid, 1, 1, True, block))
            layers.append(ConvSpec("dw", c_mid, c_mid, k, stride, True, block))
            layers.append(
                ConvSpec("conv", c_mid, c_out, 1, 1, False, block,
                         residual_with=res)
            )
            c_prev = c_out
            block += 1
    feat = _c(head_c, width) if head_c else c_prev
    if head_c:
        layers.append(ConvSpec("conv", c_prev, feat, 1, 1, True, block))
    return CnnConfig(name, tuple(layers), in_res, feat)


def mobilenetv2_035(in_res: int = 84) -> CnnConfig:
    spec = [
        (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 32, 3, 2, 3),
        (6, 64, 4, 2, 3), (6, 96, 3, 1, 3), (6, 160, 3, 2, 3),
        (6, 320, 1, 1, 3),
    ]
    return build_ir_net("mobilenetv2-0.35", spec, 0.35, 32, 1280, in_res)


def mcunet_5fps(in_res: int = 84) -> CnnConfig:
    # MCUNet-style: mixed kernels/expansions, 14 blocks / 42 conv layers
    spec = [
        (1, 16, 1, 1, 3), (4, 24, 2, 2, 7), (5, 40, 3, 2, 3),
        (4, 48, 2, 2, 7), (5, 96, 3, 1, 5), (4, 160, 2, 2, 5),
        (6, 320, 1, 1, 3),
    ]
    return build_ir_net("mcunet-5fps", spec, 0.6, 16, 0, in_res)


def proxylessnas_03(in_res: int = 84) -> CnnConfig:
    spec = [
        (1, 16, 1, 1, 3), (3, 24, 3, 2, 5), (3, 40, 3, 2, 7),
        (6, 80, 4, 2, 7), (3, 96, 3, 1, 5), (6, 192, 4, 2, 5),
        (6, 320, 1, 1, 5),
    ]
    return build_ir_net("proxylessnas-0.3", spec, 0.3, 32, 1280, in_res)


def tiny_cnn(in_res: int = 32) -> CnnConfig:
    """4-block demo backbone of the quickstart and the tests."""
    spec = [
        (1, 8, 1, 1, 3), (4, 16, 2, 2, 3), (4, 24, 2, 2, 3), (4, 32, 1, 1, 3),
    ]
    return build_ir_net("tiny", spec, 1.0, 8, 0, in_res)


# the paper's arch family only; the tiny-cnn demo backbone registers
# separately in the façade
EDGE_CNNS = {
    "mcunet": mcunet_5fps,
    "mobilenetv2": mobilenetv2_035,
    "proxylessnas": proxylessnas_03,
}


# ---------------------------------------------------------------------------
# init / apply
# ---------------------------------------------------------------------------


def cnn_init(cfg: CnnConfig, generator: torch.Generator) -> List[Params]:
    """Random weights from ``generator``, on its device (OIHW)."""
    dev = generator.device
    params = []
    for spec in cfg.layers:
        if spec.kind == "dw":
            shape, fan_in = (spec.c_out, 1, spec.k, spec.k), spec.k * spec.k
        else:
            shape = (spec.c_out, spec.c_in, spec.k, spec.k)
            fan_in = spec.k * spec.k * spec.c_in
        w = torch.randn(shape, generator=generator, device=dev)
        params.append({"w": w * (1.0 / math.sqrt(fan_in)),
                       "b": torch.zeros((spec.c_out,), device=dev)})
    return params


def _conv_pre(x: torch.Tensor, spec: ConvSpec, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """Conv + bias, pre-activation."""
    return F.conv2d(x, w, b, stride=spec.stride, padding=(spec.k - 1) // 2,
                    groups=spec.c_in if spec.kind == "dw" else 1)


def _conv(x: torch.Tensor, spec: ConvSpec, w: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    y = _conv_pre(x, spec, w, b)
    return F.relu6(y) if spec.relu else y


def _conv_delta(x: torch.Tensor, spec: ConvSpec, dw: torch.Tensor,
                idx: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``y[:, idx] += conv(x, ΔW)``, out of place: the thin conv of the
    selected output channels (a depthwise one reads only their inputs).

    A dense delta is a matrix product (a pointwise one over the channels,
    a k x k one over ``F.unfold``'s patches): under ``torch.func.vmap``
    with one ΔW a task (``adapt_many``) a conv becomes one grouped conv
    whose weight gradient sums in another order than a task's own conv,
    while a batched product gives each task the bits of its own."""
    pad = (spec.k - 1) // 2
    if spec.kind == "dw":
        upd = F.conv2d(x.index_select(1, idx), dw, stride=spec.stride,
                       padding=pad, groups=idx.shape[-1])
    elif spec.k == 1 and spec.stride == 1:
        upd = torch.einsum("bchw,nc->bnhw", x, dw[:, :, 0, 0])
    else:
        cols = F.unfold(x, spec.k, padding=pad, stride=spec.stride)
        upd = (dw.flatten(1) @ cols).reshape(y.shape[0], -1, *y.shape[2:])
    return y.index_add(1, idx, upd)


def cnn_delta_init(cfg: CnnConfig, layer: int, n_sel: int,
                   device: DeviceLike = "cpu") -> Params:
    spec = cfg.layers[layer]
    c_in = 1 if spec.kind == "dw" else spec.c_in
    return {"w": torch.zeros((n_sel, c_in, spec.k, spec.k), device=device)}


def _layer_idx(plan, chan_idx, layer: int, device) -> torch.Tensor:
    """A selected layer's output channels: the caller's tensor
    (``chan_idx``, {layer: {"conv": int tensor}}) where given, else the
    plan's static numpy indices."""
    ci = (chan_idx or {}).get(layer)
    if ci is not None:
        return ci["conv"]
    return torch.as_tensor(plan.channel_idx[layer]["conv"].astype(np.int64),
                           device=device)


def cnn_features(
    cfg: CnnConfig,
    params: List[Params],
    images: torch.Tensor,  # (B, H, W, 3)
    *,
    deltas: Optional[Dict[str, Params]] = None,
    plan=None,
    taps: Optional[List[Optional[torch.Tensor]]] = None,
    chan_idx=None,
) -> torch.Tensor:
    """Backbone features (B, feat_dim) with TinyTrain hooks.

    - ``plan``: SparseUpdatePolicy; the layers below ``plan.horizon`` and
      the input run detached, selected layers add their channel deltas
      before the activation (so W ⊕ ΔW is exact).
    - ``taps``: per-layer (B, C_out) Fisher tap scales (probe mode),
      applied after the activation and before the residual add.
    - ``chan_idx``: {layer: {"conv": int tensor}} overriding the plan's
      static channel indices (one step serves many tasks).
    """
    x = images.permute(0, 3, 1, 2)
    selected = set(plan.selected_layers()) if plan is not None else set()
    horizon = plan.horizon if plan is not None else 0
    referenced = {s.residual_with for s in cfg.layers if s.residual_with >= 0}
    block_inputs: Dict[int, torch.Tensor] = {}

    for i, (spec, p) in enumerate(zip(cfg.layers, params)):
        w, b = p["w"], p["b"]
        if i < horizon:
            w, b = w.detach(), b.detach()
            if i == 0:
                x = x.detach()
        if i in referenced:
            block_inputs[i] = x  # block input saved for the residual add
        y = _conv_pre(x, spec, w, b)
        if i in selected and deltas is not None and f"L{i}" in deltas:
            y = _conv_delta(x, spec, deltas[f"L{i}"]["conv"]["w"],
                            _layer_idx(plan, chan_idx, i, x.device), y)
        if spec.relu:
            y = F.relu6(y)
        if taps is not None and taps[i] is not None:
            y = y * taps[i][:, :, None, None]
        if spec.residual_with >= 0:
            y = y + block_inputs[spec.residual_with]
        x = y
    return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# Analytical cost model (params & MACs per layer): Eq. 3 and Table 2
# ---------------------------------------------------------------------------


def cnn_layer_costs(cfg: CnnConfig) -> List[Dict[str, int]]:
    """Per-layer params, forward MACs and activation sizes at cfg.in_res."""
    res = cfg.in_res
    out = []
    for spec in cfg.layers:
        if spec.stride == 2:
            res = (res + 1) // 2
        cin_eff = 1 if spec.kind == "dw" else spec.c_in
        n_params = spec.k * spec.k * cin_eff * spec.c_out + spec.c_out
        macs = spec.k * spec.k * cin_eff * spec.c_out * res * res
        act = res * res * spec.c_out
        out.append({
            "params": int(n_params), "macs": int(macs), "act": int(act),
            "block": spec.block, "kind": spec.kind, "c_out": spec.c_out,
            "res": res,
        })
    return out


def cnn_total_costs(cfg: CnnConfig) -> Tuple[int, int]:
    cs = cnn_layer_costs(cfg)
    return sum(c["params"] for c in cs), sum(c["macs"] for c in cs)


# ---------------------------------------------------------------------------
# Deployment: fold channel deltas into a serving weight copy
# ---------------------------------------------------------------------------


def cnn_fold_deltas(cfg: CnnConfig, params: List[Params],
                    deltas: Dict[str, Params], policy) -> List[Params]:
    """Serving copy with W_eff = W ⊕ scatter(ΔW, idx) folded in (untouched
    tensors are shared).  The delta enters before the activation (see
    :func:`cnn_features`), so a folded conv computes the delta forward's
    pre-activations and an adapted CNN deploys at base cost.  Output
    channels are OIHW's first axis for a conv and a depthwise layer
    alike."""
    out = [dict(p) for p in params]
    for u in policy.units:
        w = out[u.layer]["w"]
        idx = torch.as_tensor(np.asarray(u.channels, np.int64),
                              device=w.device)
        dw = deltas[f"L{u.layer}"][u.kind]["w"]
        out[u.layer]["w"] = w.index_add(0, idx, dw.to(w.dtype))
    return out
