"""Baseline on-device training methods (paper Sec. 3.1 / Appendix A.5): the
port of ``repro.core.baselines``.

- None:          no adaptation (the meta-trained backbone as it is).
- FullTrain:     fine-tune the entire backbone.
- LastLayer:     update only the last unit (a policy; see ``session``).
- TinyTL:        lite-residual adapters (Cai et al. 2020), backbone frozen.
- AdapterDrop-X: TinyTL with the first X% of block adapters dropped.
- SparseUpdate:  a static layer/channel policy from an offline evolutionary
                 search on a *proxy* dataset (Lin et al. 2022).  Its policy
                 cannot adapt per task; TinyTrain's can.

The fused loops run on :func:`~.sparse.scan_train_loop` (a fixed number of
guarded steps with no host read).  TinyTL works in NCHW/OIHW: its 2x2
average pool pads odd sizes at the bottom/right and always divides by 4
(``lax.reduce_window`` with "SAME" padding, then / 4), and its nearest
upsampling uses half-pixel centres (``jax.image.resize``'s "nearest"), which
is ``F.interpolate``'s "nearest-exact", not its "nearest".  The adapters
are drawn from a ``torch.Generator``; the tests carry the JAX package's
across through ``bridge``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import edge_cnn as E
from ..optim import Optimizer, apply_updates
from ..utils import DeviceLike
from .criterion import (
    Budget, UnitCost, policy_backward_macs, policy_memory_bytes,
)
from .policy import SelectedUnit, SparseUpdatePolicy
from .protonet import episode_loss
from .sparse import _value_and_grad, scan_train_loop


# ---------------------------------------------------------------------------
# FullTrain
# ---------------------------------------------------------------------------


def make_full_train_step(loss_fn, optimizer: Optimizer):
    """step(params, opt_state, batch) -> (params, opt_state, loss): one
    update of every backbone parameter on a token batch, ``loss_fn(params,
    batch) -> scalar`` (the unbounded-resource baseline), out of place."""

    def step(params, opt_state, batch):
        loss, grads = _value_and_grad(lambda p: loss_fn(p, batch), params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return step


def make_full_episode_step(feature_fn, optimizer: Optimizer, max_way: int):
    """step(params, opt_state, support, query) -> (params, opt_state, loss):
    one update of every backbone parameter, out of place."""
    from .protonet import make_meta_train_step

    return make_meta_train_step(feature_fn, optimizer, max_way)


def make_full_episode_scan(feature_fn, optimizer: Optimizer, max_way: int,
                           iters: int):
    """The FullTrain fine-tune loop as one call: run(params, opt_state,
    support, query) -> (params, opt_state, losses, skipped)."""
    return scan_train_loop(
        lambda p, support, query: episode_loss(feature_fn, p, support, query,
                                               max_way),
        optimizer, iters)


# ---------------------------------------------------------------------------
# Static SparseUpdate (Lin et al. 2022): offline evolutionary search
# ---------------------------------------------------------------------------


def evolutionary_search_policy(
    costs: Sequence[UnitCost],
    contributions: np.ndarray,  # per-unit accuracy-gain proxy on PROXY data
    budget: Budget,
    *,
    iters: int = 500,
    pop: int = 32,
    seed: int = 0,
    channel_ratios: Tuple[float, ...] = (0.125, 0.25, 0.5, 1.0),
) -> SparseUpdatePolicy:
    """Offline ES over (unit subset, per-unit channel ratio).

    Fitness = Σ contribution_i · ratio_i  subject to memory/compute budgets —
    the additive-contribution surrogate used by MCUNetV3's search.  This runs
    *offline on proxy data*; the resulting policy is static at deployment,
    which is precisely the limitation TinyTrain removes.
    """
    rng = np.random.default_rng(seed)
    n = len(costs)
    full_bwd = sum(c.dx_macs + c.macs for c in costs)

    def decode(genome):
        sel = [
            (costs[i], max(1, int(round(costs[i].n_channels * channel_ratios[g]))))
            for i, g in enumerate(genome)
            if g >= 0
        ]
        return sel

    def fitness(genome):
        sel = decode(genome)
        if not sel:
            return -1e9
        horizon = min(c.layer for c, _ in sel)
        mem = policy_memory_bytes(sel, budget)
        macs = policy_backward_macs(
            costs, {(c.layer, c.kind): k for c, k in sel}, horizon
        )
        if mem > budget.mem_bytes or macs > budget.compute_frac * full_bwd:
            return -1e9
        return sum(
            contributions[i] * (k / costs[i].n_channels)
            for i, (c, k) in zip(
                [j for j, g in enumerate(genome) if g >= 0], sel
            )
        )

    # genome: per unit, -1 (off) or ratio index
    popu = [np.full(n, -1, np.int32) for _ in range(pop)]
    for g in popu:
        on = rng.choice(n, size=max(1, n // 8), replace=False)
        g[on] = rng.integers(0, len(channel_ratios), size=len(on))
    fits = [fitness(g) for g in popu]
    for _ in range(iters):
        # tournament + mutate
        a, b = rng.integers(0, pop, 2)
        parent = popu[a] if fits[a] >= fits[b] else popu[b]
        child = parent.copy()
        for _m in range(rng.integers(1, 4)):
            i = rng.integers(0, n)
            child[i] = rng.integers(-1, len(channel_ratios))
        f = fitness(child)
        worst = int(np.argmin(fits))
        if f > fits[worst]:
            popu[worst] = child
            fits[worst] = f
    best = popu[int(np.argmax(fits))]
    sel = decode(best)
    units = []
    for c, k in sel:
        # static: channels by contribution order proxy = first-k (no target
        # data available offline, so channel pick cannot be task-adaptive)
        units.append(SelectedUnit(c.layer, c.kind, tuple(range(k))))
    units.sort(key=lambda u: (u.layer, u.kind))
    horizon = min((u.layer for u in units), default=0)
    return SparseUpdatePolicy(
        horizon=horizon, units=tuple(units),
        meta={"source": "sparse_update_es", "fitness": float(np.max(fits))},
    )


# ---------------------------------------------------------------------------
# TinyTL lite-residual adapters (CNN) + AdapterDrop
# ---------------------------------------------------------------------------


def tinytl_blocks(cfg: E.CnnConfig, reduction: int = 4
                  ) -> List[Tuple[int, int, int, int]]:
    """(block, c_in, hidden, c_out) of each block's lite residual, in block
    order: the block's input and output channels, a hidden width of
    ``max(8, c_out // reduction)``."""
    blocks: Dict[int, Tuple[int, int]] = {}
    for spec in cfg.layers:
        blocks.setdefault(spec.block, (spec.c_in, spec.c_out))
        blocks[spec.block] = (blocks[spec.block][0], spec.c_out)
    return [(b, cin, max(8, cout // reduction), cout)
            for b, (cin, cout) in sorted(blocks.items())]


def tinytl_adapter_init(cfg: E.CnnConfig, generator: torch.Generator,
                        reduction: int = 4,
                        device: Optional[DeviceLike] = None) -> Dict[str, Any]:
    """One lite-residual module per block: a 3x3 conv (``w1``, OIHW (r,
    c_in, 3, 3)) and a pointwise one (``w2``, (c_out, r, 1, 1)), with the
    JAX package's scales (1/sqrt(9 c_in), 1/sqrt(r)), drawn on
    ``generator``'s device and returned on ``device`` (by default the
    same)."""
    gdev = generator.device
    adapters = {}
    for b, cin, r, cout in tinytl_blocks(cfg, reduction):
        w1 = torch.randn((r, cin, 3, 3), generator=generator, device=gdev)
        w2 = torch.randn((cout, r, 1, 1), generator=generator, device=gdev)
        adapters[f"b{b}"] = {
            "w1": (w1 * (1.0 / np.sqrt(9 * cin))).to(device or gdev),
            "w2": (w2 * (1.0 / np.sqrt(r))).to(device or gdev)}
    return adapters


def adapter_dropped_blocks(cfg: E.CnnConfig, name: str) -> int:
    """The leading blocks whose adapters ``name`` drops: none for tinytl,
    the first X % of the blocks for adapterdrop<X> (50 by default)."""
    if not name.startswith("adapterdrop"):
        return 0
    frac = int(name.replace("adapterdrop", "") or "50") / 100
    return int((max(s.block for s in cfg.layers) + 1) * frac)


def _pool_same(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 average pool with "SAME" padding, always / 4: an odd
    edge is padded with zeros at the bottom/right."""
    h, w = x.shape[-2:]
    return F.avg_pool2d(F.pad(x, (0, w % 2, 0, h % 2)), 2, 2)


def tinytl_features(
    cfg: E.CnnConfig,
    params: List[Dict[str, Any]],
    adapters: Dict[str, Any],
    images: torch.Tensor,  # (B, H, W, 3)
    dropped_blocks: int = 0,
) -> torch.Tensor:
    """Frozen backbone + trainable lite residuals (downsample-conv-upsample)
    at the end of every block from ``dropped_blocks`` on."""
    x = images.permute(0, 3, 1, 2)
    referenced = {s.residual_with for s in cfg.layers if s.residual_with >= 0}
    block_inputs: Dict[int, torch.Tensor] = {}
    block_start_act: Dict[int, torch.Tensor] = {}

    for i, (spec, p) in enumerate(zip(cfg.layers, params)):
        if spec.block not in block_start_act:
            block_start_act[spec.block] = x
        if i in referenced:
            block_inputs[i] = x
        y = E._conv(x, spec, p["w"].detach(), p["b"].detach())
        if spec.residual_with >= 0:
            y = y + block_inputs[spec.residual_with]
        nxt_block = cfg.layers[i + 1].block if i + 1 < len(cfg.layers) else -1
        a = adapters.get(f"b{spec.block}")
        if nxt_block != spec.block and a is not None \
                and spec.block >= dropped_blocks:
            h = _pool_same(block_start_act[spec.block])
            h = F.relu6(F.conv2d(h, a["w1"], padding=1))
            h = F.conv2d(h, a["w2"])
            h = F.interpolate(h, size=y.shape[-2:], mode="nearest-exact")
            y = y + h
        x = y
    return x.mean(dim=(2, 3))


def _tinytl_loss(cfg: E.CnnConfig, max_way: int, dropped_blocks: int):
    def loss(adapters, params, support, query):
        return episode_loss(
            lambda a, b: tinytl_features(cfg, params, a, b["images"],
                                         dropped_blocks=dropped_blocks),
            adapters, support, query, max_way)

    return loss


def make_tinytl_episode_step(cfg: E.CnnConfig, optimizer: Optimizer,
                             max_way: int, dropped_blocks: int = 0):
    """step(params, adapters, opt_state, support, query) -> (adapters,
    opt_state, loss): one update of the adapters, the backbone frozen."""
    from ..optim import apply_updates

    f = _tinytl_loss(cfg, max_way, dropped_blocks)

    def step(params, adapters, opt_state, support, query):
        loss, grads = _value_and_grad(f, adapters, params, support, query)
        updates, opt_state = optimizer.update(grads, opt_state, adapters)
        return apply_updates(adapters, updates), opt_state, loss

    return step


def make_tinytl_episode_scan(cfg: E.CnnConfig, optimizer: Optimizer,
                             max_way: int, dropped_blocks: int, iters: int):
    """The TinyTL fine-tune loop as one call: run(params, adapters,
    opt_state, support, query) -> (adapters, opt_state, losses, skipped)."""
    loop = scan_train_loop(_tinytl_loss(cfg, max_way, dropped_blocks),
                           optimizer, iters)

    def run(params, adapters, opt_state, support, query):
        return loop(adapters, opt_state, params, support, query)

    return run
