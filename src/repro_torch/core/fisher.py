"""Fisher information on activations (paper Eq. 2) via tap gradients: the
port of ``repro.core.fisher``.

Per activation channel o, Δ_o = 1/(2N) Σ_n (Σ_d a_nd g_nd)², g = ∂L/∂a.
Each tapped activation is scaled by a ones-valued per-(sample, channel)
tap c; then ∂L/∂c_{n,o} = Σ_d a_nd g_nd, Eq. 2's inner sum, so one
gradient with respect to the taps gives every u_{n,o} with O(B·C) extra
memory.  The probe runs once per target task (Algorithm 1 lines 1-2).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import tree_leaves, tree_map
from .backbones import Backbone


def leaf_taps(taps: Any) -> Any:
    """The taps as per-layer leaves that require grad: every (L, B, C) tap
    becomes a list of L (B, C) tensors, so the gradient of each layer's
    tap is its own tensor (no full-size zero-fill per layer)."""
    return tree_map(lambda t: [x.detach().clone().requires_grad_()
                               for x in t.unbind(0)], taps)


def tap_grads(loss: torch.Tensor, taps: Any) -> Any:
    """∂loss/∂taps for :func:`leaf_taps` leaves ({group: {kind: [L x
    (B, C)]}}), restacked to {group: {kind: (L, B, C)}}."""
    grads = iter(torch.autograd.grad(loss, tree_leaves(taps)))
    return {g: {k: torch.stack([next(grads) for _ in v])
                for k, v in grp.items()}
            for g, grp in taps.items()}


def fisher_probe(
    backbone: Backbone,
    params: Any,
    loss_fn: Callable[..., torch.Tensor],
    batch: Dict[str, torch.Tensor],
    n_samples: int,
) -> Tuple[np.ndarray, Dict, float]:
    """Per-unit Fisher potentials P and per-channel Δ_o on the host.

    ``loss_fn(params, batch, taps=...) -> scalar``.  Returns (potentials
    aligned with ``backbone.unit_costs``, {(layer, kind): Δ_o}, wall
    seconds).  ``n_samples`` is the count of valid (non-padded) samples
    for Eq. 2's 1/(2N); taps are sized to the padded batch."""
    batch_pad = next(iter(batch.values())).shape[0]
    dev = next(iter(batch.values())).device
    taps = leaf_taps(backbone.make_taps(batch_pad, dev))
    t0 = time.perf_counter()
    g = tap_grads(loss_fn(params, batch, taps=taps), taps)
    g = tree_map(lambda x: x.cpu().numpy(), g)
    potentials, chans = backbone.fisher_from_grads(g, n_samples)
    return potentials, chans, time.perf_counter() - t0


def fisher_from_activations(a: torch.Tensor, g: torch.Tensor,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Direct Eq. 2 from materialised activations and gradients, a, g
    (N, D, C) -> Δ (C,), through the Fisher kernel (its plain version on
    the CPU).  ``mask`` is an optional (N,) validity vector: padded rows
    contribute zero and the normaliser is the valid count."""
    from ..kernels import ops

    return ops.fisher_auto(a, g, mask=mask)


def potentials_from_chans(unit_costs, chans: Dict) -> np.ndarray:
    """Per-unit Fisher potential P = Σ_o Δ_o, aligned with ``unit_costs``."""
    return np.array(
        [np.asarray(chans[(c.layer, c.kind)], np.float64).sum()
         for c in unit_costs],
        np.float64,
    )
