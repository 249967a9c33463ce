"""Algorithm 1, the TinyTrain online stage, end to end: the port of
``repro.core.adapt``.

Given a backbone, a task's support set and the device budgets: (1) one
gradient probe on the support set; (2) Fisher potential per unit; (3)
multi-objective scores; (4) budgeted layer selection and top-K channel
selection; (5) sparse fine-tuning of the selected deltas.

The online stage stays on the device: the probe reduces Eq. 2 there and
ships only the per-channel scores, and the fine-tune loop writes its losses
on the device and transfers them once at the end, so a fused
``adapt_task`` performs exactly two blocking host transfers (probe scores,
final losses).  ``fused=False`` keeps the eager loop, one transfer per
iteration.

Every device->host read on the adaptation and serving paths goes through
:func:`_fetch`/:func:`_fetch_scalar`, so tests, the serving engine's
``last_run_report["host_syncs"]`` and ``Adaptation.host_transfers`` count
the transfers instead of trusting them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..optim import Optimizer
from ..utils import tree_map
from .backbones import Backbone
from .criterion import Budget
from .fisher import fisher_probe, potentials_from_chans
from .policy import SparseUpdatePolicy
from .protonet import episode_accuracy, episode_loss
from .selection import select_policy
from .sparse import make_episode_sparse_scan, make_episode_sparse_step

_HOST_SYNCS = [0]


def host_sync_count() -> int:
    """Blocking device->host transfer events since the last reset."""
    return _HOST_SYNCS[0]


def reset_host_sync_count() -> None:
    _HOST_SYNCS[0] = 0


def _fetch(tree: Any) -> Any:
    """Materialise a tree of tensors on the host as numpy arrays: one
    blocking transfer event."""
    _HOST_SYNCS[0] += 1
    return tree_map(
        lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else x, tree)


def _fetch_scalar(x: torch.Tensor) -> float:
    _HOST_SYNCS[0] += 1
    return float(x)


@dataclasses.dataclass
class AdaptResult:
    deltas: Any
    policy: SparseUpdatePolicy
    fisher_seconds: float
    train_seconds: float
    losses: list
    # blocking device->host transfer events attributable to this task
    host_transfers: float = 0.0
    # fine-tune steps skipped by the non-finite guard (carry passthrough)
    skipped_steps: int = 0

    @property
    def steps_per_sec(self) -> float:
        n = len(self.losses or ())
        return n / self.train_seconds if self.train_seconds > 0 else 0.0


def _n_valid(support: Dict[str, Any], n_support: Optional[int]) -> int:
    if n_support is not None:
        return int(n_support)
    return int(np.sum(np.asarray(_fetch(support["episode_labels"])) >= 0))


def _probe_and_select(
    backbone: Backbone,
    params: Any,
    support: Dict[str, torch.Tensor],
    pseudo_query: Dict[str, torch.Tensor],
    budget: Budget,
    *,
    criterion: str,
    shard_channels: int,
    step_cache,
    max_way: int,
    n_support: Optional[int] = None,
) -> Tuple[SparseUpdatePolicy, float, int]:
    """Algorithm 1 lines 1-4: Fisher probe -> budgeted policy.

    Through a step cache the probe's tap gradients are reduced on the
    device (the Fisher kernel) and only the per-channel scores are
    fetched; without one they are fetched and reduced on the host.
    Either way the probe is one transfer.  ``n_support``
    is the valid-row count of the support set when the caller knows it on
    the host (``Task`` does); otherwise it costs one more transfer.
    Returns (policy, fisher_seconds, host_transfers)."""
    n = _n_valid(support, n_support)
    labels = support["episode_labels"]
    t0 = time.perf_counter()
    if step_cache is not None:
        taps = backbone.make_taps(labels.shape[0], labels.device)
        chans = _fetch(step_cache.probe_fisher()(
            params, support, pseudo_query, taps, float(n)))
        potentials = potentials_from_chans(backbone.unit_costs, chans)
    else:
        # the host reduction of the tap gradients (``fisher_from_grads``),
        # as the JAX package's uncached route computes it: one fetch
        def probe_loss(p, batch, taps=None):
            return episode_loss(backbone.features, p, support, pseudo_query,
                                max_way, taps=taps)

        potentials, chans, _ = fisher_probe(backbone, params, probe_loss,
                                            support, n)
        _HOST_SYNCS[0] += 1
    fisher_dt = time.perf_counter() - t0
    policy = select_policy(backbone.unit_costs, potentials, chans, budget,
                           criterion=criterion,
                           shard_channels=shard_channels)
    return policy, fisher_dt, 1 + (n_support is None)


def adapt_task(
    backbone: Backbone,
    params: Any,
    support: Dict[str, torch.Tensor],
    pseudo_query: Dict[str, torch.Tensor],
    budget: Budget,
    optimizer: Optimizer,
    *,
    iters: int = 40,
    max_way: int = 16,
    criterion: str = "tinytrain",
    shard_channels: int = 1,
    policy_override: Optional[SparseUpdatePolicy] = None,
    step_cache=None,
    fused: bool = True,
    nan_loss_steps: Tuple[int, ...] = (),
    n_support: Optional[int] = None,
) -> AdaptResult:
    """Run Algorithm 1 for one target task.

    ``pseudo_query`` is the augmented support set used for backprop (Hu et
    al. 2022, Appendix C).  ``policy_override`` injects a fixed policy and
    skips the probe.  ``fused=True`` runs the fine-tune loop with no host
    read inside; ``fused=False`` fetches every iteration's loss.
    Non-finite steps are skipped on the device and counted in
    ``skipped_steps``; ``nan_loss_steps`` forces NaN losses at the listed
    steps (the fault hook for that guard).  ``step_cache`` (an
    ``EpisodeStepCache``) reuses its steps and holds ``max_way``; without
    one the steps are built for this task (``make_episode_sparse_scan``,
    ``make_episode_sparse_step``) with the policy's channels fixed, and
    ``max_way`` applies."""
    if step_cache is not None:
        max_way = step_cache.max_way
    dev = support["episode_labels"].device
    transfers = 0
    if policy_override is None:
        policy, fisher_dt, transfers = _probe_and_select(
            backbone, params, support, pseudo_query, budget,
            criterion=criterion,
            shard_channels=shard_channels, step_cache=step_cache,
            max_way=max_way, n_support=n_support)
    else:
        policy, fisher_dt = policy_override, 0.0

    deltas = backbone.init_deltas(policy, dev)
    opt_state = optimizer.init(deltas)
    # the step's trailing arguments: the channels as tensors through the
    # cache, fixed in the step without one
    args = (support, pseudo_query)
    if step_cache is not None:
        args += (step_cache.chan_idx_arrays(policy, dev),)

    t0 = time.perf_counter()
    losses: list = []
    skipped = 0
    if iters <= 0:
        pass
    elif fused:
        run = (step_cache.scan_steps(policy, iters, nan_loss_steps)
               if step_cache is not None else make_episode_sparse_scan(
                   backbone.features, policy, optimizer, max_way, iters,
                   nan_steps=nan_loss_steps))
        deltas, opt_state, loss_arr, skip_arr = run(
            params, deltas, opt_state, *args)
        loss_h, skip_h = _fetch((loss_arr, skip_arr))
        losses = [float(x) for x in loss_h]
        skipped = int(np.sum(skip_h))
        transfers += 1
    else:
        # eager escape hatch: the step applies the same guard on the device
        # and reports NaN for a skipped step; injection restores the
        # pre-step carry on the host side (the step itself stays clean)
        step = (step_cache.step(policy) if step_cache is not None else
                make_episode_sparse_step(backbone.features, policy,
                                         optimizer, max_way))
        inject = frozenset(int(s) for s in nan_loss_steps)
        for t in range(iters):
            prev = (deltas, opt_state)
            deltas, opt_state, loss = step(params, deltas, opt_state, *args)
            if t in inject:
                deltas, opt_state = prev
                losses.append(float("nan"))
                skipped += 1
            else:
                val = _fetch_scalar(loss)
                losses.append(val)
                skipped += int(not np.isfinite(val))
                transfers += 1
    train_dt = time.perf_counter() - t0
    return AdaptResult(deltas, policy, fisher_dt, train_dt, losses,
                       host_transfers=transfers, skipped_steps=skipped)


def evaluate_task(
    backbone: Backbone,
    params: Any,
    deltas: Any,
    policy: Optional[SparseUpdatePolicy],
    support: Dict[str, torch.Tensor],
    query: Dict[str, torch.Tensor],
    max_way: int = 16,
) -> float:
    kw = {"deltas": deltas, "plan": policy} if policy is not None else {}
    with torch.no_grad():
        acc = episode_accuracy(backbone.features, params, support, query,
                               max_way, **kw)
    return _fetch_scalar(acc)
