"""The sparse fine-tune (Algorithm 1 lines 5-6): the port of
``repro.core.sparse``.

Gradients are taken only with respect to the delta packs; the base weights
never require grad, and layers below the policy's horizon run without
autograd, which is what yields the backward memory and compute savings.

Every step carries the non-finite guard: a step whose loss or any gradient
is non-finite is skipped (the delta/optimiser carry passes through) instead
of poisoning the iterations after it.  The guard is computed on the device:
``scan_train_loop`` runs a fixed number of steps with no host read inside,
so a later change can capture the loop as a CUDA graph.  Where the JAX
package jit-compiles and caches one step per policy structure, PyTorch runs
eagerly: :class:`EpisodeStepCache` keeps the JAX package's surface (it
hands out step callables) with nothing to cache.

The fleet fine-tune (:meth:`EpisodeStepCache.vmap_scan_steps`) runs T
tasks of one policy structure as one program: ``torch.func.vmap`` over a
leading task axis of the episodes and channel indices, the frozen weights
broadcast, gradients from ``torch.func.grad_and_value`` (``autograd.grad``
cannot run under ``vmap``).  Each task's loss, guard and update see only
its own rows, so a task's deltas and skip count are what it would get
alone.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..optim import Optimizer, apply_updates
from ..utils import tree_leaves, tree_map
from .backbones import Backbone
from .fisher import leaf_taps, tap_grads
from .policy import SparseUpdatePolicy
from .protonet import episode_accuracy, episode_loss


def _finite_step(loss: torch.Tensor, grads: Any) -> torch.Tensor:
    """Scalar bool tensor: the loss and every gradient leaf are finite."""
    ok = torch.isfinite(loss).all()
    for g in tree_leaves(grads):
        ok = ok & torch.isfinite(g).all()
    return ok


def _guard_carry(ok: torch.Tensor, new: Any, old: Any) -> Any:
    """``new`` where ``ok`` else ``old``, leaf by leaf (carry passthrough)."""
    return tree_map(lambda n, o: torch.where(ok, n, o), new, old)


def _value_and_grad(loss_fn: Callable[..., torch.Tensor], x: Any, *ctx):
    leaves = [t.detach().requires_grad_() for t in tree_leaves(x)]
    it = iter(leaves)
    xg = tree_map(lambda _: next(it), x)
    loss = loss_fn(xg, *ctx)
    grads = iter(torch.autograd.grad(loss, leaves)) if leaves else iter(())
    return loss.detach(), tree_map(lambda _: next(grads), x)


def _func_value_and_grad(loss_fn: Callable[..., torch.Tensor], x: Any, *ctx):
    """:func:`_value_and_grad` through ``torch.func``, which ``vmap`` can
    wrap."""
    grads, loss = torch.func.grad_and_value(loss_fn)(x, *ctx)
    return loss, grads


def _guarded_step(loss_fn, optimizer: Optimizer, x, st, ctx,
                  inject: Optional[torch.Tensor] = None,
                  value_and_grad: Callable = _value_and_grad):
    """One guarded update: (x, st, loss, ok), all on the device."""
    loss, grads = value_and_grad(loss_fn, x, *ctx)
    if inject is not None:
        loss = torch.where(inject, torch.full_like(loss, float("nan")), loss)
    ok = _finite_step(loss, grads)
    updates, new_st = optimizer.update(grads, st, x)
    x = _guard_carry(ok, apply_updates(x, updates), x)
    st = _guard_carry(ok, new_st, st)
    return x, st, loss, ok


def scan_train_loop(
    loss_fn: Callable[..., torch.Tensor],
    optimizer: Optimizer,
    iters: int,
    *,
    nan_steps: Tuple[int, ...] = (),
):
    """A fixed-length (value_and_grad -> update -> apply) loop.

    ``loss_fn(x, *ctx) -> scalar``, ``x`` the trained tree.  Returns
    ``run(x, opt_state, *ctx) -> (x, opt_state, losses, skipped)`` with
    losses and skipped tensors of shape (iters,), written on the device: the
    body never reads the host.  ``nan_steps`` forces the loss of the listed
    steps to NaN (the fault hook for the guard)."""
    nan_steps = tuple(int(s) for s in nan_steps)

    def run(x, opt_state, *ctx):
        dev = tree_leaves(x)[0].device if tree_leaves(x) else None
        losses = torch.empty((iters,), dtype=torch.float32, device=dev)
        skipped = torch.zeros((iters,), dtype=torch.bool, device=dev)
        inject = torch.zeros((iters,), dtype=torch.bool, device=dev)
        inject[[s for s in nan_steps if 0 <= s < iters]] = True
        for t in range(iters):
            x, opt_state, loss, ok = _guarded_step(
                loss_fn, optimizer, x, opt_state, ctx,
                inject[t] if nan_steps else None)
            losses[t] = loss.float()
            skipped[t] = ~ok
        return x, opt_state, losses, skipped

    return run


class EpisodeStepCache:
    """The adaptation engine's step functions.  Channel indices are passed
    as tensors (``chan_idx_arrays``), as the JAX package passes them to
    one compiled step per policy structure."""

    def __init__(self, backbone: Backbone, optimizer: Optimizer,
                 max_way: int):
        self.backbone = backbone
        self.optimizer = optimizer
        self.max_way = max_way
        # fleet programs by (policy structure, iters), and the (task count,
        # episode shapes) variants each has run: what the JAX package
        # compiles once each
        self._vscans: Dict[Tuple, Callable] = {}
        self._fleet_variants: set = set()

    @staticmethod
    def _key(policy: SparseUpdatePolicy) -> Tuple:
        """The policy's structure: what fixes a step's shapes (the channel
        choices themselves are arguments)."""
        return (policy.horizon,
                tuple((u.layer, u.kind, u.n_channels) for u in policy.units))

    def fleet_scan_compiles(self) -> int:
        """Distinct fleet programs run: (policy structure, iters, task count,
        episode shapes) variants, the quantity the JAX package's
        O(#buckets x #structures) compile contract bounds."""
        return len(self._fleet_variants)

    def probe_fisher(self):
        """pf(params, support, query, taps, n) -> {(layer, kind): Δ_o}: the
        tap gradients of the episode loss, reduced on the device by the
        backbone's ``fisher_reduce`` (the Fisher kernel); only the O(L·C)
        scores are ever fetched.  Rows of the support set with label < 0
        are masked out of the reduction and ``n`` (a Python number) is the
        valid count."""
        feature_fn, max_way = self.backbone.features, self.max_way
        reduce = self.backbone.fisher_reduce

        def pf(params, support, query, taps, n):
            taps = leaf_taps(taps)
            loss = episode_loss(feature_fn, params, support, query, max_way,
                                taps=taps)
            mask = (support["episode_labels"] >= 0).float()
            return reduce(tap_grads(loss, taps), n, mask)

        return pf

    @staticmethod
    def chan_idx_arrays(policy: SparseUpdatePolicy, device="cpu"):
        return {lid: {k: torch.as_tensor(v, dtype=torch.int64, device=device)
                      for k, v in kinds.items()}
                for lid, kinds in policy.channel_idx.items()}

    def _loss(self, policy: SparseUpdatePolicy):
        feature_fn, max_way = self.backbone.features, self.max_way

        def f(d, params, support, query, chan_idx):
            return episode_loss(feature_fn, params, support, query, max_way,
                                deltas=d, plan=policy, chan_idx=chan_idx)

        return f

    def step(self, policy: SparseUpdatePolicy):
        """step(params, deltas, opt_state, support, query, chan_idx) ->
        (deltas, opt_state, loss), the loss NaN for a skipped step."""
        f, opt = self._loss(policy), self.optimizer

        def step(params, deltas, opt_state, support, query, chan_idx):
            deltas, opt_state, loss, ok = _guarded_step(
                f, opt, deltas, opt_state, (params, support, query, chan_idx))
            return deltas, opt_state, torch.where(
                ok, loss, torch.full_like(loss, float("nan")))

        return step

    def scan_steps(self, policy: SparseUpdatePolicy, iters: int,
                   nan_steps: Tuple[int, ...] = ()):
        """The whole fine-tune loop as one call: run(params, deltas,
        opt_state, support, query, chan_idx) -> (deltas, opt_state, losses,
        skipped), one loss transfer per adapt() instead of ``iters``."""
        loop = scan_train_loop(self._loss(policy), self.optimizer,
                               int(iters), nan_steps=nan_steps)

        def run(params, deltas, opt_state, support, query, chan_idx):
            return loop(deltas, opt_state, params, support, query, chan_idx)

        return run

    def vmap_scan_steps(self, policy: SparseUpdatePolicy, iters: int):
        """Fleet variant of :meth:`scan_steps`: run(params, supports,
        queries, chan_idxs) -> (deltas, opt_state, losses, skipped), the
        episodes and channel indices carrying a leading task axis and every
        result task-stacked.  The zero deltas and the optimiser state are
        made inside, so T same-structure tasks fine-tune in one call with
        no per-task set-up.  Episodes may be bucket-padded: rows labelled -1
        drop out of the loss, so padding changes no result."""
        key = (self._key(policy), int(iters))
        if key not in self._vscans:
            f, opt, n = self._loss(policy), self.optimizer, int(iters)
            init_deltas = self.backbone.init_deltas

            def run_from_zero(params, support, query, chan_idx):
                d = init_deltas(policy, support["episode_labels"].device)
                st = opt.init(d)
                losses, skipped = [], []
                for _ in range(n):
                    d, st, loss, ok = _guarded_step(
                        f, opt, d, st, (params, support, query, chan_idx),
                        value_and_grad=_func_value_and_grad)
                    losses.append(loss.float())
                    skipped.append(~ok)
                return d, st, torch.stack(losses), torch.stack(skipped)

            fleet = torch.func.vmap(run_from_zero, in_dims=(None, 0, 0, 0))

            def run(params, support, query, chan_idx, _key=key):
                self._fleet_variants.add((_key, tuple(
                    (tuple(t.shape), str(t.dtype))
                    for t in tree_leaves((support, query)))))
                return fleet(params, support, query, chan_idx)

            self._vscans[key] = run
        return self._vscans[key]

    def evaluate(self, policy: Optional[SparseUpdatePolicy]):
        """ev(params, deltas, support, query, chan_idx) -> accuracy tensor;
        zero-shot (deltas ignored) when ``policy`` is None."""
        feature_fn, max_way = self.backbone.features, self.max_way

        @torch.no_grad()
        def ev(params, deltas, support, query, chan_idx):
            kw = ({} if policy is None else
                  dict(deltas=deltas, plan=policy, chan_idx=chan_idx))
            return episode_accuracy(feature_fn, params, support, query,
                                    max_way, **kw)

        return ev


def deltas_param_count(deltas: Any) -> int:
    return sum(t.numel() for t in tree_leaves(deltas))


def sparse_memory_report(
    backbone: Backbone,
    policy: SparseUpdatePolicy,
    deltas: Any,
    optimizer: Optimizer,
    param_bytes: int = 4,
) -> Dict[str, float]:
    """Backward-pass memory accounting in the paper's Table-2/7 format."""
    n = deltas_param_count(deltas)
    by_key = backbone.cost_by_key()
    act = sum(by_key[(u.layer, u.kind)].act_in_bytes for u in policy.units)
    return {
        "updated_weights_bytes": n * param_bytes,
        "optimizer_bytes": n * param_bytes * optimizer.slots,
        "activation_bytes": act,
        "total_bytes": n * param_bytes * (1 + optimizer.slots) + act,
        "delta_params": n,
    }
