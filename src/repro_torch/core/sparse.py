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
hands out step callables) with nothing to cache.  The step factories
``make_sparse_train_step`` (the training launcher's token-batch step),
``make_episode_sparse_step`` and ``make_episode_sparse_scan`` (the
uncached ``adapt_task`` route) close over a policy's channels.

The fleet fine-tune (:meth:`EpisodeStepCache.vmap_scan_steps`) runs T
tasks of one policy structure as one program: ``torch.func.vmap`` over a
leading task axis of the episodes and channel indices, the frozen weights
broadcast, gradients from ``torch.func.grad_and_value`` (``autograd.grad``
cannot run under ``vmap``).  Each task's loss, guard and update see only
its own rows, so a task's deltas and skip count are what it would get
alone.  On a mesh the task axis splits over its data positions, one vmap
a shard on that position's device.

:meth:`EpisodeStepCache.block_score` scores LM token batches on the
serving block-prefill path (the cached flash kernel on the card).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..dist import context as dist_context
from ..dist.sharding import _dp_axes, map_shards
from ..optim import Optimizer, apply_updates
from ..utils import tree_leaves, tree_map, tree_size
from .backbones import Backbone
from .fisher import leaf_taps, tap_grads
from .policy import SparseUpdatePolicy
from .protonet import episode_accuracy, episode_loss, feature_loss


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
    # a leaf the loss never reads (an AdapterDrop-ped block's adapter) has
    # a zero gradient, as under jax.grad
    grads = iter([torch.zeros_like(t) if d is None else d for t, d in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        if leaves else ())
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


def _reported(loss: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """The step's loss, or NaN where the guard skipped it."""
    return torch.where(ok, loss, torch.full_like(loss, float("nan")))


def make_sparse_train_step(
    loss_fn: Callable[..., torch.Tensor],
    policy: SparseUpdatePolicy,
    optimizer: Optimizer,
    *,
    donate: bool = True,
):
    """The token-batch sparse step: ``loss_fn(params, batch, deltas=...,
    plan=...) -> scalar``.  Returns step(params, deltas, opt_state, batch)
    -> (deltas, opt_state, loss).  Params stay the frozen weights; only
    the deltas are differentiated.  A non-finite step (loss or any
    gradient) leaves deltas and opt_state as they were and reports the
    loss as NaN.  ``donate`` is accepted for the JAX package's signature;
    the step never writes its inputs in place either way."""
    del donate

    def step(params, deltas, opt_state, batch):
        deltas, opt_state, loss, ok = _guarded_step(
            lambda d: loss_fn(params, batch, deltas=d, plan=policy),
            optimizer, deltas, opt_state, ())
        return deltas, opt_state, _reported(loss, ok)

    return step


def make_episode_sparse_step(
    feature_fn: Callable[..., torch.Tensor],
    policy: SparseUpdatePolicy,
    optimizer: Optimizer,
    max_way: int,
):
    """The ProtoNet sparse step with the policy's channels fixed:
    step(params, deltas, opt_state, support, query) -> (deltas,
    opt_state, loss), the loss NaN for a skipped step."""

    def f(d, params, support, query):
        return episode_loss(feature_fn, params, support, query, max_way,
                            deltas=d, plan=policy)

    def step(params, deltas, opt_state, support, query):
        deltas, opt_state, loss, ok = _guarded_step(
            f, optimizer, deltas, opt_state, (params, support, query))
        return deltas, opt_state, _reported(loss, ok)

    return step


def make_episode_sparse_scan(
    feature_fn: Callable[..., torch.Tensor],
    policy: SparseUpdatePolicy,
    optimizer: Optimizer,
    max_way: int,
    iters: int,
    *,
    nan_steps: Tuple[int, ...] = (),
):
    """The whole ProtoNet fine-tune as one call with no host read inside:
    run(params, deltas, opt_state, support, query) -> (deltas, opt_state,
    losses, skipped), losses and skipped of shape (iters,)."""
    loop = scan_train_loop(
        lambda d, params, support, query: episode_loss(
            feature_fn, params, support, query, max_way,
            deltas=d, plan=policy),
        optimizer, iters, nan_steps=nan_steps)

    def run(params, deltas, opt_state, support, query):
        return loop(deltas, opt_state, params, support, query)

    return run


def _remat(policy: SparseUpdatePolicy) -> bool:
    """The policy asks its steps to recompute in the backward (the one
    part of a step beyond its structure that the step reads)."""
    return bool((policy.meta or {}).get("remat", False))


class EpisodeStepCache:
    """The adaptation engine's step functions.  Channel indices are passed
    as tensors (``chan_idx_arrays``), as the JAX package passes them to
    one compiled step per policy structure."""

    def __init__(self, backbone: Backbone, optimizer: Optimizer,
                 max_way: int):
        self.backbone = backbone
        self.optimizer = optimizer
        self.max_way = max_way
        # step builders by policy structure (and iters, injected NaN
        # steps): the JAX package's compiled step variants
        self._steps: Dict[Tuple, Callable] = {}
        self._scans: Dict[Tuple, Callable] = {}
        self._probe: Optional[Callable] = None
        # fleet programs by (policy structure, iters), and the (task count,
        # episode shapes) variants each has run: what the JAX package
        # compiles once each
        self._vscans: Dict[Tuple, Callable] = {}
        self._fleet_variants: set = set()
        # token-batch scorers by block size
        self._block_scores: Dict[int, Callable] = {}

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

    def probe_grad(self):
        """g(params, support, query, taps) -> the episode loss's gradient
        with respect to ``taps``, in their shape: a ``torch.func.grad``
        built once for each backbone (episodes pass as arguments)."""
        if self._probe is None:
            feature_fn, max_way = self.backbone.features, self.max_way

            def f(params, support, query, taps):
                return episode_loss(feature_fn, params, support, query,
                                    max_way, taps=taps)

            self._probe = torch.func.grad(f, argnums=3)
        return self._probe

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

    def probe_fisher_batch(self):
        """The fleet's probe: pfb(params, supports, queries, taps, ns) ->
        {(layer, kind): (T, C) Δ_o} for T tasks of one episode shape, the
        episodes task-stacked, ``ns`` a (T,) float32 tensor of valid counts,
        ``taps`` one task's.  The tasks ride the batch axis of one probe
        (the JAX package vmaps its probe instead): the T episodes' rows go
        through the backbone together under T copies of the taps, the loss
        is the sum of the T episode losses, each from its own rows' features,
        so one backward gives every task's own tap gradients, with one
        task's activation memory a task.  The reduction then runs over the
        (T, ...) stacks through the backbone's ``fisher_reduce_batch``: for
        an LM one Fisher kernel launch a tap group, not one a task.
        (``torch.func.vmap`` of ``torch.func.grad`` gives the same
        gradients, but holds several times a task's activations: at
        qwen2-1.5b's width two tasks of 64 rows ran out of an 80 GB
        card.)"""
        feature_fn, max_way = self.backbone.features, self.max_way
        reduce = self.backbone.fisher_reduce_batch

        def pfb(params, supports, queries, taps, ns):
            t, b = supports["episode_labels"].shape

            def rows(tree):
                return {k: v.reshape(t * b, *v.shape[2:])
                        for k, v in tree.items()}

            # the task's taps repeated along the batch: an LM's (L, T*B, C)
            # a tap group, an edge CNN's (T*B, C_i) a layer
            big = leaf_taps([x.repeat(t, 1) for x in taps]
                            if isinstance(taps, list) else
                            tree_map(lambda x: x.repeat(1, t, 1), taps))
            fs = feature_fn(params, rows(supports), taps=big)
            fq = feature_fn(params, rows(queries), taps=big)
            loss = sum(feature_loss(fs[i * b:(i + 1) * b],
                                    supports["episode_labels"][i],
                                    fq[i * b:(i + 1) * b],
                                    queries["episode_labels"][i], max_way)
                       for i in range(t))
            g = tap_grads(loss, big)
            if isinstance(g, list):  # an edge CNN's (T*B, C_i) a layer
                g = [x.reshape(t, b, x.shape[-1]) for x in g]
            else:  # an LM's (L, T*B, C) a tap group -> (T, L, B, C)
                g = {gk: {k: v.reshape(v.shape[0], t, b, v.shape[-1])
                          .transpose(0, 1).contiguous()
                          for k, v in grp.items()} for gk, grp in g.items()}
            mask = (supports["episode_labels"] >= 0).float()  # (T, B)
            return reduce(g, ns, mask)

        return pfb

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
        (deltas, opt_state, loss), the loss NaN for a skipped step; built
        once for each policy structure."""
        key = (self._key(policy), _remat(policy))
        if key not in self._steps:
            f, opt = self._loss(policy), self.optimizer

            def step(params, deltas, opt_state, support, query, chan_idx):
                deltas, opt_state, loss, ok = _guarded_step(
                    f, opt, deltas, opt_state,
                    (params, support, query, chan_idx))
                return deltas, opt_state, _reported(loss, ok)

            self._steps[key] = step
        return self._steps[key]

    def scan_steps(self, policy: SparseUpdatePolicy, iters: int,
                   nan_steps: Tuple[int, ...] = ()):
        """The whole fine-tune loop as one call: run(params, deltas,
        opt_state, support, query, chan_idx) -> (deltas, opt_state, losses,
        skipped), one loss transfer per adapt() instead of ``iters``; built
        once for each (policy structure, iters, NaN steps)."""
        key = (self._key(policy), _remat(policy), int(iters),
               tuple(nan_steps))
        if key not in self._scans:
            loop = scan_train_loop(self._loss(policy), self.optimizer,
                                   int(iters), nan_steps=nan_steps)

            def run(params, deltas, opt_state, support, query, chan_idx):
                return loop(deltas, opt_state, params, support, query,
                            chan_idx)

            self._scans[key] = run
        return self._scans[key]

    def vmap_scan_steps(self, policy: SparseUpdatePolicy, iters: int,
                        mode: Optional[str] = None):
        """Fleet variant of :meth:`scan_steps`: run(params, supports,
        queries, chan_idxs) -> (deltas, opt_state, losses, skipped), the
        episodes and channel indices carrying a leading task axis and every
        result task-stacked.  The zero deltas and the optimiser state are
        made inside, so T same-structure tasks fine-tune in one call with
        no per-task set-up.  Episodes may be bucket-padded: rows labelled -1
        drop out of the loss, so padding changes no result.

        ``mode``: ``"vmap"`` batches the task axis through every op;
        ``"map"`` runs the tasks one by one inside the call; ``"shard"``
        splits the task axis over the data positions of the mesh published
        as the ``fleet_mesh`` context key (``dist.context``): the inputs
        come as :class:`~..dist.sharding.TaskShards`, the weights as
        :class:`~..dist.sharding.Replicas`, each shard runs the vmap path on
        its position's device and the results come back as task shards (a
        pure-'model' mesh, or inputs that were not split, run locally).
        Default: shard when a fleet mesh is published, else vmap.  (The
        JAX package takes "map" on its CPU backend, where XLA lowers
        batched-weight convolutions poorly; the port's vmap batches plain
        matrix products on both devices.)"""
        mesh = dist_context.get("fleet_mesh")
        if mode is None:
            mode = "shard" if mesh is not None else "vmap"
        if mode not in ("vmap", "map", "shard"):
            raise ValueError(f"unknown fleet mode {mode!r} (vmap, map or "
                             "shard)")
        key = (self._key(policy), int(iters), mode,
               mesh if mode == "shard" else None)
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

            vmap_fleet = torch.func.vmap(run_from_zero,
                                         in_dims=(None, 0, 0, 0))

            def map_fleet(params, support, query, chan_idx):
                t = support["episode_labels"].shape[0]
                outs = [run_from_zero(params, *tree_map(
                    lambda x, _i=i: x[_i], (support, query, chan_idx)))
                    for i in range(t)]
                return tree_map(lambda *xs: torch.stack(xs), *outs)

            if mode == "vmap":
                fleet = vmap_fleet
            elif mode == "map":
                fleet = map_fleet
            elif not _dp_axes(mesh)[0]:
                # a pure-'model' mesh has no data axis to split the tasks
                # over (FleetShardingRules replicates): run locally
                fleet = vmap_fleet
            else:
                def fleet(params, support, query, chan_idx):
                    return map_shards(vmap_fleet, params, support, query,
                                      chan_idx)

            def run(params, support, query, chan_idx, _key=key):
                self._fleet_variants.add((_key, tuple(
                    (tuple(t.shape), str(t.dtype))
                    for t in tree_leaves((support, query)))))
                return fleet(params, support, query, chan_idx)

            self._vscans[key] = run
        return self._vscans[key]

    def block_score(self, block: int = 32):
        """LM token-batch scorer on the serving block-prefill path.

        score(params, tokens (N, S) int) -> per-sequence mean next-token NLL
        (N,) float32, computed by folding the batch through
        ``models.transformer.prefill_block`` in ceil(S / block) blocks
        against decode caches (``init_caches(cfg, N, S)``): the
        sequence-mode path the serving engine ingests prompts with, the
        cached flash kernel's on the card.  A ragged tail rides the validity
        mask, as a prompt tail does in serving; sliding-window configs
        score through their rolling cache, as a served request would.  Each
        block's logits reduce to its positions' NLL as they come, so the
        (N, S, vocab) logits are never held at once.  Scorers are kept per
        block size."""
        if self.backbone.kind != "lm":
            raise ValueError(
                "block_score is for LM token-batch workloads; "
                f"backbone kind is {self.backbone.kind!r}")
        key = int(block)
        if key < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if key not in self._block_scores:
            from ..models import transformer as T

            cfg = self.backbone.cfg

            @torch.no_grad()
            def score(params, tokens):
                n, s = tokens.shape
                if s < 2:
                    raise ValueError(
                        f"need at least 2 tokens to score next-token NLL, "
                        f"got sequences of length {s}")
                dev = tokens.device
                blk = min(key, s)
                nb = -(-s // blk)  # the ragged tail rides a validity mask
                tb = torch.nn.functional.pad(tokens, (0, nb * blk - s))
                caches = T.init_caches(cfg, n, s, device=dev)
                nll = torch.empty((n, s - 1), dtype=torch.float32,
                                  device=dev)
                for b in range(nb):
                    lo = b * blk
                    valid = (torch.arange(lo, lo + blk, device=dev) < s
                             ).expand(n, blk)
                    pos = torch.full((n,), lo, dtype=torch.int32,
                                     device=dev)
                    logits, caches = T.prefill_block(
                        cfg, params, tb[:, lo:lo + blk], caches, pos, valid,
                        drop_free=True)
                    m = min(blk, s - 1 - lo)  # positions with a next token
                    if m <= 0:
                        continue
                    lg = logits[:, :m].float()
                    gold = tokens[:, lo + 1:lo + 1 + m].long()
                    nll[:, lo:lo + m] = (
                        torch.logsumexp(lg, dim=-1)
                        - torch.gather(lg, -1, gold[..., None])[..., 0])
                return nll.mean(dim=-1)

            self._block_scores[key] = score
        return self._block_scores[key]

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
    return tree_size(deltas)


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
