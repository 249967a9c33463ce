"""Session layer behind the port's ``api`` façade: the port of
``repro.core.session`` on the LM backbones and the edge CNNs.

- :class:`DeviceProfile`: a named resource envelope (memory / compute)
  lowered to the Algorithm-1 :class:`~.criterion.Budget`, with presets.
- :class:`TinyTrainSession`: one backbone, its frozen params on one device
  and the step cache, many ``adapt()`` / ``evaluate()`` calls.
- :class:`Adaptation`: the result: accuracy, memory accounting and
  deployment (``fold_into``).

``TinyTrainSession.adapt`` runs every registered criterion, the
static-channel ones (``random``, ``l2norm``: the probe's layers, a static
channel pick) too; ``baseline`` runs the paper's baseline zoo (none,
fulltrain, lastlayer, sparseupdate, tinytl, adapterdrop<pct>).
``adapt_many`` fine-tunes a fleet of tasks, one program and one host
fetch per (bucket, policy structure) group, under one given policy
(``policy_override``) or a policy per task from one batched Fisher probe
per episode shape (one fetch of the scores per shape group).
``mesh=``/``hosts=`` and ``score_stream`` raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..optim import Optimizer, adam
from ..utils import DeviceLike, resolve_device, tree_leaves, tree_map
from .adapt import AdaptResult, _fetch, _fetch_scalar, adapt_task
from .backbones import Backbone
from .criterion import Budget
from .fisher import potentials_from_chans
from .policy import SparseUpdatePolicy, last_layer_policy
from .protonet import episode_accuracy
from .selection import select_policy, static_channel_policy
from .sparse import (
    EpisodeStepCache, deltas_param_count, sparse_memory_report,
)

__all__ = [
    "Adaptation", "DeviceProfile", "PROFILES", "Task", "TinyTrainSession",
    "criteria", "device_profile", "register_criterion", "register_profile",
    "JETSON_NANO", "RPI_ZERO", "STM32F746",
]


# ---------------------------------------------------------------------------
# Device profiles
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Resource envelope of a deployment target.

    The online stage consumes ``mem_kb`` (backward-pass memory: B1 updated
    weights + B2 optimizer state + B4 saved inputs) and ``compute_frac``
    (backward MACs as a fraction of a full backward pass).  ``flash_mb`` and
    ``peak_mw`` are informational and feed reporting, not selection.
    """

    name: str
    mem_kb: float
    compute_frac: float
    channel_ratio: float = 0.5
    opt_slots: int = 2  # adam: m, v
    param_bytes: int = 4
    flash_mb: float = 0.0
    peak_mw: float = 0.0

    def budget(self) -> Budget:
        """Lower this profile to the Algorithm-1 budget inputs."""
        return Budget(mem_bytes=self.mem_kb * 1e3,
                      compute_frac=self.compute_frac,
                      channel_ratio=self.channel_ratio,
                      opt_slots=self.opt_slots,
                      param_bytes=self.param_bytes)

    def scaled(self, mem: float = 1.0, compute: float = 1.0,
               name: Optional[str] = None) -> "DeviceProfile":
        """A derived profile with scaled envelopes."""
        return dataclasses.replace(
            self, name=name or f"{self.name}*{mem:g}/{compute:g}",
            mem_kb=self.mem_kb * mem,
            compute_frac=min(1.0, self.compute_frac * compute))


# Presets: the paper's edge targets (Pi Zero 2, Jetson Nano) and the
# STM32-class MCU point the cost model mirrors.
STM32F746 = DeviceProfile(
    name="stm32f746", mem_kb=320, compute_frac=0.25, channel_ratio=0.5,
    flash_mb=1.0, peak_mw=400.0)
RPI_ZERO = DeviceProfile(
    name="rpi-zero", mem_kb=1000, compute_frac=0.5, channel_ratio=0.75,
    flash_mb=512.0, peak_mw=1200.0)
JETSON_NANO = DeviceProfile(
    name="jetson-nano", mem_kb=4096, compute_frac=0.8, channel_ratio=1.0,
    flash_mb=4096.0, peak_mw=10_000.0)

PROFILES: Dict[str, DeviceProfile] = {}


def register_profile(profile: DeviceProfile) -> DeviceProfile:
    PROFILES[profile.name.lower().replace("_", "-")] = profile
    return profile


for _p in (STM32F746, RPI_ZERO, JETSON_NANO):
    register_profile(_p)


def device_profile(name: str) -> DeviceProfile:
    """Look up a registered profile (case/underscore tolerant)."""
    key = name.lower().replace("_", "-")
    try:
        return PROFILES[key]
    except KeyError:
        raise KeyError(f"unknown device profile {name!r}; known: "
                       f"{sorted(PROFILES)}") from None


def _as_budget(profile: Union[DeviceProfile, Budget, str]) -> Budget:
    if isinstance(profile, str):
        profile = device_profile(profile)
    if isinstance(profile, DeviceProfile):
        return profile.budget()
    if isinstance(profile, Budget):
        return profile
    raise TypeError(
        f"expected DeviceProfile, Budget or profile name, got {type(profile)}")


# name -> (multi-objective score mode for layer selection, channel mode)
_CRITERIA: Dict[str, Tuple[str, str]] = {
    "tinytrain": ("tinytrain", "dynamic"),
    "fisher_only": ("fisher_only", "dynamic"),
    "fisher_mem": ("fisher_mem", "dynamic"),
    "fisher_compute": ("fisher_compute", "dynamic"),
    # Fig. 4 ablations: TinyTrain layer selection, static channel choice
    "random": ("tinytrain", "random"),
    "l2norm": ("tinytrain", "l2norm"),
}


def register_criterion(name: str, score_mode: str,
                       channel_mode: str = "dynamic") -> None:
    """Register a selection criterion usable as ``adapt(criterion=name)``."""
    _CRITERIA[name] = (score_mode, channel_mode)


def criteria() -> List[str]:
    return sorted(_CRITERIA)


def _resolve_criterion(name: str) -> Tuple[str, str]:
    try:
        return _CRITERIA[name]
    except KeyError:
        raise KeyError(
            f"unknown criterion {name!r}; known: {criteria()}") from None


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} arrives with ROADMAP queue 1, item {item}")


# ---------------------------------------------------------------------------
# Task
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Task:
    """One target task: the support/query episode plus the augmented
    pseudo-query set used for backprop (Hu et al. 2022, Appendix C).

    The sets are host numpy arrays; a session moves them to its device.
    Keeping them on the host also gives the valid-row count without a
    device read."""

    name: str
    support: Dict[str, np.ndarray]
    query: Dict[str, np.ndarray]
    pseudo_query: Dict[str, np.ndarray]
    max_way: int

    @property
    def n_support(self) -> int:
        return int(np.sum(np.asarray(self.support["episode_labels"]) >= 0))

    @classmethod
    def from_episode(cls, ep, rng: np.random.Generator, max_way: int,
                     name: str = "") -> "Task":
        """A Task from a ``data`` Episode of images or token sequences."""
        from ..data import augment_lm_support, augment_support

        if "frames" in ep.support or "image_embeds" in ep.support:
            raise _later("encoder-decoder episodes", "14")
        augment = (augment_support if "images" in ep.support
                   else augment_lm_support)
        return cls(name=name or getattr(ep, "domain", "task"),
                   support={k: np.asarray(v) for k, v in ep.support.items()},
                   query={k: np.asarray(v) for k, v in ep.query.items()},
                   pseudo_query=augment(rng, ep.support),
                   max_way=max_way)


def _tensors(tree: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in tree.items()}


def _stack_trees(trees: List[Any]) -> Any:
    """Stack a list of identically shaped numpy trees along a new task
    axis."""
    return tree_map(lambda *xs: np.stack(xs), *trees)


def _tree_shape_key(tree: Dict[str, np.ndarray]) -> Tuple:
    return tuple((k, np.shape(tree[k]), str(np.asarray(tree[k]).dtype))
                 for k in sorted(tree))


def _episode_shape_key(sup: Dict[str, np.ndarray],
                       pq: Dict[str, np.ndarray]) -> Tuple:
    """Episodes stack iff their (support, pseudo-query) trees match
    exactly; with bucketing the key is computed on the padded episodes, so
    any way/shot mix inside one bucket shares it."""
    return (_tree_shape_key(sup), _tree_shape_key(pq))


def _group_indices(keys: List[Any]) -> Dict[Any, List[int]]:
    groups: Dict[Any, List[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return groups


# Bucketed episode padding: heterogeneous way/shot traffic pads up to a
# few canonical row counts (the next power of two, floored), so a fleet of
# arbitrary episode sizes runs O(#buckets) programs.  Padded rows carry
# label -1, which the episode loss and accuracy treat as invisible.
_MIN_BUCKET_ROWS = 8


def _bucket_rows(n: int, floor: int = _MIN_BUCKET_ROWS) -> int:
    """Canonical bucket size: the next power of two >= n (>= floor)."""
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


def _pad_episode_rows(ep: Dict[str, np.ndarray], rows: int
                      ) -> Dict[str, np.ndarray]:
    """Pad every episode leaf to ``rows`` along axis 0: labels with -1,
    data with zeros."""
    out: Dict[str, np.ndarray] = {}
    for k, v in ep.items():
        v = np.asarray(v)
        n = v.shape[0]
        if n > rows:
            raise ValueError(
                f"episode leaf {k!r} has {n} rows > bucket {rows}")
        width = [(0, rows - n)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, width,
                        constant_values=-1 if k == "episode_labels" else 0)
    return out


def _bucket_episode(task: "Task") -> Tuple[Any, Any]:
    """(support, pseudo_query) of a task, padded to one shared bucket (both
    sets to the same row count)."""
    rows = max(np.shape(v)[0] for tree in (task.support, task.pseudo_query)
               for v in tree.values())
    target = _bucket_rows(rows)
    return (_pad_episode_rows(task.support, target),
            _pad_episode_rows(task.pseudo_query, target))


# ---------------------------------------------------------------------------
# Adaptation result
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Adaptation:
    """Outcome of one adapt() call: ``deltas`` are the channel-delta packs
    ({"L{layer}": {kind: {weight: tensor}}}) on the session's device."""

    method: str
    task: Task
    profile: Optional[DeviceProfile]
    budget: Optional[Budget]
    deltas: Any
    policy: Optional[SparseUpdatePolicy]
    fisher_seconds: float
    train_seconds: float
    losses: List[float]
    host_transfers: float
    _session: "TinyTrainSession" = dataclasses.field(repr=False)
    _eval: Callable[[Any, Any], float] = dataclasses.field(repr=False)
    # fine-tune steps skipped by the non-finite guard
    skipped_steps: int = 0

    @property
    def steps_per_sec(self) -> float:
        """Fine-tune iterations per second (0 when nothing was trained)."""
        n = len(self.losses)
        return n / self.train_seconds if self.train_seconds > 0 and n else 0.0

    def accuracy(self, task: Optional[Task] = None) -> float:
        """Query-set accuracy on this task (or another Task's episode)."""
        t = task or self.task
        return float(self._eval(t.support, t.query))

    def delta_param_count(self) -> int:
        return deltas_param_count(self.deltas) if self.deltas is not None else 0

    def memory_report(self) -> Dict[str, float]:
        """Backward-pass memory accounting (paper Table-2/7 format), with
        the profile's ``param_bytes``."""
        if self.policy is None:
            raise ValueError(f"method {self.method!r} has no sparse-update "
                             "policy; memory_report() applies to "
                             "policy-based adaptations")
        pb = (self.profile.param_bytes if self.profile is not None
              else self.budget.param_bytes if self.budget is not None
              else 4)
        return sparse_memory_report(self._session.backbone, self.policy,
                                    self.deltas, self._session.optimizer,
                                    param_bytes=pb)

    def fold_into(self, target: Any) -> Any:
        """Fold channel deltas into serving weights: W ⊕ scatter(ΔW, idx).

        ``target`` is a ``serving.ServeEngine`` (its params are replaced
        and the engine returned) or a raw parameter tree, an LM's or an
        edge CNN's (a folded copy is returned; untouched tensors are
        shared).  Adapted models then serve at exactly base cost."""
        from ..models.edge_cnn import cnn_fold_deltas
        from ..models.overlay import fold_deltas

        if self.policy is None or self.deltas is None:
            raise ValueError(
                f"method {self.method!r} produced no delta pack to fold")
        if hasattr(target, "params") and hasattr(target, "cfg"):
            target.params = fold_deltas(target.cfg, target.params,
                                        self.deltas, self.policy)
            return target
        bb = self._session.backbone
        fold = cnn_fold_deltas if bb.kind == "cnn" else fold_deltas
        return fold(bb.cfg, target, self.deltas, self.policy)

    def describe(self) -> str:
        pol = self.policy.describe() if self.policy is not None else "none"
        return (f"{self.method}: policy={pol} "
                f"fisher={self.fisher_seconds:.2f}s "
                f"train={self.train_seconds:.2f}s "
                f"steps_per_sec={self.steps_per_sec:.1f} "
                f"host_transfers={self.host_transfers:g} "
                f"skipped_steps={self.skipped_steps} "
                f"delta_params={self.delta_param_count()}")


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------


class TinyTrainSession:
    """One backbone + frozen params on one device, many tasks.

    ``params`` default to the backbone's random init from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card unless
    the caller passes ``device="cpu"``); given params fix the device."""

    def __init__(
        self,
        backbone: Backbone,
        params: Any = None,
        *,
        optimizer: Optional[Optimizer] = None,
        lr: float = 3e-3,
        baseline_lr: float = 1e-3,
        max_way: int = 16,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ):
        self.backbone = backbone
        if params is None:
            dev = resolve_device(device)
            params = backbone.init(torch.Generator(device=dev).manual_seed(seed))
        self.params = params
        self.device = tree_leaves(params)[0].device
        # delta packs start at zero -> slightly hotter lr than full tuning
        self.optimizer = optimizer or adam(lr)
        self.baseline_optimizer = adam(baseline_lr)
        self.max_way = max_way
        self.step_cache = EpisodeStepCache(backbone, self.optimizer, max_way)
        self._static_policies: Dict[str, SparseUpdatePolicy] = {}
        # ES baseline cache: one (proxy_task, policy) per budget/proxy/seed;
        # holding the task pins its id() for the key's lifetime
        self._es_cache: Dict[Any, Tuple[Task, SparseUpdatePolicy]] = {}
        self._full_scans: Dict[int, Any] = {}
        self._tinytl_scans: Dict[Tuple[int, int], Any] = {}
        self.last_fleet_report: Dict[str, Any] = {}

    def _on(self, tree: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return _tensors(tree, self.device)

    def adapt(
        self,
        task: Task,
        profile: Union[DeviceProfile, Budget, str],
        *,
        criterion: str = "tinytrain",
        iters: int = 40,
        shard_channels: int = 1,
        policy_override: Optional[SparseUpdatePolicy] = None,
        seed: int = 0,
        fused: bool = True,
        nan_loss_steps: Tuple[int, ...] = (),
    ) -> Adaptation:
        """Algorithm 1 on one task: probe -> select -> sparse fine-tune.

        ``fused=True`` runs the fine-tune loop with no host read inside
        (two blocking transfers per call); ``fused=False`` is the eager
        loop.  ``nan_loss_steps`` forces NaN losses at the listed steps to
        drive the non-finite guard (counted in ``skipped_steps``)."""
        self._check_task(task)
        if isinstance(profile, str):
            profile = device_profile(profile)
        budget = _as_budget(profile)
        prof = profile if isinstance(profile, DeviceProfile) else None
        mode, channel_mode = _resolve_criterion(criterion)
        sup, pq = self._on(task.support), self._on(task.pseudo_query)
        kw = dict(step_cache=self.step_cache, criterion=mode,
                  shard_channels=shard_channels, n_support=task.n_support)
        probe = None
        if policy_override is None and channel_mode != "dynamic":
            # probe + layer selection only, then a static channel pick at
            # the same layers and K (the Fig. 4 ablations)
            probe = adapt_task(self.backbone, self.params, sup, pq, budget,
                               self.optimizer, iters=0, **kw)
            l2 = (self.backbone.weight_l2(self.params)
                  if channel_mode == "l2norm" else None)
            policy_override = static_channel_policy(
                probe.policy, self.backbone.unit_costs, channel_mode,
                rng=np.random.default_rng(seed), weight_l2=l2)
        res = adapt_task(self.backbone, self.params, sup, pq, budget,
                         self.optimizer, iters=iters, fused=fused,
                         nan_loss_steps=nan_loss_steps,
                         policy_override=policy_override, **kw)
        if probe is not None:
            res = dataclasses.replace(
                res, fisher_seconds=probe.fisher_seconds,
                host_transfers=probe.host_transfers + res.host_transfers)
            method = criterion
        else:
            method = criterion if policy_override is None else (
                f"override:"
                f"{(policy_override.meta or {}).get('source', 'policy')}")
        return self._wrap(method, task, prof, res, budget=budget)

    def evaluate(self, task: Task,
                 adaptation: Optional[Adaptation] = None) -> float:
        """Query accuracy: zero-shot when ``adaptation`` is None."""
        self._check_task(task)
        if adaptation is not None:
            return adaptation.accuracy(task)
        ev = self.step_cache.evaluate(None)
        return _fetch_scalar(ev(self.params, None, self._on(task.support),
                                self._on(task.query), None))

    def adapt_many(
        self,
        tasks: List[Task],
        profile: Union[DeviceProfile, Budget, str],
        *,
        criterion: str = "tinytrain",
        iters: int = 40,
        shard_channels: int = 1,
        policy_override: Optional[SparseUpdatePolicy] = None,
        bucket: bool = True,
        mesh: Optional[Any] = None,
        hosts: Optional[int] = None,
    ) -> List[Adaptation]:
        """Fleet adaptation: N tasks in one fine-tune program per (bucket,
        policy structure) group.

        Without ``policy_override`` every task gets its own policy: the
        tasks of one episode shape are probed together
        (``probe_fisher_batch``: the group's rows through one probe, then
        one Fisher reduction a tap group over the task stack), one host
        fetch per shape group brings back their scores, and each task's
        policy is selected from its own.  Static-channel criteria raise ``ValueError`` here, as in
        the JAX package.  Then the episodes and channel indices of a group
        are stacked along a task axis and fine-tuned together
        (``vmap_scan_steps``) while the frozen weights broadcast; one host
        fetch per group brings back its losses and skip counts, and the
        deltas stay on the device.  Returns one :class:`Adaptation` per
        task, in input order, each with ``host_transfers`` of its share of
        its groups' fetches.  ``bucket=True`` pads each task's rows to the
        next power of two, so any way/shot mix inside a bucket shares a
        group; padded rows carry label -1 and change no result.  A summary
        of the grouping is kept in ``self.last_fleet_report``.
        ``mesh=``/``hosts=`` are ROADMAP item 16."""
        if mesh is not None or hosts not in (None, 1):
            raise _later("adapt_many(mesh=..., hosts=...) (sharded fleet "
                         "adaptation)", "16")
        if (getattr(self.backbone.cfg, "family", None) == "ssm"
                and self.device.type != "cpu"):
            raise _later("adapt_many of the ssm family on the card (the SSD "
                         "kernels under torch.func.vmap)", "15.2")
        if not tasks:
            return []
        for t in tasks:
            self._check_task(t)
        if isinstance(profile, str):
            profile = device_profile(profile)
        budget = _as_budget(profile)
        prof = profile if isinstance(profile, DeviceProfile) else None
        eps = [_bucket_episode(t) if bucket else (t.support, t.pseudo_query)
               for t in tasks]
        keys = [_episode_shape_key(sup, pq) for sup, pq in eps]
        cache = self.step_cache
        fisher_dt = [0.0] * len(tasks)
        transfers = [0.0] * len(tasks)  # each task's share of group fetches
        # the stacked episodes of a group of tasks, on the device once for
        # the probe and the fine-tune
        stack_cache: Dict[Tuple[int, ...], Tuple[Any, Any]] = {}

        def stacked(idxs):
            key = tuple(idxs)
            if key not in stack_cache:
                stack_cache[key] = (
                    self._on(_stack_trees([eps[i][0] for i in idxs])),
                    self._on(_stack_trees([eps[i][1] for i in idxs])))
            return stack_cache[key]

        if policy_override is not None:
            policies = [policy_override] * len(tasks)
            method = (f"override:"
                      f"{(policy_override.meta or {}).get('source', 'policy')}")
        else:
            mode, channel_mode = _resolve_criterion(criterion)
            if channel_mode != "dynamic":
                raise ValueError(
                    f"criterion {criterion!r} uses a static channel mode "
                    f"({channel_mode}); adapt_many supports dynamic-channel "
                    "criteria (or pass policy_override=)")
            method = criterion
            policies = [None] * len(tasks)
            probe = cache.probe_fisher_batch()
            costs = self.backbone.unit_costs
            for idxs in _group_indices(keys).values():
                sup, pq = stacked(idxs)
                ns = torch.tensor([float(tasks[i].n_support) for i in idxs],
                                  dtype=torch.float32, device=self.device)
                taps = self.backbone.make_taps(
                    sup["episode_labels"].shape[1], self.device)
                t0 = time.perf_counter()
                # the shape group's one fetch: O(T·L·C) scores
                chans_all = _fetch(probe(self.params, sup, pq, taps, ns))
                dt = (time.perf_counter() - t0) / len(idxs)
                for j, i in enumerate(idxs):
                    chans = {k: v[j] for k, v in chans_all.items()}
                    policies[i] = select_policy(
                        costs, potentials_from_chans(costs, chans), chans,
                        budget, criterion=mode,
                        shard_channels=shard_channels)
                    fisher_dt[i] = dt
                    transfers[i] = 1.0 / len(idxs)

        out: List[Optional[Adaptation]] = [None] * len(tasks)
        run_groups = _group_indices(
            [(k, cache._key(p)) for k, p in zip(keys, policies)])
        compiles_before = cache.fleet_scan_compiles()
        for idxs in run_groups.values():
            sup, pq = stacked(idxs)
            ci = tree_map(lambda *xs: torch.stack(xs), *[
                cache.chan_idx_arrays(policies[i], self.device) for i in idxs])
            run = cache.vmap_scan_steps(policies[idxs[0]], iters)
            t0 = time.perf_counter()
            d_stack, _, loss_stack, skip_stack = run(self.params, sup, pq, ci)
            # the group's one blocking fetch; the deltas stay on the device
            losses, skips = _fetch((loss_stack, skip_stack))
            dt = (time.perf_counter() - t0) / len(idxs)
            for j, i in enumerate(idxs):
                res = AdaptResult(
                    deltas=tree_map(lambda x, _j=j: x[_j], d_stack),
                    policy=policies[i], fisher_seconds=fisher_dt[i],
                    train_seconds=dt, losses=[float(x) for x in losses[j]],
                    host_transfers=transfers[i] + 1.0 / len(idxs),
                    skipped_steps=int(np.sum(skips[j])))
                out[i] = self._wrap(method, tasks[i], prof, res,
                                    budget=budget)
        self.last_fleet_report = {
            "tasks": len(tasks),
            "bucketed": bucket,
            "buckets": len(set(keys)),
            "policy_structures": len({cache._key(p) for p in policies}),
            "groups": len(run_groups),
            "scan_compiles": cache.fleet_scan_compiles() - compiles_before,
            "mesh_axes": None,
            "hosts": 1,
            "ingestion": "local",
        }
        return out

    def baseline(
        self,
        name: str,
        task: Task,
        profile: Union[DeviceProfile, Budget, str],
        *,
        iters: int = 40,
        proxy_task: Optional[Task] = None,
        seed: int = 0,
        fused: bool = True,
    ) -> Adaptation:
        """Run one on-device-training baseline on a task.

        ``name``: none | fulltrain | lastlayer | sparseupdate | tinytl |
        adapterdrop<pct> | any registered criterion (tinytrain, random,
        ...).  ``sparseupdate`` searches its static policy offline on
        ``proxy_task`` (never the target); the TinyTL family is CNN-only.
        """
        self._check_task(task)
        if isinstance(profile, str):
            profile = device_profile(profile)
        if name in _CRITERIA:
            return self.adapt(task, profile, criterion=name, iters=iters,
                              seed=seed, fused=fused)
        if name == "none":
            return self._wrap(
                "none", task,
                profile if isinstance(profile, DeviceProfile) else None,
                AdaptResult(None, None, 0.0, 0.0, []),
                budget=_as_budget(profile))
        if name == "lastlayer":
            pol = self._static_policies.setdefault(
                "lastlayer",
                last_layer_policy(self.backbone.unit_costs,
                                  len(self.backbone.unit_costs)))
            return dataclasses.replace(
                self.adapt(task, profile, policy_override=pol, iters=iters,
                           fused=fused),
                method="lastlayer")
        if name == "sparseupdate":
            pol = self._sparseupdate_policy(_as_budget(profile), proxy_task,
                                            seed)
            return dataclasses.replace(
                self.adapt(task, profile, policy_override=pol, iters=iters,
                           fused=fused),
                method="sparseupdate")
        if name == "fulltrain":
            return self._fulltrain(task, iters, fused=fused)
        if name.startswith("tinytl") or name.startswith("adapterdrop"):
            return self._tinytl(name, task, iters, seed, fused=fused)
        raise KeyError(
            f"unknown baseline {name!r}; known: none, fulltrain, lastlayer, "
            f"sparseupdate, tinytl, adapterdrop<pct>, {criteria()}")

    def score_stream(self, *args, **kwargs):
        raise _later("TinyTrainSession.score_stream", "10")

    def _check_task(self, task: Task) -> None:
        if task.max_way > self.max_way:
            raise ValueError(f"task {task.name!r} has way {task.max_way} > "
                             f"session max_way {self.max_way}")

    def _sparseupdate_policy(self, budget: Budget,
                             proxy_task: Optional[Task], seed: int
                             ) -> SparseUpdatePolicy:
        """The offline ES policy (Lin et al. 2022) from a *proxy* task."""
        if proxy_task is None:
            raise ValueError(
                "baseline('sparseupdate') needs proxy_task= — the offline "
                "evolutionary search runs on proxy data, never the target")
        key = (budget.mem_bytes, budget.compute_frac,
               budget.channel_ratio, budget.opt_slots, budget.param_bytes,
               id(proxy_task), seed)
        if key not in self._es_cache:
            from .baselines import evolutionary_search_policy
            from .fisher import fisher_probe
            from .protonet import episode_loss

            sup = self._on(proxy_task.support)
            pq = self._on(proxy_task.pseudo_query)

            def probe_loss(p, b, taps=None):
                return episode_loss(self.backbone.features, p, sup, pq,
                                    self.max_way, taps=taps)

            potentials, _, _ = fisher_probe(self.backbone, self.params,
                                            probe_loss, sup,
                                            proxy_task.n_support)
            self._es_cache[key] = (proxy_task, evolutionary_search_policy(
                self.backbone.unit_costs, potentials, budget, iters=400,
                seed=seed))
        return self._es_cache[key][1]

    def _trained(self, method: str, task: Task, x: Any, run, step,
                 iters: int, fused: bool, features) -> Adaptation:
        """A baseline that trains its own tree ``x`` (the whole backbone,
        or TinyTL's adapters) with the baseline optimiser: ``run(x, st, sup,
        pq)`` the fused loop (one fetch), ``step(x, st, sup, pq)`` one eager
        update; ``features(x, batch)`` evaluates the trained tree."""
        st = self.baseline_optimizer.init(x)
        sup, pq = self._on(task.support), self._on(task.pseudo_query)
        t0 = time.perf_counter()
        if fused and iters > 0:
            x, st, loss_arr, skip_arr = run(x, st, sup, pq)
            loss_h, skip_h = _fetch((loss_arr, skip_arr))
            losses = [float(v) for v in loss_h]
            skipped = int(np.sum(skip_h))
        else:
            losses = []
            for _ in range(iters):
                x, st, loss = step(x, st, sup, pq)
                losses.append(_fetch_scalar(loss))
            skipped = sum(1 for v in losses if not np.isfinite(v))
        dt = time.perf_counter() - t0
        mw = self.max_way

        def _eval(s, q, _x=x):
            with torch.no_grad():
                return _fetch_scalar(episode_accuracy(
                    features, _x, self._on(s), self._on(q), mw))

        return Adaptation(
            method=method, task=task, profile=None, budget=None, deltas=x,
            policy=None, fisher_seconds=0.0, train_seconds=dt, losses=losses,
            host_transfers=1 if (fused and iters > 0) else iters,
            _session=self, _eval=_eval, skipped_steps=skipped)

    def _fulltrain(self, task: Task, iters: int,
                   fused: bool = True) -> Adaptation:
        """Every backbone parameter trained, on a private copy: the
        session's frozen params stay as they are."""
        from .baselines import make_full_episode_scan, make_full_episode_step

        feats, opt, mw = (self.backbone.features, self.baseline_optimizer,
                          self.max_way)
        if fused and iters > 0 and iters not in self._full_scans:
            self._full_scans[iters] = make_full_episode_scan(feats, opt, mw,
                                                             iters)
        p = tree_map(lambda t: t.detach().clone(), self.params)
        return self._trained("fulltrain", task, p,
                             self._full_scans.get(iters),
                             make_full_episode_step(feats, opt, mw), iters,
                             fused, feats)

    def _tinytl(self, name: str, task: Task, iters: int, seed: int,
                fused: bool = True) -> Adaptation:
        from .baselines import (
            adapter_dropped_blocks, make_tinytl_episode_scan,
            make_tinytl_episode_step, tinytl_adapter_init, tinytl_features,
        )

        if self.backbone.kind != "cnn":
            raise ValueError("tinytl/adapterdrop baselines are CNN-only")
        cfg, params, opt = self.backbone.cfg, self.params, self.baseline_optimizer
        dropped = adapter_dropped_blocks(cfg, name)
        # drawn on the host: a card run and a CPU run of one seed start
        # from the same adapters
        adapters = tinytl_adapter_init(cfg, torch.Generator().manual_seed(seed),
                                       device=self.device)
        skey = (dropped, iters)
        if fused and iters > 0 and skey not in self._tinytl_scans:
            self._tinytl_scans[skey] = make_tinytl_episode_scan(
                cfg, opt, self.max_way, dropped, iters)
        scan = self._tinytl_scans.get(skey)
        step = make_tinytl_episode_step(cfg, opt, self.max_way, dropped)

        def run(a, st, s, q):
            return scan(params, a, st, s, q)

        return self._trained(
            name, task, adapters, run,
            lambda a, st, s, q: step(params, a, st, s, q), iters, fused,
            lambda a, b: tinytl_features(cfg, params, a, b["images"],
                                         dropped_blocks=dropped))

    def _wrap(self, method: str, task: Task, profile, res: AdaptResult,
              budget: Optional[Budget] = None) -> Adaptation:
        ev = self.step_cache.evaluate(res.policy)
        ci = (self.step_cache.chan_idx_arrays(res.policy, self.device)
              if res.policy is not None else None)

        def _eval(sup, qry, _ev=ev, _ci=ci, _d=res.deltas):
            return _fetch_scalar(_ev(self.params, _d, self._on(sup),
                                     self._on(qry), _ci))

        return Adaptation(
            method=method, task=task, profile=profile, budget=budget,
            deltas=res.deltas, policy=res.policy,
            fisher_seconds=res.fisher_seconds,
            train_seconds=res.train_seconds,
            losses=list(res.losses) if res.losses is not None else [],
            host_transfers=res.host_transfers, _session=self, _eval=_eval,
            skipped_steps=res.skipped_steps)
