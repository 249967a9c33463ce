"""Placement rules: the port of ``repro.dist.sharding``.

:class:`ShardingRules` is the TP/DP placement planner of every registered
arch: for params, deltas, optimiser state, batches and caches it answers
"where does this tensor live" on a ("data", "model") or ("pod", "data",
"model") mesh, with the JAX package's divisibility guards and rules line
for line.  The port runs no SPMD partitioner, so its trees of specs are
what the dry run reads: each leaf's per-device shape
(:meth:`ShardingRules.shard_shape`), hence its bytes on one device.

:class:`FleetShardingRules` is the fleet's task-axis placement.
``TinyTrainSession.adapt_many`` stacks N tasks' episodes and channel
indices along a leading task axis.  On a mesh these rules split that axis
over the mesh's data axes (every axis but ``model``) while the frozen
weights are copied once to each device: a :class:`TaskShards` holds one
contiguous block of rows a data position, on that position's device, and a
:class:`Replicas` one copy of a broadcast tree a distinct device.
:func:`map_shards` runs a function once a shard, and :func:`gather_tasks`
joins the shards' results along the task axis again.

Specs stay plain tuples (None | axis name | tuple of axes a dimension), as
in the JAX package, so the rules are testable against a mesh-shaped fake
(``axis_names`` and an axis -> size ``shape``) without devices.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models.api import ArchConfig
from ..utils import named_tree_map, tree_leaves, tree_map

Spec = Tuple[Any, ...]


def _dp_axes(mesh: Any) -> Tuple[Tuple[str, ...], int]:
    """(data axes, data size) of a mesh: every axis but 'model'.  A
    pure-'model' mesh has no data axis and a data size of 1."""
    axes = tuple(a for a in mesh.axis_names if a != "model")
    if not axes:
        return (), 1
    shape = dict(mesh.shape)
    return axes, int(np.prod([shape[a] for a in axes]))


class TaskShards(list):
    """A task-stacked tree split along its task axis: item ``i`` is the
    tree of data position ``i``'s contiguous rows, on its device."""


class Replicas(dict):
    """A broadcast tree, one copy a distinct device (device -> tree); the
    device that already holds it shares the original."""

    def on(self, device: torch.device) -> Any:
        return self[device]

    def first(self) -> Any:
        return next(iter(self.values()))


def _to(x: Any, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def _device_of(tree: Any) -> torch.device:
    return next(t.device for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor))


class FleetShardingRules:
    """Task-axis data-parallel placement for fleet adaptation.

    A task count that does not divide the data size is replicated rather
    than split (callers pad the task axis to :meth:`padded_count`), as in
    the JAX package; placing a replicated tree puts it whole on the mesh's
    first device, where the fleet runs it as one shard."""

    def __init__(self, mesh: Any):
        self.mesh = mesh
        self.dp, self.dp_size = _dp_axes(mesh)

    # -- specs -------------------------------------------------------------

    def task_spec(self, ndim: int, n_tasks: int) -> Spec:
        """Leading-axis spec of one task-stacked leaf; () when the task
        count does not divide the data size (replicate, never error)."""
        if not ndim or not self.dp or n_tasks % self.dp_size:
            return ()
        axis = self.dp if len(self.dp) > 1 else self.dp[0]
        return (axis,) + tuple(None for _ in range(ndim - 1))

    def padded_count(self, n_tasks: int) -> int:
        """Smallest multiple of the data size >= ``n_tasks``."""
        if self.dp_size <= 1:
            return n_tasks
        return -(-n_tasks // self.dp_size) * self.dp_size

    def host_blocks(self, n_padded: int, n_hosts: int):
        """Contiguous ``[lo, hi)`` blocks of the padded task axis, one a
        host: host ``h`` builds only rows ``lo..hi``, and those rows land on
        host ``h``'s positions when the axis splits in mesh order.
        ``n_padded`` must split evenly over the hosts."""
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        if n_padded % n_hosts:
            raise ValueError(
                f"padded task count {n_padded} does not split over "
                f"{n_hosts} hosts")
        blk = n_padded // n_hosts
        return [(h * blk, (h + 1) * blk) for h in range(n_hosts)]

    def replicated(self, tree: Any) -> Any:
        """The placement spec of every leaf of a broadcast tree (frozen
        params, shared taps): ``()``, whole on every data position."""
        return tree_map(lambda x: (), tree)

    def tasks(self, tree: Any) -> Any:
        """The placement spec of every leaf of a task-stacked tree
        (episodes, channel indices, valid counts): :meth:`task_spec` of its
        rank and leading size."""

        def spec(x):
            ndim = len(np.shape(x))
            return self.task_spec(ndim, int(np.shape(x)[0]) if ndim else 0)

        return tree_map(spec, tree)

    # -- placement (needs a Mesh with devices) -----------------------------

    def shard_devices(self) -> List[torch.device]:
        """The device of each data position, in the task axis's order: the
        position at 'model' coordinate 0 of each data coordinate."""
        names = self.mesh.axis_names
        out = []
        for idx in itertools.product(*(range(s) for s in self.mesh.sizes)):
            if all(i == 0 for a, i in zip(names, idx) if a == "model"):
                out.append(self.mesh.device_at(idx))
        return out

    def _bounds(self, n: int) -> List[Tuple[int, int]]:
        blk = n // self.dp_size
        return [(i * blk, (i + 1) * blk) for i in range(self.dp_size)]

    def place_tasks(self, tree: Any) -> Any:
        """A task-stacked tree (numpy arrays or tensors) split over the
        data positions, each block on its device; a tree whose task count
        does not split is placed whole on the first device."""
        n = int(np.shape(tree_leaves(tree)[0])[0])
        devs = self.shard_devices()
        if not self.task_spec(1, n):
            return tree_map(lambda x: _to(x, devs[0]), tree)
        return TaskShards(
            tree_map(lambda x, _lo=lo, _hi=hi, _d=d: _to(x[_lo:_hi], _d),
                     tree)
            for (lo, hi), d in zip(self._bounds(n), devs))

    def place_replicated(self, tree: Any) -> Any:
        """A broadcast tree copied once to each distinct device of the data
        positions (the tree itself on a pure-'model' mesh, on its first
        device)."""
        devs = self.shard_devices()
        if not self.dp:
            return tree_map(lambda x: _to(x, devs[0]), tree)
        return Replicas((d, tree_map(lambda x, _d=d: _to(x, _d), tree))
                        for d in dict.fromkeys(devs))

    def assemble_tasks(self, blocks: Sequence[Any]) -> Any:
        """Task shards from per-host blocks (:meth:`host_blocks`), each
        position's rows cut from the block of the host that owns them: no
        host's block is joined with another's, the ingestion contract of a
        multi-process mesh (here one process over groups of positions)."""
        n_hosts = len(blocks)
        blk = int(np.shape(tree_leaves(blocks[0])[0])[0])
        n = blk * n_hosts
        devs = self.shard_devices()
        if not self.task_spec(1, n):
            return self.place_tasks(tree_map(
                lambda *xs: np.concatenate([np.asarray(x) for x in xs]),
                *blocks))
        shards = TaskShards()
        for (lo, hi), d in zip(self._bounds(n), devs):
            h, off = divmod(lo, blk)
            if hi > (h + 1) * blk:
                raise ValueError(
                    f"task rows {lo}..{hi} straddle host blocks of {blk}; "
                    "the hosts must divide the data size")
            shards.append(tree_map(
                lambda x, _o=off, _w=hi - lo, _d=d: _to(x[_o:_o + _w], _d),
                blocks[h]))
        return shards


class ShardingRules:
    """TP/DP placement of one arch on one mesh (``axis_names`` and an axis
    -> size ``shape``: the port's :class:`~.mesh.Mesh` or a mesh-shaped
    fake).  A dimension that does not divide its axis is replicated:

    - attention q/o projections shard over heads (TP) when heads divide;
    - MLP / SSM inner dims shard over 'model' when they divide;
    - MoE experts shard over 'model' (EP), over ('model', *data) for
      full-EP archs whose expert count covers the whole mesh (deepseek),
      else the per-expert FFN dim shards (expert-TP);
    - vocab/embedding shards only when the vocab divides;
    - ``seq_parallel=True`` replicates block weights and shards the
      *sequence* dim of the batch over 'model' instead.

    The tree methods return trees of specs (the JAX package's trees of
    ``NamedSharding``)."""

    def __init__(self, cfg: ArchConfig, mesh: Any, *,
                 seq_parallel: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.seq_parallel = seq_parallel
        self.sizes = dict(mesh.shape)
        self.tp = int(self.sizes.get("model", 1))
        self.dp, self.dp_size = _dp_axes(mesh)

    # -- divisibility guards ----------------------------------------------

    @property
    def shard_q_heads(self) -> bool:
        return self.cfg.n_heads > 0 and self.cfg.n_heads % self.tp == 0

    @property
    def shard_ffn(self) -> bool:
        return self.cfg.d_ff > 0 and self.cfg.d_ff % self.tp == 0

    @property
    def shard_vocab(self) -> bool:
        return self.cfg.vocab % self.tp == 0

    @property
    def shard_ssm(self) -> bool:
        return (self.cfg.ssm_state > 0 and self.cfg.ssm_head_dim > 0
                and self.cfg.n_ssm_heads % self.tp == 0)

    @property
    def shard_experts(self) -> bool:
        return self.cfg.n_experts > 0 and self.cfg.n_experts % self.tp == 0

    @property
    def shard_experts_full(self) -> bool:
        """Full EP: experts cover the whole mesh (model x data)."""
        return (self.cfg.n_experts > 0
                and self.cfg.n_experts % (self.tp * self.dp_size) == 0)

    @property
    def shard_expert_ffn(self) -> bool:
        return self.cfg.d_expert > 0 and self.cfg.d_expert % self.tp == 0

    # -- per-tensor specs --------------------------------------------------

    def param_spec(self, name: str, shape: Sequence[int]) -> Spec:
        """Placement of one named parameter; replicated unless matched."""
        none: Spec = tuple(None for _ in shape)
        parts = name.split("/")
        leaf = parts[-1]
        module = parts[-2] if len(parts) > 1 else ""

        if leaf in ("embed", "unembed", "lm_head") or name == "embed":
            if self.shard_vocab and len(shape) >= 1:
                return ("model",) + none[1:]
            return none
        if self.seq_parallel and name.startswith("stacks"):
            # SP replicates block weights; activations shard on sequence
            return none
        if module == "attn":
            if not self.shard_q_heads:
                return none
            if leaf in ("wq", "w_uq"):
                return none[:-1] + ("model",)
            if leaf == "wo":
                return none[:-2] + ("model", None)
            return none
        if module == "mlp":
            if not self.shard_ffn:
                return none
            if leaf in ("w_gate", "w_up"):
                return none[:-1] + ("model",)
            if leaf == "w_down":
                return none[:-2] + ("model", None)
            return none
        if module == "moe":
            if leaf not in ("w_gate", "w_up", "w_down") or len(shape) < 4:
                return none
            if self.shard_experts_full:
                return (None, ("model",) + self.dp) + none[2:]
            if self.shard_experts:
                return (None, "model") + none[2:]
            if self.shard_expert_ffn:
                if leaf == "w_down":
                    return none[:-2] + ("model", None)
                return none[:-1] + ("model",)
            return none
        if module == "ssm":
            if not self.shard_ssm:
                return none
            if leaf in ("w_x", "w_z"):
                return none[:-1] + ("model",)
            if leaf == "w_out":
                return none[:-2] + ("model", None)
            return none
        return none

    def delta_spec(self, name: str, shape: Sequence[int]) -> Spec:
        """Placement of one delta leaf (no layer-stack dim): the selected-
        channel dim, where the full weight carries its TP dim, shards over
        'model' when it divides."""
        none: Spec = tuple(None for _ in shape)
        leaf = name.split("/")[-1]
        if not shape:
            return none
        if leaf in ("w_down", "w_out", "wo") and shape[0] % self.tp == 0:
            return ("model",) + none[1:]
        if shape[-1] % self.tp == 0:
            return none[:-1] + ("model",)
        return none

    def _dp_axis(self) -> Any:
        return self.dp if len(self.dp) > 1 else (self.dp[0] if self.dp
                                                 else None)

    def batch_spec(self) -> Dict[str, Spec]:
        """(batch, seq) placement for token batches."""
        spec = (self._dp_axis(), "model" if self.seq_parallel else None)
        return {"tokens": spec, "labels": spec}

    def shard_shape(self, spec: Spec, shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's block of a leaf of ``shape`` under ``spec``: each
        dimension divided by the product of its axes' sizes
        (``NamedSharding.shard_shape``); a dimension they do not divide
        raises."""
        out = []
        for i, n in enumerate(shape):
            ax = spec[i] if i < len(spec) else None
            axes = () if ax is None else (ax if isinstance(ax, tuple)
                                          else (ax,))
            k = int(np.prod([self.sizes[a] for a in axes])) if axes else 1
            if n % k:
                raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                                 f"split over {axes} ({k})")
            out.append(int(n) // k)
        return tuple(out)

    # -- trees of specs ----------------------------------------------------

    def params(self, params: Any) -> Any:
        return named_tree_map(
            lambda name, x: self.param_spec(name, x.shape), params)

    def deltas(self, deltas: Any) -> Any:
        return named_tree_map(
            lambda name, x: self.delta_spec(name, x.shape), deltas)

    def opt_state(self, opt_shapes: Any, deltas_sh: Any = None) -> Any:
        # moment tensors mirror their delta leaves; scalars replicate
        return named_tree_map(
            lambda name, x: (self.delta_spec(name, x.shape)
                             if getattr(x, "ndim", 0) else ()),
            opt_shapes)

    def batch(self, batch: Any) -> Any:
        dp_axis = self._dp_axis()

        def spec(name, x):
            ndim = len(x.shape)
            if ndim == 0:
                return ()
            s = [None] * ndim
            if dp_axis is not None and int(x.shape[0]) % self.dp_size == 0:
                s[0] = dp_axis
            if self.seq_parallel and ndim >= 2 and x.shape[1] % self.tp == 0:
                s[1] = "model"
            return tuple(s)

        return named_tree_map(spec, batch)

    def caches(self, caches: Any, seq_sharded: bool = False) -> Any:
        """KV/state caches: batch-sharded over data; optionally the seq dim
        over 'model' for batch=1 long-context cells."""

        def spec(name, x):
            ndim = len(x.shape)
            s = [None] * ndim
            # stacked cache leaves are (L, B, ...); len leaves (B,)/(L, B)
            if name.endswith("len"):
                return tuple(s)
            if ndim >= 2:
                if seq_sharded and ndim >= 3 and x.shape[2] % self.tp == 0:
                    s[2] = "model"
                elif self.dp and x.shape[1] % self.dp_size == 0:
                    s[1] = self._dp_axis()
            return tuple(s)

        return named_tree_map(spec, caches)


def map_shards(fn: Callable, *args: Any) -> Any:
    """``fn`` once a shard of the :class:`TaskShards` arguments, each
    :class:`Replicas` argument taken on that shard's device and any other
    argument as it is; a :class:`TaskShards` of the results.  With no
    sharded argument, one plain call (replicas on their first device)."""
    n = next((len(a) for a in args if isinstance(a, TaskShards)), None)
    if n is None:
        return fn(*(a.first() if isinstance(a, Replicas) else a
                    for a in args))
    out = TaskShards()
    for i in range(n):
        dev = _device_of(next(a[i] for a in args
                              if isinstance(a, TaskShards)))
        out.append(fn(*(a[i] if isinstance(a, TaskShards)
                        else a.on(dev) if isinstance(a, Replicas) else a
                        for a in args)))
    return out


def gather_tasks(shards: Any, device: Any = None) -> Any:
    """The task-stacked tree of a :class:`TaskShards`: every leaf joined
    along the task axis (tensors on ``device``, by default the first
    shard's; numpy leaves as numpy).  Anything else passes through."""
    if not isinstance(shards, TaskShards):
        return shards

    def cat(*xs):
        if isinstance(xs[0], torch.Tensor):
            dev = xs[0].device if device is None else device
            return torch.cat([x.to(dev) for x in xs])
        return np.concatenate(xs)

    return tree_map(cat, *shards)

