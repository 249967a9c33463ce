"""Small helpers shared across the port: the device an entry point runs
on, and tree helpers over nested dicts, lists and tuples of tensors (the
port of ``repro.utils``'s pytree helpers)."""
from __future__ import annotations

import functools
from typing import Any, Callable, List, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]
PyTree = Any


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on.

    The port's entry points default to ``"cuda"``; on a machine without a
    card that default raises instead of quietly running on the CPU.  Only
    an explicit ``device="cpu"`` runs the plain PyTorch paths.
    ``device="meta"`` builds tensors of shape and dtype only, which
    allocate nothing (the dry run's counterpart of ``jax.eval_shape``):
    the kernel entries send them to their plain versions.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(
            f"unsupported device {str(device)!r} (cuda, cpu or meta)")
    return dev


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict/list/tuple tree, or to
    the matching leaves of several trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict/list/tuple tree, in ``tree_map`` order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def named_tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """:func:`tree_map` that also passes each leaf's key path as its first
    argument, in the JAX package's ``a/b/c`` form (dict keys, list and
    tuple indices)."""

    def walk(path, node, *others):
        if isinstance(node, dict):
            return {k: walk(path + (str(k),), v, *(o[k] for o in others))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(path + (str(i),), *vs)
                              for i, vs in enumerate(zip(node, *others)))
        return fn("/".join(path), node, *others)

    return walk((), tree, *rest)


def tree_size(tree: PyTree) -> int:
    """Total number of scalar elements in a tree of tensors (or arrays)."""
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def tree_bytes(tree: PyTree) -> int:
    """Total bytes of a tree of tensors (or arrays), each in its dtype."""
    return sum(int(np.prod(x.shape)) * (x.element_size() if torch.is_tensor(x)
                                        else np.dtype(x.dtype).itemsize)
               for x in tree_leaves(tree))


def tree_zeros_like(tree: PyTree, dtype=None) -> PyTree:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype),
                    tree)


def tree_cast(tree: PyTree, dtype) -> PyTree:
    return tree_map(lambda x: x.to(dtype), tree)


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_scale(tree: PyTree, s) -> PyTree:
    return tree_map(lambda x: x * s, tree)


def tree_finite(tree: PyTree) -> torch.Tensor:
    """0-dim bool tensor: every element of every leaf is finite (read on
    the leaves' device; nothing is fetched)."""
    leaves = [torch.isfinite(x).all() for x in tree_leaves(tree)]
    return functools.reduce(torch.logical_and, leaves, torch.tensor(
        True, device=leaves[0].device if leaves else None))


def global_norm(tree: PyTree) -> torch.Tensor:
    """The float32 L2 norm of every leaf together."""
    return torch.sqrt(sum(torch.sum(x.float().square())
                          for x in tree_leaves(tree)))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b
