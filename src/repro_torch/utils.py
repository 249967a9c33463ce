"""Small helpers shared across the port."""
from __future__ import annotations

from typing import Any, Callable, List, Union

import torch

DeviceLike = Union[str, torch.device]


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
