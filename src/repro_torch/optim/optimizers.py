"""Adam and ``apply_updates``: the port of ``repro.optim.optimizers``.

The same optax-like surface: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, with updates added
to params.  Trees are nested dicts of tensors.  The moment math is float32
whatever the parameter dtype, and the moments are stored in the
parameter's dtype, as in the JAX package's default.
Pure functions: nothing is updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from ..utils import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], Tuple[PyTree, PyTree]]
    slots: int = 0  # state tensors per param (for the memory cost model)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with the moments stored in each parameter's dtype.  (The JAX
    package's weight decay, moment dtype and lr schedules have no caller
    in the port yet: ROADMAP queue 1, item 8.)"""

    def init(params):
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None

        def z(p):
            return torch.zeros_like(p)

        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        def upd_m(m, g):
            return (b1 * m.float() + (1 - b1) * g.float()).to(m.dtype)

        def upd_v(v, g):
            g = g.float()
            return (b2 * v.float() + (1 - b2) * g * g).to(v.dtype)

        m = tree_map(upd_m, state["m"], grads)
        v = tree_map(upd_v, state["v"], grads)

        def step_fn(m_, v_, p):
            u = -lr * (m_.float() / c1) / (torch.sqrt(v_.float() / c2) + eps)
            return u.to(p.dtype)

        upd = tree_map(step_fn, m, v, params)
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update, slots=2)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)

