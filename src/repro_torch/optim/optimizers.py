"""SGD, momentum, Adam, ``clip_by_global_norm`` and ``apply_updates``: the
port of ``repro.optim.optimizers``.

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


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else None)


def _lr_at(lr, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def sgd(lr) -> Optimizer:
    """Plain SGD: ``u = -lr · g``; ``lr`` a number or a function of the
    (1-based) step tensor."""

    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        return tree_map(lambda g: -lr_t * g, grads), {"step": step}

    return Optimizer(init, update, slots=0)


def momentum(lr, beta: float = 0.9) -> Optimizer:
    """Heavy-ball momentum, ``mu = beta · mu + g``, ``u = -lr · mu`` in
    float32, the buffer stored in each parameter's dtype."""

    def init(params):
        return {"step": _step0(params),
                "mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        mu = tree_map(lambda m, g: (beta * m.to(g.dtype) + g).to(m.dtype),
                      state["mu"], grads)
        upd = tree_map(lambda m: -lr_t * m.float(), mu)
        return upd, {"step": step, "mu": mu}

    return Optimizer(init, update, slots=1)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam with the moments stored in each parameter's dtype.  (The JAX
    package's weight decay, moment dtype and lr schedules have no caller
    in the port.)"""

    def init(params):
        return {"step": _step0(params),
                "m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}

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


def clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    """``opt`` with the gradients scaled by ``min(1, max_norm / (‖g‖ +
    1e-9))``, ‖g‖ the float32 norm of every leaf together."""

    def update(grads, state, params):
        leaves = tree_leaves(grads)
        gn = torch.sqrt(sum(torch.sum(g.float().square()) for g in leaves))
        scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update, slots=opt.slots)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)

