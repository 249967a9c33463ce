"""LR schedules: linear warmup + cosine decay (paper Appendix A.3 style):
the port of ``repro.optim.schedule``.

A schedule maps the optimiser's int32 step tensor to a float32 learning
rate tensor on the step's device, with no host read, so an optimiser
update stays free of device syncs."""
from __future__ import annotations

import math
from typing import Callable

import torch


def warmup_cosine(
    peak: float,
    total_steps: int,
    warmup_steps: int = 0,
    floor: float = 0.0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``peak · step / warmup`` for steps below ``warmup_steps``, then a
    cosine from ``peak`` down to ``floor`` at ``total_steps`` (held there
    after), computed in float32."""

    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak * step / max(warmup_steps, 1)
        prog = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def constant(lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """The same float32 rate at every step."""
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)
