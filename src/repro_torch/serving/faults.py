"""Deterministic fault injection for the serving engine, the port of
``repro.serving.faults``.

A :class:`FaultConfig` is a static plan that both ticks of the engine
read, so the fused chunk loop and the eager loop reproduce a failure at
the same coordinates:

- **NaN logits** at (request id, token index) pairs, the coordinates the
  sampler keys on, so the fault lands on the same emitted token whatever
  the batch neighbours, chunk size or prefill block.  Exercises the
  ``numerics`` outcome.
- **Forced preemption** of request ``rid`` once it has emitted ``k``
  tokens (``k >= 1``): the preempt, release, requeue and resume path
  without an exhausted pool.  It fires at most once per (rid, k): a
  resumed stream carries ``tok_base == k`` and the predicate requires
  ``tok_base < k``.
- **Forced page exhaustion** over a window of global engine ticks: page
  growth is granted nothing, so growing streams stall and the victim
  policy engages.
- **Queue overflow**: a host-side queue-limit override that forces
  ``submit()`` rejections.

With ``ServeEngine(faults=None)`` no tick issues a fault op, and each hook
is issued only when its part of the plan is set.  The window is keyed on
the global tick, a host integer, so :func:`exhausted` of an ``int`` is a
Python bool and reads nothing from the device.

The adapt loop takes the steps whose loss it forces to NaN as its own
``nan_loss_steps`` argument (``core.adapt.adapt_task``,
``TinyTrainSession.adapt``), so this plan holds the serving faults only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

# a slot coordinate: the fused tick's (slots,) tensor or one eager slot's int
Coord = Union[int, bool, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Static fault plan.  Request ids are the engine's, assigned in
    submission order from its ``_next_rid`` (0 on a fresh engine); token
    indices count a request's emitted tokens (the sampler's coordinate)."""

    # (rid, token_index): that emitted token's logits become NaN
    nan_logits: Tuple[Tuple[int, int], ...] = ()
    # (rid, emitted_count >= 1): preempt rid once it has emitted that many
    # tokens (once; a resumed stream carries tok_base == count)
    force_preempt: Tuple[Tuple[int, int], ...] = ()
    # [t0, t1) window of global engine ticks in which page growth is
    # granted no page
    exhaust_ticks: Optional[Tuple[int, int]] = None
    # host-side admission bound override (forces queue-full rejections)
    queue_limit: Optional[int] = None

    def __post_init__(self):
        for r, k in self.force_preempt:
            if k < 1:
                raise ValueError(
                    f"force_preempt needs emitted_count >= 1, got "
                    f"({r}, {k}): a stream that has emitted nothing has "
                    "tok_base == 0 and the once-only predicate "
                    "(tok_base < count) could never arm")
        if self.exhaust_ticks is not None:
            t0, t1 = self.exhaust_ticks
            if t1 <= t0:
                raise ValueError(
                    f"exhaust_ticks window must be non-empty, got "
                    f"[{t0}, {t1})")

    @property
    def any_serving(self) -> bool:
        """Some part of the plan injects a serving fault."""
        return bool(self.nan_logits or self.force_preempt
                    or self.exhaust_ticks is not None
                    or self.queue_limit is not None)


def nan_hit(faults: FaultConfig, rid: Coord, tok_idx: Coord) -> Coord:
    """The slot's next emitted token is a NaN target: (slots,) bool for
    the fused tick's tensors, a bool for one eager slot's ints."""
    hit: Coord = False
    for r, k in faults.nan_logits:
        hit = hit | ((rid == r) & (tok_idx == k))
    return hit


def preempt_hit(faults: FaultConfig, rid: Coord, emitted: Coord,
                tok_base: Coord) -> Coord:
    """Preempt the slot now (tensors or ints, as :func:`nan_hit`).
    ``emitted`` is the loop's count of the tokens emitted so far;
    ``tok_base < k`` makes each (rid, k) fire once."""
    hit: Coord = False
    for r, k in faults.force_preempt:
        hit = hit | ((rid == r) & (emitted == k) & (tok_base < k))
    return hit


def exhausted(faults: FaultConfig,
              gtick: Union[int, torch.Tensor]) -> Union[bool, torch.Tensor]:
    """Whether the global tick lies in the forced-exhaustion window: a
    Python bool for a host tick, a () bool tensor for a device one."""
    if faults.exhaust_ticks is None:
        return False
    t0, t1 = faults.exhaust_ticks
    return (gtick >= t0) & (gtick < t1)


def parse_inject(spec: str) -> FaultConfig:
    """Parse a CLI fault spec into a :class:`FaultConfig`.

    Comma-separated entries::

        nan:RID:TOK       NaN logits for request RID at token index TOK
        pre:RID:COUNT     force-preempt RID after COUNT emitted tokens
        exhaust:T0:T1     zero free pages during engine ticks [T0, T1)
        qlimit:N          cap the host admission queue at N requests

    e.g. ``--inject pre:0:3,nan:2:5,exhaust:10:20``.
    """
    nan: list = []
    pre: list = []
    exhaust = None
    qlimit = None
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        parts = entry.split(":")
        kind, args = parts[0], [int(p) for p in parts[1:]]
        if kind == "nan" and len(args) == 2:
            nan.append(tuple(args))
        elif kind == "pre" and len(args) == 2:
            pre.append(tuple(args))
        elif kind == "exhaust" and len(args) == 2:
            exhaust = tuple(args)
        elif kind == "qlimit" and len(args) == 1:
            qlimit = args[0]
        else:
            raise ValueError(
                f"bad fault spec entry {entry!r}; see "
                "repro_torch.serving.faults.parse_inject for the grammar")
    return FaultConfig(nan_logits=tuple(nan), force_preempt=tuple(pre),
                       exhaust_ticks=exhaust, queue_limit=qlimit)
