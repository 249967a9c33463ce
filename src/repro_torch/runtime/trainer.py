"""Fault-tolerant trainer: the port of ``repro.runtime.trainer``.

- **checkpoint/restart**: atomic keep-N checkpoints every ``ckpt_every``
  steps and at the end, carrying whatever the step function carries
  (params or deltas, optimiser state) *and* the data cursor; a restart
  resumes bit for bit on the same device.
- **failure injection**: a hook raising at a chosen step simulates a node
  loss; the trainer restarts from the latest checkpoint and reaches the
  same state as an uninterrupted run.
- **straggler detection**: a per-step wall-time EWMA; steps slower than
  ``straggler_factor`` x the EWMA are counted (a multi-host run would
  re-split the data pipeline's (host_id, n_hosts) shards).
- **NaN guard**: a non-finite loss keeps the previous state and is
  logged; more than ``max_skips`` such steps abort.

The loss is read on the host once a step (the guard and the log need it),
which also bounds each step's wall time.
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..checkpoint import CheckpointManager


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    straggler_factor: float = 3.0
    max_skips: int = 10
    log_every: int = 10


@dataclasses.dataclass
class TrainerState:
    step: int
    train_state: Any  # a tree of tensors: whatever the step function carries
    skipped: int = 0
    straggler_events: int = 0


class Trainer:
    """Runs ``step_fn(train_state, batch) -> (train_state, loss)``."""

    def __init__(
        self,
        cfg: TrainerConfig,
        step_fn: Callable[[Any, Dict], Tuple[Any, Any]],
        loader,
        *,
        failure_hook: Optional[Callable[[int], None]] = None,
        log_fn: Callable[[str], None] = print,
    ):
        self.cfg = cfg
        self.step_fn = step_fn
        self.loader = loader
        self.failure_hook = failure_hook
        self.log = log_fn
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.losses: List[float] = []

    def _save(self, state: TrainerState) -> None:
        self.ckpt.save(
            state.step,
            state.train_state,
            extra={
                "loader": self.loader.state_dict(),
                "skipped": state.skipped,
                "straggler_events": state.straggler_events,
            },
        )

    def _try_restore(self, init_state: Any) -> TrainerState:
        res = self.ckpt.restore_latest(init_state)
        if res is None:
            return TrainerState(step=0, train_state=init_state)
        step, tree, extra = res
        self.loader.load_state_dict(extra["loader"])
        self.log(f"[trainer] restored step {step}")
        return TrainerState(
            step=step, train_state=tree,
            skipped=extra.get("skipped", 0),
            straggler_events=extra.get("straggler_events", 0),
        )

    def run(self, init_state: Any) -> TrainerState:
        state = self._try_restore(init_state)
        ewma: Optional[float] = None
        while state.step < self.cfg.total_steps:
            if self.failure_hook is not None:
                self.failure_hook(state.step)  # may raise SimulatedFailure
            batch = self.loader.next()
            t0 = time.perf_counter()
            new_train_state, loss = self.step_fn(state.train_state, batch)
            loss = float(loss)
            dt = time.perf_counter() - t0
            if ewma is None:
                ewma = dt
            elif dt > self.cfg.straggler_factor * ewma:
                state.straggler_events += 1
                self.log(
                    f"[trainer] straggler step {state.step}: {dt:.3f}s vs "
                    f"ewma {ewma:.3f}s (event #{state.straggler_events})"
                )
            ewma = 0.9 * ewma + 0.1 * dt
            if not math.isfinite(loss):
                state.skipped += 1
                self.log(f"[trainer] non-finite loss at step {state.step}; "
                         "skipping update")
                if state.skipped > self.cfg.max_skips:
                    raise RuntimeError("too many non-finite steps")
                state.step += 1
                continue
            state.train_state = new_train_state
            self.losses.append(loss)
            state.step += 1
            if state.step % self.cfg.log_every == 0:
                self.log(f"[trainer] step {state.step} loss {loss:.4f} "
                         f"({dt*1e3:.0f} ms)")
            if state.step % self.cfg.ckpt_every == 0:
                self._save(state)
        self._save(state)
        return state


class SimulatedFailure(Exception):
    """Raised by failure-injection hooks in fault-tolerance tests."""


def failure_at(step: int) -> Callable[[int], None]:
    """A hook that raises :class:`SimulatedFailure` the first time the
    trainer reaches ``step``."""
    fired = {"done": False}

    def hook(s: int) -> None:
        if s == step and not fired["done"]:
            fired["done"] = True
            raise SimulatedFailure(f"injected failure at step {s}")

    return hook
