"""Online personalisation, closing the adapt -> serve loop: the port of
``repro.serving.personalise``.

Adaptation emits sparse per-unit delta packs and the engine consumes the
same packs per resident slot (``ServeEngine(personalise=policy)``), so
refreshing a user while their streams are live takes three steps between
serving chunks:

1. **observe**: finished streams (prompt + emitted tokens) accumulate per
   user, that user's corpus.
2. **refresh**: each user with enough finished streams gets an episode
   built from their own streams (each recent stream is one class; the
   augmentation pipeline re-rolls token spans into pseudo-queries), and
   the whole cohort adapts in one ``TinyTrainSession.adapt_many`` pass
   under the serving policy (``policy_override``, so every delta set has
   the arena template's structure).
3. **hot swap**: each fresh delta set goes through the int8 error-feedback
   compressor (``optim.compress``: int8 codes and one float32 scale per
   tensor, the hand-written grad_quant kernel on the card; the residual is
   kept per user and re-added at the next refresh, so the exchange stays
   unbiased over rounds) and ``ServeEngine.swap_deltas`` installs it in the
   user's resident arena rows, mid-stream and without a host read.

``Personaliser.run_online`` serves one chunk, observes, refreshes and
repeats; ``last_report`` records the payload bytes (int8 + scales against
float32), the adapt and swap times and the resident rows swapped.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.policy import SparseUpdatePolicy
from ..optim import compress as C
from ..utils import tree_leaves
from .engine import DeltaSet, Request

__all__ = ["Personaliser"]


def _payload_bytes(tree: Any) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


class Personaliser:
    """Per-user delta refresh for a personalised ServeEngine.

    ``session`` is a ``TinyTrainSession`` over the backbone config the
    engine serves, with the same frozen weights; ``engine`` a
    ``ServeEngine`` built with ``personalise=policy``; ``policy`` the
    serving policy, passed to ``adapt_many`` as ``policy_override``.  A user
    becomes eligible once ``min_streams`` (at least 2: an episode needs two
    classes) of their streams have finished since their last refresh.
    Episodes are built at ``seq`` tokens (streams are wrapped with
    ``np.resize``) so every user's episode buckets together.  With
    ``compress`` (default) the exchange goes through
    ``int8_compress``/``int8_decompress`` with a residual kept per user;
    without, deltas swap in at full precision (payload ratio 1.0).
    ``refresh_cap`` bounds the users refreshed per between-chunks window:
    eligible users rank by stale-delta age (windows since their last
    refresh) times banked streams and the rest defer; None refreshes every
    eligible user."""

    def __init__(
        self,
        session: Any,
        engine: Any,
        policy: SparseUpdatePolicy,
        *,
        profile: Any = "jetson-nano",
        criterion: str = "tinytrain",
        iters: int = 8,
        min_streams: int = 2,
        max_way: int = 4,
        shots: int = 4,
        seq: int = 32,
        compress: bool = True,
        refresh_cap: Optional[int] = None,
        seed: int = 0,
    ):
        if engine.personalise is None:
            raise ValueError(
                "engine must be constructed with personalise=<policy>; "
                "a non-personalised engine has no delta arena to swap into")
        if hasattr(engine, "push_delta_payload"):
            raise NotImplementedError(
                "the FleetRouter wire exchange (push_delta_payload, "
                "encode_delta_payload) arrives with ROADMAP queue 1, item 16")
        self.session = session
        self.engine = engine
        self.policy = policy
        self.profile = profile
        self.criterion = criterion
        self.iters = int(iters)
        self.min_streams = max(2, int(min_streams))
        self.max_way = int(max_way)
        self.shots = max(1, int(shots))
        self.seq = int(seq)
        self.compress = bool(compress)
        if refresh_cap is not None and int(refresh_cap) < 1:
            raise ValueError(
                f"refresh_cap must be >= 1 users per window, got "
                f"{refresh_cap} (None disables the cap)")
        self.refresh_cap = None if refresh_cap is None else int(refresh_cap)
        self._rng = np.random.default_rng(seed)
        # per-user state: finished-stream corpus, error-feedback residual
        self._streams: Dict[int, List[np.ndarray]] = {}
        self._ef: Dict[int, Any] = {}
        self._seen: set = set()
        # refresh-scheduling clocks: between-chunks windows elapsed and each
        # user's last refreshed window (0 = never)
        self._window = 0
        self._last_refresh: Dict[int, int] = {}
        self.refreshes = 0
        self.last_report: Dict[str, Any] = {}

    # -- observe ----------------------------------------------------------

    def observe(self, requests: List[Request]) -> int:
        """Bank finished streams (prompt + emitted tokens) per user.
        Idempotent per request object; returns how many were banked."""
        n = 0
        for r in requests:
            if not r.done or id(r) in self._seen:
                continue
            self._seen.add(id(r))
            if not r.out:  # rejected or shed streams carry no signal
                continue
            toks = np.concatenate([
                np.asarray(r.prompt, np.int32).reshape(-1),
                np.asarray(r.out, np.int32),
            ])
            self._streams.setdefault(r.uid, []).append(toks)
            n += 1
        return n

    # -- refresh ----------------------------------------------------------

    def _episode(self, uid: int):
        """Episode from the user's own streams: each recent stream is one
        class; support rows are copies the augmentation re-rolls into
        pseudo-queries."""
        from ..data import Episode

        streams = self._streams[uid][-self.max_way:]
        way = len(streams)
        rows = np.stack([np.resize(t, self.seq) for t in streams])
        sup_t = np.repeat(rows, self.shots, axis=0)
        sup_l = np.repeat(np.arange(way, dtype=np.int32), self.shots)
        return Episode(
            support={"tokens": sup_t.astype(np.int32),
                     "episode_labels": sup_l},
            query={"tokens": rows.astype(np.int32),
                   "episode_labels": np.arange(way, dtype=np.int32)},
            n_way=way,
            domain=f"user{uid}",
        )

    def refresh(self) -> Dict[str, Any]:
        """Adapt every refresh-eligible user and hot-swap their arena rows.

        One ``adapt_many`` pass covers the cohort; each result's deltas
        make the exchange round trip (int8 + per-tensor scales, persistent
        error feedback) before ``swap_deltas`` installs them.  Returns (and
        keeps in ``last_report``) the round's accounting; an empty dict
        means no user was eligible."""
        from ..core.session import Task

        self._window += 1
        eligible = sorted(u for u, s in self._streams.items()
                          if len(s) >= self.min_streams)
        if not eligible:
            return {}
        deferred: List[int] = []
        if self.refresh_cap is not None and len(eligible) > self.refresh_cap:
            # the score is stale-delta age x banked streams, so a
            # long-starved light user eventually outranks a heavy fresh one
            def score(u: int) -> int:
                age = max(1, self._window - self._last_refresh.get(u, 0))
                return age * len(self._streams[u])

            ranked = sorted(eligible, key=lambda u: (-score(u), u))
            uids = sorted(ranked[:self.refresh_cap])
            deferred = sorted(ranked[self.refresh_cap:])
        else:
            uids = eligible
        tasks = [Task.from_episode(self._episode(u), self._rng,
                                   getattr(self.session, "max_way", 16),
                                   name=f"user{u}")
                 for u in uids]
        t0 = time.perf_counter()
        results = self.session.adapt_many(
            tasks, self.profile, criterion=self.criterion,
            iters=self.iters, policy_override=self.policy)
        adapt_s = time.perf_counter() - t0

        users, raw_b, wire_b, swapped, swap_s = [], 0, 0, 0, 0.0
        for uid, ad in zip(uids, results):
            deltas = ad.deltas
            raw = 4 * sum(t.numel() for t in tree_leaves(deltas))
            if self.compress:
                ef = self._ef.get(uid)
                if ef is None:
                    ef = C.ef_state_init(deltas)
                q, scales, ef = C.int8_compress(deltas, ef)
                self._ef[uid] = ef  # the residual survives to the next round
                wire = _payload_bytes(q) + 4 * len(tree_leaves(scales))
                deltas = C.int8_decompress(q, scales)
            else:
                wire = raw
            ds = DeltaSet.from_policy(self.policy, deltas)
            t1 = time.perf_counter()
            swapped += self.engine.swap_deltas(uid, ds)
            swap_s += time.perf_counter() - t1
            raw_b += raw
            wire_b += wire
            users.append(uid)
            self._last_refresh[uid] = self._window
            self._streams[uid] = []  # corpus consumed by this refresh

        self.refreshes += 1
        self.last_report = {
            "round": self.refreshes,
            "users": users,
            "deferred_users": deferred,
            "window": self._window,
            "adapt_seconds": adapt_s,
            "swap_seconds": swap_s,
            "resident_rows_swapped": swapped,
            "payload_bytes_f32": raw_b,
            "payload_bytes_wire": wire_b,
            "payload_ratio": raw_b / max(1, wire_b),
            "wire_serialized": False,
        }
        return self.last_report

    # -- online loop ------------------------------------------------------

    def run_online(self, requests: List[Request], *,
                   ticks_per_round: Optional[int] = None,
                   max_rounds: int = 10_000) -> Dict[str, Any]:
        """Serve ``requests`` to completion, refreshing between chunks.

        Each round runs one engine chunk, banks the streams that finished
        and hot-swaps any eligible user's deltas; adaptation happens only
        between chunks, so the engine's chunks are untouched.  Returns a
        summary."""
        chunk = int(ticks_per_round or self.engine.chunk)
        pending: List[Request] = list(requests)
        rounds, ticks, syncs, history = 0, 0, 0, []
        while rounds < max_rounds:
            self.engine.run(pending, max_ticks=chunk, chunk=chunk)
            pending = []
            rep = self.engine.last_run_report
            ticks += rep.get("ticks", 0)
            syncs += rep.get("host_syncs", 0)
            self.observe(requests)
            r = self.refresh()
            if r:
                history.append(r)
            rounds += 1
            # every request at a typed terminal outcome ends the loop
            if all(q.terminal for q in requests):
                break
        return {
            "rounds": rounds,
            "ticks": ticks,
            "host_syncs": syncs,
            "refreshes": history,
            "all_done": all(q.done for q in requests),
        }
