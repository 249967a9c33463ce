"""Fleet serving: data-parallel ServeEngine replicas behind one router, and
the wire codec of the personalised delta exchange: the port of
``repro.serving.fleet``.

R :class:`~.engine.ServeEngine` replicas, each pinned to its own device
(round-robin over ``devices``; several replicas may share one card), sit
behind one ``submit()`` / ``run()`` / ``scan_chunks()`` API:

- **Least-loaded routing from host ledgers.**  A replica's load is its
  backlog plus resident streams, ties broken by free pages, all read from
  host-side bookkeeping (``memory_report`` reads no device), so the router
  adds no host sync to a chunk.
- **Sticky uid -> replica placement.**  A user's delta set lives on one
  replica; re-homing (home saturated or dead) migrates the set from the
  router's own registry.
- **Typed shedding only at fleet saturation.**  ``queue_full`` comes back
  only when every alive replica is at its ``queue_limit``.
- **Replica failure = evacuate + re-route.**  ``fail_replica`` pulls the
  replica's whole backlog (queued, staged, requeued and resident) and
  resubmits it; resident streams resume elsewhere through the recompute
  swap, and since sample keys draw on the router's global ``sample_id``,
  a resumed sampled stream draws the same tokens wherever it lands.
- **Parity.**  The router stamps ``sample_id`` with the global submission
  index, the rid a single engine would assign the same submissions, so an
  R-replica run's streams equal one engine's request by request, while
  each replica keeps one host sync a chunk (the engines'
  ``fused_begin/dispatch/drain/finish`` split: every replica dispatched,
  then every replica drained).

:func:`encode_delta_payload` / :func:`decode_delta_payload` carry one
user's int8 error-feedback refresh as real ``np.savez`` bytes, in the JAX
package's layout, so a payload written by either package decodes in the
other, and the compression is measured on an actual payload.
"""
from __future__ import annotations

import io
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..dist.mesh import resolve_devices
from ..utils import DeviceLike, tree_map
from .engine import DeltaSet, Request, ServeEngine, SubmitResult

__all__ = ["FleetRouter", "encode_delta_payload", "decode_delta_payload"]


# ---------------------------------------------------------------------------
# Delta-exchange wire codec
# ---------------------------------------------------------------------------

def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten_strdict(tree: Dict[str, Any], prefix: str = "",
                     out: Optional[Dict[str, np.ndarray]] = None,
                     ) -> Dict[str, np.ndarray]:
    if out is None:
        out = {}
    for k, v in tree.items():
        k = str(k)
        if "/" in k:
            raise ValueError(f"delta tree key {k!r} may not contain '/'")
        if isinstance(v, dict):
            _flatten_strdict(v, prefix + k + "/", out)
        else:
            out[prefix + k] = _host(v)
    return out


def _unflatten_strdict(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def encode_delta_payload(policy: Any, q: Any, scales: Any) -> bytes:
    """One user's compressed refresh as wire bytes.

    ``q`` / ``scales`` are :func:`~..optim.compress.int8_compress`'s int8
    leaves and per-tensor float32 scales, nested like the adaptation
    deltas.  The payload also carries the policy's channel indices, so the
    receiver builds a whole :class:`DeltaSet` without the policy object."""
    payload: Dict[str, np.ndarray] = {}
    for k, v in _flatten_strdict(q).items():
        payload["q/" + k] = v
    for k, v in _flatten_strdict(scales).items():
        payload["s/" + k] = v.astype(np.float32)
    for u in policy.units:
        payload[f"c/L{u.layer}/{u.kind}"] = np.asarray(u.channels, np.int32)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return buf.getvalue()


def decode_delta_payload(payload: bytes) -> DeltaSet:
    """The :class:`DeltaSet` of :func:`encode_delta_payload` bytes; the int8
    codes are decompressed here, on the receiving side, in float32."""
    z = np.load(io.BytesIO(payload))
    parts: Dict[str, Dict[str, np.ndarray]] = {"q": {}, "s": {}, "c": {}}
    for key in z.files:
        tag, rest = key.split("/", 1)
        parts[tag][rest] = z[key]
    deltas = tree_map(
        lambda qi, si: np.asarray(qi, np.float32) * np.float32(si),
        _unflatten_strdict(parts["q"]), _unflatten_strdict(parts["s"]))
    return DeltaSet(deltas=deltas, channels=_unflatten_strdict(parts["c"]))


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


def params_on(params: Any, dev: torch.device) -> Any:
    """``params`` on ``dev``: the tree itself where it already lies there."""
    return tree_map(lambda t: t if t.device == dev else t.to(dev), params)


class FleetRouter:
    """R data-parallel ServeEngine replicas behind one admission layer.

    ``cfg``, ``params``: the shared frozen base; a replica on another device
    than the weights gets its own copy, replicas on one device share one.
    ``replicas``: the engine count, pinned round-robin over ``devices``
    (default every visible CUDA device; with no card and no ``devices=``
    the router raises: pass ``devices=["cpu"]`` for the plain path).
    ``engine_kw`` goes to every :class:`ServeEngine` (slots, paging,
    personalise, queue_limit, faults, admit_backfill, ...); ``fused`` must
    stay True, since the router drives the engines' dispatch/drain
    split."""

    def __init__(self, cfg: Any, params: Any, *, replicas: int = 2,
                 devices: Optional[List[DeviceLike]] = None, **engine_kw):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if not engine_kw.get("fused", True):
            raise ValueError(
                "FleetRouter requires fused engines: the router overlaps "
                "replicas via the dispatch/drain split, which the eager "
                "per-tick path does not expose")
        if "device" in engine_kw:
            raise ValueError("FleetRouter pins its replicas itself: pass "
                             "devices=[...], not device=")
        devs = resolve_devices(devices, "FleetRouter")
        self.cfg = cfg
        self.n_replicas = int(replicas)
        self.devices = [devs[i % len(devs)] for i in range(self.n_replicas)]
        copies: Dict[torch.device, Any] = {}
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = params_on(params, dev)
        self.engines: List[ServeEngine] = [
            ServeEngine(cfg, copies[dev], device=dev, **engine_kw)
            for dev in self.devices]
        self.alive: List[bool] = [True] * self.n_replicas
        self.personalise = self.engines[0].personalise
        self.chunk = self.engines[0].chunk
        self.prefill_block = self.engines[0].prefill_block
        # sticky placement and the router's delta registry, which re-homing
        # and failover migrate from (an engine's registry dies with it)
        self._home: Dict[int, int] = {}
        self._delta_reg: Dict[int, Optional[DeltaSet]] = {}
        self._next_sid = 0  # global submission index -> Request.sample_id
        self._tally: Dict[str, int] = {}
        self.last_run_report: Dict[str, Any] = {}

    # -- load ledger / routing -------------------------------------------

    @property
    def ticks(self) -> int:
        return sum(e.ticks for e in self.engines)

    def backlog_size(self) -> int:
        return sum(e.backlog_size()
                   for e, a in zip(self.engines, self.alive) if a)

    def _first_alive(self) -> int:
        for i, a in enumerate(self.alive):
            if a:
                return i
        raise RuntimeError("no alive replicas in the fleet")

    def _saturated(self, i: int) -> bool:
        eng = self.engines[i]
        return (eng.queue_limit is not None
                and eng.backlog_size() >= eng.queue_limit)

    def _load_key(self, i: int):
        eng = self.engines[i]
        mem = eng.memory_report()
        free = mem.get("pages_free")
        return (eng.backlog_size() + mem["resident_streams"],
                -(free if free is not None else 0), i)

    def _route(self, uid: int) -> Optional[int]:
        open_ = [i for i in range(self.n_replicas)
                 if self.alive[i] and not self._saturated(i)]
        if not open_:
            return None  # fleet-wide saturation: typed queue_full
        home = self._home.get(uid)
        if home is not None and home in open_:
            return home
        i = min(open_, key=self._load_key)
        self._home[uid] = i
        if self.personalise is not None:
            # a re-homed (or first-seen) user's registered deltas move with
            # them, so the new replica serves them personalised at once
            ds = self._delta_reg.get(uid)
            if ds is not None:
                self.engines[i].swap_deltas(uid, ds)
        return i

    # -- admission --------------------------------------------------------

    def submit(self, req: Request) -> SubmitResult:
        """Route one request to its replica: ``queue_full`` only when every
        alive replica is saturated; the global submission index becomes the
        request's ``sample_id``, so its (sampled) stream is the single
        engine's wherever it is placed."""
        self.engines[self._first_alive()]._validate(req)
        if req.sample_id is None:
            req.sample_id = self._next_sid
        self._next_sid += 1
        i = self._route(req.uid)
        if i is None:
            req.outcome = "rejected"
            return SubmitResult(False, "queue_full")
        return self.engines[i].submit(req)

    # -- personalisation boundary ----------------------------------------

    def swap_deltas(self, uid: int, delta_set: Optional[DeltaSet]) -> int:
        """Register the set and hot-swap it on the user's home replica (0
        rows if the user has no home yet: the set installs at first
        routing)."""
        if self.personalise is None:
            raise RuntimeError(
                "fleet was built without personalise=: no delta arenas")
        if delta_set is None:
            self._delta_reg.pop(uid, None)
        else:
            self._delta_reg[uid] = delta_set
        home = self._home.get(uid)
        if home is not None and self.alive[home]:
            return self.engines[home].swap_deltas(uid, delta_set)
        return 0

    def push_delta_payload(self, uid: int, payload: bytes) -> int:
        """The wire boundary: one user's refresh as serialized bytes
        (:func:`encode_delta_payload`), decoded and decompressed on this
        side and hot-swapped on the user's home replica."""
        return self.swap_deltas(uid, decode_delta_payload(payload))

    # -- failure ----------------------------------------------------------

    def fail_replica(self, i: int) -> Dict[str, int]:
        """Replica ``i`` dies: its backlog is evacuated and re-routed.

        Every orphan (queued, staged, requeued or resident) is resubmitted
        through normal routing with its ``sample_id``; resident streams
        resume through the recompute swap.  A resubmission into a saturated
        fleet sheds with ``queue_full``, so every request still reaches
        exactly one terminal outcome.  Returns the re-route accounting."""
        if not (0 <= i < self.n_replicas):
            raise ValueError(f"no replica {i} in a fleet of "
                             f"{self.n_replicas}")
        if not self.alive[i]:
            return {"rerouted": 0, "shed": 0}
        self.alive[i] = False
        if not any(self.alive):
            raise RuntimeError(
                "cannot fail the last alive replica: the fleet would "
                "have nowhere to re-route its backlog")
        self._home = {u: r for u, r in self._home.items() if r != i}
        moved = shed = 0
        for req in self.engines[i].evacuate():
            res = self.submit(req)
            if res.accepted:
                moved += 1
            else:
                shed += 1
                self._tally["rejected"] = self._tally.get("rejected", 0) + 1
        return {"rerouted": moved, "shed": shed}

    # -- serving ----------------------------------------------------------

    def has_work(self) -> bool:
        return any(a and e.has_work()
                   for e, a in zip(self.engines, self.alive))

    def scan_chunks(self, rounds: Optional[int] = None,
                    max_ticks: int = 100_000,
                    chunk: Optional[int] = None) -> int:
        """Drive the fleet: dispatch every replica, then drain every
        replica, until drained, ``rounds`` rounds or ``max_ticks`` ticks a
        replica.  A dispatch issues a replica's chunk without a host read,
        so the replicas' chunks run together while the host makes one
        blocking fetch a replica a round: each replica's one host sync a
        chunk.  Returns the rounds run."""
        for eng, a in zip(self.engines, self.alive):
            if a:
                eng.fused_begin(chunk)
        done_rounds = 0
        while self.has_work():
            if rounds is not None and done_rounds >= rounds:
                break
            handles = []
            for idx, eng in enumerate(self.engines):
                if not self.alive[idx]:
                    continue
                left = max_ticks - eng._frun["used"]
                if left <= 0:
                    continue
                h = eng.fused_dispatch(left)
                if h is not None:
                    handles.append((idx, h))
            if not handles:
                break
            for idx, h in handles:
                self.engines[idx].fused_drain(h)
            done_rounds += 1
        for eng, a in zip(self.engines, self.alive):
            if a:
                eng.fused_finish()
        self._publish_report(done_rounds)
        return done_rounds

    def _publish_report(self, rounds: int) -> None:
        per: List[Dict[str, Any]] = []
        ticks = syncs = chunks = peak = 0
        outcomes = dict(self._tally)
        for idx, eng in enumerate(self.engines):
            rep = dict(eng.last_run_report)
            rep["replica"] = idx
            rep["alive"] = self.alive[idx]
            per.append(rep)
            ticks += rep.get("ticks", 0)
            syncs += rep.get("host_syncs", 0)
            chunks += rep.get("chunks", 0)
            peak += rep.get("peak_resident", 0)
            for k, v in rep.get("outcomes", {}).items():
                outcomes[k] = outcomes.get(k, 0) + v
        self.last_run_report = {
            "ticks": ticks,
            "chunks": chunks,
            "host_syncs": syncs,
            "rounds": rounds,
            "peak_resident": peak,
            "outcomes": outcomes,
            "replicas": per,
            "memory": self.memory_report(),
        }

    def run(self, requests: List[Request], max_ticks: int = 100_000,
            chunk: Optional[int] = None) -> List[Request]:
        """The fleet's :meth:`ServeEngine.run`: validate the whole batch,
        route every submission, scan until drained."""
        ref = self.engines[self._first_alive()]
        for r in requests:
            ref._validate(r)
        self._tally = {}
        for eng, a in zip(self.engines, self.alive):
            if a:
                eng._tally = {}
        for r in requests:
            res = self.submit(r)
            if not res.accepted:
                self._tally["rejected"] = self._tally.get("rejected", 0) + 1
        self.scan_chunks(max_ticks=max_ticks, chunk=chunk)
        return requests

    # -- observability -----------------------------------------------------

    def memory_report(self) -> Dict[str, Any]:
        per = [e.memory_report() for e in self.engines]
        agg: Dict[str, Any] = {
            "replicas": self.n_replicas,
            "alive": int(sum(self.alive)),
            "kv_paging": per[0]["kv_paging"],
            "kv_cache_bytes": sum(m["kv_cache_bytes"] for m in per),
            "resident_streams": sum(m["resident_streams"] for m in per),
            "per_replica": per,
        }
        if "pages_free" in per[0]:
            agg["pages_free"] = sum(m["pages_free"] for m in per)
            agg["pages_in_use"] = sum(m["pages_in_use"] for m in per)
        if "delta_arena_bytes" in per[0]:
            agg["delta_arena_bytes"] = sum(
                m["delta_arena_bytes"] for m in per)
        return agg
