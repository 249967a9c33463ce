"""Serving engine: continuous batching over per-slot KV caches, the port of
``repro.serving.engine`` for the serving slices.

Per-slot request state (feed buffer, cursor, position, last token,
remaining ``max_new`` budget, KV budget, pages held, deadline, active
flag) lives in fixed-shape device tensors (:class:`SlotState`), and a
chunk of ticks runs the JAX package's fused tick body: free slots admit
from a device-side :class:`PendingBuffer` in FIFO order, one forward runs
— a ``prefill_block`` of up to ``prefill_block`` prompt tokens per
prefilling slot while any slot is still prefilling, else a single-token
``decode_step`` — and the lifecycle advances (greedy pick, emits, budgets,
truncation, deadlines and the non-finite ``numerics`` guard), evicting
finished slots so the next tick re-admits into them.  Generating slots
pause during block ticks, so every generated token comes from the
single-token decode program whatever the block size.

**Paged KV cache** (``kv_paging=True``, ``serving/paging.py``): slots draw
pages from one pool instead of owning a ``max_len`` stripe.  Admission is
priced in pages (the cumsum of demand against the free count, FIFO with
head-of-line blocking) and reserves on the device; termination releases.
Under ``reserve="asyougo"`` (the default) admission reserves the prompt's
pages only and a generating slot claims its next page in the tick
(oldest request first while the free-list lasts).  A slot that gets no
page stalls: the tick goes through the block program with the stalled
slots paused, and the youngest resident is preempted (pages released,
slot freed).  The host requeues it with its prompt plus generated prefix
for a recompute swap, so a resumed stream equals the unpreempted one;
``preempt_budget`` bounds the requeues (outcome ``preempted`` past it),
and a resident-tick ledger carries a deadline across preemptions.  All
of it runs on the device: paging adds no host read.

Host syncs: JAX branches and loops on the device (``lax.cond``,
``lax.while_loop``); eager PyTorch has no sync-free counterpart.  So each
tick reads one small flag tensor — the loop's early-exit test and the
block-vs-decode choice — and each chunk reads its event rows once.  Every
read goes through ``core.adapt._fetch``, so ``last_run_report
["host_syncs"]`` counts them all.  One sync per chunk is ROADMAP queue 1,
item 11.2.

**Online personalisation** (``personalise=SparseUpdatePolicy``): instead
of one folded parameter copy per user, the engine keeps a per-slot delta
arena, ``{layer: {kind: (delta_pack, channel_idx)}}`` with a leading slot
axis, that the forward applies as per-slot effective weights
(``models.overlay.slot_params``) on the policy's layers.  A zero row is
the base model, so an unknown user serves unpersonalised.  A request
takes its user's registered :class:`DeltaSet` at first staging and keeps
it through preemption and requeue; admission parks it in the slot's
arena row inside the tick.  :meth:`ServeEngine.swap_deltas` registers a
user's refreshed deltas and rewrites that user's resident rows between
chunks with one masked select: no drain, no host read.  A request that
carries deltas to an engine without a policy is rejected with the typed
reason ``unexpected_delta_set``.

Sampling, the eager loop, faults, backfill and encoder runs arrive with
later slices; their knobs raise ``NotImplementedError`` naming the ROADMAP
item.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import adapt as _telemetry
from ..models import overlay as OV
from ..models import transformer as T
from ..models.api import ArchConfig
from ..utils import DeviceLike, resolve_device, tree_leaves, tree_map
from . import paging as PG

# structured terminal outcomes, emitted through the per-tick event rows
# (int32 codes) and surfaced as Request.outcome strings; the codes are the
# JAX package's
OUTCOME_NONE = 0        # slot still running
OUTCOME_DONE = 1        # reached max_new
OUTCOME_TRUNCATED = 2   # evicted by its KV budget with max_new unmet
OUTCOME_EXPIRED = 3     # deadline_ticks resident-tick budget exhausted
OUTCOME_REQUEUED = 4    # preempted with retry budget left (not terminal)
OUTCOME_PREEMPTED = 5   # preempted with no retry budget left (terminal)
OUTCOME_NUMERICS = 6    # non-finite logits on an emitting row

OUTCOME_NAMES = {
    OUTCOME_DONE: "done", OUTCOME_TRUNCATED: "truncated",
    OUTCOME_EXPIRED: "expired", OUTCOME_PREEMPTED: "preempted",
    OUTCOME_NUMERICS: "numerics",
}

# ttl sentinel for requests without a deadline: never reaches zero
# within any realistic run (2^30 resident ticks)
_NO_DEADLINE = 1 << 30


@dataclasses.dataclass
class DeltaSet:
    """One user's adapted deltas in serving form.

    ``deltas`` is the adaptation-side delta tree (``{"L{layer}": {kind:
    {weight: tensor}}}``, what ``TinyTrainSession.adapt`` returns) and
    ``channels`` the per-unit selected channel indices in the same nesting.
    :meth:`from_policy` builds ``channels`` from the policy that produced
    the deltas.  Leaves stay tensors wherever they lie (numpy leaves become
    CPU tensors), so building a set and staging it never read the device;
    the engine moves them to its own device."""

    deltas: Dict[str, Dict[str, Any]]
    channels: Dict[str, Dict[str, Any]]

    def __post_init__(self):
        self.deltas = {
            lk: {k: {n: v.detach() if isinstance(v, torch.Tensor)
                     else torch.as_tensor(np.asarray(v))
                     for n, v in pack.items()}
                 for k, pack in kinds.items()}
            for lk, kinds in self.deltas.items()}
        self.channels = {
            lk: {k: torch.as_tensor(np.asarray(v, np.int64))
                 for k, v in kinds.items()}
            for lk, kinds in self.channels.items()}

    @classmethod
    def from_policy(cls, policy, deltas) -> "DeltaSet":
        ch: Dict[str, Dict[str, np.ndarray]] = {}
        for u in policy.units:
            ch.setdefault(f"L{u.layer}", {})[u.kind] = np.asarray(
                u.channels, np.int64)
        return cls(deltas=deltas, channels=ch)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    # per-request KV budget (prompt + generated tokens); None = the
    # engine-wide max_len.  With paging, admission reserves the prompt's
    # pages (reserve='asyougo') or ceil(max_len / page_size) ('worstcase')
    max_len: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # evicted by its KV-budget cutoff before reaching max_new tokens
    truncated: bool = False
    # deadline in resident engine ticks (None = engine default / none);
    # the budget survives preemption
    deadline_ticks: Optional[int] = None
    # preempt-and-requeue retries allowed (None = engine default)
    preempt_budget: Optional[int] = None
    # terminal outcome: done | truncated | expired | preempted | numerics
    # | rejected; None while in flight
    outcome: Optional[str] = None
    # times this stream was preempted and requeued
    preempts: int = 0
    # this user's deltas for the per-slot overlay (engines built with
    # ``personalise=``); None = attached from the per-user registry at
    # first staging (zeros, the base model, for unknown users), then kept
    # so preempt/requeue re-attaches the same set.  Rejected on engines
    # without personalisation
    delta_set: Optional[DeltaSet] = None

    @property
    def terminal(self) -> bool:
        return self.outcome is not None


class SubmitResult(NamedTuple):
    """Typed admission verdict from :meth:`ServeEngine.submit`."""

    accepted: bool
    reason: str  # "ok" | "queue_full" | "unexpected_delta_set"


class SlotState(NamedTuple):
    """Per-slot request lifecycle state, device-resident."""

    prompt: torch.Tensor      # (slots, max_len) int32 feed buffer
    prompt_len: torch.Tensor  # (slots,) int32 feed length (prompt + resume)
    cursor: torch.Tensor      # (slots,) int32; >= prompt_len => generating
    pos: torch.Tensor         # (slots,) int32 absolute decode position
    last_tok: torch.Tensor    # (slots,) int32 feedback token while generating
    remaining: torch.Tensor   # (slots,) int32 max_new budget left
    budget: torch.Tensor      # (slots,) int32 per-request KV budget
    active: torch.Tensor      # (slots,) bool
    rid: torch.Tensor         # (slots,) int32 engine request id; -1 free
    pages: torch.Tensor       # (slots,) int32 pages held (as-you-go growth)
    ttl: torch.Tensor         # (slots,) int32 resident ticks until deadline
    preempt_left: torch.Tensor  # (slots,) int32 requeues left


class PendingBuffer(NamedTuple):
    """Device-side admission queue, drained FIFO between host syncs.  The
    cursor (``head``) is carried beside it through a chunk, so the buffer
    itself is never modified and can be reused while nothing is admitted."""

    prompt: torch.Tensor   # (P, max_len) int32 feed (prompt + resumed prefix)
    length: torch.Tensor   # (P,) int32
    max_new: torch.Tensor  # (P,) int32 emits still owed
    budget: torch.Tensor   # (P,) int32 per-request KV budget
    n_pages: torch.Tensor  # (P,) int32 admission page demand (0 unpaged)
    rid: torch.Tensor      # (P,) int32
    ttl: torch.Tensor      # (P,) int32 remaining deadline (resident ticks)
    preempt_left: torch.Tensor  # (P,) int32 requeues left
    # staged per-request deltas, {layer: {kind: (pack, idx)}} with leaves
    # stacked along a leading axis of max(count, 1) entries ({} without a
    # personalise policy)
    delta: Any
    count: torch.Tensor    # () int32 valid entries


class TickPlan(NamedTuple):
    """One tick's admission, page growth and preemption, computed on the
    device before the tick's flag read and committed only if it runs."""

    state: SlotState
    pool: Optional[PG.PagePool]
    take: torch.Tensor         # (slots,) bool admitted this tick
    src: torch.Tensor          # (slots,) pending entry each slot admits
    n_admit: torch.Tensor      # () int32
    head: torch.Tensor         # () int32 next pending entry
    rid_row: torch.Tensor      # (slots,) int32 rids before preemption
    active_row: torch.Tensor   # (slots,) bool residents before preemption
    pre_requeue: torch.Tensor  # (slots,) bool preempted, requeued
    pre_final: torch.Tensor    # (slots,) bool preempted, terminal
    flags: torch.Tensor        # (2,) bool [stop, block]


def _later(knob: str, item: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"ServeEngine({knob}=...): {what} arrives with ROADMAP queue 1, "
        f"item {item}")


class ServeEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        params: Any,
        *,
        slots: int = 8,
        max_len: int = 1024,
        fused: bool = True,
        chunk: int = 32,
        pending: Optional[int] = None,
        prefill_block: Optional[int] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        kv_paging: Optional[bool] = None,
        kv_page_size: Optional[int] = None,
        kv_int8: Optional[bool] = None,
        page_budget: Optional[int] = None,
        reserve: Optional[str] = None,
        deadline_ticks: Optional[int] = None,
        preempt_budget: int = 4,
        queue_limit: Optional[int] = None,
        faults: Optional[Any] = None,
        personalise: Optional[Any] = None,
        admit_backfill: Optional[int] = None,
        device: DeviceLike = "cuda",
    ):
        if not fused:
            raise _later("fused", "11.1", "the eager per-tick loop")
        if temperature > 0 or top_k:
            raise _later("temperature", "11.1",
                         "sampled decoding (temperature / top-k)")
        if faults is not None:
            raise _later("faults", "13", "fault injection")
        if admit_backfill is not None:
            raise _later("admit_backfill", "13", "page-demand backfill")
        T.check_supported(cfg)
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = slots
        self.max_len = max_len
        self.chunk = chunk
        self.deadline_ticks = deadline_ticks
        self.queue_limit = queue_limit
        self.preempt_budget = int(preempt_budget)
        if self.preempt_budget < 0:
            raise ValueError(
                f"preempt_budget must be >= 0, got {preempt_budget}")
        # paged KV cache: knobs default from the arch config; page_budget
        # (pages per layer arena) defaults to the fixed-stripe capacity
        # slots * ceil(max_len / page_size)
        paging_on = cfg.kv_paging if kv_paging is None else bool(kv_paging)
        self.spec: Optional[PG.PagingSpec] = None
        self.pool: Optional[PG.PagePool] = None
        if paging_on:
            self.spec = PG.PagingSpec.build(
                max_len,
                page_size=int(cfg.kv_page_size if kv_page_size is None
                              else kv_page_size),
                slots=slots, n_pages=page_budget,
                int8=bool(cfg.kv_int8 if kv_int8 is None else kv_int8))
            self.pool = PG.make_pool(self.spec, slots, self.device)
        # reservation discipline: 'asyougo' admits on the prompt's pages
        # and grows page by page, preempting on exhaustion; 'worstcase'
        # pins pages_for(max_len) at admission
        reserve = cfg.kv_reserve if reserve is None else reserve
        if reserve not in ("asyougo", "worstcase"):
            raise ValueError(
                f"reserve must be 'asyougo' or 'worstcase', got {reserve!r}")
        self.reserve = reserve
        self.rayg = self.spec is not None and reserve == "asyougo"
        # prompt tokens ingested per prefilling slot per tick; 1 = token by
        # token, the arch default otherwise
        self.prefill_block = int(
            cfg.serve_prefill_block if prefill_block is None else prefill_block)
        if self.prefill_block < 1:
            raise ValueError(
                f"prefill_block must be >= 1, got {self.prefill_block}")
        self.pending_size = pending if pending is not None else max(slots * 4, 8)
        if self.pending_size < 1:
            raise ValueError("pending buffer needs at least one entry")
        if chunk < 1:
            raise ValueError(
                f"chunk must be >= 1, got {chunk}: a zero-length chunk makes "
                "no progress and the run loop would spin forever")
        self.caches = T.init_caches(cfg, slots, max_len, paging=self.spec,
                                    device=self.device)
        self.queue: Deque[Request] = collections.deque()
        self.ticks = 0  # lifetime tick count (stat, never a per-call budget)
        self.last_run_report: Dict[str, Any] = {}
        # device lifecycle carry, staged-but-unadmitted requests (the host
        # mirror of the pending buffer) and the rid -> Request map that the
        # per-chunk event rows drain into
        self._state: Optional[SlotState] = None
        self._staged: Deque[Tuple[int, Request]] = collections.deque()
        self._pending_cache: Optional[PendingBuffer] = None
        self._pending_dirty = True
        self._by_rid: Dict[int, Request] = {}
        self._live: set = set()
        self._next_rid = 0
        # preempted streams awaiting restage (in preemption order) and the
        # per-rid resident-tick ledger that carries deadline balances
        # across preemptions (counted from the event rows)
        self._requeue: Deque[Tuple[int, Request]] = collections.deque()
        self._resident: Dict[int, int] = {}
        # per-run outcome tally (terminal outcomes plus "requeued" events)
        self._tally: Dict[str, int] = {}
        # online personalisation: one zero (pack, idx) template per policy
        # unit fixes the shapes; the arena stacks it along a slot axis and
        # is what the forward applies.  The per-user registry feeds
        # Request.delta_set at first staging, and the per-slot rids of the
        # last executed tick (from the fetched event rows) say which rows a
        # swap rewrites
        self.personalise = personalise
        self._delta_tmpl: Dict[int, Dict[str, Tuple[Any, Any]]] = {}
        if personalise is not None:
            dtype = T.torch_dtype(cfg)
            for u in personalise.units:
                self._delta_tmpl.setdefault(u.layer, {})[u.kind] = (
                    OV.delta_init(cfg, u.layer, u.kind, u.n_channels, dtype,
                                  self.device),
                    torch.zeros((u.n_channels,), dtype=torch.int64,
                                device=self.device))
        self._arena: Any = tree_map(
            lambda z: z.expand(slots, *z.shape).clone(), self._delta_tmpl)
        self._user_deltas: Dict[int, DeltaSet] = {}
        self._slot_rids = np.full((slots,), -1, np.int32)

    # ------------------------------------------------------------------
    # Submission
    # ------------------------------------------------------------------

    def request_budget(self, req: Request) -> int:
        """Effective KV budget (prompt + generated tokens) for a request:
        its own ``max_len`` when set, else the engine-wide ``max_len``."""
        return self.max_len if req.max_len is None else int(req.max_len)

    def _validate(self, req: Request) -> None:
        budget = self.request_budget(req)
        if budget > self.max_len:
            raise ValueError(
                f"request max_len {budget} exceeds the engine's cache "
                f"capacity max_len = {self.max_len}")
        if budget < 2:
            raise ValueError(
                f"request max_len {budget} leaves no room for a prompt "
                "token plus a generated token (need >= 2)")
        n = int(len(req.prompt))
        if n == 0:
            raise ValueError("empty prompt: nothing to prefill")
        if n >= budget - 1:
            raise ValueError(
                f"prompt of length {n} cannot fit: the engine evicts at "
                f"position max_len - 1 = {budget - 1}, so prompts must "
                f"leave room to generate (len(prompt) <= max_len - 2 = "
                f"{budget - 2})")
        if req.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {req.max_new}")
        if req.delta_set is not None and self.personalise is not None:
            self._delta_rows(req.delta_set)  # shape/structure check
        if self.spec is not None:
            need = self.spec.pages_for(budget)
            if need > self.spec.n_pages:
                raise ValueError(
                    f"request needs {need} pages but the pool holds only "
                    f"{self.spec.n_pages}: it could never be admitted")

    def backlog_size(self) -> int:
        """Un-admitted host state: queued + staged + awaiting restage."""
        return len(self.queue) + len(self._staged) + len(self._requeue)

    def _reject_reason(self, req: Request) -> Optional[str]:
        """A request the engine must not serve as it is: deltas for an
        engine with no arena to park them in would be silently dropped."""
        if self.personalise is None and req.delta_set is not None:
            return "unexpected_delta_set"
        return None

    def submit(self, req: Request) -> SubmitResult:
        """Enqueue one request.  A malformed request raises; a full queue
        (``queue_limit``) or deltas sent to an engine without
        personalisation return a typed rejection and mark the request
        ``outcome='rejected'``."""
        self._validate(req)
        reason = self._reject_reason(req)
        if reason is not None:
            req.outcome = "rejected"
            return SubmitResult(False, reason)
        if (self.queue_limit is not None
                and self.backlog_size() >= self.queue_limit):
            req.outcome = "rejected"
            return SubmitResult(False, "queue_full")
        self.queue.append(req)
        return SubmitResult(True, "ok")

    def _deadline(self, req: Request) -> int:
        d = (self.deadline_ticks if req.deadline_ticks is None
             else req.deadline_ticks)
        return _NO_DEADLINE if d is None else int(d)

    def _preempt_left(self, req: Request) -> int:
        pb = (self.preempt_budget if req.preempt_budget is None
              else int(req.preempt_budget))
        return max(pb - req.preempts, 0)

    def _feed(self, req: Request) -> np.ndarray:
        """The tokens a (re)admission prefills: the prompt plus any
        already-generated prefix (the recompute swap), so positions and
        cache rows realign with the unpreempted run."""
        prompt = np.asarray(req.prompt, np.int32)
        if not req.out:
            return prompt
        return np.concatenate([prompt, np.asarray(req.out, np.int32)])

    def _attach_delta(self, req: Request) -> None:
        """First-staging attach: a request without an explicit set takes its
        user's registered one (None for unknown users: the zero row, the
        base model) and keeps it for its lifetime, so preempt/requeue
        re-attaches the same deltas."""
        if self.personalise is not None and req.delta_set is None:
            req.delta_set = self._user_deltas.get(req.uid)

    def _delta_rows(self, ds: Optional[DeltaSet]):
        """One request's arena row: ``{layer: {kind: (pack, idx)}}`` on the
        engine's device in the template's exact shapes (the zero template
        when ``ds`` is None).  Raises ``ValueError`` on a set that does not
        match the personalise policy's structure: a caller bug, not load."""
        if ds is None:
            return self._delta_tmpl
        out: Dict[int, Dict[str, Tuple[Any, Any]]] = {}
        for lid, kinds in self._delta_tmpl.items():
            out[lid] = {}
            for kind, (pack0, idx0) in kinds.items():
                try:
                    pack = ds.deltas[f"L{lid}"][kind]
                    idx = ds.channels[f"L{lid}"][kind]
                except KeyError:
                    raise ValueError(
                        f"delta_set missing unit L{lid}.{kind} required "
                        "by the engine's personalise policy") from None
                if idx.shape != idx0.shape:
                    raise ValueError(
                        f"delta_set L{lid}.{kind} selects {idx.shape[0]} "
                        f"channels; the policy expects {idx0.shape[0]}")
                row = {}
                for name, z in pack0.items():
                    if name not in pack:
                        raise ValueError(
                            f"delta_set L{lid}.{kind} missing delta "
                            f"{name!r}")
                    v = pack[name]
                    if v.shape != z.shape:
                        raise ValueError(
                            f"delta_set L{lid}.{kind}.{name} has shape "
                            f"{tuple(v.shape)}; the policy expects "
                            f"{tuple(z.shape)}")
                    row[name] = v.to(device=self.device, dtype=z.dtype)
                out[lid][kind] = (row, idx.to(self.device))
        return out

    def _fwd_kwargs(self) -> Dict[str, Any]:
        """Forward kwargs of both tick kinds: under personalisation the
        arena is the per-slot overlay and the policy names its layers;
        without a policy, none."""
        if self.personalise is None:
            return {}
        return {"overlay": self._arena, "plan": self.personalise}

    def _admit_pages(self, feed_len: int, budget: int) -> int:
        """Pages reserved at admission: the feed's own demand under
        reserve-as-you-go (growth covers generation), the whole KV budget
        under worstcase."""
        if self.spec is None:
            return 0
        return int(self.spec.pages_for(feed_len if self.rayg else budget))

    # ------------------------------------------------------------------
    # The tick body
    # ------------------------------------------------------------------

    def _i32(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    def _init_state(self) -> SlotState:
        s = self.n_slots
        return SlotState(
            prompt=self._i32(s, self.max_len), prompt_len=self._i32(s),
            cursor=self._i32(s), pos=self._i32(s), last_tok=self._i32(s),
            remaining=self._i32(s), budget=self._i32(s),
            active=torch.zeros(s, dtype=torch.bool, device=self.device),
            rid=self._i32(s) - 1, pages=self._i32(s), ttl=self._i32(s),
            preempt_left=self._i32(s))

    def _make_pending(self) -> PendingBuffer:
        # rebuilt (and uploaded) only when the staged set changed
        if not self._pending_dirty and self._pending_cache is not None:
            return self._pending_cache
        P, maxp = self.pending_size, self.max_len
        prompt = np.zeros((P, maxp), np.int32)
        ints = {k: np.zeros((P,), np.int32) for k in (
            "length", "max_new", "budget", "n_pages", "ttl", "preempt_left")}
        rid = np.full((P,), -1, np.int32)
        for j, (r, req) in enumerate(self._staged):
            # a restaged (preempted) entry re-prefills its whole history and
            # owes only the remaining emits; a fresh one is the degenerate
            # case of that
            feed = self._feed(req)
            prompt[j, :len(feed)] = feed
            ints["length"][j] = len(feed)
            ints["max_new"][j] = req.max_new - len(req.out)
            ints["budget"][j] = self.request_budget(req)
            ints["n_pages"][j] = self._admit_pages(len(feed),
                                                   ints["budget"][j])
            rid[j] = r
            # the deadline balance survives preemption: the deadline minus
            # the resident ticks already spent under this rid
            ints["ttl"][j] = min(self._deadline(req)
                                 - self._resident.get(r, 0), _NO_DEADLINE)
            ints["preempt_left"][j] = self._preempt_left(req)
        dev = self.device
        up = (lambda a: torch.from_numpy(a).to(dev))
        delta: Any = {}
        if self.personalise is not None:
            # each staged request's row (attached at first staging, the
            # same set on every restage); only the staged entries are
            # stacked, since a slot admits entry src < count
            rows = [self._delta_rows(req.delta_set)
                    for _, req in self._staged] or [self._delta_tmpl]
            delta = tree_map(lambda *xs: torch.stack(xs), *rows)
        self._pending_cache = PendingBuffer(
            prompt=up(prompt), rid=up(rid), delta=delta,
            **{k: up(a) for k, a in ints.items()},
            count=torch.tensor(len(self._staged), dtype=torch.int32,
                               device=dev))
        self._pending_dirty = False
        return self._pending_cache

    def _plan(self, st: SlotState, pend: PendingBuffer, head: torch.Tensor,
              pool: Optional[PG.PagePool], backlog: bool) -> TickPlan:
        """Admission, page growth and preemption for one tick, on the
        device and functional: the caller commits the plan only if the
        tick runs.  Its ``flags`` are the tick's one host read, [stop,
        block]: ``stop`` is the chunk loop's exit test on the state
        *before* admission (pending drained and either no slot active, or a
        free slot while the host holds more queued work); ``block`` chooses
        the block-prefill forward (some slot prefills, or a slot stalled
        for want of a page)."""
        P, spec = self.pending_size, self.spec
        free = ~st.active
        rank = torch.cumsum(free.to(torch.int32), 0) - 1
        fifo = free & (head + rank < pend.count)
        src = (head + rank).clamp(0, P - 1).long()
        if spec is not None:
            # a candidate is admitted only if the demand up to and
            # including it fits the free-list: every request needs >= 1
            # page, so admission stays FIFO with head-of-line blocking
            need = torch.where(fifo, pend.n_pages[src], 0)
            take = fifo & (torch.cumsum(need, 0) <= PG.free_page_count(pool))
            pool = PG.reserve(pool, need, take)
        else:
            take = fifo
        stop = ((head >= pend.count)
                & (~st.active.any() | (free.any() & backlog)))

        def sel(new, old):
            return torch.where(take, new, old)

        zero = torch.zeros_like(st.cursor)
        st = SlotState(
            prompt=torch.where(take[:, None], pend.prompt[src], st.prompt),
            prompt_len=sel(pend.length[src], st.prompt_len),
            cursor=sel(zero, st.cursor), pos=sel(zero, st.pos),
            last_tok=sel(zero, st.last_tok),
            remaining=sel(pend.max_new[src], st.remaining),
            budget=sel(pend.budget[src], st.budget),
            active=st.active | take,
            rid=sel(pend.rid[src], st.rid),
            pages=sel(pend.n_pages[src], st.pages),
            ttl=sel(pend.ttl[src], st.ttl),
            preempt_left=sel(pend.preempt_left[src], st.preempt_left))
        n_admit = take.sum(dtype=torch.int32)
        # event snapshots: a slot preempted this tick still reports its rid
        rid_row, active_row = st.rid, st.active
        prefilling = st.active & (st.cursor < st.prompt_len)
        pre_requeue = pre_final = torch.zeros_like(st.active)
        stalled = torch.zeros_like(st.active)
        if self.rayg:
            # a generating slot crossing a page boundary claims its next
            # page; grants go oldest rid first while the free-list lasts
            grow = (st.active & ~prefilling
                    & (spec.pages_for(st.pos + 1) > st.pages))
            prio = torch.where(grow, st.rid, torch.iinfo(torch.int32).max)
            before = (prio[None, :] < prio[:, None]).sum(
                dim=1, dtype=torch.int32)
            granted = grow & (before < PG.free_page_count(pool))
            pool = PG.extend(pool, granted.to(torch.int32), granted, st.pages)
            st = st._replace(pages=st.pages + granted.to(torch.int32))
            stalled = grow & ~granted
            # pool exhaustion preempts the youngest resident: its pages go
            # back, the slot frees, and the host requeues it (or ends it
            # 'preempted' once its retry budget is spent)
            vrid = torch.where(st.active, st.rid, -1)
            youngest = ((torch.arange(self.n_slots, device=self.device)
                         == torch.argmax(vrid)) & st.active)
            victims = stalled.any() & youngest
            pre_final = victims & (st.preempt_left <= 0)
            pre_requeue = victims & ~pre_final
            pool = PG.release(pool, victims)
            st = st._replace(active=st.active & ~victims,
                             rid=torch.where(victims, -1, st.rid),
                             pages=torch.where(victims, 0, st.pages))
            stalled = stalled & st.active
            prefilling = prefilling & st.active
        block = ((prefilling.any() & (self.prefill_block > 1))
                 | stalled.any())
        return TickPlan(st, pool, take, src, n_admit, head + n_admit, rid_row,
                        active_row, pre_requeue, pre_final,
                        torch.stack([stop, block]))

    def _forward(self, st: SlotState, prefilling: torch.Tensor, block: bool):
        """One forward over every slot: (last logits (slots, vocab), tokens
        consumed per slot).  A block tick pauses every slot that is not
        prefilling (all-False rows advance nothing)."""
        cfg, params, maxp = self.cfg, self.params, self.max_len
        if block:
            B = self.prefill_block
            n_tok = torch.where(
                prefilling,
                torch.clamp(st.prompt_len - st.cursor, max=B), 0).to(torch.int32)
            j = torch.arange(B, device=self.device)[None, :]
            valid = j < n_tok[:, None]
            gidx = (st.cursor[:, None] + j).clamp(0, maxp - 1)
            toks = torch.where(valid, st.prompt.gather(1, gidx), 0)
            logits, self.caches = T.prefill_block(
                cfg, params, toks.long(), self.caches, st.pos, valid,
                **self._fwd_kwargs())
            last = (n_tok - 1).clamp(0, B - 1).long()
            idx = last[:, None, None].expand(-1, 1, logits.shape[-1])
            return logits.gather(1, idx)[:, 0], n_tok
        ptok = st.prompt.gather(
            1, st.cursor.clamp(0, maxp - 1)[:, None].long())[:, 0]
        tok = torch.where(st.active,
                          torch.where(prefilling, ptok, st.last_tok), 0)
        logits, self.caches = T.decode_step(
            cfg, params, tok[:, None].long(), self.caches, st.pos,
            **self._fwd_kwargs())
        return logits[:, 0], st.active.to(torch.int32)

    def _advance(self, plan: TickPlan, block: bool):
        """Forward plus lifecycle advance.  Returns (state, pool, event
        row)."""
        st, pool = plan.state, plan.pool
        prefilling = st.active & (st.cursor < st.prompt_len)
        logits, n_tok = self._forward(st, prefilling, block)
        cursor = torch.where(prefilling, st.cursor + n_tok, st.cursor)
        emit = st.active & (n_tok > 0) & (~prefilling
                                          | (cursor >= st.prompt_len))
        pos = st.pos + n_tok
        # numerics guard: a non-finite row on an emitting slot suppresses
        # the emit and terminates the stream instead of feeding back garbage
        finite = torch.isfinite(logits).all(dim=-1)
        bad = emit & ~finite
        good_emit = emit & finite
        # greedy pick: argmax returns the first maximum, as jnp.argmax does
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        remaining = st.remaining - good_emit.to(torch.int32)
        done = st.active & ~bad & ((remaining <= 0) | (pos >= st.budget - 1))
        trunc = done & (remaining > 0)
        # the deadline counts resident ticks, this tick's preempted slot's
        # included (the host ledger counts the same event rows)
        ttl = st.ttl - plan.active_row.to(torch.int32)
        expired = st.active & ~bad & ~done & (ttl <= 0)
        term = done | bad | expired
        outcome = torch.zeros_like(st.cursor)
        outcome = torch.where(done, OUTCOME_DONE, outcome)
        outcome = torch.where(trunc, OUTCOME_TRUNCATED, outcome)
        outcome = torch.where(expired, OUTCOME_EXPIRED, outcome)
        outcome = torch.where(bad, OUTCOME_NUMERICS, outcome)
        outcome = torch.where(plan.pre_requeue, OUTCOME_REQUEUED, outcome)
        outcome = torch.where(plan.pre_final, OUTCOME_PREEMPTED, outcome)
        row = torch.cat([
            plan.rid_row, torch.where(good_emit, next_tok, -1), outcome,
            plan.active_row.any().to(torch.int32)[None],
            plan.n_admit[None]])
        st = st._replace(
            cursor=cursor, pos=pos,
            last_tok=torch.where(good_emit, next_tok, st.last_tok),
            remaining=remaining, ttl=ttl, active=st.active & ~term,
            rid=torch.where(term, -1, st.rid),
            pages=torch.where(term, 0, st.pages))
        if pool is not None:
            # finished slots release their pages and their table rows go
            # unmapped, so no write of theirs can land in a recycled page
            pool = PG.release(pool, term)
            PG.set_page_table(self.caches, pool.table)
        return st, pool, row

    # ------------------------------------------------------------------
    # Chunks: stage -> tick loop -> one fetch of the event rows
    # ------------------------------------------------------------------

    def has_work(self) -> bool:
        """Anything queued, staged, resident or awaiting requeue?"""
        return bool(self.queue or self._staged or self._live
                    or self._requeue)

    def _dispatch(self, budget: int) -> List[torch.Tensor]:
        """Stage queued work and run up to ``budget`` ticks; returns the
        executed ticks' event rows (still on the device)."""
        # preempted streams restage first, in preemption order
        while self._requeue and len(self._staged) < self.pending_size:
            self._staged.appendleft(self._requeue.pop())
            self._pending_dirty = True
        while self.queue and len(self._staged) < self.pending_size:
            req = self.queue.popleft()
            rid = self._next_rid
            self._next_rid += 1
            self._attach_delta(req)
            self._by_rid[rid] = req
            self._staged.append((rid, req))
            self._pending_dirty = True
        # backlog: host work beyond the pending buffer; the tick loop
        # returns early if the buffer drains while a slot is free, so the
        # freed slot refills from the host instead of idling out the chunk
        backlog = bool(self.queue or self._requeue)
        pend = self._make_pending()
        head = torch.zeros((), dtype=torch.int32, device=self.device)
        st, pool = self._state, self.pool
        rows: List[torch.Tensor] = []
        while len(rows) < budget:
            plan = self._plan(st, pend, head, pool, backlog)
            stop, block = _telemetry._fetch(plan.flags)  # the tick's one sync
            if stop:
                break
            head = plan.head
            if pool is not None:
                # the table the forward reads is this tick's, after its
                # reserve, growth and preemption
                PG.set_page_table(self.caches, plan.pool.table)
            T.reset_slot_state(self.caches, plan.take)
            if self.personalise is not None:
                # park each admitted request's staged deltas in its slot's
                # arena row: a gather and a select per leaf, the whole
                # per-tick cost of personalisation outside the forward
                take = plan.take

                def admit(a, q):
                    m = take.reshape((self.n_slots,) + (1,) * (a.dim() - 1))
                    return torch.where(
                        m, q[plan.src.clamp(max=q.shape[0] - 1)], a)

                self._arena = tree_map(admit, self._arena, pend.delta)
            st, pool, row = self._advance(plan, bool(block))
            rows.append(row)
        self._state, self.pool = st, pool
        return rows

    def _drain(self, rows: List[torch.Tensor], fr: Dict[str, Any]) -> None:
        """Fetch a chunk's event rows (one sync) and book them."""
        fr["chunks"] += 1
        if not rows:
            return
        ev = _telemetry._fetch(torch.stack(rows))
        S = self.n_slots
        rids, toks, outs = ev[:, :S], ev[:, S:2 * S], ev[:, 2 * S:3 * S]
        act, n_admit = ev[:, 3 * S], ev[:, 3 * S + 1]
        # per-slot occupancy at the last executed tick: the resident map
        # swap_deltas targets between chunks (terminal rids resolve to no
        # live request)
        self._slot_rids = rids[-1].copy()
        for _ in range(int(n_admit.sum())):
            rid, _req = self._staged.popleft()
            self._live.add(rid)
            self._pending_dirty = True
        # residency ledger for deadlines: each rid cell is one resident
        # tick, preemption and eviction ticks included
        res_rids, res_counts = np.unique(rids[rids >= 0], return_counts=True)
        for r, c in zip(res_rids, res_counts):
            self._resident[int(r)] = self._resident.get(int(r), 0) + int(c)
        # np.nonzero walks ticks row-major, so per-request appends stay in
        # generation order; terminal cells coincide with their last emit
        for t, i in zip(*np.nonzero(toks >= 0)):
            self._by_rid[int(rids[t, i])].out.append(int(toks[t, i]))
        for t, i in zip(*np.nonzero(outs > 0)):
            rid = int(rids[t, i])
            code = int(outs[t, i])
            if code == OUTCOME_REQUEUED:
                # back to the host, restaged at the top of the next chunk
                req = self._by_rid[rid]
                req.preempts += 1
                self._live.discard(rid)
                self._requeue.append((rid, req))
                self._tally["requeued"] = self._tally.get("requeued", 0) + 1
                continue
            req = self._by_rid.pop(rid)
            req.outcome = OUTCOME_NAMES[code]
            if code in (OUTCOME_DONE, OUTCOME_TRUNCATED):
                req.done = True
                req.truncated = code == OUTCOME_TRUNCATED
            self._tally[req.outcome] = self._tally.get(req.outcome, 0) + 1
            self._live.discard(rid)
            self._resident.pop(rid, None)
        used = int(act.sum())
        fr["used"] += used
        self.ticks += used
        fr["dispatched"] += len(rows)
        fr["toks"] += int((toks >= 0).sum())
        fr["peak"] = max(fr["peak"], int((rids >= 0).sum(axis=1).max()))

    def _run_fused(self, max_ticks: int, chunk: Optional[int]) -> None:
        chunk = self.chunk if chunk is None else int(chunk)
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if self._state is None:
            self._state = self._init_state()
        fr = {"used": 0, "chunks": 0, "dispatched": 0, "peak": 0, "toks": 0,
              "busy_s": 0.0}
        syncs0 = _telemetry.host_sync_count()
        while self.has_work() and fr["used"] < max_ticks:
            t0 = time.perf_counter()
            rows = self._dispatch(min(chunk, max_ticks - fr["used"]))
            self._drain(rows, fr)
            fr["busy_s"] += time.perf_counter() - t0
        self.last_run_report = {
            "ticks": fr["used"], "chunks": fr["chunks"],
            # every blocking device->host read of this run: one flag read
            # per tick plus one event fetch per chunk
            "host_syncs": _telemetry.host_sync_count() - syncs0,
            "ticks_dispatched": fr["dispatched"],
            "peak_resident": fr["peak"],
            "new_tokens": fr["toks"],
            "busy_seconds": fr["busy_s"],
            "outcomes": dict(self._tally),
            "memory": self.memory_report(),
        }

    # ------------------------------------------------------------------
    # Online personalisation: per-user registry + hot swap
    # ------------------------------------------------------------------

    def swap_deltas(self, uid: int, delta_set: Optional[DeltaSet]) -> int:
        """Register user ``uid``'s deltas and hot-swap them in.

        Updates the per-user registry (later requests of ``uid`` attach the
        new set), the ``delta_set`` of every in-flight request of that user
        (queued, staged, requeued and resident), and rewrites the user's
        resident arena rows with one masked select per leaf: no drain and
        no host read.  Call between chunks (``run()`` calls); resident
        streams take the new deltas from their next tick, so only this
        user's later tokens change.  ``delta_set=None`` reverts the user to
        the base model.  Returns the number of resident slots swapped."""
        if self.personalise is None:
            raise RuntimeError(
                "engine was built without personalise=: there is no delta "
                "arena to swap into")
        rows = self._delta_rows(delta_set)  # validates shape/structure
        if delta_set is None:
            self._user_deltas.pop(uid, None)
        else:
            self._user_deltas[uid] = delta_set
        for _r, req in self._staged:
            if req.uid == uid:
                req.delta_set = delta_set
                self._pending_dirty = True
        for req in (*(r for _, r in self._requeue), *self.queue,
                    *self._by_rid.values()):
            if req.uid == uid:
                req.delta_set = delta_set
        mask = np.zeros(self.n_slots, bool)
        for i, r in enumerate(self._slot_rids):
            req = self._by_rid.get(int(r))
            if req is not None and req.uid == uid and int(r) in self._live:
                mask[i] = True
        n = int(mask.sum())
        if n:
            # broadcast the user's row into every masked slot
            m = torch.from_numpy(mask).to(self.device)

            def one(a, v):
                return torch.where(m.reshape((-1,) + (1,) * v.dim()),
                                   v[None], a)

            self._arena = tree_map(one, self._arena, rows)
        return n

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    def memory_report(self) -> Dict[str, Any]:
        """KV-cache memory accounting from host bookkeeping (no sync).

        Contiguous stripes: every slot pins a full-length share whether
        or not it is occupied.  Paged: under ``worstcase`` a resident
        holds ``pages_for(budget)`` pages; under ``asyougo`` residents are
        estimated from their drained history (``pages_for(len(prompt) +
        len(out))``), exact at chunk boundaries to within the one page a
        stream claims on its next boundary crossing."""
        total, arena = PG.cache_bytes(self.caches)
        live = [self._by_rid[r] for r in self._live if r in self._by_rid]
        rep: Dict[str, Any] = {
            "kv_paging": self.spec is not None,
            "kv_cache_bytes": int(total),
            "resident_streams": len(live),
        }
        if self.personalise is not None:
            # the arena rows are the only per-user parameter state (the base
            # weights are shared), against a folded copy per user
            arena_b = sum(t.numel() * t.element_size()
                          for t in tree_leaves(self._arena))
            rep["delta_arena_bytes"] = arena_b
            rep["delta_bytes_per_stream"] = arena_b // self.n_slots
            rep["params_bytes_folded_copy"] = sum(
                t.numel() * t.element_size() for t in tree_leaves(self.params))
        spec = self.spec
        if spec is None:
            rep["kv_bytes_per_stream"] = int(total) // self.n_slots
            return rep
        if self.rayg:
            in_use = sum(int(spec.pages_for(len(r.prompt) + len(r.out)))
                         for r in live)
        else:
            in_use = sum(int(spec.pages_for(self.request_budget(r)))
                         for r in live)
        page_bytes = int(arena) // spec.n_pages  # all layers, one page
        rep.update({
            "kv_int8": spec.int8,
            "page_size": spec.page_size,
            "n_pages": spec.n_pages,
            "pages_in_use": in_use,
            "pages_free": spec.n_pages - in_use,
            "page_utilisation": in_use / spec.n_pages,
            "page_bytes": page_bytes,
            # bytes pinned per resident stream; an empty engine reports
            # the worst-case single-request cost
            "kv_bytes_per_stream": (
                in_use * page_bytes // len(live) if live
                else spec.max_pages * page_bytes),
        })
        return rep

    # ------------------------------------------------------------------
    # Driver
    # ------------------------------------------------------------------

    def run(self, requests: List[Request], max_ticks: int = 100_000,
            chunk: Optional[int] = None) -> List[Request]:
        """Serve ``requests`` until done or ``max_ticks`` engine ticks.

        ``max_ticks`` budgets this call; ``self.ticks`` is a lifetime
        statistic."""
        for r in requests:  # validate the whole batch before enqueuing any
            self._validate(r)
        self._tally = {}
        for r in requests:
            # admission backpressure: overflow beyond queue_limit is shed
            # with a typed terminal outcome, never silently dropped; so is a
            # request whose deltas this engine could not serve
            if self._reject_reason(r) is not None or (
                    self.queue_limit is not None
                    and self.backlog_size() >= self.queue_limit):
                r.outcome = "rejected"
                self._tally["rejected"] = self._tally.get("rejected", 0) + 1
            else:
                self.queue.append(r)
        self._run_fused(max_ticks, chunk)
        return requests
