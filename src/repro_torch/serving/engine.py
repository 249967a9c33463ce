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

Host syncs: one per chunk, the fetch of its event rows, as in the JAX
engine.  JAX branches and loops on the device (``lax.cond``,
``lax.while_loop``); here the host issues every tick of the chunk's
budget and the device decides, with nothing read back inside the loop.
A device flag ``live`` latches False at the first tick whose exit test
holds (pending drained and either no slot active, or a free slot while
the host holds more work), and every commit of a tick is predicated on
it: admission, the pending head, page reserve/growth/release, the slot
resets, the delta arena, the lifecycle selects.  A tick after the exit
changes nothing, and its event row says so (no resident, no emit, not
live), so the drain books only the live ticks, as the JAX engine books
``t_exec``.  Each tick issues both forward programs, the block prefill
over the prefilling slots when the tick is a block tick and the
single-token decode over the active slots when it is not, and selects
the logits with ``torch.where``; the unchosen program's slots are masked
and write nothing.  The event fetch goes through ``core.adapt._fetch``,
so ``last_run_report["host_syncs"]`` counts it: ``host_syncs ==
chunks``.  With ``skip_masked`` (on a card by default) the host issues
no work it already knows to be masked: each tick's flags are copied to
pinned memory behind an event, and once a copy has completed (the host
never waits for one) no tick after a known exit is issued, nor the
unchosen program of a tick whose flags are known; the program the last
known tick chose goes first.  The skip changes no result and no count but
``ticks_issued`` and ``forwards_issued``.

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

**The ssm and hybrid families** (mamba2, zamba2) serve from per-slot
recurrent state (a conv window and a (H, P, N) SSD state per layer) that
admission zeroes; both their block prefill and their decode are the
sequential recurrence, so a serve launches no SSD kernel.  That state is
fixed-size and never paged.  Under ``kv_paging`` the pool and admission
in pages run as on the dense family, as in the JAX engine: mamba2 then
has no page store at all, and zamba2's shared-block caches (one a
``hybrid_attn_every`` layers) are page arenas under the engine's one
table.  Their SSD heads take the per-slot overlay like any other unit.

**Sampling** (``temperature`` > 0, ``top_k``): token ``t`` of a request
draws from ``fold_in(fold_in(key(sample_seed), sid), t)`` through
``serving.prng``, the JAX package's own Threefry draws, where ``sid`` is
``Request.sample_id`` (the engine rid by default) and ``t`` counts the
request's emitted tokens (``tok_base``, the tokens it had at staging, plus
those since).  A draw is a function of what is sampled, never of when, so
sampled streams are the same whatever the block size, the chunk, the batch
neighbours, a preemption or an ``evacuate`` and resubmission, and equal the
JAX engine's.  A greedy tick issues no sampler op.

**The eager loop** (``fused=False``): :meth:`ServeEngine.step` runs one
tick with the host in charge, as the JAX package's eager path does, and
reads the device every tick (the picked tokens, and the free-page count
when admission or page growth needs it); it is the debugging path and is
not run under ``tick_sync_debug``.  It issues the fused tick's forward
programs with host-built masks, so its streams equal the fused engine's
bit for bit.

**The fused split**: :meth:`fused_begin`, :meth:`fused_dispatch` (stage and
issue one chunk, returning its undrained event rows), :meth:`fused_drain`
(the chunk's one fetch) and :meth:`fused_finish`; ``run()`` composes them,
and a caller may dispatch several engines before draining any.  Each
engine counts its own fetches.  :meth:`evacuate` pulls every unfinished
request off the engine in submission order, for resubmission elsewhere.

**Fault injection** (``faults=FaultConfig(...)``, ``serving.faults``): NaN
logits and forced preemption at (request, token) coordinates, a window of
global ticks in which page growth is granted nothing, and a queue-limit
override, on both loops.  **Page-demand backfill** (``admit_backfill=N``,
paged engines): when the head of the pending buffer cannot be priced into
the free pages, at most one later entry whose whole price fits admits in
its place a tick, at most ``N`` times while the head waits.

**The moe family**: every forward program runs its MoE layers drop-free
(no token's expert choice ever drops, so a stream does not depend on its
batch neighbours or the block size), as the JAX engine's do; mixtral's
window cache rolls once ``max_len`` passes the window (and then stays
contiguous under ``kv_paging``), and deepseek's MLA layers page their
latent rows like K/V.

**Encoder-decoder and VLM serving** (whisper, paligemma): a request on
such a config carries ``enc_feats`` (whisper's (enc_len, d_model) frame
embeddings, paligemma's (n_img_tokens, img_embed_dim) patch embeddings).
The engine encodes it **once**, at first staging (``models.transformer
.encode`` or the ``img_proj`` product, on the device), keeps the rows in
a host-held map by rid (the tensors stay on the device: no read back)
and re-attaches them verbatim on every requeue, so a resumed stream is
never re-encoded and equals the unpreempted one.  Admission parks them as
the slot's read-only **encoder run** (:class:`EncRun`): pages drawn from
the KV pool's free-list under ``kv_paging`` (``paging.reserve_run``, the
run priced with the KV demand, released with the KV pages on eviction and
preemption), else a fixed per-slot stripe.  Every tick gathers the runs
through their table into the forward: cross-attention's ``enc_out`` on
whisper, the ``embed_prefix`` swap on paligemma, whose feed leads with
``n_img_tokens`` placeholder tokens (the prefix counts in positions, KV
rows and the request's budget).  All of it runs inside the tick: one host
sync a chunk still.  A request without ``enc_feats`` on such a config is
rejected with the typed reason ``missing_enc_feats``, one with them on any
other config with ``unexpected_enc_feats``, and features of the wrong
shape raise ``ValueError``.
"""
from __future__ import annotations

import collections
import contextlib
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
from . import faults as FI
from . import paging as PG
from . import prng
from .faults import FaultConfig

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
    # sampling identity: draws key on (sample_id, token index); None = the
    # engine rid.  A caller that resubmits a request elsewhere (a router,
    # ``evacuate``) keeps it, so the stream samples the same tokens
    sample_id: Optional[int] = None
    # encoder inputs, required on encoder-decoder and vlm configs and
    # rejected elsewhere: (enc_len, d_model) frame embeddings (audio),
    # (n_img_tokens, img_embed_dim) patch embeddings (vlm).  Encoded once
    # at first staging; the rows stay pinned for the stream's residency
    # and are re-attached, not re-encoded, on preemption and requeue
    enc_feats: Optional[np.ndarray] = None

    @property
    def terminal(self) -> bool:
        return self.outcome is not None


class SubmitResult(NamedTuple):
    """Typed admission verdict from :meth:`ServeEngine.submit`."""

    accepted: bool
    # "ok" | "queue_full" | "missing_enc_feats" | "unexpected_enc_feats"
    # | "unexpected_delta_set"
    reason: str


@dataclasses.dataclass
class _Slot:
    """One slot of the eager loop, on the host."""

    req: Optional[Request] = None
    cursor: int = 0    # next feed token; >= len(feed) => generating
    rid: int = -1      # engine request id (scheduling identity, fault key)
    sid: int = -1      # sampling identity (sample_id, default the rid)
    budget: int = 0    # effective KV budget
    feed: Optional[np.ndarray] = None  # prompt + generated prefix on resume
    pages: int = 0     # pages held
    tok_base: int = 0  # tokens emitted before this admission


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
    sid: torch.Tensor         # (slots,) int32 sampling identity
    pages: torch.Tensor       # (slots,) int32 pages held (as-you-go growth)
    ttl: torch.Tensor         # (slots,) int32 resident ticks until deadline
    tok_base: torch.Tensor    # (slots,) int32 tokens emitted before admission
    preempt_left: torch.Tensor  # (slots,) int32 requeues left


class PendingBuffer(NamedTuple):
    """Device-side admission queue, drained FIFO between host syncs.  The
    cursor (``head``; under backfill the taken mask and the head's age) is
    carried beside it through a chunk, so the buffer itself is never
    modified and can be reused while nothing is admitted."""

    prompt: torch.Tensor   # (P, max_len) int32 feed (prompt + resumed prefix)
    length: torch.Tensor   # (P,) int32
    max_new: torch.Tensor  # (P,) int32 emits still owed
    budget: torch.Tensor   # (P,) int32 per-request KV budget
    n_pages: torch.Tensor  # (P,) int32 admission page demand (0 unpaged)
    rid: torch.Tensor      # (P,) int32
    sid: torch.Tensor      # (P,) int32 sampling identity
    ttl: torch.Tensor      # (P,) int32 remaining deadline (resident ticks)
    tok_base: torch.Tensor  # (P,) int32 tokens emitted before staging
    preempt_left: torch.Tensor  # (P,) int32 requeues left
    # staged per-request deltas, {layer: {kind: (pack, idx)}} with leaves
    # stacked along a leading axis of max(count, 1) entries ({} without a
    # personalise policy)
    delta: Any
    # staged requests' encoded rows, (max(count, 1), enc_tokens, d_model)
    # (None on a config without encoder runs)
    enc: Optional[torch.Tensor]
    count: torch.Tensor    # () int32 valid entries
    # backfill: the head's bypasses so far, carried across chunks
    age: torch.Tensor      # () int32


class EncRun(NamedTuple):
    """The slots' pinned encoder-output runs: a run table over a page
    store.  ``table`` is (slots, run pages) int32 (-1 unmapped) over the
    KV pool's pages when paged, else the identity (slot s owns page s of
    one ``enc_tokens``-row page); ``store`` a ``paging.store_init`` arena
    of d_model rows in the model's dtype (never int8: every tick reads
    it).  The table is replaced by each reserve and release; the store is
    written in place."""

    table: torch.Tensor
    store: Dict[str, torch.Tensor]


class TickPlan(NamedTuple):
    """One tick's admission, page growth and preemption, computed on the
    device and predicated on ``live``: a tick after the chunk's exit
    admits, grows and preempts nothing."""

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
    live: torch.Tensor         # () bool the chunk has not exited yet
    block: torch.Tensor        # () bool this tick runs the block program
    # backfill carry: (P,) bool entries admitted, () int32 head bypasses
    # (None without backfill)
    taken: Optional[torch.Tensor] = None
    age: Optional[torch.Tensor] = None
    # the encoder runs' table after this tick's reserve and release (None
    # on a config without encoder runs)
    enc_table: Optional[torch.Tensor] = None


@contextlib.contextmanager
def _sync_debug(device: torch.device, mode: Optional[str]):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block on a card,
    the previous mode restored after; nothing when ``mode`` is None or the
    device is the CPU."""
    if mode is None or device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


class _FlagProbe:
    """What the host may know of a chunk's ticks without waiting.  Each
    tick's ``[live, block]`` flags are copied to pinned host memory behind
    a recorded event, and only a copy whose event has completed is read
    (``Event.query``), so nothing blocks on the device and nothing counts
    as a host sync; on the CPU the flags are known at once.  The engine
    issues no work the flags show to be masked: no tick after a known exit
    (``live`` only latches off) and not the unchosen forward program of a
    tick whose flags are known."""

    def __init__(self, device: torch.device, n: int):
        self.card = device.type == "cuda"
        self.flags = torch.empty((n, 2), dtype=torch.bool,
                                 pin_memory=self.card)
        self.events: Deque[Tuple[int, Any]] = collections.deque()
        self.known = -1        # flags of ticks <= known are readable
        self.exited = False    # a known tick was not live
        self.last_block = False  # the latest known live tick's kind

    def post(self, t: int, live: torch.Tensor, block: torch.Tensor) -> None:
        if not self.card:
            self.flags[t, 0], self.flags[t, 1] = live, block
            self._learn(t)
            return
        self.flags[t].copy_(torch.stack([live, block]), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.events.append((t, ev))

    def _learn(self, t: int) -> None:
        self.known = t
        live, block = (bool(x) for x in self.flags[t])
        self.exited = self.exited or not live
        if live:
            self.last_block = block

    def poll(self) -> bool:
        """Read every completed copy; True once the chunk is known to have
        exited."""
        while self.events and self.events[0][1].query():
            self._learn(self.events.popleft()[0])
        return self.exited

    def flags_of(self, t: int) -> Optional[Tuple[bool, bool]]:
        """Tick t's (live, block) if its copy has completed, else None."""
        self.poll()
        if t > self.known:
            return None
        return bool(self.flags[t, 0]), bool(self.flags[t, 1])


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
        sample_seed: int = 0,
        kv_paging: Optional[bool] = None,
        kv_page_size: Optional[int] = None,
        kv_int8: Optional[bool] = None,
        page_budget: Optional[int] = None,
        reserve: Optional[str] = None,
        deadline_ticks: Optional[int] = None,
        preempt_budget: int = 4,
        queue_limit: Optional[int] = None,
        faults: Optional[FaultConfig] = None,
        personalise: Optional[Any] = None,
        admit_backfill: Optional[int] = None,
        skip_masked: Optional[bool] = None,
        device: DeviceLike = "cuda",
    ):
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
        self.fused = bool(fused)
        self.chunk = chunk
        self.skip_masked = (self.device.type == "cuda" if skip_masked is None
                            else bool(skip_masked))
        # on a card, "warn" or "error" runs every tick loop under
        # torch.cuda.set_sync_debug_mode, so a hidden host sync inside it
        # (an .item(), a pageable copy, a boolean-mask index) shows; None
        # leaves the mode alone
        self.tick_sync_debug: Optional[str] = None
        self._forwards = 0  # forward programs issued (lifetime)
        self.deadline_ticks = deadline_ticks
        # the fault plan (None: no tick issues a fault op); its queue limit
        # tightens the engine's
        self.faults = faults
        if faults is not None and faults.queue_limit is not None:
            queue_limit = (faults.queue_limit if queue_limit is None
                           else min(queue_limit, faults.queue_limit))
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
        # page-demand backfill: when the pending head cannot be priced into
        # the free pages, at most one later entry that fits admits in its
        # place a tick, at most `admit_backfill` times while the head waits.
        # Demand differs between entries only under 'asyougo' (prompt
        # pages); under 'worstcase' a blocked head means nothing fits
        if admit_backfill is not None:
            if self.spec is None:
                raise ValueError(
                    "admit_backfill requires paging (kv_paging=True): "
                    "without a page pool admission never blocks on the "
                    "head, so there is nothing to backfill past")
            if int(admit_backfill) < 1:
                raise ValueError(
                    f"admit_backfill must be >= 1 bypasses, got "
                    f"{admit_backfill} (None disables backfill)")
        self._backfill = 0 if admit_backfill is None else int(admit_backfill)
        self._head_age = 0  # bypasses since the head last admitted
        self._eager_rids: Dict[int, int] = {}  # rids a backfill scan assigned
        # sampling: greedy at temperature 0, else a Gumbel-max draw keyed on
        # (sid, token index).  The JAX engine's jitted x / T compiles to
        # x * (1 / T) in float32, so the port multiplies by that reciprocal
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self._key = prng.key(int(sample_seed), self.device)
        # only a draw or a fault plan reads a slot's (sid, tok_base): a
        # greedy faultless tick neither admits nor carries them
        self._keyed = self.temperature > 0 or (
            faults is not None
            and bool(faults.nan_logits or faults.force_preempt))
        self._inv_temp = (torch.tensor(1.0, dtype=torch.float32)
                          / torch.tensor(self.temperature or 1.0,
                                         dtype=torch.float32)
                          ).to(self.device)
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
        # the SSD layers' conv windows and states: fixed-size, never paged
        # and not part of memory_report (which stays the JAX engine's)
        state = [g["ssm"][key] for g in self.caches.values() if "ssm" in g
                 for key in ("conv", "ssm")]
        self.ssm_state_bytes_per_slot = sum(
            t.numel() * t.element_size() for t in state) // slots
        # encoder-decoder / vlm: each request's encoder output is pinned as
        # a read-only run (whisper: cross-attention's enc_out; paligemma:
        # the image prefix), drawn from the KV pool's free-list when paged
        # and a fixed stripe a slot otherwise
        if cfg.is_encoder_decoder:
            self._enc_tokens = int(cfg.enc_len)
        elif cfg.family == "vlm":
            self._enc_tokens = int(cfg.n_img_tokens)
        else:
            self._enc_tokens = 0
        # vlm feeds placeholder tokens for the image prefix; the forward
        # swaps their embeddings for the run's rows
        self._feed_prefix = self._enc_tokens if cfg.family == "vlm" else 0
        self._enc_spec: Optional[PG.PagingSpec] = None
        self._enc_pages = 0   # pages a run draws from the shared pool
        self._enc: Optional[EncRun] = None
        self._enc_kw: Dict[str, torch.Tensor] = {}  # this tick's rows
        # rid -> encoded rows (on the device), from first staging until the
        # request ends: every readmission re-attaches the same rows
        self._enc_rows: Dict[int, torch.Tensor] = {}
        if self._enc_tokens:
            E = self._enc_tokens
            if self.spec is not None:
                self._enc_spec = PG.PagingSpec(
                    page_size=self.spec.page_size,
                    n_pages=self.spec.n_pages,
                    max_pages=self.spec.pages_for(E))
                self._enc_pages = self._enc_spec.max_pages
            else:
                self._enc_spec = PG.PagingSpec(page_size=E, n_pages=slots,
                                               max_pages=1)
            self._enc = EncRun(self._enc_table0(), PG.store_init(
                self._enc_spec, (cfg.d_model,), T.torch_dtype(cfg),
                self.device))
        self.queue: Deque[Request] = collections.deque()
        self.ticks = 0  # lifetime tick count (stat, never a per-call budget)
        # the eager loop's host state: its slots and their positions
        self.slots = [_Slot() for _ in range(slots)]
        self.pos = np.zeros(slots, np.int32)
        self._eager_syncs = 0  # blocking reads of the eager loop (lifetime)
        self._eager_toks = 0   # tokens the eager loop emitted (lifetime)
        self._bf_carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
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
                spec = OV.get_overlay(OV.resolve_kind(cfg, u.kind))
                if not isinstance(spec, OV.UnitOverlay):
                    raise ValueError(
                        f"kind {u.kind!r} has no per-slot overlay "
                        "(registered via the legacy register_unit_folder); "
                        "it can fold offline but not personalise per slot")
                if u.kind not in T.overlay_kinds(cfg, u.layer):
                    # the JAX engine serves the base weights for such a
                    # unit without a word
                    raise ValueError(
                        f"kind {u.kind!r} of layer {u.layer} is not one the "
                        f"per-slot forward applies there "
                        f"({T.overlay_kinds(cfg, u.layer)}): its deltas "
                        "would be carried and never served")
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
        # the image prefix (vlm) takes KV rows as prompt tokens do
        n += self._feed_prefix
        if n >= budget - 1:
            raise ValueError(
                f"prompt of length {n} cannot fit: the engine evicts at "
                f"position max_len - 1 = {budget - 1}, so prompts must "
                f"leave room to generate (len(prompt) <= max_len - 2 = "
                f"{budget - 2})")
        if req.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {req.max_new}")
        if req.enc_feats is not None and self._enc_tokens:
            shape = tuple(np.shape(req.enc_feats))
            if shape != self.cfg.enc_feats_shape:
                raise ValueError(
                    f"enc_feats shape {shape} does not match the config's "
                    f"encoder geometry {self.cfg.enc_feats_shape}")
        if req.delta_set is not None and self.personalise is not None:
            self._delta_rows(req.delta_set)  # shape/structure check
        if self.spec is not None:
            need = self._price(self.spec.pages_for(budget))
            if need > self.spec.n_pages:
                raise ValueError(
                    f"request needs {need} pages (incl. {self._enc_pages} "
                    f"encoder-run pages) but the pool holds only "
                    f"{self.spec.n_pages}: it could never be admitted")

    def backlog_size(self) -> int:
        """Un-admitted host state: queued + staged + awaiting restage."""
        return len(self.queue) + len(self._staged) + len(self._requeue)

    def _reject_reason(self, req: Request) -> Optional[str]:
        """A request the engine must not serve as it is: an
        encoder-decoder or vlm config never decodes without its encoder
        inputs, any other config must not silently ignore them, and deltas
        for an engine with no arena to park them in would be dropped."""
        if self._enc_tokens and req.enc_feats is None:
            return "missing_enc_feats"
        if not self._enc_tokens and req.enc_feats is not None:
            return "unexpected_enc_feats"
        if self.personalise is None and req.delta_set is not None:
            return "unexpected_delta_set"
        return None

    def submit(self, req: Request) -> SubmitResult:
        """Enqueue one request.  A malformed request raises; a full queue
        (``queue_limit``), missing or unexpected ``enc_feats``, or deltas
        sent to an engine without personalisation return a typed
        rejection and mark the request ``outcome='rejected'``."""
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
        cache rows realign with the unpreempted run.  On a vlm config the
        feed leads with ``n_img_tokens`` placeholder tokens, whose
        embeddings the forward swaps for the image prefix."""
        parts = [np.asarray(req.prompt, np.int32)]
        if self._feed_prefix:
            parts.insert(0, np.zeros(self._feed_prefix, np.int32))
        if req.out:
            parts.append(np.asarray(req.out, np.int32))
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

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

    def _enc_table0(self) -> torch.Tensor:
        """A fresh run table: all unmapped when paged, the identity (slot
        s -> page s) when not."""
        if self._enc_pages:
            return torch.full((self.n_slots, self._enc_pages), -1,
                              dtype=torch.int32, device=self.device)
        return torch.arange(self.n_slots, dtype=torch.int32,
                            device=self.device)[:, None]

    def _encode_cached(self, rid: int, req: Request) -> torch.Tensor:
        """Request ``rid``'s encoded rows (enc_tokens, d_model) in the
        model's dtype on the engine's device: computed once, at first
        staging (whisper's encoder, or paligemma's features cast to the
        model's dtype through ``img_proj``), and the same tensor on every
        readmission."""
        hit = self._enc_rows.get(rid)
        if hit is None:
            dtype = T.torch_dtype(self.cfg)
            feats = torch.from_numpy(np.ascontiguousarray(
                req.enc_feats, dtype=np.float32)).to(self.device).to(dtype)
            with torch.no_grad():
                if self.cfg.is_encoder_decoder:
                    hit = T.encode(self.cfg, self.params, feats[None])[0]
                else:
                    hit = feats @ self.params["img_proj"]
            self._enc_rows[rid] = hit
        return hit

    def _write_enc(self, table: torch.Tensor, rows: torch.Tensor,
                   mask: torch.Tensor) -> None:
        """Park ``rows`` (slots, enc_tokens, d_model) in the ``mask``
        slots' runs of ``table`` (in place) and adopt ``table``."""
        E = self._enc_tokens
        PG.write_rows(self._enc.store, table, self._enc_spec,
                      torch.zeros_like(mask, dtype=torch.int32), rows,
                      mask[:, None].expand(self.n_slots, E))
        self._enc = self._enc._replace(table=table)

    def _read_enc(self) -> Dict[str, torch.Tensor]:
        """Gather every slot's run through its table into the forward's
        kwargs: ``enc_out`` on an encoder-decoder config, ``embed_prefix``
        on a vlm one ({} elsewhere).  An unmapped slot reads page 0,
        finite rows whose outputs are never emitted."""
        if not self._enc_tokens:
            return {}
        rows = PG.read_rows(self._enc.store, self._enc.table,
                            self._enc_spec, T.torch_dtype(self.cfg))
        rows = rows[:, :self._enc_tokens]
        if self.cfg.is_encoder_decoder:
            return {"enc_out": rows}
        return {"embed_prefix": rows}

    def _fwd_kwargs(self) -> Dict[str, Any]:
        """Forward kwargs of both tick kinds: this tick's encoder rows
        (:meth:`_read_enc`, gathered once a tick) and, under
        personalisation, the arena as the per-slot overlay with the policy
        that names its layers."""
        kw = dict(self._enc_kw)
        if self.personalise is not None:
            kw.update(overlay=self._arena, plan=self.personalise)
        return kw

    def _admit_pages(self, feed_len: int, budget: int) -> int:
        """Pages reserved at admission: the feed's own demand under
        reserve-as-you-go (growth covers generation), the whole KV budget
        under worstcase."""
        if self.spec is None:
            return 0
        return int(self.spec.pages_for(feed_len if self.rayg else budget))

    def _price(self, kv_pages):
        """A request's admission price in pages: its KV reservation plus
        its encoder run (none without one), for an int or an int32 tensor
        of reservations alike (the eager loop's and the fused plan's)."""
        return kv_pages + self._enc_pages

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
            rid=self._i32(s) - 1, sid=self._i32(s) - 1, pages=self._i32(s),
            ttl=self._i32(s), tok_base=self._i32(s),
            preempt_left=self._i32(s))

    def _make_pending(self) -> PendingBuffer:
        # rebuilt (and uploaded) only when the staged set changed
        if not self._pending_dirty and self._pending_cache is not None:
            return self._pending_cache
        P, maxp = self.pending_size, self.max_len
        prompt = np.zeros((P, maxp), np.int32)
        ints = {k: np.zeros((P,), np.int32) for k in (
            "length", "max_new", "budget", "n_pages", "ttl", "tok_base",
            "preempt_left")}
        rid = np.full((P,), -1, np.int32)
        sid = np.full((P,), -1, np.int32)
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
            sid[j] = r if req.sample_id is None else req.sample_id
            ints["tok_base"][j] = len(req.out)
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
        enc = None
        if self._enc_tokens:
            # each staged request's encoded rows, encoded at first staging
            # and the same tensor on every restage
            enc = torch.stack([self._encode_cached(r, req)
                               for r, req in self._staged]
                              or [self._enc.store["pages"].new_zeros(
                                  (self._enc_tokens, self.cfg.d_model))])
        self._pending_cache = PendingBuffer(
            prompt=up(prompt), rid=up(rid), sid=up(sid), delta=delta,
            enc=enc,
            **{k: up(a) for k, a in ints.items()},
            count=torch.tensor(len(self._staged), dtype=torch.int32,
                               device=dev),
            age=torch.tensor(self._head_age, dtype=torch.int32, device=dev))
        self._pending_dirty = False
        return self._pending_cache

    def _plan(self, st: SlotState, pend: PendingBuffer, head: torch.Tensor,
              pool: Optional[PG.PagePool], backlog: bool,
              live: torch.Tensor, gt: int = 0,
              bf: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> TickPlan:
        """Admission, page growth and preemption for one tick, on the
        device and functional.  ``live`` is the previous tick's flag; the
        plan's own latches False when the chunk loop's exit test holds on
        the state *before* admission (pending drained and either no slot
        active, or a free slot while the host holds more queued work), and
        every mask of the plan is predicated on it.  ``block`` chooses the
        block-prefill forward (some slot prefills, or a slot stalled for
        want of a page).  ``gt`` is the global tick (a host int: the fault
        window reads no device value); ``bf`` the backfill carry (taken
        mask, head age) of a backfilling engine."""
        P, spec, faults = self.pending_size, self.spec, self.faults
        free = ~st.active
        rank = torch.cumsum(free.to(torch.int32), 0) - 1
        if bf is not None:
            # backfill admits by a taken mask: the eligible entries (valid,
            # not yet admitted) claim free slots in index order, the head
            # cursor's order until a backfill skips past a blocked head
            taken, age = bf
            idxp = torch.arange(P, device=self.device)
            elig = ~taken & (idxp < pend.count)
            n_elig = elig.sum(dtype=torch.int32)
            drained = n_elig == 0
        else:
            drained = head >= pend.count
        stop = drained & (~st.active.any() | (free.any() & backlog))
        live = live & ~stop
        if bf is not None:
            order = torch.argsort(torch.where(elig, idxp, P + idxp))
            fifo = free & (rank < n_elig) & live
            src = order[rank.clamp(0, P - 1)]
        else:
            fifo = free & (head + rank < pend.count) & live
            src = (head + rank).clamp(0, P - 1).long()
        enc_pages = self._enc_pages  # a request's run, priced with its KV
        enc_table = self._enc.table if self._enc is not None else None
        if spec is not None:
            # a candidate is admitted only if the demand up to and
            # including it fits the free-list: every request needs >= 1
            # page, so admission stays FIFO with head-of-line blocking
            need = torch.where(fifo, pend.n_pages[src], 0)
            price = torch.where(fifo, self._price(need), 0)
            avail = PG.free_page_count(pool)
            take = fifo & (torch.cumsum(price, 0) <= avail)
            if bf is not None:
                # at most one backfill a tick: with the head blocked, the
                # first later entry whose whole price fits the pages left
                # admits into the first slot left free, while the head's
                # bypasses stay under the bound
                left = avail - torch.where(take, price, 0).sum()
                taken = taken | ((src[:, None] == idxp[None, :])
                                 & take[:, None]).any(dim=0)
                cand = elig & ~taken & (self._price(pend.n_pages) <= left)
                head_blocked = (n_elig > 0) & ~taken.gather(0, order[:1])[0]
                slots_left = free & ~take
                first_left = slots_left & (
                    torch.cumsum(slots_left.to(torch.int32), 0) == 1)
                do_bf = (live & head_blocked & cand.any() & slots_left.any()
                         & (age < self._backfill))
                pick = torch.argmax(cand.to(torch.int32))
                take2 = first_left & do_bf
                src = torch.where(take2, pick, src)
                take = take | take2
                need = torch.where(take, pend.n_pages[src], 0)
                taken = taken | ((idxp == pick) & do_bf)
                age = torch.where(
                    live, torch.where(do_bf, age + 1,
                                      torch.where(head_blocked, age, 0)),
                    age)
                bf = (taken, age)
            pool = PG.reserve(pool, need, take)
            if enc_pages:
                pool, enc_table = PG.reserve_run(
                    pool, enc_table,
                    torch.full_like(need, enc_pages), take)
        else:
            take = fifo

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
            sid=sel(pend.sid[src], st.sid) if self._keyed else st.sid,
            pages=sel(pend.n_pages[src], st.pages),
            ttl=sel(pend.ttl[src], st.ttl),
            tok_base=(sel(pend.tok_base[src], st.tok_base) if self._keyed
                      else st.tok_base),
            preempt_left=sel(pend.preempt_left[src], st.preempt_left))
        n_admit = take.sum(dtype=torch.int32)
        # event snapshots: a slot preempted this tick still reports its rid;
        # a dead tick reports no resident
        act = st.active & live
        rid_row, active_row = torch.where(act, st.rid, -1), act
        prefilling = act & (st.cursor < st.prompt_len)
        pre_requeue = pre_final = torch.zeros_like(st.active)
        stalled = torch.zeros_like(st.active)
        if self.rayg:
            # a generating slot crossing a page boundary claims its next
            # page; grants go oldest rid first while the free-list lasts
            # (none inside a forced-exhaustion window)
            grow = (act & ~prefilling
                    & (spec.pages_for(st.pos + 1) > st.pages))
            if (faults is not None and faults.exhaust_ticks is not None
                    and FI.exhausted(faults, gt)):
                granted = torch.zeros_like(grow)
            else:
                prio = torch.where(grow, st.rid,
                                   torch.iinfo(torch.int32).max)
                before = (prio[None, :] < prio[:, None]).sum(
                    dim=1, dtype=torch.int32)
                granted = grow & (before < PG.free_page_count(pool))
            pool = PG.extend(pool, granted.to(torch.int32), granted, st.pages)
            st = st._replace(pages=st.pages + granted.to(torch.int32))
            stalled = grow & ~granted
        force = faults is not None and bool(faults.force_preempt)
        if self.rayg or force:
            # preemption: pool exhaustion preempts the youngest resident,
            # and the fault plan its targets; pages go back, the slot
            # frees, and the host requeues the stream (or ends it
            # 'preempted' once its retry budget is spent)
            victims = None
            if force:
                emitted = (torch.clamp(st.pos - st.prompt_len, min=0)
                           + st.tok_base)
                victims = act & FI.preempt_hit(faults, st.rid, emitted,
                                               st.tok_base)
            if self.rayg:
                vrid = torch.where(st.active, st.rid, -1)
                youngest = ((torch.arange(self.n_slots, device=self.device)
                             == torch.argmax(vrid)) & act)
                stall = stalled.any() & youngest
                victims = stall if victims is None else victims | stall
            pre_final = victims & (st.preempt_left <= 0)
            pre_requeue = victims & ~pre_final
            if pool is not None:
                pool = PG.release(pool, victims)
                if enc_pages:
                    # the victim's run goes back too; its readmission
                    # reserves a fresh one and re-attaches the same rows
                    pool, enc_table = PG.release_run(pool, enc_table,
                                                     victims)
            st = st._replace(active=st.active & ~victims,
                             rid=torch.where(victims, -1, st.rid),
                             pages=torch.where(victims, 0, st.pages))
            stalled = stalled & st.active
            prefilling = prefilling & st.active
        block = ((prefilling.any() & (self.prefill_block > 1))
                 | stalled.any())
        taken_c, age_c = bf if bf is not None else (None, None)
        return TickPlan(st, pool, take, src, n_admit, head + n_admit, rid_row,
                        active_row, pre_requeue, pre_final, live, block,
                        taken_c, age_c, enc_table)

    def _forward(self, st: SlotState, act: torch.Tensor,
                 prefilling: torch.Tensor, block: torch.Tensor,
                 known=lambda: None, block_first: bool = False):
        """One tick's forward over every slot: (last logits (slots, vocab),
        tokens consumed per slot).  The device picks between the two
        programs: the block prefill runs the prefilling slots when
        ``block`` holds (pausing every other slot), the single-token decode
        runs the ``act`` slots when it does not; the masked slots of each
        write nothing, and ``torch.where`` selects.  ``known()`` gives the
        tick's (live, block) flags where the host has them without waiting:
        then the unchosen program is not issued (neither is either program
        of a dead tick).  ``block_first`` orders the two.  An engine that
        can never take a block tick (prefill block 1 without page growth)
        issues the decode alone."""
        progs = [self._decode_program, self._block_program]
        if self.prefill_block == 1 and not self.rayg:
            progs = progs[:1]
        elif block_first:
            progs.reverse()
        out: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}
        for prog in progs:
            flags = known()
            if flags is not None:
                live, blk = flags
                if not live:  # a dead tick: every slot is masked
                    return (torch.zeros((self.n_slots, self.cfg.vocab),
                                        device=self.device),
                            torch.zeros_like(st.cursor))
                chosen = self._block_program if blk else self._decode_program
                if chosen in out:
                    return out[chosen]
                return chosen(st, act, prefilling, block)
            out[prog] = prog(st, act, prefilling, block)
        if len(out) == 1:
            return out[self._decode_program]
        (logits, n_tok), (blk_logits, n_blk) = (
            out[self._decode_program], out[self._block_program])
        return (torch.where(block, blk_logits, logits),
                torch.where(block, n_blk, n_tok))

    def _decode_program(self, st: SlotState, act: torch.Tensor,
                        prefilling: torch.Tensor, block: torch.Tensor):
        """The single-token decode over the ``act`` slots of a decode tick
        (every slot is masked in a block tick)."""
        maxp = self.max_len
        ptok = st.prompt.gather(
            1, st.cursor.clamp(0, maxp - 1)[:, None].long())[:, 0]
        tok = torch.where(act, torch.where(prefilling, ptok, st.last_tok), 0)
        return self._decode_fwd(tok, st.pos, act & ~block)

    def _decode_fwd(self, tok: torch.Tensor, pos: torch.Tensor,
                    step: torch.Tensor):
        """``decode_step`` of one token a slot over the ``step`` slots:
        (logits (slots, vocab), tokens consumed per slot)."""
        self._forwards += 1
        logits, self.caches = T.decode_step(
            self.cfg, self.params, tok[:, None].long(), self.caches, pos,
            step, drop_free=True, **self._fwd_kwargs())
        return logits[:, 0], step.to(torch.int32)

    def _block_program(self, st: SlotState, act: torch.Tensor,
                       prefilling: torch.Tensor, block: torch.Tensor):
        """The block prefill over the prefilling slots of a block tick (every
        slot is masked in a decode tick)."""
        B, maxp = self.prefill_block, self.max_len
        n_blk = torch.where(
            prefilling & block,
            torch.clamp(st.prompt_len - st.cursor, max=B), 0).to(torch.int32)
        j = torch.arange(B, device=self.device)[None, :]
        valid = j < n_blk[:, None]
        gidx = (st.cursor[:, None] + j).clamp(0, maxp - 1)
        toks = torch.where(valid, st.prompt.gather(1, gidx), 0)
        return self._block_fwd(toks, st.pos, valid, n_blk)

    def _block_fwd(self, toks: torch.Tensor, pos: torch.Tensor,
                   valid: torch.Tensor, n_blk: torch.Tensor):
        """``prefill_block`` of a (slots, B) block with its left-aligned
        ``valid`` mask: (each slot's last valid logits, ``n_blk``)."""
        self._forwards += 1
        B = toks.shape[1]
        logits, self.caches = T.prefill_block(
            self.cfg, self.params, toks.long(), self.caches, pos, valid,
            drop_free=True, **self._fwd_kwargs())
        last = (n_blk - 1).clamp(0, B - 1).long()
        idx = last[:, None, None].expand(-1, 1, logits.shape[-1])
        return logits.gather(1, idx)[:, 0], n_blk

    def _pick(self, logits: torch.Tensor, sid: torch.Tensor,
              tok_idx: torch.Tensor) -> torch.Tensor:
        """Next token of each row of (slots, vocab) logits.  Greedy at
        temperature 0: ``argmax`` returns the first maximum, as
        ``jnp.argmax`` does, and no sampler op is issued.  Otherwise the
        JAX engine's draw: ``argmax(gumbel + logits / T)`` with logits
        below the k-th largest at -inf (ties at the k-th value kept, as
        ``lax.top_k``'s threshold keeps them), the noise from
        ``fold_in(fold_in(key, sid), tok_idx)``."""
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        lg = logits.float() * self._inv_temp
        if self.top_k > 0:
            kth = torch.topk(lg, self.top_k, dim=-1).values[..., -1:]
            lg = lg.masked_fill(lg < kth, float("-inf"))
        keys = prng.fold_in(prng.fold_in(self._key.expand(len(sid), 2), sid),
                            tok_idx)
        g = prng.gumbel(keys, lg.shape[-1])
        return torch.argmax(g + lg, dim=-1).to(torch.int32)

    def _post(self, logits: torch.Tensor, rid: torch.Tensor,
              sid: torch.Tensor, tok_idx) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both loops' step from logits to (picked token, finite row): the
        fault plan's NaN rows, the finiteness guard, the pick.
        ``tok_idx`` is a callable, evaluated only when a draw or a fault
        needs it, so a greedy faultless tick issues exactly what it did."""
        nan_on = self.faults is not None and bool(self.faults.nan_logits)
        idx = tok_idx() if (nan_on or self.temperature > 0) else None
        if nan_on:
            hit = FI.nan_hit(self.faults, rid, idx)
            logits = torch.where(hit[:, None], float("nan"), logits)
        finite = torch.isfinite(logits).all(dim=-1)
        return self._pick(logits, sid, idx), finite

    def _advance(self, plan: TickPlan, known=lambda: None,
                 block_first: bool = False):
        """Forward plus lifecycle advance, predicated on ``plan.live``
        (``known`` and ``block_first`` as in :meth:`_forward`).  Returns
        (state, pool, event row)."""
        st, pool = plan.state, plan.pool
        act = st.active & plan.live
        prefilling = act & (st.cursor < st.prompt_len)
        logits, n_tok = self._forward(st, act, prefilling, plan.block, known,
                                      block_first)
        cursor = torch.where(prefilling, st.cursor + n_tok, st.cursor)
        emit = act & (n_tok > 0) & (~prefilling | (cursor >= st.prompt_len))
        pos = st.pos + n_tok
        # each slot's next emit is token (pos - prompt_len) of its feed's
        # generation plus the tokens it had at staging: the schedule-free
        # coordinate the sampler and the fault plan key on.  A non-finite
        # row on an emitting slot suppresses the emit and terminates the
        # stream instead of feeding back garbage
        next_tok, finite = self._post(
            logits, st.rid, st.sid,
            lambda: torch.clamp(pos - st.prompt_len, min=0) + st.tok_base)
        bad = emit & ~finite
        good_emit = emit & finite
        remaining = st.remaining - good_emit.to(torch.int32)
        done = act & ~bad & ((remaining <= 0) | (pos >= st.budget - 1))
        trunc = done & (remaining > 0)
        # the deadline counts resident ticks, this tick's preempted slot's
        # included (the host ledger counts the same event rows)
        ttl = st.ttl - plan.active_row.to(torch.int32)
        expired = act & ~bad & ~done & (ttl <= 0)
        term = done | bad | expired
        outcome = torch.zeros_like(st.cursor)
        outcome = torch.where(done, OUTCOME_DONE, outcome)
        outcome = torch.where(trunc, OUTCOME_TRUNCATED, outcome)
        outcome = torch.where(expired, OUTCOME_EXPIRED, outcome)
        outcome = torch.where(bad, OUTCOME_NUMERICS, outcome)
        outcome = torch.where(plan.pre_requeue, OUTCOME_REQUEUED, outcome)
        outcome = torch.where(plan.pre_final, OUTCOME_PREEMPTED, outcome)
        cols = [plan.rid_row, torch.where(good_emit, next_tok, -1), outcome,
                plan.active_row.any().to(torch.int32)[None],
                plan.n_admit[None], plan.live.to(torch.int32)[None]]
        if plan.age is not None:
            cols.append(plan.age[None])  # the head's age, fetched with the rows
        row = torch.cat(cols)
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
            if self._enc_pages:
                pool, table = PG.release_run(pool, self._enc.table, term)
                self._enc = self._enc._replace(table=table)
            PG.set_page_table(self.caches, pool.table)
        return st, pool, row

    # ------------------------------------------------------------------
    # Chunks: stage -> tick loop -> one fetch of the event rows
    # ------------------------------------------------------------------

    def has_work(self) -> bool:
        """Anything queued, staged, resident or awaiting requeue?"""
        return bool(self.queue or self._staged or self._live
                    or self._requeue)

    def _rid_for(self, req: Request) -> int:
        """The rid of a request leaving the queue, in submission order: the
        one an eager backfill scan assigned it when it skipped past it, or
        the next."""
        r = self._eager_rids.pop(id(req), None)
        if r is None:
            r = self._next_rid
            self._next_rid += 1
        return r

    def _tick(self, st: SlotState, pend: PendingBuffer, head: torch.Tensor,
              pool: Optional[PG.PagePool], backlog: bool,
              live: torch.Tensor, t: int = 0,
              probe: Optional[_FlagProbe] = None):
        """Tick ``t`` of the chunk loop, issued with no host read and
        predicated on ``live``; its flags go to ``probe``.  Returns (head,
        live, state, pool, event row); a backfilling engine carries its
        taken mask and head age in ``_bf_carry``."""
        plan = self._plan(st, pend, head, pool, backlog, live,
                          self.ticks + t, self._bf_carry)
        if plan.taken is not None:
            self._bf_carry = (plan.taken, plan.age)
        known, block_first = (lambda: None), False
        if probe is not None:
            probe.post(t, plan.live, plan.block)
            known, block_first = (lambda: probe.flags_of(t)), probe.last_block
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
        if self._enc_tokens:
            # park each admitted request's encoded rows in its new run (a
            # victim preempted in the same tick has no run left: its rows
            # drop), then gather every slot's run for this tick's forward
            self._write_enc(plan.enc_table,
                            pend.enc[plan.src.clamp(
                                max=pend.enc.shape[0] - 1)], plan.take)
            self._enc_kw = self._read_enc()
        st, pool, row = self._advance(plan, known, block_first)
        return plan.head, plan.live, st, pool, row

    def _dispatch(self, budget: int) -> List[torch.Tensor]:
        """Stage queued work and issue ``budget`` ticks with no host read;
        returns their event rows (still on the device), the live ticks
        first."""
        # preempted streams restage first, in preemption order
        while self._requeue and len(self._staged) < self.pending_size:
            self._staged.appendleft(self._requeue.pop())
            self._pending_dirty = True
        while self.queue and len(self._staged) < self.pending_size:
            req = self.queue.popleft()
            rid = self._rid_for(req)
            self._attach_delta(req)
            self._by_rid[rid] = req
            self._staged.append((rid, req))
            self._pending_dirty = True
        # backlog: host work beyond the pending buffer; the chunk exits
        # early (on the device) if the buffer drains while a slot is free,
        # so the freed slot refills from the host instead of idling out
        # the chunk
        backlog = bool(self.queue or self._requeue)
        pend = self._make_pending()
        head = torch.zeros((), dtype=torch.int32, device=self.device)
        live = torch.ones((), dtype=torch.bool, device=self.device)
        if self._backfill:
            self._bf_carry = (torch.zeros(self.pending_size, dtype=torch.bool,
                                          device=self.device), pend.age)
        st, pool = self._state, self.pool
        rows: List[torch.Tensor] = []
        probe = _FlagProbe(self.device, budget) if self.skip_masked else None
        with _sync_debug(self.device, self.tick_sync_debug):
            for t in range(budget):
                if probe is not None and probe.poll():
                    break  # the chunk is known to have exited
                head, live, st, pool, row = self._tick(
                    st, pend, head, pool, backlog, live, t, probe)
                rows.append(row)
        self._state, self.pool = st, pool
        return rows

    def _drain(self, rows: List[torch.Tensor], fr: Dict[str, Any]) -> None:
        """Fetch a chunk's event rows (its one sync) and book the live
        ticks; the rows of ticks after the exit hold no event."""
        fr["chunks"] += 1
        ev = _telemetry._fetch(torch.stack(rows))
        S = self.n_slots
        n_live = int(ev[:, 3 * S + 2].sum())
        age = int(ev[-1, 3 * S + 3]) if self._backfill else None
        ev = ev[:n_live]
        rids, toks, outs = ev[:, :S], ev[:, S:2 * S], ev[:, 2 * S:3 * S]
        act, n_admit = ev[:, 3 * S], ev[:, 3 * S + 1]
        if n_live:
            # per-slot occupancy at the last executed tick: the resident
            # map swap_deltas targets between chunks (terminal rids resolve
            # to no live request)
            self._slot_rids = rids[-1].copy()
        if self._backfill:
            # admission by taken mask: a staged entry was admitted this
            # chunk iff its rid is in the event rows (a staged entry is
            # never resident when the chunk starts), and the head's age
            # came back in the same fetch
            seen = set(np.unique(rids[rids >= 0]).tolist())
            kept: Deque[Tuple[int, Request]] = collections.deque()
            for rid, req in self._staged:
                if rid in seen:
                    self._live.add(rid)
                    self._pending_dirty = True
                else:
                    kept.append((rid, req))
            self._staged = kept
            if age != self._head_age:
                self._head_age = age
                self._pending_dirty = True
        else:
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
            self._enc_rows.pop(rid, None)
        used = int(act.sum())
        fr["used"] += used
        self.ticks += used
        fr["dispatched"] += n_live
        fr["issued"] += len(rows)
        fr["toks"] += int((toks >= 0).sum())
        if n_live:
            fr["peak"] = max(fr["peak"], int((rids >= 0).sum(axis=1).max()))

    # -- the fused run, split: begin -> (dispatch -> drain)* -> finish.
    # run() composes them for one engine; a caller driving several engines
    # may dispatch each before draining any, and each engine books only
    # its own fetches

    def fused_begin(self, chunk: Optional[int] = None) -> None:
        """Open a fused run: check the mode, build the carries, zero the
        run's counters."""
        if any(sl.req is not None for sl in self.slots):
            raise RuntimeError(
                "eager slots busy; drain step() work before a fused run")
        chunk = self.chunk if chunk is None else int(chunk)
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if self._state is None:
            self._state = self._init_state()
        self._frun = {"chunk": chunk, "used": 0, "chunks": 0,
                      "dispatched": 0, "issued": 0, "peak": 0, "syncs": 0,
                      "toks": 0, "busy_s": 0.0, "forwards0": self._forwards}

    def fused_dispatch(self, budget: Optional[int] = None
                       ) -> Optional[List[torch.Tensor]]:
        """Stage work and issue one chunk of at most ``budget`` ticks with
        no host read; returns its event rows, undrained on the device, for
        :meth:`fused_drain`, or None when the engine has no work."""
        if not self.has_work():
            return None
        fr = self._frun
        t0, s0 = time.perf_counter(), _telemetry.host_sync_count()
        budget = (fr["chunk"] if budget is None
                  else min(fr["chunk"], int(budget)))
        rows = self._dispatch(budget)
        fr["syncs"] += _telemetry.host_sync_count() - s0
        fr["busy_s"] += time.perf_counter() - t0
        return rows

    def fused_drain(self, handle: List[torch.Tensor]) -> None:
        """Fetch one dispatched chunk's event rows (``handle``, what
        :meth:`fused_dispatch` returned; the chunk's one host sync) and
        book them."""
        t0, s0 = time.perf_counter(), _telemetry.host_sync_count()
        self._drain(handle, self._frun)
        self._frun["syncs"] += _telemetry.host_sync_count() - s0
        self._frun["busy_s"] += time.perf_counter() - t0

    def fused_finish(self) -> None:
        """Close the run: publish ``last_run_report``."""
        fr = self._frun
        self.last_run_report = {
            "ticks": fr["used"], "chunks": fr["chunks"],
            # every blocking device->host read made inside this engine's
            # dispatch and drain calls (the host makes those calls one
            # after another, so interleaved engines never share one): one
            # event fetch a drained chunk, and any other read shows here
            "host_syncs": fr["syncs"],
            "ticks_dispatched": fr["dispatched"],
            # ticks and forward programs the host issued, the masked ones
            # included (fewer under skip_masked)
            "ticks_issued": fr["issued"],
            "forwards_issued": self._forwards - fr["forwards0"],
            "peak_resident": fr["peak"],
            "new_tokens": fr["toks"],
            # host wall time inside this engine's dispatch and drain calls
            "busy_seconds": fr["busy_s"],
            "outcomes": dict(self._tally),
            "memory": self.memory_report(),
        }

    def _run_fused(self, max_ticks: int, chunk: Optional[int]) -> None:
        self.fused_begin(chunk)
        fr = self._frun
        while self.has_work() and fr["used"] < max_ticks:
            rows = self.fused_dispatch(max_ticks - fr["used"])
            if rows is None:
                break
            self.fused_drain(rows)
        self.fused_finish()

    def evacuate(self) -> List[Request]:
        """Pull every unfinished request off this engine (a failed
        replica): queued, staged, requeued and resident alike, in
        submission order, and clear the host's scheduling state.  The
        device state is abandoned (the next run starts cold, with every
        page free).  An orphan without a ``sample_id`` takes the rid it
        drew (or would have drawn) under here as its own, so a
        resubmission elsewhere resumes through the recompute swap (the
        prompt plus the generated prefix) and draws the same tokens.  The deadline clock restarts on the adopting
        engine."""
        held: Dict[int, Request] = dict(self._by_rid)
        held.update((rid, req) for rid, req in self._requeue)
        held.update((sl.rid, sl.req) for sl in self.slots
                    if sl.req is not None)
        orphans = [req for _, req in sorted(held.items())]
        for req in self.queue:  # the rids they would have drawn under
            held[self._rid_for(req)] = req
            orphans.append(req)
        for rid, req in held.items():
            if req.sample_id is None:
                req.sample_id = rid
        self.queue.clear()
        self._staged.clear()
        self._requeue.clear()
        self._by_rid.clear()
        self._live.clear()
        self._resident.clear()
        self._eager_rids.clear()
        self._enc_rows.clear()
        if self._enc is not None:
            self._enc = self._enc._replace(table=self._enc_table0())
        self.slots = [_Slot() for _ in range(self.n_slots)]
        self._pending_dirty = True
        self._pending_cache = None
        self._slot_rids = np.full((self.n_slots,), -1, np.int32)
        self._head_age = 0
        self._state = None
        if self.spec is not None:
            self.pool = PG.make_pool(self.spec, self.n_slots, self.device)
            PG.set_page_table(self.caches, self.pool.table)
        return orphans

    # ------------------------------------------------------------------
    # The eager loop (fused=False): one tick a call, the host in charge
    # ------------------------------------------------------------------


    def _up(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _write_arena(self, mask: np.ndarray, rows: Any) -> None:
        """Write one request's arena row into every ``mask`` slot with one
        select per leaf."""
        m = self._up(mask)

        def one(a, v):
            return torch.where(m.reshape((-1,) + (1,) * v.dim()), v[None], a)

        self._arena = tree_map(one, self._arena, rows)

    def _backfill_pick(self, free_pages: int):
        """The first pending entry (requeued, then queued, each in order)
        whose admission price fits ``free_pages``, taken off its deque:
        (rid, req, resumed, feed, budget, pages) or None.  Queued entries
        it skips get their rids now, so rids stay in submission order."""
        for qi, (rid, req) in enumerate(self._requeue):
            budget = self.request_budget(req)
            feed = self._feed(req)
            want = self._admit_pages(len(feed), budget)
            if self._price(want) <= free_pages:
                del self._requeue[qi]
                return rid, req, True, feed, budget, want
        for qi, req in enumerate(self.queue):
            if id(req) not in self._eager_rids:
                self._eager_rids[id(req)] = self._next_rid
                self._next_rid += 1
            budget = self.request_budget(req)
            feed = self._feed(req)
            want = self._admit_pages(len(feed), budget)
            if self._price(want) <= free_pages:
                rid = self._eager_rids.pop(id(req))
                del self.queue[qi]
                self._attach_delta(req)
                return rid, req, False, feed, budget, want
        return None

    def _admit(self) -> None:
        """Free slots take work, requeued streams before fresh ones, FIFO
        with head-of-line blocking on pages (or one backfill past a
        blocked head); the host reads the free-page count to price it."""
        mask = np.zeros(self.n_slots, bool)
        need = np.zeros(self.n_slots, np.int32)
        free_pages = 0
        if self.spec is not None and (self.queue or self._requeue):
            free_pages = int(_telemetry._fetch(
                PG.free_page_count(self.pool)))
        backfilled = False
        for i, sl in enumerate(self.slots):
            if sl.req is not None or not (self._requeue or self.queue):
                continue
            if self._requeue:
                rid, req = self._requeue[0]
                resumed = True
            else:
                rid, req = -1, self.queue[0]
                resumed = False
            budget = self.request_budget(req)
            feed = self._feed(req)
            picked = None
            if self.spec is not None:
                # the price: the KV demand plus the pinned encoder run
                want = self._admit_pages(len(feed), budget)
                if self._price(want) > free_pages:
                    # head-of-line blocking, unless one later entry that
                    # fits may backfill this tick
                    if (self._backfill and not backfilled
                            and self._head_age < self._backfill):
                        picked = self._backfill_pick(free_pages)
                    if picked is None:
                        break
                    rid, req, resumed, feed, budget, want = picked
                    backfilled = True
                    self._head_age += 1
                free_pages -= self._price(want)
                need[i] = want
            if picked is None:
                if resumed:
                    self._requeue.popleft()
                else:
                    self.queue.popleft()
                    rid = self._rid_for(req)
                    self._attach_delta(req)
                self._head_age = 0
            self.slots[i] = _Slot(
                req=req, rid=rid,
                sid=rid if req.sample_id is None else req.sample_id,
                budget=budget, feed=feed, pages=int(need[i]),
                tok_base=len(req.out))
            self.pos[i] = 0
            mask[i] = True
            if backfilled:
                break  # the head still waits; this tick's backfill is spent
        if not mask.any():
            return
        m = self._up(mask)
        if self.spec is not None:
            self.pool = PG.reserve(self.pool, self._up(need), m)
            PG.set_page_table(self.caches, self.pool.table)
        T.reset_slot_state(self.caches, m)
        if self.personalise is not None:
            for i in np.nonzero(mask)[0]:
                one = np.zeros(self.n_slots, bool)
                one[i] = True
                self._write_arena(
                    one, self._delta_rows(self.slots[i].req.delta_set))
        if self._enc_tokens:
            # park each admitted request's encoded rows (the same rows on
            # every readmission) in its run
            rows = self._enc.store["pages"].new_zeros(
                (self.n_slots, self._enc_tokens, self.cfg.d_model))
            for i in np.nonzero(mask)[0]:
                rows[i] = self._encode_cached(self.slots[i].rid,
                                              self.slots[i].req)
            table = self._enc.table
            if self._enc_pages:
                self.pool, table = PG.reserve_run(
                    self.pool, table, torch.full(
                        (self.n_slots,), self._enc_pages, dtype=torch.int32,
                        device=self.device), m)
            self._write_enc(table, rows, m)

    def _preempt_slot(self, i: int, freed: np.ndarray) -> int:
        """Evict slot ``i`` mid-stream: requeue it (retries left) or end it
        ``preempted``.  Returns the outcome code."""
        sl = self.slots[i]
        req = sl.req
        if self._preempt_left(req) > 0:
            req.preempts += 1
            self._requeue.append((sl.rid, req))
            code = OUTCOME_REQUEUED
        else:
            req.outcome = OUTCOME_NAMES[OUTCOME_PREEMPTED]
            code = OUTCOME_PREEMPTED
            self._enc_rows.pop(sl.rid, None)
        freed[i] = True
        self.slots[i] = _Slot()
        return code

    def step(self) -> None:
        """One tick of the eager loop, the fused tick's lifecycle on the
        host: admission, page growth oldest rid first, the youngest
        resident preempted on a stall (and the fault plan's targets), the
        stall tick's paused generating slots, then emits, budgets,
        truncation, deadlines and the numerics guard, with the freed slots
        refilled in the same tick.  The forward is the fused tick's:
        ``decode_step`` over the live slots, or on a stall tick a
        one-token ``prefill_block`` over the prefilling ones."""
        if self._live or self._staged:
            raise RuntimeError(
                "fused run in flight; cannot interleave eager ticks")
        s0 = _telemetry.host_sync_count()
        try:
            self._step()
        finally:
            # every blocking read made inside the tick, booked to this
            # engine
            self._eager_syncs += _telemetry.host_sync_count() - s0

    def _step(self) -> None:
        self._admit()
        live = [i for i, sl in enumerate(self.slots) if sl.req is not None]
        if not live:
            return
        tally = self._tally
        # residency ledger: every live slot spends one resident tick, the
        # stalled ones and this tick's victims included
        for i in live:
            rid = self.slots[i].rid
            self._resident[rid] = self._resident.get(rid, 0) + 1
        prefilling = {i: self.slots[i].cursor < len(self.slots[i].feed)
                      for i in live}
        stalled: List[int] = []
        victims: List[int] = []
        if self.rayg:
            growers = [i for i in live if not prefilling[i]
                       and self.spec.pages_for(int(self.pos[i]) + 1)
                       > self.slots[i].pages]
            if growers:
                free = int(_telemetry._fetch(PG.free_page_count(self.pool)))
                faults = self.faults
                if (faults is not None and faults.exhaust_ticks is not None
                        and FI.exhausted(faults, self.ticks)):
                    free = 0
                grant = np.zeros(self.n_slots, bool)
                for i in sorted(growers, key=lambda i: self.slots[i].rid):
                    if free > 0:
                        free -= 1
                        grant[i] = True
                    else:
                        stalled.append(i)
                if grant.any():
                    g = self._up(grant)
                    held = np.asarray([sl.pages for sl in self.slots],
                                      np.int32)
                    self.pool = PG.extend(self.pool, g.to(torch.int32), g,
                                          self._up(held))
                    for i in np.nonzero(grant)[0]:
                        self.slots[i].pages += 1
                    PG.set_page_table(self.caches, self.pool.table)
        if self.faults is not None and self.faults.force_preempt:
            victims = [i for i in live if FI.preempt_hit(
                self.faults, self.slots[i].rid, len(self.slots[i].req.out),
                self.slots[i].tok_base)]
        if stalled:
            # the youngest resident pays for the stall (it may be the
            # grower itself); a preemption frees at least one page
            y = max(live, key=lambda i: self.slots[i].rid)
            if y not in victims:
                victims.append(y)
        freed = np.zeros(self.n_slots, bool)
        for i in victims:
            code = self._preempt_slot(i, freed)
            name = ("requeued" if code == OUTCOME_REQUEUED
                    else OUTCOME_NAMES[code])
            tally[name] = tally.get(name, 0) + 1
        live = [i for i in live if self.slots[i].req is not None]
        stall_tick = any(self.slots[i].req is not None for i in stalled)
        if not live:
            self._finish_tick(freed)
            return
        toks = np.zeros(self.n_slots, np.int32)
        valid = np.zeros(self.n_slots, bool)
        for i in live:
            sl = self.slots[i]
            if prefilling[i]:
                toks[i] = int(sl.feed[sl.cursor])
                valid[i] = True
            else:
                toks[i] = sl.req.out[-1]
                valid[i] = not stall_tick
        ids = np.asarray([[sl.rid, sl.sid, len(sl.req.out)]
                          if sl.req is not None else [-1, -1, 0]
                          for sl in self.slots], np.int32)
        self._enc_kw = self._read_enc()
        tok, v = self._up(toks), self._up(valid)
        pos = self._up(self.pos.copy())
        if stall_tick:
            # generating slots pause; prefilling slots feed one token
            logits, _ = self._block_fwd(tok[:, None], pos, v[:, None],
                                        v.to(torch.int32))
        else:
            logits, _ = self._decode_fwd(tok, pos, v)
        idt = self._up(ids)
        next_tok, finite = self._post(logits, idt[:, 0], idt[:, 1],
                                      lambda: idt[:, 2])
        next_tok, finite = _telemetry._fetch((next_tok, finite))
        for i in live:
            sl = self.slots[i]
            code = OUTCOME_NONE
            if valid[i]:  # paused slots make no progress but still age
                self.pos[i] += 1
                if prefilling[i]:
                    sl.cursor += 1
                    emit = sl.cursor == len(sl.feed)
                else:
                    emit = True
                if emit and not finite[i]:
                    code = OUTCOME_NUMERICS
                elif emit:
                    sl.req.out.append(int(next_tok[i]))
                    self._eager_toks += 1
                    if len(sl.req.out) >= sl.req.max_new:
                        code = OUTCOME_DONE
                    elif self.pos[i] >= sl.budget - 1:
                        code = OUTCOME_TRUNCATED
            if code == OUTCOME_NONE and (
                    self._resident.get(sl.rid, 0) >= self._deadline(sl.req)):
                code = OUTCOME_EXPIRED
            if code != OUTCOME_NONE:
                sl.req.outcome = OUTCOME_NAMES[code]
                if code in (OUTCOME_DONE, OUTCOME_TRUNCATED):
                    sl.req.done = True
                    sl.req.truncated = code == OUTCOME_TRUNCATED
                tally[sl.req.outcome] = tally.get(sl.req.outcome, 0) + 1
                self._enc_rows.pop(sl.rid, None)
                self.slots[i] = _Slot()
                freed[i] = True
        self._finish_tick(freed)

    def _finish_tick(self, freed: np.ndarray) -> None:
        if freed.any():
            if self.spec is not None:
                # freed slots return their pages and their table rows go
                # unmapped, so no stale write lands in a recycled page
                self.pool = PG.release(self.pool, self._up(freed))
                if self._enc_pages:
                    # the pinned encoder runs go back with the KV pages
                    self.pool, table = PG.release_run(
                        self.pool, self._enc.table, self._up(freed))
                    self._enc = self._enc._replace(table=table)
                PG.set_page_table(self.caches, self.pool.table)
            # freed slots take queued work in this tick, as the fused
            # tick's admission at its top leaves them
            self._admit()
        self.ticks += 1

    def _run_eager(self, max_ticks: int) -> None:
        used = peak = 0
        syncs0, toks0 = self._eager_syncs, self._eager_toks
        while ((self.queue or self._requeue
                or any(sl.req is not None for sl in self.slots))
               and used < max_ticks):
            self.step()
            peak = max(peak, sum(sl.req is not None for sl in self.slots))
            used += 1
        self.last_run_report = {
            # one tick a chunk; the syncs are this engine's reads: the
            # picked tokens every tick, the free pages when admission or
            # page growth prices them
            "ticks": used, "chunks": used,
            "host_syncs": self._eager_syncs - syncs0,
            "peak_resident": peak,
            "new_tokens": self._eager_toks - toks0,
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
                    *self._by_rid.values(),
                    *(sl.req for sl in self.slots if sl.req is not None)):
            if req.uid == uid:
                req.delta_set = delta_set
        # resident rows: the fused run's from the last chunk's event rows,
        # the eager loop's from its slots
        mask = np.zeros(self.n_slots, bool)
        for i, r in enumerate(self._slot_rids):
            req = self._by_rid.get(int(r))
            if req is not None and req.uid == uid and int(r) in self._live:
                mask[i] = True
        for i, sl in enumerate(self.slots):
            if sl.req is not None and sl.req.uid == uid:
                mask[i] = True
        n = int(mask.sum())
        if n:
            self._write_arena(mask, rows)  # the user's row in every slot
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
        eager = [sl for sl in self.slots if sl.req is not None]
        resident = len(live) + len(eager)
        rep: Dict[str, Any] = {
            "kv_paging": self.spec is not None,
            "kv_cache_bytes": int(total),
            "resident_streams": resident,
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
        if self._enc_tokens:
            # pinned encoder runs: every resident holds exactly one run
            # (the arena's spare row is not counted)
            enc_arena = sum(t.numel() * t.element_size()
                            for t in self._enc.store.values())
            rep["enc_tokens"] = self._enc_tokens
            rep["enc_arena_bytes"] = enc_arena
            if self.spec is not None:
                rep["enc_pages_per_stream"] = self._enc_pages
            rep["enc_run_bytes"] = (
                resident * max(self._enc_pages, 1)
                * (enc_arena // self._enc_spec.n_pages))
        spec = self.spec
        if spec is None:
            rep["kv_bytes_per_stream"] = int(total) // self.n_slots
            return rep
        if self.rayg:
            in_use = sum(sl.pages for sl in eager) + sum(
                int(spec.pages_for(len(r.prompt) + len(r.out))) for r in live)
        else:
            in_use = sum(int(spec.pages_for(sl.budget)) for sl in eager) + sum(
                int(spec.pages_for(self.request_budget(r))) for r in live)
        # the pinned encoder runs share the free-list: one ledger for both
        in_use += resident * self._enc_pages
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
                in_use * page_bytes // resident if resident
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
        statistic.  The fused engine runs chunks, the eager one
        (``fused=False``) one :meth:`step` a tick."""
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
        if self.fused:
            self._run_fused(max_ticks, chunk)
        else:
            self._run_eager(max_ticks)
        return requests


# the overlay registry's entry points, under the names the JAX package's
# engine exports them by: external unit kinds plug in with
# register_unit_overlay (or a raw register_unit_folder)
register_unit_folder = OV.register_unit_folder
register_unit_overlay = OV.register_unit_overlay
fold_kind = OV.resolve_kind
fold_deltas = OV.fold_deltas
