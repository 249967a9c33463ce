"""Paged, optionally int8-quantised KV cache: the port of
``repro.serving.paging``.

KV storage is split into fixed-size **pages** in a flat per-layer arena,
handed out from a device-resident free-list:

- :class:`PagingSpec`: the static geometry (page size, pool capacity per
  layer arena, per-slot page-table width).
- :class:`PagePool`: the allocator state, a ``(slots, max_pages)`` int32
  page table (-1 = unmapped) and an ``(n_pages,)`` bool free mask.
  :func:`reserve`, :func:`extend`, :func:`release`, :func:`reserve_run`
  and :func:`release_run` are fixed-shape tensor programs in the
  cumsum-ranked ``PendingBuffer`` idiom with no host read, so the serving
  tick allocates at admission, grows mid-stream and frees at eviction on
  the device.  They are pure: each returns a new pool.
- **Page stores**: per-layer arenas ``(n_pages, page_size, *feat)``,
  optionally int8 with one float32 scale per row (per token), packed by
  ``optim.compress.rowwise_quant``.

Two things differ from the JAX package, neither in values:

- Stores are written **in place** (the serving caches are updated in
  place throughout the port).  Rows routed through an unmapped (-1) table
  entry or past the logical capacity are dropped, as ``mode='drop'``
  drops them there: the arena is allocated with one spare row behind it
  (:func:`store_init`), and every dropped row is sent there.  So a
  dropped write can neither land in a page owned by another slot nor
  race with a valid write.  The spare row is never read and is not
  counted by :func:`cache_bytes`.
- All layers share one page table: ``caches[g]["attn"]["page_table"]``
  is a broadcast view of the pool's table (a hybrid config's unstacked
  ``caches["shared{lid}"]["page_table"]`` is the table itself), and
  :func:`set_page_table` re-points them (no copy).

The pinned runs (``reserve_run``/``release_run``) back encoder-output
page runs, which arrive with ROADMAP queue 1, item 14; they are ported now
because the pool's invariants cover them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..optim import compress

PAGE_TABLE_KEY = "page_table"


@dataclasses.dataclass(frozen=True)
class PagingSpec:
    """Static paged-cache geometry.

    ``n_pages`` is the pool capacity *per layer arena*: every paged layer
    owns an arena of ``n_pages`` pages, but all layers share one page
    table and one free-list, because a slot holds the same number of
    tokens in every layer."""

    page_size: int  # tokens per page
    n_pages: int    # pool capacity (pages per layer arena)
    max_pages: int  # per-slot page-table width = ceil(max_len / page_size)
    int8: bool = False

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {self.n_pages}")
        if self.max_pages < 1:
            raise ValueError(f"max_pages must be >= 1, got {self.max_pages}")

    @property
    def cap(self) -> int:
        """Logical per-slot capacity of the gathered view, in tokens."""
        return self.max_pages * self.page_size

    @classmethod
    def build(cls, max_len: int, *, page_size: int, slots: int,
              n_pages: Optional[int] = None, int8: bool = False,
              ) -> "PagingSpec":
        """Geometry for an engine: the table covers ``max_len``; the
        default budget (``n_pages=None``) is the fixed-stripe capacity
        ``slots * max_pages``.  A smaller budget oversubscribes slots."""
        max_pages = -(-int(max_len) // int(page_size))
        if n_pages is None:
            n_pages = slots * max_pages
        return cls(int(page_size), int(n_pages), int(max_pages), bool(int8))

    def pages_for(self, kv_budget):
        """Pages that hold ``kv_budget`` tokens (Python ints and integer
        tensors alike)."""
        return (kv_budget + self.page_size - 1) // self.page_size


class PagePool(NamedTuple):
    """Device-resident page-allocator state.  ``table[s, j]`` is the
    physical page behind logical rows ``[j*page_size, (j+1)*page_size)``
    of slot ``s`` (-1 = unmapped); ``free[p]`` marks page ``p``
    allocatable."""

    table: torch.Tensor  # (slots, max_pages) int32
    free: torch.Tensor   # (n_pages,) bool


def make_pool(spec: PagingSpec, slots: int,
              device: torch.device) -> PagePool:
    return PagePool(
        table=torch.full((slots, spec.max_pages), -1, dtype=torch.int32,
                         device=device),
        free=torch.ones((spec.n_pages,), dtype=torch.bool, device=device))


def free_page_count(pool: PagePool) -> torch.Tensor:
    return pool.free.sum(dtype=torch.int32)


def pages_in_use(pool: PagePool) -> torch.Tensor:
    return pool.free.shape[0] - free_page_count(pool)


def _mark(n: int, idx: torch.Tensor, device) -> torch.Tensor:
    """(n,) bool, True at ``idx``; entries equal to ``n`` are dropped."""
    out = torch.zeros((n + 1,), dtype=torch.bool, device=device)
    # index_fill_ takes the value as a kernel argument: an index_put of a
    # Python scalar uploads it with a blocking copy on a card
    out.index_fill_(0, idx.reshape(-1).long(), True)
    return out[:n]


def _handout(free: torch.Tensor, need: torch.Tensor, mask: torch.Tensor,
             held: torch.Tensor, width: int):
    """Cumsum-rank free-page handout for a ``(slots, width)`` table.

    Free pages get ranks 0..F-1 in page order, and slot ``s`` with
    exclusive-prefix demand ``offs[s]`` receives the pages ranked
    ``offs[s] .. offs[s] + need[s] - 1`` into table entries ``held[s] ..
    held[s] + need[s] - 1``.  Returns ``(want, page, taken)``: the entry
    mask, the page per entry and the free-list bits consumed."""
    n_pages = free.shape[0]
    dev = free.device
    need = torch.where(mask, need, 0).to(torch.int32)
    held = held.to(torch.int32)
    offs = torch.cumsum(need, 0, dtype=torch.int32) - need
    j = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    want = (mask[:, None] & (j >= held[:, None])
            & (j < (held + need)[:, None]))
    target_rank = offs[:, None] + (j - held[:, None])
    # invert rank -> page: free pages are ranked in page order
    rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    rank_to_page = torch.full((n_pages + 1,), -1, dtype=torch.int32,
                              device=dev)
    rank_to_page[torch.where(free, rank, n_pages).long()] = torch.arange(
        n_pages, dtype=torch.int32, device=dev)
    page = rank_to_page[target_rank.clamp(0, n_pages - 1).long()]
    taken = _mark(n_pages, torch.where(want, page, n_pages), dev)
    return want, page, taken


def _free_rows(free: torch.Tensor, table: torch.Tensor, mask: torch.Tensor):
    """Return masked slots' mapped pages to ``free`` and the invalidated
    (-1) table."""
    owned = mask[:, None] & (table >= 0)
    freed = _mark(free.shape[0], torch.where(owned, table, free.shape[0]),
                  free.device)
    return free | freed, torch.where(mask[:, None], -1, table)


def reserve(pool: PagePool, need: torch.Tensor,
            mask: torch.Tensor) -> PagePool:
    """Allocate ``need[s]`` pages to each masked slot, in slot order;
    masked slots overwrite their whole table row (tail entries -1), so it
    doubles as the row reset at admission.  The caller guarantees the
    masked demand fits the free-list."""
    held = torch.zeros_like(mask, dtype=torch.int32)
    want, page, taken = _handout(pool.free, need, mask, held,
                                 pool.table.shape[1])
    table = torch.where(mask[:, None], torch.where(want, page, -1),
                        pool.table)
    return PagePool(table, pool.free & ~taken)


def extend(pool: PagePool, need: torch.Tensor, mask: torch.Tensor,
           held: torch.Tensor) -> PagePool:
    """Append ``need[s]`` pages to each masked slot after its ``held[s]``
    mapped entries, leaving the mapped prefix untouched: the
    reserve-as-you-go growth step.  The caller guarantees the demand fits
    the free-list and ``held + need <= max_pages``."""
    want, page, taken = _handout(pool.free, need, mask, held,
                                 pool.table.shape[1])
    return PagePool(torch.where(want, page, pool.table), pool.free & ~taken)


def release(pool: PagePool, mask: torch.Tensor) -> PagePool:
    """Return all pages of masked slots to the free-list and invalidate
    their table rows (-1)."""
    free, table = _free_rows(pool.free, pool.table, mask)
    return PagePool(table, free)


def reserve_run(pool: PagePool, run_table: torch.Tensor, need: torch.Tensor,
                mask: torch.Tensor) -> Tuple[PagePool, torch.Tensor]:
    """Reserve a pinned, read-only page run for each masked slot from the
    shared free-list into the caller-owned ``run_table`` (slots,
    run_pages).  The KV table is untouched."""
    held = torch.zeros_like(mask, dtype=torch.int32)
    want, page, taken = _handout(pool.free, need, mask, held,
                                 run_table.shape[1])
    table = torch.where(mask[:, None], torch.where(want, page, -1),
                        run_table)
    return PagePool(pool.table, pool.free & ~taken), table


def release_run(pool: PagePool, run_table: torch.Tensor, mask: torch.Tensor,
                ) -> Tuple[PagePool, torch.Tensor]:
    """Return masked slots' pinned-run pages to the shared free-list and
    invalidate their run-table rows (-1).  The KV table is untouched."""
    free, table = _free_rows(pool.free, run_table, mask)
    return PagePool(pool.table, free), table


# ---------------------------------------------------------------------------
# Page stores: per-layer arenas with pack-on-write / unpack-on-read
# ---------------------------------------------------------------------------


def _arena(lead: Tuple[int, ...], spec: PagingSpec, feat: Tuple[int, ...],
           dtype: torch.dtype, device) -> torch.Tensor:
    """``lead + (n_pages, page_size) + feat`` zeros whose storage holds one
    spare row behind each arena (the target of dropped writes)."""
    rows = spec.n_pages * spec.page_size
    buf = torch.zeros(lead + (rows + 1,) + feat, dtype=dtype, device=device)
    return buf.narrow(len(lead), 0, rows).unflatten(
        len(lead), (spec.n_pages, spec.page_size))


def store_init(spec: PagingSpec, feat_shape: Tuple[int, ...],
               dtype: torch.dtype, device, *,
               lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """One paged arena (``lead`` stacks layers): ``pages (*lead, n_pages,
    page_size, *feat)`` plus, for int8 stores, the per-row float32
    dequantisation ``scale (*lead, n_pages, page_size)``."""
    feat = tuple(feat_shape)
    if spec.int8:
        return {"pages": _arena(lead, spec, feat, torch.int8, device),
                "scale": _arena(lead, spec, (), torch.float32, device)}
    return {"pages": _arena(lead, spec, feat, dtype, device)}


def spec_from(cache: Dict[str, Any]) -> PagingSpec:
    """The static geometry of a paged layer cache (K/V or MLA latent),
    from its shapes."""
    for key in ("k", "ckv"):
        store = cache.get(key)
        if isinstance(store, dict) and "pages" in store:
            pages = store["pages"]
            return PagingSpec(page_size=pages.shape[1],
                              n_pages=pages.shape[0],
                              max_pages=cache[PAGE_TABLE_KEY].shape[-1],
                              int8=pages.dtype == torch.int8)
    raise ValueError("not a paged cache: no 'k'/'ckv' page store found")


def _rows_with_spare(t: torch.Tensor) -> torch.Tensor:
    """A one-layer arena ``(n_pages, page_size, *feat)`` seen as its flat
    rows plus the spare row behind them, ``(n_pages*page_size + 1,
    *feat)``.  Raises if the storage has no spare row (an arena not made
    by :func:`store_init`)."""
    if not t.is_contiguous():
        raise ValueError("page arena must be contiguous")
    rows = t.shape[0] * t.shape[1]
    feat = tuple(t.shape[2:])
    return t.as_strided((rows + 1,) + feat, (t.stride(1),) + t.stride()[2:],
                        t.storage_offset())


def write_rows(store: Dict[str, torch.Tensor], table: torch.Tensor,
               spec: PagingSpec, lens: torch.Tensor, vals: torch.Tensor,
               valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Scatter ``vals[b, j]`` at logical row ``lens[b] + j`` of slot ``b``
    through the page table, in place.  ``valid`` (B, S) masks ragged tails
    and paused slots; rows through unmapped (-1) entries or past the
    logical capacity are **dropped**, never clipped, so an inactive slot
    can never corrupt a page re-allocated to a neighbour.  Int8 stores
    pack each row with its own absmax scale.  Each (page, row) belongs to
    one slot, so the valid writes never collide."""
    b, s = vals.shape[:2]
    ps = spec.page_size
    dev = vals.device
    logical = (lens[:, None].long()
               + torch.arange(s, device=dev, dtype=torch.long)[None, :])
    pidx = torch.div(logical, ps, rounding_mode="floor").clamp(
        0, spec.max_pages - 1)
    page = table.long().gather(1, pidx)
    ok = valid & (page >= 0) & (logical >= 0) & (logical < spec.cap)
    n_rows = spec.n_pages * ps
    row = torch.where(ok, page * ps + logical % ps, n_rows).reshape(-1)
    flat = _rows_with_spare(store["pages"])
    if spec.int8:
        q, scale = compress.rowwise_quant(vals, vals.dim() - 2)
        flat[row] = q.reshape((b * s,) + q.shape[2:])
        _rows_with_spare(store["scale"])[row] = scale.reshape(-1)
    else:
        flat[row] = vals.to(flat.dtype).reshape((b * s,) + vals.shape[2:])
    return store


def read_rows(store: Dict[str, torch.Tensor], table: torch.Tensor,
              spec: PagingSpec, dtype: torch.dtype) -> torch.Tensor:
    """Gather the logical contiguous ``(B, cap, *feat)`` view of each
    slot's pages.  Rows behind unmapped entries alias page 0 and must be
    masked downstream by ``kv_len``; int8 stores unpack with their per-row
    scales."""
    page = table.long().clamp(0, spec.n_pages - 1)   # (B, max_pages)
    view = store["pages"][page]                       # (B, mp, ps, *feat)
    if spec.int8:
        view = compress.rowwise_dequant(view, store["scale"][page], dtype)
    else:
        view = view.to(dtype)
    return view.reshape((table.shape[0], spec.cap) + tuple(view.shape[3:]))


def set_page_table(caches: Dict[str, Any],
                   table: torch.Tensor) -> Dict[str, Any]:
    """Point every paged layer cache at the pool's ``table``: each group's
    ``page_table`` becomes a broadcast view ``(L, slots, max_pages)`` of
    it and each unstacked shared-block cache's the table itself, with no
    copy.  Updates ``caches`` in place and returns it."""
    for g in caches.values():
        if PAGE_TABLE_KEY in g:
            g[PAGE_TABLE_KEY] = table
            continue
        c = g.get("attn")
        if isinstance(c, dict) and PAGE_TABLE_KEY in c:
            c[PAGE_TABLE_KEY] = table[None].expand(
                (c[PAGE_TABLE_KEY].shape[0],) + tuple(table.shape))
    return caches


def cache_bytes(caches: Any) -> Tuple[int, int]:
    """(total cache bytes, bytes in page arenas + scales) of a cache tree.
    A broadcast page table counts at its logical size, as in the JAX
    package's stacked copies; the spare rows behind the arenas do not
    count."""
    total = paged = 0

    def walk(tree, key):
        nonlocal total, paged
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
            return
        n = tree.numel() * tree.element_size()
        total += n
        if key in ("pages", "scale"):
            paged += n

    walk(caches, None)
    return total, paged
