"""The port's paged KV cache (``repro_torch.serving.paging``) and its int8
row quantiser against the JAX package's, exactly: random reserve / extend
/ release / reserve_run / release_run schedules give equal page tables and
free masks at every step; ``write_rows``/``read_rows`` give equal stores
and views in fp and int8 (codes and scales), dropped rows included;
``rowwise_quant`` gives equal codes on half-way values.  Then the model
on paged caches: ``prefill_block`` and ``decode_step`` logits against the
JAX package's on qwen2-smoke, fp and int8 pages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.optim import compress as jcompress
from repro.serving import paging as JPG
from repro_torch import bridge, configs
from repro_torch.models import transformer as T
from repro_torch.optim import compress
from repro_torch.serving import paging as PG


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: several CPU threads per op only contend under the
    parallel test run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _both(jpool, pool):
    """Assert the JAX and the port's pools are equal; return the table and
    free mask as numpy."""
    table, free = np.asarray(jpool.table), np.asarray(jpool.free)
    np.testing.assert_array_equal(pool.table.numpy(), table)
    np.testing.assert_array_equal(pool.free.numpy(), free)
    return table, free


def _check_ledger(table, free, held, runs=None, run_pages=0):
    """The pool's invariants: no page owned twice (KV rows and runs
    together), mapped pages off the free-list, the ledger balances, and
    KV rows are contiguous prefixes."""
    owned = table[table >= 0]
    if runs is not None:
        owned = np.concatenate([owned, runs[runs >= 0]])
    assert len(owned) == len(set(owned.tolist()))
    assert not free[owned].any()
    assert int((~free).sum()) == sum(held.values()) + len(held) * run_pages
    for s in range(table.shape[0]):
        h = held.get(s, 0)
        assert (table[s, :h] >= 0).all() and (table[s, h:] == -1).all()


def _onehot(slots, s, val=1):
    m = np.zeros(slots, bool)
    m[s] = True
    nd = np.zeros(slots, np.int32)
    nd[s] = val
    return m, nd


@pytest.mark.parametrize("runs", [False, True], ids=["kv", "kv+runs"])
@pytest.mark.parametrize("seed", range(6))
def test_allocator_programs_match_reference(seed, runs):
    """Random admit (reserve, plus a whole pinned run) / in-tick growth of
    several slots at once (extend) / preempt or evict (release, plus the
    run) schedules: the port's tables, run tables and free masks equal the
    JAX programs' after every step, and the ledger stays balanced; a full
    drain returns every page."""
    rng = np.random.default_rng(seed)
    slots = int(rng.integers(1, 6))
    max_pages = int(rng.integers(2, 6))
    run_pages = int(rng.integers(1, 4)) if runs else 0
    n_pages = int(rng.integers(max_pages + run_pages,
                               slots * (max_pages + run_pages) + 3))
    jspec = JPG.PagingSpec(page_size=int(rng.integers(1, 9)),
                           n_pages=n_pages, max_pages=max_pages)
    jpool = JPG.make_pool(jspec, slots)
    pool = PG.make_pool(PG.PagingSpec(jspec.page_size, n_pages, max_pages),
                        slots, torch.device("cpu"))
    jrun = np.full((slots, run_pages), -1, np.int32)
    run = torch.from_numpy(jrun.copy())
    t = torch.from_numpy
    held = {}
    for _ in range(40):
        free_now = int(JPG.free_page_count(jpool))
        idle = [s for s in range(slots) if s not in held]
        growable = [s for s in held if held[s] < max_pages]
        op = rng.random()
        if idle and (op < 0.4 or not held):
            s = int(rng.choice(idle))
            need = int(rng.integers(1, max_pages + 1))
            if need + run_pages > free_now:
                continue  # head-of-line blocking: never over-asks
            m, nd = _onehot(slots, s, need)
            jpool = JPG.reserve(jpool, jnp.asarray(nd), jnp.asarray(m))
            pool = PG.reserve(pool, t(nd), t(m))
            if runs:
                full = np.full((slots,), run_pages, np.int32)
                jpool, jrun = JPG.reserve_run(jpool, jnp.asarray(jrun),
                                              jnp.asarray(full),
                                              jnp.asarray(m))
                pool, run = PG.reserve_run(pool, run, t(full), t(m))
            held[s] = need
        elif growable and op < 0.75:
            grow = [s for s in growable
                    if rng.random() < 0.7][:max(free_now, 0)]
            if not grow:
                continue
            m = np.isin(np.arange(slots), grow)
            nd = m.astype(np.int32)
            hd = np.asarray([held.get(s, 0) for s in range(slots)], np.int32)
            jpool = JPG.extend(jpool, jnp.asarray(nd), jnp.asarray(m),
                               jnp.asarray(hd))
            pool = PG.extend(pool, t(nd), t(m), t(hd))
            for s in grow:
                held[s] += 1
        elif held:
            s = int(rng.choice(sorted(held)))
            m, _ = _onehot(slots, s)
            jpool = JPG.release(jpool, jnp.asarray(m))
            pool = PG.release(pool, t(m))
            if runs:
                jpool, jrun = JPG.release_run(jpool, jnp.asarray(jrun),
                                              jnp.asarray(m))
                pool, run = PG.release_run(pool, run, t(m))
            del held[s]
        table, free = _both(jpool, pool)
        np.testing.assert_array_equal(run.numpy(), np.asarray(jrun))
        assert int(PG.pages_in_use(pool)) == int(JPG.pages_in_use(jpool))
        _check_ledger(table, free, held, np.asarray(jrun), run_pages)
    everyone = np.ones(slots, bool)
    pool = PG.release(pool, t(everyone))
    pool, run = PG.release_run(pool, run, t(everyone))
    assert int(PG.free_page_count(pool)) == n_pages


def _store_case(int8, seed=0):
    """Five slots writing a block each through a ragged table: a slot with
    an unmapped tail, one whose rows run past the logical capacity, one
    with no pages at all, one paused (no valid rows), and a full one."""
    rng = np.random.default_rng(seed)
    ps, n_pages, mp, b, s = 4, 9, 3, 5, 6
    spec = JPG.PagingSpec(page_size=ps, n_pages=n_pages, max_pages=mp,
                          int8=int8)
    perm = rng.permutation(n_pages)
    table = np.full((b, mp), -1, np.int32)
    table[0, :2] = perm[:2]          # tail unmapped
    table[1, :3] = perm[2:5]         # rows past cap = 12
    table[3, :1] = perm[5:6]         # paused
    table[4, :3] = perm[6:9]
    lens = np.asarray([3, 9, 0, 1, 2], np.int32)
    valid = np.ones((b, s), bool)
    valid[3] = False
    valid[4, 5] = False              # ragged tail
    vals = (rng.standard_normal((b, s, 2, 8)) * 2).astype(np.float32)
    return spec, table, lens, valid, vals


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_write_and_read_rows_match_reference(int8):
    """Writes through -1 entries and past the capacity are dropped, not
    clipped; fp stores equal exactly, int8 codes and scales equal; the
    gathered views equal."""
    spec, table, lens, valid, vals = _store_case(int8)
    jstore = JPG.store_init(spec, (2, 8), jnp.float32)
    jstore = {k: v + (3 if k == "pages" else 0.25) for k, v in jstore.items()}
    jstore = {k: v.astype(jnp.int8) if v.dtype == jnp.int8 else v
              for k, v in jstore.items()}
    store = bridge.page_store_from_numpy(
        {k: np.asarray(v) for k, v in jstore.items()}, device="cpu")
    pspec = PG.PagingSpec(spec.page_size, spec.n_pages, spec.max_pages, int8)
    want = JPG.write_rows(jstore, jnp.asarray(table), spec, jnp.asarray(lens),
                          jnp.asarray(vals), jnp.asarray(valid))
    t = torch.from_numpy
    got = PG.write_rows(store, t(table), pspec, t(lens), t(vals), t(valid))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # nothing left the rows it owns: untouched pages keep their fill
    untouched = np.setdiff1d(np.arange(spec.n_pages), table[table >= 0])
    assert (got["pages"][untouched] == 3).all()
    view = PG.read_rows(got, t(table), pspec, torch.float32)
    np.testing.assert_array_equal(
        view.numpy(),
        np.asarray(JPG.read_rows(want, jnp.asarray(table), spec,
                                 jnp.float32)))


def test_rowwise_quant_codes_equal_on_half_way_values():
    """Rows whose scaled values land exactly on .5: both packages round
    half to even, so the codes are equal, not merely close."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5, 4, 8)).astype(np.float32) * 3.0
    # absmax 127 makes the scale 1 (+1e-12), so k + 0.5 is half-way
    x[:, :, 0, 0] = 127.0
    x[:, :, 1, :4] = np.asarray([0.5, 1.5, 2.5, -3.5], np.float32)
    jq, jscale = jcompress.rowwise_quant(jnp.asarray(x), 2)
    q, scale = compress.rowwise_quant(torch.from_numpy(x), 2)
    assert q.dtype == torch.int8 and scale.shape == (6, 5)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(q[:, :, 1, :4].numpy()[0, 0], [0, 2, 2, -4])
    back = compress.rowwise_dequant(q, scale)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcompress.rowwise_dequant(jq, jscale)))


def test_rowwise_dequant_casts_to_the_asked_dtype():
    q = torch.tensor([[1, -2, 127]], dtype=torch.int8)
    out = compress.rowwise_dequant(q, torch.tensor([0.5]), torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert out.float().tolist() == [[0.5, -1.0, 63.5]]


def test_spare_row_takes_dropped_writes_only():
    """The arena keeps one spare row behind it: a dropped write lands
    there and nowhere else, and cache_bytes does not count it."""
    spec = PG.PagingSpec(page_size=2, n_pages=3, max_pages=2)
    store = PG.store_init(spec, (4,), torch.float32, "cpu")
    table = torch.tensor([[-1, -1]], dtype=torch.int32)
    PG.write_rows(store, table, spec, torch.zeros(1, dtype=torch.int32),
                  torch.ones((1, 2, 4)), torch.ones((1, 2), dtype=torch.bool))
    assert (store["pages"] == 0).all()
    assert (PG._rows_with_spare(store["pages"])[-1] == 1).all()
    assert PG.cache_bytes({"g0": {"attn": store}}) == (96, 96)
    with pytest.raises(RuntimeError):
        PG._rows_with_spare(torch.zeros((3, 2, 4)))


@pytest.fixture(scope="module")
def model():
    cfg = jconfigs.get_reduced("qwen2-1.5b")
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = configs.get_reduced("qwen2-1.5b")
    tp = bridge.params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                               jp),
                                  device="cpu")
    return cfg, jp, tcfg, tp


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_paged_prefill_and_decode_match_reference(model, int8):
    """qwen2-smoke on paged caches (page size 5 over a permuted arena, a
    slot with no pages): a ragged prefill block, then two decode steps.
    Logits agree with the JAX package's within 1e-5, and so do the stores
    (int8 codes within one step: the rows come from two frameworks'
    float32 arithmetic, so a row may sit on the other side of a rounding
    boundary)."""
    cfg, jp, tcfg, tp = model
    b, slots, max_len = 8, 3, 20
    spec = JPG.PagingSpec.build(max_len, page_size=5, slots=slots, int8=int8)
    pspec = PG.PagingSpec(spec.page_size, spec.n_pages, spec.max_pages, int8)
    rng = np.random.default_rng(1)
    table = np.full((slots, spec.max_pages), -1, np.int32)
    perm = rng.permutation(spec.n_pages)
    table[0] = perm[:4]
    table[1, :2] = perm[4:6]
    jc = JT.init_caches(cfg, slots, max_len, paging=spec)
    jc = JPG.set_page_table(jc, jnp.asarray(table))
    tc = T.init_caches(tcfg, slots, max_len, paging=pspec, device="cpu")
    tc = PG.set_page_table(tc, torch.from_numpy(table))
    assert PG.cache_bytes(tc) == JPG.cache_bytes(jc)
    toks = rng.integers(0, cfg.vocab, (slots, b)).astype(np.int32)
    valid = np.zeros((slots, b), bool)
    valid[0, :7] = valid[1, :3] = True
    pos = np.zeros(slots, np.int32)
    jl, jc = JT.prefill_block(cfg, jp, jnp.asarray(toks), jc,
                              jnp.asarray(pos), jnp.asarray(valid))
    tl, tc = T.prefill_block(tcfg, tp, torch.from_numpy(toks).long(), tc,
                             torch.from_numpy(pos), torch.from_numpy(valid))
    v = valid[..., None]
    np.testing.assert_allclose(np.where(v, tl.numpy(), 0),
                               np.where(v, np.asarray(jl), 0),
                               rtol=1e-5, atol=1e-5)
    pos = valid.sum(1).astype(np.int32)
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab, (slots, 1)).astype(np.int32)
        jl, jc = JT.decode_step(cfg, jp, jnp.asarray(tok), jc,
                                jnp.asarray(pos))
        tl, tc = T.decode_step(tcfg, tp, torch.from_numpy(tok).long(), tc,
                               torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   rtol=1e-5, atol=1e-5)
        pos = pos + 1
    for name in ("k", "v"):
        want = jax.tree_util.tree_map(np.asarray, jc["g0"]["attn"][name])
        for leaf, w in want.items():
            got = tc["g0"]["attn"][name][leaf].numpy()
            if leaf == "pages" and int8:
                assert np.abs(got.astype(int) - w.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tc["g0"]["attn"]["len"].numpy(),
                                  np.asarray(jc["g0"]["attn"]["len"]))
