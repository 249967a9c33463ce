"""The port's serving tick with no host read, on the CPU: a tick issued
after its chunk has exited (``live`` False) leaves the slot state, the
page pool, every cache (K/V rows and lengths, SSD conv windows and
states) and the delta arena bit for bit as they were, and its event row
holds no event; ``decode_step(valid=...)`` gives the unmasked slots the
logits and cache rows of the full call, bit for bit, and leaves the
masked slots' caches alone; and the host's skip of ticks it knows to be
dead changes no stream and no report count.  Port-only: qwen2-smoke and
mamba2-smoke with weights from a seeded generator."""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
from repro_torch.models import transformer as T
from repro_torch.serving import DeltaSet, Request, ServeEngine
from repro_torch.utils import tree_leaves, tree_map

BASE = dict(slots=3, max_len=48, chunk=4)
ENGINES = {
    "contiguous": ("qwen2-1.5b", {}),
    "paged_pressure": ("qwen2-1.5b", dict(slots=4, max_len=32, chunk=8,
                                          kv_paging=True, kv_page_size=8,
                                          page_budget=8)),
    "int8_pages": ("qwen2-1.5b", dict(kv_paging=True, kv_page_size=8,
                                      kv_int8=True)),
    "personalised": ("qwen2-1.5b", dict(personalise=True)),
    "mamba2": ("mamba2-1.3b", {}),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("qwen2-1.5b", "mamba2-1.3b"):
        cfg = configs.get_reduced(arch)
        out[arch] = (cfg, T.init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu"))
    return out


def _policy(cfg):
    return SparseUpdatePolicy(horizon=0, units=(
        SelectedUnit(1, "attn", (0, cfg.n_heads - 1)),
        SelectedUnit(2, "mlp", (0, 7, cfg.d_ff - 1))))


def engine(models, name, **extra):
    arch, kw = ENGINES[name]
    cfg, params = models[arch]
    kw = {**BASE, **kw, **extra}
    policy = _policy(cfg) if kw.pop("personalise", False) else None
    eng = ServeEngine(cfg, params, device="cpu", personalise=policy, **kw)
    if policy is not None:
        gen = torch.Generator().manual_seed(7)
        for uid in (0, 1):
            zero = {f"L{u.layer}": {u.kind: {
                n: 0.5 * torch.randn(z.shape, generator=gen)
                for n, z in eng._delta_tmpl[u.layer][u.kind][0].items()}}
                for u in policy.units}
            eng.swap_deltas(uid, DeltaSet.from_policy(policy, zero))
    return eng


def requests(vocab, n=8, max_new=12, seed=1):
    rng = np.random.default_rng(seed)
    return [Request(uid=i % 2, prompt=rng.integers(
        0, vocab, size=int(rng.integers(3, 12))).astype(np.int32),
        max_new=max_new) for i in range(n)]


def snapshot(eng):
    """Bytes of every tensor a tick may touch: slot state, pool, caches
    (paged arenas without their spare row) and delta arena."""
    trees = [eng._state, eng.pool, eng.caches, eng._arena]
    return [t.reshape(-1).clone().view(torch.uint8)
            for t in tree_leaves([x for x in trees if x is not None])]


@pytest.mark.parametrize("moment", ["start", "mid"])
@pytest.mark.parametrize("name", list(ENGINES))
def test_tick_after_the_exit_changes_nothing(models, name, moment):
    """With requests staged for admission and every slot free (``start``)
    or with residents prefilling and generating (``mid``), one tick issued
    with ``live`` False changes no byte; the same tick issued live does
    change the state (so the check is not vacuous)."""
    eng = engine(models, name)
    eng.run(requests(eng.cfg.vocab), max_ticks=0 if moment == "start" else 5)
    assert bool(eng._live) == (moment == "mid") and eng.has_work()
    eng._dispatch(0)  # stage the queue, as the next chunk would
    pend = eng._make_pending()
    head = torch.zeros((), dtype=torch.int32)
    before = snapshot(eng)
    for live in (False, True):
        out = eng._tick(eng._state, pend, head, eng.pool, False,
                        torch.tensor(live))
        st, pool, row = out[2:]
        S = eng.n_slots
        if not live:
            assert not bool(out[1]) and int(out[0]) == 0  # head unmoved
            eng._state, eng.pool = st, pool
            after = snapshot(eng)
            assert len(after) == len(before)
            for a, b in zip(before, after):
                assert torch.equal(a, b)
            assert (row[:S] == -1).all() and (row[S:2 * S] == -1).all()
            assert (row[2 * S:] == 0).all()
        else:
            eng._state, eng.pool = st, pool
            assert any(not torch.equal(a, b)
                       for a, b in zip(before, snapshot(eng)))
            assert int(row[3 * S]) == 1 and int(row[3 * S + 2]) == 1


@pytest.mark.parametrize("name", ["contiguous", "paged", "int8", "mamba2"])
def test_decode_step_valid_masks_slots_bit_for_bit(models, name):
    """Half the slots masked: the others' logits and cache rows equal the
    full call's bit for bit; the masked slots' caches (rows, lengths, SSD
    windows and states) stay as they were."""
    from repro_torch.serving import paging as PG

    arch = "mamba2-1.3b" if name == "mamba2" else "qwen2-1.5b"
    cfg, params = models[arch]
    b, max_len = 4, 16
    spec = (PG.PagingSpec.build(max_len, page_size=4, slots=b,
                                int8=name == "int8")
            if name in ("paged", "int8") else None)

    def fresh():
        """The same caches every call (paged arenas keep their spare
        row): three tokens of history per slot, so masked rows hold
        state."""
        caches = T.init_caches(cfg, b, max_len, paging=spec, device="cpu")
        if spec is not None:
            pool = PG.make_pool(spec, b, torch.device("cpu"))
            pool = PG.reserve(pool, torch.full((b,), spec.max_pages,
                                               dtype=torch.int32),
                              torch.ones(b, dtype=torch.bool))
            PG.set_page_table(caches, pool.table)
        toks = torch.randint(0, cfg.vocab, (b, 3),
                             generator=torch.Generator().manual_seed(3))
        for j in range(3):
            T.decode_step(cfg, params, toks[:, j:j + 1], caches,
                          torch.full((b,), j, dtype=torch.int32))
        return caches

    base, full, masked = fresh(), fresh(), fresh()
    tok = torch.tensor([[5], [17], [200], [9]])
    pos = torch.full((b,), 3, dtype=torch.int32)
    want, full = T.decode_step(cfg, params, tok, full, pos)
    valid = torch.tensor([True, False, True, False])
    got, masked = T.decode_step(cfg, params, tok, masked, pos, valid)
    assert torch.equal(got[valid], want[valid])
    for kb, kf, km in zip(tree_leaves(base), tree_leaves(full),
                          tree_leaves(masked)):
        if kb.shape[1] == b:  # (L, B, ...) per-slot leaves
            assert torch.equal(km[:, valid], kf[:, valid])
            assert torch.equal(km[:, ~valid], kb[:, ~valid])
    if spec is not None:
        # page arenas: each slot's pages hold the full call's rows if the
        # slot is valid, their old rows if it is masked
        table = masked["g0"]["attn"]["page_table"][0]
        for key in ("k", "v"):
            for leaf in masked["g0"]["attn"][key]:
                arena_b = base["g0"]["attn"][key][leaf]
                arena_m = masked["g0"]["attn"][key][leaf]
                arena_f = full["g0"]["attn"][key][leaf]
                for s in range(b):
                    own = table[s].long()
                    ref = arena_f if valid[s] else arena_b
                    assert torch.equal(arena_m[:, own], ref[:, own])


@pytest.mark.parametrize("name", ["contiguous", "paged_pressure",
                                  "personalised", "mamba2"])
def test_skipping_masked_work_changes_nothing(models, name):
    """The host's skip of work it knows to be masked (on the CPU every
    tick's flags are known at once): the same streams, outcomes and report
    counts as the predicated path, which issues every tick of every chunk
    and both forward programs a tick; with the skip, one program a live
    tick and no tick after a chunk's exit but the one that found it."""
    runs = {}
    for skip in (True, False):
        eng = engine(models, name, chunk=8, skip_masked=skip)
        reqs = requests(eng.cfg.vocab, n=7)
        eng.run(reqs)
        rep = dict(eng.last_run_report)
        issued = rep.pop("ticks_issued"), rep.pop("forwards_issued")
        rep.pop("busy_seconds")
        runs[skip] = ([(list(r.out), r.outcome, r.preempts) for r in reqs],
                      rep, issued)
    assert runs[True][:2] == runs[False][:2]
    rep = runs[False][1]
    assert rep["host_syncs"] == rep["chunks"]
    (ticks_on, fwd_on), (ticks_off, fwd_off) = runs[True][2], runs[False][2]
    assert ticks_off == 8 * rep["chunks"] > rep["ticks"]
    assert fwd_off == 2 * ticks_off
    assert rep["ticks"] < ticks_on <= rep["ticks"] + rep["chunks"]
    assert fwd_on == rep["ticks"]
