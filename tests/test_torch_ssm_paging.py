"""The ssm and hybrid families on the paged engine, on the CPU against the
JAX package's: mamba2-smoke (no attention layer: under ``kv_paging`` the
pool and admission in pages run with no page store at all) and
zamba2-smoke (its shared block's two caches are page arenas under the
engine's one table; the SSD state stays contiguous), f32, the JAX
weights bridged across.

The twins of ``tests/test_paging.py``'s cases for these two archs: fp
pages stream as the contiguous cache does on the eager path and the fused
path at prefill blocks 1 and 8, and the drained pool leaks nothing; int8
pages within the stated 5 % teacher-forced logit tolerance; and, against
the JAX engine mode by mode, streams, outcomes, preemptions, ticks and
the memory report's page tallies on fp, int8, pressured (half the
pages), worst-case-reserved and backfilled engines."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import bridge, configs
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving import paging as PG

ARCHS = ("mamba2-1.3b", "zamba2-1.2b")
ENGINE = dict(slots=3, max_len=24, chunk=4)
PAGED = dict(kv_paging=True, kv_page_size=4)
# 3 slots x 6 pages is the fixed stripe: 9 pages run the pool dry
MODES = {
    "contiguous": {},
    "paged": PAGED,
    "int8": dict(PAGED, kv_int8=True),
    "pressured": dict(PAGED, page_budget=9),
    "worstcase": dict(PAGED, page_budget=12, reserve="worstcase"),
    "backfill": dict(PAGED, page_budget=9, admit_backfill=2),
}
PROMPT_LENS = (3, 5, 8, 9, 17)
REPORT_KEYS = ("chunks", "ticks", "new_tokens", "outcomes", "memory")


def requests(make, vocab, max_new=6):
    rng = np.random.default_rng(3)
    return [make(uid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                 max_new=max_new) for i, n in enumerate(PROMPT_LENS)]


def results(reqs):
    return [(list(r.out), r.outcome, r.preempts) for r in reqs]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """The JAX engine's run in every mode on one smoke config, once per
    module, and the bridged weights."""
    arch = request.param
    jcfg = jconfigs.get_reduced(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    out = {}
    for mode, kw in MODES.items():
        eng = JServeEngine(jcfg, jp, **ENGINE, **kw)
        out[mode] = results(eng.run(requests(JRequest, jcfg.vocab)))
        out[f"report {mode}"] = eng.last_run_report
    cfg = configs.get_reduced(arch)
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return arch, cfg, params, jcfg, jp, out


@pytest.mark.parametrize("mode", list(MODES))
def test_streams_outcomes_and_tallies_match_reference(ref, mode):
    """Fused B8 against the JAX engine in the same mode: streams,
    outcomes, preemptions, ticks and the memory report (pages in use,
    page bytes; no page store on mamba2) equal, one host sync a chunk;
    the drained pool leaks nothing."""
    _, cfg, params, _, _, out = ref
    eng = ServeEngine(cfg, params, device="cpu", **ENGINE, **MODES[mode])
    assert results(eng.run(requests(Request, cfg.vocab))) == out[mode]
    rep, jrep = eng.last_run_report, out[f"report {mode}"]
    assert rep["host_syncs"] == rep["chunks"]
    for key in REPORT_KEYS:
        assert rep[key] == jrep[key], key
    if mode in ("pressured", "backfill"):
        assert rep["outcomes"].get("requeued", 0) >= 1
    if eng.spec is not None:
        assert int(PG.free_page_count(eng.pool)) == eng.spec.n_pages
        paged = [k for k, c in eng.caches.items()
                 if PG.PAGE_TABLE_KEY in c or PG.PAGE_TABLE_KEY in
                 c.get("attn", {})]
        assert paged == ([] if cfg.family == "ssm"
                         else ["shared2", "shared5"])
    assert all(o == "done" for _, o, _ in out[mode])


@pytest.mark.parametrize("block", [1, 8])
def test_paged_fp_matches_contiguous_streams(ref, block):
    """``tests/test_paging.py``'s fp-page parity for this arch: the eager
    loop and the fused engine at prefill blocks 1 and 8 on fp pages of 8
    rows stream as the JAX engine's contiguous cache does."""
    _, cfg, params, jcfg, jp, out = ref
    kw = dict(slots=2, max_len=24, chunk=8, kv_paging=True, kv_page_size=8)
    want = results(JServeEngine(jcfg, jp, slots=2, max_len=24, chunk=8,
                                fused=False).run(
        requests(JRequest, jcfg.vocab, max_new=4)))
    for extra in (dict(prefill_block=block), dict(fused=False)):
        eng = ServeEngine(cfg, params, device="cpu", **kw, **extra)
        assert results(eng.run(requests(Request, cfg.vocab,
                                        max_new=4))) == want
        assert int(PG.free_page_count(eng.pool)) == eng.spec.n_pages


def test_int8_pages_teacher_forced_logit_tolerance(ref):
    """Teacher-forced decode through fp-contiguous and int8-paged caches:
    per-step logits within 5 % relative L2 error (mamba2 has no paged
    store, so its two runs agree exactly)."""
    _, cfg, params, _, _, _ = ref
    b, max_len, steps = 2, 16, 8
    spec = PG.PagingSpec.build(max_len, page_size=4, slots=b, int8=True)
    c_fp = T.init_caches(cfg, b, max_len, device="cpu")
    c_i8 = T.init_caches(cfg, b, max_len, paging=spec, device="cpu")
    pool = PG.reserve(PG.make_pool(spec, b, torch.device("cpu")),
                      torch.full((b,), spec.max_pages, dtype=torch.int32),
                      torch.ones((b,), dtype=torch.bool))
    PG.set_page_table(c_i8, pool.table)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, steps)))
    for t in range(steps):
        pos = torch.full((b,), t)
        l_fp, _ = T.decode_step(cfg, params, toks[:, t:t + 1], c_fp, pos)
        l_i8, _ = T.decode_step(cfg, params, toks[:, t:t + 1], c_i8, pos)
        rel = (torch.linalg.norm(l_fp - l_i8)
               / torch.clamp(torch.linalg.norm(l_fp), min=1e-9))
        assert float(rel) < 0.05, f"step {t}: relative logit error {rel}"
        if cfg.family == "ssm":
            assert torch.equal(l_fp, l_i8)
