"""The port's ServeEngine on a paged KV cache, on the CPU, against the JAX
package's on qwen2-smoke with the JAX weights bridged across: greedy
streams, typed outcomes, the run report's counts and ``kv_cache_bytes``
identical for fp pages (page size 8, and 5, which does not divide
``max_len``), ``reserve="worstcase"`` and int8 pages.  Within the port:
paged fp streams equal the contiguous ones at every prefill block and
chunk size, and paging adds no host read.  (Serving under page pressure:
``test_torch_paged_pressure.py``.)"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import bridge, configs
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving import paging as PG

PROMPT_LENS = (3, 5, 8, 9, 17, 20)
ENGINE = dict(slots=3, max_len=48, chunk=4)
PAGED = {
    "fp8": dict(kv_paging=True, kv_page_size=8),
    "fp5": dict(kv_paging=True, kv_page_size=5),  # cap 50 > max_len 48
    "worstcase": dict(kv_paging=True, kv_page_size=8, reserve="worstcase"),
    "int8": dict(kv_paging=True, kv_page_size=8, kv_int8=True),
}
REPORT_KEYS = ("ticks", "peak_resident", "new_tokens", "outcomes")


def make_requests(make, vocab, max_new=6):
    """Six requests; the one with the 9-token prompt has a KV budget of 14
    rows, so it is truncated before its sixth token."""
    rng = np.random.default_rng(0)
    return [make(uid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                 max_new=max_new, max_len=14 if n == 9 else None)
            for i, n in enumerate(PROMPT_LENS)]


def streams(reqs):
    return [(list(r.out), r.outcome) for r in reqs]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: several CPU threads per op only contend under the
    parallel test run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's paged runs, once per module, plus the bridged
    weights."""
    cfg = jconfigs.get_reduced("qwen2-1.5b")
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = configs.get_reduced("qwen2-1.5b")
    tp = bridge.params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                               jp),
                                  device="cpu")
    out = {}
    for name, kw in PAGED.items():
        eng = JServeEngine(cfg, jp, **ENGINE, **kw)
        out[name] = streams(eng.run(make_requests(JRequest, cfg.vocab)))
        out[f"report_{name}"] = eng.last_run_report
    return tcfg, tp, out


def run_port(tcfg, tp, **kw):
    eng = ServeEngine(tcfg, tp, device="cpu", **{**ENGINE, **kw})
    return eng, streams(eng.run(make_requests(Request, tcfg.vocab)))


@pytest.mark.parametrize("name", list(PAGED))
def test_paged_streams_outcomes_and_report_match_reference(ref, name):
    tcfg, tp, out = ref
    eng, got = run_port(tcfg, tp, **PAGED[name])
    assert got == out[name]
    assert {o for _, o in got} == {"done", "truncated"}
    jrep, rep = out[f"report_{name}"], eng.last_run_report
    for key in REPORT_KEYS:
        assert rep[key] == jrep[key], key
    assert rep["memory"] == jrep["memory"]
    # fp and int8 pages: one host sync a chunk, over the JAX engine's
    assert rep["host_syncs"] == rep["chunks"] == jrep["chunks"]
    assert rep["ticks_dispatched"] == jrep["ticks_dispatched"]
    # the drained pool leaks nothing
    assert int(PG.free_page_count(eng.pool)) == eng.spec.n_pages
    assert (eng.pool.table == -1).all()


def test_int8_pages_take_under_half_the_bytes(ref):
    tcfg, tp, out = ref
    fp = out["report_fp8"]["memory"]
    i8 = out["report_int8"]["memory"]
    assert i8["kv_int8"] and not fp["kv_int8"]
    assert i8["kv_cache_bytes"] < fp["kv_cache_bytes"] / 2


@pytest.mark.parametrize("block", [8, 1])
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("page_size", [8, 5])
def test_paged_streams_equal_contiguous(ref, page_size, chunk, block):
    """fp pages change no stream: the contiguous engine's streams at every
    prefill block and chunk size (the JAX package holds the same)."""
    tcfg, tp, _ = ref
    _, want = run_port(tcfg, tp)
    _, got = run_port(tcfg, tp, kv_paging=True, kv_page_size=page_size,
                      prefill_block=block, chunk=chunk)
    assert got == want


def test_paging_adds_no_host_read(ref):
    """The paged engine reads the event rows once per chunk, as the
    contiguous engine does, over the same ticks."""
    tcfg, tp, _ = ref
    plain, _ = run_port(tcfg, tp)
    for kw in PAGED.values():
        paged, _ = run_port(tcfg, tp, **kw)
        a, b = plain.last_run_report, paged.last_run_report
        assert (b["ticks"], b["chunks"]) == (a["ticks"], a["chunks"])
        assert b["host_syncs"] == a["host_syncs"]


def test_request_that_could_never_be_admitted_is_refused(ref):
    tcfg, tp, _ = ref
    eng = ServeEngine(tcfg, tp, device="cpu", kv_paging=True,
                      kv_page_size=8, page_budget=5, **ENGINE)
    with pytest.raises(ValueError, match="could never be admitted"):
        eng.submit(Request(uid=0, prompt=np.ones(4, np.int32), max_new=2))
    assert eng.submit(Request(uid=1, prompt=np.ones(4, np.int32), max_new=2,
                              max_len=40)).accepted


def test_memory_report_prices_pages(ref):
    """An idle paged engine reports the worst-case single-request cost;
    the page bytes cover every layer's K and V rows (and int8 scales)."""
    tcfg, tp, _ = ref
    rows = 8 * 2 * tcfg.n_layers * tcfg.n_kv_heads * tcfg.head_dim
    for kw, per_row in ((PAGED["fp8"], 4 * rows),
                        (PAGED["int8"], rows + 8 * 2 * tcfg.n_layers * 4)):
        rep = ServeEngine(tcfg, tp, device="cpu", **ENGINE,
                          **kw).memory_report()
        assert rep["kv_paging"] and rep["pages_in_use"] == 0
        assert rep["n_pages"] == 3 * 6 and rep["page_bytes"] == per_row
        assert rep["kv_bytes_per_stream"] == 6 * per_row
