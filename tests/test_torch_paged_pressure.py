"""The port's paged ServeEngine under page pressure, on the CPU, against
the JAX package's on qwen2-smoke with the JAX weights bridged across: at
half the fixed-stripe page budget, reserve-as-you-go growth runs the pool
dry, the youngest resident is preempted and requeued for a recompute
swap, and every stream still equals the unpressured one.  Streams, typed
outcomes (``requeued`` tallied as an event, ``preempted`` terminal with
its partial output kept), the report's counts and the memory report are
identical to the JAX engine's, with an engine-wide and a per-request
``preempt_budget``, and with deadlines carried across preemptions by the
resident-tick ledger."""
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

# slots * ceil(max_len / page_size) = 16 pages is the fixed-stripe
# capacity; PRESSURE grants half of it
ENGINE = dict(slots=4, max_len=32, chunk=8, kv_paging=True, kv_page_size=8)
PRESSURE = dict(page_budget=8)
CASES = {
    "roomy": dict(reserve="worstcase"),
    "pressure": PRESSURE,
    "no_retries": dict(PRESSURE, preempt_budget=0),
    "deadline": dict(PRESSURE, deadline_ticks=20),
}
REPORT_KEYS = ("ticks", "peak_resident", "new_tokens", "outcomes")


def make_requests(make, vocab, per_request_budget=False):
    """Eight short prompts that each generate 16 tokens: their pages grow
    past what half the pool holds."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, size=int(rng.integers(3, 9)))
               .astype(np.int32) for _ in range(8)]
    return [make(uid=i, prompt=p, max_new=16,
                 preempt_budget=(0 if per_request_budget and i % 2 else None))
            for i, p in enumerate(prompts)]


def streams(reqs):
    return [(list(r.out), r.outcome, r.preempts) for r in reqs]


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
    """The JAX engine's runs, once per module, plus the bridged weights."""
    cfg = jconfigs.get_reduced("qwen2-1.5b")
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = configs.get_reduced("qwen2-1.5b")
    tp = bridge.params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                               jp),
                                  device="cpu")
    out = {}
    for name, kw in dict(CASES, per_request=PRESSURE).items():
        eng = JServeEngine(cfg, jp, **ENGINE, **kw)
        reqs = make_requests(JRequest, cfg.vocab, name == "per_request")
        out[name] = streams(eng.run(reqs))
        out[f"report_{name}"] = eng.last_run_report
    return tcfg, tp, out


def run_port(tcfg, tp, per_request_budget=False, **kw):
    eng = ServeEngine(tcfg, tp, device="cpu", **{**ENGINE, **kw})
    reqs = make_requests(Request, tcfg.vocab, per_request_budget)
    return eng, streams(eng.run(reqs))


@pytest.mark.parametrize("name", list(CASES) + ["per_request"])
def test_streams_outcomes_and_report_match_reference(ref, name):
    tcfg, tp, out = ref
    kw = CASES.get(name, PRESSURE)
    eng, got = run_port(tcfg, tp, per_request_budget=name == "per_request",
                        **kw)
    assert got == out[name]
    jrep, rep = out[f"report_{name}"], eng.last_run_report
    for key in REPORT_KEYS:
        assert rep[key] == jrep[key], key
    assert rep["memory"] == jrep["memory"]
    assert int(PG.free_page_count(eng.pool)) == eng.spec.n_pages


def test_pressure_requeues_and_streams_equal_the_roomy_run(ref):
    """Half the pages: streams are preempted and requeued, every request
    ends done, and every stream equals the unpressured run's."""
    _, _, out = ref
    assert out["report_pressure"]["outcomes"]["requeued"] >= 1
    assert any(p > 0 for _, _, p in out["pressure"])
    assert [(s, o) for s, o, _ in out["pressure"]] == [
        (s, o) for s, o, _ in out["roomy"]]
    assert {o for _, o, _ in out["roomy"]} == {"done"}


def test_no_retries_ends_preempted_with_partial_output(ref):
    """preempt_budget=0: a preempted stream ends 'preempted' and keeps the
    tokens it emitted, a prefix of its unpressured stream."""
    _, _, out = ref
    roomy = out["roomy"]
    cut = [(i, s) for i, (s, o, _) in enumerate(out["no_retries"])
           if o == "preempted"]
    assert cut and "requeued" not in out["report_no_retries"]["outcomes"]
    for i, s in cut:
        assert s == roomy[i][0][:len(s)] and len(s) < 16
    assert any(s for _, s in cut)


def test_deadline_survives_preemption(ref):
    """A 20-tick deadline under pressure: streams expire after resident
    ticks spent before and after their preemptions."""
    _, _, out = ref
    tally = out["report_deadline"]["outcomes"]
    assert tally["expired"] >= 1 and tally["requeued"] >= 1
    assert any(o == "expired" and p > 0 for _, o, p in out["deadline"])


@pytest.mark.parametrize("block, chunk", [(1, 8), (8, 2), (8, 3)])
def test_pressure_streams_invariant_to_block_and_chunk(ref, block, chunk):
    """The preemption schedule moves with the block and chunk sizes; the
    streams do not."""
    tcfg, tp, out = ref
    eng, got = run_port(tcfg, tp, prefill_block=block, chunk=chunk,
                        **PRESSURE)
    assert [(s, o) for s, o, _ in got] == [
        (s, o) for s, o, _ in out["roomy"]]
    assert eng.last_run_report["outcomes"]["requeued"] >= 1


def test_one_tick_chunks_preempt_one_stream_until_its_budget_ends(ref):
    """A known state of the reference, kept by the port: with one-tick
    chunks a requeued stream restages at once, readmits into the pages its
    own preemption freed, stalls the others' growth and, as the youngest
    resident, is preempted again, whatever its retry budget.  Both engines
    end request 3 'preempted' after exactly 16 preemptions (ROADMAP queue
    3)."""
    tcfg, tp, _ = ref
    jcfg = jconfigs.get_reduced("qwen2-1.5b")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    kw = dict(ENGINE, chunk=1, preempt_budget=16, **PRESSURE)
    want = streams(JServeEngine(jcfg, jp, **kw).run(
        make_requests(JRequest, jcfg.vocab)))
    got = streams(ServeEngine(tcfg, tp, device="cpu", **kw).run(
        make_requests(Request, tcfg.vocab)))
    assert got == want
    assert [(o, p) for _, o, p in got if o != "done"] == [("preempted", 16)]


def test_pressure_syncs_once_per_chunk(ref):
    """Growth, stalls, preemption and the forced block tick decide on the
    device: the host reads the event rows once per chunk and nothing
    inside the tick loop, as unpaged and as the JAX engine."""
    tcfg, tp, out = ref
    eng, _ = run_port(tcfg, tp, **PRESSURE)
    rep = eng.last_run_report
    assert rep["outcomes"]["requeued"] >= 1
    assert rep["host_syncs"] == rep["chunks"]
    assert rep["chunks"] == out["report_pressure"]["chunks"]
    assert rep["ticks_dispatched"] == rep["ticks"]
