"""The port's fault injection and page-demand backfill on the CPU against
the JAX package's, on the reference tests' two-layer model with the JAX
weights bridged across: the twins of ``tests/test_faults.py``'s serving
cases and of ``tests/test_fleet_serving.py``'s backfill cases, on the
fused engine and the eager loop, greedy and sampled.

Each faulted or backfilled run has the JAX engine's streams, outcomes,
preemptions and tally, and the reference's own oracles hold in the port:
every request ends terminal, a preempted and resumed stream equals the
unfaulted one, the fused engine fetches once a chunk, a NaN lands on its
(request, token) coordinate, and backfill admits past a blocked head in
fewer ticks without changing a stream.  With ``faults=None`` (or an empty
plan) no fault hook runs."""
import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.models.api import ArchConfig as JArchConfig
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving.faults import FaultConfig as JFaultConfig
from repro.serving.faults import parse_inject as jparse_inject
from repro_torch import bridge
from repro_torch.models.api import ArchConfig
from repro_torch.serving import FaultConfig, Request, ServeEngine
from repro_torch.serving import faults as FI
from repro_torch.serving import parse_inject

TINY = dict(name="t", family="dense", n_layers=2, d_model=32, vocab=64,
            n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, dtype="float32")
PAGED = dict(slots=4, max_len=32, chunk=8, kv_paging=True, kv_page_size=8)
SAMPLING = {"greedy": {}, "sampled": dict(temperature=0.7, top_k=8)}
# name -> (engine knobs, fault plan, prompts(...) knobs, max_new)
SCENARIOS = {
    "pressure": (dict(reserve="asyougo", page_budget=8), None, {}, 6),
    "forced_preempt": (dict(reserve="asyougo"),
                       dict(force_preempt=((1, 2), (3, 4))), dict(n=6), 6),
    "preempt_budget": (dict(reserve="asyougo", preempt_budget=0),
                       dict(force_preempt=((0, 2),)), dict(n=4), 6),
    "exhaustion": (dict(reserve="asyougo", kv_page_size=4),
                   dict(exhaust_ticks=(3, 9)), dict(n=6, lo=4), 8),
    "permanent_exhaustion": (dict(reserve="asyougo", kv_page_size=4,
                                  preempt_budget=2),
                             dict(exhaust_ticks=(0, 1 << 20)),
                             dict(n=4, lo=4), 8),
    "deadline": (dict(deadline_ticks=3), None, dict(n=4), 12),
    "nan": ({}, dict(nan_logits=((2, 3),)), dict(n=5), 6),
    "chaos": (dict(reserve="asyougo", page_budget=8, deadline_ticks=64),
              dict(force_preempt=((1, 2),), exhaust_ticks=(4, 8),
                   nan_logits=((5, 1),)), {}, 6),
}
LOOPS = {"fused": True, "eager": False}
# backfill (tests/test_fleet_serving.py): a 16-token head blocked on pages
# while two 4-token requests fit
BACKFILL = dict(slots=2, max_len=24, chunk=8, prefill_block=4,
                kv_paging=True, kv_page_size=4, page_budget=7,
                reserve="asyougo")


def prompts(n=8, lo=3, hi=9, seed=1, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def requests(cls, name):
    _, _, pkw, max_new = SCENARIOS[name]
    reqs = [cls(uid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts(**pkw))]
    if name == "deadline":
        reqs[0].deadline_ticks = 4096  # a per-request override
    return reqs


def backfill_requests(cls):
    rng = np.random.default_rng(21)
    return [cls(uid=i, prompt=rng.integers(0, 64, size=n).astype(np.int32),
                max_new=4) for i, n in enumerate((16, 16, 4, 4))]


def knobs(name, fused, samp, fault_cls):
    ekw, plan, _, _ = SCENARIOS[name]
    kw = {**PAGED, **ekw, "fused": fused, **SAMPLING[samp]}
    if plan is not None:
        kw["faults"] = fault_cls(**plan)
    return kw


def outcome(reqs, rep):
    return ([(list(r.out), r.outcome, r.preempts) for r in reqs],
            rep["outcomes"])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's faulted and backfilled runs, once per module, and
    the bridged weights."""
    jcfg = JArchConfig(**TINY).validate()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = ArchConfig(**TINY).validate()
    tp = bridge.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    out = {}
    for name in SCENARIOS:
        for loop, fused in LOOPS.items():
            for samp in SAMPLING:
                eng = JServeEngine(jcfg, jp, **knobs(name, fused, samp,
                                                     JFaultConfig))
                reqs = eng.run(requests(JRequest, name))
                out[name, loop, samp] = outcome(reqs, eng.last_run_report)
    for loop, fused in LOOPS.items():
        for bf in (None, 4):
            kw = dict(BACKFILL, fused=fused, admit_backfill=bf)
            eng = JServeEngine(jcfg, jp, **kw)
            reqs = eng.run(backfill_requests(JRequest))
            out["backfill", loop, bf] = (outcome(reqs, eng.last_run_report),
                                         eng.last_run_report["ticks"])
    return cfg, tp, out


def port_run(ref, name, loop, samp, **extra):
    cfg, tp, _ = ref
    eng = ServeEngine(cfg, tp, device="cpu",
                      **{**knobs(name, LOOPS[loop], samp, FaultConfig),
                         **extra})
    reqs = eng.run(requests(Request, name))
    return eng, reqs


@pytest.mark.parametrize("samp", list(SAMPLING))
@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_faulted_run_equals_reference(ref, name, loop, samp):
    """Streams, outcomes, preemptions and the tally equal the JAX
    engine's; every request ends terminal, counted once among the
    terminal outcomes; the fused engine fetches once a chunk."""
    eng, reqs = port_run(ref, name, loop, samp)
    rep = eng.last_run_report
    assert outcome(reqs, rep) == ref[2][name, loop, samp]
    assert all(r.terminal for r in reqs)
    assert sum(v for k, v in rep["outcomes"].items()
               if k != "requeued") == len(reqs)
    if loop == "fused":
        assert rep["host_syncs"] == rep["chunks"]


@pytest.mark.parametrize("samp", list(SAMPLING))
@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("name", ["pressure", "forced_preempt",
                                  "exhaustion", "permanent_exhaustion"])
def test_resumed_streams_equal_unfaulted(ref, name, loop, samp):
    """A stream preempted and resumed (by page pressure, by the plan, in
    and after an exhaustion window) is the unfaulted stream, greedy and
    sampled: the recompute swap and keys on (request, token)."""
    eng, reqs = port_run(ref, name, loop, samp)
    _, base = port_run(ref, name, loop, samp, faults=None,
                       page_budget=None, reserve="worstcase",
                       preempt_budget=4)
    assert all(r.outcome == "done" for r in base)
    done = [r for r in reqs if r.outcome == "done"]
    assert done
    for r in done:
        assert list(r.out) == list(base[r.uid].out), r.uid
    if name in ("forced_preempt", "exhaustion"):
        assert len(done) == len(reqs)
    if name == "forced_preempt":
        assert reqs[1].preempts >= 1 and reqs[3].preempts >= 1
    if name == "permanent_exhaustion":
        starved = [r for r in reqs if r.outcome != "done"]
        assert starved  # the retry budget binds under total starvation
        for r in starved:
            assert r.outcome == "preempted" and r.preempts == 2
            assert len(r.out) < r.max_new


@pytest.mark.parametrize("loop", list(LOOPS))
def test_preempt_budget_exhaustion_is_terminal(ref, loop):
    eng, reqs = port_run(ref, "preempt_budget", loop, "greedy")
    assert reqs[0].outcome == "preempted"
    assert len(reqs[0].out) < reqs[0].max_new
    assert all(r.outcome == "done" for r in reqs[1:])
    assert eng.last_run_report["outcomes"].get("preempted") == 1


@pytest.mark.parametrize("loop", list(LOOPS))
def test_deadline_expiry(ref, loop):
    eng, reqs = port_run(ref, "deadline", loop, "greedy")
    assert reqs[0].outcome == "done"
    assert all(r.outcome == "expired" for r in reqs[1:])
    assert eng.last_run_report["outcomes"].get("expired") == 3


@pytest.mark.parametrize("samp", list(SAMPLING))
@pytest.mark.parametrize("loop", list(LOOPS))
def test_nan_logits_end_the_stream_at_their_coordinate(ref, loop, samp):
    """NaN logits at (request 2, token 3): that request ends 'numerics'
    with its first three tokens, its neighbours stream as unfaulted."""
    eng, reqs = port_run(ref, "nan", loop, samp)
    _, base = port_run(ref, "nan", loop, samp, faults=None)
    assert reqs[2].outcome == "numerics"
    assert list(reqs[2].out) == list(base[2].out)[:3]
    for a, b in zip(base, reqs):
        if a.uid != 2:
            assert b.outcome == "done" and list(a.out) == list(b.out)
    assert eng.last_run_report["outcomes"].get("numerics") == 1


def test_submit_backpressure_and_run_shedding(ref):
    cfg, tp, _ = ref
    eng = ServeEngine(cfg, tp, device="cpu", queue_limit=2, **PAGED)
    verdicts = [eng.submit(r) for r in requests(Request, "nan")[:3]]
    assert verdicts[0].accepted and verdicts[1].accepted
    assert not verdicts[2].accepted and verdicts[2].reason == "queue_full"
    eng2 = ServeEngine(cfg, tp, device="cpu", queue_limit=2, **PAGED)
    reqs = eng2.run(requests(Request, "pressure"))
    shed = [r for r in reqs if r.outcome == "rejected"]
    assert len(shed) == 6 and all(not r.out for r in shed)
    assert all(r.terminal for r in reqs)
    assert eng2.last_run_report["outcomes"].get("rejected") == 6


def test_fault_queue_limit_override(ref):
    cfg, tp, _ = ref
    eng = ServeEngine(cfg, tp, device="cpu", queue_limit=3,
                      faults=FaultConfig(queue_limit=1), **PAGED)
    assert eng.queue_limit == 1
    reqs = requests(Request, "nan")
    assert eng.submit(reqs[0]).accepted
    assert eng.submit(reqs[1]).reason == "queue_full"


def test_fault_config_validation():
    with pytest.raises(ValueError, match="emitted_count"):
        FaultConfig(force_preempt=((0, 0),))
    with pytest.raises(ValueError, match="non-empty"):
        FaultConfig(exhaust_ticks=(5, 5))


@pytest.mark.parametrize("spec", [
    "nan:3:2, pre:1:4, exhaust:10:20, qlimit:8", "pre:0:3,nan:2:5",
    "exhaust:0:1", ""])
def test_parse_inject_equals_reference(spec):
    want = jparse_inject(spec)
    got = parse_inject(spec)
    for f in ("nan_logits", "force_preempt", "exhaust_ticks", "queue_limit"):
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(ValueError, match="bad fault spec"):
        parse_inject(spec + ",bogus:1")


@pytest.mark.parametrize("loop", list(LOOPS))
def test_disabled_faults_run_no_hook(ref, loop, monkeypatch):
    """``faults=None`` and an empty plan run no fault hook and give the
    same streams; a plan that only limits the queue adds none either."""

    def refuse(*a, **k):
        raise AssertionError("a fault hook ran")

    for hook in ("nan_hit", "preempt_hit", "exhausted"):
        monkeypatch.setattr(FI, hook, refuse)
    runs = [port_run(ref, "pressure", loop, "greedy", faults=f)[1]
            for f in (None, FaultConfig(), FaultConfig(queue_limit=64))]
    got = [[(list(r.out), r.outcome, r.preempts) for r in reqs]
           for reqs in runs]
    assert got[0] == got[1] == got[2]


@pytest.mark.parametrize("loop", list(LOOPS))
def test_backfill_equals_reference_and_is_faster(ref, loop):
    """With the head blocked on pages, later small requests admit in its
    place: the JAX engine's ticks and streams, fewer fused ticks than FIFO
    admission, the same streams, the aged head still served."""
    cfg, tp, out = ref
    ticks = {}
    for bf in (None, 4):
        eng = ServeEngine(cfg, tp, device="cpu", fused=LOOPS[loop],
                          admit_backfill=bf, **{**BACKFILL})
        reqs = eng.run(backfill_requests(Request))
        rep = eng.last_run_report
        want, want_ticks = out["backfill", loop, bf]
        assert outcome(reqs, rep) == want
        assert rep["ticks"] == want_ticks
        assert all(r.outcome == "done" for r in reqs)
        if loop == "fused":
            assert rep["host_syncs"] == rep["chunks"]
        ticks[bf] = rep["ticks"]
    # the eager loop refills a freed slot in the tick that frees it, so
    # here it gains no tick from backfill (nor does the JAX package's)
    assert ticks[4] < ticks[None] if loop == "fused" else ticks[4] <= ticks[
        None]
    assert out["backfill", loop, 4][0] == out["backfill", loop, None][0]


def test_backfill_eager_equals_fused(ref):
    _, _, out = ref
    assert out["backfill", "eager", 4][0][0] == out["backfill", "fused",
                                                    4][0][0]
    cfg, tp, _ = ref
    streams = []
    for fused in (True, False):
        eng = ServeEngine(cfg, tp, device="cpu", fused=fused,
                          admit_backfill=2, **BACKFILL)
        streams.append([list(r.out) for r in
                        eng.run(backfill_requests(Request))])
    assert streams[0] == streams[1]


def test_backfill_requires_paging_and_a_positive_bound(ref):
    cfg, tp, _ = ref
    with pytest.raises(ValueError, match="requires paging"):
        ServeEngine(cfg, tp, slots=2, max_len=32, admit_backfill=2,
                    device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        ServeEngine(cfg, tp, slots=2, max_len=32, kv_paging=True,
                    admit_backfill=0, device="cpu")
