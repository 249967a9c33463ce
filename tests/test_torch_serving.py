"""The port's ServeEngine on the CPU against the JAX package's ServeEngine
on qwen2-smoke with the JAX weights bridged across: greedy streams and
typed outcomes identical at prefill_block 8 and 1, and, within the port,
whatever the prefill block and chunk size."""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import bridge, configs
from repro_torch.core import adapt as telemetry
from repro_torch.serving import Request, ServeEngine

PROMPT_LENS = (3, 5, 8, 9, 17, 20)
ENGINE = dict(slots=3, max_len=48, chunk=4)


def make_requests(make, vocab, max_new=6):
    """Six requests; the one with the 9-token prompt has a KV budget of 14
    rows, so it is truncated before its sixth token."""
    rng = np.random.default_rng(0)
    return [make(uid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                 max_new=max_new, max_len=14 if n == 9 else None)
            for i, n in enumerate(PROMPT_LENS)]


def streams(reqs):
    return [(list(r.out), r.outcome) for r in reqs]


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's runs, once per module, plus the bridged weights."""
    cfg = jconfigs.get_reduced("qwen2-1.5b")
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = configs.get_reduced("qwen2-1.5b")
    tp = bridge.params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    out = {}
    for block in (8, 1):
        eng = JServeEngine(cfg, jp, prefill_block=block, **ENGINE)
        out[block] = streams(eng.run(make_requests(JRequest, cfg.vocab)))
        out[f"report{block}"] = eng.last_run_report
    eng = JServeEngine(cfg, jp, deadline_ticks=5, queue_limit=4, **ENGINE)
    out["pressure"] = streams(eng.run(make_requests(JRequest, cfg.vocab)))
    return tcfg, tp, out


def run_port(tcfg, tp, **kw):
    eng = ServeEngine(tcfg, tp, device="cpu", **{**ENGINE, **kw})
    return eng, streams(eng.run(make_requests(Request, tcfg.vocab)))


@pytest.mark.parametrize("block", [8, 1])
def test_streams_and_outcomes_match_reference(ref, block):
    tcfg, tp, out = ref
    eng, got = run_port(tcfg, tp, prefill_block=block)
    assert got == out[block]
    assert {o for _, o in got} == {"done", "truncated"}
    jrep, rep = out[f"report{block}"], eng.last_run_report
    for key in ("ticks", "peak_resident", "new_tokens", "outcomes"):
        assert rep[key] == jrep[key], key
    assert (rep["memory"]["kv_cache_bytes"]
            == jrep["memory"]["kv_cache_bytes"])


@pytest.mark.parametrize("block", [1, 8])
@pytest.mark.parametrize("chunk", [1, 4])
def test_streams_invariant_to_block_and_chunk(ref, block, chunk):
    tcfg, tp, out = ref
    assert run_port(tcfg, tp, prefill_block=block, chunk=chunk)[1] == out[8]


def test_deadline_and_queue_limit_match_reference(ref):
    """Resident-tick deadlines expire the long prompts; the queue limit
    sheds the overflow as 'rejected'."""
    tcfg, tp, out = ref
    _, got = run_port(tcfg, tp, deadline_ticks=5, queue_limit=4)
    assert got == out["pressure"]
    assert {o for _, o in got} >= {"expired", "rejected"}


def test_host_syncs_are_counted(ref):
    """One flag read per tick plus one event fetch per chunk, every one of
    them through core.adapt._fetch."""
    tcfg, tp, _ = ref
    before = telemetry.host_sync_count()
    eng, _ = run_port(tcfg, tp)
    rep = eng.last_run_report
    assert rep["host_syncs"] == telemetry.host_sync_count() - before
    assert rep["ticks"] + rep["chunks"] <= rep["host_syncs"]
    assert rep["host_syncs"] <= rep["ticks"] + 2 * rep["chunks"]


def test_non_finite_logits_end_the_stream_as_numerics(ref):
    """A NaN input-embedding row poisons only the request whose prompt ends
    on that token: it ends 'numerics' with nothing emitted and the others
    stream as in a clean run.  The unembedding is untied (a clean copy) so
    that the NaN row does not reach every slot's logits, and the poisoned
    request is the last one admitted, so no later request reuses its
    slot's cache stripe."""
    tcfg, tp, _ = ref
    cfg = dataclasses.replace(tcfg, tie_embeddings=False)
    clean = dict(tp, unembed=tp["embed"].T.clone())
    reqs = make_requests(Request, cfg.vocab)
    bad_tok = int(reqs[-1].prompt[-1])
    assert all(bad_tok not in r.prompt for r in reqs[:-1])
    poisoned = dict(clean, embed=clean["embed"].clone())
    poisoned["embed"][bad_tok] = float("nan")
    want = streams(ServeEngine(cfg, clean, device="cpu", **ENGINE).run(
        make_requests(Request, cfg.vocab)))
    got = streams(ServeEngine(cfg, poisoned, device="cpu", **ENGINE).run(reqs))
    assert got[-1] == ([], "numerics")
    assert got[:-1] == want[:-1]
    assert {o for _, o in want} == {"done", "truncated"}


@pytest.mark.parametrize("block", [8, 1])
def test_numerics_stream_does_not_poison_the_next_occupant(ref, block):
    """A stream that ends 'numerics' leaves NaN K/V rows in its slot's
    cache stripe.  The next request in that slot must stream exactly as it
    would alone, at every prefill block size.  (The JAX package's engine
    ends that request 'numerics' too: ROADMAP queue 3.)"""
    tcfg, tp, _ = ref
    cfg = dataclasses.replace(tcfg, tie_embeddings=False)
    params = dict(tp, unembed=tp["embed"].T.clone(),
                  embed=tp["embed"].clone())
    bad = 77
    params["embed"][bad] = float("nan")
    kw = dict(slots=1, max_len=32, chunk=4, prefill_block=block,
              device="cpu")

    def nxt():
        return Request(uid=1, prompt=np.asarray([9, 10, 11], np.int32),
                       max_new=4)

    poisoned = Request(uid=0, prompt=np.asarray([1, 2, 3, 4, 5, bad],
                                                np.int32), max_new=4)
    got = streams(ServeEngine(cfg, params, **kw).run([poisoned, nxt()]))
    alone = streams(ServeEngine(cfg, params, **kw).run([nxt()]))
    assert got[0] == ([], "numerics")
    assert got[1] == alone[0] and alone[0][1] == "done"


def test_reference_engine_lets_a_numerics_stream_poison_the_next(ref):
    """The JAX engine on the same weights and requests as the test above:
    its next request in the slot ends 'numerics' with no tokens, which
    breaks ``reset_slot_state``'s promise that stale rows are never
    attended to (``repro/models/transformer.py:818-819``).  A known state
    of the reference (ROADMAP queue 3); the port keeps the promise."""
    import jax.numpy as jnp

    tcfg, tp, _ = ref
    jcfg = dataclasses.replace(jconfigs.get_reduced("qwen2-1.5b"),
                               tie_embeddings=False)
    params = dict(tp, unembed=tp["embed"].T.clone(),
                  embed=tp["embed"].clone())
    params["embed"][77] = float("nan")
    jp = jax.tree_util.tree_map(jnp.asarray, bridge.tree_to_numpy(params))
    eng = JServeEngine(jcfg, jp, slots=1, max_len=32, chunk=4,
                       prefill_block=8)
    reqs = [JRequest(uid=0, prompt=np.asarray([1, 2, 3, 4, 5, 77], np.int32),
                     max_new=4),
            JRequest(uid=1, prompt=np.asarray([9, 10, 11], np.int32),
                     max_new=4)]
    assert streams(eng.run(reqs)) == [([], "numerics"), ([], "numerics")]


def test_submit_validates_and_sheds(ref):
    tcfg, tp, _ = ref
    eng = ServeEngine(tcfg, tp, device="cpu", queue_limit=1, **ENGINE)
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit(Request(uid=0, prompt=np.zeros(47, np.int32), max_new=1))
    assert eng.submit(Request(uid=1, prompt=np.ones(4, np.int32),
                              max_new=2)).accepted
    r = Request(uid=2, prompt=np.ones(4, np.int32), max_new=2)
    assert eng.submit(r) == (False, "queue_full") and r.outcome == "rejected"


@pytest.mark.parametrize("knob", [
    dict(faults=object()), dict(temperature=0.7, top_k=5),
    dict(admit_backfill=1), dict(temperature=0.7), dict(top_k=5),
    dict(fused=False),
])
def test_knobs_of_later_slices_raise(ref, knob):
    tcfg, tp, _ = ref
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
        ServeEngine(tcfg, tp, device="cpu", **{**ENGINE, **knob})


def test_serve_driver_runs_and_refuses_later_flags(capsys):
    from repro_torch.launch import serve

    serve.main(["--preset", "smoke", "--device", "cpu", "--requests", "3",
                "--max-new", "3", "--slots", "2"])
    text = capsys.readouterr().out
    assert "3 requests, 9 new tokens" in text and "done=3" in text
    serve.main(["--preset", "smoke", "--device", "cpu", "--requests", "6",
                "--max-new", "8", "--slots", "3", "--max-len", "32",
                "--paging", "--page-size", "8", "--pressure", "0.5"])
    text = capsys.readouterr().out
    assert "pressure 0.5x: 6 pages" in text and "done=6" in text
    assert "[serve] paged KV:" in text
    with pytest.raises(SystemExit, match="item 13"):
        serve.main(["--device", "cpu", "--inject", "nan:3:2"])
    with pytest.raises(SystemExit, match="item 11.1"):
        serve.main(["--device", "cpu", "--temperature", "0.8"])
