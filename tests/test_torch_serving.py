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
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServeEngine

PROMPT_LENS = (3, 5, 8, 9, 17, 20)
ENGINE = dict(slots=3, max_len=48, chunk=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke model's ops are tiny: several CPU threads per op only
    contend under the parallel test run (the launcher's runs ~40x)."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
    """One event fetch per chunk and no read inside the tick loop, as in
    the JAX engine, counted through core.adapt._fetch; every dispatched
    tick is a live one."""
    tcfg, tp, out = ref
    before = telemetry.host_sync_count()
    eng, _ = run_port(tcfg, tp)
    rep = eng.last_run_report
    assert rep["host_syncs"] == telemetry.host_sync_count() - before
    assert rep["host_syncs"] == rep["chunks"] == out["report8"]["chunks"]
    assert rep["ticks_dispatched"] == rep["ticks"]


@pytest.mark.parametrize("fused", [True, False])
def test_host_syncs_book_a_stray_read(ref, monkeypatch, fused):
    """A blocking read anywhere in a tick is booked to the engine that
    made it: one stray fetch per logits step raises ``host_syncs`` by the
    number of steps, so a fused run no longer shows one sync a chunk."""
    tcfg, tp, _ = ref
    clean, want = run_port(tcfg, tp, fused=fused)
    calls = [0]
    post = ServeEngine._post

    def stray(self, logits, *args):
        calls[0] += 1
        telemetry._fetch(logits[:, :1])
        return post(self, logits, *args)

    monkeypatch.setattr(ServeEngine, "_post", stray)
    eng, got = run_port(tcfg, tp, fused=fused)
    rep, base = eng.last_run_report, clean.last_run_report
    assert got == want and calls[0] > 0
    assert rep["host_syncs"] == base["host_syncs"] + calls[0]
    if fused:
        assert base["host_syncs"] == base["chunks"] < rep["host_syncs"]


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


def _fleet_exchange(tcfg, tp):
    """A ``Personaliser`` over a ``FleetRouter``: accepted, and a refresh's
    payload bytes cross the router's wire boundary into the user's
    registered set (tests/test_torch_fleet_serving.py holds the loop to
    the JAX package's)."""
    import torch

    from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
    from repro_torch.optim import compress as C
    from repro_torch.serving import (
        FleetRouter, Personaliser, encode_delta_payload,
    )

    pol = SparseUpdatePolicy(horizon=1, units=(SelectedUnit(1, "mlp", (0,)),))
    router = FleetRouter(tcfg, tp, replicas=2, devices=["cpu"],
                         personalise=pol, **ENGINE)
    session = _session(tcfg, tp)
    assert Personaliser(session, router, pol).engine is router
    d = session.backbone.init_deltas(pol, "cpu")
    d = {lk: {k: {n: v + 0.5 for n, v in pack.items()}
              for k, pack in kinds.items()} for lk, kinds in d.items()}
    q, scales, _ = C.int8_compress(d, C.ef_state_init(d))
    assert router.push_delta_payload(3, encode_delta_payload(pol, q, scales)
                                     ) == 0  # user 3 has no home yet
    got = router._delta_reg[3].deltas["L1"]["mlp"]
    for n, v in d["L1"]["mlp"].items():
        torch.testing.assert_close(got[n], v, rtol=0, atol=0.5 / 127)


def _remat(tcfg, tp):
    """A remat policy's forward equals the plain policy's bit for bit."""
    import torch

    from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy

    plan = SparseUpdatePolicy(horizon=1, units=(SelectedUnit(1, "mlp", (0,)),))
    remat = dataclasses.replace(plan, meta={"remat": True})
    x = tp["embed"][torch.zeros((1, 4), dtype=torch.long)]
    out = [T.forward_hidden(tcfg, tp, x, torch.arange(4)[None], plan=p,
                            deltas={})[0] for p in (plan, remat)]
    assert torch.equal(out[0], out[1])


def _serves(arch):
    """An engine on ``arch``'s smoke config serves requests carrying their
    encoder inputs to ``done`` (tests/test_torch_encdec_serving.py and
    test_torch_vlm_serving.py hold the streams to the JAX engine)."""
    def run(tcfg, tp):
        import torch

        cfg = configs.get_reduced(arch)
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        eng = ServeEngine(cfg, params, device="cpu", **ENGINE)
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
            np.int32), max_new=3, enc_feats=rng.standard_normal(
                cfg.enc_feats_shape).astype(np.float32))
            for i, n in enumerate(PROMPT_LENS[:3])]
        eng.run(reqs)
        assert [r.outcome for r in reqs] == ["done"] * 3
        rep = eng.last_run_report
        assert rep["host_syncs"] == rep["chunks"]

    return run


def _session(tcfg, tp):
    from repro_torch import api
    from repro_torch.core.backbones import lm_backbone

    return api.TinyTrainSession(lm_backbone(tcfg, 64, 4), tp, max_way=2,
                                device="cpu")


def _score_stream(tcfg, tp):
    """One finite mean NLL a sequence (tests/test_torch_block_score.py
    holds the scores to the JAX package's)."""
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 11))
    nll = _session(tcfg, tp).score_stream(toks.astype(np.int32), block=4)
    assert nll.shape == (2,) and np.isfinite(nll).all()


def _mesh(tcfg, tp):
    """A fleet of one task over two mesh positions gives the single-device
    losses (tests/test_torch_fleet_sharding.py holds the mesh path)."""
    from repro_torch import api
    from repro_torch.core.backbones import lm_backbone
    from repro_torch.launch.mesh import make_debug_mesh

    session = api.TinyTrainSession(lm_backbone(tcfg, 256, 16), tp,
                                   max_way=4, device="cpu")
    task = api.sample_lm_task(np.random.default_rng(0), tcfg.vocab, seq=16,
                              max_way=4, support_pad=16, query_pad=16)
    assert session.adapt_many([], "jetson-nano",
                              mesh=make_debug_mesh(2, devices=["cpu"])) == []
    one, two = (session.adapt_many([task], "jetson-nano", iters=2, mesh=m)
                for m in (None, make_debug_mesh(2, devices=["cpu"])))
    assert two[0].policy.units == one[0].policy.units
    np.testing.assert_allclose(two[0].losses, one[0].losses, rtol=1e-4,
                               atol=1e-5)


# what an earlier slice pinned as a raise and now runs
NOW_RUN = {"remat": _remat, "vlm": _serves("paligemma-3b"),
           "audio": _serves("whisper-base"), "score_stream": _score_stream,
           "fleet_exchange": _fleet_exchange, "mesh": _mesh}


@pytest.mark.parametrize("what", ["remat", "score_stream", "fleet_exchange",
                                  "mesh", "vlm", "audio"])
def test_knobs_of_later_slices_raise(ref, what):
    """What earlier slices pinned as raising, naming the ROADMAP item that
    would bring it, now runs, and each case checks that it does: a
    policy's remat option, the vlm and audio families, ``score_stream``
    (item 10), the fleet's delta exchange and sharded ``adapt_many`` (item
    16).  (The ssm family's paged cache and per-slot overlay and the hybrid
    family run too: ``tests/test_torch_ssm_paging.py``,
    ``test_torch_ssm_personalise.py``, ``test_torch_hybrid.py``.)"""
    tcfg, tp, _ = ref
    NOW_RUN[what](tcfg, tp)


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
    serve.main(["--preset", "smoke", "--device", "cpu", "--requests", "4",
                "--max-new", "4", "--slots", "2", "--inject", "nan:2:1",
                "--temperature", "0.8", "--top-k", "20"])
    text = capsys.readouterr().out
    assert "4 requests, 13 new tokens" in text
    assert "done=3, numerics=1" in text and "sampled T=0.8 top-k 20" in text
    # the encoder-decoder and vlm families: enc_feats drawn per request,
    # adapted on a conditioned task, contiguous and paged; paligemma's
    # prefix (8 positions at smoke size) counts in --max-len
    for arch, extra in (("whisper-base", []),
                        ("paligemma-3b", ["--paging", "--page-size", "4"])):
        serve.main(["--arch", arch, "--preset", "smoke", "--device", "cpu",
                    "--requests", "3", "--max-new", "3", "--slots", "2",
                    "--max-len", "40", "--adapt", "--adapt-iters", "2"]
                   + extra)
        text = capsys.readouterr().out
        assert "3 requests, 9 new tokens" in text and "done=3" in text
        assert "adapted under jetson-nano" in text
        assert "[serve] encoder runs:" in text
    with pytest.raises(SystemExit, match="token-only episodes"):
        serve.main(["--arch", "whisper-base", "--device", "cpu",
                    "--personalise"])
    serve.main(["--preset", "smoke", "--device", "cpu", "--requests", "3",
                "--max-new", "3", "--slots", "2", "--eager"])
    text = capsys.readouterr().out
    assert "3 requests, 9 new tokens" in text and "eager" in text
    # the fleet: two replicas behind the router, the fused engine only
    serve.main(["--preset", "smoke", "--device", "cpu", "--requests", "4",
                "--max-new", "3", "--slots", "2", "--fleet", "2"])
    text = capsys.readouterr().out
    assert "[serve] fleet: 2 replicas over 1 device(s)" in text
    assert "4 requests, 12 new tokens" in text and "done=4" in text
    assert "[serve] fleet: 2/2 replicas" in text
    with pytest.raises(SystemExit, match="requires the fused engine"):
        serve.main(["--device", "cpu", "--fleet", "2", "--eager"])
    with pytest.raises(SystemExit, match="--fleet must be >= 1"):
        serve.main(["--device", "cpu", "--fleet", "0"])
