"""The port's ssm family (mamba2) on the CPU against the JAX package's, on
mamba2-smoke (4 layers, d_model 64, 8 SSD heads of 16, state 16, chunk
16, float32) with the JAX weights bridged across: ``lm_loss`` and pooled
features; the serving engine's greedy streams, outcomes and memory
report; slot reuse; TinyTrain's adaptation (probe scores, policy with SSD
units, losses, deltas, folded streams).  Within the port: block prefill
equals token-by-token decode bit for bit, a ``numerics`` stream's NaN
state does not reach the slot's next occupant (the JAX engine's does:
pinned here), and what is still unported raises naming its ROADMAP
item."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.core import lm_backbone as jlm_backbone
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import api, bridge, configs
from repro_torch.core.backbones import lm_backbone
from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
from repro_torch.models import overlay as OV
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServeEngine
from repro_torch.utils import tree_map

ARCH = "mamba2-1.3b"
ITERS = 4
TASK = dict(seq=16, max_way=5, support_pad=32, query_pad=32)
ENGINE = dict(slots=3, max_len=48, chunk=4)
PROMPT_LENS = (3, 5, 8, 9, 17, 20)


def units(policy):
    return [(u.layer, u.kind, u.channels) for u in policy.units]


def streams(reqs):
    return [(list(r.out), r.outcome) for r in reqs]


def requests(make, vocab, max_new=6):
    """Six requests; the 9-token prompt has a budget of 14 cache rows, so
    it is truncated before its sixth token."""
    rng = np.random.default_rng(0)
    return [make(uid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                 max_new=max_new, max_len=14 if n == 9 else None)
            for i, n in enumerate(PROMPT_LENS)]


def trees_close(port_tree, jax_tree, **tol):
    want = jax.tree_util.tree_map(np.asarray, jax_tree)
    got = bridge.tree_to_numpy(port_tree)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **tol)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke model's ops are tiny: several CPU threads per op only
    contend (10x slower under the parallel test run)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's runs, once per module: a token batch's loss and
    pooled features, the engine's streams at prefill blocks 8 and 1, the
    probe's scores, one fused adapt and its folded engine's streams; plus
    the port's session on the bridged weights."""
    jcfg = jconfigs.get_reduced(ARCH)
    jbb = jlm_backbone(jcfg, tokens_per_batch=32 * 16, batch_size=32)
    js = japi.TinyTrainSession(jbb, max_way=5, seed=0)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab, (3, 32)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    toks[2, 20:] = -1  # a padded row: pooled features average 20 tokens
    batch = {"tokens": toks, "labels": labels}
    out = {"batch": batch,
           "loss": float(JT.lm_loss(jcfg, js.params, batch)),
           "features": np.asarray(JT.pooled_features(jcfg, js.params,
                                                     batch))}
    for block in (8, 1):
        eng = JServeEngine(jcfg, js.params, prefill_block=block, **ENGINE)
        out[block] = streams(eng.run(requests(JRequest, jcfg.vocab)))
        out[f"memory{block}"] = eng.memory_report()
        out[f"report{block}"] = eng.last_run_report
    jtask = japi.sample_lm_task(np.random.default_rng(0), jcfg.vocab, **TASK)
    out["chans"] = jax.tree_util.tree_map(
        np.asarray, js.step_cache.probe_fisher()(
            js.params, jtask.support, jtask.pseudo_query,
            jbb.make_taps(len(jtask.support["episode_labels"])),
            np.float32(jtask.n_support)))
    out["adapt"] = js.adapt(jtask, japi.JETSON_NANO, iters=ITERS)
    eng = JServeEngine(jcfg, js.params, **ENGINE)
    out["adapt"].fold_into(eng)
    out["streams"] = streams(eng.run(requests(JRequest, jcfg.vocab)))

    cfg = configs.get_reduced(ARCH)
    bb = lm_backbone(cfg, tokens_per_batch=32 * 16, batch_size=32)
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, js.params), device="cpu")
    session = api.TinyTrainSession(bb, params, max_way=5)
    task = api.sample_lm_task(np.random.default_rng(0), cfg.vocab, **TASK)
    port = {"adapt": session.adapt(task, api.JETSON_NANO, iters=ITERS)}
    return out, session, task, port


def _batch(out):
    return {k: torch.from_numpy(v) for k, v in out["batch"].items()}


def test_lm_loss_and_pooled_features_match_reference(ref):
    out, session, _, _ = ref
    cfg, params = session.backbone.cfg, session.params
    loss = T.lm_loss(cfg, params, _batch(out))
    assert float(loss) == pytest.approx(out["loss"], rel=1e-5)
    feats = T.pooled_features(cfg, params, _batch(out))
    np.testing.assert_allclose(feats.numpy(), out["features"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("preset", ["smoke", "full"])
def test_unit_costs_and_taps_match_reference(preset):
    """One SSD unit a layer with the reference's costs, and one tap group
    (the mixer's SSD heads) with no FFN taps."""
    cfg = configs.preset_config(ARCH, preset)
    jcfg = jconfigs.preset_config(ARCH, preset)
    bb = lm_backbone(cfg, 48 * 64, 48)
    jbb = jlm_backbone(jcfg, 48 * 64, 48)
    assert ([vars(c) for c in bb.unit_costs]
            == [vars(c) for c in jbb.unit_costs])
    assert {c.kind for c in bb.unit_costs} == {"ssm"}
    taps = bb.make_taps(5, "cpu")
    jtaps = jbb.make_taps(5)
    assert ({g: {k: tuple(v.shape) for k, v in grp.items()}
             for g, grp in taps.items()}
            == {g: {k: tuple(v.shape) for k, v in grp.items()}
                for g, grp in jtaps.items()})


def test_caches_and_memory_report_match_reference(ref):
    out, session, _, _ = ref
    cfg = session.backbone.cfg
    jcfg = jconfigs.get_reduced(ARCH)
    caches = T.init_caches(cfg, 3, 48, device="cpu")
    want = JT.init_caches(jcfg, 3, 48)
    assert (jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                   bridge.tree_to_numpy(caches))
            == jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                      jax.tree_util.tree_map(np.asarray,
                                                             want)))
    eng = ServeEngine(cfg, session.params, device="cpu", **ENGINE)
    eng.run(requests(Request, cfg.vocab))
    assert eng.memory_report() == out["memory8"]


@pytest.mark.parametrize("block", [8, 1])
def test_streams_and_outcomes_match_reference(ref, block):
    out, session, _, _ = ref
    cfg = session.backbone.cfg
    eng = ServeEngine(cfg, session.params, prefill_block=block, device="cpu",
                      **ENGINE)
    got = streams(eng.run(requests(Request, cfg.vocab)))
    assert got == out[block]
    assert {o for _, o in got} == {"done", "truncated"}
    # the recurrent serve syncs once a chunk, over the JAX engine's ticks
    rep, jrep = eng.last_run_report, out[f"report{block}"]
    assert rep["host_syncs"] == rep["chunks"] == jrep["chunks"]
    for key in ("ticks", "ticks_dispatched", "peak_resident", "new_tokens",
                "outcomes"):
        assert rep[key] == jrep[key], key


@pytest.mark.parametrize("block", [8, 3])
def test_block_prefill_equals_token_by_token_decode(ref, block):
    """Prompts ingested in blocks (ragged lengths, paused slots) leave
    the same conv windows, SSD states and logits, bit for bit, as the
    same tokens fed one decode step at a time."""
    _, session, _, _ = ref
    cfg, params = session.backbone.cfg, session.params
    rng = np.random.default_rng(2)
    lens = [11, 4, 0]  # the last slot is paused throughout
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 11)))
    blocked = T.init_caches(cfg, 3, 32, device="cpu")
    pos = torch.zeros((3,), dtype=torch.int32)
    last = {}
    for s0 in range(0, 11, block):
        valid = torch.tensor([[s0 + j < n for j in range(block)]
                              for n in lens])
        chunk = torch.zeros((3, block), dtype=torch.long)
        w = min(block, 11 - s0)
        chunk[:, :w] = toks[:, s0:s0 + w]
        logits, blocked = T.prefill_block(cfg, params, chunk, blocked, pos,
                                          valid)
        for b, n in enumerate(lens):
            if s0 < n <= s0 + block:
                last[b] = logits[b, n - 1 - s0]
        pos = pos + valid.sum(1).to(torch.int32)
    stepped = T.init_caches(cfg, 3, 32, device="cpu")
    for t in range(11):
        logits, stepped = T.decode_step(cfg, params, toks[:, t:t + 1],
                                        stepped, torch.full((3,), t))
        for b, n in enumerate(lens):
            if t == n - 1:  # slot b's last prompt token
                assert torch.equal(logits[b, 0], last[b])
                for g, want in zip(stepped.values(), blocked.values()):
                    for key in ("conv", "ssm"):
                        assert torch.equal(g["ssm"][key][:, b],
                                           want["ssm"][key][:, b])
    for want in blocked.values():  # the paused slot never moved
        assert not want["ssm"]["ssm"][:, 2].any()
        assert not want["ssm"]["conv"][:, 2].any()


def test_slot_reuse_does_not_leak_state(ref):
    """A request served on a reused slot matches a solo run (the twin of
    ``tests/test_serve_scan.py::test_ssm_slot_reuse_does_not_leak_state``)."""
    _, session, _, _ = ref
    cfg, params = session.backbone.cfg, session.params
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=5).astype(np.int32)
               for _ in range(2)]
    eng = ServeEngine(cfg, params, slots=1, max_len=24, device="cpu")
    reqs = [Request(uid=i, prompt=p, max_new=4)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    solo = Request(uid=9, prompt=prompts[1], max_new=4)
    ServeEngine(cfg, params, slots=1, max_len=24, device="cpu").run([solo])
    assert reqs[1].out == solo.out and solo.outcome == "done"


def _poisoned(session):
    cfg = dataclasses.replace(session.backbone.cfg, tie_embeddings=False)
    params = dict(session.params, unembed=session.params["embed"].T.clone(),
                  embed=session.params["embed"].clone())
    params["embed"][77] = float("nan")
    return cfg, params


def _poison_requests(make):
    return [make(uid=0, prompt=np.asarray([1, 2, 3, 4, 5, 77], np.int32),
                 max_new=4),
            make(uid=1, prompt=np.asarray([9, 10, 11], np.int32), max_new=4)]


@pytest.mark.parametrize("block", [8, 1])
def test_numerics_stream_does_not_poison_the_next_occupant(ref, block):
    """A stream that ends ``numerics`` leaves a NaN SSD state in its slot;
    admission zeroes it with a fill, so the next request streams exactly
    as it would alone."""
    _, session, _, _ = ref
    cfg, params = _poisoned(session)
    kw = dict(slots=1, max_len=32, chunk=4, prefill_block=block,
              device="cpu")
    got = streams(ServeEngine(cfg, params, **kw).run(
        _poison_requests(Request)))
    alone = streams(ServeEngine(cfg, params, **kw).run(
        _poison_requests(Request)[1:]))
    assert got[0] == ([], "numerics")
    assert got[1] == alone[0] and alone[0][1] == "done"


def test_reference_engine_lets_a_numerics_state_poison_the_next(ref):
    """The JAX engine on the same weights and requests: its
    ``reset_slot_state`` zeroes the SSD state by ``x * keep``
    (``repro/models/transformer.py:838``), and NaN x 0 is NaN, so the
    next request in the slot ends ``numerics`` with no tokens.  A known
    state of the reference (ROADMAP queue 3); the port keeps the
    promise."""
    import jax.numpy as jnp

    _, session, _, _ = ref
    _, params = _poisoned(session)
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH),
                               tie_embeddings=False)
    jp = jax.tree_util.tree_map(jnp.asarray, bridge.tree_to_numpy(params))
    eng = JServeEngine(jcfg, jp, slots=1, max_len=32, chunk=4,
                       prefill_block=8)
    assert (streams(eng.run(_poison_requests(JRequest)))
            == [([], "numerics"), ([], "numerics")])


def test_probe_scores_match(ref):
    out, session, task, _ = ref
    t = {k: torch.from_numpy(v) for k, v in task.support.items()}
    pq = {k: torch.from_numpy(v) for k, v in task.pseudo_query.items()}
    taps = session.backbone.make_taps(len(task.support["episode_labels"]),
                                      "cpu")
    chans = session.step_cache.probe_fisher()(session.params, t, pq, taps,
                                              float(task.n_support))
    assert set(chans) == set(out["chans"])
    assert {kind for _, kind in chans} == {"ssm"}
    for key, want in out["chans"].items():
        np.testing.assert_allclose(chans[key].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_policy_losses_deltas_and_folded_streams_match(ref):
    out, session, _, port = ref
    got, want = port["adapt"], out["adapt"]
    assert units(got.policy) == units(want.policy)
    assert got.policy.horizon == want.policy.horizon
    assert got.policy.units and {u.kind for u in got.policy.units} == {"ssm"}
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    assert got.losses[-1] < got.losses[0]
    trees_close(got.deltas, want.deltas, rtol=2e-3, atol=2e-4)
    assert got.memory_report() == want.memory_report()
    assert got.host_transfers == 2 and got.skipped_steps == 0
    cfg = session.backbone.cfg
    eng = ServeEngine(cfg, session.params, device="cpu", **ENGINE)
    got.fold_into(eng)
    folded = streams(eng.run(requests(Request, cfg.vocab)))
    assert folded == out["streams"]
    base = streams(ServeEngine(cfg, session.params, device="cpu",
                               **ENGINE).run(requests(Request, cfg.vocab)))
    assert base != folded  # the deltas change what is served


def test_fold_is_exact_on_reference_deltas(ref):
    """The reference's own deltas, folded by the port, give the
    reference's folded weights exactly (SSD heads expand to
    ``ssm_head_dim`` columns of w_z and w_x and rows of w_out)."""
    out, session, _, _ = ref
    jad = out["adapt"]
    jcfg = jconfigs.get_reduced(ARCH)
    want = jad.fold_into(jax.tree_util.tree_map(
        jax.numpy.asarray, bridge.tree_to_numpy(session.params)))
    got = OV.fold_deltas(session.backbone.cfg, session.params,
                         bridge.tree_from_numpy(jax.tree_util.tree_map(
                             np.asarray, jad.deltas), device="cpu"),
                         jad.policy)
    assert jcfg.ssm_head_dim == session.backbone.cfg.ssm_head_dim
    trees_close(got, want, rtol=0, atol=0)


def test_later_features_raise_naming_their_item(ref):
    """The items that brought the ssm family's paging (12.2), its per-slot
    overlay and fleet adaptation (15.2), the hybrid family and a policy's
    remat option (9), and sharded ``adapt_many`` (16) are closed: those now
    run (tests/test_torch_ssm_paging.py, test_torch_ssm_personalise.py,
    test_torch_hybrid.py, test_torch_encdec.py and
    test_torch_fleet_sharding.py hold them to the JAX package; a remat
    policy's loss and delta gradients are the plain policy's bit for bit
    here, and a mesh fleet of one task equals the single-device one)."""
    _, session, task, _ = ref
    cfg, params = session.backbone.cfg, session.params
    pol = SparseUpdatePolicy(horizon=0, units=(SelectedUnit(1, "ssm", (0,)),))
    eng = ServeEngine(cfg, params, kv_paging=True, device="cpu")
    assert eng.spec is not None and eng.ssm_state_bytes_per_slot > 0
    ServeEngine(cfg, params, personalise=pol, device="cpu")
    st = tree_map(lambda a: a[1], params["stacks"]["g0"]["ssm"])
    d = OV.delta_init(cfg, 1, "ssm", 1, torch.float32, "cpu")
    slot = OV.slot_params(cfg, "ssm", st, tree_map(lambda a: a[None], d),
                          torch.zeros((1, 1), dtype=torch.int64))
    assert torch.equal(slot["w_z"][0], st["w_z"])
    T.check_supported(configs.get_reduced("zamba2-1.2b"))
    remat = dataclasses.replace(pol, meta={"remat": True})
    toks = torch.from_numpy(task.support["tokens"][:4])
    delta = {"L1": {"ssm": tree_map(lambda t: t + 0.01, OV.delta_init(
        cfg, 1, "ssm", 1, torch.float32, "cpu"))}}
    got = []
    for plan in (pol, remat):
        d = tree_map(lambda t: t.clone().requires_grad_(), delta)
        loss = T.lm_loss(cfg, params, {"tokens": toks, "labels": toks},
                         deltas=d, plan=plan)
        got.append((loss, torch.autograd.grad(loss, d["L1"]["ssm"]["w_x"])))
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1][0], got[1][1][0])
    from repro_torch.launch.mesh import make_debug_mesh

    one = session.adapt_many([task], api.JETSON_NANO, iters=2,
                             policy_override=pol)
    two = session.adapt_many([task], api.JETSON_NANO, iters=2,
                             policy_override=pol,
                             mesh=make_debug_mesh(2, devices=["cpu"]))
    assert session.last_fleet_report["mesh_axes"] == {"data": 2, "model": 1}
    np.testing.assert_allclose(two[0].losses, one[0].losses, rtol=1e-4,
                               atol=1e-5)


def test_serve_launcher_adapts_folds_and_serves(capsys):
    """``repro_torch.launch.serve --arch mamba2-1.3b --adapt`` on the CPU:
    adapt, fold into the engine, serve."""
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--preset", "smoke", "--device", "cpu",
                "--adapt", "--adapt-iters", "2", "--requests", "3",
                "--max-new", "3", "--slots", "2"])
    text = capsys.readouterr().out
    assert "adapted under jetson-nano" in text and ".ssm[" in text
    assert "host_transfers=2" in text and "done=3" in text
