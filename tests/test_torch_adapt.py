"""The port's TinyTrain adaptation (Fisher probe, Eq. 3 selection, sparse
fine-tune, fold into the engine) on the CPU against the JAX package's, on
qwen2-smoke with the JAX weights bridged across and the same episode from
the same seed: per-channel Fisher scores, the selected policy, losses,
deltas, accuracy, host transfers, the non-finite guard and the folded
engine's greedy streams.  Within the port: eager == fused."""
import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.core import lm_backbone as jlm_backbone
from repro.core.selection import select_policy as jselect_policy
from repro.data import synthetic as jsyn
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import api, bridge, configs
from repro_torch.core.backbones import lm_backbone
from repro_torch.core.selection import select_policy
from repro_torch.data import synthetic as syn
from repro_torch.models.overlay import fold_deltas
from repro_torch.serving import Request, ServeEngine

ITERS = 4
TASK = dict(seq=16, max_way=5, support_pad=32, query_pad=32)
ENGINE = dict(slots=3, max_len=48, chunk=4)
PROMPT_LENS = (3, 5, 8, 9, 17)


def units(policy):
    return [(u.layer, u.kind, u.channels) for u in policy.units]


def streams(reqs):
    return [(list(r.out), r.outcome) for r in reqs]


def requests(make, vocab):
    rng = np.random.default_rng(3)
    return [make(uid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                 max_new=6) for i, n in enumerate(PROMPT_LENS)]


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
    """The JAX package's runs, once per module: the probe's per-channel
    scores, one fused adapt, one with a NaN loss injected, and the folded
    engine's streams; plus the port's session on the bridged weights."""
    jcfg = jconfigs.get_reduced("qwen2-1.5b")
    jbb = jlm_backbone(jcfg, tokens_per_batch=32 * 16, batch_size=32)
    js = japi.TinyTrainSession(jbb, max_way=5, seed=0)
    jtask = japi.sample_lm_task(np.random.default_rng(0), jcfg.vocab, **TASK)
    out = {"task": jtask}
    out["chans"] = jax.tree_util.tree_map(
        np.asarray, js.step_cache.probe_fisher()(
        js.params, jtask.support, jtask.pseudo_query,
        jbb.make_taps(len(jtask.support["episode_labels"])),
        np.float32(jtask.n_support)))
    out["adapt"] = js.adapt(jtask, japi.JETSON_NANO, iters=ITERS)
    out["nan"] = js.adapt(jtask, japi.JETSON_NANO, iters=ITERS,
                          nan_loss_steps=(1,))
    eng = JServeEngine(jcfg, js.params, **ENGINE)
    out["adapt"].fold_into(eng)
    out["streams"] = streams(eng.run(requests(JRequest, jcfg.vocab)))
    out["folded"] = out["adapt"].fold_into(js.params)

    cfg = configs.get_reduced("qwen2-1.5b")
    bb = lm_backbone(cfg, tokens_per_batch=32 * 16, batch_size=32)
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, js.params), device="cpu")
    session = api.TinyTrainSession(bb, params, max_way=5)
    task = api.sample_lm_task(np.random.default_rng(0), cfg.vocab, **TASK)
    port = {"adapt": session.adapt(task, api.JETSON_NANO, iters=ITERS)}
    return out, session, task, port


def test_lm_episodes_identical_from_one_seed():
    for seed in (0, 5):
        a = syn.lm_episode(np.random.default_rng(seed), 300, 12,
                           support_pad=40, query_pad=40)
        b = jsyn.lm_episode(np.random.default_rng(seed), 300, 12,
                            support_pad=40, query_pad=40)
        for got, want in ((a.support, b.support), (a.query, b.query)):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        rng_a, rng_b = (np.random.default_rng(seed + 1) for _ in range(2))
        aug_a = syn.augment_lm_support(rng_a, a.support)
        aug_b = jsyn.augment_lm_support(rng_b, b.support)
        for k in aug_b:
            np.testing.assert_array_equal(aug_a[k], aug_b[k])
    np.testing.assert_array_equal(
        syn.markov_tokens(np.random.default_rng(2), 5000, 3, 7, order_seed=4),
        jsyn.markov_tokens(np.random.default_rng(2), 5000, 3, 7, order_seed=4))


def test_task_matches_reference(ref):
    out, _, task, _ = ref
    jtask = out["task"]
    for name in ("support", "query", "pseudo_query"):
        for k, want in getattr(jtask, name).items():
            np.testing.assert_array_equal(getattr(task, name)[k],
                                          np.asarray(want))
    assert task.n_support == jtask.n_support


@pytest.mark.parametrize("arch_preset", [("smoke", 32 * 16, 32),
                                         ("full", 48 * 64, 48)])
def test_unit_costs_and_selection_identical(arch_preset):
    """The same unit costs, and the same policy from the same scores, for
    qwen2-smoke and for qwen2-1.5b at full width under the profile
    ``chip_smoke.py`` adapts with (which must select attn and mlp)."""
    preset, tokens, batch = arch_preset
    cfg = configs.preset_config("qwen2-1.5b", preset)
    jcfg = jconfigs.preset_config("qwen2-1.5b", preset)
    costs = lm_backbone(cfg, tokens, batch).unit_costs
    jcosts = jlm_backbone(jcfg, tokens, batch).unit_costs
    assert [vars(c) for c in costs] == [vars(c) for c in jcosts]
    def edge_lm(mod):  # examples/serve_batched.py's, scaled as chip_smoke
        return mod.DeviceProfile(name="edge-lm", mem_kb=4000,
                                 compute_frac=0.5).scaled(mem=500,
                                                          compute=1.6)

    profile = api.JETSON_NANO if preset == "smoke" else edge_lm(api)
    jprofile = japi.JETSON_NANO if preset == "smoke" else edge_lm(japi)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        pot = rng.lognormal(0, 2, len(costs))
        chans = {(c.layer, c.kind): rng.uniform(0, 1, c.n_channels)
                 for c in costs}
        got = select_policy(costs, pot, chans, profile.budget())
        want = jselect_policy(jcosts, pot, chans, jprofile.budget())
        assert units(got) == units(want) and got.horizon == want.horizon
        assert got.meta == want.meta
        if preset == "full":
            assert {u.kind for u in got.units} == {"attn", "mlp"}


def test_probe_scores_match(ref):
    out, session, task, _ = ref
    t = {k: torch.from_numpy(v) for k, v in task.support.items()}
    pq = {k: torch.from_numpy(v) for k, v in task.pseudo_query.items()}
    taps = session.backbone.make_taps(len(task.support["episode_labels"]),
                                      "cpu")
    chans = session.step_cache.probe_fisher()(session.params, t, pq, taps,
                                              float(task.n_support))
    assert set(chans) == set(out["chans"])
    for key, want in out["chans"].items():
        got = chans[key].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_policy_losses_deltas_and_accuracy_match(ref):
    out, _, _, port = ref
    got, want = port["adapt"], out["adapt"]
    assert units(got.policy) == units(want.policy)
    assert got.policy.horizon == want.policy.horizon
    assert {u.kind for u in got.policy.units} == {"attn", "mlp"}
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    assert got.losses[-1] < got.losses[0]
    trees_close(got.deltas, want.deltas, rtol=2e-3, atol=2e-4)
    assert got.accuracy() == pytest.approx(want.accuracy(), abs=1e-6)
    assert got.memory_report() == want.memory_report()
    assert got.skipped_steps == 0


def test_fused_adapt_makes_two_host_transfers(ref):
    _, session, task, port = ref
    from repro_torch.core import adapt as telemetry

    assert port["adapt"].host_transfers == 2
    before = telemetry.host_sync_count()
    session.adapt(task, api.JETSON_NANO, iters=2)
    assert telemetry.host_sync_count() - before == 2


def test_eager_equals_fused(ref):
    _, session, task, port = ref
    eager = session.adapt(task, api.JETSON_NANO, iters=ITERS, fused=False)
    fused = port["adapt"]
    assert units(eager.policy) == units(fused.policy)
    assert eager.losses == fused.losses
    for a, b in zip(bridge.tree_to_numpy(eager.deltas).values(),
                    bridge.tree_to_numpy(fused.deltas).values()):
        for k in a:
            for w in a[k]:
                np.testing.assert_array_equal(a[k][w], b[k][w])
    assert eager.host_transfers == 1 + ITERS


@pytest.mark.parametrize("fused", [True, False])
def test_nan_loss_step_is_skipped_like_the_reference(ref, fused):
    out, session, task, _ = ref
    got = session.adapt(task, api.JETSON_NANO, iters=ITERS,
                        nan_loss_steps=(1,), fused=fused)
    want = out["nan"]
    assert got.skipped_steps == want.skipped_steps == 1
    assert np.isnan(got.losses[1]) and np.isnan(want.losses[1])
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    trees_close(got.deltas, want.deltas, rtol=2e-3, atol=2e-4)


def test_folded_engine_streams_match_reference(ref):
    out, session, _, port = ref
    cfg = session.backbone.cfg
    eng = ServeEngine(cfg, session.params, device="cpu", **ENGINE)
    assert port["adapt"].fold_into(eng) is eng
    got = streams(eng.run(requests(Request, cfg.vocab)))
    assert got == out["streams"]
    base = streams(ServeEngine(cfg, session.params, device="cpu",
                               **ENGINE).run(requests(Request, cfg.vocab)))
    assert base != got  # the deltas change what is served


def test_fold_into_params_returns_a_copy(ref):
    out, session, _, port = ref
    before = bridge.tree_to_numpy(session.params)
    folded = port["adapt"].fold_into(session.params)
    trees_close(session.params, before, rtol=0, atol=0)
    trees_close(folded, out["folded"], rtol=2e-3, atol=2e-4)
    # the fold itself is exact: the reference's deltas, folded by the port
    jad = out["adapt"]
    exact = fold_deltas(session.backbone.cfg, session.params,
                        bridge.tree_from_numpy(jax.tree_util.tree_map(
                            np.asarray, jad.deltas), device="cpu"),
                        jad.policy)
    trees_close(exact, out["folded"], rtol=0, atol=0)


def test_describe_and_later_features(ref):
    _, session, task, port = ref
    text = port["adapt"].describe()
    assert "host_transfers=2" in text and "L0." in text
    # token-batch scoring runs (tests/test_torch_block_score.py holds it to
    # the JAX package): one finite mean NLL a sequence
    nll = session.score_stream(np.zeros((2, 4), np.int32), block=2)
    assert nll.shape == (2,) and np.isfinite(nll).all()
    # the routes this slice brought raise the JAX package's errors
    with pytest.raises(ValueError, match="static channel mode"):
        session.adapt_many([task], api.JETSON_NANO, criterion="random")
    with pytest.raises(ValueError, match="CNN-only"):
        session.baseline("tinytl", task, "jetson-nano")
    with pytest.raises(KeyError, match="unknown baseline"):
        session.baseline("bogus", task, "jetson-nano")


def test_plan_sparse_update_matches_reference():
    """The token-batch probe (the backbone's own LM loss, host-side
    reduction) selects the reference's policy."""
    jcfg = jconfigs.get_reduced("qwen2-1.5b")
    jbb = jlm_backbone(jcfg, tokens_per_batch=4 * 16, batch_size=4)
    jparams = jbb.init(jax.random.PRNGKey(1))
    toks = jsyn.markov_tokens(np.random.default_rng(0), jcfg.vocab, 4, 16)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    want, _ = japi.plan_sparse_update(
        jbb, jparams, {"tokens": toks, "labels": labels}, japi.JETSON_NANO,
        n_samples=4)
    cfg = configs.get_reduced("qwen2-1.5b")
    bb = lm_backbone(cfg, tokens_per_batch=4 * 16, batch_size=4)
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    got, secs = api.plan_sparse_update(
        bb, params, {"tokens": torch.from_numpy(toks),
                     "labels": torch.from_numpy(labels)},
        api.JETSON_NANO, n_samples=4)
    assert units(got) == units(want) and secs > 0


def test_serve_launcher_adapts_folds_and_serves(capsys):
    """``repro_torch.launch.serve --adapt``: the twin of
    ``examples/serve_batched.py`` (adapt, fold into the engine, serve)."""
    from repro_torch.launch import serve

    serve.main(["--preset", "smoke", "--device", "cpu", "--adapt",
                "--adapt-iters", "2", "--requests", "3", "--max-new", "3",
                "--slots", "2"])
    text = capsys.readouterr().out
    assert "adapted under jetson-nano" in text
    assert "host_transfers=2" in text and "done=3" in text
