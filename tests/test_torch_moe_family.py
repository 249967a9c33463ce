"""The port's moe family on the CPU against the JAX package's, on
mixtral-smoke (3 layers, 4 experts top-2, a 32-token sliding window) and
deepseek-smoke (MLA with a 16-wide latent, a dense-head layer, 8 experts
top-2 with a shared expert, the MTP head), f32, with the JAX weights
bridged across: ``lm_loss`` (the MoE aux and MTP terms) and pooled
features; unit costs, taps and cache layouts; the serving engine's greedy
streams, eager == fused at prefill blocks 1 and 8 == the JAX engine, on
contiguous, rolling (prompts that wrap the window), paged, int8 and
pressured caches; the step mask changing no byte of a rolling or latent
cache; TinyTrain's adaptation (probe scores, policy, losses, deltas,
folded streams); per-slot personalised streams against each user's
folded copy; and the serve launcher."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.core import lm_backbone as jlm_backbone
from repro.core.policy import SelectedUnit as JUnit
from repro.core.policy import SparseUpdatePolicy as JPolicy
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import api, bridge, configs
from repro_torch.core.backbones import lm_backbone
from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
from repro_torch.models import overlay as OV
from repro_torch.models import transformer as T
from repro_torch.serving import DeltaSet, Request, ServeEngine
from repro_torch.utils import tree_map

ARCHS = ("mixtral-8x7b", "deepseek-v3-671b")
ITERS = 4
TASK = dict(seq=16, max_way=5, support_pad=32, query_pad=32)
PROMPT_LENS = (3, 5, 8, 9, 17)
# mixtral-smoke's window is 32: max_len 24 keeps a plain cache (block
# prefill through the cached flash kernel), 80 rolls it
ENGINE = dict(slots=3, max_len=24, chunk=4)
# the serving modes: contiguous streams are held to the JAX engine's,
# paged and pressured ones to those (as the JAX package's own paging tests
# hold its paged streams to its contiguous ones), int8 pages to their own
# fused and eager twins (tests/test_torch_mla.py holds int8 latent pages
# to the JAX package layer by layer)
MODES = {
    "contiguous": {},
    "paged": dict(kv_paging=True, kv_page_size=4),
    "int8": dict(kv_paging=True, kv_page_size=4, kv_int8=True),
    # half the fixed-stripe pages: growth runs the pool dry mid-stream
    "pressured": dict(kv_paging=True, kv_page_size=4),
}
ROLLING = dict(slots=2, max_len=80, chunk=16)
ROLLING_LENS = (8, 30, 45, 70)


def mode_kw(arch, mode):
    kw = dict(ENGINE, **MODES[mode])
    if mode == "pressured":
        kw["page_budget"] = kw["slots"] * -(-kw["max_len"] // 4) // 2
    return kw


def units(policy):
    return [(u.layer, u.kind, u.channels) for u in policy.units]


def streams(reqs):
    return [(list(r.out), r.outcome) for r in reqs]


def requests(make, vocab, lens=PROMPT_LENS, max_new=6, uid=None):
    rng = np.random.default_rng(3)
    return [make(uid=i if uid is None else uid(i),
                 prompt=rng.integers(0, vocab, n).astype(np.int32),
                 max_new=max_new) for i, n in enumerate(lens)]


def trees_close(port_tree, jax_tree, **tol):
    want = jax.tree_util.tree_map(np.asarray, jax_tree)
    got = bridge.tree_to_numpy(port_tree)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **tol)


def covering_policy(bb, unit_cls, policy_cls):
    """One unit of every kind the backbone exposes (first + last channel),
    as ``tests/test_personalise.py`` builds it."""
    out, seen = [], set()
    for c in reversed(bb.unit_costs):
        if c.kind not in seen:
            out.append(unit_cls(c.layer, c.kind,
                                tuple(sorted({0, c.n_channels - 1}))))
            seen.add(c.kind)
    out.sort(key=lambda u: (u.layer, u.kind))
    return policy_cls(horizon=0, units=tuple(out))


def rand_deltas(jbb, policy, seed, scale=0.05):
    deltas = jbb.init_deltas(policy)
    leaves, treedef = jax.tree_util.tree_flatten(deltas)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    leaves = [np.asarray(jax.random.normal(k, x.shape, x.dtype) * scale)
              for k, x in zip(keys, leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke models' ops are tiny: several CPU threads per op only
    contend (10x slower under the parallel test run)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_runs(arch):
    """The JAX package's runs on one smoke config: a token batch's loss
    and features, the engine's contiguous streams (and mixtral's
    rolling case), the probe's scores, one fused adapt and its folded
    streams, and two users' random deltas over every unit kind."""
    jcfg = jconfigs.get_reduced(arch)
    jbb = jlm_backbone(jcfg, tokens_per_batch=32 * 16, batch_size=32)
    js = japi.TinyTrainSession(jbb, max_way=5, seed=0)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab, (3, 32)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    toks[2, 20:] = -1  # a padded row: pooled features average 20 tokens
    batch = {"tokens": toks, "labels": labels}
    # jitted: the eager JAX forward of the MoE and MTP takes far longer
    out = {"batch": batch,
           "loss": float(jax.jit(JT.lm_loss, static_argnums=0)(
               jcfg, js.params, batch)),
           "features": np.asarray(jax.jit(JT.pooled_features,
                                          static_argnums=0)(
               jcfg, js.params, batch))}
    eng = JServeEngine(jcfg, js.params, **ENGINE)
    out["contiguous"] = streams(eng.run(requests(JRequest, jcfg.vocab)))
    out["report"] = eng.last_run_report
    if jcfg.sliding_window:
        eng = JServeEngine(jcfg, js.params, **ROLLING)
        out["rolling"] = streams(eng.run(requests(
            JRequest, jcfg.vocab, ROLLING_LENS)))
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
    jpolicy = covering_policy(jbb, JUnit, JPolicy)
    out["user_deltas"] = {u: rand_deltas(jbb, jpolicy, 3 + u)
                          for u in (0, 1)}
    return out, js.params


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """One JAX reference run a config, and the port's session on the
    bridged weights with its own adapt of the same task."""
    arch = request.param
    out, jparams = _jax_runs(arch)
    cfg = configs.get_reduced(arch)
    bb = lm_backbone(cfg, tokens_per_batch=32 * 16, batch_size=32)
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    session = api.TinyTrainSession(bb, params, max_way=5)
    task = api.sample_lm_task(np.random.default_rng(0), cfg.vocab, **TASK)
    port = {"adapt": session.adapt(task, api.JETSON_NANO, iters=ITERS)}
    return arch, out, session, task, port


def _batch(out):
    return {k: torch.from_numpy(v) for k, v in out["batch"].items()}


def test_lm_loss_and_pooled_features_match_reference(ref):
    """The loss carries the MoE aux (x 0.01) and, on deepseek, the MTP
    head's loss (x 0.1)."""
    _, out, session, _, _ = ref
    cfg, params = session.backbone.cfg, session.params
    loss = T.lm_loss(cfg, params, _batch(out))
    assert float(loss) == pytest.approx(out["loss"], rel=1e-5)
    feats = T.pooled_features(cfg, params, _batch(out))
    np.testing.assert_allclose(feats.numpy(), out["features"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("preset", ["smoke", "full"])
def test_unit_costs_taps_and_params_match_reference(arch, preset):
    """MLA heads are the ``attn`` unit, experts the ``moe`` unit, the
    dense head's MLP has ``dense_d_ff`` channels; the tap groups follow;
    the parameter tree (MTP head included) has the reference's shapes."""
    cfg = configs.preset_config(arch, preset)
    jcfg = jconfigs.preset_config(arch, preset)
    T.check_supported(cfg)
    bb = lm_backbone(cfg, 48 * 64, 48)
    jbb = jlm_backbone(jcfg, 48 * 64, 48)
    assert ([vars(c) for c in bb.unit_costs]
            == [vars(c) for c in jbb.unit_costs])
    assert "moe" in {c.kind for c in bb.unit_costs}
    shapes = {g: {k: tuple(v.shape) for k, v in grp.items()}
              for g, grp in bb.make_taps(5, "meta").items()}
    assert shapes == {g: {k: tuple(v.shape) for k, v in grp.items()}
                      for g, grp in jbb.make_taps(5).items()}
    if preset == "smoke":
        tp = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        jp = jax.eval_shape(lambda: JT.init_params(
            jcfg, jax.random.PRNGKey(0)))
        assert (jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                       bridge.tree_to_numpy(tp))
                == jax.tree_util.tree_map(lambda a: tuple(a.shape), jp))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("max_len,paging", [(24, None), (32, None),
                                            (48, None), (32, "fp"),
                                            (48, "int8")])
def test_cache_layouts_match_reference(arch, max_len, paging):
    """Latent (MLA) and K/V caches, contiguous and paged; a window below
    ``max_len`` holds ``window`` rows and stays contiguous under paging,
    at ``max_len == window`` it pages."""
    from repro.serving.paging import PagingSpec as JSpec

    from repro_torch.serving.paging import PagingSpec

    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    spec = jspec = None
    if paging:
        kw = dict(page_size=4, slots=2, int8=paging == "int8")
        spec, jspec = (PagingSpec.build(max_len, **kw),
                       JSpec.build(max_len, **kw))
    got = T.init_caches(cfg, 2, max_len, paging=spec, device="cpu")
    want = JT.init_caches(jcfg, 2, max_len, paging=jspec)
    assert (jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                   bridge.tree_to_numpy(got))
            == jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                      jax.tree_util.tree_map(np.asarray,
                                                             want)))


@pytest.mark.parametrize("mode", list(MODES))
def test_streams_match_reference(ref, mode):
    """Fused B8, fused B1 and the eager loop stream alike in every mode,
    with one host sync a chunk; contiguous streams, outcomes and ticks
    equal the JAX engine's, and paged and pressured (requeued) streams
    equal them too."""
    arch, out, session, _, _ = ref
    cfg = session.backbone.cfg
    kw = mode_kw(arch, mode)
    got = {}
    for name, extra in (("b8", {}), ("b1", dict(prefill_block=1)),
                        ("eager", dict(fused=False))):
        eng = ServeEngine(cfg, session.params, device="cpu", **kw, **extra)
        got[name] = streams(eng.run(requests(Request, cfg.vocab)))
        if name == "b8":
            rep = eng.last_run_report
            assert rep["host_syncs"] == rep["chunks"]
            if mode == "contiguous":
                jrep = out["report"]
                for key in ("chunks", "ticks", "new_tokens", "outcomes"):
                    assert rep[key] == jrep[key], key
            if mode == "pressured":
                assert rep["outcomes"].get("requeued", 0) >= 1
    assert got["b8"] == got["b1"] == got["eager"]
    assert all(o == "done" for _, o in got["b8"])
    if mode != "int8":
        assert got["b8"] == out["contiguous"]


def test_rolling_window_streams_match_reference(ref):
    """``tests/test_serve_scan.py``'s rolling case: prompts of 8, 30, 45
    and 70 tokens at max_len 80 against a 32-row window, so block writes
    wrap within a block; eager == fused B1 == fused B8 == the JAX
    engine."""
    arch, out, session, _, _ = ref
    if "rolling" not in out:
        pytest.skip(f"{arch} has no sliding window")
    cfg = session.backbone.cfg
    assert cfg.sliding_window == 32
    got = []
    for extra in ({}, dict(prefill_block=1), dict(fused=False)):
        eng = ServeEngine(cfg, session.params, device="cpu", **ROLLING,
                          **extra)
        got.append(streams(eng.run(requests(Request, cfg.vocab,
                                            ROLLING_LENS))))
        assert all(o == "done" for _, o in got[-1])
    assert eng.caches["g0"]["attn"]["k"].shape[2] == 32
    assert got[0] == got[1] == got[2] == out["rolling"]


@pytest.mark.parametrize("max_len", [24, 40])
def test_step_mask_changes_no_byte_of_the_cache(ref, max_len):
    """A decode step masked for one slot leaves that slot's K/V or latent
    rows and its length bit for bit (mixtral's 32-row cache rolls at
    max_len 40, after 36 tokens), and the other slots' logits are those
    of the unmasked call."""
    cfg, params = ref[2].backbone.cfg, ref[2].params
    rng = np.random.default_rng(5)
    caches = T.init_caches(cfg, 3, max_len, device="cpu")
    n = max_len - 4
    for t in range(n):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1)))
        T.decode_step(cfg, params, toks, caches, torch.full((3,), t))
    before = tree_map(lambda a: a.clone(), caches)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1)))
    pos = torch.full((3,), n)
    masked, _ = T.decode_step(cfg, params, toks, caches, pos,
                              torch.tensor([True, False, True]))
    for g, grp in before.items():
        for key, want in grp["attn"].items():
            assert torch.equal(caches[g]["attn"][key][:, 1], want[:, 1]), key
        assert (caches[g]["attn"]["len"][:, 0] == n + 1).all()
    full, _ = T.decode_step(cfg, params, toks, before, pos)
    assert torch.equal(masked[0], full[0]) and torch.equal(masked[2], full[2])


def test_probe_scores_match(ref):
    _, out, session, task, _ = ref
    t = {k: torch.from_numpy(v) for k, v in task.support.items()}
    pq = {k: torch.from_numpy(v) for k, v in task.pseudo_query.items()}
    taps = session.backbone.make_taps(len(task.support["episode_labels"]),
                                      "cpu")
    chans = session.step_cache.probe_fisher()(session.params, t, pq, taps,
                                              float(task.n_support))
    assert set(chans) == set(out["chans"])
    assert "moe" in {kind for _, kind in chans}
    for key, want in out["chans"].items():
        np.testing.assert_allclose(chans[key].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_policy_losses_deltas_and_folded_streams_match(ref):
    arch, out, session, _, port = ref
    got, want = port["adapt"], out["adapt"]
    assert units(got.policy) == units(want.policy)
    assert got.policy.horizon == want.policy.horizon and got.policy.units
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    trees_close(got.deltas, want.deltas, rtol=2e-3, atol=2e-4)
    assert got.memory_report() == want.memory_report()
    assert got.host_transfers == 2 and got.skipped_steps == 0
    cfg = session.backbone.cfg
    eng = ServeEngine(cfg, session.params, device="cpu", **ENGINE)
    got.fold_into(eng)
    assert streams(eng.run(requests(Request, cfg.vocab))) == out["streams"]


def test_fold_is_exact_on_reference_deltas(ref):
    """The reference's deltas of every unit kind the config has (MLA
    heads expand to qk_nope + qk_rope columns of w_uq and v_head_dim rows
    of wo; experts index the stacks' leading axis), folded by the port,
    give the reference's folded weights exactly."""
    _, out, session, _, _ = ref
    cfg = session.backbone.cfg
    jbb = jlm_backbone(jconfigs.get_reduced(ref[0]), 32, 2)
    policy = covering_policy(jbb, JUnit, JPolicy)
    jd = out["user_deltas"][0]
    jparams = jax.tree_util.tree_map(jax.numpy.asarray,
                                     bridge.tree_to_numpy(session.params))
    from repro.models.overlay import fold_deltas as jfold

    want = jfold(jbb.cfg, jparams, jd, policy)
    got = OV.fold_deltas(cfg, session.params,
                         bridge.tree_from_numpy(jd, device="cpu"), policy)
    trees_close(got, want, rtol=0, atol=0)


def test_personalised_streams_match_folded_copies(ref):
    """Two users' delta sets (the JAX package's, bridged) resident at once
    through the per-slot overlay (MLA's w_uq/wo per slot, a MoE unit's
    whole expert stack per slot through the per-row dispatch) stream, fused
    and eager, as each user's folded copy does (the JAX package's own
    acceptance test; ``test_fold_is_exact_on_reference_deltas`` holds the
    fold to the JAX package's)."""
    arch, out, session, _, _ = ref
    cfg = session.backbone.cfg
    policy = covering_policy(session.backbone, SelectedUnit,
                             SparseUpdatePolicy)
    assert {u.kind for u in policy.units} >= {"attn", "moe"}
    deltas = {u: bridge.tree_from_numpy(d, device="cpu")
              for u, d in out["user_deltas"].items()}
    got = {}
    for name, extra in (("b8", {}), ("eager", dict(fused=False))):
        eng = ServeEngine(cfg, session.params, personalise=policy,
                          device="cpu", **ENGINE, **extra)
        for u, d in deltas.items():
            eng.swap_deltas(u, DeltaSet.from_policy(policy, d))
        got[name] = streams(eng.run(requests(Request, cfg.vocab,
                                             uid=lambda i: i % 2)))
    assert got["b8"] == got["eager"]
    for u, d in deltas.items():
        folded = OV.fold_deltas(cfg, session.params, d, policy)
        solo = streams(ServeEngine(cfg, folded, device="cpu",
                                   **ENGINE).run(
            requests(Request, cfg.vocab, uid=lambda i: i % 2)))
        assert [s for i, s in enumerate(solo) if i % 2 == u] == \
            [s for i, s in enumerate(got["b8"]) if i % 2 == u]


@pytest.mark.parametrize("arch,flags", [
    ("mixtral-8x7b", ["--adapt", "--max-len", "48"]),
    ("deepseek-v3-671b", ["--adapt", "--paging", "--kv-int8"]),
    ("mixtral-8x7b", ["--preset", "100m", "--paging", "--max-new", "2"]),
])
def test_serve_launcher_runs_the_family(capsys, arch, flags):
    """``repro_torch.launch.serve --arch mixtral-8x7b|deepseek-v3-671b``
    on the CPU: adapt, fold and serve; paged and int8 pages; the 100m
    preset."""
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--preset", "smoke", "--device", "cpu",
                "--adapt-iters", "2", "--requests", "3", "--max-new", "3",
                "--slots", "2"] + flags)
    text = capsys.readouterr().out
    assert "done=3" in text
    if "--adapt" in flags:
        assert "adapted under jetson-nano" in text
        assert "host_transfers=2" in text
    if "--paging" in flags:
        assert "[serve] paged KV:" in text


def test_moe_family_is_admitted_and_later_families_raise():
    """Every family is admitted now: the moe family, the hybrid, and the
    encoder-decoder and VLM families of the later slice (whose caches
    build); an unknown family raises."""
    for arch in ARCHS + ("zamba2-1.2b", "whisper-base", "paligemma-3b"):
        T.check_supported(configs.get_reduced(arch))
    for arch in ("whisper-base", "paligemma-3b"):
        T.init_caches(configs.get_reduced(arch), 2, 16, device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        T.check_supported(dataclasses.replace(
            configs.get_reduced("qwen2-1.5b"), family="retnet"))
    rolled = dataclasses.replace(configs.get_reduced("qwen2-1.5b"),
                                 sliding_window=8)
    caches = T.init_caches(rolled, 2, 16, device="cpu")
    assert caches["g0"]["attn"]["k"].shape[2] == 8
