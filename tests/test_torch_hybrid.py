"""The port's hybrid family (zamba2) on the CPU against the JAX package's,
on zamba2-smoke (6 SSD layers, d_model 64, 8 SSD heads of 16, state 16,
one weight-shared attention + MLP block of 4 heads of 16 after every 3rd
layer, float32) with the JAX weights bridged across: ``lm_loss`` and
pooled features, tap gradients, deltas and their gradients under a plan
whose horizon stops the gradient below the shared block; unit costs,
taps, the parameter tree (its ``shared_attn`` subtree) and cache layouts
(one attention cache an application of the shared block, contiguous and
paged); the serving engine's greedy streams, outcomes and cache lengths,
fused B8 and B1 and the eager loop, against the JAX engine; block
prefill against token-by-token decode; TinyTrain's adaptation (probe
scores, policy, losses, deltas, folded streams); the fold; the shared
block's KV bytes in the engine's report; and the serve launcher."""
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
from repro_torch.serving import Request, ServeEngine
from repro_torch.utils import tree_map

ARCH = "zamba2-1.2b"
ITERS = 4
TASK = dict(seq=16, max_way=5, support_pad=32, query_pad=32)
ENGINE = dict(slots=3, max_len=24, chunk=4)
PROMPT_LENS = (3, 5, 8, 9, 17)
# a plan whose horizon (layer 3) sits just past the shared block after
# layer 2: layers 0-2 and that block run frozen, layers 4 and 5 train
HORIZON_UNITS = ((4, "ssm", (0, 3)), (5, "ssm", (1, 6)))


def units(policy):
    return [(u.layer, u.kind, u.channels) for u in policy.units]


def streams(reqs):
    return [(list(r.out), r.outcome) for r in reqs]


def requests(make, vocab, max_new=6):
    rng = np.random.default_rng(3)
    return [make(uid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                 max_new=max_new) for i, n in enumerate(PROMPT_LENS)]


def lens(caches):
    """The cache lengths by cache key, as numpy."""
    return {k: np.asarray(c["len"] if "len" in c else c["ssm"]["len"])
            for k, c in caches.items()}


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
    """The JAX package's runs, once per module: a token batch's loss,
    pooled features and tap gradients, a horizon plan's loss and delta
    gradients, the engine's contiguous streams and cache lengths, the
    probe's scores, one fused adapt and its folded engine's streams; plus
    the port's session on the bridged weights and its own adapt."""
    jcfg = jconfigs.get_reduced(ARCH)
    jbb = jlm_backbone(jcfg, tokens_per_batch=32 * 16, batch_size=32)
    js = japi.TinyTrainSession(jbb, max_way=5, seed=0)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab, (3, 32)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    toks[2, 20:] = -1  # a padded row: pooled features average 20 tokens
    batch = {"tokens": toks, "labels": labels}
    loss = jax.jit(JT.lm_loss, static_argnums=0)
    out = {"batch": batch, "loss": float(loss(jcfg, js.params, batch)),
           "features": np.asarray(jax.jit(JT.pooled_features,
                                          static_argnums=0)(
               jcfg, js.params, batch))}
    out["tap_grads"] = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(
        lambda taps: JT.lm_loss(jcfg, js.params, batch, taps=taps)))(
        jbb.make_taps(3)))
    plan = JPolicy(horizon=3, units=tuple(JUnit(*u) for u in HORIZON_UNITS))
    dl = jbb.init_deltas(plan)
    leaves, treedef = jax.tree_util.tree_flatten(dl)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    deltas = jax.tree_util.tree_unflatten(treedef, [
        np.asarray(jax.random.normal(k, x.shape, x.dtype) * 0.05)
        for k, x in zip(keys, leaves)])
    out["plan"], out["deltas"] = plan, deltas
    val, grads = jax.jit(jax.value_and_grad(
        lambda d: JT.lm_loss(jcfg, js.params, batch, deltas=d, plan=plan)))(
        deltas)
    out["plan_loss"] = float(val)
    out["delta_grads"] = jax.tree_util.tree_map(np.asarray, grads)
    eng = JServeEngine(jcfg, js.params, **ENGINE)
    out["contiguous"] = streams(eng.run(requests(JRequest, jcfg.vocab)))
    out["report"] = eng.last_run_report
    # one chunk in: every slot still live (the JAX decode advances an idle
    # slot's lengths, the port's step mask does not)
    eng = JServeEngine(jcfg, js.params, **ENGINE)
    eng.run(requests(JRequest, jcfg.vocab), max_ticks=ENGINE["chunk"])
    out["lens"] = lens(eng.caches)
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


def test_lm_loss_pooled_features_and_tap_gradients_match_reference(ref):
    """The shared block runs after layers 2 and 5 in the plain and the
    probe forward; it has no tap, so the one tap group is the SSD
    heads'."""
    out, session, _, _ = ref
    cfg, params = session.backbone.cfg, session.params
    loss = T.lm_loss(cfg, params, _batch(out))
    assert float(loss) == pytest.approx(out["loss"], rel=1e-5)
    feats = T.pooled_features(cfg, params, _batch(out))
    np.testing.assert_allclose(feats.numpy(), out["features"], rtol=1e-5,
                               atol=1e-5)
    taps = tree_map(lambda t: t.requires_grad_(),
                    session.backbone.make_taps(3, "cpu"))
    assert list(taps) == ["g0"] and list(taps["g0"]) == ["mixer"]
    grads = torch.autograd.grad(T.lm_loss(cfg, params, _batch(out),
                                          taps=taps),
                                [taps["g0"]["mixer"]])
    want = out["tap_grads"]["g0"]["mixer"]
    np.testing.assert_allclose(grads[0].numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_deltas_under_a_horizon_plan_match_reference(ref):
    """Deltas on layers 4 and 5 under a plan whose horizon (3) freezes
    layers 0-2 and the shared block after layer 2: the loss and every
    delta's gradient equal the JAX package's (which stop-gradients the
    segment below the horizon)."""
    out, session, _, _ = ref
    cfg, params = session.backbone.cfg, session.params
    plan = SparseUpdatePolicy(horizon=3, units=tuple(
        SelectedUnit(*u) for u in HORIZON_UNITS))
    deltas = tree_map(lambda t: t.requires_grad_(),
                      bridge.tree_from_numpy(out["deltas"], device="cpu"))
    loss = T.lm_loss(cfg, params, _batch(out), deltas=deltas, plan=plan)
    assert loss.item() == pytest.approx(out["plan_loss"], rel=1e-5)
    leaves = [t for k in sorted(deltas) for kind in sorted(deltas[k])
              for _, t in sorted(deltas[k][kind].items())]
    grads = torch.autograd.grad(loss, leaves)
    got = {}
    i = 0
    for k in sorted(deltas):
        for kind in sorted(deltas[k]):
            for name, _ in sorted(deltas[k][kind].items()):
                got.setdefault(k, {}).setdefault(kind, {})[name] = grads[i]
                i += 1
    trees_close(got, out["delta_grads"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("preset", ["smoke", "full"])
def test_unit_costs_taps_and_params_match_reference(preset):
    """Every layer is an SSD unit (the shared block is not selectable);
    one tap group; the parameter tree has the reference's shapes, with
    the unstacked ``shared_attn`` block."""
    cfg = configs.preset_config(ARCH, preset)
    jcfg = jconfigs.preset_config(ARCH, preset)
    T.check_supported(cfg)
    bb = lm_backbone(cfg, 48 * 64, 48)
    jbb = jlm_backbone(jcfg, 48 * 64, 48)
    assert ([vars(c) for c in bb.unit_costs]
            == [vars(c) for c in jbb.unit_costs])
    assert {c.kind for c in bb.unit_costs} == {"ssm"}
    shapes = {g: {k: tuple(v.shape) for k, v in grp.items()}
              for g, grp in bb.make_taps(5, "meta").items()}
    assert shapes == {g: {k: tuple(v.shape) for k, v in grp.items()}
                      for g, grp in jbb.make_taps(5).items()}
    if preset == "full":
        assert shapes == {"g0": {"mixer": (38, 5, 64)}}
        return
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    assert (jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                   bridge.tree_to_numpy(tp))
            == jax.tree_util.tree_map(lambda a: (tuple(a.shape),
                                                 str(a.dtype)), jp))
    assert set(tp["shared_attn"]) == {"norm1", "attn", "norm2", "mlp"}


@pytest.mark.parametrize("paging", [None, "fp", "int8"])
def test_cache_layouts_match_reference(paging):
    """One unstacked attention cache an application of the shared block
    (``shared2``, ``shared5``), paged under paging with the SSD state
    contiguous; every paged cache views the one page table."""
    from repro.serving.paging import PagingSpec as JSpec

    from repro_torch.serving.paging import PagingSpec

    cfg, jcfg = configs.get_reduced(ARCH), jconfigs.get_reduced(ARCH)
    spec = jspec = None
    if paging:
        kw = dict(page_size=4, slots=2, int8=paging == "int8")
        spec, jspec = PagingSpec.build(24, **kw), JSpec.build(24, **kw)
    got = T.init_caches(cfg, 2, 24, paging=spec, device="cpu")
    want = JT.init_caches(jcfg, 2, 24, paging=jspec)
    assert (jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                   bridge.tree_to_numpy(got))
            == jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                      jax.tree_util.tree_map(np.asarray,
                                                             want)))
    assert sorted(k for k in got if k.startswith("shared")) == [
        "shared2", "shared5"]
    if paging:
        assert got["shared2"]["page_table"] is got["shared5"]["page_table"]


@pytest.mark.parametrize("mode", ["b8", "b1", "eager"])
def test_streams_outcomes_and_cache_lengths_match_reference(ref, mode):
    out, session, _, _ = ref
    cfg = session.backbone.cfg
    extra = {"b8": {}, "b1": dict(prefill_block=1),
             "eager": dict(fused=False)}[mode]
    eng = ServeEngine(cfg, session.params, device="cpu", **ENGINE, **extra)
    got = streams(eng.run(requests(Request, cfg.vocab)))
    assert got == out["contiguous"]
    assert all(o == "done" for _, o in got)
    rep, jrep = eng.last_run_report, out["report"]
    if mode == "b8":
        assert rep["host_syncs"] == rep["chunks"]
        for key in ("chunks", "ticks", "new_tokens", "outcomes"):
            assert rep[key] == jrep[key], key
        eng = ServeEngine(cfg, session.params, device="cpu", **ENGINE)
        eng.run(requests(Request, cfg.vocab), max_ticks=ENGINE["chunk"])
        got_lens = lens(eng.caches)
        assert set(got_lens) == set(out["lens"])
        for k, v in got_lens.items():
            np.testing.assert_array_equal(v, out["lens"][k], err_msg=k)
    assert rep["memory"]["kv_cache_bytes"] == jrep["memory"]["kv_cache_bytes"]


def test_block_prefill_equals_token_decode(ref):
    """A prompt fed as one block and the same prompt fed token by token
    leave the same cache lengths, SSD state and shared-block K/V and give
    the same last logits, to 1e-5 in f32 (the shared block's products run
    over 7 rows against 1, so the last bits may differ; mamba2's
    recurrence alone is bit for bit, ``tests/test_torch_ssm.py``)."""
    _, session, _, _ = ref
    cfg, params = session.backbone.cfg, session.params
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 7)))
    valid = torch.ones((2, 7), dtype=torch.bool)
    valid[1, 5:] = False  # a ragged tail
    block = T.init_caches(cfg, 2, 16, device="cpu")
    logits, _ = T.prefill_block(cfg, params, toks, block, torch.zeros(2),
                                valid)
    step = T.init_caches(cfg, 2, 16, device="cpu")
    last = {}
    for t in range(7):
        lg, _ = T.decode_step(cfg, params, toks[:, t:t + 1], step,
                              torch.full((2,), t), valid[:, t])
        for b in range(2):
            if valid[b, t]:
                last[b] = lg[b, 0]

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)

    close(logits[0, 6], last[0])
    close(logits[1, 4], last[1])
    for key in ("shared2", "shared5"):
        assert torch.equal(block[key]["len"], step[key]["len"])
        for b, n in ((0, 7), (1, 5)):
            for kv in ("k", "v"):
                close(block[key][kv][b, :n], step[key][kv][b, :n])
    assert torch.equal(block["g0"]["ssm"]["len"], step["g0"]["ssm"]["len"])
    for name in ("conv", "ssm"):
        close(block["g0"]["ssm"][name], step["g0"]["ssm"][name])


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
        np.testing.assert_allclose(chans[key].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_policy_losses_deltas_and_folded_streams_match(ref):
    out, session, _, port = ref
    got, want = port["adapt"], out["adapt"]
    assert units(got.policy) == units(want.policy)
    assert got.policy.horizon == want.policy.horizon and got.policy.units
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5, atol=1e-5)
    trees_close(got.deltas, want.deltas, rtol=2e-3, atol=2e-4)
    assert got.memory_report() == want.memory_report()
    assert got.host_transfers == 2 and got.skipped_steps == 0
    cfg = session.backbone.cfg
    eng = ServeEngine(cfg, session.params, device="cpu", **ENGINE)
    got.fold_into(eng)
    assert streams(eng.run(requests(Request, cfg.vocab))) == out["streams"]


def test_fold_is_exact_on_reference_deltas(ref):
    """The reference's deltas, folded by the port, give the reference's
    folded weights exactly; the shared block is untouched."""
    out, session, _, _ = ref
    jad = out["adapt"]
    want = jad.fold_into(jax.tree_util.tree_map(
        jax.numpy.asarray, bridge.tree_to_numpy(session.params)))
    got = OV.fold_deltas(session.backbone.cfg, session.params,
                         bridge.tree_from_numpy(jax.tree_util.tree_map(
                             np.asarray, jad.deltas), device="cpu"),
                         jad.policy)
    trees_close(got, want, rtol=0, atol=0)
    assert got["shared_attn"] is session.params["shared_attn"]


@pytest.mark.parametrize("paging", [False, True])
def test_report_counts_the_shared_block_kv(ref, paging):
    """A slot's shared-block KV is applications x 2 x Hkv x Dh x bytes x
    max_len (zamba2-1.2b: 6 x 2 x 32 x 64 x 2 B = 49,152 B a token), the
    paged report's worst-case stream; the SSD state is reported apart."""
    _, session, _, _ = ref
    cfg = session.backbone.cfg
    kw = dict(kv_paging=True, kv_page_size=4) if paging else {}
    eng = ServeEngine(cfg, session.params, device="cpu", **ENGINE, **kw)
    mem = eng.memory_report()
    per_token = 2 * 2 * cfg.n_kv_heads * cfg.head_dim * 4
    state = (cfg.n_layers * ((cfg.d_conv - 1) * (cfg.d_inner
                                                 + 2 * cfg.ssm_state)
                             + cfg.n_ssm_heads * cfg.ssm_head_dim
                             * cfg.ssm_state) * 4)
    assert eng.ssm_state_bytes_per_slot == state
    if paging:
        assert mem["kv_bytes_per_stream"] == per_token * 24
        assert mem["page_bytes"] == per_token * 4
    else:
        len_bytes = 4 * ENGINE["slots"] * (cfg.n_layers + 2)
        assert mem["kv_cache_bytes"] == (
            ENGINE["slots"] * (per_token * 24 + state) + len_bytes)


@pytest.mark.parametrize("flags", [["--adapt"],
                                   ["--paging", "--kv-int8"],
                                   ["--pressure", "0.5", "--adapt"]])
def test_serve_launcher_runs_zamba2(capsys, flags):
    """``repro_torch.launch.serve --arch zamba2-1.2b`` on the CPU: adapt,
    fold and serve; int8 pages; half the pages with requeues."""
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--preset", "smoke", "--device", "cpu",
                "--adapt-iters", "2", "--requests", "4", "--max-new", "3",
                "--slots", "2", "--max-len", "48"] + flags)
    text = capsys.readouterr().out
    assert "done=4" in text
    assert "SSD state (conv windows and states, never paged)" in text
    if "--adapt" in flags:
        assert "adapted under jetson-nano" in text and ".ssm[" in text
    if "--paging" in flags or "--pressure" in flags:
        assert "[serve] paged KV:" in text
