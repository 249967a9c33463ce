"""The port's baselines and static criteria on the CPU against the JAX
package's, on tiny-cnn at in_res 36 (odd activation sizes 9 and 5 inside,
so TinyTL's "SAME" pooling pads and its nearest resize is not a plain
doubling) with the port's seeded weights, and TinyTL's adapters, bridged
across and the same episode from the same seed: fulltrain, lastlayer, tinytl and
adapterdrop50 losses (1e-5 a step), the ES policy from the same
potentials, the sparseupdate, random and l2norm policies, ``none`` as the
zero-shot accuracy, ``weight_l2`` (tiny-cnn and qwen2-smoke, 1e-12
relative), ``tinytl_features`` (1e-5), the optimisers, the reference's
errors, and the frozen params bit for bit after ``fulltrain``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.core import baselines as jbl
from repro.core import lm_backbone as jlm_backbone
from repro.optim import optimizers as jopt
from repro_torch import api, bridge, configs
from repro_torch.core import baselines as bl
from repro_torch.core.backbones import lm_backbone
from repro_torch.optim import optimizers as opt

ITERS = 3
RES = 36
TASK = dict(res=RES, max_way=4, min_way=2, support_pad=16, query_pad=16,
            max_support_total=12, max_support_per_class=4, query_per_class=4)
BASELINES = ("fulltrain", "lastlayer", "tinytl", "adapterdrop50")
CRITERIA = ("random", "l2norm")


def units(policy):
    return [(u.layer, u.kind, tuple(int(c) for c in u.channels))
            for u in policy.units]


def jax_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def jax_tinytl(jbb, js, jtask, adapters, name):
    """The JAX package's TinyTL fine-tune (its ``_tinytl`` body) from the
    given adapters: (losses, trained adapters)."""
    dropped = 0 if name == "tinytl" else int(
        (max(s.block for s in jbb.cfg.layers) + 1) * 0.5)
    run = jbl.make_tinytl_episode_scan(jbb.cfg, js.baseline_optimizer, 4,
                                       dropped, ITERS)
    a, _, losses, _ = run(js.params, adapters,
                          js.baseline_optimizer.init(adapters),
                          jtask.support, jtask.pseudo_query)
    return [float(x) for x in np.asarray(losses)], a


@pytest.fixture(scope="module")
def ref():
    """The port's runs of every method on its own seeded weights, and the
    JAX package's on the same weights bridged across, once per module.
    TinyTL starts both from the adapters the port's session draws for seed
    0 (a host generator), carried across HWIO."""
    bb = api.backbone("tiny-cnn", in_res=RES, batch_size=16)
    session = api.TinyTrainSession(bb, max_way=4, seed=0, device="cpu")
    params = session.params
    before = [{k: v.clone() for k, v in p.items()} for p in params]
    task = api.sample_task(np.random.default_rng(0), "glyphs", **TASK)
    proxy = api.sample_task(np.random.default_rng(5), "gratings", **TASK)
    port = {"zero_shot": session.evaluate(task)}
    for name in BASELINES + CRITERIA:
        port[name] = session.baseline(name, task, api.RPI_ZERO, iters=ITERS,
                                      seed=0)
    port["sparseupdate"] = session.baseline("sparseupdate", task,
                                            api.RPI_ZERO, iters=ITERS,
                                            proxy_task=proxy)
    port["none"] = session.baseline("none", task, api.RPI_ZERO)

    jbb = japi.backbone("tiny-cnn", in_res=RES, batch_size=16)
    js = japi.TinyTrainSession(
        jbb, to_jax(bridge.cnn_tree_to_numpy(params)), max_way=4)
    jtask = japi.sample_task(np.random.default_rng(0), "glyphs", **TASK)
    out = {"zero_shot": js.evaluate(jtask)}
    for name in ("fulltrain", "lastlayer") + CRITERIA:
        a = js.baseline(name, jtask, japi.RPI_ZERO, iters=ITERS, seed=0)
        out[name] = dict(losses=a.losses, policy=a.policy, deltas=a.deltas,
                         host_transfers=a.host_transfers,
                         skipped_steps=a.skipped_steps)
    adapters = bridge.cnn_tree_to_numpy(bl.tinytl_adapter_init(
        bb.cfg, torch.Generator().manual_seed(0)))
    for name in ("tinytl", "adapterdrop50"):
        # the scan donates its adapters: a fresh copy each
        losses, a = jax_tinytl(jbb, js, jtask, to_jax(adapters), name)
        out[name] = dict(losses=losses, policy=None, deltas=a,
                         host_transfers=1, skipped_steps=0)
    return dict(out=out, port=port, session=session, task=task, jbb=jbb,
                js=js, jtask=jtask, before=before, proxy=proxy)


@pytest.mark.parametrize("name", BASELINES + CRITERIA)
def test_losses_match_reference(ref, name):
    got, want = ref["port"][name], ref["out"][name]
    assert got.method == name
    assert len(got.losses) == ITERS and np.isfinite(got.losses).all()
    np.testing.assert_allclose(got.losses, want["losses"], rtol=1e-5,
                               atol=1e-5)
    assert got.skipped_steps == want["skipped_steps"] == 0
    assert got.host_transfers == want["host_transfers"]


@pytest.mark.parametrize("name", CRITERIA + ("lastlayer",))
def test_policies_match_reference(ref, name):
    got, want = ref["port"][name], ref["out"][name]["policy"]
    assert units(got.policy) == units(want)
    assert got.policy.horizon == want.horizon
    assert got.policy.n_units >= 1


def test_sparseupdate_policy_is_the_es_of_the_proxy_probe(ref):
    """The offline ES runs on the proxy task's Fisher potentials (its
    arithmetic against the JAX package's in the next test) and the target's
    fine-tune runs under it."""
    from repro_torch.core.fisher import fisher_probe
    from repro_torch.core.protonet import episode_loss

    session, proxy = ref["session"], ref["proxy"]
    got = ref["port"]["sparseupdate"]
    sup = {k: torch.from_numpy(v) for k, v in proxy.support.items()}
    pq = {k: torch.from_numpy(v) for k, v in proxy.pseudo_query.items()}
    bb = session.backbone
    pot, _, _ = fisher_probe(
        bb, session.params, lambda p, b, taps=None: episode_loss(
            bb.features, p, sup, pq, 4, taps=taps), sup, proxy.n_support)
    want = bl.evolutionary_search_policy(bb.unit_costs, pot,
                                         api.RPI_ZERO.budget(), iters=400,
                                         seed=0)
    assert units(got.policy) == units(want) and got.policy.n_units >= 1
    assert got.method == "sparseupdate" and np.isfinite(got.losses).all()
    assert len(got.losses) == ITERS


def test_trained_trees_match_reference(ref):
    """fulltrain's whole backbone and TinyTL's adapters after the steps."""
    for name, conv in (("fulltrain", bridge.cnn_tree_to_numpy),
                       ("tinytl", bridge.cnn_tree_to_numpy)):
        got = conv(ref["port"][name].deltas)
        want = jax_numpy(ref["out"][name]["deltas"])
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_none_is_zero_shot(ref):
    port, out = ref["port"], ref["out"]
    none = port["none"]
    assert none.policy is None and none.losses == []
    assert none.accuracy() == port["zero_shot"]
    assert port["zero_shot"] == pytest.approx(out["zero_shot"], abs=1e-6)


def test_fulltrain_leaves_the_frozen_params(ref):
    session = ref["session"]
    for p, q in zip(session.params, ref["before"]):
        for k in p:
            assert torch.equal(p[k], q[k])
    assert ref["port"]["fulltrain"].deltas is not session.params


def test_eager_baselines_equal_fused(ref):
    session, task = ref["session"], ref["task"]
    for name in ("fulltrain", "tinytl"):
        fused = session.baseline(name, task, api.RPI_ZERO, iters=2)
        eager = session.baseline(name, task, api.RPI_ZERO, iters=2,
                                 fused=False)
        assert eager.losses == fused.losses
        assert eager.host_transfers == 2 and fused.host_transfers == 1


def test_es_policy_from_the_same_potentials(ref):
    costs = ref["session"].backbone.unit_costs
    jcosts = ref["jbb"].unit_costs
    pot = np.random.default_rng(3).random(len(costs))
    for budget in (api.RPI_ZERO.budget(), api.JETSON_NANO.budget()):
        jb = japi.RPI_ZERO.budget() if budget == api.RPI_ZERO.budget() \
            else japi.JETSON_NANO.budget()
        got = bl.evolutionary_search_policy(costs, pot, budget, iters=200,
                                            seed=1)
        want = jbl.evolutionary_search_policy(jcosts, pot, jb, iters=200,
                                              seed=1)
        assert units(got) == units(want) and got.horizon == want.horizon
        assert got.meta == want.meta


def test_tinytl_features_at_odd_sizes(ref):
    """The frozen backbone with the lite residuals of blocks 1 on, at in_res
    21 (activations 11, 6 and 3; the fixture's losses cover in_res 36),
    from adapters in the JAX package's layout (HWIO, the shapes of its
    ``tinytl_adapter_init``) carried across the bridge."""
    jbb, cfg = ref["jbb"], ref["session"].backbone.cfg
    rng = np.random.default_rng(7)
    jad = jax.tree_util.tree_map(
        lambda sd: (0.3 * rng.standard_normal(sd.shape)).astype(np.float32),
        jax.eval_shape(lambda k: jbl.tinytl_adapter_init(jbb.cfg, k),
                       jax.random.PRNGKey(0)))
    adapters = bridge.tinytl_adapters_from_numpy(cfg, jad, device="cpu")
    feats = jax.jit(lambda p, a, x: jbl.tinytl_features(
        jbb.cfg, p, a, x, dropped_blocks=1))
    for res in (21,):
        imgs = np.random.default_rng(res).standard_normal(
            (3, res, res, 3)).astype(np.float32)
        want = np.asarray(feats(ref["js"].params, to_jax(jad),
                                jnp.asarray(imgs)))
        got = bl.tinytl_features(cfg, ref["session"].params, adapters,
                                 torch.from_numpy(imgs),
                                 dropped_blocks=1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("size", (5, 7, 11, 21))
def test_tinytl_pool_and_resize(size):
    x = np.random.default_rng(size).standard_normal(
        (2, size, size + 2, 3)).astype(np.float32)
    pooled = jax.lax.reduce_window(jnp.asarray(x), 0.0, jax.lax.add,
                                   (1, 2, 2, 1), (1, 2, 2, 1), "SAME") / 4.0
    up = jax.image.resize(pooled, (2, size, size + 2, 3), "nearest")
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = bl._pool_same(t)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(pooled), rtol=0, atol=1e-6)
    got_up = torch.nn.functional.interpolate(got, size=(size, size + 2),
                                             mode="nearest-exact")
    # jax.image.resize computes its nearest resize as a product with a 0/1
    # matrix (1.2e-7 apart); mode "nearest" would miss by whole values
    np.testing.assert_allclose(got_up.permute(0, 2, 3, 1).numpy(),
                               np.asarray(up), rtol=0, atol=1e-6)


def test_weight_l2_matches_reference(ref):
    jl2 = ref["jbb"].weight_l2(ref["js"].params)
    got = ref["session"].backbone.weight_l2(ref["session"].params)
    assert set(got) == set(jl2)
    for k, w in jl2.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-12, atol=0)
    jcfg = jconfigs.get_reduced("qwen2-1.5b")
    jlm = jlm_backbone(jcfg, tokens_per_batch=64, batch_size=4)
    cfg = configs.get_reduced("qwen2-1.5b")
    lm = lm_backbone(cfg, tokens_per_batch=64, batch_size=4)
    p = lm.init(torch.Generator().manual_seed(2))
    jl2, got = jlm.weight_l2(bridge.tree_to_numpy(p)), lm.weight_l2(p)
    assert set(got) == set(jl2) and {k for _, k in got} == {"attn", "mlp"}
    for k, w in jl2.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-12, atol=0)
    # the reference's errors: TinyTL is CNN-only
    session = api.TinyTrainSession(lm, p, max_way=5)
    task = api.sample_lm_task(np.random.default_rng(0), cfg.vocab, seq=16,
                              max_way=5, support_pad=16, query_pad=16)
    with pytest.raises(ValueError, match="CNN-only"):
        session.baseline("tinytl", task, api.JETSON_NANO, iters=1)


def test_reference_errors(ref):
    session, task = ref["session"], ref["task"]
    with pytest.raises(KeyError, match="unknown baseline"):
        session.baseline("bogus", task, api.RPI_ZERO)
    with pytest.raises(ValueError, match="proxy_task"):
        session.baseline("sparseupdate", task, api.RPI_ZERO)
    with pytest.raises(KeyError, match="unknown criterion"):
        session.adapt(task, api.RPI_ZERO, criterion="bogus")


def test_register_criterion():
    api.register_criterion("l2_fisher_only", "fisher_only", "l2norm")
    try:
        assert "l2_fisher_only" in api.criteria()
    finally:
        from repro_torch.core import session as S

        del S._CRITERIA["l2_fisher_only"]


def _tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal((3, 4)).astype(dtype),
            "b": [rng.standard_normal((5,)).astype(dtype)]}


@pytest.mark.parametrize("which", ("sgd", "momentum", "clip_sgd",
                                   "clip_adam", "sgd_schedule"))
def test_optimizers_match_reference(which):
    """Three updates of each optimiser on the same trees."""
    mk = {
        "sgd": lambda m: m.sgd(0.1),
        "momentum": lambda m: m.momentum(0.05, beta=0.8),
        "clip_sgd": lambda m: m.clip_by_global_norm(m.sgd(0.1), 0.5),
        "clip_adam": lambda m: m.clip_by_global_norm(m.adam(1e-2), 2.0),
        "sgd_schedule": lambda m: m.sgd(lambda step: 0.1 / step),
    }[which]
    rng = np.random.default_rng(0)
    p = _tree(rng)
    jo, to = mk(jopt), mk(opt)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = bridge.tree_from_numpy(p, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    assert to.slots == jo.slots
    for _ in range(3):
        g = _tree(rng)
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = to.update(bridge.tree_from_numpy(g, device="cpu"), ts, tp)
        jp = jopt.apply_updates(jp, ju)
        tp = opt.apply_updates(tp, tu)
    for a, b in zip(jax.tree_util.tree_leaves(bridge.tree_to_numpy(tp)),
                    jax.tree_util.tree_leaves(jax_numpy(jp))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 3
