"""The port's edge-CNN slice below the session, on the CPU against the JAX
package: the vision episodes and the resumable loaders from the same
seeds, the configs and their analytical costs, the bridge's HWIO <-> OIHW
round trips, ``cnn_features`` (plain, with channel deltas, with Fisher
taps and their gradients, under a backprop horizon) and
``cnn_fold_deltas`` on the JAX weights bridged across, the masked Eq. 2
reduction, and ``leaf_taps`` on ragged per-layer taps.  Features are held
to 1e-5 of max |want| (float32); tiny-cnn at in_res 16 and mcunet at
in_res 32 cover depthwise, stride-2 and residual layers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backbones import cnn_backbone as jcnn_backbone
from repro.core.policy import SelectedUnit as JUnit
from repro.core.policy import SparseUpdatePolicy as JPolicy
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsyn
from repro.models import edge_cnn as JE
from repro_torch import bridge, configs
from repro_torch.core.backbones import cnn_backbone
from repro_torch.core.fisher import leaf_taps, tap_grads
from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
from repro_torch.data import pipeline
from repro_torch.data import synthetic as syn
from repro_torch.models import edge_cnn as E

TOL = 1e-5  # float32, relative to max |want|
BATCH = 4
# (name, builder, in_res)
NETS = [("tiny-cnn", "tiny_cnn", 16), ("mcunet", "mcunet_5fps", 32)]
BUILDERS = {"tiny-cnn": "tiny_cnn", "mcunet": "mcunet_5fps",
            "mobilenetv2": "mobilenetv2_035", "proxylessnas": "proxylessnas_03"}
# (layer, channels): the stride-2 stem conv, a stride-2 depthwise layer,
# a stride-1 depthwise layer inside a residual block and the projection
# conv that adds the block input back
UNITS = ((0, (0, 3, 5)), (4, (1, 2, 7, 11)), (7, (0, 9)), (8, (1, 4, 6)))


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def policies(horizon=0):
    units = [(l, c) for l, c in UNITS if l >= horizon]
    return (SparseUpdatePolicy(horizon, tuple(SelectedUnit(l, "conv", c)
                                              for l, c in units)),
            JPolicy(horizon, tuple(JUnit(l, "conv", c) for l, c in units)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def nets():
    """Per net: both configs, the JAX weights (numpy, HWIO) and the port's
    (bridged), random deltas for UNITS in both layouts, images and taps."""
    out = {}
    for name, builder, res in NETS:
        jcfg = getattr(JE, builder)(in_res=res)
        cfg = getattr(E, builder)(in_res=res)
        rng = np.random.default_rng(5)
        # the reference init's shapes and scales, drawn with numpy (no
        # compile); biases nonzero so the fold and the bridge see them
        jparams = [{"w": (rng.standard_normal(p["w"].shape) / np.sqrt(
                       np.prod(p["w"].shape[:3]))).astype(np.float32),
                    "b": (0.1 * rng.standard_normal(p["b"].shape)).astype(
                        np.float32)}
                   for p in jax.eval_shape(lambda c=jcfg: JE.cnn_init(
                       c, jax.random.PRNGKey(0)))]
        jdeltas = {}
        for layer, chans in UNITS:
            spec = jcfg.layers[layer]
            c_in = 1 if spec.kind == "dw" else spec.c_in
            jdeltas[f"L{layer}"] = {"conv": {"w": (0.5 * rng.standard_normal(
                (spec.k, spec.k, c_in, len(chans)))).astype(np.float32)}}
        images = rng.standard_normal((BATCH, res, res, 3)).astype(np.float32)
        taps = [rng.uniform(0.5, 1.5, (BATCH, s.c_out)).astype(np.float32)
                for s in jcfg.layers]
        out[name] = dict(
            jcfg=jcfg, cfg=cfg, jparams=jparams, jdeltas=jdeltas,
            params=bridge.params_from_numpy(cfg, jparams, device="cpu"),
            deltas=bridge.cnn_tree_from_numpy(jdeltas, device="cpu"),
            images=images, taps=taps)
    return out


# -- data --------------------------------------------------------------------


@pytest.mark.parametrize("domain", syn.DOMAINS)
def test_vision_episodes_identical_from_one_seed(domain):
    assert syn.DOMAINS == jsyn.DOMAINS
    kw = dict(res=16, max_way=6, support_pad=64, query_pad=64)
    a = syn.sample_episode(np.random.default_rng(4), domain, **kw)
    b = jsyn.sample_episode(np.random.default_rng(4), domain, **kw)
    assert (a.n_way, a.domain) == (b.n_way, b.domain)
    for got, want in ((a.support, b.support), (a.query, b.query)):
        assert set(got) == set(want) == {"images", "episode_labels"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    aug_a = syn.augment_support(np.random.default_rng(9), a.support)
    aug_b = jsyn.augment_support(np.random.default_rng(9), b.support)
    for k in aug_b:
        np.testing.assert_array_equal(aug_a[k], aug_b[k])


@pytest.mark.parametrize("kind", ["image", "lm"])
def test_episode_stream_identical_and_resumable(kind):
    kw = dict(seed=2, res=16, max_way=5, support_pad=48, query_pad=48,
              kind=kind, vocab=200, seq=8)
    port = pipeline.EpisodeStream("waves", **kw)
    ref = jpipeline.EpisodeStream("waves", **kw)
    eps = [port.next() for _ in range(3)]
    for ep in eps:
        want = ref.next()
        for k in want.support:
            np.testing.assert_array_equal(ep.support[k], want.support[k])
            np.testing.assert_array_equal(ep.query[k], want.query[k])
    again = pipeline.EpisodeStream("waves", **kw)
    again.load_state_dict({"cursor": 1, "seed": 2})
    assert port.state_dict() == ref.state_dict() == {"cursor": 3, "seed": 2}
    for k, v in again.next().support.items():
        np.testing.assert_array_equal(v, eps[1].support[k])


def test_token_loader_identical_and_resumable():
    port = pipeline.TokenLoader(300, 8, 12, seed=1, host_id=1, n_hosts=2)
    ref = jpipeline.TokenLoader(300, 8, 12, seed=1, host_id=1, n_hosts=2)
    first = [port.next() for _ in range(2)]
    for got in first:
        want = ref.next()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
    assert first[0]["tokens"].shape == (4, 12)
    back = pipeline.TokenLoader(300, 8, 12, seed=0, host_id=1, n_hosts=2)
    back.load_state_dict({"step": 1, "seed": 1})
    np.testing.assert_array_equal(back.next()["tokens"], first[1]["tokens"])


# -- configs, costs, bridge -------------------------------------------------------


@pytest.mark.parametrize("name", list(BUILDERS))
def test_configs_and_layer_costs_identical(name):
    """The same layers, analytical costs and unit costs (at the builder's
    own resolution and at 32), and ``configs.get_cnn`` gives the paper
    backbones at their builders' resolution."""
    for kw in ({}, {"in_res": 32}):
        cfg = getattr(E, BUILDERS[name])(**kw)
        jcfg = getattr(JE, BUILDERS[name])(**kw)
        assert (cfg.name, cfg.in_res, cfg.feat_dim) == (
            jcfg.name, jcfg.in_res, jcfg.feat_dim)
        assert [dataclasses.astuple(s) for s in cfg.layers] == \
            [dataclasses.astuple(s) for s in jcfg.layers]
        assert E.cnn_layer_costs(cfg) == JE.cnn_layer_costs(jcfg)
        assert E.cnn_total_costs(cfg) == JE.cnn_total_costs(jcfg)
        assert [vars(c) for c in cnn_backbone(cfg, 64).unit_costs] == \
            [vars(c) for c in jcnn_backbone(jcfg, 64).unit_costs]
    if name != "tiny-cnn":
        assert configs.get_cnn(name) == getattr(E, BUILDERS[name])()
        assert configs.get_cnn(name).in_res == 84


def test_bridge_round_trips(nets):
    """Params, delta packs and an Adam state over them cross HWIO -> OIHW
    and back unchanged; a depthwise (k, k, 1, C) weight becomes (C, 1, k,
    k), and the port's init draws the same shapes."""
    n = nets["tiny-cnn"]
    cfg, jparams, jdeltas = n["cfg"], n["jparams"], n["jdeltas"]
    for port, ref in ((n["params"], jparams), (n["deltas"], jdeltas)):
        back = bridge.cnn_tree_to_numpy(port)
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(ref)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a, b)
    spec = cfg.layers[4]
    assert spec.kind == "dw"
    assert tuple(n["params"][4]["w"].shape) == (spec.c_out, 1, spec.k, spec.k)
    assert tuple(n["deltas"]["L4"]["conv"]["w"].shape) == (4, 1, 3, 3)
    np.testing.assert_array_equal(n["params"][4]["w"][7, 0].numpy(),
                                  jparams[4]["w"][:, :, 0, 7])
    adam = {"step": np.asarray(3, np.int32), "m": jdeltas, "v": jdeltas}
    back = bridge.cnn_tree_to_numpy(bridge.cnn_tree_from_numpy(adam,
                                                               device="cpu"))
    assert back["step"] == 3
    np.testing.assert_array_equal(back["v"]["L8"]["conv"]["w"],
                                  jdeltas["L8"]["conv"]["w"])
    init = E.cnn_init(cfg, torch.Generator().manual_seed(0))
    assert [tuple(p["w"].shape) for p in init] == \
        [tuple(p["w"].shape) for p in n["params"]]
    assert torch.equal(init[3]["w"], E.cnn_init(
        cfg, torch.Generator().manual_seed(0))[3]["w"])
    with pytest.raises(ValueError, match="weight of shape"):
        bridge.params_from_numpy(E.tiny_cnn(), [jparams[1]] + jparams[1:],
                                 device="cpu")


# -- features and the fold ------------------------------------------------------


def jfeatures(n, plan=None):
    """The JAX package's ``cnn_features`` of one net (and plan), jitted:
    one compile instead of one per op."""
    return jax.jit(lambda params, images, taps=None, deltas=None:
                   JE.cnn_features(n["jcfg"], params, images, taps=taps,
                                   deltas=deltas, plan=plan))


def _features(n, mode):
    """(port features, JAX features) of one mode."""
    imgs = n["images"]
    if mode == "plain":
        return (E.cnn_features(n["cfg"], n["params"], torch.from_numpy(imgs)),
                jfeatures(n)(n["jparams"], imgs))
    if mode == "taps":
        return (E.cnn_features(n["cfg"], n["params"], torch.from_numpy(imgs),
                               taps=[torch.from_numpy(t) for t in n["taps"]]),
                jfeatures(n)(n["jparams"], imgs, taps=n["taps"]))
    pol, jpol = policies(horizon=4 if mode == "horizon" else 0)
    deltas = {f"L{u.layer}": n["deltas"][f"L{u.layer}"] for u in pol.units}
    jdeltas = {f"L{u.layer}": n["jdeltas"][f"L{u.layer}"] for u in pol.units}
    return (E.cnn_features(n["cfg"], n["params"], torch.from_numpy(imgs),
                           deltas=deltas, plan=pol),
            jfeatures(n, jpol)(n["jparams"], imgs, deltas=jdeltas))


@pytest.mark.parametrize("mode", ["plain", "deltas", "taps", "horizon"])
@pytest.mark.parametrize("name", [n[0] for n in NETS])
def test_features_match_reference(nets, name, mode):
    n = nets[name]
    got, want = _features(n, mode)
    assert got.shape == (BATCH, n["cfg"].feat_dim)
    close(got, want)
    if mode == "deltas":  # the deltas move the features past the tolerance
        plain, _ = _features(n, "plain")
        assert (got - plain).abs().max() > 100 * TOL * plain.abs().max()


@pytest.mark.parametrize("name", [n[0] for n in NETS])
def test_tap_and_delta_gradients_match_reference(nets, name):
    """∂/∂taps (Eq. 2's inner sums) through ``leaf_taps``/``tap_grads``,
    and ∂/∂deltas under a horizon (layers below it detached), of the same
    scalar in both packages."""
    n = nets[name]
    imgs = n["images"]
    taps = leaf_taps([torch.from_numpy(t) for t in n["taps"]])
    loss = (E.cnn_features(n["cfg"], n["params"], torch.from_numpy(imgs),
                           taps=taps) ** 2).sum()
    got = tap_grads(loss, taps)
    feats = jfeatures(n)
    want = jax.jit(jax.grad(lambda t: jnp.sum(feats(
        n["jparams"], imgs, taps=t) ** 2)))(n["taps"])
    assert len(got) == len(want) == n["cfg"].n_layers
    for g, w in zip(got, want):
        close(g, w)
    pol, jpol = policies(horizon=4)
    deltas = {f"L{u.layer}": {"conv": {"w": n["deltas"][f"L{u.layer}"][
        "conv"]["w"].clone().requires_grad_()}} for u in pol.units}
    loss = (E.cnn_features(n["cfg"], n["params"], torch.from_numpy(imgs),
                           deltas=deltas, plan=pol) ** 2).sum()
    grads = torch.autograd.grad(loss, [d["conv"]["w"]
                                       for d in deltas.values()])
    jdeltas = {k: n["jdeltas"][k] for k in deltas}
    feats = jfeatures(n, jpol)
    jgrads = jax.jit(jax.grad(lambda d: jnp.sum(feats(
        n["jparams"], imgs, deltas=d) ** 2)))(jdeltas)
    for g, k in zip(grads, deltas):
        close(g.permute(2, 3, 1, 0), jgrads[k]["conv"]["w"])


@pytest.mark.parametrize("name", [n[0] for n in NETS])
def test_fold_matches_reference_and_the_delta_forward(nets, name):
    """``cnn_fold_deltas`` equals the JAX package's fold exactly (one add a
    weight), and the folded copy's plain features equal the delta forward
    within 1e-5; channel indices as tensors (``chan_idx``) equal the
    plan's."""
    n = nets[name]
    pol, jpol = policies()
    folded = E.cnn_fold_deltas(n["cfg"], n["params"], n["deltas"], pol)
    want = JE.cnn_fold_deltas(n["jcfg"], jax.tree_util.tree_map(
        jnp.asarray, n["jparams"]), n["jdeltas"], jpol)
    for a, b in zip(jax.tree_util.tree_leaves(bridge.cnn_tree_to_numpy(
            folded)), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert folded[1]["w"] is n["params"][1]["w"]  # untouched: shared
    imgs = torch.from_numpy(n["images"])
    delta_fwd = E.cnn_features(n["cfg"], n["params"], imgs,
                               deltas=n["deltas"], plan=pol)
    close(E.cnn_features(n["cfg"], folded, imgs), delta_fwd)
    ci = {l: {"conv": torch.tensor(c)} for l, c in UNITS}
    assert torch.equal(E.cnn_features(n["cfg"], n["params"], imgs,
                                      deltas=n["deltas"], plan=pol,
                                      chan_idx=ci), delta_fwd)


# -- Eq. 2 on ragged taps ------------------------------------------------------


def test_leaf_taps_keeps_ragged_per_layer_taps():
    """An edge CNN's taps are one (B, C_i) tensor a layer: each becomes one
    leaf that requires grad (not B leaves of (C_i,)), and ``tap_grads``
    returns them as a list of the same shapes; an LM's stacked (L, B, C)
    taps still become L leaves, restacked."""
    widths = (8, 32, 24, 96)
    taps = [torch.ones(5, c) for c in widths]
    leaves = leaf_taps(taps)
    assert isinstance(leaves, list) and len(leaves) == len(widths)
    for t, c in zip(leaves, widths):
        assert t.shape == (5, c) and t.requires_grad and t.is_leaf
    loss = sum((t * torch.arange(c, dtype=torch.float32)).sum() * (i + 1)
               for i, (t, c) in enumerate(zip(leaves, widths)))
    grads = tap_grads(loss, leaves)
    assert [tuple(g.shape) for g in grads] == [(5, c) for c in widths]
    assert torch.equal(grads[2][3], 3.0 * torch.arange(24,
                                                      dtype=torch.float32))
    lm = leaf_taps({"g0": {"mixer": torch.ones(3, 5, 4)}})
    assert len(lm["g0"]["mixer"]) == 3
    g = tap_grads(sum(t.sum() for t in lm["g0"]["mixer"]), lm)
    assert g["g0"]["mixer"].shape == (3, 5, 4)


def test_fisher_reduce_matches_reference_and_masks_padding():
    """The device-side Eq. 2 equals the JAX package's, padded rows (mask 0)
    drop out exactly, and it agrees with the host-side reduction."""
    cfg, jcfg = E.tiny_cnn(16), JE.tiny_cnn(16)
    bb, jbb = cnn_backbone(cfg, 6), jcnn_backbone(jcfg, 6)
    rng = np.random.default_rng(0)
    tg = [rng.standard_normal((6, s.c_out)).astype(np.float32)
          for s in cfg.layers]
    mask = np.asarray([1, 1, 0, 1, 0, 1], np.float32)
    got = bb.fisher_reduce([torch.from_numpy(g) for g in tg], 4.0,
                           torch.from_numpy(mask))
    want = jbb.fisher_reduce([jnp.asarray(g) for g in tg], 4.0,
                             jnp.asarray(mask))
    assert set(got) == set(want) == {(i, "conv") for i in range(cfg.n_layers)}
    valid = mask.astype(bool)
    _, host = bb.fisher_from_grads([g[valid] for g in tg], 4)
    for key in got:
        close(got[key], want[key], 1e-6)
        close(got[key], host[key], 1e-6)
    poisoned = [g.copy() for g in tg]
    for g in poisoned:
        g[~valid] = 1e3
    again = bb.fisher_reduce([torch.from_numpy(g) for g in poisoned], 4.0,
                             torch.from_numpy(mask))
    assert all(torch.equal(again[k], got[k]) for k in got)
